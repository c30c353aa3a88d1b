"""CNN decoder (d_model-channel token map → RGB) — port of
tgtc/models/decoder.py.

Reflection-padded 3x3 convs with ReLU and three 2x nearest upsamples; the
last conv has no activation. The module is an ``nn.Sequential`` laid out as
the reference's (``tctrans.py:36-66``), so its convs sit at the torch
indices ``1, 5, 8, 11, 14, 18, 21, 25, 28`` with OIHW weights and a
reference ``decoder.pth`` loads with ``load_state_dict``. The first conv's
input width follows ``in_channels`` (512 in the reference). Inputs and
outputs are NHWC, as in the JAX package; the convs run on an NCHW view.
Like flax's ``Conv(dtype=...)``, each conv casts its input, weight and bias
to ``dtype`` and returns ``dtype``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tgtc_torch.models.vgg import reflect_pad

# (out channels, upsample before) of each conv, in order
_LAYERS = ((256, False), (256, True), (256, False), (256, False), (128, False),
           (128, True), (64, False), (64, True), (3, False))
TORCH_INDEX = (1, 5, 8, 11, 14, 18, 21, 25, 28)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


class _ReflectPad(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x)


class Decoder(nn.Sequential):
    """``x [B, h, w, in_channels]`` → ``[B, 8h, 8w, 3]`` in ``dtype``."""

    def __init__(self, in_channels: int = 512, dtype: torch.dtype = torch.float32):
        mods = []
        cin = in_channels
        for i, (cout, up) in enumerate(_LAYERS):
            if up:
                mods.append(nn.Upsample(scale_factor=2, mode="nearest"))
            mods += [_ReflectPad(), nn.Conv2d(cin, cout, 3)]
            if i < len(_LAYERS) - 1:
                mods.append(nn.ReLU())
            cin = cout
        super().__init__(*mods)
        self.dtype = dtype
        assert tuple(i for i, m in enumerate(self) if isinstance(m, nn.Conv2d)) == TORCH_INDEX

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = x.permute(0, 3, 1, 2)
        for m in self:
            if isinstance(m, nn.Conv2d):
                y = F.conv2d(y.to(dt), m.weight.to(dt), m.bias.to(dt))
            else:
                y = m(y)
        return y.permute(0, 2, 3, 1)
