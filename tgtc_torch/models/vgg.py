"""VGG-19 feature encoder (the normalised-VGG layout) — port of
tgtc/models/vgg.py.

A 1x1 input conv (the ``vgg_normalised`` RGB remap), then 3x3
reflection-padded convs with ReLU and ceil-mode 2x2 max-pools, tapped at
relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1. Each stage pools after its
trailing convs, not at the stage boundary (``_STAGES``). The module is an
``nn.Sequential`` laid out as the reference's sequential VGG, so its convs
sit at the torch indices of ``_TORCH_IDX_TO_NAME`` with OIHW weights and
``vgg_normalised.pth`` loads with ``load_state_dict`` once the keys past the
built layers are dropped. ``truncated=True`` (the default) builds the first
31 layers only, as the reference's StyTrans does (``vgg[:31]``): its fifth
level is then relu4_1 itself. Inputs and outputs are NHWC, as in the JAX
package; the convs run on an NCHW view and, like flax's
``Conv(dtype=...)``, cast input, weight and bias to ``dtype``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tgtc_torch.device import DeviceLike, resolve_device

# Ops per pyramid stage, in order; "pool" is the ceil-mode max-pool.
_STAGES: Tuple[Tuple[Any, ...], ...] = (
    (("conv0", 3), ("conv1_1", 64)),                      # → relu1_1
    (("conv1_2", 64), "pool", ("conv2_1", 128)),          # → relu2_1
    (("conv2_2", 128), "pool", ("conv3_1", 256)),         # → relu3_1
    (("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
     "pool", ("conv4_1", 512)),                           # → relu4_1
    (("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
     "pool", ("conv5_1", 512)),                           # → relu5_1
)

# torch sequential index → conv name (the reference's vgg_normalised.pth)
_TORCH_IDX_TO_NAME = {
    0: "conv0",
    2: "conv1_1", 5: "conv1_2",
    9: "conv2_1", 12: "conv2_2",
    16: "conv3_1", 19: "conv3_2", 22: "conv3_3", 25: "conv3_4",
    29: "conv4_1", 32: "conv4_2", 35: "conv4_3", 38: "conv4_4",
    42: "conv5_1",
}
TRUNCATED_LAYERS = 31  # the reference's vgg[:31]: through relu4_1


def reflect_pad(x: torch.Tensor, p: int = 1) -> torch.Tensor:
    """Reflection padding of the two spatial axes of an NCHW tensor (the
    JAX function pads NHWC; the port's convolutions run NCHW)."""
    return F.pad(x, (p, p, p, p), mode="reflect")


def _ceil_pool_nchw(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[2] % 2, x.shape[3] % 2
    if h or w:
        x = F.pad(x, (0, w, 0, h), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


def ceil_max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool of an NHWC tensor in ceil mode: an odd
    spatial size keeps its last row or column (−inf padding)."""
    return _ceil_pool_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _ReflectPad(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x)


class _CeilMaxPool(nn.Module):  # NCHW, as the reference's MaxPool2d(2, 2, ceil_mode=True)
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ceil_pool_nchw(x)


class VggEncoder(nn.Sequential):
    """NHWC input in [0, 1] (no mean/std preprocessing) → the five-level
    pyramid ``[relu1_1, ..., relu5_1]``, NHWC, in ``dtype``."""

    def __init__(self, truncated: bool = True, dtype: torch.dtype = torch.float32):
        mods: List[nn.Module] = []
        taps = []
        cin = 3
        for stage in _STAGES:
            for op in stage:
                if op == "pool":
                    mods.append(_CeilMaxPool())
                    continue
                _, cout = op
                if not mods:  # the 1x1 RGB remap: no padding, no relu
                    mods.append(nn.Conv2d(cin, cout, 1))
                else:
                    mods += [_ReflectPad(), nn.Conv2d(cin, cout, 3), nn.ReLU()]
                cin = cout
            taps.append(len(mods))
        n = TRUNCATED_LAYERS if truncated else len(mods)
        super().__init__(*mods[:n])
        self.truncated, self.dtype = truncated, dtype
        self.taps = [t for t in taps if t <= n]  # truncated: relu5_1 is relu4_1
        assert {i for i, m in enumerate(self) if isinstance(m, nn.Conv2d)} == {
            i for i in _TORCH_IDX_TO_NAME if i < n}

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.dtype
        y = x.permute(0, 3, 1, 2)
        feats = []
        for i, m in enumerate(self, 1):
            if isinstance(m, nn.Conv2d):
                y = F.conv2d(y.to(dt), m.weight.to(dt), m.bias.to(dt))
            else:
                y = m(y)
            if i in self.taps:
                feats.append(y.permute(0, 2, 3, 1))
        while len(feats) < len(_STAGES):  # the empty fifth stage
            feats.append(feats[-1])
        return feats


def make_vgg(generator: Optional[torch.Generator] = None, truncated: bool = True,
             dtype: torch.dtype = torch.float32, device: DeviceLike = None) -> VggEncoder:
    """A VggEncoder on ``device`` with LeCun-normal kernels drawn from
    ``generator`` and zero biases (the flax ``Conv`` default)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = VggEncoder(truncated, dtype)
    model.to_empty(device=dev)
    with torch.no_grad():
        for m in model:
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.weight[0].numel() ** -0.5)
                m.bias.zero_()
    return model
