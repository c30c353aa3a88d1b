"""The classic AdaIN style-transfer network (the reference's alternate 2D
stylizer) — port of tgtc/models/adain_net.py (``AdainNet`` :29-66,
``make_adain_net`` :69-74).

The truncated normalised VGG (:class:`~tgtc_torch.models.vgg.VggEncoder`,
through relu4_1) encodes content and style, AdaIN renormalizes the content's
relu4_1 to the style's statistics, and the CNN decoder
(:class:`~tgtc_torch.models.decoder.Decoder`, 512 channels in) maps it back
to an image. The losses are the reference's: the content MSE of the
stylization's relu4_1 against the detached AdaIN target, and the per-stage
mean/std MSE over the four VGG stages against the style's detached
statistics. NHWC at the API, as the port's
:class:`~tgtc_torch.models.stytrans.StyTrans`; f32 throughout. The two
submodules keep the JAX package's names (``vgg``, ``decode``) and the
reference's torch layouts, so ``vgg_normalised.pth`` and ``decoder.pth``
load with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.models.decoder import Decoder
from tgtc_torch.models.stytrans import mse
from tgtc_torch.models.vgg import VggEncoder
from tgtc_torch.ops.style import adaptive_instance_normalization, calc_mean_std

STAGES = 4  # relu1_1 … relu4_1: the truncated VGG's distinct levels


class AdainNet(nn.Module):
    """``stylize(content, style, alpha)`` → image;
    ``compute_losses(content, style)`` → ``{"stylized", "loss_c",
    "loss_s"}``. Images are ``[B, H, W, 3]`` in [0, 1], H and W multiples
    of 8."""

    def __init__(self):
        super().__init__()
        self.vgg = VggEncoder()
        self.decode = Decoder()

    def stylize(self, content: torch.Tensor, style: torch.Tensor,
                alpha: float = 1.0) -> torch.Tensor:
        """AdaIN at relu4_1 blended with the content's own by ``alpha``,
        then decoded."""
        c4, s4 = self.vgg(content)[3], self.vgg(style)[3]
        t = adaptive_instance_normalization(c4, s4)
        return self.decode(alpha * t + (1.0 - alpha) * c4)

    def forward(self, content: torch.Tensor, style: torch.Tensor,
                alpha: float = 1.0) -> torch.Tensor:
        return self.stylize(content, style, alpha)

    def compute_losses(self, content: torch.Tensor, style: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
        """The AdaIN objective's two losses and the stylization ``g``."""
        c_feats, s_feats = self.vgg(content), self.vgg(style)
        t = adaptive_instance_normalization(c_feats[3], s_feats[3]).detach()
        g = self.decode(t)
        g_feats = self.vgg(g)
        loss_c = mse(g_feats[3], t)
        loss_s = torch.zeros((), device=content.device)
        for i in range(STAGES):
            gm, gs = calc_mean_std(g_feats[i])
            sm, ss = calc_mean_std(s_feats[i].detach())
            loss_s = loss_s + mse(gm, sm) + mse(gs, ss)
        return {"stylized": g, "loss_c": loss_c, "loss_s": loss_s}


def make_adain_net(generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> AdainNet:
    """An :class:`AdainNet` on ``device`` (the card unless told otherwise)
    with LeCun-normal kernels drawn from ``generator``, the VGG's first,
    and zero biases (the flax ``Conv`` default)."""
    dev = resolve_device(device)
    with torch.device("meta"):  # no draw from the global generator
        model = AdainNet()
    model.to_empty(device=dev)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.weight[0].numel() ** -0.5)
                m.bias.zero_()
    return model
