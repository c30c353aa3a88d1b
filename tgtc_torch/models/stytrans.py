"""StyTrans — the 2D stylization network and its training losses; port of
tgtc/models/stytrans.py.

PatchEmbed → StyleTransformer → CNN decoder, NHWC in and out as in the JAX
package, and a frozen VGG feature pyramid for the losses. ``stylize``
returns the image and the d_model token map ``hs`` (both f32 whatever the
compute type), from which :func:`style_feature_from_tokens` makes the
2·d_model style feature. ``compute_losses`` is the C1 objective:

* content loss: MSE of the mean-std-normalized relu4_1/relu5_1 features;
* style loss: per-stage mean and std MSE over the five stages;
* identity losses: the Icc/Iss pixel identity ``l_id1`` and the per-stage
  feature identity ``l_id2``.

Features are cast to f32; the content and style targets are detached (JAX's
``stop_gradient``). The four state dicts (``embedding``, ``transformer``,
``decode``, ``vgg``) use the reference's torch names (``embedding_iter_*.pth``,
``transformer_iter_*.pth``, ``decoder.pth``, ``vgg_normalised.pth``). Weights
are drawn from an explicit ``torch.Generator``: LeCun-normal kernels and zero
biases (the flax ``Dense``/``Conv`` default), unit LayerNorm scales; the VGG
is registered last, so the other weights do not depend on it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.models.decoder import Decoder
from tgtc_torch.models.transformer import (
    MultiHeadAttention,
    PatchEmbed,
    Rows,
    StyleTransformer,
    TransformerConfig,
)
from tgtc_torch.models.vgg import VggEncoder
from tgtc_torch.ops.style import calc_mean_std, mean_variance_norm


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


class StyTrans(nn.Module):
    def __init__(self, cfg: TransformerConfig = TransformerConfig(),
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):  # no draw from the global generator
            self.embedding = PatchEmbed(cfg.d_model, dtype=cfg.dtype)
            self.transformer = StyleTransformer(cfg)
            self.decode = Decoder(cfg.d_model, dtype=cfg.dtype)
            self.vgg = VggEncoder(dtype=cfg.dtype)  # last: drawn after the others
        self.to_empty(device=dev)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        def lecun(p: torch.Tensor, fan_in: int) -> None:
            p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun(m.weight, m.weight[0].numel())
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MultiHeadAttention):
                lecun(m.in_proj_weight, m.d_model)  # three separate d -> d projections
                m.in_proj_bias.zero_()

    def _transform(self, content: torch.Tensor, style: torch.Tensor, deterministic: bool = True,
                   pos_mode: str = "ics", generator: Optional[torch.Generator] = None,
                   rows: Rows = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(image, hs)`` in f32, whatever the compute type."""
        hs = self.transformer(self.embedding(style), self.embedding(content), pos_mode,
                              deterministic, generator, rows)
        return self.decode(hs).float(), hs.float()

    @torch.no_grad()
    def stylize(self, content: torch.Tensor, style: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``content [B, H, W, 3]``, ``style [B, Hs, Ws, 3]`` (H, W, Hs, Ws
        multiples of 8) → ``(image [B, H, W, 3], hs [B, H/8, W/8, d_model])``."""
        return self._transform(content, style)

    def encode_pyramid(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.vgg(x)

    def compute_losses(self, content: torch.Tensor, style: torch.Tensor,
                       deterministic: bool = False,
                       generator: Optional[torch.Generator] = None,
                       rows: Rows = None) -> Dict[str, torch.Tensor]:
        """The C1 losses of ``content``/``style`` batches ``[B, P, P, 3]`` in
        [0, 1]: ``{"ics", "loss_c", "loss_s", "l_id1", "l_id2"}``. Dropout,
        where not ``deterministic``, draws from ``generator`` in the order
        Ics, Icc, Iss; under ``rows=(first, total)`` the batches are rows
        ``first…`` of a ``total``-row batch and draw its masks
        (:mod:`tgtc_torch.models.transformer`). Every loss is a mean over
        the batch's images."""
        def f32(feats):
            return [f.float() for f in feats]

        content_feats = f32(self.vgg(content))
        style_feats = f32(self.vgg(style))
        ics, _ = self._transform(content, style, deterministic, "ics", generator, rows)
        ics_feats = f32(self.vgg(ics))

        loss_c = (mse(mean_variance_norm(ics_feats[-1]),
                      mean_variance_norm(content_feats[-1].detach()))
                  + mse(mean_variance_norm(ics_feats[-2]),
                        mean_variance_norm(content_feats[-2].detach())))
        loss_s = torch.zeros((), device=content.device)
        for i in range(5):
            im, istd = calc_mean_std(ics_feats[i])
            tm, tstd = calc_mean_std(style_feats[i].detach())
            loss_s = loss_s + mse(im, tm) + mse(istd, tstd)

        # the identity calls' positional patterns differ from the main call's
        icc, _ = self._transform(content, content, deterministic, "icc", generator, rows)
        iss, _ = self._transform(style, style, deterministic, "iss", generator, rows)
        l_id1 = mse(icc, content) + mse(iss, style)
        icc_feats, iss_feats = f32(self.vgg(icc)), f32(self.vgg(iss))
        l_id2 = torch.zeros((), device=content.device)
        for i in range(5):
            l_id2 = (l_id2 + mse(icc_feats[i], content_feats[i].detach())
                     + mse(iss_feats[i], style_feats[i].detach()))
        return {"ics": ics, "loss_c": loss_c, "loss_s": loss_s, "l_id1": l_id1, "l_id2": l_id2}


def make_stytrans(cfg: TransformerConfig = TransformerConfig(),
                  generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None) -> StyTrans:
    """A StyTrans with weights drawn from ``generator``, on ``device``."""
    return StyTrans(cfg, generator, device)


def style_feature_from_tokens(hs: torch.Tensor) -> torch.Tensor:
    """``[B, h, w, C]`` → ``[B, 2C]``: the token mean and the unbiased token
    variance, as torch's ``var`` in the reference."""
    tok = hs.reshape(hs.shape[0], -1, hs.shape[-1])
    return torch.cat([tok.mean(dim=1), tok.var(dim=1)], dim=-1)
