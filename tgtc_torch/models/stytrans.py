"""StyTrans — the 2D stylization network's inference path; port of
tgtc/models/stytrans.py.

PatchEmbed → StyleTransformer → CNN decoder, NHWC in and out as in the JAX
package. ``stylize`` returns the image and the d_model token map ``hs``
(both f32 whatever the compute type), from which
:func:`style_feature_from_tokens` makes the 2·d_model style feature. The
training path (``compute_losses``) and the VGG pyramid (``encode_pyramid``)
come with the C1 trainer.

The three state dicts (``embedding``, ``transformer``, ``decode``) use the
reference's torch names (``embedding_iter_*.pth``, ``transformer_iter_*.pth``,
``decoder.pth``). Weights are drawn from an explicit ``torch.Generator``:
LeCun-normal kernels and zero biases (the flax ``Dense``/``Conv`` default),
unit LayerNorm scales.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.models.decoder import Decoder
from tgtc_torch.models.transformer import (
    MultiHeadAttention,
    PatchEmbed,
    StyleTransformer,
    TransformerConfig,
)

_C1 = "comes with the C1 trainer (ROADMAP.md queue 1, items 13 and 15)"


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

    @torch.no_grad()
    def stylize(self, content: torch.Tensor, style: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``content [B, H, W, 3]``, ``style [B, Hs, Ws, 3]`` (H, W, Hs, Ws
        multiples of 8) → ``(image [B, H, W, 3], hs [B, H/8, W/8, d_model])``."""
        hs = self.transformer(self.embedding(style), self.embedding(content))
        return self.decode(hs).float(), hs.float()

    def encode_pyramid(self, x: torch.Tensor):
        raise NotImplementedError(f"the VGG feature pyramid {_C1}")

    def compute_losses(self, content: torch.Tensor, style: torch.Tensor):
        raise NotImplementedError(f"StyTrans.compute_losses {_C1}")


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
