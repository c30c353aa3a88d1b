"""The eager stylized chain — port of tgtc/render/style.py.

One stream (coarse or fine, given its depths): frozen NeRF trunk →
``base_remap``, σ and ``pts_embed``; per-ray latents; the concat MLP on
``(pts_embed, latent)``; the style MLP on ``(pts_embed, [base_remap |
concat_features], mean latent)``; then the composite with the frozen
density. The style MLP's latent input is the per-ray mean of the latent
broadcast back over its columns, as in the reference. This is the oracle
of the fused path (:mod:`tgtc_torch.render.fast_style`); the σ-noise draw
is an explicit tensor.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tgtc_torch.models.nerf import NerfMLP, nerf_apply
from tgtc_torch.models.style_field import (
    StyleMLPBeforeConcat,
    StyleMLPWildMultilayers,
    lookup_latents,
)
from tgtc_torch.ops.composite import CompositeOutput, alpha_composite


def style_forward(
    nerf_model: NerfMLP,
    concat_model: StyleMLPBeforeConcat,
    style_model: StyleMLPWildMultilayers,
    latent_state: Dict[str, torch.Tensor],
    rays_o: torch.Tensor,      # [R, 3]
    rays_d: torch.Tensor,      # [R, 3]
    ts: torch.Tensor,          # [R, S]
    style_ids: torch.Tensor,   # [R]
    frame_ids: torch.Tensor,   # [R]
    sigma_scale: float = 1.0,
    llff_tile: bool = True,
    noise_std: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    with_sigma: bool = False,
    deltas: Optional[torch.Tensor] = None,
) -> Tuple[CompositeOutput, ...]:
    """Returns ``(composite, weights)``, plus the raw trunk σ ``[R, S]`` when
    ``with_sigma``. ``noise [R, S]``: standard-normal σ-noise draws, scaled
    by ``noise_std``; ``deltas``: the intervals of a sample subset
    (``ops.sampling.select_sample_budget``). The trunk is frozen: no
    gradient reaches it."""
    r, s = ts.shape
    pts = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    dirs = rays_d[:, None, :].expand(pts.shape)
    with torch.no_grad():
        out = nerf_apply(nerf_model, pts, dirs)
    base_remap, sigma, pts_embed = out["base_remap"], out["sigma"], out["pts_embed"]

    lat = lookup_latents(latent_state, style_ids, frame_ids, sigma_scale, llff_tile)
    d = lat.shape[-1]
    lat_full = lat[:, None, :].expand(r, s, d)
    lat_scalar = lat.mean(dim=-1, keepdim=True)[:, None, :].expand(r, s, d)

    concat_features = concat_model(pts_embed, lat_full)
    concated = torch.cat([base_remap, concat_features], dim=-1)
    rgb = style_model(pts_embed, concated, lat_scalar)

    comp = alpha_composite(rgb, sigma, ts, noise_std=noise_std, noise=noise, deltas=deltas)
    if with_sigma:
        return comp, comp.weights, sigma
    return comp, comp.weights
