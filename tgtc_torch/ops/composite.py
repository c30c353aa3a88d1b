"""Alpha compositing (classic NeRF quadrature) — port of tgtc/ops/composite.py.

``alpha = 1 - exp(-relu(sigma + noise) * delta)``, exclusive-transmittance
cumprod with ``+1e-10``, a ``1e10`` last interval, expected RGB / depth /
accumulation and an optional white background. σ noise is an explicit
tensor of standard-normal draws instead of a PRNG key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class CompositeOutput(NamedTuple):
    rgb: torch.Tensor      # [R, 3]  expected color
    t_exp: torch.Tensor    # [R]     expected depth
    weights: torch.Tensor  # [R, N]  per-sample contribution
    acc: torch.Tensor      # [R]     accumulated opacity


def sigma_weights(
    sigma: torch.Tensor,
    t_values: torch.Tensor,
    deltas: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-sample compositing weights from (post-noise) density alone.

    ``deltas`` overrides the consecutive-difference interval lengths."""
    if deltas is None:
        delta = t_values[..., 1:] - t_values[..., :-1]
        delta = torch.cat([delta, torch.full_like(delta[..., :1], 1e10)], dim=-1)
    else:
        delta = deltas
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * delta)
    # exclusive cumulative transmittance: T_i = prod_{j<i} (1 - alpha_j)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    return alpha * trans


def alpha_composite(
    rgb: torch.Tensor,
    sigma: torch.Tensor,
    t_values: torch.Tensor,
    noise_std: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
    deltas: Optional[torch.Tensor] = None,
) -> CompositeOutput:
    """Composite per-sample radiance ``rgb [R, N, 3]``, raw density
    ``sigma [R, N]`` at depths ``t_values [R, N]`` into per-ray outputs.

    ``noise``: optional standard-normal draws shaped like ``sigma``; when
    given and ``noise_std > 0``, ``noise * noise_std`` is added to sigma
    before the ReLU (the JAX version draws them from its key)."""
    if noise is not None and noise_std > 0.0:
        sigma = sigma + noise * noise_std

    weights = sigma_weights(sigma, t_values, deltas=deltas)

    rgb_exp = torch.sum(weights[..., None] * rgb, dim=-2)
    t_exp = torch.sum(weights * t_values, dim=-1)
    acc = torch.sum(weights, dim=-1)
    if white_bkgd:
        rgb_exp = rgb_exp + (1.0 - acc[..., None])
    return CompositeOutput(rgb=rgb_exp, t_exp=t_exp, weights=weights, acc=acc)
