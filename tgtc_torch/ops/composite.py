"""Alpha compositing (classic NeRF quadrature) — port of tgtc/ops/composite.py.

``alpha = 1 - exp(-relu(sigma + noise) * delta)``, exclusive-transmittance
cumprod with ``+1e-10``, a ``1e10`` last interval, expected RGB / depth /
accumulation and an optional white background; :func:`alpha_composite_wild`
is the static + transient (NeRF-in-the-Wild) variant. σ noise is an
explicit tensor of standard-normal draws instead of a PRNG key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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

    ``deltas`` overrides the consecutive-difference interval lengths: a
    sample subset (:func:`~tgtc_torch.ops.sampling.select_sample_budget`)
    keeps each sample's interval from the full set, so dropping a sample
    equals setting its alpha to 0."""
    if deltas is None:
        delta = t_values[..., 1:] - t_values[..., :-1]
        delta = torch.cat([delta, torch.full_like(delta[..., :1], 1e10)], dim=-1)
    else:
        delta = deltas
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * delta)
    return alpha * _exclusive_trans(alpha)


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


class _CumprodNonzero(torch.autograd.Function):
    """``torch.cumprod`` along the last dim of a tensor without zeros, with
    the backward autograd takes for such a tensor (``reversed cumsum of out
    · grad, over x``) minus its check for zeros, which reads a flag back to
    the host: so the backward syncs nothing and can be captured in a CUDA
    graph. Both passes are ``torch.cumprod``'s bit for bit."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def _exclusive_trans(alpha: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative transmittance: T_i = prod_{j<i} (1 - alpha_j + 1e-10).
    The factors are never 0 where 1e-10 survives the addition (float32,
    bfloat16; not float16, which the port does not composite in), so the
    product is :class:`_CumprodNonzero`'s."""
    trans = _CumprodNonzero.apply(1.0 - alpha + 1e-10)
    return torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)


def alpha_composite_wild(
    rgb: torch.Tensor,
    sigma: torch.Tensor,
    t_values: torch.Tensor,
    transient_rgb: torch.Tensor,
    transient_sigma: torch.Tensor,
    transient_beta: torch.Tensor,
    beta_min: float = 0.03,
    noise_std: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """NeRF-in-the-Wild static + transient compositing with a β
    uncertainty: ``rgb/transient_rgb [R, N, 3]``, ``sigma/transient_sigma
    [R, N]``, ``transient_beta [R, N, 1]``. ``noise`` (standard normal,
    shaped like ``sigma``) goes on the static σ only. Returns ``(rgb_exp,
    t_exp, weights, beta_exp)``."""
    delta = t_values[..., 1:] - t_values[..., :-1]
    delta = torch.cat([delta, torch.full_like(delta[..., :1], 1e10)], dim=-1)
    if noise is not None and noise_std > 0.0:
        sigma = sigma + noise * noise_std

    sigma_static = torch.relu(sigma)
    alpha_static = 1.0 - torch.exp(-sigma_static * delta)
    sigma_tr = torch.relu(transient_sigma)
    alpha_tr = 1.0 - torch.exp(-sigma_tr * delta)
    trans_tr = _exclusive_trans(alpha_tr)
    beta_exp = torch.sum(trans_tr[..., None] * alpha_tr[..., None]
                         * torch.relu(transient_beta), dim=-2) + beta_min

    alpha_both = 1.0 - torch.exp(-(sigma_static + sigma_tr) * delta)
    trans_both = _exclusive_trans(alpha_both)
    rgb_exp = torch.sum(trans_both[..., None] * alpha_static[..., None] * rgb
                        + trans_both[..., None] * alpha_tr[..., None] * transient_rgb, dim=-2)
    weights = alpha_both * trans_both
    t_exp = torch.sum(weights * t_values, dim=-1)
    if white_bkgd:
        rgb_exp = rgb_exp + (1.0 - torch.sum(weights, -1)[..., None])
    return rgb_exp, t_exp, weights, beta_exp
