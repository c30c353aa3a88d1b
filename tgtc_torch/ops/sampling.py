"""Ray-sample generation — port of tgtc/ops/sampling.py.

* :func:`sample_along_rays_uniform` — uniform / disparity ("harmony")
  spacing with optional mid-bin jitter given as an explicit ``u``.
* :func:`sample_pdf` — inverse-CDF importance sampling. The JAX version
  counts comparisons and gathers with one-hot matmuls (a TPU workaround);
  the count is exactly ``searchsorted(..., right=True)``, which is what
  this port calls, followed by ``gather``.
* :func:`merge_and_resample_fine` — resample from coarse weights, merge
  with the coarse depths and sort.

Random draws are explicit tensors (``u``) so callers choose the generator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_along_rays_uniform(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    n_samples: int,
    near: float = 0.0,
    far: float = 1.05,
    harmony: bool = False,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified depths along each ray ``rays_o/rays_d [R, 3]``.

    ``u [R, N]`` in [0, 1): if given, jitter each depth uniformly within
    its bin. Returns ``pts [R, N, 3]``, ``ts [R, N]``."""
    r = rays_o.shape[0]
    ts = torch.linspace(0.0, 1.0, n_samples, dtype=rays_o.dtype,
                        device=rays_o.device)
    if not harmony:
        ts = ts * (far - near) + near
    else:
        ts = 1.0 / (1.0 / near * (1.0 - ts) + 1.0 / far * ts)
    ts = ts.expand(r, n_samples)

    if u is not None:
        mid = 0.5 * (ts[..., 1:] + ts[..., :-1])
        upper = torch.cat([mid, ts[..., -1:]], dim=-1)
        lower = torch.cat([ts[..., :1], mid], dim=-1)
        ts = lower + (upper - lower) * u

    pts = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    return pts, ts


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` new depths from per-bin
    weights. ``bins [R, B]`` are bin centers, ``weights [R, B-1]``.
    Deterministic (evenly spaced u) when ``u`` is None, else ``u [R, N]``."""
    if bins.shape[-1] != weights.shape[-1] + 1:
        raise ValueError(
            f"bins [R, B] needs weights [R, B-1]; got {tuple(bins.shape)} / "
            f"{tuple(weights.shape)}")
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, B]

    r, b = cdf.shape
    if u is None:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=bins.dtype,
                           device=bins.device).expand(r, n_samples)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, b - 1)
    above = torch.clamp(inds, 0, b - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def merge_and_resample_fine(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    ts: torch.Tensor,
    weights: torch.Tensor,
    n_samples_fine: int,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical resampling: bins are coarse-depth midpoints, weights
    drop the first/last sample; the merged, sorted depths are detached so
    sampling is not differentiated. Returns ``pts [R, Nc+Nf, 3]``,
    ``t_all [R, Nc+Nf]``."""
    ts_mid = 0.5 * (ts[..., 1:] + ts[..., :-1])
    t_new = sample_pdf(ts_mid, weights[..., 1:-1], n_samples_fine, u=u)
    t_all = torch.sort(torch.cat([ts, t_new.detach()], dim=-1), dim=-1).values
    t_all = t_all.detach()
    pts = rays_o[..., None, :] + rays_d[..., None, :] * t_all[..., None]
    return pts, t_all
