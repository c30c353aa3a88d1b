"""Ray-sample generation — port of tgtc/ops/sampling.py.

* :func:`sample_along_rays_uniform` — uniform / disparity ("harmony")
  spacing with optional mid-bin jitter given as an explicit ``u``.
* :func:`sample_pdf` — inverse-CDF importance sampling. The JAX version
  counts comparisons and gathers with one-hot matmuls (a TPU workaround);
  the count is exactly ``searchsorted(..., right=True)``, which is what
  this port calls, followed by ``gather``.
* :func:`merge_and_resample_fine` — resample from coarse weights, merge
  with the coarse depths and sort.
* :func:`merge_two_sorted` — merge two per-row sorted arrays by rank
  (``searchsorted`` and a scatter; the JAX version places them with
  one-hot matmuls).
* :func:`select_sample_budget` — keep each ray's ``budget`` merged samples
  of highest estimated weight (a stable descending sort, so ties resolve
  as ``jax.lax.top_k`` resolves them: the lower index first).

Random draws are explicit tensors (``u``) so callers choose the generator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tgtc_torch.ops.composite import sigma_weights


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
    ts = stratified_depths(rays_o, n_samples, near, far, harmony, u)
    pts = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    return pts, ts


def stratified_depths(
    rays_o: torch.Tensor,
    n_samples: int,
    near: float = 0.0,
    far: float = 1.05,
    harmony: bool = False,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The depths ``ts [R, N]`` of :func:`sample_along_rays_uniform`
    without its points (``rays_o`` gives R, dtype and device)."""
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
    return ts


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


def merge_two_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge per-row sorted ``a [R, Na]`` and ``b [R, Nb]`` into a sorted
    ``[R, Na + Nb]``: each element's slot is its index plus the count of
    smaller elements in the other array, ties placing ``a`` first."""
    a, b = a.contiguous(), b.contiguous()
    na, nb = a.shape[-1], b.shape[-1]
    pos_a = torch.arange(na, device=a.device) + torch.searchsorted(b, a, right=False)
    pos_b = torch.arange(nb, device=a.device) + torch.searchsorted(a, b, right=True)
    out = a.new_empty(a.shape[:-1] + (na + nb,))
    return out.scatter_(-1, pos_a, a).scatter_(-1, pos_b, b)


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of each row's ``k`` largest scores in ``jax.lax.top_k``'s
    order: descending, equal scores by ascending index (``torch.topk``
    promises no order among ties, and empty space scores many samples
    exactly 0)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def select_sample_budget(
    ts_all: torch.Tensor,
    ts_coarse: torch.Tensor,
    sigma_coarse: torch.Tensor,
    budget: int,
    grid: Optional[Tuple[float, float]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep each ray's ``budget`` merged samples of highest estimated
    compositing weight, in depth order.

    Each merged depth ``ts_all [R, M]`` takes the σ of its coarse interval
    (``sigma_coarse [R, Nc]`` at ``ts_coarse [R, Nc]``), the quadrature
    (:func:`sigma_weights`) scores it, and the top ``budget`` are kept
    (:func:`top_k_indices`). The score takes no gradient. Returns
    ``(ts_kept, deltas_kept)``, both ``[R, budget]``: the deltas are each
    kept sample's interval in the full set, so compositing the subset with
    them equals the full composite with the dropped alphas set to 0.

    ``grid=(near, far)``: only when ``ts_coarse`` is the unperturbed
    linspace over that range; the coarse interval is then a floor instead
    of a search (``+1e-4`` bin keeps a sample on a grid point in its own
    bin)."""
    r, m = ts_all.shape
    nc = ts_coarse.shape[-1]
    if not 0 < budget <= m:
        raise ValueError(f"budget {budget} must be in (0, {m}]")
    if grid is not None:
        near, far = grid
        step = (far - near) / (nc - 1)
        idx_bin = torch.floor((ts_all - near) / step + 1e-4).long()
    else:
        # the coarse interval of each merged sample: count(ts_coarse <= t) - 1
        idx_bin = torch.searchsorted(ts_coarse.contiguous(), ts_all.contiguous(),
                                     right=True) - 1
    idx_bin = idx_bin.clamp(0, nc - 1)
    sigma_est = torch.gather(sigma_coarse, -1, idx_bin)
    score = sigma_weights(sigma_est, ts_all).detach()
    keep = torch.sort(top_k_indices(score, budget), dim=-1).values  # depth order

    deltas = ts_all[..., 1:] - ts_all[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], dim=-1)
    return torch.gather(ts_all, -1, keep), torch.gather(deltas, -1, keep)
