"""The eager coarse→fine volume-render step — port of tgtc/render/volume.py.

Random draws are explicit tensors: ``perturb_u`` (coarse-depth jitter,
uniform ``[R, Nc]``) and ``noise_coarse`` / ``noise_fine`` (standard-normal
σ noise, scaled by ``settings.sigma_noise_std``). Without them the render
is deterministic, as the JAX version is without a key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from tgtc_torch.models.nerf import NerfMLP, nerf_apply, nerf_apply_t
from tgtc_torch.ops.composite import alpha_composite
from tgtc_torch.ops.sampling import merge_and_resample_fine, sample_along_rays_uniform


def _trunk_apply(model: NerfMLP, pts: torch.Tensor, dirs: torch.Tensor,
                 feature_major: bool) -> Dict[str, torch.Tensor]:
    """Point-major vs feature-major trunk; ``[R, S, ...]`` in and out."""
    if not feature_major:
        return nerf_apply(model, pts, dirs)
    r, s, _ = pts.shape
    out = nerf_apply_t(model, pts.reshape(-1, 3).T, dirs.reshape(-1, 3).T)
    return {"rgb": out["rgb"].T.reshape(r, s, 3),
            "sigma": out["sigma"].reshape(r, s),
            "base_remap": out["base_remap"].T.reshape(r, s, -1)}


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render-time settings (subset of the reference flags)."""

    n_samples: int = 64
    n_samples_fine: int = 64
    near: float = 0.0
    far: float = 1.0
    sigma_noise_std: float = 1.0
    white_bkgd: bool = False
    perturb: bool = False  # jitter coarse depths (needs perturb_u)
    feature_major: bool = False  # evaluate the trunk via nerf_apply_t
    fine_budget: Optional[int] = None  # not ported yet (ROADMAP.md queue 1)


def render_rays(
    coarse_model: NerfMLP,
    fine_model: NerfMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    perturb_u: Optional[torch.Tensor] = None,
    noise_coarse: Optional[torch.Tensor] = None,
    noise_fine: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """Coarse+fine render of a flat ray batch ``[R, 3]``. Returns the
    ``coarse``/``fine`` :class:`CompositeOutput` and the depths ``ts`` /
    ``ts_fine``."""
    if settings.fine_budget is not None:
        raise NotImplementedError(
            "fine_budget is not ported yet (ROADMAP: select_sample_budget)")
    pts, ts = sample_along_rays_uniform(
        rays_o, rays_d, settings.n_samples, near=settings.near,
        far=settings.far, u=perturb_u if settings.perturb else None)
    dirs = rays_d[:, None, :].expand(pts.shape)
    out_c = _trunk_apply(coarse_model, pts, dirs, settings.feature_major)
    comp_c = alpha_composite(out_c["rgb"], out_c["sigma"], ts,
                             noise_std=settings.sigma_noise_std,
                             noise=noise_coarse, white_bkgd=settings.white_bkgd)

    pts_f, ts_f = merge_and_resample_fine(rays_o, rays_d, ts, comp_c.weights,
                                          settings.n_samples_fine)
    dirs_f = rays_d[:, None, :].expand(pts_f.shape)
    out_f = _trunk_apply(fine_model, pts_f, dirs_f, settings.feature_major)
    comp_f = alpha_composite(out_f["rgb"], out_f["sigma"], ts_f,
                             noise_std=settings.sigma_noise_std,
                             noise=noise_fine, white_bkgd=settings.white_bkgd)
    return {"coarse": comp_c, "fine": comp_f, "ts": ts, "ts_fine": ts_f}
