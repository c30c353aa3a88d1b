"""Fused bulk render: CUDA trunk kernels + PyTorch sampling/compositing.

Port of tgtc/render/fast.py — the Phase-B geometry dump and bench path:

    stratified sample → K2 σ-only (or K1) coarse → composite weights →
    inverse-CDF resample → K1 fine → composite

Points are built feature-major ``[3, R*S]`` straight from the ray tensors,
the layout the kernels take. ``fine_budget``, ``coarse_share`` and
``grid_spec`` are not ported yet and raise; the sharded renderer waits for
the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.ops.composite import alpha_composite, sigma_weights
from tgtc_torch.ops.kernels.nerf_mlp import (
    PackedNerf,
    fused_nerf_apply_t,
    fused_nerf_sigma_apply_t,
    pack_nerf_params,
)
from tgtc_torch.ops.sampling import sample_along_rays_uniform, sample_pdf
from tgtc_torch.render.volume import RenderSettings

_LEVERS = "ROADMAP.md queue 1, 'Proposal levers and sample budgets'"
_NOT_PORTED = {
    "fine_budget": f"{_LEVERS}: fine_budget / select_sample_budget",
    "coarse_share": f"{_LEVERS}: coarse_share",
    "grid_spec": f"{_LEVERS}: density-grid proposal",
}


def _reject_unported(fine_budget, coarse_share, grid_spec) -> None:
    for name, given in (("fine_budget", fine_budget is not None),
                        ("coarse_share", coarse_share != 1),
                        ("grid_spec", grid_spec is not None)):
        if given:
            raise NotImplementedError(f"{name} is not ported yet ({_NOT_PORTED[name]})")


def _points_t(rays_o: torch.Tensor, rays_d: torch.Tensor, ts: torch.Tensor,
              with_dirs: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Feature-major pts/dirs ``[3, R*S]`` from rays ``[R, 3]`` + depths
    ``[R, S]``."""
    r, s = ts.shape
    o = rays_o.T[:, :, None]
    d = rays_d.T[:, :, None]
    pts = (o + ts[None] * d).reshape(3, r * s)
    dirs = d.expand(3, r, s).reshape(3, r * s) if with_dirs else None
    return pts, dirs


def make_fused_render_fn(
    settings: RenderSettings,
    coarse_rgb: bool = True,
    fine_budget: Optional[int] = None,
    coarse_share: int = 1,
    grid_spec=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``(packed_coarse, packed_fine, rays_o, rays_d) -> outputs`` using the
    fused trunk kernels for both passes. ``coarse_rgb=False`` runs the
    σ-only kernel on the coarse pass (the fine image is identical)."""
    _reject_unported(fine_budget, coarse_share, grid_spec)
    nc, nf = settings.n_samples, settings.n_samples_fine

    @torch.no_grad()
    def render(pc: PackedNerf, pf: PackedNerf, rays_o: torch.Tensor,
               rays_d: torch.Tensor) -> Dict[str, torch.Tensor]:
        r = rays_o.shape[0]
        _, ts = sample_along_rays_uniform(rays_o, rays_d, nc,
                                          near=settings.near, far=settings.far)
        pt, dt = _points_t(rays_o, rays_d, ts, with_dirs=coarse_rgb)
        if coarse_rgb:
            rgb_t, sigma_t = fused_nerf_apply_t(pc, pt, dt)
            comp_c = alpha_composite(rgb_t.reshape(3, r, nc).permute(1, 2, 0),
                                     sigma_t.reshape(r, nc), ts,
                                     white_bkgd=settings.white_bkgd)
            weights_c = comp_c.weights
        else:
            sigma_c = fused_nerf_sigma_apply_t(pc, pt).reshape(r, nc)
            weights_c = sigma_weights(sigma_c, ts)

        ts_mid = 0.5 * (ts[..., 1:] + ts[..., :-1])
        t_new = sample_pdf(ts_mid, weights_c[..., 1:-1], nf)
        ts_f = torch.sort(torch.cat([ts, t_new], dim=-1), dim=-1).values

        ptf, dtf = _points_t(rays_o, rays_d, ts_f)
        rgb_t, sigma_t = fused_nerf_apply_t(pf, ptf, dtf)
        n_eval = nc + nf
        comp_f = alpha_composite(rgb_t.reshape(3, r, n_eval).permute(1, 2, 0),
                                 sigma_t.reshape(r, n_eval), ts_f,
                                 white_bkgd=settings.white_bkgd)
        out = {"rgb": comp_f.rgb, "t_exp": comp_f.t_exp, "acc": comp_f.acc}
        if coarse_rgb:
            out["rgb_coarse"] = comp_c.rgb
            out["t_exp_coarse"] = comp_c.t_exp
        return out

    return render


@dataclasses.dataclass
class FusedNerfRenderer:
    """Packed kernel weights for coarse+fine. Build from ``NerfMLP`` state
    dicts with :meth:`from_params`; call :meth:`render` on flat ray blocks
    or :meth:`render_image` on any ray count."""

    packed_coarse: PackedNerf
    packed_fine: PackedNerf
    settings: RenderSettings
    coarse_rgb: bool = True

    def __post_init__(self):
        self._fn = make_fused_render_fn(self.settings, self.coarse_rgb)

    @property
    def device(self) -> torch.device:
        return self.packed_coarse.w.device

    @classmethod
    def from_params(
        cls,
        params_coarse: Dict[str, torch.Tensor],
        params_fine: Dict[str, torch.Tensor],
        settings: RenderSettings,
        depth: int = 8,
        num_freq_coor: int = 10,
        num_freq_dir: int = 4,
        width: int = 256,
        depth_fine: Optional[int] = None,
        width_fine: Optional[int] = None,
        coarse_rgb: bool = True,
        fine_budget: Optional[int] = None,
        coarse_share: int = 1,
        sigma_grid=None,
        skip: int = 4,
        device: DeviceLike = None,
    ) -> "FusedNerfRenderer":
        """``params_*``: ``NerfMLP`` state dicts (see tgtc_torch.convert)."""
        _reject_unported(fine_budget, coarse_share, sigma_grid)
        dev = resolve_device(device)
        pc = pack_nerf_params(params_coarse, depth=depth, skip=skip,
                              num_freq_coor=num_freq_coor,
                              num_freq_dir=num_freq_dir, width=width, device=dev)
        pf = pack_nerf_params(params_fine, depth=depth_fine or depth, skip=skip,
                              num_freq_coor=num_freq_coor,
                              num_freq_dir=num_freq_dir,
                              width=width_fine or width, device=dev)
        return cls(pc, pf, settings, coarse_rgb=coarse_rgb)

    def render(self, rays_o: torch.Tensor, rays_d: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        return self._fn(self.packed_coarse, self.packed_fine, rays_o, rays_d)

    def render_image(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     block: int = 16384) -> Dict[str, torch.Tensor]:
        """Any ray count by :func:`render_in_blocks`."""
        return render_in_blocks(lambda bo, bd, start: self.render(bo, bd), rays_o, rays_d,
                                block)


def render_in_blocks(render_block: Callable[[torch.Tensor, torch.Tensor, int],
                                            Dict[str, torch.Tensor]],
                     rays_o: torch.Tensor, rays_d: torch.Tensor,
                     block: int = 16384) -> Dict[str, torch.Tensor]:
    """Rays ``[N, 3]`` through ``render_block(bo, bd, start)`` in fixed
    blocks of ``block`` rays, ``start`` being the block's first ray; the
    tail block is padded with zero origins and unit directions."""
    n = rays_o.shape[0]
    outs = []
    for start in range(0, n, block):
        end = min(start + block, n)
        bo, bd = rays_o[start:end], rays_d[start:end]
        if end - start < block:
            pad = block - (end - start)
            bo = torch.cat([bo, bo.new_zeros((pad, 3))], 0)
            bd = torch.cat([bd, bd.new_ones((pad, 3))], 0)
        out = render_block(bo, bd, start)
        outs.append({k: v[: end - start] for k, v in out.items()})
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}
