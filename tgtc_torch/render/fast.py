"""Fused bulk render: CUDA trunk kernels + PyTorch sampling/compositing.

Port of tgtc/render/fast.py — the plain renders, the Phase-B geometry dump
and the bench path:

    stratified sample → K2 σ-only (or K1) coarse → composite weights →
    inverse-CDF resample → K1 fine → composite

Points are built feature-major ``[3, R*S]`` straight from the ray tensors,
the layout the kernels take. The proposal levers of the JAX package:

* ``fine_budget`` — K1 evaluates only each ray's ``fine_budget`` merged
  samples of highest estimated weight
  (:func:`~tgtc_torch.ops.sampling.select_sample_budget`);
* ``coarse_share`` — the proposal runs on every ``coarse_share``-th ray and
  its depths serve each group of consecutive rays;
* ``grid_spec`` — σ of the proposal is gathered from a voxel snapshot
  (:mod:`tgtc_torch.render.grid`) and no coarse trunk runs;
* a distilled proposal (:mod:`tgtc_torch.render.distill`) is the coarse
  net: its packing carries its own depth and width (K2 at width 128).

:func:`make_sharded_fused_render_fn` splits a frame's ray blocks over the
processes of a :class:`~tgtc_torch.parallel.DataGroup` (the JAX package's
``shard_map`` over a mesh), on the 1-process block grid of
:func:`render_in_blocks`.
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
from tgtc_torch.ops.sampling import sample_pdf, select_sample_budget, stratified_depths
from tgtc_torch.parallel.mesh import DataGroup
from tgtc_torch.render.grid import GridSpec, sample_sigma_grid
from tgtc_torch.render.volume import RenderSettings
from tgtc_torch.utils.logging import span


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


def check_levers(settings: RenderSettings, coarse_rgb: bool, fine_budget: Optional[int],
                 coarse_share: int, proposal: bool = False) -> Optional[int]:
    """The JAX package's checks of the proposal levers; returns the budget,
    None when it keeps every merged sample (the exact path). ``proposal``:
    a frozen-density proposal (grid or distilled) is in use."""
    nf = settings.n_samples + settings.n_samples_fine
    if fine_budget is not None and not 0 < fine_budget <= nf:
        raise ValueError(f"fine_budget {fine_budget} not in (0, {nf}]")
    if coarse_share < 1:
        raise ValueError(f"coarse_share {coarse_share} must be >= 1")
    if coarse_share > 1 and coarse_rgb:
        raise ValueError("coarse_share > 1 requires coarse_rgb=False: the shared coarse pass "
                         "is a sampling proposal, not a per-ray coarse image")
    if proposal and coarse_rgb:
        raise ValueError("a frozen-density proposal (grid_spec, proposal) requires "
                         "coarse_rgb=False: it has no coarse radiance")
    return None if fine_budget == nf else fine_budget


def coarse_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, coarse_share: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The proposal's rays: every ``coarse_share``-th ray, contiguous."""
    if rays_o.shape[0] % coarse_share:
        raise ValueError(f"ray count {rays_o.shape[0]} not divisible by coarse_share "
                         f"{coarse_share}")
    if coarse_share == 1:
        return rays_o, rays_d
    return rays_o[::coarse_share].contiguous(), rays_d[::coarse_share].contiguous()


def share_depths(x: Optional[torch.Tensor], coarse_share: int) -> Optional[torch.Tensor]:
    """A proposal ray's ``[Rc, K]`` row for each of its group's
    ``coarse_share`` rays: ``[Rc * coarse_share, K]``."""
    if x is None or coarse_share == 1:
        return x
    rc, k = x.shape
    return x[:, None, :].expand(rc, coarse_share, k).reshape(rc * coarse_share, k)


def make_fused_render_fn(
    settings: RenderSettings,
    coarse_rgb: bool = True,
    fine_budget: Optional[int] = None,
    coarse_share: int = 1,
    grid_spec: Optional[GridSpec] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``(packed_coarse, packed_fine, rays_o, rays_d, grid_values=None) ->
    outputs`` using the fused trunk kernels for both passes.
    ``coarse_rgb=False`` runs the σ-only kernel on the coarse pass (the fine
    image is identical). ``grid_spec``: the coarse σ is gathered from
    ``grid_values [Gx, Gy, Gz]`` and ``packed_coarse`` is not read. The ray
    count must divide by ``coarse_share``."""
    budget = check_levers(settings, coarse_rgb, fine_budget, coarse_share,
                          grid_spec is not None)
    nc, nf = settings.n_samples, settings.n_samples_fine

    @torch.no_grad()
    def render(pc: Optional[PackedNerf], pf: PackedNerf, rays_o: torch.Tensor,
               rays_d: torch.Tensor,
               grid_values: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        r = rays_o.shape[0]
        with span("tgtc.render.coarse"):
            ro_c, rd_c = coarse_rays(rays_o, rays_d, coarse_share)
            rc = ro_c.shape[0]
            ts = stratified_depths(ro_c, nc, near=settings.near, far=settings.far)
            if grid_spec is not None:
                sigma_c = sample_sigma_grid(grid_values, grid_spec,
                                            ro_c[:, None, :] + ts[..., None] * rd_c[:, None, :])
                weights_c = sigma_weights(sigma_c, ts)
            elif coarse_rgb:
                pt, dt = _points_t(ro_c, rd_c, ts)
                rgb_t, sigma_t = fused_nerf_apply_t(pc, pt, dt)
                sigma_c = sigma_t.reshape(rc, nc)
                comp_c = alpha_composite(rgb_t.reshape(3, rc, nc).permute(1, 2, 0), sigma_c, ts,
                                         white_bkgd=settings.white_bkgd)
                weights_c = comp_c.weights
            else:
                pt, _ = _points_t(ro_c, rd_c, ts, with_dirs=False)
                sigma_c = fused_nerf_sigma_apply_t(pc, pt).reshape(rc, nc)
                weights_c = sigma_weights(sigma_c, ts)
        with span("tgtc.render.resample"):
            ts_mid = 0.5 * (ts[..., 1:] + ts[..., :-1])
            t_new = sample_pdf(ts_mid, weights_c[..., 1:-1], nf)
            ts_f = torch.sort(torch.cat([ts, t_new], dim=-1), dim=-1).values
            deltas_f = None
            if budget is not None:
                # grid= holds: these coarse depths are the unperturbed linspace
                ts_f, deltas_f = select_sample_budget(ts_f, ts, sigma_c, budget,
                                                      grid=(settings.near, settings.far))
            ts_f = share_depths(ts_f, coarse_share)
            deltas_f = share_depths(deltas_f, coarse_share)
        with span("tgtc.render.fine"):
            n_eval = ts_f.shape[1]
            ptf, dtf = _points_t(rays_o, rays_d, ts_f)
            rgb_t, sigma_t = fused_nerf_apply_t(pf, ptf, dtf)
            comp_f = alpha_composite(rgb_t.reshape(3, r, n_eval).permute(1, 2, 0),
                                     sigma_t.reshape(r, n_eval), ts_f,
                                     white_bkgd=settings.white_bkgd, deltas=deltas_f)
            out = {"rgb": comp_f.rgb, "t_exp": comp_f.t_exp, "acc": comp_f.acc}
            if coarse_rgb:
                out["rgb_coarse"] = comp_c.rgb
                out["t_exp_coarse"] = comp_c.t_exp
        return out

    return render


@dataclasses.dataclass
class FusedNerfRenderer:
    """Packed kernel weights for coarse+fine, the levers and the grid
    (``sigma_grid``: ``(values, GridSpec)``). Build from ``NerfMLP`` state
    dicts with :meth:`from_params`; call :meth:`render` on flat ray blocks
    or :meth:`render_image` on any ray count."""

    packed_coarse: Optional[PackedNerf]  # None with the grid
    packed_fine: PackedNerf
    settings: RenderSettings
    coarse_rgb: bool = True
    fine_budget: Optional[int] = None
    coarse_share: int = 1
    sigma_grid: Optional[Tuple[torch.Tensor, GridSpec]] = None

    def __post_init__(self):
        self._fn = make_fused_render_fn(self.settings, self.coarse_rgb, self.fine_budget,
                                        self.coarse_share,
                                        self.sigma_grid[1] if self.sigma_grid else None)

    @property
    def device(self) -> torch.device:
        return self.packed_fine.w.device

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
        sigma_grid: Optional[Tuple[torch.Tensor, GridSpec]] = None,
        skip: int = 4,
        device: DeviceLike = None,
    ) -> "FusedNerfRenderer":
        """``params_*``: ``NerfMLP`` state dicts (see tgtc_torch.convert);
        the coarse net may be a distilled proposal (its ``depth`` and
        ``width``); with ``sigma_grid`` it is not packed."""
        dev = resolve_device(device)
        pc = None if sigma_grid is not None else pack_nerf_params(
            params_coarse, depth=depth, skip=skip, num_freq_coor=num_freq_coor,
            num_freq_dir=num_freq_dir, width=width, device=dev)
        pf = pack_nerf_params(params_fine, depth=depth_fine or depth, skip=skip,
                              num_freq_coor=num_freq_coor,
                              num_freq_dir=num_freq_dir,
                              width=width_fine or width, device=dev)
        if sigma_grid is not None:
            sigma_grid = (sigma_grid[0].to(dev), sigma_grid[1])
        return cls(pc, pf, settings, coarse_rgb, fine_budget, coarse_share, sigma_grid)

    def render(self, rays_o: torch.Tensor, rays_d: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        grid = self.sigma_grid[0] if self.sigma_grid else None
        return self._fn(self.packed_coarse, self.packed_fine, rays_o, rays_d, grid)

    def render_image(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     block: int = 16384) -> Dict[str, torch.Tensor]:
        """Any ray count by :func:`render_in_blocks`."""
        return render_in_blocks(lambda bo, bd, start: self.render(bo, bd), rays_o, rays_d,
                                block)


def make_sharded_fused_render_fn(settings: RenderSettings, group: DataGroup, block: int = 16384,
                                 **kw) -> Callable[..., Dict[str, torch.Tensor]]:
    """The fused render of a frame over ``group``'s processes (one per GPU):
    ``(packed_coarse, packed_fine, rays_o, rays_d, grid_values=None) ->
    outputs`` of every ray on every rank. ``kw`` are
    :func:`make_fused_render_fn`'s (the levers, ``grid_spec``,
    ``coarse_rgb``), as the JAX package's ``make_sharded_fused_render_fn``
    (tgtc/render/fast.py:307-350) takes them.

    Each rank renders whole ``block``-ray blocks of the 1-process block grid
    (:func:`render_in_blocks`): the same block starts and the same tail
    padding, so the composition of each block, any per-block draw and the
    kernels' shapes are the 1-process render's, and the frame equals it bit
    for bit. JAX asks for a ray count divisible by mesh × tile, because
    ``shard_map`` splits the ray axis evenly; splitting whole blocks has no
    such condition, so any ray count renders."""
    inner = make_fused_render_fn(settings, **kw)

    def render(pc: Optional[PackedNerf], pf: PackedNerf, rays_o: torch.Tensor,
               rays_d: torch.Tensor, grid_values: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        return render_in_blocks(lambda bo, bd, start: inner(pc, pf, bo, bd, grid_values),
                                rays_o, rays_d, block, group)

    return render


def block_range(n_blocks: int, group: DataGroup) -> Tuple[int, int]:
    """``(first, count)`` of the blocks this rank renders: contiguous, the
    first ``n_blocks % world`` ranks one more than the rest."""
    base, extra = divmod(n_blocks, group.world)
    return group.rank * base + min(group.rank, extra), base + (group.rank < extra)


def render_in_blocks(render_block: Callable[[torch.Tensor, torch.Tensor, int],
                                            Dict[str, torch.Tensor]],
                     rays_o: torch.Tensor, rays_d: torch.Tensor,
                     block: int = 16384, group: DataGroup = DataGroup()
                     ) -> Dict[str, torch.Tensor]:
    """Rays ``[N, 3]`` through ``render_block(bo, bd, start)`` in fixed
    blocks of ``block`` rays, ``start`` being the block's first ray; the
    tail block is padded with zero origins and unit directions.

    Over ``group``'s processes (world W > 1) each rank renders its
    :func:`block_range` of the ``ceil(N / block)`` blocks, and the rows are
    gathered (:meth:`DataGroup.gather_rows`, every rank's blocks padded to
    the largest share), so every rank returns all N rows. A rank with no
    block renders a padded block to learn the outputs' shapes and keeps
    none of it."""
    n = rays_o.shape[0]
    n_blocks = -(-n // block)
    first, count = block_range(n_blocks, group)
    outs = []
    for b in range(first, first + count) if count else [n_blocks]:
        start = b * block
        end = min(start + block, n)
        bo, bd = rays_o[start:end], rays_d[start:end]
        if end - start < block:
            pad = block - max(end - start, 0)
            bo = torch.cat([bo, bo.new_zeros((pad, 3))], 0)
            bd = torch.cat([bd, bd.new_ones((pad, 3))], 0)
        out = render_block(bo, bd, start)
        outs.append({k: v[: max(end - start, 0)] for k, v in out.items()})
    local = {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}
    if group.world == 1:
        return local
    share = -(-n_blocks // group.world) * block  # the largest rank's rows
    frame = {}
    for k, v in local.items():
        rows = group.gather_rows(torch.cat([v, v.new_zeros((share - v.shape[0], *v.shape[1:]))]))
        parts = []
        for r in range(group.world):
            f, c = block_range(n_blocks, DataGroup(None, r, group.world))
            parts.append(rows[r * share: r * share + min(c * block, n - f * block)])
        frame[k] = torch.cat(parts, 0)
    return frame
