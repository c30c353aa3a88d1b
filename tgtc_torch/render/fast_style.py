"""Fused stylized render (Phase F) — port of tgtc/render/fast_style.py.

Coarse→fine stylized render where each pass is one CUDA kernel launch:

    stratified (perturbed) samples → K5 σ-only (or K4) coarse → composite
    weights → inverse-CDF resample → K4 fine (trunk + concat MLP + style
    MLP) → composite

Latents are looked up per ray and handed to K4 as ``[R, D]`` with the
sample count, so no per-point latent tensor is built. The coarse jitter is
an explicit ``u [R / coarse_share, Nc]`` draw, or drawn from a
``torch.Generator``; :func:`render_blocks` seeds one generator per (frame,
block start). The levers are render.fast's (``fine_budget``,
``coarse_share``, ``grid_spec``), plus ``proposal``: the distilled
proposal's σ (K2 at width 128) in place of K5. The coarse depths are
perturbed here, so the budget's coarse bins are searched, not floored.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.models.style_field import lookup_latents
from tgtc_torch.ops.composite import alpha_composite, sigma_weights
from tgtc_torch.ops.kernels.nerf_mlp import (
    PackedNerf,
    fused_nerf_sigma_apply_t,
    pack_nerf_params,
)
from tgtc_torch.ops.kernels.style_kernel import (
    PackedStyle,
    fused_sigma_apply_t,
    fused_style_apply_t,
    pack_style_params,
)
from tgtc_torch.ops.sampling import sample_pdf, select_sample_budget, stratified_depths
from tgtc_torch.render.fast import (
    _points_t,
    check_levers,
    coarse_rays,
    render_in_blocks,
    share_depths,
)
from tgtc_torch.render.grid import GridSpec, sample_sigma_grid
from tgtc_torch.render.volume import RenderSettings
from tgtc_torch.utils.logging import span


def make_fused_style_render_fn(
    settings: RenderSettings,
    sigma_scale: float = 1.0,
    llff_tile: bool = True,
    coarse_rgb: bool = True,
    fine_budget: Optional[int] = None,
    coarse_share: int = 1,
    grid_spec: Optional[GridSpec] = None,
    proposal: bool = False,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``(packed_coarse, packed_fine, latent_state, rays_o [R, 3], rays_d,
    style_ids [R], frame_ids [R], u [R / coarse_share, Nc], grid_values=None,
    packed_proposal=None) -> {"rgb", "t_exp"}`` (plus ``"rgb_coarse"`` with
    ``coarse_rgb``). ``coarse_rgb=False`` runs K5 on the coarse pass: the
    fine image is bitwise the same. ``grid_spec`` takes σ from
    ``grid_values``; ``proposal`` from the distilled proposal's packing
    ``packed_proposal`` (K2 at its width). ``packed_coarse`` is not read
    with either."""
    if proposal and grid_spec is not None:
        raise ValueError("proposal and grid_spec are both frozen-density proposals: "
                         "pick one")
    budget = check_levers(settings, coarse_rgb, fine_budget, coarse_share,
                          grid_spec is not None or proposal)
    nc, nf = settings.n_samples, settings.n_samples_fine

    @torch.no_grad()
    def render(pc: Optional[PackedStyle], pf: PackedStyle,
               latent_state: Dict[str, torch.Tensor],
               rays_o: torch.Tensor, rays_d: torch.Tensor, style_ids: torch.Tensor,
               frame_ids: torch.Tensor, u: torch.Tensor,
               grid_values: Optional[torch.Tensor] = None,
               packed_proposal: Optional[PackedNerf] = None) -> Dict[str, torch.Tensor]:
        r = rays_o.shape[0]

        def run(packed: PackedStyle, ts: torch.Tensor, deltas=None):
            s = ts.shape[1]
            pt, _ = _points_t(rays_o, rays_d, ts, with_dirs=False)
            rgb_t, sigma_t = fused_style_apply_t(packed, pt, lat, samples_per_ray=s)
            sigma = sigma_t.reshape(r, s)
            return alpha_composite(rgb_t.reshape(3, r, s).permute(1, 2, 0), sigma, ts,
                                   white_bkgd=settings.white_bkgd, deltas=deltas), sigma

        with span("tgtc.render.coarse"):
            lat = lookup_latents(latent_state, style_ids, frame_ids, sigma_scale,
                                 llff_tile).float().contiguous()  # [R, D]
            ro_c, rd_c = coarse_rays(rays_o, rays_d, coarse_share)
            rc = ro_c.shape[0]
            ts = stratified_depths(ro_c, nc, near=settings.near, far=settings.far, u=u)
            if proposal:
                pt, _ = _points_t(ro_c, rd_c, ts, with_dirs=False)
                sigma_c = fused_nerf_sigma_apply_t(packed_proposal, pt).reshape(rc, nc)
            elif grid_spec is not None:
                sigma_c = sample_sigma_grid(grid_values, grid_spec,
                                            ro_c[:, None, :] + ts[..., None] * rd_c[:, None, :])
            elif coarse_rgb:
                comp_c, sigma_c = run(pc, ts)
            else:
                pt, _ = _points_t(ro_c, rd_c, ts, with_dirs=False)
                sigma_c = fused_sigma_apply_t(pc, pt).reshape(rc, nc)
            weights_c = comp_c.weights if coarse_rgb else sigma_weights(sigma_c, ts)
        with span("tgtc.render.resample"):
            ts_mid = 0.5 * (ts[..., 1:] + ts[..., :-1])
            t_new = sample_pdf(ts_mid, weights_c[..., 1:-1], nf)
            ts_f = torch.sort(torch.cat([ts, t_new], dim=-1), dim=-1).values
            deltas_f = None
            if budget is not None:
                # no grid=: these coarse depths are perturbed per ray
                ts_f, deltas_f = select_sample_budget(ts_f, ts, sigma_c, budget)
            ts_f = share_depths(ts_f, coarse_share)
            deltas_f = share_depths(deltas_f, coarse_share)
        with span("tgtc.render.fine"):
            comp_f, _ = run(pf, ts_f, deltas=deltas_f)
            out = {"rgb": comp_f.rgb, "t_exp": comp_f.t_exp}
            if coarse_rgb:
                out["rgb_coarse"] = comp_c.rgb
        return out

    return render


def block_generator(seed: int, frame: int, start: int, device) -> torch.Generator:
    """The generator of the coarse jitter of the block at ray ``start`` of
    frame ``frame``: one stream per (seed, frame, block start), as the JAX
    package folds its key."""
    state = np.random.SeedSequence((seed, frame, start)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def render_blocks(render: Callable[..., Dict[str, torch.Tensor]], rays_o: torch.Tensor,
                  rays_d: torch.Tensor, style_id: int, frame_id: int, block: int = 16384,
                  seed: int = 0) -> Dict[str, torch.Tensor]:
    """A frame's rays ``[N, 3]`` through ``render(bo, bd, style_ids,
    frame_ids, generator=...)`` by :func:`render_in_blocks`. Each block's
    jitter comes from :func:`block_generator` of ``(seed, frame_id, start)``."""
    dev = rays_o.device
    sid = torch.full((block,), style_id, dtype=torch.long, device=dev)
    fid = torch.full((block,), frame_id, dtype=torch.long, device=dev)
    return render_in_blocks(
        lambda bo, bd, start: render(bo, bd, sid, fid,
                                     generator=block_generator(seed, frame_id, start, dev)),
        rays_o, rays_d, block)


@dataclasses.dataclass
class FusedStyleRenderer:
    """Packed kernel weights (trunk + style MLPs) for the coarse and fine
    passes and the latent table. Build with :meth:`from_params`; call
    :meth:`render` on ray blocks or :meth:`render_image` on a frame."""

    packed_coarse: Optional[PackedStyle]  # None with the grid or the proposal
    packed_fine: PackedStyle
    latent_state: Dict[str, torch.Tensor]
    settings: RenderSettings
    sigma_scale: float = 1.0
    llff_tile: bool = True
    coarse_rgb: bool = True
    fine_budget: Optional[int] = None
    coarse_share: int = 1
    sigma_grid: Optional[Tuple[torch.Tensor, GridSpec]] = None  # (values, spec)
    proposal: Optional[PackedNerf] = None

    def __post_init__(self):
        self._fn = make_fused_style_render_fn(
            self.settings, self.sigma_scale, self.llff_tile, self.coarse_rgb,
            self.fine_budget, self.coarse_share,
            self.sigma_grid[1] if self.sigma_grid else None, self.proposal is not None)

    @property
    def device(self) -> torch.device:
        return self.packed_fine.w.device

    @classmethod
    def from_params(
        cls,
        nerf_params_coarse: Dict[str, torch.Tensor],
        nerf_params_fine: Dict[str, torch.Tensor],
        concat_params: Dict[str, torch.Tensor],
        style_params: Dict[str, torch.Tensor],
        latent_state: Dict[str, torch.Tensor],
        settings: RenderSettings,
        depth: int = 8,
        num_freq_coor: int = 10,
        style_d: int = 8,
        style_width: int = 256,
        latent_dim: int = 32,
        sigma_scale: float = 1.0,
        llff_tile: bool = True,
        trunk_width: int = 256,
        depth_fine: Optional[int] = None,
        trunk_width_fine: Optional[int] = None,
        coarse_rgb: bool = True,
        fine_budget: Optional[int] = None,
        coarse_share: int = 1,
        sigma_grid=None,
        proposal=None,
        skip: int = 4,
        device: DeviceLike = None,
    ) -> "FusedStyleRenderer":
        """``nerf_params_*``: ``NerfMLP`` state dicts; ``concat_params`` /
        ``style_params``: the style MLPs' state dicts (see
        tgtc_torch.convert); ``latent_state``: the latent table.
        ``sigma_grid``: ``(values, GridSpec)``; ``proposal``: ``(state dict,
        depth, width, num_freq_dir)`` of a distilled proposal ``NerfMLP``,
        packed here and run in place of the coarse trunk. With either the
        coarse trunk is not packed."""
        dev = resolve_device(device)
        kw = dict(num_freq_coor=num_freq_coor, skip=skip, style_d=style_d,
                  style_width=style_width, latent_dim=latent_dim, device=dev)
        pc = None if sigma_grid is not None or proposal is not None else pack_style_params(
            nerf_params_coarse, concat_params, style_params, depth=depth,
            trunk_width=trunk_width, **kw)
        pf = pack_style_params(nerf_params_fine, concat_params, style_params,
                               depth=depth_fine or depth,
                               trunk_width=trunk_width_fine or trunk_width, **kw)
        lat = {k: v.detach().float().to(dev) for k, v in latent_state.items()}
        if sigma_grid is not None:
            sigma_grid = (sigma_grid[0].to(dev), sigma_grid[1])
        if proposal is not None:
            p_par, p_depth, p_width, p_nfd = proposal
            proposal = pack_nerf_params(p_par, depth=p_depth, num_freq_coor=num_freq_coor,
                                        num_freq_dir=p_nfd, skip=skip, width=p_width,
                                        device=dev)
        return cls(pc, pf, lat, settings, sigma_scale, llff_tile, coarse_rgb, fine_budget,
                   coarse_share, sigma_grid, proposal)

    def render(self, rays_o: torch.Tensor, rays_d: torch.Tensor, style_ids: torch.Tensor,
               frame_ids: torch.Tensor, u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One ray block. The coarse jitter ``u [R / coarse_share, Nc]`` is
        drawn from ``generator`` when not given."""
        if u is None:
            u = torch.rand((rays_o.shape[0] // self.coarse_share, self.settings.n_samples),
                           generator=generator, device=rays_o.device)
        return self._fn(self.packed_coarse, self.packed_fine, self.latent_state, rays_o,
                        rays_d, style_ids, frame_ids, u,
                        self.sigma_grid[0] if self.sigma_grid else None, self.proposal)

    def render_image(self, rays_o: torch.Tensor, rays_d: torch.Tensor, style_id: int,
                     frame_id: int, block: int = 16384, seed: int = 0
                     ) -> Dict[str, torch.Tensor]:
        """Any ray count by :func:`render_blocks`."""
        return render_blocks(self.render, rays_o, rays_d, style_id, frame_id, block, seed)
