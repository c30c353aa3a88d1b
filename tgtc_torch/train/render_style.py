"""Phase F — stylized frames — port of tgtc/train/render_style.py.

For every (style, pose) pair render the stylized chain coarse then fine and
write ``style_%05d_fine_%05d.png`` plus a normalised depth image
(``style_%05d_fine_depth_%05d.png``); ``skip_existing`` resumes a run.

* :func:`render_stylized_frames_fused` — the serving path on the fused
  kernels (:class:`~tgtc_torch.render.fast_style.FusedStyleRenderer`): the
  frame is assembled on the device (blocks concatenated, clipped, depth
  normalised and pooled, converted to uint8), copied to pinned host memory
  behind an event, and two frames stay in flight, so the card renders
  frame N+1 while the host encodes frame N's PNGs.
* :func:`make_stylized_render_fn` / :func:`render_stylized_views` — the
  eager f32-capable chain (:func:`~tgtc_torch.render.style.style_forward`),
  for layouts the kernels do not take; it is the fused frame's oracle.

Draws: each block's coarse jitter comes from a generator seeded by
``(seed, frame, block start)`` (:func:`~tgtc_torch.render.fast_style.block_generator`).
"""

from __future__ import annotations

import functools
import os
from collections import deque
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from tgtc_torch.models.nerf import NerfMLP
from tgtc_torch.models.style_field import StyleMLPBeforeConcat, StyleMLPWildMultilayers
from tgtc_torch.ops.sampling import merge_and_resample_fine, sample_along_rays_uniform
from tgtc_torch.parallel.mesh import DataGroup
from tgtc_torch.render.fast import render_in_blocks
from tgtc_torch.render.fast_style import render_blocks
from tgtc_torch.render.style import style_forward
from tgtc_torch.utils import native
from tgtc_torch.utils.img import to_uint8

DEPTH_PNG_MODES = ("full", "half", "off")


def _check_depth_png(depth_png: str) -> None:
    if depth_png not in DEPTH_PNG_MODES:
        raise ValueError(f"depth_png {depth_png!r} not in full/half/off")


def make_stylized_render_fn(
    nerf_coarse: NerfMLP,
    nerf_fine: NerfMLP,
    concat_model: StyleMLPBeforeConcat,
    style_model: StyleMLPWildMultilayers,
    n_samples: int,
    n_samples_fine: int,
    near: float,
    far: float,
    sigma_scale: float = 1.0,
    llff_tile: bool = True,
    group: Optional[DataGroup] = None,
    block: int = 16384,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Eager block renderer: ``(latent_state, rays_o [B, 3], rays_d,
    style_ids [B], frame_ids [B], u=None, generator=None) -> {"rgb",
    "t_exp", "rgb_coarse", "ts_fine"}`` (fine outputs; ``ts_fine`` the fine
    depths). The coarse depths are jittered by ``u [B, Nc]``, drawn from
    ``generator`` when not given; no σ noise, as the reference renders.

    With ``group`` (the JAX package's ``mesh=``,
    tgtc/train/render_style.py:28-56) the call's rays are rendered in
    ``block``-ray blocks over the group's processes by
    :func:`~tgtc_torch.render.fast.render_in_blocks`: every rank draws the
    call's whole ``u`` (as the 1-process call does) and renders its whole
    blocks of the 1-process block grid with their rows of ``u`` and of the
    ids, so every rank returns the rows of the same call with
    ``DataGroup()``, bit for bit."""

    @torch.no_grad()
    def render(latent_state, rays_o, rays_d, style_ids, frame_ids, u=None, generator=None):
        if u is None:
            u = torch.rand((rays_o.shape[0], n_samples), generator=generator,
                           device=rays_o.device)
        kw = dict(sigma_scale=sigma_scale, llff_tile=llff_tile)
        _, ts = sample_along_rays_uniform(rays_o, rays_d, n_samples, near=near, far=far, u=u)
        comp_c, weights = style_forward(nerf_coarse, concat_model, style_model, latent_state,
                                        rays_o, rays_d, ts, style_ids, frame_ids, **kw)
        _, ts_f = merge_and_resample_fine(rays_o, rays_d, ts, weights, n_samples_fine)
        comp_f, _ = style_forward(nerf_fine, concat_model, style_model, latent_state,
                                  rays_o, rays_d, ts_f, style_ids, frame_ids, **kw)
        return {"rgb": comp_f.rgb, "t_exp": comp_f.t_exp, "rgb_coarse": comp_c.rgb,
                "ts_fine": ts_f}

    if group is None:
        return render

    def render_grouped(latent_state, rays_o, rays_d, style_ids, frame_ids, u=None,
                       generator=None):
        n = rays_o.shape[0]
        if u is None:
            u = torch.rand((n, n_samples), generator=generator, device=rays_o.device)
        pad = -n % block  # the tail block's rows: ids of ray 0, zero jitter
        rows = lambda x: torch.cat([x, x[:1].expand(pad, *x.shape[1:])]) if pad else x
        sid, fid = rows(style_ids), rows(frame_ids)
        u = torch.cat([u, u.new_zeros((pad, n_samples))]) if pad else u
        return render_in_blocks(
            lambda bo, bd, s: render(latent_state, bo, bd, sid[s: s + block], fid[s: s + block],
                                     u=u[s: s + block]), rays_o, rays_d, block, group)

    return render_grouped


def _normalised_depth(t: torch.Tensor) -> torch.Tensor:
    return (t - t.min()) / (t.max() - t.min() + 1e-7)


def _pool_half(t: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling of ``t [H, W]`` (an odd last row/column dropped)."""
    h, w = t.shape
    hh, ww = (h // 2) * 2, (w // 2) * 2
    return t[:hh, :ww].reshape(hh // 2, 2, ww // 2, 2).mean(dim=(1, 3))


def _paths(out_dir: str, s: int, f: int):
    return (os.path.join(out_dir, f"style_{s:05d}_fine_{f:05d}.png"),
            os.path.join(out_dir, f"style_{s:05d}_fine_depth_{f:05d}.png"))


def render_stylized_views(
    render_fn: Callable[..., Dict[str, torch.Tensor]],
    latent_state: Dict[str, torch.Tensor],
    rays_o: torch.Tensor,  # [V, H, W, 3]
    rays_d: torch.Tensor,
    style_ids: Iterable[int],
    out_dir: str,
    seed: int = 0,
    block: int = 16384,
    skip_existing: bool = True,
    depth_png: str = "full",
) -> None:
    """Every (style, view) pair through the eager ``render_fn`` of
    :func:`make_stylized_render_fn`, PNGs written on the native thread
    pool. View ``f`` looks up latent frame ``f``."""
    _check_depth_png(depth_png)
    os.makedirs(out_dir, exist_ok=True)
    v, h, w, _ = rays_o.shape
    render = functools.partial(render_fn, latent_state)
    for s in style_ids:
        for f in range(v):
            path, dpath = _paths(out_dir, s, f)
            if skip_existing and os.path.exists(path):
                continue
            out = render_blocks(render, rays_o[f].reshape(-1, 3), rays_d[f].reshape(-1, 3), s,
                                f, block, seed)
            native.write_png_async(path, out["rgb"].reshape(h, w, 3).clamp(0, 1).cpu().numpy())
            if depth_png != "off":
                t = _normalised_depth(out["t_exp"].reshape(h, w))
                if depth_png == "half":
                    t = _pool_half(t)
                native.write_png_async(dpath, t[..., None].cpu().numpy())
    errs = native.wait_writes()
    if errs:
        raise IOError(f"{errs} async png writes failed in {out_dir}")


def _fetch_async(t: torch.Tensor):
    """Start ``t``'s copy to host memory; returns ``(host tensor, event)``.
    On a card the copy goes to pinned memory behind an event, so the host
    waits for this frame only; on the CPU it is the tensor itself."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def render_stylized_frames_fused(
    rend,                  # FusedStyleRenderer, or anything with its .render
    rays_o: torch.Tensor,  # [V, H, W, 3]
    rays_d: torch.Tensor,
    style_ids: Iterable[int],
    out_dir: str,
    seed: int = 0,
    block: int = 16384,
    skip_existing: bool = True,
    frame_sink: Optional[Callable[[np.ndarray], None]] = None,
    depth_png: str = "full",
) -> int:
    """Phase F on the fused kernels, streamed; returns the number of frames
    rendered. ``frame_sink``, if given, receives each rgb frame as a host
    uint8 ``[H, W, 3]`` array in playback order. ``depth_png``: "full"
    (the reference's depth image), "half" (2x2-pooled on the device) or
    "off"."""
    _check_depth_png(depth_png)
    os.makedirs(out_dir, exist_ok=True)
    v, h, w, _ = rays_o.shape

    def dispatch_frame(s: int, f: int):
        out = render_blocks(rend.render, rays_o[f].reshape(-1, 3), rays_d[f].reshape(-1, 3),
                            s, f, block, seed)
        rgb8 = _fetch_async(to_uint8(out["rgb"]).reshape(h, w, 3))
        if depth_png == "off":
            return rgb8, None
        t = _normalised_depth(out["t_exp"].reshape(h, w))
        return rgb8, _fetch_async(to_uint8(_pool_half(t) if depth_png == "half" else t)[..., None])

    def flush(entry) -> None:
        path, dpath, (rgb8, ev), depth = entry
        if ev is not None:
            ev.synchronize()
        rgb_np = rgb8.numpy()
        native.write_png_async(path, rgb_np)
        if depth is not None:
            t8, ev_t = depth
            if ev_t is not None:
                ev_t.synchronize()
            native.write_png_async(dpath, t8.numpy())
        if frame_sink is not None:
            frame_sink(rgb_np)

    rendered, pending = 0, deque()
    for s in style_ids:
        for f in range(v):
            path, dpath = _paths(out_dir, s, f)
            if skip_existing and os.path.exists(path):
                continue
            rgb8, depth = dispatch_frame(s, f)
            while len(pending) >= 2:
                flush(pending.popleft())
            pending.append((path, dpath, rgb8, depth))
            rendered += 1
    while pending:
        flush(pending.popleft())
    errs = native.wait_writes()
    if errs:
        raise IOError(f"{errs} async png writes failed in {out_dir}")
    return rendered
