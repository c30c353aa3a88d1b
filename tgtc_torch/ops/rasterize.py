"""Point-splat rasterizer and camera math — port of tgtc/ops/rasterize.py.

Splats a coloured 3-D point cloud into B target views with a z-buffer and
returns (warped features, hit mask); Phase C2's temporal loss warps view
0's stylized patch into every view with it. The reference uses pytorch3d's
point rasterizer; the JAX package replaced it with a two-pass segment-min
z-buffer, and this port keeps that design:

* every point is projected to continuous pixel coordinates and offered to
  the ``(2·ceil(r) + 1)²`` pixel centres around its rounded position; a
  candidate is valid if its centre lies within ``r`` pixels, inside the
  image, and the point is in front of the camera;
* pass 1 takes the least depth per pixel (``index_reduce_`` "amin" into a
  buffer of +inf), pass 2 the least point index among the candidates at
  that depth (into a buffer of N, the "no point" sentinel, which is what an
  empty segment of the JAX package's ``segment_min`` yields too);
* the features are gathered at the winners and zeroed where none hit.

All B views go at once, each with its own ``h·w`` slots at a view offset,
and the slot ids are int32. The JAX package sends every invalid candidate
to one dump slot; here they go to ``DUMP_SLOTS`` dump slots after the
views', in turn, so that the GPU's atomic ``amin`` does not queue ~3/4 of
the candidates on one address a view. ``amin`` does not depend on the
order of the candidates, so the forward is deterministic on every device.
The result is differentiable with respect to ``features`` only (the
gather's backward is a scatter-add; on CUDA PyTorch sorts the rows and
adds each row's duplicates in order, and it repeats bit for bit on an
H100).

The projection is written out as sums of products in f32 (no matmul, so
TF32 cannot enter). ``torch.round`` rounds half to even, as ``jnp.round``.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# |pixel coordinate| past which a point cannot be a candidate: the float
# → int32 cast is clamped there so that it is defined for any projection
_PX_LIMIT = float(1 << 24)
DUMP_SLOTS = 1 << 16  # where invalid candidates go, in turn (a power of two)


def llff_projection_matrix(h: int, w: int, focal: float, near: float = 1e-3, far: float = 1e5,
                           cx: Optional[float] = None, cy: Optional[float] = None) -> np.ndarray:
    """The reference's OpenGL-style projection (train_style_modules.py:394-400)."""
    cx = w / 2 if cx is None else cx
    cy = h / 2 if cy is None else cy
    return np.array(
        [
            [-2 * focal / w, 0, 1 - 2 * cx / w, 0],
            [0, 2 * focal / h, 2 * cy / h - 1, 0],
            [0, 0, -(far + near) / (far - near), -2 * far * near / (far - near)],
            [0, 0, -1, 0],
        ],
        np.float32,
    )


def ndc_to_world(coor_ndc: torch.Tensor, h: int, w: int, focal: float) -> torch.Tensor:
    """Invert the LLFF NDC projection of coor maps ``[..., 3]``."""
    z = 2.0 / (coor_ndc[..., 2] - 1.0)
    x = -w / 2.0 / focal * z * coor_ndc[..., 0]
    y = -h / 2.0 / focal * z * coor_ndc[..., 1]
    return torch.stack([x, y, z], dim=-1)


def _apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m [..., 4, 4] @ v [..., 4]`` as four explicit products a row."""
    return (m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2]
            + m[..., 2] * v[..., 2:3] + m[..., 3] * v[..., 3:4])


def world_to_cvv(coor_world: torch.Tensor, w2c: torch.Tensor, proj: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World → canonical view volume: ``(cvv [..., 3], w_clip [...])``;
    ``w_clip > 0`` marks points in front of the camera. ``w2c [..., 4, 4]``
    broadcasts against the points' leading axes."""
    hom = torch.cat([coor_world, torch.ones_like(coor_world[..., :1])], dim=-1)
    clip = _apply(proj, _apply(w2c, hom))
    w_clip = clip[..., 3]
    cvv = clip[..., :3] / torch.where(w_clip == 0, 1e-8, w_clip)[..., None]
    return cvv, w_clip


def cvv_to_pixel(cvv: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cvv → continuous ``(px, py)``: +1 maps to pixel 0 and −1 to the last
    pixel on both axes (the mapping the reference recovers with its
    PixeltoCvv probe)."""
    px = (1.0 - (cvv[..., 0] + 1.0) / 2.0) * (w - 1)
    py = (1.0 - (cvv[..., 1] + 1.0) / 2.0) * (h - 1)
    return px, py


def _index_amin(fill, n: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    with warnings.catch_warnings():  # index_reduce_ is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return out.index_reduce_(0, index, values, "amin", include_self=True)


def splat_winners(coor_world: torch.Tensor, w2c: torch.Tensor, proj: torch.Tensor, h: int,
                  w: int, radius: float = 1.5) -> torch.Tensor:
    """The z-buffer's winner per pixel: ``[B, h, w]`` int32 point indices
    into ``coor_world [N, 3]``, N where no point covers the pixel. ``w2c
    [B, 4, 4]`` are world → camera matrices of the target views. A pixel
    takes the nearest covering point, the smallest index among equal
    depths."""
    n, b = coor_world.shape[0], w2c.shape[0]
    dev = coor_world.device
    r_int = int(math.ceil(radius))
    offs = torch.arange(-r_int, r_int + 1, dtype=torch.int32, device=dev)
    oy, ox = (o.reshape(-1) for o in torch.meshgrid(offs, offs, indexing="ij"))  # [K]
    k = ox.shape[0]

    cvv, w_clip = world_to_cvv(coor_world, w2c[:, None], proj)  # [B, N, 3], [B, N]
    px, py = cvv_to_pixel(cvv, h, w)
    in_front = w_clip > 1e-6
    cx = torch.round(px).clamp(-_PX_LIMIT, _PX_LIMIT).to(torch.int32)[..., None] + ox
    cy = torch.round(py).clamp(-_PX_LIMIT, _PX_LIMIT).to(torch.int32)[..., None] + oy
    d2 = (cx.float() - px[..., None]) ** 2 + (cy.float() - py[..., None]) ** 2  # [B, N, K]
    valid = ((d2 <= radius * radius) & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
             & in_front[..., None])
    pixels = b * h * w
    base = (torch.arange(b, dtype=torch.int32, device=dev) * (h * w))[:, None, None]
    dump = pixels + (torch.arange(b * n * k, dtype=torch.int32, device=dev)
                     & (DUMP_SLOTS - 1)).reshape(b, n, k)
    pid = torch.where(valid, cy * w + cx + base, dump).reshape(-1)

    depth = torch.where(valid, cvv[..., 2:3].expand(b, n, k), math.inf).reshape(-1)
    min_depth = _index_amin(math.inf, pixels + DUMP_SLOTS, pid, depth)
    idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :, None].expand(b, n, k)
    is_win = (depth <= min_depth[pid] + 0.0) & valid.reshape(-1)
    key = torch.where(is_win, idx.reshape(-1), n)
    win = _index_amin(n, pixels + DUMP_SLOTS, pid, key)
    return win[:pixels].reshape(b, h, w)


def gather_winners(features: torch.Tensor, win: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``features [N, F]`` at :func:`splat_winners`' ``win [B, h, w]``:
    ``(warped [B, h, w, F], mask [B, h, w, 1])``, zero where no point hit.

    An empty pixel reads a row that its mask then zeroes. The JAX package
    reads row N - 1 for all of them; here pixel ``i`` reads row ``i mod
    N``. The values and the gradient are the same (the mask zeroes both),
    but the gather's backward on CUDA, which adds up each row's duplicates
    one after the other, no longer meets ~2.9 M of them on one row (the
    empty pixels of a C2 step, of 3 M)."""
    n = features.shape[0]
    hit = win < n
    spread = torch.arange(win.numel(), device=win.device).reshape(win.shape) % n
    rows = torch.where(hit, win.long(), spread)
    mask = hit[..., None].to(features.dtype)
    return features[rows] * mask, mask


def splat_points(coor_world: torch.Tensor, features: torch.Tensor, w2c: torch.Tensor,
                 proj: torch.Tensor, h: int, w: int, radius: float = 1.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z-buffer splat of ``features [N, F]`` at ``coor_world [N, 3]`` into
    B views (``w2c [B, 4, 4]``): ``(warped [B, h, w, F], mask [B, h, w,
    1])``. Each pixel takes the features of the nearest point whose
    projection lies within ``radius`` pixels of its centre (the reference's
    pytorch3d ``radius=1.5``, ``z=1``)."""
    return gather_winners(features, splat_winners(coor_world, w2c, proj, h, w, radius))


def rasterize_warp(coor_world: torch.Tensor, rgb: torch.Tensor, cam_poses: torch.Tensor,
                   proj: torch.Tensor, h: int, w: int, radius: float = 1.5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``Camera.rasterize``: the source view's colours
    ``rgb [N, 3]`` and world coordinates warped into each target view of
    the camera-to-world ``cam_poses [B, 4, 4]`` (inverted in f32):
    ``(rgb_map [B, h, w, 3], coor_map [B, h, w, 3], mask [B, h, w, 1])``."""
    w2c = torch.linalg.inv(cam_poses)
    feats = torch.cat([rgb, coor_world], dim=-1)
    warped, mask = splat_points(coor_world, feats, w2c, proj, h, w, radius)
    return warped[..., :3], warped[..., 3:], mask


def rasterize_pyramid(coor_world: torch.Tensor, rgb: torch.Tensor, cam_poses: torch.Tensor,
                      proj: torch.Tensor, h: int, w: int,
                      radii: Sequence[float] = (0.7, 1.2, 1.7, 2.2)
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Splats over growing radii composited under the intersection of their
    hit masks (the reference's ``rasterize_pyramid``): ``(image, mask)``."""
    image = mask = None
    for r in radii:
        img, _, msk = rasterize_warp(coor_world, rgb, cam_poses, proj, h, w, radius=float(r))
        mask = msk if mask is None else mask * msk
        image = img if image is None else image + img * mask
    return image, mask
