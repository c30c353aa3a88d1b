"""Density-grid proposal — port of tgtc/render/grid.py.

After Phase A the density field is frozen, so its σ can be snapshotted once
into a dense voxel grid and the per-frame coarse pass becomes a trilinear
(or nearest) gather that steers the same resample / sample-budget machinery
(:mod:`tgtc_torch.ops.sampling`); ray and sample counts stay fixed.

* :class:`GridSpec` — the grid's bounds and interpolation;
* :func:`sample_sigma_grid` — the gather (plain PyTorch: the JAX version is
  XLA, not a Pallas kernel), border-clamped, on a flat ``int32`` index
  (``int64`` past 2^31 voxels);
* :func:`ray_bounds` — the sampled volume's bounds, reduced on the device;
* :func:`build_sigma_grid` — the fine trunk's σ on the lattice through K2
  (:func:`~tgtc_torch.ops.kernels.nerf_mlp.fused_nerf_sigma_apply_t`),
  max-pooled over each point and its 8 half-cell corner offsets;
* :func:`save_sigma_grid` / :func:`load_sigma_grid` — ``.npz`` with the JAX
  package's keys, so each package reads the other's files.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.ops.kernels.nerf_mlp import PackedNerf, fused_nerf_sigma_apply_t


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The grid's geometry: bounds ``lo``/``hi`` in ray space (NDC for llff
    scenes) and ``interp``, "trilinear" or "nearest"."""

    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    interp: str = "trilinear"

    def __post_init__(self):
        if self.interp not in ("trilinear", "nearest"):
            raise ValueError(f"interp {self.interp!r}")
        if not all(h > l for l, h in zip(self.lo, self.hi)):
            raise ValueError(f"degenerate grid bounds {self.lo} {self.hi}")


def sample_sigma_grid(values: torch.Tensor, spec: GridSpec, pts: torch.Tensor
                      ) -> torch.Tensor:
    """σ of the grid ``values [Gx, Gy, Gz]`` at ``pts [..., 3]``; points
    outside clamp to the border voxel."""
    f32 = dict(dtype=torch.float32, device=values.device)
    shape = torch.tensor(values.shape, **f32)
    lo, hi = torch.tensor(spec.lo, **f32), torch.tensor(spec.hi, **f32)
    u = (pts - lo) / (hi - lo) * (shape - 1.0)

    _, gy, gz = values.shape
    flat = values.reshape(-1)
    itype = torch.int32 if flat.numel() < 2 ** 31 else torch.int64

    def gather(ix, iy, iz):
        idx = (ix * gy + iy) * gz + iz
        return torch.index_select(flat, 0, idx.reshape(-1)).reshape(idx.shape)

    if spec.interp == "nearest":
        u = torch.minimum(torch.clamp(torch.round(u), min=0.0), shape - 1.0).to(itype)
        return gather(u[..., 0], u[..., 1], u[..., 2])

    u = torch.minimum(torch.clamp(u, min=0.0), shape - 1.0 - 1e-6)
    i0 = torch.floor(u).to(itype)
    f = u - i0
    i1 = torch.minimum(i0 + 1, torch.tensor(values.shape, dtype=itype, device=values.device) - 1)
    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    c00 = gather(x0, y0, z0) * (1 - fx) + gather(x1, y0, z0) * fx
    c01 = gather(x0, y0, z1) * (1 - fx) + gather(x1, y0, z1) * fx
    c10 = gather(x0, y1, z0) * (1 - fx) + gather(x1, y1, z0) * fx
    c11 = gather(x0, y1, z1) * (1 - fx) + gather(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def ray_bounds(rays_o, rays_d, near: float, far: float, margin: float = 0.01
               ) -> Tuple[Tuple, Tuple]:
    """Axis-aligned bounds of the sampled volume: min/max over every ray's
    near and far endpoints (sampling is linear in t), padded by ``margin``
    of the extent. Tensors reduce on their device; only six floats reach
    the host."""
    if isinstance(rays_o, torch.Tensor):
        ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        ends = torch.stack([ro + near * rd, ro + far * rd])
        lo = ends.amin(dim=(0, 1)).cpu().numpy()
        hi = ends.amax(dim=(0, 1)).cpu().numpy()
    else:
        a = np.asarray(rays_o) + near * np.asarray(rays_d)
        b = np.asarray(rays_o) + far * np.asarray(rays_d)
        pts = np.concatenate([a.reshape(-1, 3), b.reshape(-1, 3)], 0)
        lo, hi = pts.min(0), pts.max(0)
    pad = (hi - lo) * margin + 1e-6
    return tuple((lo - pad).tolist()), tuple((hi + pad).tolist())


def lattice_offsets(spec: GridSpec, resolution: Tuple[int, int, int]
                    ) -> Tuple[list, np.ndarray]:
    """The lattice's axes (f32, as the JAX package computes them) and the
    nine offsets σ is pooled over: the point itself, then the 8 half-cell
    corners."""
    lo = np.asarray(spec.lo, np.float32)
    hi = np.asarray(spec.hi, np.float32)
    axes = [np.linspace(lo[i], hi[i], n, dtype=np.float32) for i, n in enumerate(resolution)]
    cell = (hi - lo) / (np.asarray(resolution, np.float32) - 1)
    offsets = np.concatenate([
        np.zeros((1, 3), np.float32),
        np.stack(np.meshgrid(*([[-0.5, 0.5]] * 3), indexing="ij"), -1).reshape(-1, 3) * cell,
    ], 0).astype(np.float32)
    return axes, offsets


@torch.no_grad()
def build_sigma_grid(packed_fine: PackedNerf, spec: GridSpec,
                     resolution: Tuple[int, int, int], chunk: int = 1 << 21) -> torch.Tensor:
    """The fine trunk's σ (``packed_fine``, K2) on a ``resolution`` lattice
    over ``spec``'s bounds, each voxel the max over its lattice point and
    the 8 corners half a cell away, so thin surfaces between lattice points
    still register (an over-estimate costs a few fine samples, an
    under-estimate loses a surface). Built ``chunk`` lattice points a K2
    launch on ``packed_fine``'s device; returns ``[Gx, Gy, Gz]`` f32."""
    dev = packed_fine.w.device
    gx, gy, gz = resolution
    axes, offsets = lattice_offsets(spec, resolution)
    ax, ay, az = (torch.from_numpy(a).to(dev) for a in axes)
    n = gx * gy * gz
    out = torch.empty(n, dtype=torch.float32, device=dev)
    for start in range(0, n, chunk):
        idx = torch.arange(start, min(start + chunk, n), device=dev)
        lattice = (ax[idx // (gy * gz)], ay[(idx // gz) % gy], az[idx % gz])
        acc = None
        for off in offsets:
            pts_t = torch.stack([c + float(o) for c, o in zip(lattice, off)])
            s = fused_nerf_sigma_apply_t(packed_fine, pts_t).reshape(-1)
            acc = s if acc is None else torch.maximum(acc, s)
        out[start: start + idx.numel()] = acc
    return out.reshape(gx, gy, gz)


def save_sigma_grid(path: str, values: torch.Tensor, spec: GridSpec) -> None:
    np.savez_compressed(path, values=values.detach().cpu().numpy(), lo=np.asarray(spec.lo),
                        hi=np.asarray(spec.hi), interp=spec.interp)


def load_sigma_grid(path: str, device: DeviceLike = None) -> Tuple[torch.Tensor, GridSpec]:
    """A grid written by either package; values on ``device`` (the card
    unless the caller asks for the CPU)."""
    z = np.load(path, allow_pickle=False)
    spec = GridSpec(lo=tuple(z["lo"].tolist()), hi=tuple(z["hi"].tolist()),
                    interp=str(z["interp"]))
    return torch.from_numpy(z["values"]).to(resolve_device(device)), spec
