"""Fused stylized-point kernels K4/K5 and their plain PyTorch twins.

Port of tgtc/ops/pallas/style_kernel.py. The CUDA kernels live in
``tgtc_torch/csrc/style_kernel.cu`` (hand-written for sm_90a, built at
first use by :mod:`tgtc_torch.ops.kernels._build`):

* K4 :func:`fused_style_apply_t` replaces the Pallas ``fused_style_apply_t``
  — per point the frozen NeRF trunk (σ and 256-d ``base_remap``), the
  concat MLP on ``[enc(pts) | latent]``, the style MLP on ``[base_remap |
  concat_features | enc(pts)]`` with its scalar-mean latent as a rank-1
  term, then a sigmoid: ``pts_t [3, P]`` and per-ray latents ``lat [R, D]``
  (point p reads row ``p // samples_per_ray``) → ``rgb [3, P]``, ``sigma
  [1, P]``;
* K5 :func:`fused_sigma_apply_t` replaces the Pallas ``fused_sigma_apply_t``
  — the trunk alone, ``pts_t [3, P]`` → ``sigma [1, P]``, bit for bit K4's σ
  (and K2's on the same trunk: all three run one device function).

The latents are taken per ray, not per point: the JAX renderer broadcasts
them to ``[D, R*S]`` (268 MB of f32 for a 16,384-ray fine block).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
twin (``*_plain``) only for CPU tensors. The twins follow ``_make_kernel``'s
arithmetic: bf16 operands and latents, f32 sums, bias (+ rank-1 term) +
ReLU in f32 then a bf16 round after every layer, the rank-1 term as the
bf16-rounded row sum of a layer's latent columns times the f32 mean of the
bf16 latent. ``launches`` on each wrapper counts kernel launches only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from tgtc_torch.ops.kernels import _build
from tgtc_torch.ops.kernels.nerf_mlp import (
    TRUNK_W,
    _bf16,
    _linear,
    _offsets,
    _raise_on,
    _round16,
    _trunk_sigma_plain,
    check_points,
    flatten_layers,
)

# the only shape the CUDA kernels take: (trunk depth, skip, trunk width,
# point frequencies, style_d, style width, latent dim)
CUDA_SHAPE = (8, 4, 256, 10, 8, 256, 32)


@dataclasses.dataclass(frozen=True)
class PackedStyle:
    """GPU-packed weights of one trunk and both style MLPs: one bf16 buffer
    of row-major ``[out, in_padded]`` matrices, one f32 buffer of
    bf16-rounded vectors (every layer's bias, then the latent row sums of
    the style layers and ``rgb_out``), and the element offsets of each.

    Matrices, in order: trunk 0..depth-1, base_remap, sigma (the indices of
    :class:`~tgtc_torch.ops.kernels.nerf_mlp.PackedNerf`), the concat layers,
    the style layers, rgb_out. Input columns keep the reference's order with
    the latent columns left out of the style layers (they become the rank-1
    term) and ``enc(pts)`` padded to a multiple of 16."""

    w: torch.Tensor
    b: torch.Tensor
    offsets: Tuple[int, ...]  # matrices, then biases, then latent row sums
    depth: int
    skip: int
    width: int  # trunk width
    num_freq_coor: int
    style_d: int
    style_width: int
    latent_dim: int

    @property
    def k_coor(self) -> int:
        return _round16(3 + 6 * self.num_freq_coor)

    @property
    def n_concat(self) -> int:
        return min(self.style_d - 1, self.skip + 1)

    def concat_index(self, i: int) -> int:
        return self.depth + 2 + i

    def style_index(self, i: int) -> int:
        """Style layer ``i`` (``i == style_d - 1`` is rgb_out)."""
        return self.depth + 2 + self.n_concat + i

    def layers(self) -> List[Tuple[int, int]]:
        """``(out, in_padded)`` of every packed matrix."""
        tw, kc, sw, nl = self.width, self.k_coor, self.style_width, self.latent_dim
        shapes = [(tw, kc)]
        for i in range(1, self.depth):
            shapes.append((tw, kc + tw) if i == self.skip + 1 else (tw, tw))
        shapes += [(TRUNK_W, tw), (1, tw)]
        for i in range(self.n_concat):
            shapes.append((sw, (kc if i == 0 else sw) + nl + (kc if i == self.skip else 0)))
        for i in range(self.style_d - 1):
            shapes.append((sw, (TRUNK_W + sw + kc if i == 0 else sw)
                           + (kc if i == self.skip else 0)))
        return shapes + [(3, sw)]

    def weight(self, i: int) -> torch.Tensor:
        n, k = self.layers()[i]
        off = self.offsets[i]
        return self.w[off: off + n * k].view(n, k)

    def bias(self, i: int) -> torch.Tensor:
        n = self.layers()[i][0]
        off = self.offsets[len(self.layers()) + i]
        return self.b[off: off + n]

    def lsum(self, i: int) -> torch.Tensor:
        """bf16-rounded row sums of style layer ``i``'s latent columns."""
        n = self.layers()[self.style_index(i)][0]
        off = self.offsets[2 * len(self.layers()) + i]
        return self.b[off: off + n]

    def to(self, device) -> "PackedStyle":
        return dataclasses.replace(self, w=self.w.to(device), b=self.b.to(device))


def _columns(w: torch.Tensor, parts: List[Tuple[str, int]], kc: int
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Split ``w [out, in]`` by ``parts`` (name, width) in column order:
    ``"x"`` parts (``enc(pts)``) are zero-padded to ``kc`` columns, a
    ``"lat_sum"`` part is summed over its columns and returned apart (None
    if there is none), every other part is kept as it is."""
    kept, lsum, col = [], None, 0
    for name, n in parts:
        piece = w[:, col: col + n]
        col += n
        if name == "x":
            kept.append(torch.nn.functional.pad(piece, (0, kc - n)))
        elif name == "lat_sum":
            lsum = piece.sum(1)
        else:
            kept.append(piece)
    if col != w.shape[1]:
        raise ValueError(f"layer has {w.shape[1]} input columns, expected {col}")
    return torch.cat(kept, dim=1), lsum


def pack_style_params(
    nerf_state_dict: Dict[str, torch.Tensor],
    concat_state_dict: Dict[str, torch.Tensor],
    style_state_dict: Dict[str, torch.Tensor],
    depth: int = 8,
    num_freq_coor: int = 10,
    skip: int = 4,
    style_d: int = 8,
    style_width: int = 256,
    latent_dim: int = 32,
    trunk_width: int = 256,
    device=None,
) -> PackedStyle:
    """Pack a ``NerfMLP`` state dict (its rgb head is not used) and the two
    style MLPs' state dicts into a :class:`PackedStyle` on ``device``."""
    def get(sd, name):
        return (sd[f"{name}.weight"].detach().float().cpu(),
                sd[f"{name}.bias"].detach().float().cpu())

    proto = PackedStyle(torch.empty(0), torch.empty(0), (), depth, skip, trunk_width,
                        num_freq_coor, style_d, style_width, latent_dim)
    in_c, kc, sw, nl = 3 + 6 * num_freq_coor, proto.k_coor, style_width, latent_dim

    mats, biases, lsums = [], [], []
    for i in range(depth):
        wi, bi = get(nerf_state_dict, f"base_layers.{i}")
        if i == 0:
            wi, _ = _columns(wi, [("x", in_c)], kc)
        elif i == skip + 1:
            wi, _ = _columns(wi, [("x", in_c), ("h", trunk_width)], kc)
        mats.append(wi)
        biases.append(bi)
    for name in ("base_remap_layer", "sigma_layer"):
        wi, bi = get(nerf_state_dict, name)
        mats.append(wi)
        biases.append(bi)
    for i in range(proto.n_concat):
        wi, bi = get(concat_state_dict, f"layers.{i}")
        parts = [("x", in_c) if i == 0 else ("h", sw), ("lat", nl)]
        wi, _ = _columns(wi, parts + ([("x", in_c)] if i == skip else []), kc)
        mats.append(wi)
        biases.append(bi)
    for i in range(style_d):
        wi, bi = get(style_state_dict, f"layers.{i}")
        if i == 0:
            parts = [("br", TRUNK_W), ("h", sw), ("x", in_c), ("lat_sum", nl)]
        else:
            parts = [("h", sw), ("lat_sum", nl)]
        if i == skip and i < style_d - 1:
            parts.append(("x", in_c))
        wi, lsum = _columns(wi, parts, kc)
        mats.append(wi)
        biases.append(bi)
        lsums.append(lsum)
    w, b, offsets = flatten_layers(mats, biases + lsums, proto.layers())
    packed = dataclasses.replace(proto, w=w, b=b, offsets=offsets)
    return packed.to(device) if device is not None else packed


# ---------------------------------------------------------------- twins


def _point_latents(lat: torch.Tensor, samples_per_ray: int, p: int) -> torch.Tensor:
    """bf16-valued per-point latents ``[P, D]`` from per-ray ``lat [R, D]``."""
    if lat.shape[0] * samples_per_ray != p:
        raise ValueError(f"lat has {lat.shape[0]} rows x {samples_per_ray} samples per ray, "
                         f"points {p}")
    return _bf16(lat.float()).repeat_interleave(samples_per_ray, dim=0)


def _style_rgb_plain(packed: PackedStyle, e_c: torch.Tensor, h: torch.Tensor,
                     lat: torch.Tensor) -> torch.Tensor:
    """rgb ``[P, 3]`` from the trunk's encoding ``e_c``, last trunk layer
    ``h`` and bf16-valued point latents ``lat`` (the kernel's steps)."""
    br = _bf16(torch.relu(_linear(h, packed, packed.depth)))
    lmean = lat.mean(dim=-1, keepdim=True)  # the scalar-mean latent, f32
    cf = e_c
    for i in range(packed.n_concat):
        parts = [cf, lat] + ([e_c] if i == packed.skip else [])
        cf = _bf16(torch.relu(_linear(torch.cat(parts, dim=-1), packed,
                                      packed.concat_index(i))))

    def rank1(x: torch.Tensor, i: int) -> torch.Tensor:
        j = packed.style_index(i)
        return x @ packed.weight(j).float().T + packed.lsum(i) * lmean + packed.bias(j)

    s = torch.cat([br, cf, e_c], dim=-1)
    for i in range(packed.style_d - 1):
        parts = [s] + ([e_c] if i == packed.skip else [])
        s = _bf16(torch.relu(rank1(torch.cat(parts, dim=-1), i)))
    return torch.sigmoid(rank1(s, packed.style_d - 1))


def fused_style_apply_t_plain(packed: PackedStyle, pts_t: torch.Tensor, lat: torch.Tensor,
                              samples_per_ray: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K4: ``pts_t [3, P]``, ``lat [R, D]`` with ``R *
    samples_per_ray == P`` → ``(rgb [3, P], sigma [1, P])`` f32."""
    e_c, h, sigma = _trunk_sigma_plain(packed, pts_t)
    lat_p = _point_latents(lat, samples_per_ray, pts_t.shape[1])
    return _style_rgb_plain(packed, e_c, h, lat_p).T.contiguous(), sigma


def fused_sigma_apply_t_plain(packed: PackedStyle, pts_t: torch.Tensor) -> torch.Tensor:
    """Plain twin of K5: ``pts_t [3, P]`` → ``sigma [1, P]`` f32."""
    return _trunk_sigma_plain(packed, pts_t)[2]


# ---------------------------------------------------------------- kernels


def _check_cuda(packed: PackedStyle, pts_t: torch.Tensor) -> int:
    shape = (packed.depth, packed.skip, packed.width, packed.num_freq_coor,
             packed.style_d, packed.style_width, packed.latent_dim)
    if shape != CUDA_SHAPE:
        raise NotImplementedError(
            "the CUDA style kernels take trunk D8/W256 with skip 4 and 10 frequencies, "
            f"style_d 8, style width 256 and latent 32; got {shape} (no tgtc path or "
            "configs/*.txt reaches other widths; the plain twins take them on the CPU)")
    return check_points(packed, pts_t)


@functools.cache
def _style_lib() -> ctypes.CDLL:
    """The kernels' library, built and bound on the first launch."""
    lib = _build.load("style_kernel")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tgtc_style_fwd.argtypes = [vp, vp, ll, i, vp, vp, vp, vp, vp, vp]
    lib.tgtc_style_fwd.restype = i
    lib.tgtc_style_sigma.argtypes = [vp, ll, vp, vp, vp, vp, vp]
    lib.tgtc_style_sigma.restype = i
    for smem in (lib.tgtc_style_fwd_smem, lib.tgtc_style_sigma_smem):
        smem.argtypes = []
        smem.restype = i
    return lib


def fused_style_apply_t(packed: PackedStyle, pts_t: torch.Tensor, lat: torch.Tensor,
                        samples_per_ray: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``pts_t [3, P]`` f32, per-ray ``lat [R, D]`` f32 with ``R *
    samples_per_ray == P`` → ``(rgb [3, P], sigma [1, P])``."""
    if pts_t.device.type == "cpu":
        return fused_style_apply_t_plain(packed, pts_t, lat, samples_per_ray)
    p = _check_cuda(packed, pts_t)
    if (lat.device != pts_t.device or lat.dtype != torch.float32 or not lat.is_contiguous()
            or lat.shape != (lat.shape[0], packed.latent_dim)):
        raise TypeError(f"expected contiguous f32 latents [R, {packed.latent_dim}] on "
                        f"{pts_t.device}, got {lat.dtype} {tuple(lat.shape)} on {lat.device}")
    if samples_per_ray < 1 or lat.shape[0] * samples_per_ray != p:
        raise ValueError(f"lat has {lat.shape[0]} rows x {samples_per_ray} samples per ray, "
                         f"points {p}")
    lib = _style_lib()
    rgb = torch.empty((3, p), dtype=torch.float32, device=pts_t.device)
    sigma = torch.empty((1, p), dtype=torch.float32, device=pts_t.device)
    stream = torch.cuda.current_stream(pts_t.device).cuda_stream
    rc = lib.tgtc_style_fwd(pts_t.data_ptr(), lat.data_ptr(), p, samples_per_ray,
                            packed.w.data_ptr(), packed.b.data_ptr(), _offsets(packed),
                            rgb.data_ptr(), sigma.data_ptr(), stream)
    _raise_on(rc, "tgtc_style_fwd")
    fused_style_apply_t.launches += 1
    return rgb, sigma


def fused_sigma_apply_t(packed: PackedStyle, pts_t: torch.Tensor) -> torch.Tensor:
    """K5: ``pts_t [3, P]`` f32 → ``sigma [1, P]`` (bitwise equal to K4's)."""
    if pts_t.device.type == "cpu":
        return fused_sigma_apply_t_plain(packed, pts_t)
    p = _check_cuda(packed, pts_t)
    lib = _style_lib()
    sigma = torch.empty((1, p), dtype=torch.float32, device=pts_t.device)
    stream = torch.cuda.current_stream(pts_t.device).cuda_stream
    rc = lib.tgtc_style_sigma(pts_t.data_ptr(), p, packed.w.data_ptr(), packed.b.data_ptr(),
                              _offsets(packed), sigma.data_ptr(), stream)
    _raise_on(rc, "tgtc_style_sigma")
    fused_sigma_apply_t.launches += 1
    return sigma


fused_style_apply_t.launches = 0
fused_sigma_apply_t.launches = 0
