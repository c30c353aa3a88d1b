"""Fused NeRF trunk kernels K1/K2 and their plain PyTorch twins.

Port of tgtc/ops/pallas/nerf_mlp.py. The CUDA kernels live in
``tgtc_torch/csrc/nerf_mlp.cu`` (hand-written for sm_90a, built at first
use by :mod:`tgtc_torch.ops.kernels._build`):

* K1 :func:`fused_nerf_apply_t` replaces the Pallas ``fused_nerf_apply_t``
  — ``pts_t/dirs_t [3, P]`` → ``rgb [3, P]``, ``sigma [1, P]``;
* K2 :func:`fused_nerf_sigma_apply_t` replaces the Pallas
  ``fused_nerf_sigma_apply_t`` — ``pts_t [3, P]`` → ``sigma [1, P]``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
twin (``*_plain``) only for CPU tensors. The twins follow the kernel's
arithmetic step by step: the same encoding, bf16 operands (bf16 σ/rgb head
weights and bf16-rounded biases included), f32 accumulation, bias + ReLU
in f32 then a bf16 round. ``launches`` on each wrapper counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from tgtc_torch.ops.kernels import _build

TRUNK_W = 256  # base_remap and the rgb head's input are 256 wide
CUDA_WIDTH, CUDA_FREQS = 256, (10, 4)  # the only shape the CUDA kernels take


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class PackedNerf:
    """GPU-packed trunk weights: one bf16 buffer of row-major
    ``[out, in_padded]`` matrices and one f32 bias buffer (bf16-rounded
    values), with the element offsets of each layer."""

    w: torch.Tensor
    b: torch.Tensor
    offsets: Tuple[int, ...]  # weight offsets, then bias offsets
    depth: int
    skip: int
    width: int
    num_freq_coor: int
    num_freq_dir: int

    @property
    def k_coor(self) -> int:
        return _round16(3 + 6 * self.num_freq_coor)

    @property
    def k_dir(self) -> int:
        return _round16(3 + 6 * self.num_freq_dir)

    def layers(self) -> List[Tuple[int, int]]:
        """``(out, in_padded)`` per packed layer: trunk 0..depth-1,
        base_remap, sigma, rgb_0, rgb_1."""
        w, kc = self.width, self.k_coor
        shapes = [(w, kc)]
        for i in range(1, self.depth):
            shapes.append((w, kc + w) if i == self.skip + 1 else (w, w))
        return shapes + [(TRUNK_W, w), (1, w), (w // 2, TRUNK_W + self.k_dir),
                         (3, w // 2)]

    def weight(self, i: int) -> torch.Tensor:
        n, k = self.layers()[i]
        off = self.offsets[i]
        return self.w[off: off + n * k].view(n, k)

    def bias(self, i: int) -> torch.Tensor:
        n = self.layers()[i][0]
        off = self.offsets[len(self.layers()) + i]
        return self.b[off: off + n]

    def to(self, device) -> "PackedNerf":
        return dataclasses.replace(self, w=self.w.to(device), b=self.b.to(device))


def pack_nerf_params(
    state_dict: Dict[str, torch.Tensor],
    depth: int = 8,
    num_freq_coor: int = 10,
    num_freq_dir: int = 4,
    skip: int = 4,
    width: int = 256,
    device=None,
) -> PackedNerf:
    """Pack a ``NerfMLP`` state dict (relu trunk with one skip, viewdir
    head) into a :class:`PackedNerf`. Input columns are zero-padded to a
    multiple of 16; the skip layer keeps the reference's input order
    ``[enc(pts) | h]`` and rgb_0 ``[base_remap | enc(dirs)]``."""
    in_c, in_d = 3 + 6 * num_freq_coor, 3 + 6 * num_freq_dir
    proto = PackedNerf(torch.empty(0), torch.empty(0), (), depth, skip, width,
                       num_freq_coor, num_freq_dir)
    kc, kd = proto.k_coor, proto.k_dir

    def get(name):
        return (state_dict[f"{name}.weight"].detach().float().cpu(),
                state_dict[f"{name}.bias"].detach().float().cpu())

    def place(cols: List[Tuple[torch.Tensor, int]], n: int, k: int):
        """``cols``: (source block, first padded column) pairs."""
        m = torch.zeros(n, k)
        for blk, c in cols:
            m[:, c: c + blk.shape[1]] = blk
        return m

    mats, biases = [], []
    w0, b0 = get("base_layers.0")
    mats.append(place([(w0, 0)], width, kc))
    biases.append(b0)
    for i in range(1, depth):
        wi, bi = get(f"base_layers.{i}")
        if i == skip + 1:
            mats.append(place([(wi[:, :in_c], 0), (wi[:, in_c:], kc)], width, kc + width))
        else:
            mats.append(wi)
        biases.append(bi)
    for name in ("base_remap_layer", "sigma_layer"):
        wi, bi = get(name)
        mats.append(wi)
        biases.append(bi)
    wr0, br0 = get("rgb_layers.0")
    if wr0.shape[1] != TRUNK_W + in_d:
        raise ValueError("pack_nerf_params needs the viewdir rgb head "
                         f"(rgb_layers.0 input {TRUNK_W + in_d}, got {wr0.shape[1]})")
    mats.append(place([(wr0[:, :TRUNK_W], 0), (wr0[:, TRUNK_W:], TRUNK_W)],
                      width // 2, TRUNK_W + kd))
    biases.append(br0)
    wr1, br1 = get("rgb_layers.1")
    mats += [wr1]
    biases += [br1]

    for m, (n, k) in zip(mats, proto.layers()):
        if tuple(m.shape) != (n, k):
            raise ValueError(f"layer shape {tuple(m.shape)} != expected {(n, k)}")
    w_offs, b_offs, w_flat, pos = [], [], [], 0
    for m in mats:
        w_offs.append(pos)
        w_flat.append(m.reshape(-1))
        pad = _round16(m.numel()) - m.numel()  # keep every layer 32-byte aligned
        if pad:
            w_flat.append(torch.zeros(pad))
        pos += m.numel() + pad
    pos = 0
    for bvec in biases:
        b_offs.append(pos)
        pos += bvec.numel()
    w = torch.cat(w_flat).to(torch.bfloat16)
    b = torch.cat(biases).to(torch.bfloat16).float()
    packed = dataclasses.replace(proto, w=w, b=b, offsets=tuple(w_offs + b_offs))
    return packed.to(device) if device is not None else packed


# ---------------------------------------------------------------- twins


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and hold the value in f32 (products of two such
    values are exact in f32, so an f32 matmul of them is a bf16 matmul
    with f32 accumulation)."""
    return x.to(torch.bfloat16).float()


def _encode_plain(x: torch.Tensor, nfreq: int, kpad: int) -> torch.Tensor:
    """``x [P, 3]`` → bf16-valued ``[P, kpad]``: ``[x, sin(2^0 x), cos(2^0
    x), ...]`` then zero columns."""
    feats = [x]
    for k in range(nfreq):
        arg = x * float(2 ** k)
        feats += [torch.sin(arg), torch.cos(arg)]
    enc = torch.cat(feats, dim=-1)
    enc = torch.nn.functional.pad(enc, (0, kpad - enc.shape[-1]))
    return _bf16(enc)


def _linear(x: torch.Tensor, packed: PackedNerf, i: int) -> torch.Tensor:
    return x @ packed.weight(i).float().T + packed.bias(i)


def _trunk_sigma_plain(packed: PackedNerf, pts_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    e_c = _encode_plain(pts_t.T.float(), packed.num_freq_coor, packed.k_coor)
    h = _bf16(torch.relu(_linear(e_c, packed, 0)))
    for i in range(1, packed.depth):
        inp = torch.cat([e_c, h], dim=-1) if i == packed.skip + 1 else h
        h = _bf16(torch.relu(_linear(inp, packed, i)))
    sigma = _linear(h, packed, packed.depth + 1)  # [P, 1]
    return e_c, h, sigma.T.contiguous()


def fused_nerf_sigma_apply_t_plain(packed: PackedNerf, pts_t: torch.Tensor
                                   ) -> torch.Tensor:
    """Plain twin of K2: ``pts_t [3, P]`` → ``sigma [1, P]`` f32."""
    return _trunk_sigma_plain(packed, pts_t)[2]


def fused_nerf_apply_t_plain(packed: PackedNerf, pts_t: torch.Tensor,
                             dirs_t: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K1: ``pts_t/dirs_t [3, P]`` → ``(rgb [3, P], sigma
    [1, P])`` f32."""
    d = packed.depth
    _, h, sigma = _trunk_sigma_plain(packed, pts_t)
    e_d = _encode_plain(dirs_t.T.float(), packed.num_freq_dir, packed.k_dir)
    br = _bf16(torch.relu(_linear(h, packed, d)))
    rf = _bf16(torch.relu(_linear(torch.cat([br, e_d], dim=-1), packed, d + 2)))
    rgb = torch.sigmoid(_linear(rf, packed, d + 3))
    return rgb.T.contiguous(), sigma


# ---------------------------------------------------------------- kernels


def _check_cuda(packed: PackedNerf, *points: torch.Tensor) -> int:
    if (packed.width, (packed.num_freq_coor, packed.num_freq_dir)) != (
            CUDA_WIDTH, CUDA_FREQS):
        raise NotImplementedError(
            "the CUDA NeRF kernels take width 256 with 10/4 frequencies; got "
            f"width {packed.width}, frequencies {packed.num_freq_coor}/"
            f"{packed.num_freq_dir} (width 128 is a ROADMAP item)")
    p = points[0].shape[-1]
    for t in points:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"expected a float32 CUDA tensor, got {t.dtype} on {t.device}")
        if t.shape != (3, p) or not t.is_contiguous():
            raise ValueError(f"expected a contiguous [3, {p}] tensor, got {tuple(t.shape)}")
    for t in (packed.w, packed.b):
        if t.device != points[0].device or not t.is_contiguous():
            raise ValueError("packed weights must be contiguous on the points' device")
    if packed.w.dtype != torch.bfloat16 or packed.b.dtype != torch.float32:
        raise TypeError("packed weights must be bf16 with f32 biases")
    return p


def _offsets(packed: PackedNerf):
    return (ctypes.c_longlong * len(packed.offsets))(*packed.offsets)


@functools.cache
def _nerf_lib() -> ctypes.CDLL:
    """The kernels' library, built and bound on the first launch."""
    lib = _build.load("nerf_mlp")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tgtc_nerf_mlp_fwd.argtypes = [vp, vp, ll, vp, vp, vp, i, i, vp, vp, vp]
    lib.tgtc_nerf_mlp_fwd.restype = i
    lib.tgtc_nerf_mlp_sigma.argtypes = [vp, ll, vp, vp, vp, i, i, vp, vp]
    lib.tgtc_nerf_mlp_sigma.restype = i
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def fused_nerf_apply_t(packed: PackedNerf, pts_t: torch.Tensor,
                       dirs_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``pts_t/dirs_t [3, P]`` f32 → ``(rgb [3, P], sigma [1, P])``."""
    if pts_t.device.type == "cpu":
        return fused_nerf_apply_t_plain(packed, pts_t, dirs_t)
    p = _check_cuda(packed, pts_t, dirs_t)
    lib = _nerf_lib()
    rgb = torch.empty((3, p), dtype=torch.float32, device=pts_t.device)
    sigma = torch.empty((1, p), dtype=torch.float32, device=pts_t.device)
    stream = torch.cuda.current_stream(pts_t.device).cuda_stream
    rc = lib.tgtc_nerf_mlp_fwd(
        pts_t.data_ptr(), dirs_t.data_ptr(), p, packed.w.data_ptr(),
        packed.b.data_ptr(), _offsets(packed), packed.depth, packed.skip,
        rgb.data_ptr(), sigma.data_ptr(), stream)
    _raise_on(rc, "tgtc_nerf_mlp_fwd")
    fused_nerf_apply_t.launches += 1
    return rgb, sigma


def fused_nerf_sigma_apply_t(packed: PackedNerf, pts_t: torch.Tensor
                             ) -> torch.Tensor:
    """K2: ``pts_t [3, P]`` f32 → ``sigma [1, P]`` (bitwise equal to K1's)."""
    if pts_t.device.type == "cpu":
        return fused_nerf_sigma_apply_t_plain(packed, pts_t)
    p = _check_cuda(packed, pts_t)
    lib = _nerf_lib()
    sigma = torch.empty((1, p), dtype=torch.float32, device=pts_t.device)
    stream = torch.cuda.current_stream(pts_t.device).cuda_stream
    rc = lib.tgtc_nerf_mlp_sigma(
        pts_t.data_ptr(), p, packed.w.data_ptr(), packed.b.data_ptr(),
        _offsets(packed), packed.depth, packed.skip, sigma.data_ptr(), stream)
    _raise_on(rc, "tgtc_nerf_mlp_sigma")
    fused_nerf_sigma_apply_t.launches += 1
    return sigma


fused_nerf_apply_t.launches = 0
fused_nerf_sigma_apply_t.launches = 0
