"""Fused NeRF trunk kernels K1/K2 and their plain PyTorch twins.

Port of tgtc/ops/pallas/nerf_mlp.py. The CUDA kernels live in
``tgtc_torch/csrc/nerf_mlp.cu`` (hand-written for sm_90a, built at first
use by :mod:`tgtc_torch.ops.kernels._build`):

* K1 :func:`fused_nerf_apply_t` replaces the Pallas ``fused_nerf_apply_t``
  — ``pts_t/dirs_t [3, P]`` → ``rgb [3, P]``, ``sigma [1, P]``;
* K2 :func:`fused_nerf_sigma_apply_t` replaces the Pallas
  ``fused_nerf_sigma_apply_t`` — the trunk alone, ``pts_t [3, P]`` →
  ``sigma [1, P]``, bit for bit K1's σ (both run the trunk function of the
  Hopper engine, ``csrc/trunk_sm90.cuh``). K2 also takes the distilled
  proposal's 128-wide trunk (``tgtc_torch.render.distill``): that is
  K2-W128, a kernel of its own (``csrc/proposal_sm90.cuh``: the weights
  resident in shared memory, the encoding and the σ head in registers and
  on the tensor cores) for every depth up to 7, whose weights fit in a
  block's shared memory (``w128_smem_bytes``); a deeper 128-wide trunk runs
  on the engine's σ-only kernel. The choice is made by shape at launch.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
twin (``*_plain``) only for CPU tensors. The twins follow the kernel's
arithmetic step by step: the same encoding, bf16 operands (bf16 σ/rgb head
weights and bf16-rounded biases included), f32 accumulation, bias + ReLU
in f32 then a bf16 round. ``launches`` on each wrapper counts kernel
launches and nothing else; K2's launches on a 128-wide trunk (K2-W128, or
the engine beyond depth 7) count in ``launches_w128`` instead.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Tuple

import torch

from tgtc_torch.ops.kernels import _build

TRUNK_W = 256  # base_remap and the rgb head's input are 256 wide
CUDA_WIDTH, CUDA_FREQS = 256, (10, 4)  # the shape K1 (and K3) take
SIGMA_WIDTHS = (CUDA_WIDTH, 128)  # K2's trunk widths: the NeRF's, the proposal's


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


def pack_layers(
    get: Callable[[str], Tuple[torch.Tensor, torch.Tensor]],
    depth: int,
    num_freq_coor: int,
    num_freq_dir: int,
    skip: int,
    width: int,
) -> PackedNerf:
    """Build a :class:`PackedNerf` from ``get(name) -> (weight, bias)`` of a
    ``NerfMLP`` (relu trunk with one skip, viewdir head) with ``cat``/``pad``
    only, so autograd carries the packed buffers' gradients back to the
    tensors ``get`` returns. Input columns are zero-padded to a multiple of
    16; the skip layer keeps the reference's input order ``[enc(pts) | h]``
    and rgb_0 ``[base_remap | enc(dirs)]``."""
    pad = torch.nn.functional.pad
    in_c, in_d = 3 + 6 * num_freq_coor, 3 + 6 * num_freq_dir
    proto = PackedNerf(torch.empty(0), torch.empty(0), (), depth, skip, width,
                       num_freq_coor, num_freq_dir)
    kc, kd = proto.k_coor, proto.k_dir

    mats, biases = [], []
    w0, b0 = get("base_layers.0")
    mats.append(pad(w0, (0, kc - in_c)))
    biases.append(b0)
    for i in range(1, depth):
        wi, bi = get(f"base_layers.{i}")
        if i == skip + 1:
            wi = torch.cat([pad(wi[:, :in_c], (0, kc - in_c)), wi[:, in_c:]], dim=1)
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
    mats.append(torch.cat([wr0[:, :TRUNK_W], pad(wr0[:, TRUNK_W:], (0, kd - in_d))], dim=1))
    biases.append(br0)
    wr1, br1 = get("rgb_layers.1")
    mats.append(wr1)
    biases.append(br1)

    w, b, offsets = flatten_layers(mats, biases, proto.layers())
    return dataclasses.replace(proto, w=w, b=b, offsets=offsets)


def flatten_layers(mats: List[torch.Tensor], vectors: List[torch.Tensor],
                   shapes: List[Tuple[int, int]]
                   ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """One bf16 buffer of the row-major matrices (each starting 32-byte
    aligned), one f32 buffer of the bf16-rounded vectors (biases, then any
    others), and their element offsets (matrices', then vectors')."""
    for m, (n, k) in zip(mats, shapes):
        if tuple(m.shape) != (n, k):
            raise ValueError(f"layer shape {tuple(m.shape)} != expected {(n, k)}")
    w_offs, b_offs, w_flat, pos = [], [], [], 0
    for m in mats:
        w_offs.append(pos)
        extra = _round16(m.numel()) - m.numel()
        w_flat.append(torch.nn.functional.pad(m.reshape(-1), (0, extra)))
        pos += m.numel() + extra
    pos = 0
    for vec in vectors:
        b_offs.append(pos)
        pos += vec.numel()
    w = torch.cat(w_flat).to(torch.bfloat16)
    b = torch.cat(vectors).to(torch.bfloat16).float()
    return w, b, tuple(w_offs + b_offs)


def pack_nerf_params(
    state_dict: Dict[str, torch.Tensor],
    depth: int = 8,
    num_freq_coor: int = 10,
    num_freq_dir: int = 4,
    skip: int = 4,
    width: int = 256,
    device=None,
) -> PackedNerf:
    """Pack a ``NerfMLP`` state dict into a :class:`PackedNerf` for
    rendering (detached, packed on the host, then moved to ``device``)."""

    def get(name):
        return (state_dict[f"{name}.weight"].detach().float().cpu(),
                state_dict[f"{name}.bias"].detach().float().cpu())

    packed = pack_layers(get, depth, num_freq_coor, num_freq_dir, skip, width)
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


def _check_cuda(packed: PackedNerf, *points: torch.Tensor,
                widths: Tuple[int, ...] = (CUDA_WIDTH,)) -> int:
    if packed.width not in widths or (packed.num_freq_coor,
                                      packed.num_freq_dir) != CUDA_FREQS:
        raise NotImplementedError(
            "the CUDA NeRF kernels take width 256 (K1, K2, K3) or 128 (K2) with "
            f"10/4 frequencies; got width {packed.width}, frequencies "
            f"{packed.num_freq_coor}/{packed.num_freq_dir}")
    return check_points(packed, *points)


def check_points(packed, *points: torch.Tensor) -> int:
    """Checks what every CUDA kernel of the port takes: contiguous f32
    ``[3, P]`` point tensors on a card, packed weights (bf16 matrices, f32
    vectors) contiguous on the same device. Returns P."""
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
    lib.tgtc_nerf_mlp_sigma.argtypes = [vp, ll, vp, vp, vp, i, i, i, vp, vp]
    lib.tgtc_nerf_mlp_sigma.restype = i
    for smem in (lib.tgtc_nerf_mlp_fwd_smem, lib.tgtc_nerf_mlp_sigma_smem):
        smem.argtypes = []
        smem.restype = i
    lib.tgtc_nerf_mlp_sigma_w128_smem.argtypes = [i, i]
    lib.tgtc_nerf_mlp_sigma_w128_smem.restype = i
    return lib


def w128_smem_bytes(depth: int, skip: int) -> int:
    """K2-W128's dynamic shared memory a block for a 128-wide trunk of
    this depth and skip (the resident weights and the padded σ row), from
    the built library. Above 232,448 bytes (depth 8 and deeper) the trunk
    runs on the engine's σ-only kernel instead."""
    return _nerf_lib().tgtc_nerf_mlp_sigma_w128_smem(depth, skip)


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
    """K2: ``pts_t [3, P]`` f32 → ``sigma [1, P]`` (bitwise equal to K1's
    at width 256); the trunk may be 256 or 128 wide (K2-W128 up to depth
    7, the engine's σ-only kernel deeper: see the module docstring)."""
    if pts_t.device.type == "cpu":
        return fused_nerf_sigma_apply_t_plain(packed, pts_t)
    p = _check_cuda(packed, pts_t, widths=SIGMA_WIDTHS)
    lib = _nerf_lib()
    sigma = torch.empty((1, p), dtype=torch.float32, device=pts_t.device)
    stream = torch.cuda.current_stream(pts_t.device).cuda_stream
    rc = lib.tgtc_nerf_mlp_sigma(
        pts_t.data_ptr(), p, packed.w.data_ptr(), packed.b.data_ptr(),
        _offsets(packed), packed.depth, packed.skip, packed.width, sigma.data_ptr(), stream)
    _raise_on(rc, "tgtc_nerf_mlp_sigma")
    if packed.width == CUDA_WIDTH:
        fused_nerf_sigma_apply_t.launches += 1
    else:
        fused_nerf_sigma_apply_t.launches_w128 += 1
    return sigma


fused_nerf_apply_t.launches = 0
fused_nerf_sigma_apply_t.launches = 0
fused_nerf_sigma_apply_t.launches_w128 = 0
