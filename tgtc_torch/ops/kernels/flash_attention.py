"""Flash-attention forward K6 and its plain PyTorch twin.

Port of the forward of tgtc/ops/pallas/flash_attention.py. The CUDA kernel
lives in ``tgtc_torch/csrc/flash_attention.cu`` (hand-written for sm_90a,
built at first use by :mod:`tgtc_torch.ops.kernels._build`):

* K6 :func:`flash_attention_fwd` replaces the Pallas ``_fwd_call`` —
  ``softmax(sm_scale · q kᵀ) v`` with q scaled first in q's type, an online
  softmax over key tiles, optional attention-probs dropout from a counter
  hash of (seed, batch·head, row, col), and the logsumexp of every row
  (kept for the backward kernels K7/K8).

``q [B, H, Sq, D]``, ``k``/``v [B, H, Sk, D]`` may be strided views (the
``[B, S, H, D]`` layout of the projections transposed), as may the
returned ``o``. The wrapper launches the kernel for CUDA tensors (bf16, D
64, or it raises) and runs the twin only for CPU tensors, which takes every
D and f32 too. The twin follows the kernel's arithmetic with one softmax
per row instead of per tile: logits f32 from the operands, ``p = exp(s -
m)`` and ``l`` in f32 over the undropped p, then the dropout mask and
``1/keep``, ``p`` cast to v's type before ``p v``, ``o = acc / l`` in q's
type and ``lse = m + log l``. ``launches`` on the wrapper counts kernel
launches only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tgtc_torch.ops.kernels import _build
from tgtc_torch.ops.kernels.nerf_mlp import _raise_on

CUDA_HEAD_DIM = 64  # the only head width the CUDA kernel takes
_U32 = 0xFFFFFFFF


def quantized_keep(rate: float) -> Tuple[int, float]:
    """(uint32 threshold, exact keep probability): an element is dropped
    when its uint32 draw is below the threshold."""
    thr = int(round(rate * float(2 ** 32)))
    thr = max(0, min(thr, 2 ** 32 - 1))
    return thr, 1.0 - thr / float(2 ** 32)


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32), in two 16-bit
    halves of ``c`` so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def dropout_keep_mask(seed: int, bh: int, rows: torch.Tensor, cols: torch.Tensor,
                      thr: int) -> torch.Tensor:
    """Keep-mask ``[len(rows), len(cols)]`` of batch·head ``bh`` at absolute
    query ``rows`` and key ``cols``: the murmur3 counter hash of the TPU
    kernel bit for bit, in int64 arithmetic held to 32 bits."""
    salt = ((int(seed) & _U32) + (int(bh) & _U32) * 0xC2B2AE35) & _U32
    r = _mul_u32(rows.long()[:, None] & _U32, 0x9E3779B9)
    c = _mul_u32(cols.long()[None, :] & _U32, 0x85EBCA6B)
    x = r ^ c ^ salt
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= thr


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float = 1.0) -> torch.Tensor:
    """Einsum attention without dropout, logits and softmax in f32, the
    probabilities cast to v's type before ``p v``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _check_args(q, k, v, dropout_rate, dropout_seed):
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B, H, Sq, D] and k, v [B, H, Sk, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch, heads "
                         "or head width")
    if k.shape[2] == 0:
        raise ValueError("attention over zero keys")


def _scaled(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """``q * sm_scale`` with the scale rounded to q's type first (``_prep``)."""
    return q * torch.tensor(sm_scale, dtype=q.dtype)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              sm_scale: float = 1.0, dropout_rate: float = 0.0,
                              dropout_seed: Optional[int] = None, rows: int = 2048
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K6: ``(o [B, H, Sq, D]`` in q's type, ``lse [B, H, Sq]``
    f32). One head and ``rows`` query rows at a time, so the logits never
    take more than ``rows x Sk`` floats."""
    _check_args(q, k, v, dropout_rate, dropout_seed)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    thr, keep = quantized_keep(dropout_rate)
    qs = _scaled(q, sm_scale)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    cols = torch.arange(sk, device=q.device)
    for bi in range(b):
        for hi in range(h):
            kt = k[bi, hi].float().T
            vf = v[bi, hi]
            for r0 in range(0, sq, rows):
                s = qs[bi, hi, r0: r0 + rows].float() @ kt
                m = s.amax(dim=-1, keepdim=True)
                p = torch.exp(s - m)
                l = p.sum(dim=-1, keepdim=True)
                if dropout_rate > 0.0:
                    r = torch.arange(r0, r0 + s.shape[0], device=q.device)
                    mask = dropout_keep_mask(int(dropout_seed), bi * h + hi, r, cols, thr)
                    p = torch.where(mask, p * (1.0 / keep), 0.0)
                acc = p.to(vf.dtype).float() @ vf.float()
                o[bi, hi, r0: r0 + rows] = (acc / l).to(q.dtype)
                lse[bi, hi, r0: r0 + rows] = (m + torch.log(l))[:, 0]
    return o, lse


def flash_attention_plain(q, k, v, sm_scale: float = 1.0, dropout_rate: float = 0.0,
                          dropout_seed: Optional[int] = None) -> torch.Tensor:
    """``o`` of :func:`flash_attention_fwd_plain`."""
    return flash_attention_fwd_plain(q, k, v, sm_scale, dropout_rate, dropout_seed)[0]


# ---------------------------------------------------------------- kernel


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.bfloat16:
            raise TypeError(f"K6 takes bf16 q, k, v on one device; {name} is {x.dtype} "
                            f"on {x.device}")
        if x.shape[3] != CUDA_HEAD_DIM or x.stride(3) != 1:
            raise NotImplementedError(
                f"the CUDA flash kernel takes head width {CUDA_HEAD_DIM} with a contiguous "
                f"last axis; got {name} {tuple(x.shape)} with strides {x.stride()} (other "
                "widths are a ROADMAP item; the twin takes them on the CPU)")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if its rows can be read 16 bytes at a time, else a
    contiguous copy."""
    ok = x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3])
    return x if ok else x.contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and bound on the first launch."""
    lib = _build.load("flash_attention")
    vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tgtc_flash_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp, f, i, u, u, f, vp]
    lib.tgtc_flash_fwd.restype = i
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float = 1.0, dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: ``q [B, H, Sq, D]``, ``k``/``v [B, H, Sk, D]`` → ``(o [B, H, Sq,
    D]``, ``lse [B, H, Sq]`` f32). On the card ``o`` is a ``[B, Sq, H, D]``
    tensor seen through a transpose, so that merging the heads is free."""
    _check_args(q, k, v, dropout_rate, dropout_seed)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, sm_scale, dropout_rate, dropout_seed)
    _check_cuda(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if b * h > 65535:
        raise ValueError(f"K6 takes at most 65,535 batch x heads, got {b * h}")
    k, v = _aligned(k), _aligned(v)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, o) for s in x.stride()[:3]))
    thr, keep = quantized_keep(dropout_rate)
    scale = float(torch.tensor(sm_scale, dtype=q.dtype))
    seed = int(dropout_seed) & _U32 if dropout_seed is not None else 0
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().tgtc_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               lse.data_ptr(), b, h, sq, sk, strides, scale,
                               int(dropout_rate > 0.0), seed, thr, 1.0 / keep, stream)
    _raise_on(rc, "tgtc_flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float = 1.0, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Fused attention ``softmax(sm_scale · q kᵀ) v`` with optional
    in-kernel attention-probs dropout: ``o`` of :func:`flash_attention_fwd`.
    ``dropout_seed`` (an int32) is required when ``dropout_rate > 0``; the
    same seed gives the same mask."""
    return flash_attention_fwd(q, k, v, sm_scale, dropout_rate, dropout_seed)[0]


flash_attention_fwd.launches = 0
