"""Flash attention: the forward K6, the backward K7 (dQ) and K8 (dK, dV),
their plain PyTorch twins, and the autograd bridge between them.

Port of tgtc/ops/pallas/flash_attention.py. The CUDA kernels live in
``tgtc_torch/csrc/flash_attention.cu`` (hand-written for sm_90a, built at
first use by :mod:`tgtc_torch.ops.kernels._build`):

* K6 :func:`flash_attention_fwd` replaces the Pallas ``_fwd_call`` —
  ``softmax(sm_scale · q kᵀ) v`` with q scaled first in q's type, an online
  softmax over key tiles, optional attention-probs dropout from a counter
  hash of (seed, batch·head, row, col), and the logsumexp of every row;
  ``bh_offset`` shifts the batch·head index, so that one process's rows of
  a batch draw the masks they have in the whole batch.
* K7 :func:`flash_attention_bwd_dq` and K8 :func:`flash_attention_bwd_dkv`
  replace the two calls of ``_bwd_call``: dQ, and dK with dV, from dO, the
  logsumexp and Δ = rowsum(dO·O), regenerating the same dropout mask.
* :func:`flash_attention` is differentiable: a ``torch.autograd.Function``
  whose forward is K6 and whose backward is Δ, K7 and K8 (``_flash_bwd``).

``q [B, H, Sq, D]``, ``k``/``v [B, H, Sk, D]`` and the gradients may be
strided views (the ``[B, S, H, D]`` layout of the projections transposed),
as are the returned ``o``, ``dq``, ``dk`` and ``dv`` on the card. Each
wrapper launches its kernel for CUDA tensors (bf16, D 64 and, for K7/K8, a
power-of-two ``sm_scale``, or it raises) and runs its twin only for CPU
tensors; the twins take every D, scale and f32 too. The twins follow the
kernels' rounding points one head and a few query rows at a time: the
forward with one softmax per row instead of per tile (logits f32, ``p =
exp(s - m)`` and ``l`` over the undropped p, then the mask and ``1/keep``,
p cast to v's type, ``o = acc / l`` in q's type, ``lse = m +
log l``); the backward as ``_dq_kernel`` / ``_dkv_kernel`` (``p = exp(s -
lse)``, ``dp = dO vᵀ`` masked and scaled, ``ds = p (dp - Δ)`` from the
undropped p cast to the operands' type, ``pd = mask p / keep`` cast to dO's
type, dq scaled by ``sm_scale`` in q's type). ``dropout_seed`` is an int or
an int32 tensor on the operands' device (the transformer draws it there, so
no launch waits for the host). ``launches`` on each wrapper counts kernel
launches only.
"""

from __future__ import annotations

import ctypes
import functools
import math
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


def _seed_int(seed) -> int:
    """The dropout seed as a Python int (a tensor seed is read back)."""
    return int(seed.reshape(()).item()) if isinstance(seed, torch.Tensor) else int(seed)


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
                              dropout_seed: Optional[int] = None, rows: int = 2048,
                              bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K6: ``(o [B, H, Sq, D]`` in q's type, ``lse [B, H, Sq]``
    f32). One head and ``rows`` query rows at a time, so the logits never
    take more than ``rows x Sk`` floats. ``bh_offset`` is added to the
    batch·head index of the dropout hash (see :func:`flash_attention`)."""
    _check_args(q, k, v, dropout_rate, dropout_seed)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    thr, keep = quantized_keep(dropout_rate)
    seed = _seed_int(dropout_seed) if dropout_rate > 0.0 else 0
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
                    mask = dropout_keep_mask(seed, bh_offset + bi * h + hi, r, cols, thr)
                    p = torch.where(mask, p * (1.0 / keep), 0.0)
                acc = p.to(vf.dtype).float() @ vf.float()
                o[bi, hi, r0: r0 + rows] = (acc / l).to(q.dtype)
                lse[bi, hi, r0: r0 + rows] = (m + torch.log(l))[:, 0]
    return o, lse


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale: float = 1.0,
                                 dropout_rate: float = 0.0, dropout_seed=None,
                                 rows: int = 2048, bh_offset: int = 0) -> torch.Tensor:
    """Plain twin of K7: ``dq [B, H, Sq, D]`` in q's type from ``do`` (the
    shape of q), ``lse`` and ``delta [B, H, Sq]`` f32."""
    _check_args(q, k, v, dropout_rate, dropout_seed)
    b, h, sq, _ = q.shape
    thr, keep = quantized_keep(dropout_rate)
    seed = _seed_int(dropout_seed) if dropout_rate > 0.0 else 0
    qs, scale = _scaled(q, sm_scale), torch.tensor(sm_scale, dtype=q.dtype)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    cols = torch.arange(k.shape[2], device=q.device)
    for bi in range(b):
        for hi in range(h):
            kf, vt = k[bi, hi].float(), v[bi, hi].float().T
            for r0 in range(0, sq, rows):
                sl = slice(r0, r0 + rows)
                p = torch.exp(qs[bi, hi, sl].float() @ kf.T - lse[bi, hi, sl, None])
                dpt = do[bi, hi, sl].float() @ vt
                if dropout_rate > 0.0:
                    r = torch.arange(r0, r0 + p.shape[0], device=q.device)
                    mask = dropout_keep_mask(seed, bh_offset + bi * h + hi, r, cols, thr)
                    dpt = torch.where(mask, dpt * (1.0 / keep), 0.0)
                ds = (p * (dpt - delta[bi, hi, sl, None])).to(k.dtype)
                dq[bi, hi, sl] = (ds.float() @ kf).to(q.dtype) * scale
    return dq


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, sm_scale: float = 1.0,
                                  dropout_rate: float = 0.0, dropout_seed=None,
                                  rows: int = 2048, bh_offset: int = 0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K8: ``(dk, dv)`` in k's and v's types, the shape of k."""
    _check_args(q, k, v, dropout_rate, dropout_seed)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    thr, keep = quantized_keep(dropout_rate)
    seed = _seed_int(dropout_seed) if dropout_rate > 0.0 else 0
    qs = _scaled(q, sm_scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    cols = torch.arange(sk, device=q.device)
    for bi in range(b):
        for hi in range(h):
            kf, vf = k[bi, hi].float(), v[bi, hi].float()
            dk_acc = torch.zeros((sk, d), device=q.device)
            dv_acc = torch.zeros((sk, d), device=q.device)
            for r0 in range(0, sq, rows):
                sl = slice(r0, r0 + rows)
                qb, dob = qs[bi, hi, sl], do[bi, hi, sl]
                p = torch.exp(qb.float() @ kf.T - lse[bi, hi, sl, None])
                dpt, pd = dob.float() @ vf.T, p
                if dropout_rate > 0.0:
                    r = torch.arange(r0, r0 + p.shape[0], device=q.device)
                    mask = dropout_keep_mask(seed, bh_offset + bi * h + hi, r, cols, thr)
                    pd = torch.where(mask, p * (1.0 / keep), 0.0)
                    dpt = torch.where(mask, dpt * (1.0 / keep), 0.0)
                dv_acc += pd.to(do.dtype).float().T @ dob.float()
                ds = (p * (dpt - delta[bi, hi, sl, None])).to(q.dtype)
                dk_acc += ds.float().T @ qb.float()
            dk[bi, hi], dv[bi, hi] = dk_acc.to(k.dtype), dv_acc.to(v.dtype)
    return dk, dv


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO · O) ``[B, H, Sq]`` in f32 (``_flash_bwd``), contiguous."""
    return (do.float() * o.float()).sum(-1).contiguous()


def flash_attention_bwd_plain(q, k, v, o, do, lse, sm_scale: float = 1.0,
                              dropout_rate: float = 0.0, dropout_seed=None, bh_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The twins' backward: ``(dq, dk, dv)`` from the forward's ``o`` and
    ``lse`` and the cotangent ``do``."""
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale, dropout_rate,
                                      dropout_seed, bh_offset=bh_offset)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, sm_scale, dropout_rate,
                                           dropout_seed, bh_offset=bh_offset)
    return dq, dk, dv


# ---------------------------------------------------------------- kernels


def _check_cuda(**tensors: torch.Tensor) -> None:
    dev = next(iter(tensors.values())).device
    for name, x in tensors.items():
        if x.device != dev or x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA flash kernels take bf16 operands on one device; {name} "
                            f"is {x.dtype} on {x.device}")
        if x.shape[3] != CUDA_HEAD_DIM or x.stride(3) != 1:
            raise NotImplementedError(
                f"the CUDA flash kernels take head width {CUDA_HEAD_DIM} with a contiguous "
                f"last axis; got {name} {tuple(x.shape)} with strides {x.stride()} (no "
                "tgtc path or configs/*.txt reaches other widths; the plain twins take them "
                "on the CPU)")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if its rows can be read 16 bytes at a time, else a
    contiguous copy."""
    ok = x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3])
    return x if ok else x.contiguous()


def _rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``[B, H, S]`` f32 row statistic (lse or Δ), contiguous, checked."""
    if x.shape != like.shape[:3] or x.dtype != torch.float32 or x.device != like.device:
        raise ValueError(f"expected f32 [B, H, Sq] = {tuple(like.shape[:3])} on {like.device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


def _strides(*tensors: torch.Tensor):
    vals = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _dropout_args(q: torch.Tensor, dropout_rate: float, dropout_seed):
    """``(dropout flag, seed tensor or None, thr, inv_keep)`` for a launch:
    the seed as one int32 on q's device (an int is copied there)."""
    thr, keep = quantized_keep(dropout_rate)
    if dropout_rate <= 0.0:
        return 0, None, thr, 1.0
    if isinstance(dropout_seed, torch.Tensor):
        seed = dropout_seed.reshape(1).to(device=q.device, dtype=torch.int32)
    else:
        s = int(dropout_seed) & _U32
        seed = torch.tensor([s - (1 << 32) if s >= 1 << 31 else s], dtype=torch.int32,
                            device=q.device)
    return 1, seed, thr, 1.0 / keep


def _bh_offset(bh_offset: int, bh: int) -> int:
    """The launch's batch·head offset, checked to keep every hashed index
    an int32."""
    if bh_offset < 0 or bh_offset + bh > 2 ** 31 - 1:
        raise ValueError(f"bh_offset {bh_offset} with {bh} batch x heads leaves int32")
    return int(bh_offset)


def _bf16_scale(sm_scale: float) -> float:
    return float(torch.tensor(sm_scale, dtype=torch.bfloat16))


def _pow2_scale(sm_scale: float, what: str) -> float:
    """The bf16 scale of K7/K8, which must be a power of two: they scale
    the logits and dk in f32, which equals the products of bf16(q · scale)
    exactly only then."""
    s = _bf16_scale(sm_scale)
    if s == 0.0 or not math.isfinite(s) or math.frexp(abs(s))[0] != 0.5:
        raise NotImplementedError(
            f"{what} takes a power-of-two sm_scale (1/sqrt(64) = 0.125 on every path), got "
            f"{sm_scale}; the twins take any scale on the CPU")
    return s


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built and bound on the first launch."""
    lib = _build.load("flash_attention")
    vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tgtc_flash_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp, f, i, vp, u, f, i, vp]
    lib.tgtc_flash_bwd_dq.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp, f, i, vp, u,
                                      f, i, vp]
    lib.tgtc_flash_bwd_dkv.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp, f, i, vp,
                                       u, f, i, vp]
    for fn in (lib.tgtc_flash_fwd, lib.tgtc_flash_bwd_dq, lib.tgtc_flash_bwd_dkv):
        fn.restype = i
    return lib


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _launch_shape(q: torch.Tensor, k: torch.Tensor, what: str):
    b, h, sq, d = q.shape
    if b * h > 65535:
        raise ValueError(f"{what} takes at most 65,535 batch x heads, got {b * h}")
    return b, h, sq, k.shape[2], d


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float = 1.0, dropout_rate: float = 0.0,
                        dropout_seed=None, bh_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: ``q [B, H, Sq, D]``, ``k``/``v [B, H, Sk, D]`` → ``(o [B, H, Sq,
    D]``, ``lse [B, H, Sq]`` f32). On the card ``o`` is a ``[B, Sq, H, D]``
    tensor seen through a transpose, so that merging the heads is free."""
    _check_args(q, k, v, dropout_rate, dropout_seed)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, sm_scale, dropout_rate, dropout_seed,
                                         bh_offset=bh_offset)
    _check_cuda(q=q, k=k, v=v)
    b, h, sq, sk, d = _launch_shape(q, k, "K6")
    q, k, v = (_aligned(x) for x in (q, k, v))
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    drop, seed, thr, inv_keep = _dropout_args(q, dropout_rate, dropout_seed)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().tgtc_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               lse.data_ptr(), b, h, sq, sk, _strides(q, k, v, o),
                               _bf16_scale(sm_scale), drop, _ptr(seed), thr, inv_keep,
                               _bh_offset(bh_offset, b * h), stream)
    _raise_on(rc, "tgtc_flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, sm_scale: float = 1.0,
                           dropout_rate: float = 0.0, dropout_seed=None,
                           bh_offset: int = 0) -> torch.Tensor:
    """K7: ``dq`` (the shape of q; on the card a ``[B, Sq, H, D]`` tensor
    seen through a transpose) from ``do``, ``lse`` and ``delta``."""
    _check_args(q, k, v, dropout_rate, dropout_seed)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale, dropout_rate,
                                            dropout_seed, bh_offset=bh_offset)
    _check_cuda(q=q, k=k, v=v, do=do)
    scale = _pow2_scale(sm_scale, "K7")
    b, h, sq, sk, d = _launch_shape(q, k, "K7")
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    lse, delta = _rows(lse, q), _rows(delta, q)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    drop, seed, thr, inv_keep = _dropout_args(q, dropout_rate, dropout_seed)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().tgtc_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk,
                                  _strides(q, k, v, do, dq), scale, drop, _ptr(seed), thr,
                                  inv_keep, _bh_offset(bh_offset, b * h), stream)
    _raise_on(rc, "tgtc_flash_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float = 1.0,
                            dropout_rate: float = 0.0, dropout_seed=None, bh_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: ``(dk, dv)`` (the shape of k; on the card ``[B, Sk, H, D]``
    tensors seen through a transpose) from ``do``, ``lse`` and ``delta``."""
    _check_args(q, k, v, dropout_rate, dropout_seed)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, sm_scale, dropout_rate,
                                             dropout_seed, bh_offset=bh_offset)
    _check_cuda(q=q, k=k, v=v, do=do)
    scale = _pow2_scale(sm_scale, "K8")
    b, h, sq, sk, d = _launch_shape(q, k, "K8")
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    lse, delta = _rows(lse, q), _rows(delta, q)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device).transpose(1, 2)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=v.device).transpose(1, 2)
    drop, seed, thr, inv_keep = _dropout_args(q, dropout_rate, dropout_seed)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().tgtc_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), b, h, sq, sk, _strides(q, k, v, do, dk, dv),
                                   scale, drop, _ptr(seed), thr, inv_keep,
                                   _bh_offset(bh_offset, b * h), stream)
    _raise_on(rc, "tgtc_flash_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, sm_scale: float = 1.0, dropout_rate: float = 0.0,
                        dropout_seed=None, bh_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_flash_bwd``: Δ = rowsum(dO·O) in f32, then K7 and K8 (their twins
    for CPU tensors)."""
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, sm_scale, dropout_rate, dropout_seed,
                                bh_offset)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, sm_scale, dropout_rate,
                                     dropout_seed, bh_offset)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``o`` of the forward, differentiable in q, k and v. ``plain`` runs
    the twins (forward and backward) on any device; otherwise the forward is
    K6 and the backward K7 + K8 (the twins for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, dropout_rate: float, dropout_seed, plain: bool,
                bh_offset: int):
        fwd = flash_attention_fwd_plain if plain else flash_attention_fwd
        o, lse = fwd(q, k, v, sm_scale, dropout_rate, dropout_seed, bh_offset=bh_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sm_scale, dropout_rate, dropout_seed, plain, bh_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        sm_scale, dropout_rate, dropout_seed, plain, bh_offset = ctx.args
        bwd = flash_attention_bwd_plain if plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, do, lse, sm_scale, dropout_rate, dropout_seed,
                         bh_offset=bh_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float = 1.0, dropout_rate: float = 0.0,
                    dropout_seed=None, bh_offset: int = 0) -> torch.Tensor:
    """Fused attention ``softmax(sm_scale · q kᵀ) v`` with optional
    in-kernel attention-probs dropout, differentiable in q, k and v (K6
    forward, K7 + K8 backward). ``dropout_seed`` (an int or int32 tensor)
    is required when ``dropout_rate > 0``; the same seed gives the same
    mask in the forward and the backward. ``bh_offset`` is added to every
    batch·head index the dropout hash takes: a call on rows ``b0…`` of a
    batch with ``bh_offset = b0 · H`` draws the masks those rows have in the
    whole batch (0, the default, for a whole batch). On the card a call that
    will be differentiated refuses a scale K7/K8 do not take before K6 runs."""
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, k, v))):
        _pow2_scale(sm_scale, "K7/K8")
    return FlashAttention.apply(q, k, v, float(sm_scale), float(dropout_rate), dropout_seed,
                                False, int(bh_offset))


def flash_attention_plain(q, k, v, sm_scale: float = 1.0, dropout_rate: float = 0.0,
                          dropout_seed=None, bh_offset: int = 0) -> torch.Tensor:
    """:func:`flash_attention` through the twins on any device (a card's
    tensors included): the comparison path for the kernels."""
    return FlashAttention.apply(q, k, v, float(sm_scale), float(dropout_rate), dropout_seed,
                                True, int(bh_offset))


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
