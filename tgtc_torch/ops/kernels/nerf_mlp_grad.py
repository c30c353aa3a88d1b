"""Differentiable fused NeRF trunk: K1 forward, K3 backward, and the twin.

Port of tgtc/ops/pallas/nerf_mlp_grad.py. The CUDA kernel K3 lives in
``tgtc_torch/csrc/nerf_mlp_grad.cu`` (hand-written for sm_90a, built at
first use):

* K3 :func:`fused_nerf_bwd` replaces the Pallas ``_fused_nerf_bwd`` —
  ``pts_t/dirs_t/g_rgb [3, P]``, ``g_sigma [1, P]`` → the f32 gradients of
  the packed weight and bias buffers, in their layout. It recomputes the
  forward with K1's own device code (``csrc/trunk_sm90.cuh``), so its ReLU
  masks, rgb and σ are K1's bit for bit; ``forward_out`` shows them.

:func:`pack_nerf_params_traceable` packs live ``nn.Linear`` parameters on
their device with ``cat``/``pad``/``.to(bfloat16)``, so autograd routes the
packed gradients back to the module's parameters; the bf16 cast rounds the
incoming gradient to bf16, as JAX's ``make_diff_apply`` casts its dW to the
packed buffers' bf16. :class:`FusedNerfApply` is ``make_diff_apply``: K1
forward, K3 backward, gradients to the packed weights and biases only.

The wrapper launches K3 for CUDA tensors (or raises) and runs the twin
:func:`fused_nerf_bwd_plain` only for CPU tensors. The twin follows
``_make_bwd_kernel`` step by step: the K1 twin's forward, then gs, g_rf,
g_br and every trunk layer's masked g rounded to bf16 before they feed both
the weight-gradient product and the next input-gradient product; masks on
the bf16 activations; bias gradients as f32 sums of the bf16 values, except
the σ bias, which sums the f32 g_σ. ``fused_nerf_bwd.launches`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import torch

from tgtc_torch.ops.kernels import _build
from tgtc_torch.ops.kernels.nerf_mlp import (
    TRUNK_W,
    PackedNerf,
    _bf16,
    _check_cuda,
    _encode_plain,
    _linear,
    _offsets,
    _raise_on,
    fused_nerf_apply_t,
    fused_nerf_apply_t_plain,
    pack_layers,
)


def pack_nerf_params_traceable(
    params: Mapping[str, torch.Tensor],
    depth: int = 8,
    num_freq_coor: int = 10,
    num_freq_dir: int = 4,
    skip: int = 4,
    width: int = 256,
) -> PackedNerf:
    """Differentiable twin of ``pack_nerf_params``: the same layout, built
    on the parameters' device from ``params`` (``dict(model.named_parameters())``
    or a state dict) without detaching."""

    def get(name):
        return params[f"{name}.weight"].float(), params[f"{name}.bias"].float()

    return pack_layers(get, depth, num_freq_coor, num_freq_dir, skip, width)


# ---------------------------------------------------------------- twin


def _flatten(packed: PackedNerf, dws, dbs) -> Tuple[torch.Tensor, torch.Tensor]:
    dw = torch.zeros(packed.w.numel(), dtype=torch.float32, device=dws[0].device)
    for i, g in enumerate(dws):
        off = packed.offsets[i]
        dw[off: off + g.numel()] = g.reshape(-1)
    return dw, torch.cat(dbs)


def fused_nerf_bwd_plain(packed: PackedNerf, pts_t: torch.Tensor, dirs_t: torch.Tensor,
                         g_rgb: torch.Tensor, g_sigma: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K3: ``(dw [w.numel()], db [b.numel()])`` f32 in the
    packed layout (alignment gaps zero)."""
    d, width = packed.depth, packed.width

    def wt(i):
        return packed.weight(i).float()

    e_c = _encode_plain(pts_t.T.float(), packed.num_freq_coor, packed.k_coor)
    inputs, hs = [e_c], []
    h = _bf16(torch.relu(_linear(e_c, packed, 0)))
    hs.append(h)
    for i in range(1, d):
        inp = torch.cat([e_c, h], dim=-1) if i == packed.skip + 1 else h
        inputs.append(inp)
        h = _bf16(torch.relu(_linear(inp, packed, i)))
        hs.append(h)
    e_d = _encode_plain(dirs_t.T.float(), packed.num_freq_dir, packed.k_dir)
    br = _bf16(torch.relu(_linear(h, packed, d)))
    x_rf = torch.cat([br, e_d], dim=-1)
    rf = _bf16(torch.relu(_linear(x_rf, packed, d + 2)))
    rgb = torch.sigmoid(_linear(rf, packed, d + 3))               # [P, 3]

    n_layers = len(packed.layers())
    dws, dbs = [None] * n_layers, [None] * n_layers
    gs = _bf16(g_rgb.T.float() * rgb * (1.0 - rgb))               # [P, 3]
    dws[d + 3], dbs[d + 3] = gs.T @ rf, gs.sum(0)
    g_rf = _bf16(torch.where(rf > 0, gs @ wt(d + 3), 0.0))       # [P, hw]
    dws[d + 2], dbs[d + 2] = g_rf.T @ x_rf, g_rf.sum(0)
    g_br = _bf16(torch.where(br > 0, g_rf @ wt(d + 2)[:, :TRUNK_W], 0.0))
    g_sig = g_sigma.T.float()                                      # [P, 1]
    g_sig_b = _bf16(g_sig)
    dws[d + 1], dbs[d + 1] = g_sig_b.T @ h, g_sig.sum(0)
    dws[d], dbs[d] = g_br.T @ h, g_br.sum(0)
    g_h = g_br @ wt(d) + g_sig_b @ wt(d + 1)                       # [P, width]
    for i in range(d - 1, -1, -1):
        g = _bf16(torch.where(hs[i] > 0, g_h, 0.0))
        dws[i], dbs[i] = g.T @ inputs[i], g.sum(0)
        if i:  # only the h columns propagate (the skip layer's are last)
            g_h = g @ wt(i)[:, -width:]
    return _flatten(packed, dws, dbs)


# ---------------------------------------------------------------- kernel


@functools.cache
def _grad_lib() -> ctypes.CDLL:
    """K3's library, built and bound on the first launch."""
    lib = _build.load("nerf_mlp_grad")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tgtc_nerf_mlp_bwd_workspace.argtypes = [ll, i, ll]
    lib.tgtc_nerf_mlp_bwd_workspace.restype = ll
    lib.tgtc_nerf_mlp_bwd_point_bytes.argtypes = [i]
    lib.tgtc_nerf_mlp_bwd_point_bytes.restype = ll
    lib.tgtc_nerf_mlp_bwd.argtypes = [vp, vp, vp, vp, ll, vp, vp, vp, i, i, ll, ll,
                                      vp, vp, vp, vp]
    lib.tgtc_nerf_mlp_bwd.restype = i
    return lib


def _check_forward_out(forward_out: Optional[torch.Tensor], pts_t: torch.Tensor) -> None:
    p = pts_t.shape[-1]
    if forward_out is not None and (
            forward_out.device != pts_t.device or forward_out.dtype != torch.float32
            or forward_out.shape != (4, p) or not forward_out.is_contiguous()):
        raise ValueError(f"expected a contiguous float32 [4, {p}] forward_out on "
                         f"{pts_t.device}, got {forward_out.dtype} "
                         f"{tuple(forward_out.shape)} on {forward_out.device}")


def workspace_bytes(packed: PackedNerf, p: int) -> int:
    """Bytes of K3's workspace for ``p`` points (needs the card's toolchain)."""
    return _grad_lib().tgtc_nerf_mlp_bwd_workspace(p, packed.depth,
                                                   packed.w.numel() + packed.b.numel())


def workspace_point_bytes(depth: int) -> int:
    """Bytes a point of K3's workspace at ``depth`` (the saved activations
    and gradients; the transposed weights, masks and per-chunk partials come
    on top). Builds K3's library, so it needs the card's toolchain."""
    return _grad_lib().tgtc_nerf_mlp_bwd_point_bytes(depth)


def fused_nerf_bwd(packed: PackedNerf, pts_t: torch.Tensor, dirs_t: torch.Tensor,
                   g_rgb: torch.Tensor, g_sigma: torch.Tensor, *,
                   forward_out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: the packed weight and bias gradients ``(dw, db)`` (f32, the
    layouts of ``packed.w`` and ``packed.b``) of ``sum(g_rgb * rgb) +
    sum(g_sigma * sigma)`` for K1's ``rgb [3, P]``, ``sigma [1, P]``.
    Deterministic: the same inputs give the same bits. For the checks only,
    ``forward_out`` (f32 ``[4, P]``) receives the recomputed forward: rgb in
    rows 0-2, σ in row 3 (on the card, K1's bit for bit)."""
    _check_forward_out(forward_out, pts_t)
    if pts_t.device.type == "cpu":
        if forward_out is not None:
            rgb, sigma = fused_nerf_apply_t_plain(packed, pts_t, dirs_t)
            forward_out.copy_(torch.cat([rgb, sigma]))
        return fused_nerf_bwd_plain(packed, pts_t, dirs_t, g_rgb, g_sigma)
    p = _check_cuda(packed, pts_t, dirs_t, g_rgb)
    if (g_sigma.device != pts_t.device or g_sigma.dtype != torch.float32
            or g_sigma.shape != (1, p) or not g_sigma.is_contiguous()):
        raise ValueError(f"expected a contiguous float32 [1, {p}] g_sigma on "
                         f"{pts_t.device}, got {g_sigma.dtype} {tuple(g_sigma.shape)} "
                         f"on {g_sigma.device}")
    lib = _grad_lib()
    nw, nb = packed.w.numel(), packed.b.numel()
    dev = pts_t.device
    ws = torch.empty(workspace_bytes(packed, p), dtype=torch.uint8, device=dev)
    out = torch.empty(nw + nb, dtype=torch.float32, device=dev)
    rc = lib.tgtc_nerf_mlp_bwd(
        pts_t.data_ptr(), dirs_t.data_ptr(), g_rgb.data_ptr(), g_sigma.data_ptr(), p,
        packed.w.data_ptr(), packed.b.data_ptr(), _offsets(packed), packed.depth,
        packed.skip, nw, nb, ws.data_ptr(), out.data_ptr(),
        None if forward_out is None else forward_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "tgtc_nerf_mlp_bwd")
    fused_nerf_bwd.launches += 1
    return out[:nw], out[nw:]


fused_nerf_bwd.launches = 0


# ---------------------------------------------------------------- autograd


class FusedNerfApply(torch.autograd.Function):
    """``make_diff_apply``: ``(w, b, pts_t, dirs_t) → (rgb [3, P], sigma
    [1, P])`` with K1 forward and K3 backward. Gradients flow to the packed
    weights and biases only; pts and dirs get none."""

    @staticmethod
    def forward(ctx, w, b, pts_t, dirs_t, layout: PackedNerf):
        ctx.layout = layout
        ctx.save_for_backward(w, b, pts_t, dirs_t)
        return fused_nerf_apply_t(dataclasses.replace(layout, w=w, b=b), pts_t, dirs_t)

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        w, b, pts_t, dirs_t = ctx.saved_tensors
        p = pts_t.shape[-1]
        g_rgb = (pts_t.new_zeros(3, p) if g_rgb is None else g_rgb.float().contiguous())
        g_sigma = (pts_t.new_zeros(1, p) if g_sigma is None
                   else g_sigma.float().contiguous())
        dw, db = fused_nerf_bwd(dataclasses.replace(ctx.layout, w=w, b=b),
                                pts_t, dirs_t, g_rgb, g_sigma)
        return dw.to(w.dtype), db, None, None, None


def fused_nerf_apply_diff(packed: PackedNerf, pts_t: torch.Tensor, dirs_t: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable K1: ``pts_t/dirs_t [3, P]`` → ``(rgb [3, P], sigma
    [1, P])``; backward through K3 into ``packed.w`` / ``packed.b``."""
    layout = dataclasses.replace(packed, w=torch.empty(0), b=torch.empty(0))
    return FusedNerfApply.apply(packed.w, packed.b, pts_t.contiguous(),
                                dirs_t.contiguous(), layout)
