"""The flash-attention backward of the port (K7/K8's plain twins and the
autograd bridge in tgtc_torch.ops.kernels.flash_attention) against the
Pallas backward of tgtc.ops.pallas.flash_attention in interpret mode
(``jax.vjp``, blocks of 128), on numpy-seeded inputs and cotangents.

Tolerances, of max|JAX| per gradient: f32 1e-4 (the twins and the Pallas
kernels follow the same rounding points; only summation order differs),
bf16 3e-2 (tests/test_flash_attention.py:139's bf16 bound); under dropout
also the exact-mask oracle of tests/test_flash_attention.py:88-112 (2e-2
absolute, its bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.ops.pallas import flash_attention as jfa
from tgtc_torch.ops.kernels import flash_attention as fa
from test_flash_attention import _np_mask
from test_torch_ops import close

torch.set_num_threads(1)

TOL_F32, TOL_BF16, TOL_ORACLE = 1e-4, 3e-2, 2e-2
SCALE = 0.125


def _inputs(seed, b, h, sq, sk, d=64):
    """q, k, v and the cotangent do, f32 numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (sq, sk, sk, sq))


def _jax_grads(q, k, v, do, rate=0.0, seed=None, dtype=jnp.float32):
    """(o, dq, dk, dv) of the Pallas kernels (interpret mode) as f32 numpy."""
    def f(q, k, v):
        return jfa.flash_attention(q, k, v, sm_scale=SCALE, dropout_rate=rate, dropout_seed=seed,
                                   block_q=128, block_k=128, interpret=True)

    o, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, dtype))
    return tuple(np.asarray(x.astype(jnp.float32)) for x in (o,) + tuple(grads))


def _port_grads(q, k, v, do, rate=0.0, seed=None, dtype=torch.float32):
    """(o, dq, dk, dv) of the port's differentiable flash_attention."""
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, SCALE, rate, seed)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(dtype))
    return (o,) + grads


def _rel_close(got, want, rel):
    close(got, want, rel * float(np.abs(want).max()))


@pytest.mark.parametrize("sq,sk", [(200, 310), (300, 300), (128, 64)])
def test_twins_match_pallas_backward_f32(sq, sk):
    q, k, v, do = _inputs(0, 1, 2, sq, sk)
    want = _jax_grads(q, k, v, do)
    for got, ref in zip(_port_grads(q, k, v, do), want):
        _rel_close(got, ref, TOL_F32)
    # the twins called directly, from the forward twin's o and lse
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_fwd_plain(tq, tk, tv, SCALE)
    for got, ref in zip(fa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, SCALE), want[1:]):
        _rel_close(got, ref, TOL_F32)


def test_twins_match_pallas_backward_bf16():
    q, k, v, do = _inputs(1, 1, 2, 260, 190)
    want = _jax_grads(q, k, v, do, dtype=jnp.bfloat16)
    got = _port_grads(q, k, v, do, dtype=torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, ref in zip(got, want):
        _rel_close(g, ref, TOL_BF16)


def test_dropout_matches_pallas_and_the_exact_mask_oracle():
    b, h, sq, sk, rate, seed = 1, 2, 300, 180, 0.25, 7
    q, k, v, do = _inputs(2, b, h, sq, sk)
    want = _jax_grads(q, k, v, do, rate, seed)
    got = _port_grads(q, k, v, do, rate, seed)
    for g, ref in zip(got, want):
        _rel_close(g, ref, TOL_F32)
    # the exact-mask oracle: softmax, the hash mask / keep, autograd through it
    thr, keep = fa.quantized_keep(rate)
    mask = torch.from_numpy(_np_mask(seed, b * h, sq, sk, thr).reshape(b, h, sq, sk))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    p = torch.softmax(tq @ tk.transpose(-1, -2) * SCALE, dim=-1)
    o = torch.where(mask, p / keep, 0.0) @ tv
    oracle = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    close(got[0], o.detach(), TOL_ORACLE)
    for g, ref in zip(got[1:], oracle):
        close(g, ref, TOL_ORACLE)


def test_autograd_function_matches_torch_autograd_through_the_reference():
    q, k, v, do = _inputs(3, 2, 3, 150, 170, 32)
    got = _port_grads(q, k, v, do)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.attention_reference(tq, tk, tv, SCALE)
    want = (o,) + torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, ref in zip(got, want):
        _rel_close(g, ref.detach(), TOL_F32)


def test_strided_head_views_in_and_out():
    """q, k, v as [B, H, S, D] views of [B, S, H, D] (the projections'
    layout) and a strided cotangent give the same gradients, bit for bit."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, 2, 4, 100, 75))

    def grads(q, k, v, do):
        q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
        o = fa.flash_attention(q, k, v, SCALE, 0.1, 3)
        return (o,) + torch.autograd.grad(o, (q, k, v), do)

    def view(x):
        return x.transpose(1, 2).contiguous().transpose(1, 2)

    views = [view(x).detach().requires_grad_() for x in (q, k, v)]
    assert not views[0].is_contiguous()
    o_v = fa.flash_attention(*views, SCALE, 0.1, 3)
    got = (o_v,) + torch.autograd.grad(o_v, views, view(do))
    for a, b in zip(got, grads(q, k, v, do)):
        assert torch.equal(a, b)
    # the twins also take dq/dk/dv layouts as given: the backward's Δ
    delta = fa.attention_delta(o_v.detach(), view(do))
    assert delta.is_contiguous() and delta.shape == (2, 4, 100)


def test_a_different_seed_gives_a_different_mask_and_gradient():
    q, k, v, do = _inputs(5, 1, 2, 128, 96)
    a, a2, b = (_port_grads(q, k, v, do, 0.25, s) for s in (11, 11, 12))
    for x, y, z in zip(a, a2, b):
        assert torch.equal(x, y)
        assert float((x - z).abs().max()) > 1e-3


def test_wrappers_run_the_twins_for_cpu_tensors_and_count_no_launch():
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(6, 1, 2, 70, 90))
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, SCALE, 0.1, 5)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, SCALE, 0.1, 5)
    assert torch.equal(fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dq_plain(*args))
    got, want = fa.flash_attention_bwd_dkv(*args), fa.flash_attention_bwd_dkv_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == before


def test_seed_may_be_a_tensor():
    q, k, v, do = _inputs(7, 1, 1, 64, 64)
    a = _port_grads(q, k, v, do, 0.25, 9)
    b = _port_grads(q, k, v, do, 0.25, torch.tensor([9], dtype=torch.int32))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
