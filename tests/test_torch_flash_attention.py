"""K6's plain twin (tgtc_torch.ops.kernels.flash_attention) against the
Pallas flash-attention forward in interpret mode and its XLA twin
``attention_reference``, on the shapes of tests/test_flash_attention.py.

Tolerances: f32 5e-3 and bf16 3e-2 (tests/test_flash_attention.py:60,
:139), lse 1e-4; the dropout mask bit for bit against ``_np_mask``, the
keep probability exactly.
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

TOL_F32, TOL_BF16, TOL_LSE = 5e-3, 3e-2, 1e-4


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (sq, sk, sk))


def _jax_fwd(q, k, v, sm_scale, rate=0.0, seed=0, dtype=jnp.float32):
    """Pallas forward in interpret mode: (o, lse [B, H, Sq])."""
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    seed_arr = jnp.asarray([seed], jnp.int32)
    o, res = jfa._flash_fwd(jq, jk, jv, seed_arr, sm_scale, rate, 128, 128, True)
    b, h, sq, _ = q.shape
    lse = np.asarray(res[4])[:, :sq, 0].reshape(b, h, sq)
    return np.asarray(o.astype(jnp.float32)), lse


def _torch(*arrs, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrs)


# The last four shapes cut K6's 128-row blocks and 128-key tiles on the card
# (tests/test_torch_cuda.py): the twin that K6 is held to is held here.
@pytest.mark.parametrize("sq,sk", [(300, 300), (257, 520), (128, 64), (200, 130), (1000, 1030),
                                   (300, 1), (300, 65)])
def test_twin_matches_pallas_and_reference(sq, sk):
    q, k, v = _qkv(0, 2, 3, sq, sk, 64)
    o_j, lse_j = _jax_fwd(q, k, v, 0.125)
    o, lse = fa.flash_attention_fwd_plain(*_torch(q, k, v), sm_scale=0.125)
    close(o, o_j, TOL_F32)
    close(lse, lse_j, TOL_LSE)
    ref = np.asarray(jfa.attention_reference(*(jnp.asarray(x) for x in (q, k, v)), 0.125))
    close(o, ref, TOL_F32)
    close(fa.attention_reference(*_torch(q, k, v), 0.125), ref, 1e-5)


@pytest.mark.parametrize("d", [32, 128])
def test_head_dims(d):
    q, k, v = _qkv(6, 1, 2, 200, 200, d)
    sc = 1 / np.sqrt(d)
    o_j, lse_j = _jax_fwd(q, k, v, sc)
    o, lse = fa.flash_attention_fwd_plain(*_torch(q, k, v), sm_scale=sc)
    close(o, o_j, TOL_F32)
    close(lse, lse_j, TOL_LSE)


def test_bf16_matches_pallas_and_f32_reference():
    q, k, v = _qkv(4, 1, 2, 260, 260, 64)
    o_j, lse_j = _jax_fwd(q, k, v, 0.125, dtype=jnp.bfloat16)
    o, lse = fa.flash_attention_fwd_plain(*_torch(q, k, v, dtype=torch.bfloat16),
                                          sm_scale=0.125)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    close(o, o_j, TOL_BF16)
    close(lse, lse_j, TOL_LSE)
    ref = fa.attention_reference(*_torch(q, k, v), 0.125)
    close(o, ref, TOL_BF16)


@pytest.mark.parametrize("sq,sk,rate,seed", [(300, 300, 0.25, 7), (300, 180, 0.1, -3),
                                              (200, 130, 0.25, 7), (1000, 1030, 0.25, 11),
                                              (300, 1, 0.25, 7), (300, 65, 0.1, -3)])
def test_dropout_matches_pallas_and_the_mask_oracle(sq, sk, rate, seed):
    q, k, v = _qkv(3, 1, 2, sq, sk, 64)
    o_j, lse_j = _jax_fwd(q, k, v, 0.125, rate, seed)
    o, lse = fa.flash_attention_fwd_plain(*_torch(q, k, v), sm_scale=0.125,
                                          dropout_rate=rate, dropout_seed=seed)
    close(o, o_j, TOL_F32)
    close(lse, lse_j, TOL_LSE)  # the normalizer sums the undropped probabilities
    thr, keep = fa.quantized_keep(rate)
    mask = _np_mask(seed, 2, sq, sk, thr).reshape(1, 2, sq, sk)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * 0.125
    p = np.exp(s - s.max(-1, keepdims=True))
    p = np.where(mask, p / p.sum(-1, keepdims=True) / keep, 0.0)
    close(o, np.einsum("bhqk,bhkd->bhqd", p, v), TOL_F32)


@pytest.mark.parametrize("seed", [0, 7, -1, 2 ** 31 - 1])
def test_dropout_keep_mask_is_the_oracle_bit_for_bit(seed):
    thr, _ = fa.quantized_keep(0.25)
    want = _np_mask(seed, 5, 130, 257, thr)
    for bh in range(5):
        got = fa.dropout_keep_mask(seed, bh, torch.arange(130), torch.arange(257), thr)
        assert np.array_equal(got.numpy(), want[bh]), bh
    # absolute indices: a window equals the same window of the full mask
    got = fa.dropout_keep_mask(seed, 3, torch.arange(64, 130), torch.arange(100, 257), thr)
    assert np.array_equal(got.numpy(), want[3, 64:, 100:])


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.25, 0.5, 1.0, 1e-12])
def test_quantized_keep_is_exact(rate):
    assert fa.quantized_keep(rate) == jfa._quantized_keep(rate)


def test_extreme_logits_stay_finite():
    q, k, v = _qkv(8, 1, 1, 200, 200, 64)
    q = q * 100.0
    o, lse = fa.flash_attention_fwd_plain(*_torch(q, k, v), sm_scale=1.0)
    assert bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    o_j, _ = _jax_fwd(q, k, v, 1.0)
    close(o, o_j, TOL_F32)


def test_wrapper_runs_the_twin_for_cpu_tensors_and_counts_no_launch():
    q, k, v = _torch(*_qkv(9, 2, 2, 70, 90, 64), dtype=torch.bfloat16)
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, sm_scale=0.125, dropout_rate=0.1, dropout_seed=5)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, 0.125, 0.1, 5)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert torch.equal(fa.flash_attention(q, k, v, 0.125), fa.flash_attention_plain(q, k, v, 0.125))
    assert fa.flash_attention_fwd.launches == before


def test_strided_views_and_row_chunks_give_the_same_result():
    """q/k/v as head-transposed views of [B, S, H, D] (the projections'
    layout) and the twin's row chunking change nothing."""
    q, k, v = _torch(*_qkv(10, 2, 4, 100, 75, 64))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    o, lse = fa.flash_attention_fwd_plain(q, k, v, 0.125)
    o_v, lse_v = fa.flash_attention_fwd_plain(*views, 0.125, rows=16)
    assert torch.equal(o, o_v) and torch.equal(lse, lse_v)


def test_argument_errors():
    q, k, v = _torch(*_qkv(5, 1, 1, 16, 16, 64))
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="zero keys"):
        fa.flash_attention(q, k[:, :, :0], v[:, :, :0])
