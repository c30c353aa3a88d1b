"""The port's multi-process runtime (tgtc_torch.parallel) without spawning a
process, against tgtc.parallel.

* ``discover_cluster_env`` returns JAX's spec on the same environments (the
  TGTC, torchrun and SLURM cases, an empty one and partial ones), and
  ``multi_process_launch`` reads it.
* ``DataGroup.rows`` at W = 2 keeps the rows that JAX's ``data_sharding``
  places on each half of ``cpu_mesh8`` split 2 x 4 (the devices of a
  process); a batch that W does not split raises, as the mesh refuses one;
  the 1-process group is the identity and runs no collective.
* The plain K6/K7/K8 at dropout 0.1 on rows ``b0…`` of a batch with
  ``bh_offset = b0 · H`` equal rows ``b0…`` of the whole batch's o, lse,
  dQ, dK and dV exactly, and the Pallas kernels' (interpret mode) on the
  whole batch within the f32 bounds of tests/test_torch_flash_attention.py
  and tests/test_torch_flash_attention_grad.py; at offset 0 the twins are
  the default call bit for bit, and their mask is the oracle's
  (``_np_mask``) for the whole batch's batch·head index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.ops.pallas import flash_attention as jfa
from tgtc.parallel.distributed import discover_cluster_env as jax_discover
from tgtc.parallel.mesh import data_sharding
from tgtc_torch.ops.kernels import flash_attention as fa
from tgtc_torch.parallel import DataGroup, discover_cluster_env, multi_process_launch
from test_flash_attention import _np_mask
from test_torch_ops import close

torch.set_num_threads(1)

TOL_FWD, TOL_GRAD, TOL_LSE = 5e-3, 1e-4, 1e-4  # f32, of the flash tests' bounds
SCALE, RATE, SEED = 0.125, 0.1, 7

ENVS = [
    {"TGTC_COORDINATOR": "10.0.0.1:1234", "TGTC_NUM_PROCESSES": "4", "TGTC_PROCESS_ID": "2"},
    {"MASTER_ADDR": "host0", "MASTER_PORT": "29500", "WORLD_SIZE": "8", "RANK": "3"},
    {"SLURM_PROCID": "1", "SLURM_NTASKS": "2", "TGTC_COORDINATOR": "node0:5555"},
    # the first complete spec wins
    {"TGTC_COORDINATOR": "a:1", "TGTC_NUM_PROCESSES": "2", "TGTC_PROCESS_ID": "1",
     "MASTER_ADDR": "b", "MASTER_PORT": "2", "WORLD_SIZE": "4", "RANK": "3"},
    {"MASTER_ADDR": "b", "MASTER_PORT": "2", "WORLD_SIZE": "1", "RANK": "0"},
    {},
    {"RANK": "0"},
    {"WORLD_SIZE": "4", "MASTER_ADDR": "b", "RANK": "1"},
    {"SLURM_PROCID": "1", "SLURM_NTASKS": "2"},
    {"TGTC_COORDINATOR": "a:1", "TGTC_NUM_PROCESSES": "2"},
    {"TGTC_DISTRIBUTED": "1"},
]


@pytest.mark.parametrize("env", ENVS)
def test_discover_cluster_env_matches_jax(env):
    spec = discover_cluster_env(env)
    assert spec == jax_discover(env)
    want = spec["num_processes"] > 1 if spec else env.get("TGTC_DISTRIBUTED") == "1"
    assert multi_process_launch(env) == want


@pytest.mark.parametrize("ndim", [1, 2, 4])
def test_rows_are_the_mesh_halves(cpu_mesh8, ndim):
    b = 16
    x = np.arange(b * 3 ** (ndim - 1), dtype=np.float32).reshape((b,) + (3,) * (ndim - 1))
    arr = jax.device_put(jnp.asarray(x), data_sharding(cpu_mesh8, ndim))
    devices = list(cpu_mesh8.devices.reshape(-1))
    for half in range(2):
        mine = devices[4 * half: 4 * half + 4]
        held = sorted((s for s in arr.addressable_shards if s.device in mine),
                      key=lambda s: s.index[0].start)
        want = np.concatenate([np.asarray(s.data) for s in held], 0)
        got = DataGroup(None, half, 2).rows(torch.from_numpy(x))
        assert np.array_equal(got.numpy(), want), half
        assert DataGroup(None, half, 2).row_offset(b) == held[0].index[0].start


def test_an_unsplit_batch_raises_and_one_process_is_the_identity():
    with pytest.raises(ValueError, match="does not split"):
        DataGroup(None, 0, 2).rows(torch.zeros(7, 3))
    from tgtc_torch.train.nerf_trainer import NerfTrainConfig, make_train_step

    with pytest.raises(ValueError, match="does not split"):
        make_train_step(NerfTrainConfig(batch_size=9), device="cpu", group=DataGroup(None, 0, 2))
    with pytest.raises(RuntimeError, match="without a process group"):
        DataGroup(None, 0, 2).all_reduce_mean_([torch.ones(3)])
    one = DataGroup()
    x = torch.arange(6.0)
    assert one.rows(x) is x and one.all_reduce_sum(x) is x and one.gather_rows(x) is x
    grads = [torch.ones(2), None, torch.zeros(3, dtype=torch.float64)]
    assert one.all_reduce_mean_(grads) == grads
    assert torch.equal(grads[0], torch.ones(2))
    one.broadcast_([x])
    one.barrier()
    assert not torch.distributed.is_initialized()


def _inputs(b=4, h=2, sq=130, sk=70, d=64):
    rng = np.random.default_rng(11)
    return tuple(torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
                 for n in (sq, sk, sk, sq))


@pytest.mark.parametrize("b0", [0, 1, 2])
def test_offset_rows_equal_the_whole_batch(b0):
    q, k, v, do = _inputs()
    h = q.shape[1]
    o, lse = fa.flash_attention_fwd_plain(q, k, v, SCALE, RATE, SEED)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, SCALE, RATE, SEED)
    sl = slice(b0, b0 + 2)
    o_r, lse_r = fa.flash_attention_fwd_plain(q[sl], k[sl], v[sl], SCALE, RATE, SEED,
                                              bh_offset=b0 * h)
    grads_r = fa.flash_attention_bwd_plain(q[sl], k[sl], v[sl], o_r, do[sl], lse_r, SCALE, RATE,
                                           SEED, bh_offset=b0 * h)
    for got, whole in zip((o_r, lse_r) + grads_r, (o, lse, dq, dk, dv)):
        assert torch.equal(got, whole[sl])
    # through the autograd bridge, the path the transformer takes
    tq, tk, tv = (x[sl].clone().requires_grad_() for x in (q, k, v))
    o_b = fa.flash_attention(tq, tk, tv, SCALE, RATE, SEED, bh_offset=b0 * h)
    grads_b = torch.autograd.grad(o_b, (tq, tk, tv), do[sl])
    for got, whole in zip((o_b,) + grads_b, (o, dq, dk, dv)):
        assert torch.equal(got, whole[sl])


def test_offset_zero_is_the_default_call_and_the_oracle_mask():
    q, k, v, do = _inputs()
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    o, lse = fa.flash_attention_fwd_plain(q, k, v, SCALE, RATE, SEED)
    o0, lse0 = fa.flash_attention_fwd_plain(q, k, v, SCALE, RATE, SEED, bh_offset=0)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    for got, want in zip(fa.flash_attention_bwd_plain(q, k, v, o, do, lse, SCALE, RATE, SEED,
                                                      bh_offset=0),
                         fa.flash_attention_bwd_plain(q, k, v, o, do, lse, SCALE, RATE, SEED)):
        assert torch.equal(got, want)
    thr, _ = fa.quantized_keep(RATE)
    oracle = _np_mask(SEED, b * h, sq, sk, thr)
    rows, cols = torch.arange(sq), torch.arange(sk)
    for bh in range(b * h):
        assert np.array_equal(fa.dropout_keep_mask(SEED, bh, rows, cols, thr).numpy(),
                              oracle[bh])


def test_offset_rows_equal_the_pallas_kernels_on_the_whole_batch():
    q, k, v, do = _inputs(b=2)
    h = q.shape[1]

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, sm_scale=SCALE, dropout_rate=RATE,
                                   dropout_seed=SEED, block_q=128, block_k=128, interpret=True)

    o_j, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = (o_j,) + tuple(vjp(jnp.asarray(do.numpy())))
    tq, tk, tv = (x[1:].clone().requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, SCALE, RATE, SEED, bh_offset=h)
    got = (o,) + torch.autograd.grad(o, (tq, tk, tv), do[1:])
    for g, w, tol in zip(got, want, (TOL_FWD, TOL_GRAD, TOL_GRAD, TOL_GRAD)):
        w = np.asarray(w)[1:]
        close(g, w, tol * float(np.abs(w).max()) if tol == TOL_GRAD else tol)
