"""The sample-budget machinery of the port against tgtc's.

* ``select_sample_budget`` in both branches (the comparison count on
  perturbed coarse depths, the ``grid=(near, far)`` floor on the
  unperturbed linspace): kept depths and deltas equal to JAX's bit for bit
  in f32, on rows whose scores are all 0, half 0 and none 0 (empty space
  scores many samples exactly 0, so ties at the top-K boundary are the
  rule); ``top_k_indices`` gives ``jax.lax.top_k``'s indices, ties to the
  lower index.
* ``merge_two_sorted`` bit for bit; ``alpha_composite_wild`` and the subset
  composite with ``deltas`` to 1e-6; the identity "subset composite ==
  full composite with the dropped alphas set to 0".
* ``render_rays`` with ``fine_budget`` against JAX's in f32 with JAX's
  draws (the bounds of tests/test_torch_render.py's eager test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.nerf import NerfConfig as JNerfConfig, make_nerf as j_make_nerf
from tgtc.ops import composite as jc
from tgtc.ops import sampling as js
from tgtc.render.volume import RenderSettings as JSettings, render_rays as j_render_rays
from tgtc_torch.convert import nerf_state_dict_from_flax
from tgtc_torch.models.nerf import NerfConfig, NerfMLP
from tgtc_torch.ops import composite as tc
from tgtc_torch.ops import sampling as ts
from tgtc_torch.render.volume import RenderSettings, render_rays
from test_torch_ops import close

torch.set_num_threads(1)
NC, NF = 16, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _budget_case(seed: int, r: int = 24, perturb: bool = True):
    """Coarse depths (perturbed or the linspace), merged depths and a
    coarse σ whose first third of rows is all <= 0 and second third half
    <= 0 (scores exactly 0 there)."""
    rng = np.random.default_rng(seed)
    lin = np.linspace(0.0, 1.0, NC, dtype=np.float32)
    if perturb:
        mid = 0.5 * (lin[1:] + lin[:-1])
        lo, hi = np.concatenate([lin[:1], mid]), np.concatenate([mid, lin[-1:]])
        ts_c = (lo + (hi - lo) * rng.uniform(size=(r, NC))).astype(np.float32)
    else:
        ts_c = np.broadcast_to(lin, (r, NC)).copy()
    extra = rng.uniform(size=(r, NF)).astype(np.float32)
    ts_all = np.sort(np.concatenate([ts_c, extra], -1), -1)
    sigma = (rng.standard_normal((r, NC)) * 4.0).astype(np.float32)
    k = r // 3
    sigma[:k] = -np.abs(sigma[:k])
    sigma[k:2 * k, NC // 2:] = 0.0
    return ts_all, ts_c, sigma


@pytest.mark.parametrize("budget", [8, 20, 32])
@pytest.mark.parametrize("grid", [False, True])
def test_select_sample_budget_matches_jax_bit_for_bit(grid, budget):
    ts_all, ts_c, sigma = _budget_case(budget + grid, perturb=not grid)
    kw = {"grid": (0.0, 1.0)} if grid else {}
    want_t, want_d = js.select_sample_budget(jnp.asarray(ts_all), jnp.asarray(ts_c),
                                             jnp.asarray(sigma), budget, **kw)
    got_t, got_d = ts.select_sample_budget(_t(ts_all), _t(ts_c), _t(sigma), budget, **kw)
    assert got_t.shape == (ts_all.shape[0], budget)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    # the all-zero rows keep their first `budget` merged samples
    np.testing.assert_array_equal(got_t[:8].numpy(), ts_all[:8, :budget])


def test_grid_floor_equals_the_comparison_count_on_the_linspace():
    ts_all, ts_c, sigma = _budget_case(3, perturb=False)
    a = ts.select_sample_budget(_t(ts_all), _t(ts_c), _t(sigma), 12, grid=(0.0, 1.0))
    b = ts.select_sample_budget(_t(ts_all), _t(ts_c), _t(sigma), 12)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_top_k_indices_resolve_ties_as_lax_top_k():
    rng = np.random.default_rng(0)
    score = rng.uniform(size=(6, 40)).astype(np.float32)
    score[0] = 0.0                                   # all tied
    score[1, ::2] = 0.0                              # half tied at 0
    score[2] = np.repeat(rng.uniform(size=8), 5)     # runs of equal values
    score[3, 10:30] = score[3, 10]                   # a tied block across the boundary
    for k in (1, 7, 20, 40):
        want = np.asarray(jax.lax.top_k(jnp.asarray(score), k)[1])
        np.testing.assert_array_equal(ts.top_k_indices(_t(score), k).numpy(), want)


def test_select_sample_budget_takes_no_gradient():
    ts_all, ts_c, sigma = _budget_case(4)
    s = _t(sigma).requires_grad_(True)
    kept, deltas = ts.select_sample_budget(_t(ts_all), _t(ts_c), s, 10)
    assert not kept.requires_grad and not deltas.requires_grad
    with pytest.raises(ValueError, match="budget"):
        ts.select_sample_budget(_t(ts_all), _t(ts_c), s, NC + NF + 1)


def test_merge_two_sorted_matches_jax():
    rng = np.random.default_rng(1)
    a = np.sort(rng.uniform(size=(10, 12)).astype(np.float32), -1)
    b = rng.uniform(size=(10, 9)).astype(np.float32)
    b[:, 3] = a[:, 5]  # ties: a first
    b = np.sort(b, -1)
    want = np.asarray(js.merge_two_sorted(jnp.asarray(a), jnp.asarray(b)))
    got = ts.merge_two_sorted(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(np.concatenate([a, b], -1), -1))


def test_alpha_composite_wild_matches_jax():
    rng = np.random.default_rng(2)
    r, n = 16, 12
    t = np.sort(rng.uniform(size=(r, n)).astype(np.float32), -1)
    arrs = dict(rgb=rng.uniform(size=(r, n, 3)), sigma=rng.standard_normal((r, n)) * 3,
                transient_rgb=rng.uniform(size=(r, n, 3)),
                transient_sigma=rng.standard_normal((r, n)) * 3,
                transient_beta=rng.standard_normal((r, n, 1)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (r, n), jnp.float32))
    for white in (False, True):
        want = jc.alpha_composite_wild(t_values=jnp.asarray(t), noise_std=0.5, key=key,
                                       white_bkgd=white,
                                       **{k: jnp.asarray(v) for k, v in arrs.items()})
        got = tc.alpha_composite_wild(t_values=_t(t), noise_std=0.5, noise=_t(noise),
                                      white_bkgd=white, **{k: _t(v) for k, v in arrs.items()})
        for g, w in zip(got, want):
            close(g, np.asarray(w), atol=1e-6)


def test_subset_composite_with_deltas_matches_jax_and_the_full_composite():
    ts_all, ts_c, sigma_c = _budget_case(6)
    rng = np.random.default_rng(6)
    r, m = ts_all.shape
    rgb = rng.uniform(size=(r, m, 3)).astype(np.float32)
    sigma = (rng.standard_normal((r, m)) * 3).astype(np.float32)
    kept, deltas = ts.select_sample_budget(_t(ts_all), _t(ts_c), _t(sigma_c), 12)
    idx = torch.searchsorted(_t(ts_all), kept)  # merged depths are distinct
    sub_rgb = torch.gather(_t(rgb), 1, idx[..., None].expand(-1, -1, 3))
    sub_sigma = torch.gather(_t(sigma), 1, idx)
    got = tc.alpha_composite(sub_rgb, sub_sigma, kept, deltas=deltas)
    want = jc.alpha_composite(jnp.asarray(sub_rgb.numpy()), jnp.asarray(sub_sigma.numpy()),
                              jnp.asarray(kept.numpy()), deltas=jnp.asarray(deltas.numpy()))
    for f in ("rgb", "t_exp", "acc", "weights"):
        close(getattr(got, f), np.asarray(getattr(want, f)), atol=1e-6)
    # the subset equals the full set with every dropped sample's alpha 0
    # (σ -inf: relu gives 0)
    dropped = torch.ones((r, m), dtype=torch.bool).scatter_(1, idx, False)
    full = tc.alpha_composite(_t(rgb), _t(sigma).masked_fill(dropped, -float("inf")),
                              _t(ts_all))
    for f in ("rgb", "t_exp", "acc"):
        close(getattr(got, f), getattr(full, f).numpy(), atol=1e-6)
    close(got.weights, torch.gather(full.weights, 1, idx).numpy(), atol=1e-6)


@pytest.mark.parametrize("budget", [12, 24])
def test_render_rays_with_fine_budget_matches_jax_f32(budget):
    cfg = JNerfConfig(compute_dtype=jnp.float32)
    (cm, cp), (fm, fp) = [j_make_nerf(cfg, jax.random.PRNGKey(s)) for s in (0, 1)]
    n = 32
    s_kw = dict(n_samples=NC, n_samples_fine=NF, sigma_noise_std=1.0, perturb=True,
                fine_budget=budget)
    rng = np.random.default_rng(3)
    ro = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(7)
    ref = j_render_rays(cm, cp, fm, fp, jnp.asarray(ro), jnp.asarray(rd), JSettings(**s_kw),
                        key=key)
    k_coarse, k_noise_c, k_noise_f = jax.random.split(key, 3)
    draws = {"perturb_u": jax.random.uniform(k_coarse, (n, NC), jnp.float32),
             "noise_coarse": jax.random.normal(k_noise_c, (n, NC), jnp.float32),
             "noise_fine": jax.random.normal(k_noise_f, (n, budget), jnp.float32)}
    models = []
    for params in (cp, fp):
        m = NerfMLP(NerfConfig(compute_dtype=torch.float32))
        m.load_state_dict(nerf_state_dict_from_flax(params))
        models.append(m)
    with torch.no_grad():
        out = render_rays(models[0], models[1], _t(ro), _t(rd), RenderSettings(**s_kw),
                          **{k: _t(v) for k, v in draws.items()})
    assert out["ts_fine"].shape == (n, budget)
    close(out["ts_fine"], np.asarray(ref["ts_fine"]), atol=1e-3)
    for stage, tol in (("coarse", 1e-4), ("fine", 5e-4)):
        for field in ("rgb", "t_exp", "acc", "weights"):
            close(getattr(out[stage], field), np.asarray(getattr(ref[stage], field)), atol=tol)
