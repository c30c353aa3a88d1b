"""Phase-A training (tgtc_torch.train.nerf_trainer) against tgtc's.

* The eager step against JAX ``make_train_step`` in f32 at small width, with
  JAX's own batch indices, jitter and σ noise injected, at the reference's
  lrate 5e-4, plain and with ``steps_per_opt=2`` (optax.MultiSteps): the
  losses of every step to 1e-5 and the first update's gradients (the Adam
  moments) to 5e-5 relative (max|err| / max|JAX| per leaf: the fine pass
  inherits the resampled depths' sensitivity, where ``sample_pdf`` divides
  by CDF differences near 1e-5; measured up to 3.7e-5); parameters and
  moments after 3 steps, a parameter leaf's scale floored at the learning
  rate, to 1e-5 relative when every step updates (measured 8.1e-6) and to
  2e-4 with ``steps_per_opt=2`` (measured 1.2e-4). Adam divides each
  gradient element by its own size, so an element whose gradient is f32
  summation noise (XLA and torch sum in other orders) moves by a sizeable
  part of the learning rate in either framework; averaging two micro-steps
  first, as optax.MultiSteps does in its own order, widens that noise.
  optax also forms ``1 - 0.999 ** t`` in f32, where 0.999 is inexact:
  every update differs from torch's by about 6.4e-6 relative.
* The fused step (K1/K3 twins on the CPU) against JAX
  ``make_fused_train_step`` (Pallas interpret, tile 128): D8/W256, batch 8,
  16+16 samples (tile 128 must divide batch x samples), one step from the
  same state and draws: loss within 2e-2, gradient cosine >= 0.99 per leaf
  (JAX's gradient read off its first Adam moment, mu = 0.1 g).
* The same from a trained state (80 JAX eager steps on
  tests/synthetic_scene.py): the same bounds, and printed beside it, for
  each fused step and JAX's eager bf16 step, the distance from JAX's eager
  f32 step (whether a gap the fused step shows there is the port's or
  the algorithm's).
* A JAX state after 2 steps, converted, takes the same third step: loss to
  1e-5, parameters and moments to 1e-4 relative (measured 3.3e-5, on fine
  biases still within a few learning rates of 0, which the Adam noise
  above moves).
* The budget-schedule grammar agrees with JAX's on tests/test_train_fine_budget.py's
  cases.
* With ``train_fine_budget`` (12 of 16 eager, 16 of 32 fused): the eager
  step to the bounds of the plain eager step over 3 steps, the fused step
  to the fused bounds above, from the same states and draws (the fine
  noise then ``[B, budget]``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.nerf import NerfConfig as JNerfConfig
from tgtc.train import nerf_trainer as jt
from tgtc_torch.convert import nerf_state_dict_from_flax, nerf_train_state_from_jax
from tgtc_torch.models.nerf import NerfConfig
from tgtc_torch.train import nerf_trainer as tt
from test_torch_ops import close

torch.set_num_threads(1)

SMALL = dict(depth=4, width=32, embed_freq_coor=4, embed_freq_dir=2, skips=(2,))
TOL_GRAD = 5e-5
TOL_STATE = {1: 1e-5, 2: 2e-4}  # after 3 steps, by steps_per_opt
TOL_CONVERTED = 1e-4
TCFG = dict(batch_size=64, n_samples=8, n_samples_fine=8, sigma_noise_std=1.0)


def _toy_rays(n=512, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, (d * 0.5 + 0.5).astype(np.float32)


def _jax_draws(key, step, n_rays, c):
    """The draws JAX's step makes at ``step`` (nerf_trainer.py:159-161 and
    render/volume.py:85-86)."""
    k_idx, k_render = jax.random.split(jax.random.fold_in(key, step))
    idx = jax.random.randint(k_idx, (c.batch_size,), 0, n_rays)
    k_u, k_nc, k_nf = jax.random.split(k_render, 3)
    b, nc, nf = c.batch_size, c.n_samples, c.n_fine_eval
    t = lambda a: torch.from_numpy(np.array(a))
    return tt.StepDraws(
        t(idx).long(), t(jax.random.uniform(k_u, (b, nc))),
        t(jax.random.normal(k_nc, (b, nc))) if c.sigma_noise_std > 0 else None,
        t(jax.random.normal(k_nf, (b, nf))) if c.sigma_noise_std > 0 else None)


def _adam(j_state):
    opt = j_state.opt_state
    return (opt.inner_opt_state if hasattr(opt, "inner_opt_state") else opt)[0]


def _port_state(j_state, nerf_cfg, train_cfg):
    """The port's state from a JAX one (with MultiSteps, only where its
    gradient accumulator is empty)."""
    adam = _adam(j_state)
    return nerf_train_state_from_jax(
        int(j_state.step), *(jax.tree.map(np.asarray, t) for t in (
            j_state.params_coarse, j_state.params_fine)),
        int(adam.count), jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        nerf_cfg, train_cfg, device="cpu")


def _leaf_rel(got, want, floor=1e-30):
    got, want = got.detach().double(), want.double()
    return float((got - want).abs().max() / max(float(want.abs().max()), floor))


def _assert_state_close(state, j_state, tol, lrate, kinds=("param", "mu", "nu")):
    """Parameters and Adam moments, per leaf, relative to JAX's max; a
    parameter leaf's scale is at least the learning rate (a bias that has
    moved less than one Adam step from 0 has no scale of its own)."""
    worst = 0.0
    for which, model in (("coarse", state.coarse), ("fine", state.fine)):
        j_params = getattr(j_state, f"params_{which}")
        want = nerf_state_dict_from_flax(jax.tree.map(np.asarray, j_params))
        opt = state.optimizer.state
        adam = _adam(j_state)
        mu = nerf_state_dict_from_flax(jax.tree.map(np.asarray, adam.mu[which]))
        nu = nerf_state_dict_from_flax(jax.tree.map(np.asarray, adam.nu[which]))
        for name, p in model.named_parameters():
            for kind, got, ref in (("param", p, want[name]), ("mu", opt[p]["exp_avg"], mu[name]),
                                   ("nu", opt[p]["exp_avg_sq"], nu[name])):
                if kind not in kinds:
                    continue
                rel = _leaf_rel(got, ref, lrate if kind == "param" else 1e-30)
                worst = max(worst, rel)
                assert rel <= tol, (kind, which, name, rel)
    print(f"[parity] train state ({', '.join(kinds)}) vs JAX: max rel {worst:.3e} "
          f"(tol {tol:g})")


@pytest.mark.parametrize("k_steps", [1, 2])
def test_eager_step_matches_jax_f32(k_steps):
    j_cfg = JNerfConfig(compute_dtype=jnp.float32, **SMALL)
    t_cfg = NerfConfig(compute_dtype=torch.float32, **SMALL)
    j_tc = jt.NerfTrainConfig(steps_per_opt=k_steps, **TCFG)
    t_tc = tt.NerfTrainConfig(steps_per_opt=k_steps, **TCFG)
    cm, fm, j_state = jt.init_state(jax.random.PRNGKey(0), j_cfg, j_tc)
    state = _port_state(j_state, t_cfg, t_tc)
    j_step = jt.make_train_step(cm, fm, j_tc)
    step = tt.make_train_step(t_tc, device="cpu")
    ro, rd, rgb = _toy_rays()
    key = jax.random.PRNGKey(7)
    for s in range(3):
        draws = _jax_draws(key, s, ro.shape[0], t_tc)
        j_state, jm = j_step(j_state, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rgb), key)
        state, m = step(state, torch.from_numpy(ro), torch.from_numpy(rd),
                        torch.from_numpy(rgb), draws=draws)
        for k in ("loss", "loss_coarse", "loss_fine", "psnr_fine"):
            close(m[k], np.asarray(jm[k]), atol=1e-5 * max(1.0, abs(float(jm[k]))))
        if s == k_steps - 1:  # the first update's gradients
            _assert_state_close(state, j_state, TOL_GRAD, t_tc.lrate, kinds=("mu", "nu"))
    assert state.step == int(j_state.step) == 3
    _assert_state_close(state, j_state, TOL_STATE[k_steps], t_tc.lrate)


def test_converted_state_resumes_like_jax():
    j_cfg = JNerfConfig(compute_dtype=jnp.float32, **SMALL)
    t_cfg = NerfConfig(compute_dtype=torch.float32, **SMALL)
    j_tc, t_tc = jt.NerfTrainConfig(**TCFG), tt.NerfTrainConfig(**TCFG)
    cm, fm, j_state = jt.init_state(jax.random.PRNGKey(1), j_cfg, j_tc)
    j_step = jt.make_train_step(cm, fm, j_tc)
    ro, rd, rgb = _toy_rays(seed=1)
    key = jax.random.PRNGKey(3)
    args = (jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rgb), key)
    for _ in range(2):
        j_state, _ = j_step(j_state, *args)
    state = _port_state(j_state, t_cfg, t_tc)
    assert state.step == 2 and state.scheduler.last_epoch == 2
    j_state, jm = j_step(j_state, *args)
    state, m = tt.make_train_step(t_tc, device="cpu")(
        state, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(rgb),
        draws=_jax_draws(key, 2, ro.shape[0], t_tc))
    close(m["loss"], np.asarray(jm["loss"]), atol=1e-5)
    _assert_state_close(state, j_state, TOL_CONVERTED, t_tc.lrate)


def test_fused_step_matches_jax_fused_step():
    import tgtc.ops.pallas.nerf_mlp_grad as g

    j_cfg = JNerfConfig()
    t_cfg = NerfConfig()
    kw = dict(batch_size=8, n_samples=16, n_samples_fine=16, sigma_noise_std=1.0)
    j_tc, t_tc = jt.NerfTrainConfig(**kw), tt.NerfTrainConfig(**kw)
    _, _, j_state = jt.init_state(jax.random.PRNGKey(0), j_cfg, j_tc)
    state = _port_state(j_state, t_cfg, t_tc)
    orig = g.make_diff_apply
    try:
        g.make_diff_apply = lambda *a, **k: orig(*a, **{**k, "interpret": True})
        j_step = jt.make_fused_train_step(j_cfg, j_tc, tile=128)
    finally:
        g.make_diff_apply = orig
    ro, rd, rgb = _toy_rays(n=64, seed=2)
    key = jax.random.PRNGKey(3)
    j_state, jm = j_step(j_state, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rgb), key)
    step = tt.make_fused_train_step(t_cfg, t_tc, device="cpu")
    m, grads = step.loss_and_grad(state.coarse, state.fine, torch.from_numpy(ro),
                                  torch.from_numpy(rd), torch.from_numpy(rgb),
                                  _jax_draws(key, 0, ro.shape[0], t_tc))
    close(m["loss"], np.asarray(jm["loss"]), atol=2e-2)
    adam = j_state.opt_state[0]
    names = ([("coarse", n) for n, _ in state.coarse.named_parameters()]
             + [("fine", n) for n, _ in state.fine.named_parameters()])
    mu = {w: nerf_state_dict_from_flax(jax.tree.map(np.asarray, adam.mu[w]))
          for w in ("coarse", "fine")}
    worst = 1.0
    for (which, name), got in zip(names, grads):
        want = mu[which][name].double() / 0.1  # first Adam moment = 0.1 g
        got = got.double()
        cos = float((got * want).sum() / (got.norm() * want.norm() + 1e-30))
        worst = min(worst, cos)
        assert cos >= 0.99, (which, name, cos)
    print(f"[parity] fused step vs JAX fused step: loss {float(m['loss']):.6f} vs "
          f"{float(jm['loss']):.6f}, min grad cos {worst:.6f}")


def _step_grads(step_fn, j_state, ro, rd, rgb, key):
    """Loss and gradient of one JAX step from ``j_state``, whose Adam moments
    are fresh: the first moment after the step is 0.1 g. The step donates
    its state, so it takes a copy."""
    j_state, jm = step_fn(jax.tree.map(jnp.copy, j_state), ro, rd, rgb, key)
    adam = j_state.opt_state[0]
    grads = {w: nerf_state_dict_from_flax(jax.tree.map(lambda m: np.asarray(m) / 0.1, adam.mu[w]))
             for w in ("coarse", "fine")}
    return float(jm["loss"]), grads


def test_fused_step_matches_jax_fused_step_from_a_trained_state(tmp_path):
    """The fused step (twins) against JAX's fused step (Pallas interpret)
    from a trained state: full-width trunks trained by JAX's eager step on
    tests/synthetic_scene.py (lrate 5e-3, which reaches the fine PSNR of
    chip_smoke.py's 320 fern-width steps, ~28 dB, in 80 steps), then one
    step of each from the same state, batch and draws: loss within 2e-2,
    every gradient cosine >= 0.99. Printed beside it: how far each fused
    step and JAX's eager bf16 step lie from JAX's eager f32 step."""
    import tgtc.ops.pallas.nerf_mlp_grad as g
    from synthetic_scene import make_synthetic_llff_scene
    from tgtc.data.llff import load_llff_data
    from tgtc.data.rays import rays_for_poses

    scene = load_llff_data(make_synthetic_llff_scene(tmp_path), factor=1)
    h, w, _ = scene.hwf
    ro, rd = rays_for_poses(h, w, jnp.asarray(scene.intrinsics), jnp.asarray(scene.poses))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    rgb = jnp.asarray(scene.images, jnp.float32).reshape(-1, 3)
    j_cfg, f32_cfg = JNerfConfig(), JNerfConfig(compute_dtype=jnp.float32)
    train_tc = jt.NerfTrainConfig(batch_size=64, n_samples=16, n_samples_fine=16,
                                  sigma_noise_std=1.0, lrate=5e-3)
    cm, fm, j_state = jt.init_state(jax.random.PRNGKey(0), j_cfg, train_tc)
    train = jax.jit(jt.make_train_step(cm, fm, train_tc))
    for _ in range(80):
        j_state, jm = train(j_state, ro, rd, rgb, jax.random.PRNGKey(1))
    psnr = float(jm["psnr_fine"])

    kw = dict(batch_size=8, n_samples=16, n_samples_fine=16, sigma_noise_std=1.0)
    j_tc, t_tc = jt.NerfTrainConfig(**kw), tt.NerfTrainConfig(**kw)
    cm32, fm32, fresh = jt.init_state(jax.random.PRNGKey(0), f32_cfg, j_tc)
    trained = fresh.replace(step=j_state.step, params_coarse=j_state.params_coarse,
                            params_fine=j_state.params_fine)
    orig = g.make_diff_apply
    try:
        g.make_diff_apply = lambda *a, **k: orig(*a, **{**k, "interpret": True})
        j_fused = jt.make_fused_train_step(j_cfg, j_tc, tile=128)
    finally:
        g.make_diff_apply = orig
    key = jax.random.PRNGKey(3)
    runs = {"jax_fused": j_fused, "jax_bf16": jt.make_train_step(cm, fm, j_tc),
            "jax_f32": jt.make_train_step(cm32, fm32, j_tc)}
    runs = {k: _step_grads(fn, trained, ro, rd, rgb, key) for k, fn in runs.items()}

    state = _port_state(trained, NerfConfig(), t_tc)
    step = tt.make_fused_train_step(NerfConfig(), t_tc, device="cpu")
    to_t = lambda a: torch.from_numpy(np.array(a))
    m, grads = step.loss_and_grad(state.coarse, state.fine, to_t(ro), to_t(rd), to_t(rgb),
                                  _jax_draws(key, int(trained.step), ro.shape[0], t_tc))
    names = ([("coarse", n) for n, _ in state.coarse.named_parameters()]
             + [("fine", n) for n, _ in state.fine.named_parameters()])
    port = {(wh, n): gr.detach().double() for (wh, n), gr in zip(names, grads)}
    close(m["loss"], runs["jax_fused"][0], atol=2e-2)
    cos = lambda a, b: float((a * b).sum() / (a.norm() * b.norm() + 1e-30))
    worst = 1.0
    for (wh, n), got in port.items():
        c = cos(got, runs["jax_fused"][1][wh][n].double())
        worst = min(worst, c)
        assert c >= 0.99, (wh, n, c)

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-30))

    def above(errs):  # leaves whose error exceeds 1.3x the eager bf16 step's + 5e-3
        return sum(e > 1.3 * errs_bf16[k] + 5e-3 for k, e in errs.items())

    f32 = {(wh, n): runs["jax_f32"][1][wh][n].double() for wh, n in names}
    errs_bf16 = {k: rel(runs["jax_bf16"][1][k[0]][k[1]].double(), f32[k]) for k in names}
    errs_jax = {k: rel(runs["jax_fused"][1][k[0]][k[1]].double(), f32[k]) for k in names}
    errs_port = {k: rel(port[k], f32[k]) for k in names}
    print(f"[parity] trained state (JAX eager, 80 steps, psnr_fine {psnr:.2f}), fused step "
          f"(twins) vs JAX fused step: loss {float(m['loss']):.6f} vs {runs['jax_fused'][0]:.6f}, "
          f"min grad cos {worst:.6f}; vs JAX eager f32, leaves above 1.3x the eager bf16 "
          f"step's error + 5e-3: port fused {above(errs_port)}, JAX fused {above(errs_jax)} "
          f"of {len(names)}; max rel error port fused {max(errs_port.values()):.3f}, JAX fused "
          f"{max(errs_jax.values()):.3f}, JAX eager bf16 {max(errs_bf16.values()):.3f}")


def test_fused_step_supported_and_builders_refuse():
    cfg, tc = NerfConfig(), tt.NerfTrainConfig()
    assert tt.fused_train_supported(cfg)
    for other in (dict(act_type="elu"), dict(use_viewdir=False), dict(skips=(3,)),
                  dict(width=128)):
        assert not tt.fused_train_supported(dataclasses.replace(cfg, **other))
    assert not tt.fused_train_supported(cfg, dataclasses.replace(cfg, depth=6))
    with pytest.raises(ValueError, match="preconditions"):
        tt.make_fused_train_step(NerfConfig(**SMALL), tc, device="cpu")
    # a training-time budget builds both steps (their parity with JAX's:
    # test_budget_steps_match_jax); one outside (0, Nc + Nf] is refused
    budget = tt.NerfTrainConfig(train_fine_budget=80)
    assert budget.n_fine_eval == 80
    for build in (lambda tc: tt.make_train_step(tc, device="cpu"),
                  lambda tc: tt.make_fused_train_step(cfg, tc, device="cpu")):
        assert isinstance(build(budget), tt.TrainStep)
        with pytest.raises(ValueError, match="train_fine_budget"):
            build(tt.NerfTrainConfig(train_fine_budget=129))


@pytest.mark.parametrize("steps_per_opt", [1, 2])
def test_fused_cpu_call_never_captures_and_equals_the_eager_blocks(steps_per_opt):
    """On the CPU the fused step's ``__call__`` runs eagerly (its CUDA graphs
    are the card's): both counters stay 0, and three steps leave the metrics
    and every parameter bit for bit where ``draw`` + ``loss_and_grad`` +
    ``apply`` leave them."""
    cfg = NerfConfig()
    tc = tt.NerfTrainConfig(steps_per_opt=steps_per_opt, **{**TCFG, "batch_size": 8})
    ro, rd, rgb = (torch.from_numpy(a) for a in _toy_rays(n=64, seed=4))
    called, built = (tt.init_state(torch.Generator().manual_seed(0), cfg, tc, device="cpu")
                     for _ in range(2))
    step = tt.make_fused_train_step(cfg, tc, device="cpu")
    blocks = tt.make_fused_train_step(cfg, tc, device="cpu")
    for s in range(3):
        called, m = step(called, ro, rd, rgb, generator=torch.Generator().manual_seed(s))
        draws = blocks.draw(ro.shape[0], torch.Generator().manual_seed(s))
        m_b, g = blocks.loss_and_grad(built.coarse, built.fine, ro, rd, rgb, draws)
        blocks.apply(built, g)
        built.step += 1
        assert m.keys() == m_b.keys() and all(torch.equal(m[k], m_b[k]) for k in m_b)
    assert (step.captures, step.replays) == (0, 0)
    assert called.step == built.step == 3 and called.mini_step == built.mini_step
    for p, q in zip(called.parameters(), built.parameters()):
        assert torch.equal(p, q)


def test_learning_rate_schedule_counts_updates():
    tc = tt.NerfTrainConfig(lrate=1e-2, lrate_decay=4, steps_per_opt=2, batch_size=4,
                            n_samples=4, n_samples_fine=4)
    state = tt.init_state(torch.Generator().manual_seed(0), NerfConfig(**SMALL), tc,
                          device="cpu")
    ro, rd, rgb = (torch.from_numpy(a) for a in _toy_rays(n=32))
    step = tt.make_train_step(tc, device="cpu")
    lrs = []
    for s in range(6):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        state, _ = step(state, ro, rd, rgb, generator=torch.Generator().manual_seed(s))
    # one update every 2 micro-steps; update n runs at 1e-2 * 0.1 ** (n / 4)
    np.testing.assert_allclose(lrs, [1e-2 * 0.1 ** (n / 4) for n in (0, 0, 1, 1, 2, 2)])
    assert state.step == 6 and state.grad_acc is None


@pytest.mark.parametrize("spec", [
    "", None, "80", "96@60000,80@90000", "0", "80@100,0", "80@90000,96@60000",
    "80@100,96@200", "80,0@100", "abc", "80@x", "-1", "80@-5", "80@100,96@100",
])
def test_budget_schedule_matches_jax(spec):
    def run(parse):
        try:
            return parse(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tt.parse_budget_schedule) == run(jt.parse_budget_schedule)


@pytest.mark.parametrize("step", [0, 99, 100, 199, 200, 10 ** 6])
def test_budget_at_step_matches_jax(step):
    seg = jt.parse_budget_schedule("96@100,80@200")
    assert tt.budget_at_step(seg, step) == jt.budget_at_step(seg, step)
    assert tt.budget_at_step(tt.parse_budget_schedule(""), step) == (None, None)


@pytest.mark.parametrize("kind", ["eager", "fused"])
def test_budget_steps_match_jax(kind):
    """Training-time sample budgets: JAX's step and the port's with the same
    budget, state and draws."""
    ro, rd, rgb = _toy_rays(n=64 if kind == "fused" else 512, seed=4)
    key = jax.random.PRNGKey(5)
    if kind == "eager":
        j_cfg = JNerfConfig(compute_dtype=jnp.float32, **SMALL)
        j_tc = jt.NerfTrainConfig(train_fine_budget=12, **TCFG)
        t_tc = tt.NerfTrainConfig(train_fine_budget=12, **TCFG)
        cm, fm, j_state = jt.init_state(jax.random.PRNGKey(0), j_cfg, j_tc)
        state = _port_state(j_state, NerfConfig(compute_dtype=torch.float32, **SMALL), t_tc)
        j_step, step = jt.make_train_step(cm, fm, j_tc), tt.make_train_step(t_tc, device="cpu")
        for s in range(3):
            draws = _jax_draws(key, s, ro.shape[0], t_tc)
            assert draws.noise_fine.shape == (TCFG["batch_size"], 12)
            j_state, jm = j_step(j_state, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rgb),
                                 key)
            state, m = step(state, torch.from_numpy(ro), torch.from_numpy(rd),
                            torch.from_numpy(rgb), draws=draws)
            for k in ("loss", "loss_coarse", "loss_fine"):
                close(m[k], np.asarray(jm[k]), atol=1e-5 * max(1.0, abs(float(jm[k]))))
        _assert_state_close(state, j_state, TOL_STATE[1], t_tc.lrate)
        return

    import tgtc.ops.pallas.nerf_mlp_grad as g

    kw = dict(batch_size=8, n_samples=16, n_samples_fine=16, sigma_noise_std=1.0,
              train_fine_budget=16)
    j_tc, t_tc = jt.NerfTrainConfig(**kw), tt.NerfTrainConfig(**kw)
    _, _, j_state = jt.init_state(jax.random.PRNGKey(0), JNerfConfig(), j_tc)
    state = _port_state(j_state, NerfConfig(), t_tc)
    orig = g.make_diff_apply
    try:
        g.make_diff_apply = lambda *a, **k: orig(*a, **{**k, "interpret": True})
        j_step = jt.make_fused_train_step(JNerfConfig(), j_tc, tile=128)
    finally:
        g.make_diff_apply = orig
    j_state, jm = j_step(j_state, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rgb), key)
    m, grads = tt.make_fused_train_step(NerfConfig(), t_tc, device="cpu").loss_and_grad(
        state.coarse, state.fine, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(rgb), _jax_draws(key, 0, ro.shape[0], t_tc))
    close(m["loss"], np.asarray(jm["loss"]), atol=2e-2)
    adam = j_state.opt_state[0]
    names = ([("coarse", n) for n, _ in state.coarse.named_parameters()]
             + [("fine", n) for n, _ in state.fine.named_parameters()])
    mu = {w: nerf_state_dict_from_flax(jax.tree.map(np.asarray, adam.mu[w]))
          for w in ("coarse", "fine")}
    worst = 1.0
    for (which, name), got in zip(names, grads):
        want, got = mu[which][name].double() / 0.1, got.double()
        cos = float((got * want).sum() / (got.norm() * want.norm() + 1e-30))
        worst = min(worst, cos)
        assert cos >= 0.99, (which, name, cos)
    print(f"[parity] fused step with budget 16 vs JAX: loss {float(m['loss']):.6f} vs "
          f"{float(jm['loss']):.6f}, min grad cos {worst:.6f}")
