"""Phase C1 on the CPU: the port's StyTrans losses, C1 trainer, crop
prefetcher and CLI against tgtc's, on the same numpy-seeded uint8 batches
and the same weights (converted by ``tgtc_torch.convert``).

Narrow network: d_model 32, 2 heads, 1+1 layers, FFN 64, the truncated VGG
at full channel widths; batch 2 of 32x32 crops; dropout 0 wherever values
are compared (JAX's random streams cannot be reproduced; dropout is held by
its statistics and by repeating bit for bit).

* ``compute_losses``: every loss to 1e-5 relative, f32 "xla" against
  JAX's "xla", and the flash path (K6/K7/K8's twins) against JAX's flash
  (Pallas, interpret mode).
* Three train steps, each from JAX's state before it converted bit for bit
  (``transformer_train_state_from_jax``), so that both sides take every
  step from identical parameters, moments and batch: losses 1e-5 relative;
  every trained leaf, its scale floored at the learning rate, to 1e-5 of
  JAX's and the Adam moments to 5e-5, as the Phase-A test does
  (tests/test_torch_train.py); only ``transformer`` and ``embedding`` move
  (tests/test_trainers_2d.py:52-81). The loss is not smooth at f32 scale:
  the random VGG's 2x2 max-pools hold windows whose two largest inputs lie
  within f32 rounding of each other (at the first step's inputs, 1-3 such
  windows a pool within 1e-6 of the tensor's max, on both sides), and which
  framework's rounding crosses which of them depends on the host. A
  crossing reroutes a pixel's gradient: on one x86 host the port and JAX
  pick different maxima in 3 windows of the gradient-carrying pools at the
  first step, and their gradients differ by 3.3e-3 of a leaf's max (4.4e-6
  at the second step's inputs, where none differ); Adam's first update,
  lr * sign(g), turns each gradient element that changes sign into a move
  of 2 lr. JAX crosses the same ties against itself: so each step's
  tolerance is the larger of the tight one and JAX's own spread on the same
  host (``jax_witness``): the largest distance between JAX's states after
  the same step from the same state with every attention's key bias moved
  by one of ``KEY_BIAS_BUMPS`` (a constant added to a row of logits leaves
  its softmax, and so the loss, unchanged; the rounding moves). The key
  bias of every attention (``in_proj_bias[d:2d]``) has an analytically zero
  gradient, so Adam normalizes f32 summation noise (|m| ~ 1e-10) into steps
  of up to the learning rate, in JAX and the port alike: there each must
  stay within one learning rate of the step's start, and JAX's spread leaves
  it out. ``test_jax_gradient_moves_between_the_two_trajectories`` holds the
  gradients at the same states the same way and caps JAX's spread.
* A JAX state after two steps converts exactly (parameters and moments bit
  for bit, the update count and the learning rate); one more step then
  matches JAX's loss to 1e-5, its parameters to 1e-3 (measured 1.5e-4) and
  its moments to 3e-2. The two sides start from the same parameters there,
  so only their rounding differences, through the ties above, move them.
* uint8 batches give bitwise the losses of their f32 division by 255.
* ``lr_schedule`` against JAX's on both sides of 10,000 updates.
* ``CropBatchPrefetcher`` batches equal JAX's bit for bit.
* ``tools.train2d.main(["--task", "transformer", ...], device="cpu")`` runs,
  writes its collage and checkpoint, and resumes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tgtc.data.prefetch import CropBatchPrefetcher as JPrefetcher
from tgtc.models.stytrans import StyTrans as JStyTrans
from tgtc.models.transformer import TransformerConfig as JConfig
from tgtc.models.vgg import VggEncoder as JVgg
from tgtc.train import transformer2d as jt
from tgtc_torch.convert import stytrans_model_state_from_flax, transformer_train_state_from_jax
from tgtc_torch.data.prefetch import CropBatchPrefetcher
from tgtc_torch.models.stytrans import make_stytrans
from tgtc_torch.models.transformer import TransformerConfig, dropout
from tgtc_torch.tools import train2d
from tgtc_torch.train import transformer2d as t2
from test_torch_ops import close
from test_torch_stytrans import NARROW, jax_params

torch.set_num_threads(1)

TOL_LOSS, TOL_PARAM, TOL_MOMENT = 1e-5, 1e-5, 5e-5        # a step from identical inputs
TOL_TIE_SHIFT = 1e-2    # the most JAX's own gradient may move across ties (see jax_witness)
KEY_BIAS_BUMPS = (1e-6, 1e-5, 3e-5, 1e-4, 4e-4)           # analytically null changes
TOL_CONVERTED_PARAM, TOL_CONVERTED_MOMENT = 1e-3, 3e-2    # one step from a converted state
TRAIN = ("transformer", "embedding")


def _batches(seed=0, n=2, size=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8) for _ in range(2))


@pytest.fixture(scope="module")
def params():
    """A narrow flax StyTrans tree with a truncated full-width VGG, biases
    moved off 0."""
    tree = jax_params()["params"]
    vgg = jax.tree.map(np.asarray, JVgg().init(jax.random.PRNGKey(1),
                                               jnp.zeros((1, 16, 16, 3)))["params"])
    rng = np.random.default_rng(2)
    for leaf in vgg.values():
        leaf["bias"] = leaf["bias"] + np.float32(0.05) * rng.standard_normal(
            leaf["bias"].shape, np.float32)
    return {"params": {**tree, "vgg": vgg}}


def _copy(tree):
    return jax.tree.map(lambda x: jnp.array(np.array(x)), tree)


def _port(params, attn_impl="xla", dtype=torch.float32, dropout_rate=0.0):
    model = make_stytrans(TransformerConfig(dropout=dropout_rate, attn_impl=attn_impl,
                                            dtype=dtype, **NARROW),
                          torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(stytrans_model_state_from_flax(params))
    return model


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-12)


def _adam(j_state):
    return j_state.opt_state.inner_states["train"].inner_state[0]


def _trained(tree):
    """The ``train`` subtrees of a flax tree (masked nodes dropped)."""
    return {"params": {k: tree["params"][k] for k in TRAIN}}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_compute_losses_match_jax(params, attn_impl):
    c8, s8 = _batches()
    c, s = (x.astype(np.float32) / 255.0 for x in (c8, s8))
    jm = JStyTrans(JConfig(dropout=0.0, attn_impl=attn_impl, **NARROW))
    want = jax.jit(lambda p, c, s: jm.apply(p, c, s, True, method=jm.compute_losses))(
        params, jnp.asarray(c), jnp.asarray(s))
    got = _port(params, attn_impl).compute_losses(torch.from_numpy(c), torch.from_numpy(s))
    for k in ("loss_c", "loss_s", "l_id1", "l_id2"):
        close(_rel(got[k], want[k]), 0.0, TOL_LOSS)
    close(got["ics"], np.asarray(want["ics"]), 1e-5)


def _numpy_state(state):
    """A JAX C1 state as the numpy arguments of
    ``transformer_train_state_from_jax``."""
    adam = _adam(state)
    return (int(state.step), jax.tree.map(np.array, state.params), int(adam.count),
            jax.tree.map(np.array, _trained(adam.mu)), jax.tree.map(np.array, _trained(adam.nu)))


def _bump_key_biases(params, delta):
    """``params`` with every attention's key bias moved by ``delta``: the
    same loss in exact arithmetic, other f32 rounding."""
    bumped = _copy(params)
    for sub in bumped["params"]["transformer"].values():
        for attn in sub.values():
            if isinstance(attn, dict) and "k_proj" in attn:
                attn["k_proj"]["bias"] = attn["k_proj"]["bias"] + np.float32(delta)
    return bumped


@pytest.fixture(scope="module")
def jax_run(params):
    """JAX's C1 step, three times from ``params`` on the same batches: per
    step the JAX state before it, that state as numpy, the step's metrics
    and the numpy state after it."""
    tcfg = jt.TransformerTrainConfig()
    model = JStyTrans(JConfig(dropout=0.0, **NARROW))
    step = jt.make_transformer_train_step(model, tcfg)
    state = jt.init_transformer_train(_copy(params), tcfg)
    c8, s8 = _batches()
    out = []
    for _ in range(3):
        before = _copy(state)  # the step donates its state
        state, m = step(state, jnp.asarray(c8), jnp.asarray(s8), jax.random.PRNGKey(3))
        out.append((before, _numpy_state(before), {k: float(v) for k, v in m.items()},
                    _numpy_state(state)))
    return out


def _flat_state(params, mu, nu):
    """The trained leaves, key-bias slices left out of the parameters, and
    their Adam moments as port-named flat dicts."""
    flat = stytrans_model_state_from_flax(params)
    return ({n: _key_bias(n, v)[0] for n, v in flat.items() if n.split(".")[0] in TRAIN},
            stytrans_model_state_from_flax(mu), stytrans_model_state_from_flax(nu))


def _state_dist(a, b, lr):
    """Per kind, the largest ``_leaf_rel`` over trained leaves between two
    ``_flat_state`` triples (parameters floored at the learning rate)."""
    return {kind: max(_leaf_rel(x[n], y[n], floor) for n in y)
            for kind, x, y, floor in zip(("param", "mu", "nu"), a, b, (lr, 1e-30, 1e-30))}


@pytest.fixture(scope="module")
def jax_witness(jax_run):
    """JAX's own spread at each of ``jax_run``'s steps: the largest
    ``_state_dist`` between any two of JAX's states after the step taken
    from the state before it as it is and with its key biases moved by each
    of ``KEY_BIAS_BUMPS``."""
    tcfg = jt.TransformerTrainConfig()
    step = jt.make_transformer_train_step(JStyTrans(JConfig(dropout=0.0, **NARROW)), tcfg)
    c8, s8 = _batches()
    spread = []
    for s, (before, _, _, after) in enumerate(jax_run):
        runs = [_flat_state(after[1], after[3], after[4])]
        for delta in KEY_BIAS_BUMPS:
            bumped = _copy(before).replace(params=_bump_key_biases(before.params, delta))
            state, _ = step(bumped, jnp.asarray(c8), jnp.asarray(s8), jax.random.PRNGKey(3))
            _, p, _, mu, nu = _numpy_state(state)
            runs.append(_flat_state(p, mu, nu))
        lr = float(jt.lr_schedule(tcfg)(s))
        worst = {"param": 0.0, "mu": 0.0, "nu": 0.0}
        for i in range(len(runs)):
            for j in range(i):
                for kind, v in _state_dist(runs[i], runs[j], lr).items():
                    worst[kind] = max(worst[kind], v)
        print(f"[parity] C1 step {s + 1}: JAX's own spread over {len(KEY_BIAS_BUMPS)} key-bias "
              f"bumps: param {worst['param']:.3e}, mu {worst['mu']:.3e}, nu {worst['nu']:.3e}")
        spread.append(worst)
    return spread


def _leaf_rel(got, want, floor=1e-30):
    got, want = got.detach().double(), want.double()
    return float((got - want).abs().max() / max(float(want.abs().max()), floor))


def _key_bias(name, x, d=NARROW["d_model"]):
    """``x`` without its key-bias slice if ``name`` is an in_proj_bias (see
    the module docstring), and that slice (or None)."""
    if not name.endswith("in_proj_bias"):
        return x, None
    return torch.cat([x[:d], x[2 * d:]]), x[d: 2 * d]


def _assert_state_close(state, j_params, j_mu, j_nu, tol_param, tol_mu, tol_nu, lr, start,
                        steps):
    """Every trained leaf (its scale floored at the learning rate) and its
    Adam moments, relative to JAX's max per leaf; the frozen leaves equal;
    each key-bias slice, JAX's and the port's, within ``steps`` learning
    rates of ``start``."""
    want = stytrans_model_state_from_flax(j_params)
    mu, nu = stytrans_model_state_from_flax(j_mu), stytrans_model_state_from_flax(j_nu)
    opt = state.optimizer.state
    worst = {"param": 0.0, "mu": 0.0, "nu": 0.0}
    for name, p in state.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, want[name]), name
            continue
        got_p, got_k = _key_bias(name, p.detach())
        want_p, want_k = _key_bias(name, want[name])
        if got_k is not None:
            _, start_k = _key_bias(name, start[name])
            for k in (got_k, want_k):
                assert float((k - start_k).abs().max()) <= steps * lr * (1 + 1e-3), name
        for kind, got, ref, tol, floor in (
                ("param", got_p, want_p, tol_param, lr),
                ("mu", opt[p]["exp_avg"], mu[name], tol_mu, 1e-30),
                ("nu", opt[p]["exp_avg_sq"], nu[name], tol_nu, 1e-30)):
            rel = _leaf_rel(got, ref, floor)
            worst[kind] = max(worst[kind], rel)
            assert rel <= tol, (kind, name, rel)
    print(f"[parity] C1 train state vs JAX: max rel param {worst['param']:.3e} (tol "
          f"{tol_param:.3g}), mu {worst['mu']:.3e} (tol {tol_mu:.3g}), nu {worst['nu']:.3e} "
          f"(tol {tol_nu:.3g})")


def test_three_steps_match_jax(jax_run, jax_witness):
    tcfg = t2.TransformerTrainConfig()
    c8, s8 = (torch.from_numpy(x) for x in _batches())
    for s, ((_, before, jm, (_, jp, _, jmu, jnu)), spread) in enumerate(zip(jax_run,
                                                                           jax_witness)):
        state = transformer_train_state_from_jax(
            *before, TransformerConfig(dropout=0.0, **NARROW), tcfg, device="cpu")
        start = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, m = t2.make_transformer_train_step(state.model, tcfg)(state, c8, s8)
        for k in ("loss", "loss_c", "loss_s", "l_id1", "l_id2"):
            close(_rel(m[k], jm[k]), 0.0, TOL_LOSS)
        tols = (max(TOL_PARAM, spread["param"]), max(TOL_MOMENT, spread["mu"]),
                max(TOL_MOMENT, spread["nu"]))
        _assert_state_close(state, jp, jmu, jnu, *tols, t2.lr_schedule(tcfg)(s), start, 1)
        assert state.step == s + 1 and state.scheduler.last_epoch == s + 1


def test_only_transformer_and_embedding_update(params):
    tcfg = t2.TransformerTrainConfig()
    model = _port(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = t2.init_transformer_train(model, tcfg)
    assert {n.split(".")[0] for n, _ in t2.trained_parameters(model)} == set(TRAIN)
    state, m = t2.make_transformer_train_step(model, tcfg)(
        state, *(torch.from_numpy(x) for x in _batches(1)))
    assert np.isfinite(float(m["loss"]))
    after = model.state_dict()
    for prefix, moves in (("vgg.", False), ("decode.", False), ("transformer.", True),
                          ("embedding.", True)):
        keys = [k for k in after if k.startswith(prefix)]
        changed = [not torch.equal(after[k], before[k]) for k in keys]
        assert (any(changed) if moves else not any(changed)), prefix
        assert all(p.grad is None for n, p in model.named_parameters() if n.startswith(prefix))


def test_converted_jax_state_resumes_like_jax(params):
    tcfg = jt.TransformerTrainConfig()
    model = JStyTrans(JConfig(dropout=0.0, **NARROW))
    step = jt.make_transformer_train_step(model, tcfg)
    state = jt.init_transformer_train(_copy(params), tcfg)
    c8, s8 = _batches(2)
    for _ in range(2):
        state, _ = step(state, jnp.asarray(c8), jnp.asarray(s8), jax.random.PRNGKey(3))
    adam = _adam(state)
    start = stytrans_model_state_from_flax(jax.tree.map(np.array, state.params))
    port = transformer_train_state_from_jax(
        int(state.step), jax.tree.map(np.array, state.params), int(adam.count),
        jax.tree.map(np.array, _trained(adam.mu)), jax.tree.map(np.array, _trained(adam.nu)),
        TransformerConfig(dropout=0.0, **NARROW), t2.TransformerTrainConfig(), device="cpu")
    assert port.step == 2 and port.scheduler.last_epoch == 2
    assert port.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jt.lr_schedule(tcfg)(2)), rel=1e-6)
    _assert_state_close(port, jax.tree.map(np.array, state.params),
                        jax.tree.map(np.array, _trained(adam.mu)),
                        jax.tree.map(np.array, _trained(adam.nu)), 0.0, 0.0, 0.0, 1e-30, start,
                        0)
    assert all(int(v["step"]) == 2 for v in port.optimizer.state.values())
    state, jm = step(state, jnp.asarray(c8), jnp.asarray(s8), jax.random.PRNGKey(3))
    port, m = t2.make_transformer_train_step(port.model, t2.TransformerTrainConfig())(
        port, torch.from_numpy(c8), torch.from_numpy(s8))
    close(_rel(m["loss"], jm["loss"]), 0.0, TOL_LOSS)
    adam = _adam(state)
    _assert_state_close(port, jax.tree.map(np.array, state.params),
                        jax.tree.map(np.array, _trained(adam.mu)),
                        jax.tree.map(np.array, _trained(adam.nu)), TOL_CONVERTED_PARAM,
                        TOL_CONVERTED_MOMENT, TOL_CONVERTED_MOMENT,
                        float(jt.lr_schedule(tcfg)(2)), start, 1)


def test_uint8_batches_equal_f32_batches_bitwise(params):
    tcfg = t2.TransformerTrainConfig()
    model = _port(params)
    t2.init_transformer_train(model, tcfg)
    step = t2.make_transformer_train_step(model, tcfg)
    c8, s8 = (torch.from_numpy(x) for x in _batches(3))
    m8, g8 = step.loss_and_grad(model, c8, s8, None)
    mf, gf = step.loss_and_grad(model, c8.float() / 255.0, s8.float() / 255.0, None)
    assert all(torch.equal(m8[k], mf[k]) for k in m8)
    assert all(torch.equal(a, b) for a, b in zip(g8, gf))


@pytest.mark.parametrize("n", [0, 1, 100, 9999, 10000, 10001, 20000])
def test_lr_schedule_matches_jax(n):
    cfg = t2.TransformerTrainConfig()
    want = float(jt.lr_schedule(jt.TransformerTrainConfig())(jnp.asarray(n, jnp.int32)))
    close(_rel(t2.lr_schedule(cfg)(n), want), 0.0, 1e-6)


def _write_images(d, n, size, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size + 7, 3), np.uint8)).save(
            os.path.join(d, f"img_{i:03d}.png"))
    return sorted(os.path.join(d, f) for f in os.listdir(d))


def test_prefetcher_batches_equal_jax_bitwise(tmp_path):
    paths = _write_images(str(tmp_path / "imgs"), 5, 60, 4)
    kw = dict(paths=paths, batch=3, patch=16, resize=48, seed=11, workers=2)
    with CropBatchPrefetcher(**kw) as ours, JPrefetcher(**kw) as theirs:
        for _ in range(4):
            a, b = ours.next(), theirs.next()
            assert a.dtype == np.uint8 and a.shape == (3, 16, 16, 3)
            assert np.array_equal(a, b)


def test_dropout_keeps_about_keep_and_repeats(params):
    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.9) < 5e-3 and torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
    assert torch.equal(dropout(x, 0.0), x)
    # a step at dropout 0.1 (flash path: the twins' hash mask; the residual
    # and FFN masks from the generator) repeats bit for bit from one seed
    tcfg = t2.TransformerTrainConfig()
    c8, s8 = (torch.from_numpy(x) for x in _batches(4))
    out = []
    for seed in (5, 5, 6):
        model = _port(params, "flash", dropout_rate=0.1)
        t2.init_transformer_train(model, tcfg)
        step = t2.make_transformer_train_step(model, tcfg)
        out.append(step.loss_and_grad(model, c8, s8, step.generator(seed, 0)))
    (ma, ga), (mb, gb), (mc, gc) = out
    assert torch.equal(ma["loss"], mb["loss"]) and all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert not torch.equal(ma["loss"], mc["loss"])


def test_transformer_xla_dropout_rates():
    """The "xla" path's attention-probs dropout: f32 keeps 1 - rate, the
    bf16 branch 1 - round(256 rate) / 256 (uint8 draws)."""
    from tgtc_torch.models.transformer import MultiHeadAttention

    for dtype, keep in ((torch.float32, 0.9), (torch.bfloat16, 1 - 26 / 256)):
        mha = MultiHeadAttention(16, 2, dtype, "xla", dropout=0.1)
        qh = torch.zeros(4, 2, 64, 8, dtype=dtype)
        vh = torch.ones(4, 2, 64, 8, dtype=dtype)
        out = mha._eager(qh, qh, vh, 0.1, torch.Generator().manual_seed(1))
        # uniform probabilities 1/64: each output is (kept share) / keep
        got = float(out.float().mean()) * keep
        assert abs(got - keep) < 1e-2, (dtype, got, keep)


def test_train2d_transformer_task_runs_and_resumes(tmp_path):
    for d, s in (("gen", 1), ("style", 2)):
        _write_images(str(tmp_path / d), 3, 40, s)
    Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(tmp_path / "gen" / "depth_000.png")
    argv = ["--task", "transformer", "--nerf_content_dir", str(tmp_path / "gen"),
            "--style_dir", str(tmp_path / "style"), "--save_dir", str(tmp_path / "save"),
            "--log_dir", str(tmp_path / "log"), "--max_iter", "2", "--batch_size", "2",
            "--patch", "16", "--print_interval", "1", "--save_model_interval", "1",
            "--n_threads", "2", "--hidden_dim", "32", "--vgg", "", "--decoder", ""]
    assert train2d.main(argv, device="cpu") == 0
    assert sorted(os.listdir(tmp_path / "save" / "transformer")) == [
        "ckpt_00000001.pt", "ckpt_00000002.pt"]
    assert (tmp_path / "log" / "2.png").exists()
    assert Image.open(tmp_path / "log" / "2.png").size == (2 * 16, 3 * 16)
    # resumes at step 2; a third call at the same max_iter trains nothing
    argv[argv.index("--max_iter") + 1] = "3"
    assert train2d.main(argv, device="cpu") == 0
    assert train2d.main(argv, device="cpu") == 0
    lines = (tmp_path / "log" / "transformer.jsonl").read_text().splitlines()
    assert [eval(line.replace("NaN", "0"))["step"] for line in lines] == [1, 2, 3]
    assert (tmp_path / "save" / "transformer" / "ckpt_00000003.pt").exists()


def test_parser_and_per_task_defaults():
    ns = train2d.build_parser().parse_args(["--task", "transformer"])
    train2d._resolve_task_defaults(ns)
    assert (ns.lr, ns.max_iter, ns.style_weight, ns.content_weight,
            ns.save_model_interval) == (5e-4, 5000, 10.0, 7.0, 1000)
    ns = train2d.build_parser().parse_args(["--task", "vae", "--lr", "5e-4"])
    train2d._resolve_task_defaults(ns)
    assert ns.lr == 5e-4 and ns.max_iter == 160000


@pytest.mark.parametrize("task", ["finetune_decoder", "temporal_decoder"])
def test_unported_tasks_raise(task):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train2d.main(["--task", task], device="cpu")


@jax.jit
def _jax_value_and_grad(train, frozen, c8, s8):
    tcfg = jt.TransformerTrainConfig()
    jm = JStyTrans(JConfig(dropout=0.0, **NARROW))
    c, s = (x.astype(jnp.float32) / 255.0 for x in (c8, s8))

    def loss_fn(tp):
        out = jm.apply({"params": {**frozen, **tp}}, c, s, True, method=jm.compute_losses)
        return (tcfg.content_weight * out["loss_c"] + tcfg.style_weight * out["loss_s"]
                + tcfg.id1_weight * out["l_id1"] + tcfg.id2_weight * out["l_id2"])

    return jax.value_and_grad(loss_fn)(train)


def _jax_loss_and_grad(params, c8, s8):
    """JAX's C1 loss and its gradient over the ``train`` subtrees, as the
    port's named trained leaves."""
    p = params["params"]
    loss, grad = _jax_value_and_grad({k: p[k] for k in TRAIN},
                                     {k: v for k, v in p.items() if k not in TRAIN},
                                     jnp.asarray(c8), jnp.asarray(s8))
    tree = {"params": {**jax.tree.map(np.array, p), **jax.tree.map(np.array, grad)}}
    flat = stytrans_model_state_from_flax(tree)
    return float(loss), {k: v for k, v in flat.items() if k.split(".")[0] in TRAIN}


def _grad_shift(g2, g1):
    """The largest ``max|g2 - g1| / max|g1|`` over leaves, key-bias slices
    left out (their gradient is zero in exact arithmetic)."""
    return max(_leaf_rel(_key_bias(n, g2[n])[0], _key_bias(n, g1[n])[0]) for n in g1)


def test_a_key_bias_change_keeps_the_loss(params):
    """Moving every attention's key bias by 5e-5 leaves the loss unchanged (a
    constant added to a row of logits leaves its softmax unchanged), in the
    port and in JAX. The gradients' shifts are printed side by side: each
    side moves by ~1e-6 of a leaf's max, or by ~3e-3 where its rounding
    crosses one of the max-pool ties of the module docstring, which is
    chance (``jax_witness`` collects JAX's crossings)."""
    model = _port(params)
    t2.init_transformer_train(model, t2.TransformerTrainConfig())
    step = t2.make_transformer_train_step(model, t2.TransformerTrainConfig())
    c8, s8 = _batches()
    names = [n for n, _ in t2.trained_parameters(model)]
    bumped = _bump_key_biases(params, 5e-5)
    shifts = {}
    for side, tree in (("port", params), ("port", bumped), ("jax", params), ("jax", bumped)):
        if side == "port":
            model.load_state_dict(stytrans_model_state_from_flax(tree))
            m, g = step.loss_and_grad(model, torch.from_numpy(c8), torch.from_numpy(s8), None)
            loss, grad = float(m["loss"]), dict(zip(names, g))
        else:
            loss, grad = _jax_loss_and_grad(tree, c8, s8)
        shifts.setdefault(side, []).append((loss, grad))
    moved = {}
    for side, ((l1, g1), (l2, g2)) in shifts.items():
        close(_rel(l2, l1), 0.0, TOL_LOSS)
        moved[side] = _grad_shift(g2, g1)
    print(f"[parity] C1 gradient moved by a key-bias change: port {moved['port']:.3e}, JAX "
          f"{moved['jax']:.3e} of a leaf's max")


def test_jax_gradient_moves_between_the_two_trajectories(jax_run):
    """The witness for the tolerances of ``test_three_steps_match_jax``, on
    gradients: at JAX's states before steps 1 and 2, JAX's gradient as it is
    and with every key bias moved by each of ``KEY_BIAS_BUMPS`` (the same
    loss in exact arithmetic: two trajectories of JAX's rounding). The ties
    of the module docstring move JAX by at most ``TOL_TIE_SHIFT`` of a
    leaf's max (3.3e-3 at the first step on an x86 host, and 1.5e-6 where
    no bump crosses one), and the port's gradient at the same state must lie
    within the larger of 5e-5 and JAX's own spread of JAX's."""
    tcfg = t2.TransformerTrainConfig()
    c8, s8 = _batches()
    for s, (_, before, _, _) in enumerate(jax_run[:2]):
        state = transformer_train_state_from_jax(
            *before, TransformerConfig(dropout=0.0, **NARROW), tcfg, device="cpu")
        step = t2.make_transformer_train_step(state.model, tcfg)
        names = [n for n, _ in t2.trained_parameters(state.model)]
        _, g = step.loss_and_grad(state.model, torch.from_numpy(c8), torch.from_numpy(s8), None)
        jax_grads = [_jax_loss_and_grad(_bump_key_biases(before[1], d), c8, s8)[1]
                     for d in (0.0,) + KEY_BIAS_BUMPS]
        spread = max(_grad_shift(a, b) for i, a in enumerate(jax_grads) for b in jax_grads[:i])
        port = _grad_shift(dict(zip(names, g)), jax_grads[0])
        print(f"[parity] C1 gradient before step {s + 1}: JAX's own spread over "
              f"{len(KEY_BIAS_BUMPS)} key-bias bumps {spread:.3e}; the port vs JAX {port:.3e} "
              f"(of a leaf's max)")
        assert spread <= TOL_TIE_SHIFT
        assert port <= max(TOL_MOMENT, spread)


def _pool_windows(x):
    """The 2x2 windows of an NHWC pool input (even rows and columns) as
    rows of four values."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 5, 2, 4).reshape(-1, 4)


def test_vgg_max_pool_flips_are_near_ties(params, monkeypatch):
    """The mechanism of the module docstring, measured on both sides: the
    inputs of every VGG max-pool of ``compute_losses`` (five VGG calls,
    three pools each), recorded from the port and from JAX's jitted call at
    the same parameters and batch. They agree to f32 noise (1e-5 of the
    tensor's max), and wherever the two pick different maxima of a window
    (exact ties aside) its two largest inputs lie within that noise of each
    other on both sides. The windows whose top two lie within 16 ulps, and
    the windows picked differently, are printed per pool."""
    import tgtc.models.vgg as jvgg
    import tgtc_torch.models.vgg as tvgg

    seen = {"port": [], "jax": {}}
    port_pool, jax_pool = tvgg._ceil_pool_nchw, jvgg.ceil_max_pool

    def port_record(x):
        seen["port"].append(x.detach().permute(0, 2, 3, 1).numpy().copy())
        return port_pool(x)

    calls = [0]

    def jax_record(x):
        i = calls[0]
        calls[0] += 1
        jax.debug.callback(lambda v, i=i: seen["jax"].__setitem__(i, np.asarray(v).copy()), x)
        return jax_pool(x)

    monkeypatch.setattr(tvgg, "_ceil_pool_nchw", port_record)
    monkeypatch.setattr(jvgg, "ceil_max_pool", jax_record)
    c, s = (x.astype(np.float32) / 255.0 for x in _batches())
    jm = JStyTrans(JConfig(dropout=0.0, **NARROW))
    jax.block_until_ready(jax.jit(lambda p, c, s: jm.apply(p, c, s, True, method=jm.compute_losses))(
        params, jnp.asarray(c), jnp.asarray(s)))
    with torch.no_grad():
        _port(params).compute_losses(torch.from_numpy(c), torch.from_numpy(s))
    assert len(seen["port"]) == len(seen["jax"]) == 15
    report = []
    for i, a in enumerate(seen["port"]):
        b = seen["jax"][i]
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= 1e-5 * scale, i
        wa, wb = _pool_windows(a), _pool_windows(b)
        sa, sb = np.sort(wa, axis=1), np.sort(wb, axis=1)
        gap_a, gap_b = sa[:, 3] - sa[:, 2], sb[:, 3] - sb[:, 2]
        near = [int(((g > 0) & (g <= 16 * np.spacing(np.abs(t)))).sum())
                for g, t in ((gap_a, sa[:, 3]), (gap_b, sb[:, 3]))]
        flipped = (np.argmax(wa, 1) != np.argmax(wb, 1)) & ~((gap_a == 0) & (gap_b == 0))
        assert np.all(gap_a[flipped] <= 1e-5 * scale) and np.all(gap_b[flipped] <= 1e-5 * scale), i
        report.append(f"{i}: {near[0]}/{near[1]}/{int(flipped.sum())}")
    print("[parity] C1 VGG max-pools, windows with the top two within 16 ulps port/JAX and windows "
          "picked differently, per pool: " + ", ".join(report))
