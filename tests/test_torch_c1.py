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
* Three train steps from the same params and batches: losses 1e-5
  relative at every step; after the first, every trained leaf, its scale
  floored at the learning rate, to 1e-5 of JAX's and the Adam moments to
  5e-5, as the Phase-A test does (tests/test_torch_train.py); only
  ``transformer`` and ``embedding`` move (tests/test_trainers_2d.py:52-81).
  After that the two sides hold parameters that differ by f32 noise, and
  the gradient is not smooth at that scale. The random VGG's deepest
  channels are near constant (spatial variance ~1e-7 at ~0.02), so two
  entries of a 2x2 max-pool window can lie within f32 rounding of each
  other; an f32 change of the input can swap the window's argmax, and
  ``mean_variance_norm`` (its ``sqrt(var + 1e-5)`` near ``sqrt(1e-5)`` in
  those channels) weighs the rerouted gradient heavily. One such swap, in
  the pool after relu3_4, moves loss_c's input gradient by 3.3e-2 and the
  trained leaves' by 2.6e-3 of their max. JAX crosses such ties too: its
  own gradient at the port's parameters differs from its gradient at its
  own by up to 5.4e-3 of a leaf's max
  (``test_jax_gradient_moves_between_the_two_trajectories``, which holds
  the later-step moment tolerance within 10x of that). Larger (64x64),
  smoother or He-scaled inputs did not avoid the ties (they broke the
  first step's 1e-5 as well). So after steps 2 and 3 the parameters are
  held to 1e-4 (measured 1.6e-5) and the moments to 1e-2 (measured
  2.2e-3). The key bias of every
  attention (``in_proj_bias[d:2d]``) has an analytically zero gradient (a
  constant added to a row of logits leaves its softmax unchanged), so Adam
  normalizes f32 summation noise (|m| ~ 1e-10) into steps of up to the
  learning rate, in JAX and the port alike: there each must stay within one
  learning rate per step of the start.
* A JAX state after two steps converts exactly (parameters and moments bit
  for bit, the update count and the learning rate); one more step then
  matches JAX's loss to 1e-5, its parameters to 1e-3 (measured 1.5e-4) and
  its moments to 3e-2 (measured 9.8e-3). The two sides start from the same
  parameters there, so their rounding differences alone move the moments
  that far, as they move the gradients at the same parameters before step
  2 above by 1.2e-3.
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
from tgtc_torch.convert import (stytrans_flax_from_state_dicts, stytrans_model_state_from_flax,
                                transformer_train_state_from_jax)
from tgtc_torch.data.prefetch import CropBatchPrefetcher
from tgtc_torch.models.stytrans import make_stytrans
from tgtc_torch.models.transformer import TransformerConfig, dropout
from tgtc_torch.tools import train2d
from tgtc_torch.train import transformer2d as t2
from test_torch_ops import close
from test_torch_stytrans import NARROW, jax_params

torch.set_num_threads(1)

TOL_LOSS, TOL_PARAM, TOL_MOMENT = 1e-5, 1e-5, 5e-5        # the first step
TOL_LATER_PARAM, TOL_LATER_MOMENT = 1e-4, 1e-2            # steps 2 and 3
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


@pytest.fixture(scope="module")
def jax_run(params):
    """JAX's C1 step, three times from ``params`` on the same batches:
    (metrics, params, mu, nu) after each step, as numpy."""
    tcfg = jt.TransformerTrainConfig()
    model = JStyTrans(JConfig(dropout=0.0, **NARROW))
    step = jt.make_transformer_train_step(model, tcfg)
    state = jt.init_transformer_train(_copy(params), tcfg)
    c8, s8 = _batches()
    out = []
    for _ in range(3):
        state, m = step(state, jnp.asarray(c8), jnp.asarray(s8), jax.random.PRNGKey(3))
        adam = _adam(state)
        out.append(({k: float(v) for k, v in m.items()},
                    jax.tree.map(np.array, state.params),
                    jax.tree.map(np.array, _trained(adam.mu)),
                    jax.tree.map(np.array, _trained(adam.nu))))
    return out


def _leaf_rel(got, want, floor=1e-30):
    got, want = got.detach().double(), want.double()
    return float((got - want).abs().max() / max(float(want.abs().max()), floor))


def _key_bias(name, x, d=NARROW["d_model"]):
    """``x`` without its key-bias slice if ``name`` is an in_proj_bias (see
    the module docstring), and that slice (or None)."""
    if not name.endswith("in_proj_bias"):
        return x, None
    return torch.cat([x[:d], x[2 * d:]]), x[d: 2 * d]


def _assert_state_close(state, j_params, j_mu, j_nu, tol_param, tol_moment, lr, start, steps):
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
                ("mu", opt[p]["exp_avg"], mu[name], tol_moment, 1e-30),
                ("nu", opt[p]["exp_avg_sq"], nu[name], tol_moment, 1e-30)):
            rel = _leaf_rel(got, ref, floor)
            worst[kind] = max(worst[kind], rel)
            assert rel <= tol, (kind, name, rel)
    print(f"[parity] C1 train state vs JAX: max rel param {worst['param']:.3e} (tol "
          f"{tol_param:g}), mu {worst['mu']:.3e}, nu {worst['nu']:.3e} (tol {tol_moment:g})")


def test_three_steps_match_jax(params, jax_run):
    tcfg = t2.TransformerTrainConfig()
    model = _port(params)
    state = t2.init_transformer_train(model, tcfg)
    step = t2.make_transformer_train_step(model, tcfg)
    c8, s8 = (torch.from_numpy(x) for x in _batches())
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for s, (jm, jp, jmu, jnu) in enumerate(jax_run):
        state, m = step(state, c8, s8)
        for k in ("loss", "loss_c", "loss_s", "l_id1", "l_id2"):
            close(_rel(m[k], jm[k]), 0.0, TOL_LOSS)
        lr = t2.lr_schedule(tcfg)(s)
        tols = (TOL_PARAM, TOL_MOMENT) if s == 0 else (TOL_LATER_PARAM, TOL_LATER_MOMENT)
        _assert_state_close(state, jp, jmu, jnu, *tols, lr, start, s + 1)
    assert state.step == 3 and state.scheduler.last_epoch == 3


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
                        jax.tree.map(np.array, _trained(adam.nu)), 0.0, 0.0, 1e-30, start, 0)
    assert all(int(v["step"]) == 2 for v in port.optimizer.state.values())
    state, jm = step(state, jnp.asarray(c8), jnp.asarray(s8), jax.random.PRNGKey(3))
    port, m = t2.make_transformer_train_step(port.model, t2.TransformerTrainConfig())(
        port, torch.from_numpy(c8), torch.from_numpy(s8))
    close(_rel(m["loss"], jm["loss"]), 0.0, TOL_LOSS)
    adam = _adam(state)
    _assert_state_close(port, jax.tree.map(np.array, state.params),
                        jax.tree.map(np.array, _trained(adam.mu)),
                        jax.tree.map(np.array, _trained(adam.nu)), TOL_CONVERTED_PARAM,
                        TOL_CONVERTED_MOMENT, float(jt.lr_schedule(tcfg)(2)), start, 1)


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


@pytest.mark.parametrize("task", ["vae", "finetune_decoder", "temporal_decoder"])
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
    port and in JAX. The gradients' shifts are printed side by side: the
    port's crosses one max-pool tie of the VGG (see the module docstring)
    and moves by ~2.6e-3 of a leaf's max, JAX's crosses none here and moves
    by ~1e-6. Which side crosses a tie under a given f32 change is chance;
    ``test_jax_gradient_moves_between_the_two_trajectories`` shows JAX
    crossing one."""
    model = _port(params)
    t2.init_transformer_train(model, t2.TransformerTrainConfig())
    step = t2.make_transformer_train_step(model, t2.TransformerTrainConfig())
    c8, s8 = _batches()
    names = [n for n, _ in t2.trained_parameters(model)]
    bumped = _copy(params)
    for sub in bumped["params"]["transformer"].values():
        for attn in sub.values():
            if isinstance(attn, dict) and "k_proj" in attn:
                attn["k_proj"]["bias"] = attn["k_proj"]["bias"] + 5e-5
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


def _flax_of(model):
    """The port's StyTrans parameters as a numpy flax tree."""
    sds = {}
    for k, v in model.state_dict().items():
        part, rest = k.split(".", 1)
        sds.setdefault({"decode": "decoder"}.get(part, part), {})[rest] = v.detach()
    return stytrans_flax_from_state_dicts(sds)


def test_jax_gradient_moves_between_the_two_trajectories(params, jax_run):
    """The witness for the later-step tolerances: before steps 2 and 3, JAX's
    own gradient at the port's parameters against JAX's gradient at JAX's
    parameters (the two differ by f32 noise). JAX alone moves by a few 1e-3
    of a leaf's max there, as far as the port's moments are allowed to be
    from JAX's; the port's and JAX's gradients at the same parameters are
    printed beside it and held to the same tolerance."""
    tcfg = t2.TransformerTrainConfig()
    model = _port(params)
    state = t2.init_transformer_train(model, tcfg)
    step = t2.make_transformer_train_step(model, tcfg)
    c8, s8 = _batches()
    names = [n for n, _ in t2.trained_parameters(model)]
    jax_self, port_jax = [], []
    for s, (_, jp, _, _) in enumerate(jax_run[:2]):
        state, _ = step(state, torch.from_numpy(c8), torch.from_numpy(s8))
        _, g = step.loss_and_grad(model, torch.from_numpy(c8), torch.from_numpy(s8), None)
        _, at_port = _jax_loss_and_grad(_flax_of(model), c8, s8)
        _, at_jax = _jax_loss_and_grad(jp, c8, s8)
        jax_self.append(_grad_shift(at_port, at_jax))
        port_jax.append(_grad_shift(dict(zip(names, g)), at_port))
        print(f"[parity] C1 gradient before step {s + 2}: JAX at the port's parameters vs at "
              f"its own {jax_self[-1]:.3e}; the port vs JAX at the port's parameters "
              f"{port_jax[-1]:.3e} (of a leaf's max)")
    assert TOL_LATER_MOMENT / 10 <= max(jax_self) <= TOL_LATER_MOMENT
    assert max(port_jax) <= TOL_LATER_MOMENT
