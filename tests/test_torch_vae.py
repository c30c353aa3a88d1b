"""Phase D on the CPU: the port's VAE (tgtc_torch.models.vae), its trainer
(tgtc_torch.train.vae_trainer), the ``vae.pth`` loader and the ``vae`` task
of tools/train2d against tgtc's, on numpy-seeded inputs and the same
weights (``convert.vae_state_dict_from_flax``).

* ``Vae`` forward at the pipeline's shape (1024 → 512 x3 → 32) with JAX's
  ε injected, and ``vae_loss``: 1e-6 of each output's scale.
* Five train steps with JAX's per-step ε (``jax.random.normal(fold_in(key,
  step), ...)``), at ``lr_decay`` 0 and 5e-2, each from JAX's state before
  it converted bit for bit: losses and gradients to 1e-5 relative,
  parameters to 1e-5 of each leaf's scale floored at the learning rate, or
  to the gradient tolerance carried through Adam's per-element normalizer
  (see the test).
* ``vgg_style_feature`` against JAX's on 32x32 images through the full-width
  VGG, 1e-5 of the largest feature.
* ``seed_latents_from_features`` with JAX's ε injected, 1e-6.
* ``load_vae_params`` on a reference-named state dict the test writes:
  converted, bit for bit JAX's ``load_vae_params``; a missing path gives
  None. The converters round-trip bit for bit.
* ``train2d.main(["--task", "vae", ...], device="cpu")`` at tiny widths
  writes its log and checkpoints and resumes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tgtc.models import vae as jv
from tgtc.models.vgg import VggEncoder as JVgg
from tgtc.train import pretrained as jp
from tgtc.train import vae_trainer as jvt
from tgtc_torch.convert import (
    stytrans_state_dicts_from_flax,
    vae_flax_from_state_dict,
    vae_state_dict_from_flax,
)
from tgtc_torch.models import vae as tv
from tgtc_torch.models.vgg import make_vgg
from tgtc_torch.tools import train2d
from tgtc_torch.train import pretrained as tp
from tgtc_torch.train import vae_trainer as tvt
from test_torch_ops import close

torch.set_num_threads(1)

CFG = tv.VaeConfig()
J_CFG = jv.VaeConfig()
BATCH = 8
TOL_FWD, TOL_LOSS, TOL_PARAM, TOL_FEAT = 1e-6, 1e-5, 1e-5, 1e-5


def _jax_model(seed=0):
    model, params = jv.make_vae(J_CFG, jax.random.PRNGKey(seed))
    return model, jax.tree.map(np.asarray, params)


def _port(params):
    model = tv.make_vae(CFG, torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(vae_state_dict_from_flax(params))
    return model


def _features(seed=1, n=BATCH):
    """Feature-like rows: channel means ~U(0, 2) ‖ stds ~U(0.1, 1)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, 2, (n, 512)), rng.uniform(0.1, 1, (n, 512))],
                          -1).astype(np.float32)


def _scaled(got, want, tol):
    want = np.asarray(want)
    close(np.asarray(got.detach()) / max(np.abs(want).max(), 1e-30),
          want / max(np.abs(want).max(), 1e-30), tol)


def test_forward_and_loss_match_jax():
    model, params = _jax_model()
    x = _features()
    key = jax.random.PRNGKey(4)
    y, z, mu, logvar = model.apply(params, jnp.asarray(x), key)
    eps = jax.random.normal(key, mu.shape, mu.dtype)  # what reparameterize draws
    got = _port(params)(torch.from_numpy(x), eps=torch.from_numpy(np.asarray(eps)))
    for g, w in zip(got, (y, z, mu, logvar)):
        _scaled(g, w, TOL_FWD)
    # without eps or a generator, z is mu, as JAX's call without a key
    y0, z0, _, _ = _port(params)(torch.from_numpy(x))
    _scaled(z0, model.apply(params, jnp.asarray(x))[1], TOL_FWD)
    loss, parts = tv.vae_loss(torch.from_numpy(x), *got[:1], *got[2:], CFG.kl_lambda)
    j_loss, j_parts = jv.vae_loss(jnp.asarray(x), y, mu, logvar, J_CFG.kl_lambda)
    _scaled(loss, j_loss, TOL_FWD)
    for k in ("recon", "kl"):
        _scaled(parts[k], j_parts[k], TOL_FWD)


def test_reparameterize_draws_from_the_generator():
    mu, logvar = torch.zeros(4, 3), torch.zeros(4, 3)
    a = tv.reparameterize(mu, logvar, generator=torch.Generator().manual_seed(1))
    b = tv.reparameterize(mu, logvar, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, mu)
    assert torch.equal(tv.reparameterize(mu + 1, logvar, eps=torch.ones(4, 3), factor=0.5),
                       torch.full((4, 3), 1.5))


def _load_jax_state(state, jstate):
    """``state`` set to JAX's VAE train state bit for bit: the parameters,
    Adam's moments and count, the schedule's position."""
    adam = jstate.opt_state[0]
    sd = vae_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    mu, nu = (vae_state_dict_from_flax(jax.tree.map(np.asarray, t)) for t in (adam.mu, adam.nu))
    state.model.load_state_dict(sd)
    count = int(adam.count)
    names = [n for n, _ in state.model.named_parameters()]
    opt = state.optimizer.state_dict()
    opt["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n].clone(),
                        "exp_avg_sq": nu[n].clone()} for i, n in enumerate(names)}
    state.optimizer.load_state_dict(opt)
    state.scheduler.last_epoch = count
    for group in state.optimizer.param_groups:
        group["lr"] = state.scheduler.lr_lambdas[0](count)
    state.step = int(jstate.step)


@pytest.mark.parametrize("lr_decay", [0.0, 5e-2])
def test_five_train_steps_match_jax(lr_decay):
    """Each step from JAX's state before it, with JAX's ε: the losses and
    the gradients to 1e-5 (of each leaf's largest gradient); every
    parameter to 1e-5 of its leaf's scale (floored at the learning rate) or
    to what that gradient tolerance allows through Adam's per-element
    normalizer, whichever is larger. The update lr · m_hat / (sqrt(v_hat) +
    eps) divides each element by its own gradient scale, so a gradient
    error of 1e-5 of the leaf's largest gradient moves an element by up to
    lr · 1e-5 · max|g| / (sqrt(v_hat) + eps) (twice that, for m and v),
    capped at 2 lr, the most two updates can differ by. At the first step,
    from zero moments, elements near Adam's eps take 0.0068 lr, and at the
    second, small elements ~1.2e-5 of their leaf's scale; the elements the
    propagated bound admits are counted."""
    jcfg = jvt.VaeTrainConfig(lr_decay=lr_decay, batch_size=BATCH)
    jmodel, jstate = jvt.init_vae_train(jax.random.PRNGKey(0), J_CFG, jcfg)
    step = jvt.make_vae_train_step(jmodel, jcfg)
    key = jax.random.PRNGKey(3)
    tcfg = tvt.VaeTrainConfig(lr_decay=lr_decay, batch_size=BATCH)
    model, state = tvt.init_vae_train(torch.Generator(), CFG, tcfg, device="cpu")
    port_step = tvt.make_vae_train_step(model, tcfg)
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    exempt = 0
    for s in range(5):
        x = _features(10 + s)
        eps = np.array(jax.random.normal(jax.random.fold_in(key, s), (BATCH, CFG.latent_dim)))
        _load_jax_state(state, jstate)

        def j_loss(p):
            y, _, mu, logvar = jmodel.apply(p, jnp.asarray(x), jax.random.fold_in(key, s))
            return jv.vae_loss(jnp.asarray(x), y, mu, logvar, J_CFG.kl_lambda)[0]

        j_grad = vae_state_dict_from_flax(jax.tree.map(np.asarray,
                                                       jax.grad(j_loss)(jstate.params)))
        _, grads = port_step.loss_and_grad(model, torch.from_numpy(x), torch.from_numpy(eps))
        for (name, _), g in zip(model.named_parameters(), grads):
            err = float((g - j_grad[name]).abs().max()) / float(j_grad[name].abs().max())
            worst["grad"] = max(worst["grad"], err)
            assert err <= TOL_LOSS, (s, name, err)
        jstate, jm = step(jstate, jnp.asarray(x), key)
        state, m = port_step(state, torch.from_numpy(x), eps=torch.from_numpy(eps))
        for k in ("loss", "recon", "kl"):
            rel = abs(float(m[k]) - float(jm[k])) / abs(float(jm[k]))
            worst["loss"] = max(worst["loss"], rel)
            assert rel <= TOL_LOSS, (s, k, rel)
        lr = jcfg.lr / (1 + lr_decay * s)
        want = vae_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
        nu = vae_state_dict_from_flax(jax.tree.map(np.asarray, jstate.opt_state[0].nu))
        for name, p in model.state_dict().items():
            scale = max(float(want[name].abs().max()), lr)
            diff = (p - want[name]).abs()
            tight = diff <= TOL_PARAM * scale
            worst["param"] = max(worst["param"], float(diff[tight].max()) / scale)
            sqrt_v_hat = (nu[name] / (1 - 0.999 ** (s + 1))).sqrt()
            propagated = (2 * lr * TOL_LOSS * float(j_grad[name].abs().max())
                          / (sqrt_v_hat + 1e-8)).clamp(max=2 * lr) * (1 + 1e-3)
            assert bool((tight | (diff <= propagated)).all()), (s, name)
            exempt += int((~tight).sum())
        assert state.step == s + 1
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
            jcfg.lr / (1 + lr_decay * (s + 1)), rel=1e-12)
    print(f"[parity] VAE five steps, lr_decay {lr_decay}: max rel loss {worst['loss']:.3e}, "
          f"grad {worst['grad']:.3e}, param {worst['param']:.3e} where within 1e-5; elements "
          f"held by the bound propagated through Adam's normalizer: {exempt}")


def test_step_draws_eps_from_the_step_seed():
    model, state = tvt.init_vae_train(torch.Generator().manual_seed(0), CFG, tvt.VaeTrainConfig(),
                                      device="cpu")
    step = tvt.make_vae_train_step(model, tvt.VaeTrainConfig())
    a, b = step.eps(5, 3, 4), step.eps(5, 3, 4)
    assert torch.equal(a, b) and not torch.equal(a, step.eps(5, 4, 4))
    x = torch.from_numpy(_features())
    _, m = step(state, x, seed=5)
    assert np.isfinite(float(m["loss"]))


def test_vgg_style_feature_matches_jax():
    jvgg = JVgg()
    params = jvgg.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    imgs = np.random.default_rng(6).uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvt.vgg_style_feature(jvgg, params, jnp.asarray(imgs)))
    vgg = make_vgg(torch.Generator().manual_seed(0), device="cpu")
    vgg.load_state_dict(stytrans_state_dicts_from_flax(
        {"params": {"vgg": jax.tree.map(np.asarray, params["params"])}})["vgg"])
    with torch.no_grad():
        got = tvt.vgg_style_feature(vgg, torch.from_numpy(imgs))
    assert got.shape == (3, 1024)
    _scaled(got, want, TOL_FEAT)


def test_seed_latents_matches_jax():
    model, params = _jax_model(1)
    feats = _features(7, 3)
    key = jax.random.PRNGKey(8)
    want = jvt.seed_latents_from_features(key, model, params, jnp.asarray(feats), 5)
    eps = jax.random.normal(key, (3, 5, CFG.latent_dim))  # set_latents_from_vae's draw
    got = tvt.seed_latents_from_features(_port(params), torch.from_numpy(feats), 5,
                                         eps=torch.from_numpy(np.asarray(eps)))
    assert got["latents"].shape == (3, 5, CFG.latent_dim)
    for k in ("latents", "mu", "logvar"):
        _scaled(got[k], want[k], TOL_FWD)


def _reference_vae_pth(path, seed=0, depth=4):
    """A reference-named ``vae.pth`` (torch Linear layout) of random weights."""
    rng = np.random.default_rng(seed)
    sd = {}
    for layer, (n_in, n_out) in zip(
            tp.vae_keys(depth)[::2],
            [(1024, 512)] + [(512, 512)] * (depth - 2) + [(512, 32)] * 2 + [(32, 512)]
            + [(512, 512)] * (depth - 2) + [(512, 1024)]):
        sd[layer] = torch.from_numpy(rng.standard_normal((n_out, n_in)).astype(np.float32))
        sd[layer.replace(".weight", ".bias")] = torch.from_numpy(
            rng.standard_normal(n_out).astype(np.float32))
    sd["extra.unused"] = torch.zeros(1)  # keys the VAE does not have are left out
    torch.save(sd, path)
    return sd


def test_load_vae_params_matches_jax(tmp_path):
    path = str(tmp_path / "vae.pth")
    _reference_vae_pth(path)
    got = tp.load_vae_params(path)
    assert sorted(got) == sorted(tp.vae_keys())
    model = tv.make_vae(CFG, torch.Generator(), device="cpu")
    model.load_state_dict(got)  # strict: the reference names are the module's
    want = jp.load_vae_params(path)
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
                      for kp, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(vae_flax_from_state_dict(got)), flat(want)
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    back = vae_state_dict_from_flax(vae_flax_from_state_dict(got))
    assert all(torch.equal(back[k], got[k]) for k in got)
    assert tp.load_vae_params(str(tmp_path / "missing.pth")) is None
    assert tp.load_vae_params("") is None


def test_train2d_vae_task_runs_and_resumes(tmp_path):
    styles = tmp_path / "styles"
    styles.mkdir()
    rng = np.random.default_rng(9)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (40, 47, 3), np.uint8)).save(styles / f"s{i}.png")
    argv = ["--task", "vae", "--style_dir", str(styles), "--save_dir", str(tmp_path / "save"),
            "--log_dir", str(tmp_path / "log"), "--max_iter", "2", "--batch_size", "2",
            "--patch", "16", "--print_interval", "1", "--save_model_interval", "1",
            "--n_threads", "2", "--vae_w", "16", "--vae_latent", "4", "--vgg", ""]
    assert train2d.main(argv, device="cpu") == 0
    assert sorted(os.listdir(tmp_path / "save" / "vae")) == ["ckpt_00000001.pt",
                                                             "ckpt_00000002.pt"]
    lines = (tmp_path / "log" / "vae.jsonl").read_text().splitlines()
    records = [eval(line) for line in lines]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["steps_per_s"] > 0 for r in records)
    sd = torch.load(tmp_path / "save" / "vae" / "ckpt_00000002.pt", weights_only=False)
    assert sd["step"] == 2 and sd["model"]["encoder.fc_layer_mu.weight"].shape == (4, 16)
    # resumes at step 2; a third call at the same max_iter trains nothing
    argv[argv.index("--max_iter") + 1] = "3"
    assert train2d.main(argv, device="cpu") == 0
    assert train2d.main(argv, device="cpu") == 0
    assert [eval(line)["step"] for line in
            (tmp_path / "log" / "vae.jsonl").read_text().splitlines()] == [1, 2, 3]
