"""Phase E on the CPU: the port's style-field distillation
(tgtc_torch.train.style3d) against tgtc's, on numpy-seeded scenes and the
same weights (``convert.style_train_state_from_jax``).

Narrow sizes: D2/W32 trunks (10/4 frequencies, viewdirs), ``style_d`` 2,
width 32, latent 8; 2 styles, 3 frames of 8x8 rays; batch 16 a stream, 8+8
samples, σ noise 1.0, λ_coh 1e2, the llff x7 table tiling.

The trunks' σ bias is raised by 2 (``SIGMA_BIAS``), as a trained trunk's
density is: with a random trunk's σ near 0, σ noise 1.0 zeroes most of a
ray's weights, and the fine resampler's ``denom < 1e-5`` branch
(``sample_pdf``, the reference's) moves a fine depth by up to a bin where
the two frameworks' cumulative sums round differently. The losses still
agree to 4e-6, but the coherence gradient of the step below then differs by
up to 2.8e-2 of a leaf's max (measured at bias 0 on an x86 host; 4.4e-6 at
bias 2, 1.8e-6 at 5). That branch is the same code on both sides.

* One step from JAX's state after one step (the coherence loss active),
  JAX's draws fed explicitly, f32 trunks on both sides: the four losses to
  1e-5 relative, the gradients (read back from the moments) and the Adam
  moments to 5e-5, every parameter to 1e-5 of its leaf's scale floored at
  the learning rate (or through Adam's normalizer, see
  ``_assert_step_matches``), the buffers (rgb composites, at the renders'
  f32 bound) to 1e-5, the counters and Adam's counts equal, the trunks
  untouched, and the latent table's gradient that of the main stream alone
  (bit for bit the same gradient at λ_coh 0).
* The same from JAX's initial state (``cnt == 0``: the coherence loss 0)
  and past ``coh_until_step`` (the term computed, not applied); with bf16
  trunks at the stylized-render tolerance of the bf16 renders
  (tests/test_torch_render_style.py, 5e-2): losses relative, buffers
  absolute.
* ``coherence_grad_ratio``: JAX's ratio to 1e-4 with JAX's draws, linear in
  λ_coh, and the real trajectory bit for bit the one without it.
* ``style_train_state_from_jax`` converts bit for bit.
* ``run_style3d(..., device="cpu")`` on a written 2-style scene: the
  diagnostic line, the JSONL log and the checkpoints, a resume that
  continues where it stopped, and Phase F's ``load_style_field`` rendering
  the checkpoint through ``FusedStyleRenderer`` (the kernels' twins here)
  and ``render_stylized_frames_fused``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tgtc.data.style_dataset import StyleSceneData as JData
from tgtc.models.nerf import NerfConfig as JNerfConfig
from tgtc.models.nerf import make_nerf as j_make_nerf
from tgtc.models.style_field import StyleFieldConfig as JField
from tgtc.train import style3d as js
from tgtc_torch.config import Config
from tgtc_torch.convert import (
    nerf_state_dict_from_flax,
    style_state_dicts_from_flax,
    style_train_state_from_jax,
)
from tgtc_torch.data.llff import LlffScene
from tgtc_torch.data.style_dataset import StyleSceneData
from tgtc_torch.models.nerf import NerfConfig, NerfMLP
from tgtc_torch.models.style_field import StyleFieldConfig
from tgtc_torch.models.vae import VaeConfig, make_vae
from tgtc_torch.render.fast_style import FusedStyleRenderer
from tgtc_torch.render.volume import RenderSettings
from tgtc_torch.train import style3d as ts
from tgtc_torch.train.render_style import render_stylized_frames_fused
from test_torch_ops import close

torch.set_num_threads(1)

S, F, H, W = 2, 3, 8, 8
B, NC, NF = 16, 8, 8
LAT, STYLE_W = 8, 32
TOL_LOSS, TOL_PARAM, TOL_MOMENT, TOL_BUF = 1e-5, 1e-5, 5e-5, 1e-5
TOL_BF16 = 5e-2  # the bf16 stylized renders' bound against JAX's
SIGMA_BIAS = 2.0  # a random trunk's σ raised to a density (see the module docstring)
KEY = 3


def _field(embed):
    kw = dict(style_d=2, width=STYLE_W, latent_dim=LAT, embed_dim=embed)
    return JField(**kw), StyleFieldConfig(**kw)


def _cfgs(**kw):
    base = dict(batch_size=B, n_samples=NC, n_samples_fine=NF, sigma_noise_std=1.0,
                origin_step=0, coh_until_step=1000, loss_coh_lambda=1e2)
    base.update(kw)
    return js.StyleTrainConfig(**base), ts.StyleTrainConfig(**base)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    arrays = dict(rays_o=u(F, H, W, 3) - 0.5, rays_d=rng.standard_normal((F, H, W, 3), np.float32),
                  images=u(F, H, W, 3), stylized=u(S, F, H, W, 3),
                  style_features=rng.standard_normal((S, 1024), np.float32))
    return (JData(**{k: jnp.asarray(v) for k, v in arrays.items()}, near=0.0, far=1.0),
            StyleSceneData(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _trunks(dtype="f32", seed=0):
    """Both trunks, JAX (model, params) and the port's NerfMLP, the σ head's
    bias raised by ``SIGMA_BIAS``."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = JNerfConfig(depth=2, width=32, compute_dtype=jdt)
    key = jax.random.PRNGKey(seed)
    out = []
    for k in (key, jax.random.fold_in(key, 1)):
        model, params = j_make_nerf(jcfg, k)
        sigma = params["params"]["sigma"]
        params["params"]["sigma"] = {**sigma, "bias": sigma["bias"] + SIGMA_BIAS}
        port = NerfMLP(NerfConfig(depth=2, width=32, compute_dtype=tdt))
        port.load_state_dict(nerf_state_dict_from_flax(jax.tree.map(np.asarray, params)))
        out.append((model, params, port))
    return out, jcfg.input_ch


class Setup:
    """JAX's and the port's Phase-E pieces on the same scene and weights."""

    def __init__(self, dtype="f32", **cfg_kw):
        (self.jc, self.jf), embed = _trunks(dtype)
        self.jfield, self.tfield = _field(embed)
        self.jcfg, self.tcfg = _cfgs(**cfg_kw)
        self.jdata, self.tdata = _data()
        self.cm, self.sm, self.state0 = js.init_style_state(
            jax.random.PRNGKey(1), self.jfield, self.jcfg, S, F)
        self.jstep = js.make_style_train_step(self.jc[0], self.jf[0], self.jc[1], self.jf[1],
                                              self.cm, self.sm, self.jcfg)
        self.tstep = ts.make_style_train_step(self.jc[2], self.jf[2], self.tcfg)

    def jax_step(self, state):
        """JAX's step from ``state`` (which it donates: pass a copy)."""
        return self.jstep(state, self.jdata, jax.random.PRNGKey(KEY))

    def port_state(self, jstate):
        return style_train_state_from_jax(jax.device_get(jstate), self.tfield, self.tcfg,
                                          device="cpu")

    def draws(self, jstate):
        """JAX's draws for its step from ``jstate`` with ``KEY``, as the
        port's ``StyleStepDraws`` (the key derivation of
        tgtc/train/style3d.py's ``step_fn`` and ``two_pass``)."""
        key = jax.random.PRNGKey(KEY)
        k_coh = jax.random.fold_in(key, 7)
        k_main, k1, k2 = jax.random.split(jax.random.fold_in(key, int(jstate.step)), 3)
        t = lambda x: torch.from_numpy(np.array(x))
        main = jax.random.randint(k_main, (B,), 0, S * F * H * W)
        pix_key = jax.random.fold_in(jax.random.fold_in(k_coh, int(jstate.style_start)),
                                     int(jstate.block))
        pix = jax.random.randint(pix_key, (B,), 0, H * W)

        nf = self.tcfg.fine_budget or NC + NF  # the fine pass's samples a ray

        def stream(k):
            ks, kn1, kn2 = jax.random.split(k, 3)
            return (t(jax.random.uniform(ks, (B, NC))),
                    (t(jax.random.normal(kn1, (B, NC))), t(jax.random.normal(kn2, (B, nf)))))

        (u1, n1), (u2, n2) = stream(k1), stream(k2)
        return ts.StyleStepDraws(t(main), t(pix), u1, u2, n1, n2)


def _copy(tree):
    return jax.tree.map(lambda x: jnp.array(np.array(x)), tree)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _leaf_rel(got, want, floor):
    got, want = got.detach().double(), torch.as_tensor(np.asarray(want)).double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), floor)


def _jax_flat(jstate):
    """JAX's state as port-named tensors: parameters, and the Adam moments
    and counts of both partitions (in the port's parameter order)."""
    st = jax.device_get(jstate)
    c, s = style_state_dicts_from_flax(st.params)
    names = [f"concat.{n}" for n in c] + [f"style.{n}" for n in s] + ["latents"]
    params = (list(c.values()) + list(s.values())
              + [torch.from_numpy(np.array(st.params["latents"]))])
    adam = lambda part: st.opt_state.inner_states[part].inner_state[0]
    mom = {}
    for kind in ("mu", "nu"):
        mc, ms = style_state_dicts_from_flax(getattr(adam("style"), kind))
        mom[kind] = (list(mc.values()) + list(ms.values())
                     + [torch.from_numpy(np.array(getattr(adam("latent"), kind)["latents"]))])
    return names, params, mom, (int(adam("style").count), int(adam("latent").count))


def _assert_step_matches(tag, su, jold, jnew, jm, port, m):
    """The port's state after a step against JAX's, the step taken from
    JAX's state ``jold`` converted: the losses; each leaf's gradient (read
    back from the Adam moments, ``(mu' - 0.9 mu) / 0.1``) and the moments
    to 5e-5 of its largest element; every parameter to 1e-5 of its leaf's
    scale (floored
    at its learning rate) or, whichever is larger, to what that gradient
    tolerance allows through Adam's per-element normalizer, as
    tests/test_torch_vae.py holds its steps (an element near Adam's eps
    divides a small gradient error by its own small scale); the buffers; the
    counters and Adam's counts equal."""
    for k in ts.LOSSES:
        if float(jm[k]) == 0.0:
            assert float(m[k]) == 0.0, k
        else:
            close(_rel(m[k], jm[k]), 0.0, TOL_LOSS)
    names, _, mom0, _ = _jax_flat(jold)
    _, params, mom, counts = _jax_flat(jnew)
    opt = port.optimizer.state
    lrs = [su.tcfg.lrate] * (len(names) - 1) + [su.tcfg.latent_lrate]
    worst = {"grad": 0.0, "param": 0.0, "mu": 0.0, "nu": 0.0}
    exempt = 0
    for name, p, want, m0, m1, m2, lr, n in zip(names, port.parameters(), params, mom0["mu"],
                                                mom["mu"], mom["nu"], lrs, counts[:1] * len(lrs)):
        g_jax = (m1.double() - 0.9 * m0.double()) / 0.1
        g_port = (opt[p]["exp_avg"].double() - 0.9 * m0.double()) / 0.1
        gmax = float(g_jax.abs().max())
        for kind, rel in (("grad", float((g_port - g_jax).abs().max()) / gmax),
                          ("mu", _leaf_rel(opt[p]["exp_avg"], m1, 1e-30)),
                          ("nu", _leaf_rel(opt[p]["exp_avg_sq"], m2, 1e-30))):
            worst[kind] = max(worst[kind], rel)
            assert rel <= TOL_MOMENT, (tag, kind, name, rel)
        scale = max(float(want.abs().max()), lr)
        diff = (p.detach() - want).abs()
        tight = diff <= TOL_PARAM * scale
        worst["param"] = max(worst["param"], float(diff[tight].max()) / scale)
        sqrt_v_hat = (m2 / (1 - 0.999 ** n)).sqrt()
        propagated = (2 * lr * TOL_MOMENT * gmax / (sqrt_v_hat + 1e-8)).clamp(max=2 * lr)
        assert bool((tight | (diff <= propagated * (1 + 1e-3))).all()), (tag, name)
        exempt += int((~tight).sum())
    assert [int(opt[p]["step"]) for p in (port.parameters()[0], port.latents)] == list(counts)
    st = jax.device_get(jnew)
    for k in ("coh_x", "coh_y", "coh_x_origin"):
        close(getattr(port, k), np.asarray(getattr(st, k)), TOL_BUF)
    for k in ("step", "cnt", "style_start", "frame_start", "block", "start"):
        assert getattr(port, k) == int(getattr(st, k)), k
    print(f"[parity] Phase-E step ({tag}) vs JAX: losses "
          + ", ".join(f"{k} {float(m[k]):.6g}/{float(jm[k]):.6g}" for k in ts.LOSSES)
          + f"; max rel grad {worst['grad']:.3e}, param {worst['param']:.3e} where within "
          f"1e-5, mu {worst['mu']:.3e}, nu {worst['nu']:.3e}; elements held by the bound "
          f"through Adam's normalizer: {exempt}")


@pytest.fixture(scope="module")
def f32():
    """The f32 setup, JAX's state after one step and that step's metrics."""
    su = Setup()
    s1, m0 = su.jax_step(_copy(su.state0))
    return su, s1, m0


def test_converter_is_bitwise(f32):
    su, s1, _ = f32
    port = su.port_state(s1)
    names, params, mom, counts = _jax_flat(s1)
    opt = port.optimizer.state
    for name, p, want, m1, m2 in zip(names, port.parameters(), params, mom["mu"], mom["nu"]):
        assert torch.equal(p.detach(), want), name
        assert torch.equal(opt[p]["exp_avg"], m1) and torch.equal(opt[p]["exp_avg_sq"], m2), name
        assert int(opt[p]["step"]) == 1
    assert counts == (1, 1) and port.step == 1 and port.cnt == 1
    groups = port.optimizer.param_groups
    assert [g["lr"] for g in groups] == [su.tcfg.lrate, su.tcfg.latent_lrate]
    assert groups[1]["params"] == [port.latents] and len(groups[0]["params"]) == len(names) - 1


def test_step_matches_jax_with_coherence(f32):
    su, s1, _ = f32
    port = su.port_state(s1)
    draws = su.draws(s1)
    trunks = [{k: v.clone() for k, v in m.state_dict().items()} for m in (su.jc[2], su.jf[2])]
    s2, jm = su.jax_step(_copy(s1))
    assert float(jm["loss_coh"]) > 0
    port, m = su.tstep(port, su.tdata, draws)
    _assert_step_matches("coherence active", su, s1, s2, jm, port, m)
    for model, before in zip((su.jc[2], su.jf[2]), trunks):
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_latents_learn_from_the_main_stream_only(f32):
    su, s1, _ = f32
    draws = su.draws(s1)
    grads = {}
    for lam in (1e2, 0.0):
        step = ts.make_style_train_step(su.jc[2], su.jf[2],
                                        dataclasses.replace(su.tcfg, loss_coh_lambda=lam))
        _, g, t = step.loss_and_grad(su.port_state(s1), su.tdata, draws)
        assert float(t["loss_coh"].detach()) > 0
        grads[lam] = g
    assert torch.equal(grads[1e2][-1], grads[0.0][-1])  # the latent table
    assert not all(torch.equal(a, b) for a, b in zip(grads[1e2][:-1], grads[0.0][:-1]))


def test_first_step_without_coherence_matches_jax(f32):
    su, s1, m0 = f32
    assert float(m0["loss_coh"]) == 0.0 and int(su.state0.cnt) == 0
    port, m = su.tstep(su.port_state(su.state0), su.tdata, su.draws(su.state0))
    _assert_step_matches("cnt 0", su, su.state0, s1, m0, port, m)


def test_step_past_coh_until_step_matches_jax():
    su = Setup(coh_until_step=0)
    s1, _ = su.jax_step(_copy(su.state0))
    port = su.port_state(s1)
    draws = su.draws(s1)
    s2, jm = su.jax_step(_copy(s1))
    port, m = su.tstep(port, su.tdata, draws)
    assert float(m["loss_coh"]) > 0 and float(m["loss"]) == pytest.approx(
        float(m["loss_rgb"] + m["loss_logp"]), rel=1e-6)
    _assert_step_matches("past coh_until_step", su, s1, s2, jm, port, m)


def test_bf16_trunk_step_matches_jax():
    su = Setup("bf16")
    s1, _ = su.jax_step(_copy(su.state0))
    port = su.port_state(s1)
    draws = su.draws(s1)
    s2, jm = su.jax_step(_copy(s1))
    port, m = su.tstep(port, su.tdata, draws)
    for k in ts.LOSSES:
        close(_rel(m[k], jm[k]), 0.0, TOL_BF16)
    st = jax.device_get(s2)
    for k in ("coh_x", "coh_y"):
        close(getattr(port, k), np.asarray(getattr(st, k)), TOL_BF16)
    assert port.cnt == int(st.cnt) and port.step == int(st.step)


def _jax_ratio(lam):
    su = Setup(loss_coh_lambda=lam)
    diag = js.make_style_train_step(su.jc[0], su.jf[0], su.jc[1], su.jf[1], su.cm, su.sm,
                                    su.jcfg, with_grad_ratio=True)
    return su, js.coherence_grad_ratio(diag, su.state0, su.jdata, jax.random.PRNGKey(KEY))


def test_coherence_grad_ratio_matches_jax_and_is_linear():
    ratios = {}
    for lam in (1.0, 20.0):
        su, want = _jax_ratio(lam)
        port = su.port_state(su.state0)
        # JAX's draws for the two steps the diagnostic takes
        s1, _ = su.jax_step(_copy(su.state0))
        draws = (su.draws(su.state0), su.draws(s1))
        got = ts.coherence_grad_ratio(su.tstep, port, su.tdata, draws=draws)
        print(f"[parity] coherence_grad_ratio at lambda {lam}: port {got[0]:.7g} (coh "
              f"{got[1]:.6g}, rgb {got[2]:.6g}), JAX {want[0]:.7g}")
        assert _rel(got[0], want[0]) <= 1e-4
        ratios[lam] = got[0]
    assert _rel(ratios[20.0] / ratios[1.0], 20.0) <= 1e-6


def test_coherence_grad_ratio_leaves_the_trajectory(f32):
    su, _, _ = f32
    runs = []
    for probe in (False, True):
        state = su.port_state(su.state0)
        if probe:
            ts.coherence_grad_ratio(su.tstep, state, su.tdata, seed=5)
        for _ in range(2):
            state, _ = su.tstep(state, su.tdata, seed=5)
        runs.append(state)
    a, b = runs
    assert all(torch.equal(x.detach(), y.detach()) for x, y in zip(a.parameters(), b.parameters()))
    assert all(torch.equal(a.optimizer.state[x]["exp_avg"], b.optimizer.state[y]["exp_avg"])
               for x, y in zip(a.parameters(), b.parameters()))
    assert a.step == b.step == 2 and torch.equal(a.coh_y, b.coh_y)


def test_port_draws_repeat_and_depend_on_the_step(f32):
    su, _, _ = f32
    state = su.port_state(su.state0)
    d1, d2 = (su.tstep.draw(su.tdata, state, seed=4) for _ in range(2))
    assert all(torch.equal(getattr(d1, k), getattr(d2, k))
               for k in ("main_ids", "coh_pix", "u_main", "u_coh"))
    state.step += 1  # the same (style, block): the same coherent pixels
    d3 = su.tstep.draw(su.tdata, state, seed=4)
    assert torch.equal(d3.coh_pix, d1.coh_pix) and not torch.equal(d3.main_ids, d1.main_ids)


def test_fine_budget_raises():
    """``fine_budget``, once refused, now takes JAX's step: one step with
    a budget of 12 of 16 from JAX's state after one step (the coherence loss
    active), held as test_step_matches_jax_with_coherence holds it; a
    budget outside (0, 16] is refused."""
    su = Setup(fine_budget=12)
    s1, _ = su.jax_step(_copy(su.state0))
    port = su.port_state(s1)
    draws = su.draws(s1)
    assert draws.noise_main[1].shape == (B, 12)
    s2, jm = su.jax_step(_copy(s1))
    port, m = su.tstep(port, su.tdata, draws)
    assert float(jm["loss_coh"]) > 0
    _assert_step_matches("fine_budget 12", su, s1, s2, jm, port, m)
    with pytest.raises(ValueError, match="fine_budget"):
        ts.make_style_train_step(su.jc[2], su.jf[2],
                                 dataclasses.replace(su.tcfg, fine_budget=NC + NF + 1))


# ---------------------------------------------------------------- the loop


def _write_scene(root, rng, s=2, f=3, h=8, w=8):
    """An LlffScene (3 views facing -z), Phase B's renders and Phase C3's
    per-style frames with their npz, as the pipeline leaves them."""
    poses = np.zeros((f, 3, 5), np.float32)
    for i in range(f):
        poses[i, :3, :3] = np.eye(3)
        poses[i, :3, 3] = (0.05 * i, 0.0, 0.0)
        poses[i, :, 4] = (h, w, 10.0)
    scene = LlffScene(images=rng.uniform(0, 1, (f, h, w, 3)).astype(np.float32), poses=poses,
                      bds=np.tile(np.float32([[1.0, 5.0]]), (f, 1)), render_poses=poses,
                      i_test=0)
    gen, sty = os.path.join(root, "gen"), os.path.join(root, "stylized")
    os.makedirs(gen)
    for i in range(f):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            os.path.join(gen, f"rgb_{i:05d}.png"))
    dirs = []
    for si in range(s):
        d = os.path.join(sty, f"style_{si:02d}")
        os.makedirs(d)
        for i in range(f):
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                os.path.join(d, f"{i + 1:03d}.jpg"))
        dirs.append(d)
    np.savez(os.path.join(sty, "stylized_data.npz"), style_paths=np.array(dirs),
             style_features=rng.standard_normal((s, 1024)).astype(np.float32))
    return scene, gen, sty


def test_run_style3d_logs_checkpoints_resumes_and_renders(tmp_path):
    rng = np.random.default_rng(7)
    scene, gen, sty = _write_scene(str(tmp_path), rng)
    (jc, jf), embed = _trunks()
    nerf = (jc[2], jf[2])
    vae = make_vae(VaeConfig(width=16, depth=2, latent_dim=LAT), torch.Generator().manual_seed(3),
                   device="cpu")
    cfg = Config(batch_size_style=B, N_samples=NC, N_samples_fine=NF, loss_coh_lambda=1e2,
                 origin_step=10, total_step=13, style_D=2, netwidth=STYLE_W, vae_latent=LAT,
                 i_print=2, seed=1)
    out = str(tmp_path / "run")
    lines = []
    state, hist = ts.run_style3d(cfg, scene, gen, sty, *nerf, vae, out, device="cpu",
                                 print_fn=lines.append)
    assert state.step == 13 and len(hist["loss"]) == 3 and hist["loss_coh"][0] == 0.0
    assert all(np.isfinite(hist[k]).all() for k in ts.LOSSES) and hist["loss_coh"][1] > 0
    assert any(line.startswith("[COH DIAG] step 10 coh_grad_ratio") for line in lines)
    assert sorted(os.listdir(os.path.join(out, "ckpt_style"))) == ["ckpt_00000013.pt"]
    records = [json.loads(line) for line in open(os.path.join(out, "logs", "style.jsonl"))]
    assert [r["step"] for r in records] == [10, 12, 13]
    assert "coh_grad_ratio" in records[0] and records[-1]["steps_per_s"] > 0

    # resume: the same cfg trains nothing; a later total_step continues
    again, hist2 = ts.run_style3d(cfg, scene, gen, sty, *nerf, vae, out, device="cpu",
                                  print_fn=None)
    assert again.step == 13 and hist2["loss"] == []
    assert all(torch.equal(a.detach(), b.detach())
               for a, b in zip(again.parameters(), state.parameters()))
    longer = dataclasses.replace(cfg, total_step=15)
    cont, hist3 = ts.run_style3d(longer, scene, gen, sty, *nerf, vae, out, device="cpu",
                                 print_fn=None)
    assert cont.step == 15 and len(hist3["loss"]) == 2
    # an uninterrupted run to 15 reaches the same state
    fresh, _ = ts.run_style3d(longer, scene, gen, sty, *nerf, vae, str(tmp_path / "run2"),
                              device="cpu", print_fn=None)
    assert all(torch.equal(a.detach(), b.detach())
               for a, b in zip(fresh.parameters(), cont.parameters()))
    assert [getattr(fresh, k) for k in ("cnt", "style_start", "frame_start", "block")] == [
        getattr(cont, k) for k in ("cnt", "style_start", "frame_start", "block")]

    # Phase F from the checkpoint
    field = ts.style_field_config(cfg, nerf[0])
    concat, style, lat = ts.load_style_field(os.path.join(out, "ckpt_style"), field,
                                             device="cpu")
    assert torch.equal(lat["latents"], cont.latents.detach())
    settings = RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    rend = FusedStyleRenderer.from_params(nerf[0].state_dict(), nerf[1].state_dict(),
                                          concat.state_dict(), style.state_dict(), lat, settings,
                                          depth=2, trunk_width=32, style_d=2,
                                          style_width=STYLE_W, latent_dim=LAT, device="cpu")
    data = ts.load_style_scene(scene, gen, sty, device="cpu")
    frame = rend.render_image(data.rays_o[1].reshape(-1, 3), data.rays_d[1].reshape(-1, 3), 1, 1,
                              block=32)
    assert frame["rgb"].shape == (H * W, 3) and bool(torch.isfinite(frame["rgb"]).all())
    frames = str(tmp_path / "frames")
    assert render_stylized_frames_fused(rend, data.rays_o[:1], data.rays_d[:1], [1], frames,
                                        block=32) == 1
    assert Image.open(os.path.join(frames, "style_00001_fine_00000.png")).size == (W, H)
