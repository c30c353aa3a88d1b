"""Phase C2 on the CPU: the port's temporal decoder finetune
(tgtc_torch.train.temporal) against tgtc's, on the same numpy-seeded
batches and the same weights (converted by ``tgtc_torch.convert``).

Narrow network: test_torch_c1.py's (d_model 32, 2 heads, 1+1 layers, FFN
64, the truncated VGG at full widths, biases moved off 0), dropout 0; a
32x32 patch at (5, 11) of a 40x52 NDC frame whose coor maps are a tilted
plane seen from two nearby cameras.

* ``_stylize_and_warp``: ``ics`` and the warped rgb to 1e-5, the hit and
  occlusion masks equal, on the "xla" path and on the flash path (K6's
  twin against JAX's Pallas flash in interpret mode).
* One C2 step from JAX's state converted bit for bit: the five losses to
  1e-5 relative; nothing but ``decode`` moves
  (tests/test_trainers_2d.py:122-156); the decoder's Adam moments to 5e-5
  and its leaves (their scale floored at the learning rate) to 1e-5, the
  tolerances of tests/test_torch_c1.py. The decoder's gradient crosses the
  random VGG's max-pool and ReLU near-ties (see tests/test_torch_c1.py):
  JAX's step records its decisions there (``jax_tie_recorder``) and the
  port's step takes them (``port_takes_jax_picks``), every rerouted window
  or element a near-tie on both sides. Adam's first update is lr · m / (|m|
  + eps), so a gradient element whose sign the rounding flips (|g| ~ 1e-5
  of the leaf's max here, away from any tie) moves 2 lr: each parameter
  element is held to its leaf's tolerance or to 2 lr of JAX's, whichever
  is larger.
* The debug images equal JAX's within 1 LSB.
* ``sample_patch`` and the loop's draws (``draw_batch``) equal the
  pipeline's for the same ``np.random.default_rng``; the batches
  ``run_temporal_finetune`` feeds its step equal the pipeline's crops bit
  for bit.
* A short CPU run of ``run_temporal_finetune`` writes its log and the
  debug PNGs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.stytrans import StyTrans as JStyTrans
from tgtc.models.transformer import TransformerConfig as JConfig
from tgtc.ops.rasterize import llff_projection_matrix as j_proj
from tgtc.train import temporal as jtemp
from tgtc.train import transformer2d as jt
from tgtc_torch.convert import stytrans_model_state_from_flax
from tgtc_torch.models.stytrans import make_stytrans
from tgtc_torch.models.transformer import TransformerConfig
from tgtc_torch.train import temporal as tt
from test_torch_c1 import (  # noqa: F401 (params is a fixture)
    TOL_LOSS, TOL_MOMENT, TOL_PARAM, _leaf_rel, _rel, jax_tie_recorder, moves, params,
    port_takes_jax_picks, recorded)
from test_torch_ops import close
from test_torch_stytrans import NARROW

torch.set_num_threads(1)

H, W, FOCAL, PATCH, ORIGIN = 40, 52, 45.0, 32, (5, 11)
TOL_ICS = 1e-5
CFG = tt.TemporalTrainConfig(batch_size=2, patch=PATCH)
J_CFG = jtemp.TemporalTrainConfig(batch_size=2, patch=PATCH)


def _cps():
    """Camera-to-world poses: the identity and a camera moved by (0.04,
    -0.02, 0.03) and turned by 0.02 rad about y."""
    a = 0.02
    moved = np.array([[np.cos(a), 0, np.sin(a), 0.04], [0, 1, 0, -0.02],
                      [-np.sin(a), 0, np.cos(a), 0.03], [0, 0, 0, 1]], np.float32)
    return np.stack([np.eye(4, dtype=np.float32), moved])


def _coor_maps(cps):
    """NDC coor maps ``[2, H, W, 3]`` of the plane z = -2 - 0.1 x - 0.05 y
    seen through each camera's pixel centres."""
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    d_cam = np.stack([(xs - W / 2) / FOCAL, -(ys - H / 2) / FOCAL, -np.ones_like(xs)], -1)
    maps = []
    for c2w in cps.astype(np.float64):
        o, d = c2w[:3, 3], d_cam @ c2w[:3, :3].T
        # the plane n · p = -2 with n = (0.1, 0.05, 1)
        n = np.array([0.1, 0.05, 1.0])
        t = (-2.0 - o @ n) / (d @ n)
        p = o + t[..., None] * d
        maps.append(np.stack([-FOCAL / (W / 2) * p[..., 0] / p[..., 2],
                              -FOCAL / (H / 2) * p[..., 1] / p[..., 2],
                              1 + 2 / p[..., 2]], -1))
    return np.stack(maps).astype(np.float32)


def _batch(seed=0):
    """``(content, coor, cps, style)`` of one C2 batch: content and style
    patches in [0, 1], the coor maps cropped to the patch at ORIGIN."""
    rng = np.random.default_rng(seed)
    cps = _cps()
    y0, x0 = ORIGIN
    coor = _coor_maps(cps)[:, y0: y0 + PATCH, x0: x0 + PATCH]
    content, style = (rng.uniform(0, 1, (2, PATCH, PATCH, 3)).astype(np.float32)
                      for _ in range(2))
    return content, np.ascontiguousarray(coor), cps, style


def _port(params, attn_impl="xla"):
    model = make_stytrans(TransformerConfig(dropout=0.0, attn_impl=attn_impl, **NARROW),
                          torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(stytrans_model_state_from_flax(params))
    return model


def _cam():
    return tt.SplatCamera.llff(H, W, FOCAL, is_ndc=True, device="cpu")


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_stylize_and_warp_matches_jax(params, attn_impl):
    content, coor, cps, style = _batch()
    jm = JStyTrans(JConfig(dropout=0.0, attn_impl=attn_impl, **NARROW))
    proj = jnp.asarray(j_proj(H, W, FOCAL))
    want = jax.jit(lambda p, *a: jtemp._stylize_and_warp(
        jm, J_CFG, proj, H, W, True, FOCAL, p, *a, ORIGIN, jax.random.PRNGKey(0), 0)[1:])(
        params, *(jnp.asarray(x) for x in (content, coor, cps, style)))
    with torch.no_grad():
        got = tt._stylize_and_warp(_port(params, attn_impl), CFG, _cam(),
                                   *(torch.from_numpy(x) for x in (content, coor, cps, style)),
                                   ORIGIN, None)[1:]
    ics, warped, mask, occl = got
    close(ics, np.asarray(want[0]), TOL_ICS)
    close(warped, np.asarray(want[1]), TOL_ICS)
    hits, kept = float(mask.mean()), float((mask * occl).mean())
    print(f"[parity] C2 core ({attn_impl}): hit share {hits:.3f}, hit and unoccluded {kept:.3f}")
    assert 0.2 < kept < hits <= 1.0  # the masks are neither empty nor everything
    assert np.array_equal(mask.numpy(), np.asarray(want[2]))
    assert np.array_equal(occl.numpy(), np.asarray(want[3]))


def _adam(j_state):
    return j_state.opt_state.inner_states["train"].inner_state[0]


def _jax_one_step(params):
    """JAX's C2 state after one step on ``_batch()`` from ``params``: the
    parameters, the decoder's Adam moments (numpy), the metrics and the
    step's recorded ties (``jax_tie_recorder``)."""
    jm = JStyTrans(JConfig(dropout=0.0, **NARROW))
    state = jt.init_transformer_train(jax.tree.map(jnp.asarray, params),
                                      jt.TransformerTrainConfig(lr=J_CFG.lr),
                                      train_keys=("decode",))
    with jax_tie_recorder() as seen:
        step = jtemp.make_temporal_train_step(jm, J_CFG, jnp.asarray(j_proj(H, W, FOCAL)), H, W,
                                              is_ndc=True, focal=FOCAL)
        state, m = step(state, *(jnp.asarray(x) for x in _batch()), ORIGIN,
                        jax.random.PRNGKey(0))
        ties = recorded(seen)
    adam = _adam(state)
    pick = lambda t: {"params": {"decode": jax.tree.map(np.array, t["params"]["decode"])}}
    return (jax.tree.map(np.array, state.params), pick(adam.mu), pick(adam.nu),
            {k: float(v) for k, v in m.items()}, ties)


def _decoder_state(j_params, j_mu, j_nu):
    """The decoder's leaves and Adam moments as port-named flat dicts."""
    flat = stytrans_model_state_from_flax(j_params)
    return ({n: v for n, v in flat.items() if n.startswith("decode.")},
            stytrans_model_state_from_flax(j_mu), stytrans_model_state_from_flax(j_nu))


@pytest.fixture(scope="module")
def jax_step(params):
    """JAX's step from ``params``: its metrics, its decoder state and the
    ties it recorded."""
    out = _jax_one_step(params)
    return out[3], _decoder_state(*out[:3]), out[4]


def test_one_step_matches_jax(params, jax_step):
    jm, run, ties = jax_step
    model = _port(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = tt.init_temporal_train(model, CFG)
    with port_takes_jax_picks(ties) as rerouted:
        state, m = tt.make_temporal_train_step(model, CFG, _cam())(
            state, *(torch.from_numpy(x) for x in _batch()), ORIGIN)
    assert set(m) == {"loss", "loss_c", "loss_s", "loss_t", "l_id1", "l_id2"}
    for k in m:
        close(_rel(m[k], jm[k]), 0.0, TOL_LOSS)
    assert float(m["loss_t"]) > 0
    for name, p in model.named_parameters():
        if not name.startswith("decode."):
            assert not p.requires_grad and torch.equal(p, before[name]), name
        else:
            assert not torch.equal(p, before[name]), name
    decoder = [(n, p) for n, p in model.named_parameters() if n.startswith("decode.")]
    opt = state.optimizer.state
    ours = ({n: p.detach() for n, p in decoder}, {n: opt[p]["exp_avg"] for n, p in decoder},
            {n: opt[p]["exp_avg_sq"] for n, p in decoder})
    lr = float(jt.lr_schedule(jt.TransformerTrainConfig(lr=CFG.lr))(0))
    dist = {kind: max(_leaf_rel(a[n], b[n], 1e-30) for n in b)
            for kind, a, b in zip(("mu", "nu"), ours[1:], run[1:])}
    flips = max(float((ours[0][n] - run[0][n]).abs().max()) for n in run[0]) / lr
    print(f"[parity] C2 step vs JAX (rerouted max-pool windows and ReLU elements: "
          f"{moves(rerouted)}): max rel " + ", ".join(f"{k} {d:.3e}" for k, d in dist.items())
          + f" (tol {TOL_MOMENT:.3g}); max|d param| {flips:.4f} lr")
    assert all(d <= TOL_MOMENT for d in dist.values()), dist
    # the parameters: each leaf within its tolerance, or no element further
    # than one sign flip of Adam's first update (2 lr) from JAX's
    for n, want in run[0].items():
        err = float((ours[0][n] - want).abs().max())
        scale = max(float(want.abs().max()), lr)
        assert err <= max(TOL_PARAM * scale, 2 * lr * (1 + 1e-3)), (n, err / lr)
    assert state.step == 1 and state.scheduler.last_epoch == 1


def test_debug_images_match_jax(params):
    content, coor, cps, style = _batch(1)
    jm = JStyTrans(JConfig(dropout=0.0, **NARROW))
    want = jtemp.make_temporal_debug_fn(jm, J_CFG, jnp.asarray(j_proj(H, W, FOCAL)), H, W,
                                        is_ndc=True, focal=FOCAL)(
        params, *(jnp.asarray(x) for x in (content, coor, cps, style)), ORIGIN,
        jax.random.PRNGKey(0))
    got = tt.make_temporal_debug_fn(_port(params), CFG, _cam())(
        *(torch.from_numpy(x) for x in (content, coor, cps, style)), ORIGIN)
    assert list(got) == list(tt.DEBUG_IMAGES) and set(want) == set(got)
    for name in got:
        g, w = got[name].numpy().astype(int), np.asarray(want[name]).astype(int)
        assert g.dtype == w.dtype and g.shape == w.shape == (2, PATCH, PATCH, 3)
        assert np.abs(g - w).max() <= 1, name


def test_sample_patch_matches_jax():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for h, w, p in ((100, 120, 32), (756, 1008, 256), (32, 32, 64), (40, 52, 32)):
        for _ in range(10):
            assert tt.sample_patch(a, h, w, p) == jtemp.sample_patch(b, h, w, p)


def _pipeline_draws(rng, renders, coor_maps, cps, styles_512, h, w, cfg):
    """The pipeline's C2 host batch, verbatim (tgtc/train/pipeline.py:554-567)."""
    patch = min(cfg.patch, h, w)
    y0, x0 = jtemp.sample_patch(rng, h, w, patch)
    ids = rng.integers(0, renders.shape[0], cfg.batch_size)
    content = renders[ids][:, y0: y0 + patch, x0: x0 + patch]
    coor = coor_maps[ids][:, y0: y0 + patch, x0: x0 + patch]
    sy = rng.integers(0, 512 - patch + 1)
    sx = rng.integers(0, 512 - patch + 1)
    s_id = rng.integers(0, styles_512.shape[0])
    style = np.broadcast_to(styles_512[s_id, None, sy: sy + patch, sx: sx + patch],
                            (cfg.batch_size, patch, patch, 3)).copy()
    return (y0, x0), content, coor, cps[ids], style


def _scene(n_views=3, n_styles=4):
    rng = np.random.default_rng(5)
    renders = rng.uniform(0, 1, (n_views, H, W, 3)).astype(np.float32)
    coor = np.concatenate([_coor_maps(_cps())] * 2)[:n_views]
    cps = np.concatenate([_cps()] * 2)[:n_views]
    styles = rng.uniform(0, 1, (n_styles, 512, 512, 3)).astype(np.float32)
    return renders, coor, cps, styles


def test_loop_batches_equal_the_pipelines(params, monkeypatch, tmp_path):
    renders, coor, cps, styles = _scene()
    seen = []

    class Recorder:
        def __init__(self, model, cfg, cam):
            pass

        def __call__(self, state, content, coor, cps, style, origin, seed=0):
            seen.append((origin, content, coor, cps, style, seed))
            return state, {"loss": torch.zeros(())}

    monkeypatch.setattr(tt, "make_temporal_train_step", Recorder)
    cfg = tt.TemporalTrainConfig(batch_size=2, patch=PATCH, max_iter=6)
    tt.run_temporal_finetune(_port(params), renders, coor, cps, styles, (H, W, FOCAL), cfg,
                             seed=7, out_dir=str(tmp_path), device="cpu", log_every=100)
    rng = np.random.default_rng(7)
    for origin, content, c, p, style, seed in seen:
        want = _pipeline_draws(rng, renders, coor, cps, styles, H, W, cfg)
        assert origin == want[0] and seed == 7 + 4
        for got, ref in zip((content, c, p, style), want[1:]):
            assert np.array_equal(got.numpy(), ref)
    assert len(seen) == cfg.max_iter
    # draw_batch on its own follows the same stream
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        batch = tt.draw_batch(a, 756, 1008, 2, 8, (512, 512), tt.TemporalTrainConfig())
        y0, x0 = jtemp.sample_patch(b, 756, 1008, 256)
        ids = b.integers(0, 2, 4)
        sy, sx, s_id = (b.integers(0, 257), b.integers(0, 257), b.integers(0, 8))
        assert batch.origin == (y0, x0) and np.array_equal(batch.ids, ids)
        assert batch.style_origin == (sy, sx) and batch.style_id == s_id


def test_short_run_writes_log_and_debug_pngs(params, tmp_path):
    renders, coor, cps, styles = _scene(2, 2)
    model = _port(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = tt.TemporalTrainConfig(batch_size=2, patch=PATCH, max_iter=2)
    out = tt.run_temporal_finetune(model, renders, coor, cps, styles, (H, W, FOCAL), cfg,
                                   seed=0, out_dir=str(tmp_path), device="cpu", log_every=1)
    assert out is model
    names = sorted(os.listdir(tmp_path))
    want = sorted([f"{n}_{b:03d}.png" for n in tt.DEBUG_IMAGES for b in range(2)]
                  + ["style_image.png", "logs"])
    assert names == want
    lines = (tmp_path / "logs" / "temporal.jsonl").read_text().splitlines()
    assert [eval(line)["step"] for line in lines] == [1, 2]
    moved = {k.split(".")[0] for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    assert moved == {"decode"}
