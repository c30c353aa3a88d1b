"""AdaIN, the reference's alternate 2D path, on the CPU: the port's
network, trainers and CLI tasks (tgtc_torch/models/adain_net.py,
train/adain_trainer.py, tools/train2d.py) against tgtc's on the same
weights (JAX's ``make_adain_net`` through ``adain_state_dicts_from_flax``)
and the same numpy-seeded inputs, f32 on both sides.

* ``stylize`` at alpha 1.0 and 0.5 to 1e-5 of max|JAX| and
  ``compute_losses`` to 1e-5 relative, at image 32, full width.
* Two finetune steps and one temporal step at 16x16 (as
  tests/test_adain_trainer.py) from the same state against JAX's jitted
  steps: losses to 1e-4 relative, every decoder leaf after the steps to
  1e-4 of its norm, the VGG bitwise unchanged. The random VGG's 2x2
  max-pools can hold windows whose two largest inputs lie within f32
  rounding of each other; there the port takes JAX's recorded pick
  (``pools_take_jax_picks``, the pool half of tests/test_torch_c1.py's
  ``port_takes_jax_picks`` on JAX's ``jax_tie_recorder`` records), which
  must be a near-tie on both sides, and the rerouted windows are printed.
* The learning-rate decay: the first update is lr, the tenth lr/10 at decay
  1.0, the VGG's update zero (tests/test_train2d_cli.py:178-200), as JAX's
  ``_decoder_only_tx``.
* ``train2d.main`` runs both AdaIN tasks on tiny directories and writes
  their checkpoints (tests/test_train2d_cli.py:75, :91), resumes, and
  refuses a render count that differs from ``geometry.npz``'s.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tgtc.models.adain_net import make_adain_net as jax_make_adain_net
from tgtc.ops.rasterize import llff_projection_matrix as jax_proj
from tgtc.train import adain_trainer as jt
from tgtc_torch.convert import adain_flax_from_state_dicts, adain_state_dicts_from_flax
from tgtc_torch.models.adain_net import make_adain_net
from tgtc_torch.ops.rasterize import llff_projection_matrix
from tgtc_torch.tools import train2d
from tgtc_torch.train import adain_trainer as ta
from test_torch_c1 import (_as_port, _plain_layout, _top_gap, _windows, jax_tie_recorder, moves,
                           recorded)
from test_torch_temporal import _cps

torch.set_num_threads(1)

TOL_OUT, TOL_LOSS = 1e-5, 1e-5            # the network, f32 on both sides
TOL_STEP_LOSS, TOL_STEP_LEAF = 1e-4, 1e-4  # the steps: relative, of a leaf's norm
SIZE, STEP_SIZE, FOCAL = 32, 16, 15.0
# f32 noise of a VGG input, of the tensor's max: the full-width decoder's
# output differs between the frameworks by up to ~1.3e-5 of its max at
# 16x16, so the VGG pass over it does too (tests/test_torch_c1.py's 1e-5
# holds its narrow decoder)
TIE_NOISE = 5e-5


@pytest.fixture(scope="module")
def jax_net():
    model, params = jax_make_adain_net(jax.random.PRNGKey(0), image_size=SIZE)
    return model, jax.tree.map(np.asarray, params)


def _port(params):
    model = make_adain_net(torch.Generator().manual_seed(0), device="cpu")
    sds = adain_state_dicts_from_flax(params)
    model.vgg.load_state_dict(sds["vgg"])
    model.decode.load_state_dict(sds["decoder"])
    return model


def _images(seed, n, size):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def test_converter_round_trips(jax_net):
    _, params = jax_net
    back = adain_flax_from_state_dicts(adain_state_dicts_from_flax(params))
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat(params))
    got = dict(flat(back))
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_stylize_matches_jax(jax_net, alpha):
    model, params = jax_net
    c, s = _images(1, 2, SIZE), _images(2, 2, SIZE)
    want = np.asarray(jax.jit(lambda p, c, s: model.apply(p, c, s, alpha, method=model.stylize))(
        params, jnp.asarray(c), jnp.asarray(s)))
    with torch.no_grad():
        got = _port(params).stylize(torch.from_numpy(c), torch.from_numpy(s), alpha).numpy()
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    print(f"[parity] AdaIN stylize alpha {alpha}: max|err| / max|JAX| {err:.3e} (tol {TOL_OUT})")
    assert got.shape == want.shape == c.shape and err <= TOL_OUT


def test_compute_losses_match_jax(jax_net):
    model, params = jax_net
    c, s = _images(3, 2, SIZE), _images(4, 2, SIZE)
    want = jax.jit(lambda p, c, s: model.apply(p, c, s, method=model.compute_losses))(
        params, jnp.asarray(c), jnp.asarray(s))
    got = _port(params).compute_losses(torch.from_numpy(c), torch.from_numpy(s))
    rel = {k: _rel(got[k], want[k]) for k in ("loss_c", "loss_s")}
    out = float(np.abs(got["stylized"].detach().numpy() - np.asarray(want["stylized"])).max())
    out /= float(np.abs(np.asarray(want["stylized"])).max())
    print(f"[parity] AdaIN compute_losses: relative {rel}, stylized {out:.3e} (tol {TOL_LOSS})")
    assert max(rel.values()) <= TOL_LOSS and out <= TOL_OUT


def _temporal_inputs():
    """tests/test_adain_trainer.py:41-60's shapes from numpy seeds: content
    and style in [0, 1], and the NDC coor maps of the tilted plane of
    tests/test_torch_temporal.py seen through its two cameras' pixel
    centres, so that view 0's splat lands on view 1's own points."""
    rng = np.random.default_rng(5)
    n = STEP_SIZE
    cps = _cps()
    ys, xs = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5, indexing="ij")
    d_cam = np.stack([(xs - n / 2) / FOCAL, -(ys - n / 2) / FOCAL, -np.ones_like(xs)], -1)
    maps = []
    for c2w in cps.astype(np.float64):
        o, d = c2w[:3, 3], d_cam @ c2w[:3, :3].T
        normal = np.array([0.1, 0.05, 1.0])  # the plane normal · p = -2
        p = o + ((-2.0 - o @ normal) / (d @ normal))[..., None] * d
        maps.append(np.stack([-FOCAL / (n / 2) * p[..., 0] / p[..., 2],
                              -FOCAL / (n / 2) * p[..., 1] / p[..., 2], 1 + 2 / p[..., 2]], -1))
    content, style = (rng.uniform(0, 1, (2, n, n, 3)).astype(np.float32) for _ in range(2))
    return content, np.stack(maps).astype(np.float32), cps, style


def _jax_steps(kind, params, batches):
    """JAX's jitted steps from ``params`` on each batch: the metrics of each
    and the parameters after, with the records of its pools and ReLUs."""
    cfg = jt.AdainTrainConfig()
    model, _ = jax_make_adain_net(jax.random.PRNGKey(0), image_size=STEP_SIZE)
    state = jt.init_adain_train(jax.tree.map(jnp.array, params), cfg)
    runs = []
    with jax_tie_recorder() as seen:
        if kind == "finetune":
            step = jt.make_adain_finetune_step(model, cfg)
        else:
            step = jt.make_adain_temporal_step(
                model, cfg, jnp.asarray(jax_proj(STEP_SIZE, STEP_SIZE, FOCAL)), STEP_SIZE,
                STEP_SIZE, is_ndc=True, focal=FOCAL)
        for batch in batches:
            state, m = step(state, *(jnp.asarray(x) for x in batch))
            runs.append(({k: float(v) for k, v in m.items()}, recorded(seen)))
    return runs, jax.tree.map(np.asarray, state.params)


@contextlib.contextmanager
def pools_take_jax_picks(ties):
    """While open, each VGG max-pool window of the port
    (``tgtc_torch.models.vgg._ceil_pool_nchw``, call ``i`` against JAX's
    recorded call ``i``) routes its gradient where JAX's backward routed it
    (windows whose JAX cotangent is 0 keep the port's pick); its output is
    the port's own value at that element. A window that moves must be a
    near-tie on both sides: its top two within ``TIE_NOISE`` of the tensor's
    max. Yields ``{"pool": [moved windows per call]}``."""
    import torch.nn.functional as F

    import tgtc_torch.models.vgg as tvgg

    moved_count = {"pool": []}

    def pool(x):
        xj, g = ties["pool"][len(moved_count["pool"])]
        ref, g = _as_port(xj, x), _as_port(g, x)
        scale = float(ref.abs().max())
        h, w = x.shape[2] % 2, x.shape[3] % 2
        if h or w:
            x, ref = (F.pad(t, (0, w, 0, h), value=float("-inf")) for t in (x, ref))
            g = F.pad(g, (0, w, 0, h))
        wx, wj, routed = _windows(x), _windows(ref), _windows(g) != 0
        assert int(routed.sum(-1).max()) <= 1  # one element a window
        theirs = routed.to(torch.uint8).argmax(-1)
        moved = routed.any(-1) & (wx.detach().argmax(-1) != theirs)
        moved_count["pool"].append(int(moved.sum()))
        plain = F.max_pool2d(x, 2, 2)
        if not bool(moved.any()):
            return plain
        for gap in (_top_gap(wx.detach())[moved], _top_gap(wj)[moved]):
            assert float(gap.max()) <= TIE_NOISE * scale, float(gap.max()) / scale
        theirs_value = torch.gather(wx, -1, theirs[..., None])[..., 0]
        return _plain_layout(torch.where(moved, theirs_value, plain), plain)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvgg, "_ceil_pool_nchw", pool)
        yield moved_count
    assert len(moved_count["pool"]) == len(ties["pool"])


def _port_steps(kind, params, batches, runs):
    model = _port(params)
    vgg_before = {k: v.clone() for k, v in model.vgg.state_dict().items()}
    cfg = ta.AdainTrainConfig()
    state = ta.init_adain_train(model, cfg)
    if kind == "finetune":
        step = ta.make_adain_finetune_step(model, cfg)
    else:
        proj = torch.from_numpy(llff_projection_matrix(STEP_SIZE, STEP_SIZE, FOCAL))
        step = ta.make_adain_temporal_step(model, cfg, proj, STEP_SIZE, STEP_SIZE, is_ndc=True,
                                           focal=FOCAL)
    for i, (batch, (jm, ties)) in enumerate(zip(batches, runs)):
        with pools_take_jax_picks(ties) as rerouted:
            state, m = step(state, *(torch.from_numpy(x) for x in batch))
        rel = {k: _rel(m[k], jm[k]) for k in jm}
        print(f"[parity] AdaIN {kind} step {i + 1}: losses relative {rel} (tol "
              f"{TOL_STEP_LOSS}); rerouted max-pool windows: "
              f"{moves(rerouted)}")
        assert set(m) == set(jm) and max(rel.values()) <= TOL_STEP_LOSS
    assert state.step == len(batches) and state.scheduler.last_epoch == len(batches)
    assert all(torch.equal(v, vgg_before[k]) for k, v in model.vgg.state_dict().items())
    return model


def _assert_decoder_close(model, j_params, what):
    want = adain_state_dicts_from_flax(j_params)["decoder"]
    worst = 0.0
    for k, v in model.decode.state_dict().items():
        worst = max(worst, float((v.double() - want[k].double()).norm() / want[k].double().norm()))
    print(f"[parity] AdaIN {what}: worst decoder leaf |err| / |leaf| {worst:.3e} "
          f"(tol {TOL_STEP_LEAF})")
    assert worst <= TOL_STEP_LEAF


def test_two_finetune_steps_match_jax(jax_net):
    _, params = jax_net
    batches = [(_images(10 + i, 2, STEP_SIZE), _images(20 + i, 2, STEP_SIZE)) for i in range(2)]
    runs, j_after = _jax_steps("finetune", params, batches)
    model = _port_steps("finetune", params, batches, runs)
    _assert_decoder_close(model, j_after, "two finetune steps")
    j_vgg = adain_state_dicts_from_flax(j_after)["vgg"]
    assert all(torch.equal(v, j_vgg[k]) for k, v in model.vgg.state_dict().items())


def test_temporal_step_matches_jax(jax_net):
    _, params = jax_net
    batch = _temporal_inputs()
    runs, j_after = _jax_steps("temporal", params, [batch])
    assert runs[0][0]["loss_t"] > 0
    model = _port_steps("temporal", params, [batch], runs)
    _assert_decoder_close(model, j_after, "one temporal step")


def test_temporal_step_crops_a_frame_that_is_not_a_multiple_of_8(jax_net):
    """At 20x20 the decoder returns 24x24; the port's temporal term takes
    the 20x20 crop, where JAX's step fails on the mismatched shapes."""
    _, params = jax_net
    n = 20
    rng = np.random.default_rng(6)
    content, style = (rng.uniform(0, 1, (2, n, n, 3)).astype(np.float32) for _ in range(2))
    coor = (rng.uniform(0, 1, (2, n, n, 3)) * 0.4 - np.array([0.2, 0.2, 2.5])).astype(np.float32)
    cps = np.stack([np.eye(4, dtype=np.float32)] * 2)
    model, _ = jax_make_adain_net(jax.random.PRNGKey(0), image_size=n)
    cfg = jt.AdainTrainConfig()
    j_step = jt.make_adain_temporal_step(model, cfg, jnp.asarray(jax_proj(n, n, FOCAL)), n, n,
                                         is_ndc=False, focal=FOCAL)
    with pytest.raises((TypeError, ValueError)):
        j_step(jt.init_adain_train(jax.tree.map(jnp.array, params), cfg),
               *(jnp.asarray(x) for x in (content, coor, cps, style)))
    port = _port(params)
    state = ta.init_adain_train(port, ta.AdainTrainConfig())
    step = ta.make_adain_temporal_step(port, ta.AdainTrainConfig(),
                                       torch.from_numpy(llff_projection_matrix(n, n, FOCAL)), n,
                                       n, is_ndc=False, focal=FOCAL)
    assert port.compute_losses(*(torch.from_numpy(x) for x in (content, style)))[
        "stylized"].shape == (2, 24, 24, 3)
    state, m = step(state, *(torch.from_numpy(x) for x in (content, coor, cps, style)))
    assert state.step == 1 and all(bool(torch.isfinite(v)) for v in m.values())


def test_lr_decay_and_frozen_vgg_match_jax():
    """With a constant gradient Adam's update is the learning rate: lr at
    the first update, lr / 10 at the tenth under decay 1.0; the VGG takes
    no update and is in no parameter group."""
    cfg = ta.AdainTrainConfig(lr=1e-4, lr_decay=1.0)
    model = make_adain_net(torch.Generator().manual_seed(0), device="cpu")
    state = ta.init_adain_train(model, cfg)
    step = ta.make_adain_finetune_step(model, cfg)
    grouped = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert grouped == {id(p) for p in model.decode.parameters()}
    assert not any(p.requires_grad for p in model.vgg.parameters())
    vgg = {k: v.clone() for k, v in model.vgg.state_dict().items()}
    w = model.decode[1].weight
    mags = []
    for _ in range(10):
        before = float(w[0, 0, 0, 0])
        step.apply(state, [torch.ones_like(p) for p in ta.decoder_parameters(model)])
        mags.append(abs(float(w[0, 0, 0, 0]) - before))
    assert all(torch.equal(v, vgg[k]) for k, v in model.vgg.state_dict().items())

    tx = jt._decoder_only_tx(jt.AdainTrainConfig(lr=1e-4, lr_decay=1.0))
    params = {"params": {"decode": {"w": jnp.ones((2,))}, "vgg": {"w": jnp.ones((2,))}}}
    st = tx.init(params)
    want = []
    for _ in range(10):
        upd, st = tx.update(params, st, params)
        want.append(float(jnp.abs(upd["params"]["decode"]["w"][0])))
        assert float(jnp.abs(upd["params"]["vgg"]["w"][0])) == 0.0
    assert mags[0] == pytest.approx(1e-4, rel=1e-3) and mags[9] == pytest.approx(1e-5, rel=1e-3)
    np.testing.assert_allclose(mags, want, rtol=1e-3)


def _write_images(d, n, size, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)).save(
            os.path.join(d, f"img_{i:03d}.png"))


def _geometry(d, n_maps, size=STEP_SIZE):
    rng = np.random.default_rng(0)
    coor = (rng.uniform(size=(n_maps, size, size, 3)) * 0.4).astype(np.float32)
    coor[..., 2] -= 2.5
    np.savez(os.path.join(d, "geometry.npz"), coor_maps=coor,
             cps=np.stack([np.eye(4, dtype=np.float32)] * n_maps),
             hwf=np.array([size, size, FOCAL], np.float32))


def _argv(tmp_path, task):
    for d, seed in (("content", 1), ("style", 2)):
        _write_images(str(tmp_path / d), 3, 40, seed)
    gen = tmp_path / "gen"
    _write_images(str(gen), 3, STEP_SIZE, 3)
    Image.fromarray(np.zeros((STEP_SIZE, STEP_SIZE, 3), np.uint8)).save(gen / "depth_000.png")
    return ["--task", task, "--content_dir", str(tmp_path / "content"),
            "--nerf_content_dir", str(gen), "--no_ndc", "--style_dir", str(tmp_path / "style"),
            "--save_dir", str(tmp_path / "save"), "--log_dir", str(tmp_path / "log"),
            "--max_iter", "2", "--batch_size", "2", "--patch", "32", "--print_interval", "1",
            "--save_model_interval", "1", "--n_threads", "2", "--vgg", "", "--decoder", ""]


@pytest.mark.parametrize("task, ckpt_dir", [("finetune_decoder", "adain_decoder"),
                                            ("temporal_decoder", "adain_temporal")])
def test_adain_tasks_run_and_write_checkpoints(tmp_path, task, ckpt_dir):
    argv = _argv(tmp_path, task)
    _geometry(str(tmp_path / "gen"), 3)
    assert train2d.main(argv, device="cpu") == 0
    save = tmp_path / "save" / ckpt_dir
    assert sorted(os.listdir(save)) == ["ckpt_00000001.pt", "ckpt_00000002.pt"]
    ckpt = torch.load(save / "ckpt_00000002.pt", weights_only=False)
    assert ckpt["step"] == 2 and set(ckpt["model"]) == set(
        make_adain_net(device="cpu", generator=torch.Generator()).state_dict())
    # resumes at step 2
    argv[argv.index("--max_iter") + 1] = "3"
    assert train2d.main(argv, device="cpu") == 0
    lines = (tmp_path / "log" / f"{task}.jsonl").read_text().splitlines()
    assert [eval(line.replace("NaN", "0"))["step"] for line in lines] == [1, 2, 3]
    assert (save / "ckpt_00000003.pt").exists()


def test_temporal_task_refuses_a_count_mismatch(tmp_path):
    argv = _argv(tmp_path, "temporal_decoder")
    _geometry(str(tmp_path / "gen"), 2)  # 2 maps for 3 renders
    with pytest.raises(ValueError, match="misalign"):
        train2d.main(argv, device="cpu")
    assert not (tmp_path / "save" / "adain_temporal").exists()
