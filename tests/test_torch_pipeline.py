"""The port's phase machine (tgtc_torch/train/pipeline.py) against the JAX
``Pipeline`` (tgtc/train/pipeline.py), on the CPU at a tiny size.

* The derived configuration and the directory layout equal the JAX
  pipeline's exactly, for three configurations (fern's file among them).
* One tiny NeRF trained and saved by the JAX pipeline, converted into the
  port's ``ckpt_nerf``: with f32 trunks both ``evaluate()`` agree within
  1e-3 dB and both ``render_plain("train")`` write PNGs within one uint8
  level on at least 99.9% of the pixels; with the default bf16 trunks, whose
  rounding differs between the two frameworks, ``evaluate()`` agrees within
  0.1 dB (see ``TOL_PSNR_DB``).
* A→F through the port's pipeline at the JAX end-to-end test's config
  (tests/test_pipeline_e2e.py) writes the artifacts that test asserts, and a
  second ``run()`` trains nothing. C1 and C2 run their full-size VGG on
  256² crops; to keep the file inside its time here the test swaps the
  pipeline module's ``TransformerTrainConfig`` and ``TemporalTrainConfig``
  for ones with batch 2 and 32² crops.
* The proposal levers construct, reach their phases as in the JAX
  pipeline, and exclude each other where JAX's do (``--proposal_width`` with
  ``--sigma_grid``); a multi-process launch reaches the multi-process
  schedule (its group creation and Phase A stubbed here; the schedule itself
  runs in tests/test_torch_multiprocess.py), where the render flags raise.
* ``render_plain`` with the fast stack (a distilled proposal, or a density
  grid, with ``fine_budget`` and ``coarse_share``; the fused renderer's
  twins forced on the CPU) writes its PNGs.
"""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tgtc.config import Config as JaxConfig
from tgtc.config import load_config as jax_load_config
from tgtc.train.pipeline import Pipeline as JaxPipeline
from tgtc_torch.config import Config
from tgtc_torch.config import load_config
from tgtc_torch.models.transformer import TransformerConfig
from tgtc_torch.train import pipeline as P
from tgtc_torch.train.style3d import style_train_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_pipeline_e2e.py:31-45
E2E = dict(expname="smoke", factor=1.0, use_viewdir=True, netdepth=2, netwidth=32,
           netdepth_fine=2, netwidth_fine=32, embed_freq_coor=2, embed_freq_dir=1,
           N_samples=4, N_samples_fine=4, batch_size=128, batch_size_style=32,
           origin_step=25, total_step=35, style_D=4, vae_latent=8, vae_w=16, vae_d=2,
           style_feature_dim=64, i_print=10, sigma_noise_std=0.0, use_pallas=False)
TOL_PNG_LEVELS, TOL_PNG_SHARE = 1, 0.999


@pytest.fixture(scope="module")
def style_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("styles")
    rng = np.random.default_rng(7)
    Image.fromarray((rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)).save(
        d / "style0.png")
    return str(d)


def _pair(**kw):
    return JaxConfig(**kw), Config(**kw)


def _configs(scene, styles, tmp):
    base = dict(basedir=str(tmp / "logs"), datadir=scene, styledir=styles)
    fern = ["--config", os.path.join(REPO, "configs", "fern.txt"), "--datadir", scene,
            "--styledir", styles, "--basedir", str(tmp / "fern")]
    return {"e2e": _pair(**base, **E2E),
            "no_ndc": _pair(**base, **E2E | dict(no_ndc=True, chunk=5000, ckp_num=2,
                                                 netdepth_fine=3, netwidth_fine=16)),
            "fern": (jax_load_config(fern), load_config(fern))}


def _nerf_fields(c):
    return (c.depth, c.width, c.embed_freq_coor, c.embed_freq_dir, c.use_viewdir, c.act_type,
            c.siren_sigma_mul, tuple(c.skips), c.input_ch, c.input_ch_viewdir)


def _jax_style_train_config(cfg, near, far):
    """The StyleTrainConfig tgtc/train/pipeline.py:744-763 builds."""
    from tgtc.train.nerf_trainer import parse_budget_schedule
    from tgtc.train.style3d import StyleTrainConfig

    return StyleTrainConfig(
        batch_size=cfg.batch_size_style, n_samples=cfg.N_samples,
        n_samples_fine=cfg.N_samples_fine, near=near, far=far,
        sigma_noise_std=cfg.sigma_noise_std, lrate=cfg.lrate,
        rgb_loss_lambda=cfg.rgb_loss_lambda, logp_loss_lambda=cfg.logp_loss_lambda,
        logp_loss_decay=cfg.logp_loss_decay, loss_coh_lambda=cfg.loss_coh_lambda,
        sigma_scale=cfg.sigma_scale, origin_step=cfg.origin_step,
        dataset_type=cfg.dataset_type,
        coh_until_step=(cfg.coh_until_step if cfg.coh_until_step >= 0
                        else cfg.origin_step + 1999),
        fine_budget=parse_budget_schedule(cfg.train_fine_budget)[-1][1])


@pytest.mark.parametrize("which", ["e2e", "no_ndc", "fern"])
def test_derived_configuration_and_layout_equal_jax(which, private_llff_dir, style_dir,
                                                    tmp_path):
    jcfg, pcfg = _configs(private_llff_dir, style_dir, tmp_path)[which]
    jp, pp = JaxPipeline(jcfg), P.Pipeline(pcfg, device="cpu")
    try:
        assert (pp.near, pp.far) == (jp.near, jp.far)
        assert pp.scene.hwf == jp.scene.hwf
        assert pp.scene.i_test == jp.scene.i_test
        assert _nerf_fields(pp.nerf_cfg) == _nerf_fields(jp.nerf_cfg)
        assert _nerf_fields(pp.nerf_cfg_fine) == _nerf_fields(jp.nerf_cfg_fine)
        for name in ("exp_dir", "gen_dir", "stylized_dir", "vae_iters", "vae_patch",
                     "_render_block"):
            assert getattr(pp, name) == getattr(jp, name), name
        for name in ("nerf_ckpt", "trans_ckpt", "style_ckpt", "vae_ckpt"):
            pm, jm = getattr(pp, name), getattr(jp, name)
            assert pm._dir == jm._dir, name
            assert pm._keep == jm._mgr._options.max_to_keep, name
        if which == "fern":  # the JAX layout's string, with a float factor
            assert pp.stylized_dir.endswith("stylized_gen_4.0")
        # the 2D stack on the CPU: f32 with the eager attention on both
        t = pp.trans_cfg
        assert (t.d_model, t.nhead, t.num_encoder_layers, t.num_decoder_layers,
                t.dim_feedforward, t.dropout) == (
            jp.trans_cfg.d_model, jp.trans_cfg.nhead, jp.trans_cfg.num_encoder_layers,
            jp.trans_cfg.num_decoder_layers, jp.trans_cfg.dim_feedforward,
            jp.trans_cfg.dropout)
        assert (t.dtype, t.attn_impl) == (torch.float32, jp.trans_cfg.attn_impl) == (
            torch.float32, "xla")
        want = dataclasses.asdict(_jax_style_train_config(jcfg, jp.near, jp.far))
        got = dataclasses.asdict(style_train_config(pcfg, pp.near, pp.far))
        assert got == {k: want[k] for k in got}
        assert not pp._fused_render_ok() and not pp._fused_style_ok()  # the CPU
    finally:
        jp.close()
        pp.close()


def _read(path):
    return np.asarray(Image.open(path).convert("RGB"), np.int16)


@pytest.fixture(scope="module")
def jax_trained(synthetic_llff_dir, style_dir, tmp_path_factory):
    """A tiny NeRF trained 20 steps by the JAX pipeline: its config and
    its ``ckpt_nerf``."""
    root = tmp_path_factory.mktemp("jax_nerf")
    # 4,096-ray render blocks (fern's chunk is 32,768): a view has 1,280 rays
    kw = dict(E2E, origin_step=20, chunk=4096, datadir=synthetic_llff_dir,
              styledir=style_dir)
    jp = JaxPipeline(JaxConfig(**kw, basedir=str(root)))
    jp.train_nerf()
    jp.close()
    return kw, str(root)


# evaluate()'s tolerance per trunk compute type. The same f32 math agrees to
# 1e-3 dB (measured ~1e-6) and its PNGs within one level everywhere. The
# default bf16 trunks round differently in the two frameworks (the trunks'
# bf16 parity, tests/test_torch_nerf.py): the PSNR moved by 1.1e-2-2.3e-2 dB
# in rehearsals at 20 steps (5.0e-2 at 200), and at 20 steps 2 of a view's
# 1,280 rays take their whole weight on the 1e10 last interval on one side
# and none on the other (a last-sample σ within bf16 rounding of 0, the
# exemption of chip_smoke.py's phase 2), so their PNGs are compared in f32.
TOL_PSNR_DB = {"f32": 1e-3, "bf16": 1e-1}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_evaluate_and_plain_renders_match_jax_on_the_same_weights(dtype, jax_trained,
                                                                  tmp_path):
    import jax.numpy as jnp

    from tgtc_torch.convert import nerf_train_state_from_jax

    kw, jax_root = jax_trained
    jp = JaxPipeline(JaxConfig(**kw, basedir=jax_root))
    pp = P.Pipeline(Config(**kw, basedir=str(tmp_path / "port")), device="cpu")
    if dtype == "f32":
        for pipe, dt in ((jp, jnp.float32), (pp, torch.float32)):
            pipe.nerf_cfg = dataclasses.replace(pipe.nerf_cfg, compute_dtype=dt)
            pipe.nerf_cfg_fine = dataclasses.replace(pipe.nerf_cfg_fine, compute_dtype=dt)
    _, _, js, _ = jp._nerf_setup()
    assert int(js.step) == 20
    adam = js.opt_state[0]
    state = nerf_train_state_from_jax(
        int(js.step), *(jax.tree.map(np.asarray, t) for t in (js.params_coarse,
                                                              js.params_fine)),
        int(adam.count), jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        pp.nerf_cfg, pp._nerf_train_cfg(), pp.nerf_cfg_fine, device="cpu")
    pp.nerf_ckpt.save(state.step, state.state_dict())
    out = tmp_path / "jax_renders"
    try:
        psnr_j, psnr_p = jp.evaluate(), pp.evaluate()
        print(f"parity evaluate ({dtype} trunks): jax {psnr_j:.6f} dB, port {psnr_p:.6f} dB, "
              f"|diff| {abs(psnr_j - psnr_p):.3e} (tol {TOL_PSNR_DB[dtype]})")
        assert abs(psnr_j - psnr_p) <= TOL_PSNR_DB[dtype]
        lines = [json.loads(x) for x in open(os.path.join(pp.log_dir, "train.jsonl"))]
        assert lines[-1]["step"] == 20 and lines[-1]["holdout_view"] == pp.scene.i_test

        if dtype == "bf16":
            return
        # each pipeline renders into its own run directory
        jp.exp_dir = str(out)
        dj, dp = jp.render_plain("train"), pp.render_plain("train")
        names = sorted(f for f in os.listdir(dj) if f.endswith(".png"))
        assert names == sorted(f for f in os.listdir(dp) if f.endswith(".png"))
        assert len(names) == 2 * pp.scene.poses.shape[0]
        worst = 1.0
        for f in names:
            d = np.abs(_read(os.path.join(dj, f)) - _read(os.path.join(dp, f)))
            share = float((d <= TOL_PNG_LEVELS).mean())
            worst = min(worst, share)
            assert share >= TOL_PNG_SHARE, (f, int(d.max()), share)
        print(f"parity render_plain (f32 trunks): {len(names)} PNGs, the worst within "
              f"{TOL_PNG_LEVELS} level on {worst:.5f} of its pixels (tol {TOL_PNG_SHARE})")
        assert os.path.exists(os.path.join(dp, "video.gif"))
    finally:
        jp.close()
        pp.close()


def _ckpt_steps(pipe):
    out = {}
    for d in ("ckpt_nerf", "ckpt_trans", "ckpt_trans_c2", "ckpt_vae", "ckpt_style"):
        path = os.path.join(pipe.exp_dir, d)
        out[d] = sorted(os.listdir(path)) if os.path.isdir(path) else None
    return out


def _log_lines(pipe):
    return {f: len(open(os.path.join(pipe.log_dir, f)).readlines())
            for f in sorted(os.listdir(pipe.log_dir)) if f.endswith(".jsonl")}


def test_a_to_f_on_the_cpu_then_a_second_run_trains_nothing(private_llff_dir, style_dir,
                                                            tmp_path, monkeypatch):
    # small C1/C2 batches and crops: the full-size VGG on 256² crops takes
    # minutes on one CPU thread (see the module docstring)
    for name in ("TransformerTrainConfig", "TemporalTrainConfig"):
        monkeypatch.setattr(P, name, functools.partial(getattr(P, name), batch_size=2,
                                                       patch=32))
    cfg = Config(**E2E, basedir=str(tmp_path / "logs"), datadir=private_llff_dir,
                 styledir=style_dir)
    pipe = P.Pipeline(cfg, device="cpu")
    # the JAX test's hooks (tests/test_pipeline_e2e.py:48-53, :65)
    pipe.trans_cfg = TransformerConfig(d_model=32, nhead=2, num_encoder_layers=1,
                                       num_decoder_layers=1, dim_feedforward=32, dropout=0.0)
    pipe.vae_iters = 3
    pipe.vae_patch = 32

    pipe.train_nerf()
    assert pipe.nerf_ckpt.latest_step() == 25
    pipe.ensure_geometry()
    assert os.path.exists(os.path.join(pipe.gen_dir, "geometry.npz"))
    assert os.path.exists(os.path.join(pipe.gen_dir, "rgb_00000.png"))
    pipe.ensure_style2d(c1_iters=3, c2_iters=2)
    assert os.path.exists(os.path.join(pipe.stylized_dir, "stylized_data.npz"))
    assert os.path.exists(os.path.join(pipe.stylized_dir, "001.jpg"))
    assert os.path.exists(os.path.join(pipe.exp_dir, "test", "3.png"))
    for name in ("stylized_content", "warped_stylized_content", "warped_mask",
                 "coor_dist_msk"):
        assert os.path.exists(os.path.join(pipe.exp_dir, f"{name}_000.png")), name
    assert os.path.exists(os.path.join(pipe.exp_dir, "style_image.png"))
    assert pipe.trans_ckpt.latest_step() == 3
    pipe.train_style3d()
    assert pipe.vae_ckpt.latest_step() == 3
    assert pipe.style_ckpt.latest_step() == 35
    out_dir = pipe.render_stylized("train")
    n_views = pipe.scene.poses.shape[0]
    for f in range(n_views):
        for name in (f"style_00000_fine_{f:05d}.png", f"style_00000_fine_depth_{f:05d}.png"):
            assert os.path.exists(os.path.join(out_dir, name)), name
    assert os.path.exists(os.path.join(out_dir, "video.gif"))
    pipe.close()
    steps = _ckpt_steps(pipe)
    assert steps["ckpt_trans_c2"] == ["ckpt_00000002.pt"]
    lines = _log_lines(pipe)

    again = P.Pipeline(cfg, device="cpu")
    again.run()  # A → E: every phase finds its work done
    again.close()
    assert _ckpt_steps(again) == steps
    after = _log_lines(again)
    assert after.pop("train.jsonl") == lines.pop("train.jsonl") + 1  # evaluate's EVAL line
    assert after == lines


def test_unported_options_raise_naming_their_item(synthetic_llff_dir, style_dir, tmp_path,
                                                  monkeypatch, capsys):
    """The proposal levers, once refused, construct and reach their phases;
    the two frozen-density proposals exclude each other; a multi-process
    launch, once refused, reaches ``_run_multihost`` (which joins the group
    and trains Phase A over it, both stubbed here), where a render flag
    raises ``RuntimeError``."""
    base = dict(E2E, basedir=str(tmp_path), datadir=synthetic_llff_dir, styledir=style_dir)
    for option, value in (("sigma_grid", 8), ("proposal_width", 128), ("fine_budget", 6),
                          ("coarse_share", 2), ("train_fine_budget", "6@10")):
        pipe = P.Pipeline(Config(**base, **{option: value}), device="cpu")
        try:
            assert getattr(pipe.cfg, option) == value
            assert style_train_config(pipe.cfg, pipe.near, pipe.far).fine_budget == (
                6 if option == "train_fine_budget" else None)
        finally:
            pipe.close()
    monkeypatch.setattr(P.Pipeline, "_fused_render_ok", lambda self, levers=False: True)
    both = P.Pipeline(Config(**base, sigma_grid=8, proposal_width=128), device="cpu")
    try:
        with pytest.raises(ValueError, match="pick one"):
            both.render_plain("train")
    finally:
        both.close()
    monkeypatch.undo()
    pipe = P.Pipeline(Config(**base), device="cpu")
    joined, trained = [], []
    try:
        for env in ({"TGTC_COORDINATOR": "localhost:1234", "TGTC_NUM_PROCESSES": "2",
                     "TGTC_PROCESS_ID": "0"},
                    {"MASTER_ADDR": "localhost", "MASTER_PORT": "1234", "WORLD_SIZE": "4",
                     "RANK": "1"},
                    {"TGTC_DISTRIBUTED": "1"}):
            assert P.multi_process_launch(env)
            with monkeypatch.context() as m:
                for k, v in env.items():
                    m.setenv(k, v)
                m.setattr(P, "maybe_initialize_distributed",
                          lambda device=None: joined.append(device))
                m.setattr(P.DataGroup, "world_group", classmethod(lambda cls: cls()))
                m.setattr(P.Pipeline, "train_nerf", lambda self: trained.append(self.group))
                capsys.readouterr()
                pipe.run()
                assert "Run phases B-D single-process" in capsys.readouterr().out
                cfg = pipe.cfg
                for flag in ("render_valid", "render_train", "render_valid_style",
                             "render_train_style"):
                    m.setattr(pipe, "cfg", dataclasses.replace(cfg, **{flag: True}))
                    with pytest.raises(RuntimeError, match="single-process"):
                        pipe.run()
        assert joined == [torch.device("cpu")] * 3 and len(trained) == 3
        assert not P.multi_process_launch({"WORLD_SIZE": "1", "MASTER_ADDR": "x",
                                           "MASTER_PORT": "1", "RANK": "0"})
        assert not P.multi_process_launch({"WORLD_SIZE": "4"})  # incomplete: no cluster
    finally:
        pipe.close()
    assert not os.path.exists(os.path.join(pipe.exp_dir, "ckpt_nerf", "ckpt_00000025.pt"))


@pytest.mark.parametrize("proposal", [dict(proposal_width=128, proposal_steps=5),
                                      dict(sigma_grid=8)])
def test_render_plain_with_the_fast_stack_writes_its_pngs(synthetic_llff_dir, style_dir,
                                                          tmp_path, monkeypatch, capsys,
                                                          proposal):
    """``render_plain`` through the fused renderer (its kernels' twins: the
    eligibility check forced, as on the card) with a distilled proposal or a
    density grid, ``fine_budget`` 6 of 8 and ``coarse_share`` 2."""
    monkeypatch.setattr(P.Pipeline, "_fused_render_ok", lambda self, levers=False: True)
    cfg = Config(**E2E, basedir=str(tmp_path), datadir=synthetic_llff_dir, styledir=style_dir,
                 fine_budget=6, coarse_share=2, **proposal)
    pipe = P.Pipeline(cfg, device="cpu")
    try:
        out = pipe.render_plain("train")
        again = pipe._nerf_renderer(*pipe._nerf_setup(), levers=True)
    finally:
        pipe.close()
    n = pipe.scene.poses.shape[0]
    names = sorted(os.listdir(out))
    assert [f for f in names if f.startswith("rgb_")] == [f"rgb_{i:05d}.png" for i in range(n)]
    assert len([f for f in names if f.startswith("depth_")]) == n
    h, w, _ = pipe.scene.hwf
    assert np.asarray(Image.open(os.path.join(out, "rgb_00000.png"))).shape == (h, w, 3)
    printed = capsys.readouterr().out
    what = "[proposal] distilled D2xW128" if "proposal_width" in proposal else "[grid] 8^3"
    assert printed.count(what) == 1  # built once a process
    assert (again.fine_budget, again.coarse_share) == (6, 2)
    if "proposal_width" in proposal:
        assert (again.packed_coarse.depth, again.packed_coarse.width) == (2, 128)
    else:
        assert again.sigma_grid[0].shape == (8, 8, 8)
