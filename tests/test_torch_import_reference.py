"""Importing a reference experiment (tgtc_torch/tools/import_reference.py):
the newest NeRF, style and latent ``.tar`` files, written here in the
reference's layout as tests/test_import_reference.py:19-61 writes them,
become the port's ``ckpt_nerf`` and ``ckpt_style``; the port's pipeline
resumes from them with no Phase-A step and the tars' weights; and the same
tars through the JAX package's importer, converted by ``tgtc_torch.convert``,
give the same weights bit for bit."""

import os

import jax
import numpy as np
import pytest
import torch

from tgtc.config import Config as JaxConfig
from tgtc_torch.config import Config
from tgtc_torch.models.nerf import NerfConfig, make_nerf
from tgtc_torch.models.style_field import StyleFieldConfig, make_style_mlps
from tgtc_torch.tools.import_reference import _newest, import_reference_checkpoints, main
from tgtc_torch.train import pipeline as P

torch.set_num_threads(1)

KW = dict(expname="imp", factor=1.0, netdepth=2, netwidth=16, netdepth_fine=2,
          netwidth_fine=16, embed_freq_coor=2, embed_freq_dir=1, use_viewdir=True,
          N_samples=4, N_samples_fine=4, batch_size=64, batch_size_style=32,
          origin_step=77, style_D=4, vae_latent=8, sigma_noise_std=0.0, use_pallas=False)
NERF = NerfConfig(depth=2, width=16, embed_freq_coor=2, embed_freq_dir=1, use_viewdir=True)
FIELD = StyleFieldConfig(style_d=4, width=16, latent_dim=8, embed_dim=NERF.input_ch)
S, F = 2, 3


@pytest.fixture()
def ref_dir(tmp_path):
    """Reference tars: two NeRF steps (the newest wins), the fine net's
    keys under ``net.``, and a style/latent pair at step 123."""
    g = torch.Generator().manual_seed(42)
    d = tmp_path / "ref_logs"
    d.mkdir()
    nets = {}
    for step in (33, 77):
        coarse, fine = (make_nerf(NERF, g, device="cpu").state_dict() for _ in range(2))
        nets[step] = (coarse, fine)
        torch.save({"global_step": step, "model": coarse,
                    "model_fine": {f"net.{k}": v for k, v in fine.items()},
                    "optimizer_state_dict": {}}, d / f"{step:06d}.tar")
    concat, style = (m.state_dict() for m in make_style_mlps(FIELD, g, device="cpu"))
    lat = {"latents": torch.randn(S, F, 8, generator=g),
           "style_latents_mu": torch.randn(S, 8, generator=g),
           "style_latents_logvar": torch.randn(S, 8, generator=g)}
    torch.save({"model": style, "concat_model": concat}, d / "style_000123.tar")
    torch.save({"train_set_1": lat}, d / "latent_000123.tar")
    return str(d), nets[77], (concat, style, lat)


def _equal_sd(a, b):
    return set(a) == set(b) and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def test_newest_follows_the_reference_rules(ref_dir):
    d, _, _ = ref_dir
    assert os.path.basename(_newest(d, excludes=["style", "latent"])) == "000077.tar"
    assert os.path.basename(_newest(d, contains="style")) == "style_000123.tar"
    assert _newest(d, contains="nothing") is None


def test_import_then_the_pipeline_resumes_without_a_step(ref_dir, synthetic_llff_dir,
                                                         tmp_path):
    from tgtc_torch.train.style3d import load_style_field

    d, (coarse, fine), (concat, style, lat) = ref_dir
    cfg = Config(**KW, basedir=str(tmp_path / "logs"), datadir=synthetic_llff_dir,
                 styledir=str(tmp_path))
    assert import_reference_checkpoints(cfg, d, device="cpu") == {"nerf_step": 77,
                                                                  "style_step": 123}
    pipe = P.Pipeline(cfg, device="cpu")
    try:
        state, _ = pipe._nerf_setup()
        assert state.step == 77
        assert _equal_sd(state.coarse.state_dict(), coarse)
        assert _equal_sd(state.fine.state_dict(), fine)
        pipe.train_nerf()  # origin_step 77: nothing to train
        assert pipe.nerf_ckpt.steps() == [77]
        assert not os.path.exists(os.path.join(pipe.log_dir, "nerf.jsonl"))
        assert pipe.style_ckpt.latest_step() == 123
        c, s, latent_state = load_style_field(os.path.join(pipe.exp_dir, "ckpt_style"), FIELD,
                                              device="cpu")
        assert _equal_sd(c.state_dict(), concat) and _equal_sd(s.state_dict(), style)
        for ours, theirs in (("latents", "latents"), ("mu", "style_latents_mu"),
                             ("logvar", "style_latents_logvar")):
            assert torch.equal(latent_state[ours], lat[theirs])
    finally:
        pipe.close()


def test_the_same_tars_through_jax_give_the_same_weights(ref_dir, synthetic_llff_dir,
                                                        tmp_path):
    from tgtc.models.style_field import StyleFieldConfig as JaxField
    from tgtc.tools.import_reference import import_reference_checkpoints as jax_import
    from tgtc.train.pipeline import Pipeline as JaxPipeline
    from tgtc.train.style3d import StyleTrainConfig, init_style_state
    from tgtc_torch.convert import nerf_state_dict_from_flax, style_state_dicts_from_flax
    from tgtc_torch.train.style3d import load_style_field

    d, _, _ = ref_dir
    common = dict(KW, datadir=synthetic_llff_dir, styledir=str(tmp_path))
    jcfg = JaxConfig(**common, basedir=str(tmp_path / "jax"))
    pcfg = Config(**common, basedir=str(tmp_path / "port"))
    assert jax_import(jcfg, d) == {"nerf_step": 77, "style_step": 123}
    flags = [f"--{k}={v}" for k, v in KW.items() if not isinstance(v, bool)]
    assert main(["--ref_dir", d, "--basedir", pcfg.basedir, "--use_viewdir", *flags],
                device="cpu") == 0
    jp = JaxPipeline(jcfg)
    pp = P.Pipeline(pcfg, device="cpu")
    try:
        _, _, js, _ = jp._nerf_setup()
        state, _ = pp._nerf_setup()
        assert int(js.step) == state.step == 77
        np_tree = lambda t: jax.tree.map(np.asarray, t)
        assert _equal_sd(nerf_state_dict_from_flax(np_tree(js.params_coarse)),
                         state.coarse.state_dict())
        assert _equal_sd(nerf_state_dict_from_flax(np_tree(js.params_fine)),
                         state.fine.state_dict())
        field = JaxField(style_d=4, width=16, latent_dim=8, embed_dim=NERF.input_ch)
        _, _, st = init_style_state(jax.random.PRNGKey(0), field,
                                    StyleTrainConfig(batch_size=32), style_num=S, frame_num=F)
        st = jp.style_ckpt.restore(st)
        assert int(st.step) == pp.style_ckpt.latest_step() == 123
        c, s, latent_state = load_style_field(os.path.join(pp.exp_dir, "ckpt_style"), FIELD,
                                              device="cpu")
        jc, js_ = style_state_dicts_from_flax(np_tree(
            {"concat": st.params["concat"], "style": st.params["style"]}))
        assert _equal_sd(jc, c.state_dict()) and _equal_sd(js_, s.state_dict())
        for k, v in (("latents", st.params["latents"]), ("mu", st.mu), ("logvar", st.logvar)):
            assert torch.equal(latent_state[k], torch.from_numpy(np.array(v)))
    finally:
        jp.close()
        pp.close()
