"""The phase loops the pipeline shares with the standalone tools, at the
pipeline's settings, on the CPU at a tiny size:

* ``train/nerf_trainer.train_nerf`` with the pipeline's checkpoint
  directory, ``max_to_keep``, ``reload`` and ``profile_dir`` (its defaults,
  ``nerf_ckpt`` and 3, are tests/test_torch_train_loop.py's);
* ``train/transformer2d.train_transformer``, the C1 loop of both
  ``tools/train2d`` and ``Pipeline.ensure_style2d``, with its own log and
  save intervals and seeds;
* ``train/vae_trainer.train_vae`` with ``fit_dim`` to a
  ``style_feature_dim`` other than 1,024, saving only at its end, as
  ``Pipeline.ensure_vae`` runs it (``train2d --task vae`` keeps 1,024:
  tests/test_torch_vae.py).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from synthetic_scene import make_synthetic_llff_scene
from tgtc_torch.data.llff import load_llff_data
from tgtc_torch.models.nerf import NerfConfig
from tgtc_torch.train import nerf_trainer as tt
from tgtc_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

TINY = NerfConfig(depth=2, width=16, embed_freq_coor=2, embed_freq_dir=1)
TCFG = tt.NerfTrainConfig(batch_size=64, n_samples=4, n_samples_fine=4, sigma_noise_std=0.0)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return load_llff_data(make_synthetic_llff_scene(tmp_path_factory.mktemp("scene")), factor=1)


def _lines(path):
    return [json.loads(x) for x in open(path)]


def test_train_nerf_checkpoint_directory_keep_count_and_reload(scene, tmp_path):
    out = str(tmp_path)
    kw = dict(out_dir=out, seed=3, i_print=100, device="cpu", print_fn=None,
              ckpt_dir="ckpt_nerf", max_to_keep=2)
    for steps in (3, 6, 9):
        state, hist = tt.train_nerf(scene, TINY, TCFG, steps, **kw)
        assert state.step == steps and len(hist["loss"]) == 3
    assert CheckpointManager(os.path.join(out, "ckpt_nerf")).steps() == [6, 9]
    assert not os.path.exists(os.path.join(out, "nerf_ckpt"))
    assert [r["step"] for r in _lines(os.path.join(out, "logs", "nerf.jsonl"))] == [3, 6, 9]
    # reload=False starts again from the seed's state and overwrites nothing older
    state, hist = tt.train_nerf(scene, TINY, TCFG, 2, reload=False, **kw)
    assert state.step == 2 and len(hist["loss"]) == 2
    assert CheckpointManager(os.path.join(out, "ckpt_nerf")).steps() == [6, 9]  # keeps the newest


def test_train_nerf_profile_dir_traces_the_first_steps(scene, tmp_path):
    prof = tmp_path / "prof"
    state, _ = tt.train_nerf(scene, TINY, TCFG, 3, str(tmp_path), seed=0, device="cpu",
                             print_fn=None, profile_dir=str(prof))
    assert state.step == 3
    trace = json.loads((prof / "phase_a.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert any("aten::" in n for n in names)
    # each step's phases by name, the step drawing its own randoms
    for phase in ("draw", "forward", "backward", "optimizer"):
        assert names.count(f"tgtc.step.{phase}") == 3, phase


def _images(d, n, size, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = os.path.join(d, f"rgb_{i:05d}.png")
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def test_train_transformer_intervals_and_resume(tmp_path):
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train.transformer2d import (
        TransformerTrainConfig,
        init_transformer_train,
        train_transformer,
    )

    content = _images(str(tmp_path / "gen"), 2, 40, 1)
    styles = _images(str(tmp_path / "style"), 2, 40, 2)
    narrow = TransformerConfig(d_model=16, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
                               dim_feedforward=16)
    ckpt = CheckpointManager(str(tmp_path / "ckpt_trans"), max_to_keep=2)

    def run(max_iter):
        model = make_stytrans(narrow, torch.Generator().manual_seed(2), device="cpu")
        cfg = TransformerTrainConfig(max_iter=max_iter, batch_size=2, patch=16)
        state = init_transformer_train(model, cfg)
        if ckpt.latest_step() is not None:
            state.load_state_dict(ckpt.restore())
        return train_transformer(state, cfg, content, styles, ckpt, log_dir=str(tmp_path / "logs"),
                                 collage_dir=str(tmp_path / "test"), print_interval=2,
                                 save_interval=2, dropout_seed=3, data_seed=0, workers=2)

    assert run(3).step == 3
    assert ckpt.steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "test")) == ["3.png"]  # every 100 steps and the last
    assert Image.open(tmp_path / "test" / "3.png").size == (2 * 16, 3 * 16)
    assert run(5).step == 5  # resumed at 3
    assert ckpt.steps() == [4, 5]
    assert [r["step"] for r in _lines(tmp_path / "logs" / "transformer.jsonl")] == [2, 4]
    assert run(5).step == 5 and ckpt.steps() == [4, 5]  # nothing left to train
    ckpt.close()


def test_fit_dim_crops_and_pads():
    from tgtc_torch.train.vae_trainer import fit_dim

    x = torch.arange(12.0).reshape(2, 6)
    assert torch.equal(fit_dim(x, 6), x)
    assert torch.equal(fit_dim(x, 4), x[:, :4])
    assert torch.equal(fit_dim(x, 8), torch.cat([x, torch.zeros(2, 2)], 1))


def test_train_vae_fits_the_features_and_saves_at_its_end(tmp_path):
    from tgtc_torch.models.vae import VaeConfig
    from tgtc_torch.models.vgg import make_vgg
    from tgtc_torch.train.vae_trainer import VaeTrainConfig, init_vae_train, train_vae
    from tgtc_torch.utils.logging import MetricsLogger

    styles = _images(str(tmp_path / "style"), 2, 64, 5)
    vcfg = VaeConfig(data_dim=64, latent_dim=8, width=16, depth=2)
    tcfg = VaeTrainConfig(max_iter=4, batch_size=2)
    _, state = init_vae_train(torch.Generator().manual_seed(5), vcfg, tcfg, device="cpu")
    vgg = make_vgg(torch.Generator().manual_seed(0), device="cpu").requires_grad_(False)
    ckpt = CheckpointManager(str(tmp_path / "ckpt_vae"), max_to_keep=1)
    logger = MetricsLogger(str(tmp_path / "logs"), name="vae", print_fn=None)
    state = train_vae(state, vgg, styles, tcfg, ckpt, logger, patch=16, data_dim=64,
                      data_seed=2, eps_seed=6, print_interval=2, workers=2)
    logger.close()
    assert state.step == 4 and ckpt.steps() == [4]
    lines = _lines(tmp_path / "logs" / "vae.jsonl")
    assert [r["step"] for r in lines] == [2, 4] and all(np.isfinite(r["loss"]) for r in lines)
    ckpt.close()
