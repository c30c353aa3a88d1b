"""The port's command (tgtc_torch/cli.py) end to end on the CPU, in the
shapes of the JAX package's CLI test (tests/test_cli_e2e.py): a reference
config file trains Phase A to ``origin_step`` with the holdout PSNR and
Phase B, ``--render_train`` writes the plain renders and their turntable,
and without ``device="cpu"`` the command refuses to run on a host with no
card."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tgtc_torch.cli import main
from tgtc_torch.train import pipeline as P

torch.set_num_threads(1)


@pytest.fixture()
def tiny_config_file(synthetic_llff_dir, tmp_path):
    style_dir = tmp_path / "styles"
    style_dir.mkdir()
    Image.fromarray((np.random.default_rng(0).uniform(size=(32, 32, 3)) * 255
                     ).astype(np.uint8)).save(style_dir / "s.png")
    cfg = tmp_path / "scene.txt"
    cfg.write_text(f"""expname = cli_e2e
basedir = {tmp_path}/logs
datadir = {synthetic_llff_dir}
styledir = {style_dir}
dataset_type = llff
factor = 1
batch_size = 64
N_samples = 4
N_samples_fine = 4
netdepth = 2
netwidth = 16
netdepth_fine = 2
netwidth_fine = 16
embed_freq_coor = 2
embed_freq_dir = 1
origin_step = 6
sigma_noise_std = 0
chunk = 4096
use_viewdir
""")
    return str(cfg)


def _exp_dir(tmp_path):
    return [d for d in (tmp_path / "logs").iterdir() if d.is_dir()][0]


def test_cli_trains_phase_a_then_renders(tiny_config_file, tmp_path, monkeypatch):
    # the phases past B are stubbed, as in the JAX CLI test: dispatch,
    # config-file parsing, Phase A, the holdout PSNR, B
    monkeypatch.setattr(P.Pipeline, "ensure_style2d", lambda self, *a, **k: None)
    monkeypatch.setattr(P.Pipeline, "train_style3d", lambda self: None)
    assert main(["--config", tiny_config_file], device="cpu") == 0
    exp = _exp_dir(tmp_path)
    assert sorted(os.listdir(exp / "ckpt_nerf")) == ["ckpt_00000006.pt"]
    assert (exp / "nerf_gen_data2" / "geometry.npz").exists()
    (line,) = [json.loads(x) for x in (exp / "logs" / "train.jsonl").read_text().splitlines()]
    assert line["step"] == 6 and np.isfinite(line["psnr"]) and "holdout_view" in line
    assert len((exp / "logs" / "nerf.jsonl").read_text().splitlines()) == 1  # the last step

    assert main(["--config", tiny_config_file, "--render_train"], device="cpu") == 0
    out = exp / "render_train"
    rgb = sorted(f for f in os.listdir(out) if f.startswith("rgb_"))
    depth = sorted(f for f in os.listdir(out) if f.startswith("depth_"))
    assert len(rgb) == len(depth) == 8  # the synthetic scene's views
    assert Image.open(out / rgb[0]).size == (40, 32)
    assert (out / "video.gif").exists()
    assert getattr(Image.open(out / "video.gif"), "n_frames", 1) == 8
    # nothing trained again: the checkpoint and the Phase-A log are as they were
    assert sorted(os.listdir(exp / "ckpt_nerf")) == ["ckpt_00000006.pt"]
    assert len((exp / "logs" / "nerf.jsonl").read_text().splitlines()) == 1


def test_cli_debug_nans_turns_on_anomaly_detection(tiny_config_file, tmp_path, monkeypatch):
    monkeypatch.setattr(P.Pipeline, "run", lambda self: None)
    was = torch.is_anomaly_enabled()
    try:
        main(["--config", tiny_config_file], device="cpu")
        assert not torch.is_anomaly_enabled()
        main(["--config", tiny_config_file, "--debug_nans"], device="cpu")
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_cli_defaults_to_the_card(tiny_config_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", tiny_config_file])
    assert not (tmp_path / "logs").exists()  # refused before anything touched the disk
