"""tgtc_torch stands alone: importing it loads neither JAX nor any module
of tgtc, no source line under it imports them, and its entry points run on
the card unless the caller asks for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import tgtc_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tgtc_torch")


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], prefix="tgtc_torch."))


def test_submodule_list_covers_the_slice():
    mods = set(_submodules())
    for name in ("device", "convert", "ops.encoding", "ops.composite", "ops.losses",
                 "ops.sampling", "ops.kernels.nerf_mlp", "ops.kernels._build",
                 "models.nerf", "render.volume", "render.fast", "data.rays",
                 "data.llff", "utils.native", "train.geometry", "ops.kernels.nerf_mlp_grad",
                 "train.nerf_trainer", "train.checkpoint", "utils.logging",
                 "tools.profile_step", "models.style_field", "render.style",
                 "render.fast_style", "ops.kernels.style_kernel", "train.render_style",
                 "utils.img", "tools.profile_frame", "ops.kernels.flash_attention",
                 "models.transformer", "models.vgg", "models.decoder", "models.stytrans",
                 "train.pretrained", "train.stylize", "ops.style", "data.prefetch",
                 "train.transformer2d", "tools.train2d", "ops.rasterize", "train.temporal",
                 "models.vae", "train.vae_trainer", "config", "data.style_dataset",
                 "train.style3d", "train.pipeline", "cli", "utils.video", "utils.io3d",
                 "tools.jsonl2tb", "tools.import_reference", "render.grid", "render.distill",
                 "parallel", "parallel.mesh", "parallel.distributed", "data.poses",
                 "models.adain_net", "train.adain_trainer"):
        assert f"tgtc_torch.{name}" in mods


def test_import_loads_no_jax_and_no_tgtc():
    """In a subprocess: the test process itself has JAX loaded (conftest)."""
    code = (
        "import importlib, sys\n"
        f"for m in {_submodules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'optax', 'tgtc'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_line_imports_jax_or_tgtc():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|optax|tgtc)\b(?!_torch)")
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if pattern.match(line):
                            offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders


def test_lazy_package_attributes():
    assert tgtc_torch.device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(AttributeError):
        tgtc_torch.no_such_module


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.nerf import NerfConfig, make_nerf
    from tgtc_torch.render.fast import FusedNerfRenderer
    from tgtc_torch.render.volume import RenderSettings

    cfg = NerfConfig(depth=2, width=16, embed_freq_coor=2, embed_freq_dir=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_nerf(cfg)
    sd = make_nerf(NerfConfig(), device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedNerfRenderer.from_params(sd, sd, RenderSettings(), coarse_rgb=False)
    from tgtc_torch.models.style_field import StyleFieldConfig, init_latents, make_style_mlps
    from tgtc_torch.render.fast_style import FusedStyleRenderer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_style_mlps(StyleFieldConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_latents(torch.Generator(), 1, 2, 32)
    styles = [m.state_dict() for m in make_style_mlps(StyleFieldConfig(), device="cpu")]
    lat = init_latents(torch.Generator(), 1, 2, 32, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedStyleRenderer.from_params(sd, sd, *styles, lat, RenderSettings(), coarse_rgb=False)
    intr = np.array([[50.0, 0, 20], [0, 50.0, 16], [0, 0, 1]], np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rays_for_poses(32, 40, intr, np.eye(4, dtype=np.float32)[None])
    with pytest.raises(RuntimeError):
        tgtc_torch.device.resolve_device("cuda")
    from tgtc_torch.train import nerf_trainer as tt

    tc = tt.NerfTrainConfig()
    from tgtc_torch.models.stytrans import StyTrans, make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train.stylize import stylize_all

    narrow = TransformerConfig(d_model=16, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
                               dim_feedforward=16)
    model = make_stytrans(narrow, device="cpu")
    for build in (lambda: make_stytrans(narrow), lambda: StyTrans(narrow),
                  lambda: stylize_all(model, "unused", [], [], "unused")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    from tgtc_torch.models.adain_net import make_adain_net
    from tgtc_torch.models.vgg import make_vgg
    from tgtc_torch.tools import train2d

    from tgtc_torch.models.vae import VaeConfig, make_vae
    from tgtc_torch.train.temporal import SplatCamera, run_temporal_finetune
    from tgtc_torch.train.vae_trainer import VaeTrainConfig, init_vae_train
    from tgtc_torch.config import Config
    from tgtc_torch.data.style_dataset import load_style_scene, synthetic_style_scene
    from tgtc_torch.train import style3d as s3

    for build in (lambda: make_vgg(),
                  lambda: train2d.main(["--task", "transformer", "--save_dir", "unused"]),
                  lambda: train2d.main(["--task", "vae", "--save_dir", "unused"]),
                  lambda: train2d.main(["--task", "finetune_decoder", "--save_dir", "unused"]),
                  lambda: train2d.main(["--task", "temporal_decoder", "--save_dir", "unused"]),
                  lambda: make_adain_net(),
                  lambda: make_vae(VaeConfig()),
                  lambda: init_vae_train(torch.Generator(), VaeConfig(), VaeTrainConfig()),
                  lambda: SplatCamera.llff(8, 8, 10.0),
                  lambda: run_temporal_finetune(model, None, None, None, None, (8, 8, 10.0)),
                  lambda: tt.init_state(torch.Generator(), cfg, tc),
                  lambda: tt.make_train_step(tc),
                  lambda: tt.make_fused_train_step(NerfConfig(), tc),
                  lambda: tt.train_nerf(None, cfg, tc, 1, "unused", print_fn=None),
                  lambda: load_style_scene(None, "unused", "unused"),
                  lambda: synthetic_style_scene(torch.Generator(), 1, 1, 2, 2),
                  lambda: s3.init_style_state(torch.Generator(), StyleFieldConfig(),
                                              s3.StyleTrainConfig(), 1, 2),
                  lambda: s3.run_style3d(Config(), None, "unused", "unused", None, None, None,
                                         "unused", print_fn=None),
                  lambda: s3.load_style_field("unused", StyleFieldConfig())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    from tgtc_torch import cli
    from tgtc_torch.tools import import_reference
    from tgtc_torch.train.pipeline import Pipeline

    from tgtc_torch.parallel import maybe_initialize_distributed

    launch = {"TGTC_COORDINATOR": "127.0.0.1:1", "TGTC_NUM_PROCESSES": "2",
              "TGTC_PROCESS_ID": "1"}
    for build in (lambda: Pipeline(Config(datadir="unused")),
                  lambda: maybe_initialize_distributed(launch),
                  lambda: cli.main(["--datadir", "unused"]),
                  lambda: import_reference.import_reference_checkpoints(Config(), "unused"),
                  lambda: import_reference.main(["--ref_dir", "unused"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
