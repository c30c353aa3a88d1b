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
                 "data.llff", "utils.native", "train.geometry"):
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
    intr = np.array([[50.0, 0, 20], [0, 50.0, 16], [0, 0, 1]], np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rays_for_poses(32, 40, intr, np.eye(4, dtype=np.float32)[None])
    with pytest.raises(RuntimeError):
        tgtc_torch.device.resolve_device("cuda")
