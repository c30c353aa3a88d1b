"""The CUDA kernels on a card: K1/K2 against their plain twins, their
launch counters, and the fused render on the card against the same render
on the CPU (where the wrappers run the twins).

Every test here needs a card and skips without one. The file imports
neither JAX nor tgtc, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from tgtc_torch.models.nerf import NerfConfig, make_nerf
from tgtc_torch.ops.kernels import nerf_mlp as tk
from tgtc_torch.render.fast import FusedNerfRenderer
from tgtc_torch.render.volume import RenderSettings

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL_RGB, TOL_SIGMA, TOL_RENDER = 3e-2, 2e-1, 5e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


def _state_dict(seed):
    return make_nerf(NerfConfig(), torch.Generator().manual_seed(seed), device="cpu").state_dict()


def _points(p, device, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(-1, 1, (3, p)).astype(np.float32)).to(device),
            torch.from_numpy(rng.normal(size=(3, p)).astype(np.float32)).to(device))


@pytest.mark.parametrize("p", [300, 64 * 1000 + 17])
def test_cuda_kernels_match_twins(cuda_device, p):
    packed = tk.pack_nerf_params(_state_dict(0), device=cuda_device)
    pts, dirs = _points(p, cuda_device)
    rgb, sigma = tk.fused_nerf_apply_t(packed, pts, dirs)
    sigma2 = tk.fused_nerf_sigma_apply_t(packed, pts)
    torch.cuda.synchronize()
    rgb_p, sigma_p = tk.fused_nerf_apply_t_plain(packed, pts, dirs)
    assert rgb.shape == (3, p) and sigma.shape == (1, p)
    assert (rgb - rgb_p).abs().max() <= TOL_RGB
    assert (sigma - sigma_p).abs().max() <= TOL_SIGMA
    assert torch.equal(sigma, sigma2)


def test_launch_counters_count_launches(cuda_device):
    packed = tk.pack_nerf_params(_state_dict(0), device=cuda_device)
    pts, dirs = _points(128, cuda_device)
    before = (tk.fused_nerf_apply_t.launches, tk.fused_nerf_sigma_apply_t.launches)
    tk.fused_nerf_apply_t(packed, pts, dirs)
    tk.fused_nerf_sigma_apply_t(packed, pts)
    tk.fused_nerf_sigma_apply_t(packed, pts)
    tk.fused_nerf_apply_t_plain(packed, pts, dirs)  # the twin is no launch
    torch.cuda.synchronize()
    assert (tk.fused_nerf_apply_t.launches - before[0],
            tk.fused_nerf_sigma_apply_t.launches - before[1]) == (1, 2)


@pytest.mark.parametrize("coarse_rgb", [True, False])
def test_fused_render_on_card_matches_cpu(cuda_device, coarse_rgb):
    settings = RenderSettings(n_samples=16, n_samples_fine=16, sigma_noise_std=0.0)
    sds = (_state_dict(0), _state_dict(1))
    rng = np.random.default_rng(3)
    ro = rng.uniform(-0.5, 0.5, (1000, 3)).astype(np.float32)
    rd = rng.normal(size=(1000, 3)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        r = FusedNerfRenderer.from_params(*sds, settings, coarse_rgb=coarse_rgb, device=dev)
        o = r.render_image(torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev),
                           block=256)
        out[str(dev)] = {k: v.cpu() for k, v in o.items()}
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert set(cpu) == set(card)
    for key in cpu:
        assert card[key].shape == cpu[key].shape
        assert (card[key] - cpu[key]).abs().max() <= TOL_RENDER, key
