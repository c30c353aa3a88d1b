"""The CUDA kernels on a card: K1-K5 against their plain twins, their
launch counters, the fused render, the fused stylized render and one fused
training step on the card against the same on the CPU (where the wrappers
run the twins).

Every test here needs a card and skips without one. The file imports
neither JAX nor tgtc, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from tgtc_torch.models.nerf import NerfConfig, make_nerf
from tgtc_torch.models.style_field import StyleFieldConfig, init_latents, make_style_mlps
from tgtc_torch.ops.kernels import nerf_mlp as tk
from tgtc_torch.ops.kernels import nerf_mlp_grad as tg
from tgtc_torch.ops.kernels import style_kernel as ts
from tgtc_torch.train import nerf_trainer as tt
from tgtc_torch.render.fast import FusedNerfRenderer
from tgtc_torch.render.fast_style import FusedStyleRenderer
from tgtc_torch.render.volume import RenderSettings

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL_RGB, TOL_SIGMA, TOL_RENDER = 3e-2, 2e-1, 5e-2
# K3 vs its twin, per packed layer: max|err| / max|twin| and cosine. The
# kernel's forward is K1's, which rounds its bf16 activations apart from the
# twin's at the odd f32 tie, flipping a ReLU mask; at P = 300 one flip moves
# a few percent of a layer's max (4.2e-2 measured on the card).
TOL_K3_REL, TOL_K3_COS = 5e-2, 0.999


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


def _cotangents(p, device, seed=2):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(3, p)).astype(np.float32)).to(device),
            torch.from_numpy(rng.normal(size=(1, p)).astype(np.float32)).to(device))


@pytest.mark.parametrize("p", [300, 64 * 1000 + 17])
def test_cuda_k3_matches_twin_and_repeats(cuda_device, p):
    packed = tk.pack_nerf_params(_state_dict(0), device=cuda_device)
    args = _points(p, cuda_device) + _cotangents(p, cuda_device)
    dw, db = tg.fused_nerf_bwd(packed, *args)
    dw2, db2 = tg.fused_nerf_bwd(packed, *args)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)  # deterministic
    tw, tb = tg.fused_nerf_bwd_plain(packed, *args)
    for i, (n, k) in enumerate(packed.layers()):
        a = dw[packed.offsets[i]: packed.offsets[i] + n * k].double()
        b = tw[packed.offsets[i]: packed.offsets[i] + n * k].double()
        assert (a - b).abs().max() <= TOL_K3_REL * b.abs().max(), i
        assert (a * b).sum() >= TOL_K3_COS * a.norm() * b.norm(), i
    assert (db - tb).abs().max() <= TOL_K3_REL * tb.abs().max()


def test_k3_launch_counter_counts_launches(cuda_device):
    packed = tk.pack_nerf_params(_state_dict(0), device=cuda_device)
    args = _points(128, cuda_device) + _cotangents(128, cuda_device)
    before = tg.fused_nerf_bwd.launches
    tg.fused_nerf_bwd(packed, *args)
    tg.fused_nerf_bwd_plain(packed, *args)  # the twin is no launch
    torch.cuda.synchronize()
    assert tg.fused_nerf_bwd.launches - before == 1


def test_fused_train_step_on_card_matches_cpu(cuda_device):
    """One fused step (K1 + K3 on the card, the twins on the CPU) from the
    same state and draws: loss within 2e-2, gradient cosine >= 0.99."""
    cfg = NerfConfig()
    tc = tt.NerfTrainConfig(batch_size=64, n_samples=16, n_samples_fine=16)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    rays = [torch.from_numpy(a) for a in (rng.uniform(-0.3, 0.3, (256, 3)).astype(np.float32),
                                           d / np.linalg.norm(d, axis=-1, keepdims=True),
                                           rng.uniform(0, 1, (256, 3)).astype(np.float32))]
    cpu_step = tt.make_fused_train_step(cfg, tc, device="cpu")
    draws = cpu_step.draw(256, torch.Generator().manual_seed(0))
    out = {}
    before = (tk.fused_nerf_apply_t.launches, tg.fused_nerf_bwd.launches)
    for dev in ("cpu", cuda_device):
        state = tt.init_state(torch.Generator().manual_seed(0), cfg, tc, device=dev)
        dr = tt.StepDraws(*(None if t is None else t.to(dev) for t in dataclasses.astuple(draws)))
        step = tt.make_fused_train_step(cfg, tc, device=dev)
        out[str(dev)] = step.loss_and_grad(state.coarse, state.fine,
                                           *(r.to(dev) for r in rays), dr)
    torch.cuda.synchronize()
    assert (tk.fused_nerf_apply_t.launches - before[0], tg.fused_nerf_bwd.launches - before[1]) == (2, 2)
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out[str(cuda_device)]
    assert abs(float(m_cpu["loss"]) - float(m_gpu["loss"])) <= 2e-2
    for a, b in zip(g_cpu, g_gpu):
        a, b = a.double(), b.double().cpu()
        assert float((a * b).sum()) >= 0.99 * float(a.norm() * b.norm())


def _style_sds(seed=1):
    return tuple(m.state_dict() for m in make_style_mlps(
        StyleFieldConfig(), torch.Generator().manual_seed(seed), device="cpu"))


@pytest.mark.parametrize("p,spr", [(300, 1), (64 * 1000 + 17, 1), (512 * 128, 128)])
def test_cuda_style_kernels_match_twins_and_repeat(cuda_device, p, spr):
    packed = ts.pack_style_params(_state_dict(0), *_style_sds(), device=cuda_device)
    pts, _ = _points(p, cuda_device)
    lat = torch.from_numpy(np.random.default_rng(4).normal(size=(p // spr, 32))
                           .astype(np.float32)).to(cuda_device)
    rgb, sigma = ts.fused_style_apply_t(packed, pts, lat, spr)
    rgb2, sigma2 = ts.fused_style_apply_t(packed, pts, lat, spr)
    sigma5 = ts.fused_sigma_apply_t(packed, pts)
    torch.cuda.synchronize()
    rgb_p, sigma_p = ts.fused_style_apply_t_plain(packed, pts, lat, spr)
    assert rgb.shape == (3, p) and sigma.shape == (1, p)
    assert (rgb - rgb_p).abs().max() <= TOL_RGB
    assert (sigma - sigma_p).abs().max() <= TOL_SIGMA
    assert (sigma5 - ts.fused_sigma_apply_t_plain(packed, pts)).abs().max() <= TOL_SIGMA
    assert torch.equal(sigma5, sigma)
    assert torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2)


def test_style_launch_counters_count_launches(cuda_device):
    packed = ts.pack_style_params(_state_dict(0), *_style_sds(), device=cuda_device)
    pts, _ = _points(128, cuda_device)
    lat = torch.zeros(128, 32, device=cuda_device)
    before = (ts.fused_style_apply_t.launches, ts.fused_sigma_apply_t.launches)
    ts.fused_style_apply_t(packed, pts, lat)
    ts.fused_sigma_apply_t(packed, pts)
    ts.fused_sigma_apply_t(packed, pts)
    ts.fused_style_apply_t_plain(packed, pts, lat)  # the twin is no launch
    torch.cuda.synchronize()
    assert (ts.fused_style_apply_t.launches - before[0],
            ts.fused_sigma_apply_t.launches - before[1]) == (1, 2)


@pytest.mark.parametrize("coarse_rgb", [True, False])
def test_fused_style_render_on_card_matches_cpu(cuda_device, coarse_rgb):
    settings = RenderSettings(n_samples=16, n_samples_fine=16, sigma_noise_std=0.0)
    sds = (_state_dict(0), _state_dict(1)) + _style_sds()
    lat = init_latents(torch.Generator().manual_seed(2), 1, 4, 32, device="cpu")
    rng = np.random.default_rng(3)
    ro = torch.from_numpy(rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32))
    ids = torch.zeros(256, dtype=torch.long)
    u = torch.rand((256, 16), generator=torch.Generator().manual_seed(4))
    out = {}
    for dev in ("cpu", cuda_device):
        r = FusedStyleRenderer.from_params(*sds, lat, settings, coarse_rgb=coarse_rgb,
                                           device=dev)
        o = r.render(ro.to(dev), rd.to(dev), ids.to(dev), ids.to(dev) + 1, u=u.to(dev))
        out[str(dev)] = {k: v.cpu() for k, v in o.items()}
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert set(cpu) == set(card)
    for key in cpu:
        assert (card[key] - cpu[key]).abs().max() <= TOL_RENDER, key
