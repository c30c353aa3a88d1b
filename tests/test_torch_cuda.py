"""The CUDA kernels on a card: K1-K8 against their plain twins (K3's
recompute against K1 bit for bit), their launch counters, the fused render, the fused stylized render, one fused
training step, a narrow C3 stylization, a narrow C1 step, C2's splat, a
narrow C2 step and a VAE step on the card against the same on the CPU
(where the wrappers run the twins).

Every test here needs a card and skips without one. The file imports
neither JAX nor tgtc, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from tgtc_torch.models.nerf import NerfConfig, make_nerf
from tgtc_torch.models.stytrans import make_stytrans
from tgtc_torch.models.transformer import TransformerConfig
from tgtc_torch.models.style_field import StyleFieldConfig, init_latents, make_style_mlps
from tgtc_torch.ops.kernels import flash_attention as fa
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


# Point counts that cut the Hopper engine's 128-point tiles (K1, K2, K4, K5) and wrap
# its persistent loop (one block per SM walks over the tiles: 133 tiles on
# 132 SMs).
ENGINE_TILE = 128
ENGINE_P = [1, ENGINE_TILE - 1, ENGINE_TILE + 1, 132 * ENGINE_TILE + 17]


@pytest.mark.parametrize("p", ENGINE_P)
def test_cuda_k1_engine_tiles_match_twin_and_repeat(cuda_device, p):
    packed = tk.pack_nerf_params(_state_dict(0), device=cuda_device)
    pts, dirs = _points(p, cuda_device)
    rgb, sigma = tk.fused_nerf_apply_t(packed, pts, dirs)
    rgb2, sigma2 = tk.fused_nerf_apply_t(packed, pts, dirs)
    sigma_k2 = tk.fused_nerf_sigma_apply_t(packed, pts)
    torch.cuda.synchronize()
    rgb_p, sigma_p = tk.fused_nerf_apply_t_plain(packed, pts, dirs)
    assert rgb.shape == (3, p) and sigma.shape == (1, p)
    assert (rgb - rgb_p).abs().max() <= TOL_RGB
    assert (sigma - sigma_p).abs().max() <= TOL_SIGMA
    assert torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2)
    assert torch.equal(sigma, sigma_k2)


@pytest.mark.parametrize("p", ENGINE_P)
def test_cuda_k2_engine_tiles_match_twin_and_repeat(cuda_device, p):
    """K2 on the engine's sigma-only kernel: its twin, a second launch bit
    for bit, and K1's sigma bit for bit (one trunk function)."""
    packed = tk.pack_nerf_params(_state_dict(0), device=cuda_device)
    pts, dirs = _points(p, cuda_device)
    sigma = tk.fused_nerf_sigma_apply_t(packed, pts)
    sigma2 = tk.fused_nerf_sigma_apply_t(packed, pts)
    _, sigma_k1 = tk.fused_nerf_apply_t(packed, pts, dirs)
    torch.cuda.synchronize()
    assert sigma.shape == (1, p)
    assert (sigma - tk.fused_nerf_sigma_apply_t_plain(packed, pts)).abs().max() <= TOL_SIGMA
    assert torch.equal(sigma, sigma2)
    assert torch.equal(sigma, sigma_k1)


@pytest.mark.parametrize("p", [ENGINE_TILE + 1, 132 * ENGINE_TILE + 17])
def test_cuda_k1_runtime_depth_matches_twin(cuda_device, p):
    """K1 at a depth and skip other than the configs' 8 and 4 (the kernel
    fixes those at compile time and takes any other at run time)."""
    cfg = NerfConfig(depth=6, skips=(2,))
    sd = make_nerf(cfg, torch.Generator().manual_seed(3), device="cpu").state_dict()
    packed = tk.pack_nerf_params(sd, depth=6, skip=2, device=cuda_device)
    pts, dirs = _points(p, cuda_device)
    rgb, sigma = tk.fused_nerf_apply_t(packed, pts, dirs)
    rgb2, sigma2 = tk.fused_nerf_apply_t(packed, pts, dirs)
    sigma_k2 = tk.fused_nerf_sigma_apply_t(packed, pts)
    sigma_k2b = tk.fused_nerf_sigma_apply_t(packed, pts)
    torch.cuda.synchronize()
    rgb_p, sigma_p = tk.fused_nerf_apply_t_plain(packed, pts, dirs)
    assert (rgb - rgb_p).abs().max() <= TOL_RGB
    assert (sigma - sigma_p).abs().max() <= TOL_SIGMA
    assert torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2)
    assert torch.equal(sigma, sigma_k2) and torch.equal(sigma_k2, sigma_k2b)


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


@pytest.mark.parametrize("p", [300, 64 * 1000 + 17])
def test_cuda_k3_recompute_ties_k1(cuda_device, p):
    """K3 recomputes the forward with K1's own device code (trunk_tile and
    rgb_tail): its rgb and sigma equal K1's on the same inputs bit for bit."""
    packed = tk.pack_nerf_params(_state_dict(0), device=cuda_device)
    args = _points(p, cuda_device) + _cotangents(p, cuda_device)
    fwd = torch.empty(4, p, device=cuda_device)
    tg.fused_nerf_bwd(packed, *args, forward_out=fwd)
    rgb, sigma = tk.fused_nerf_apply_t(packed, args[0], args[1])
    torch.cuda.synchronize()
    assert torch.equal(fwd[:3], rgb) and torch.equal(fwd[3:], sigma)


def test_cuda_k3_runtime_depth_matches_twin(cuda_device):
    """K3 at depth 6 with skip 2 (its run-time depth build): the twin per
    packed layer, a second launch and K1's forward bit for bit."""
    cfg = NerfConfig(depth=6, skips=(2,))
    sd = make_nerf(cfg, torch.Generator().manual_seed(3), device="cpu").state_dict()
    packed = tk.pack_nerf_params(sd, depth=6, skip=2, device=cuda_device)
    p = 64 * 1000 + 17
    args = _points(p, cuda_device) + _cotangents(p, cuda_device)
    fwd = torch.empty(4, p, device=cuda_device)
    dw, db = tg.fused_nerf_bwd(packed, *args, forward_out=fwd)
    dw2, db2 = tg.fused_nerf_bwd(packed, *args)
    rgb, sigma = tk.fused_nerf_apply_t(packed, args[0], args[1])
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert torch.equal(fwd[:3], rgb) and torch.equal(fwd[3:], sigma)
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


@pytest.mark.parametrize("p,spr", [(p, 1) for p in ENGINE_P] + [
    (ENGINE_TILE, 128), (133 * ENGINE_TILE, 128)])
def test_cuda_k4_engine_tiles_match_twin_and_repeat(cuda_device, p, spr):
    packed = ts.pack_style_params(_state_dict(0), *_style_sds(), device=cuda_device)
    pts, _ = _points(p, cuda_device)
    lat = torch.from_numpy(np.random.default_rng(5).normal(size=(p // spr, 32))
                           .astype(np.float32)).to(cuda_device)
    rgb, sigma = ts.fused_style_apply_t(packed, pts, lat, spr)
    rgb2, sigma2 = ts.fused_style_apply_t(packed, pts, lat, spr)
    sigma5 = ts.fused_sigma_apply_t(packed, pts)
    torch.cuda.synchronize()
    rgb_p, sigma_p = ts.fused_style_apply_t_plain(packed, pts, lat, spr)
    assert rgb.shape == (3, p) and sigma.shape == (1, p)
    assert (rgb - rgb_p).abs().max() <= TOL_RGB
    assert (sigma - sigma_p).abs().max() <= TOL_SIGMA
    assert torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2)
    assert torch.equal(sigma, sigma5)


@pytest.mark.parametrize("p", ENGINE_P)
def test_cuda_k5_engine_tiles_match_twin_and_repeat(cuda_device, p):
    """K5 on the engine's sigma-only kernel: its twin, a second launch bit
    for bit, and K2's sigma bit for bit on the same trunk (K4's packing
    holds the trunk and sigma matrices at K2's indices)."""
    sd = _state_dict(0)
    packed = ts.pack_style_params(sd, *_style_sds(), device=cuda_device)
    packed_k2 = tk.pack_nerf_params(sd, device=cuda_device)
    pts, _ = _points(p, cuda_device)
    sigma = ts.fused_sigma_apply_t(packed, pts)
    sigma2 = ts.fused_sigma_apply_t(packed, pts)
    sigma_k2 = tk.fused_nerf_sigma_apply_t(packed_k2, pts)
    torch.cuda.synchronize()
    assert sigma.shape == (1, p)
    assert (sigma - ts.fused_sigma_apply_t_plain(packed, pts)).abs().max() <= TOL_SIGMA
    assert torch.equal(sigma, sigma2)
    assert torch.equal(sigma, sigma_k2)


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


TOL_K6_O, TOL_K6_LSE, TOL_C3 = 3e-2, 1e-3, 5e-2
TOL_K6_O_REL = 1e-2  # of max|twin|, which sits far below TOL_K6_O at long key rows


def _qkv(heads, sq, sk, device, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(1, heads, n, 64)).astype(np.float32))
                 .to(device, torch.bfloat16) for n in (sq, sk, sk))


def _k6_case(heads, sq, sk, rate, scale=0.125, q_view=False):
    name = f"{heads}-{sq}-{sk}-{rate}" + (f"-scale{scale}" if scale != 0.125 else "")
    return pytest.param(heads, sq, sk, rate, scale, q_view, id=name + ("-qview" if q_view else ""))


# The last cases cut K6's 128-row blocks and 128-key tiles: rows past Sq in
# a block's second warpgroup or second TMA box, one key, one key past a
# box; then a scale that is not a power of two, and q alone as a view.
@pytest.mark.parametrize("heads,sq,sk,rate,scale,q_view", [
    _k6_case(16, 300, 180, 0.0), _k6_case(2, 2000, 700, 0.0), _k6_case(2, 64, 4096, 0.0),
    _k6_case(4, 257, 129, 0.25),
    _k6_case(4, 200, 130, 0.0), _k6_case(4, 200, 130, 0.25), _k6_case(2, 1000, 1030, 0.0),
    _k6_case(2, 1000, 1030, 0.25), _k6_case(4, 300, 1, 0.0), _k6_case(4, 300, 1, 0.25),
    _k6_case(4, 300, 65, 0.0), _k6_case(4, 300, 65, 0.25),
    _k6_case(4, 300, 200, 0.0, scale=0.1), _k6_case(4, 300, 200, 0.25, q_view=True)])
def test_cuda_k6_matches_twin_and_repeats(cuda_device, heads, sq, sk, rate, scale, q_view):
    """K6 against its twin, and a second launch bitwise equal (with q given
    as a head-transposed view of [B, S, H, D] for ``q_view``)."""
    q, k, v = _qkv(heads, sq, sk, cuda_device)
    o, lse = fa.flash_attention_fwd(q, k, v, scale, rate, 11)
    q2 = q.transpose(1, 2).contiguous().transpose(1, 2) if q_view else q
    o2, lse2 = fa.flash_attention_fwd(q2, k, v, scale, rate, 11)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, rate, 11)
    assert o.shape == q.shape and o.dtype == torch.bfloat16 and lse.shape == (1, heads, sq)
    e_o = float((o.float() - o_p.float()).abs().max())
    e_l = float((lse - lse_p).abs().max())
    lim_o = min(TOL_K6_O, TOL_K6_O_REL * float(o_p.float().abs().max()))
    print(f"parity K6 vs twin, {heads} heads, Sq {sq}, Sk {sk}, dropout {rate}, scale {scale}: "
          f"o {e_o:.3e} (limit {lim_o:.3e}), lse {e_l:.3e} (limit {TOL_K6_LSE})")
    assert e_o <= lim_o
    assert e_l <= TOL_K6_LSE
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_cuda_k6_reads_head_transposed_views(cuda_device):
    """q/k/v as [B, H, S, D] views of [B, S, H, D] (the projections' layout)."""
    q, k, v = _qkv(4, 300, 200, cuda_device)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    o, lse = fa.flash_attention_fwd(q, k, v, 0.125)
    o_v, lse_v = fa.flash_attention_fwd(*views, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(o, o_v) and torch.equal(lse, lse_v)


def test_k6_launch_counter_counts_launches(cuda_device):
    q, k, v = _qkv(2, 64, 64, cuda_device)
    before = fa.flash_attention_fwd.launches
    fa.flash_attention(q, k, v, 0.125)
    fa.flash_attention_fwd(q, k, v, 0.125)
    fa.flash_attention_fwd_plain(q, k, v, 0.125)  # the twin is no launch
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches - before == 2


def test_k6_dropout_mask_probe(cuda_device):
    """q = 0 and row j of v = 2^(j // 64) e_(j mod 64): each output element
    encodes four keep bits, which must be the twin's hash mask."""
    heads, rows, sk, rate, seed = 4, 200, 256, 0.1, 7
    q = torch.zeros((1, heads, rows, 64), dtype=torch.bfloat16, device=cuda_device)
    k = _qkv(heads, 1, sk, cuda_device)[1]
    j = torch.arange(sk, device=cuda_device)
    v = torch.zeros((sk, 64), device=cuda_device)
    v[j, j % 64] = 2.0 ** (j // 64).float()
    v = v.to(torch.bfloat16).expand(1, heads, sk, 64).contiguous()
    thr, keep = fa.quantized_keep(rate)
    o = fa.flash_attention(q, k, v, 1.0, rate, seed)
    n = torch.round(o.float() * sk / float(torch.tensor(1.0 / keep, dtype=torch.bfloat16))).long()
    decoded = torch.stack([(n >> b) & 1 for b in range(4)], dim=-2).reshape(heads, rows, sk)
    want = torch.stack([fa.dropout_keep_mask(seed, bh, torch.arange(rows, device=cuda_device),
                                             j, thr) for bh in range(heads)])
    assert torch.equal(decoded.bool(), want)


def test_k6_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(2, 64, 64, cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q[..., :32], k[..., :32], v[..., :32])


def test_narrow_stylize_on_card_matches_cpu(cuda_device):
    """StyTrans (d_model 128, 2 heads of 64, 1+1 layers, bf16, flash): K6 and
    cuDNN/cuBLAS on the card against the twins on the CPU, same weights."""
    cfg = TransformerConfig(d_model=128, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
                            dim_feedforward=256, dtype=torch.bfloat16, attn_impl="flash")
    rng = np.random.default_rng(8)
    content = torch.from_numpy(rng.uniform(0, 1, (1, 40, 48, 3)).astype(np.float32))
    style = torch.from_numpy(rng.uniform(0, 1, (1, 24, 32, 3)).astype(np.float32))
    out = {}
    before = fa.flash_attention_fwd.launches
    for dev in ("cpu", cuda_device):
        model = make_stytrans(cfg, torch.Generator().manual_seed(3), device=dev)
        out[str(dev)] = [t.cpu() for t in model.stylize(content.to(dev), style.to(dev))]
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches - before == 4  # 1 + 1 encoder, 2 decoder sites
    for cpu, card in zip(out["cpu"], out[str(cuda_device)]):
        assert card.shape == cpu.shape
        assert (card - cpu).abs().max() <= TOL_C3 * cpu.abs().max()


TOL_K78_REL = 1e-2  # of max|twin|, for each of dq, dk, dv (chip_smoke.py phase 10)


def _qkvdo(batch, heads, sq, sk, device, seed=9):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(batch, heads, n, 64)).astype(np.float32))
                 .to(device, torch.bfloat16) for n in (sq, sk, sk, sq))


@pytest.mark.parametrize("batch,heads,sq,sk,rate", [(1, 16, 300, 180, 0.0), (1, 16, 300, 180, 0.25),
                                                    (8, 8, 1024, 1024, 0.0),
                                                    (8, 8, 1024, 1024, 0.25),
                                                    (1, 4, 200, 130, 0.0), (1, 4, 200, 130, 0.25),
                                                    (1, 2, 1000, 1030, 0.0),
                                                    (1, 2, 1000, 1030, 0.25)])
def test_cuda_k78_match_twins_and_repeat(cuda_device, batch, heads, sq, sk, rate):
    """Shapes that fill and cut the kernels' 128-row blocks and 64-row tiles."""
    q, k, v, do = _qkvdo(batch, heads, sq, sk, cuda_device)
    o, lse = fa.flash_attention_fwd(q, k, v, 0.125, rate, 13)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, 0.125, rate, 13)
    dq, (dk, dv) = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)
    dq2, (dk2, dv2) = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    want = (fa.flash_attention_bwd_dq_plain(*args),) + fa.flash_attention_bwd_dkv_plain(*args)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        e = float((got.float() - ref.float()).abs().max())
        lim = TOL_K78_REL * float(ref.float().abs().max())
        print(f"parity {name} vs twin, {batch}x{heads} heads, Sq {sq}, Sk {sk}, dropout {rate}: "
              f"{e:.3e} (limit {lim:.3e})")
        assert e <= lim, name
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_cuda_k78_read_head_transposed_views(cuda_device, rate):
    """q, k, v and dO as [B, H, S, D] views of [B, S, H, D] (the projections'
    layout, as the transformer feeds them): bitwise the contiguous case."""
    q, k, v, do = _qkvdo(2, 4, 200, 130, cuda_device)
    o, lse = fa.flash_attention_fwd(q, k, v, 0.125, rate, 13)
    delta = fa.attention_delta(o, do)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v, do)]
    want = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, 0.125, rate, 13),
            *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0.125, rate, 13))
    got = (fa.flash_attention_bwd_dq(*views, lse, delta, 0.125, rate, 13),
           *fa.flash_attention_bwd_dkv(*views, lse, delta, 0.125, rate, 13))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k78_launch_counters_count_launches(cuda_device):
    q, k, v, do = (x.requires_grad_() if i < 3 else x
                   for i, x in enumerate(_qkvdo(1, 2, 64, 64, cuda_device)))
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    o = fa.flash_attention(q, k, v, 0.125)
    torch.autograd.grad(o, (q, k, v), do)
    fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(), do,
                                 fa.flash_attention_fwd_plain(q.detach(), k.detach(),
                                                              v.detach(), 0.125)[1], 0.125)
    torch.cuda.synchronize()
    after = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)  # the twins are no launch


def test_k78_refuse_what_they_do_not_take(cuda_device):
    q, k, v, do = _qkvdo(1, 2, 64, 64, cuda_device)
    o, lse = fa.flash_attention_fwd(q, k, v, 0.125)
    delta = fa.attention_delta(o, do)
    for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        with pytest.raises(TypeError):
            fn(q.float(), k.float(), v.float(), do.float(), lse, delta)
        with pytest.raises(NotImplementedError):
            fn(q[..., :32], k[..., :32], v[..., :32], do[..., :32], lse, delta)
        with pytest.raises(NotImplementedError):  # the scale must be a power of two
            fn(q, k, v, do, lse, delta, 0.1)
    before = fa.flash_attention_fwd.launches
    with pytest.raises(NotImplementedError):  # before the forward runs
        fa.flash_attention(q.requires_grad_(), k, v, 0.1)
    assert fa.flash_attention_fwd.launches == before
    with torch.no_grad():  # no backward, so K6 takes any scale
        fa.flash_attention(q, k, v, 0.1)
    assert fa.flash_attention_fwd.launches == before + 1


def test_narrow_c1_step_on_card_matches_cpu(cuda_device):
    """One C1 step (d_model 128, 2 heads of 64, 1+1 layers, bf16, flash,
    dropout 0, batch 2 of 32x32 crops) on the card, K6/K7/K8 and
    cuDNN/cuBLAS, against the same step on the CPU (the twins), same
    weights: losses within 2e-2, the gradient of all trained leaves together
    at cosine >= 0.99 and each leaf's error within 0.1 of its own gradient
    norm or of the median leaf's, whichever is larger (a leaf whose gradient
    sits at the bf16 noise floor has no meaningful cosine of its own)."""
    from tgtc_torch.train import transformer2d as t2

    cfg = TransformerConfig(d_model=128, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
                            dim_feedforward=256, dropout=0.0, dtype=torch.bfloat16,
                            attn_impl="flash")
    rng = np.random.default_rng(10)
    batch = [torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
             for _ in range(2)]
    out = {}
    before = [c.launches for c in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)]
    for dev in ("cpu", cuda_device):
        model = make_stytrans(cfg, torch.Generator().manual_seed(3), device=dev)
        t2.init_transformer_train(model, t2.TransformerTrainConfig())
        step = t2.make_transformer_train_step(model, t2.TransformerTrainConfig())
        m, g = step.loss_and_grad(model, *(b.to(dev) for b in batch), None)
        out[str(dev)] = ({k: float(v) for k, v in m.items()}, [x.double().cpu() for x in g])
    torch.cuda.synchronize()
    after = [c.launches for c in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                                  fa.flash_attention_bwd_dkv)]
    assert [a - b for a, b in zip(after, before)] == [12, 12, 12]  # 3 calls x 4 sites
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out[str(cuda_device)]
    for k in m_cpu:
        assert abs(m_gpu[k] - m_cpu[k]) <= 2e-2 * max(1.0, abs(m_cpu[k])), k
    a, b = torch.cat([x.flatten() for x in g_gpu]), torch.cat([x.flatten() for x in g_cpu])
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    median = float(np.median([float(x.norm()) for x in g_cpu]))
    leaf = max(float((x - y).norm()) / max(float(y.norm()), median) for x, y in zip(g_gpu, g_cpu))
    print(f"parity narrow C1 step, card vs CPU: loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f}, "
          f"gradient cosine {cos:.6f} (limit 0.99), worst leaf error {leaf:.3e} (limit 0.1)")
    assert cos >= 0.99
    assert leaf <= 0.1


def _plane_cloud(n_side, h, w, focal, seed=11):
    """A tilted plane of ``n_side²`` points spread over an ``h x w`` frame
    in front of the identity camera, and two more camera-to-world poses
    (moved and turned)."""
    ys, xs = np.meshgrid(np.linspace(0, h - 1, n_side), np.linspace(0, w - 1, n_side),
                         indexing="ij")
    x_cam, y_cam = xs - (w - 1) / 2, -(ys - (h - 1) / 2)
    z = -2.0 - 0.003 * x_cam - 0.002 * y_cam
    pts = np.stack([x_cam / focal * -z, y_cam / focal * -z, z], -1).reshape(-1, 3)
    cps = np.stack([np.eye(4)] * 3)
    for i, (dx, a) in enumerate(((0.05, 0.02), (-0.04, -0.03)), 1):
        cps[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        cps[i, 0, 3] = dx
    rgb = np.random.default_rng(seed).uniform(0, 1, pts.shape)
    return (torch.from_numpy(a.astype(np.float32)) for a in (pts, rgb, cps))


def test_splat_on_card_matches_cpu(cuda_device):
    """C2's splat (256² points into 3 views of 378x504) on the card against
    the CPU with the same w2c: hit masks differ at <= 0.1% of the pixels,
    the warped features equal wherever both pick the same point, a second
    card splat bitwise equal (``amin`` does not depend on order), and the
    gather's backward twice bitwise equal."""
    from tgtc_torch.ops import rasterize as rz

    h, w, focal = 378, 504, 400.0
    pts, rgb, cps = _plane_cloud(256, h, w, focal)
    proj = torch.from_numpy(rz.llff_projection_matrix(h, w, focal))
    w2c = torch.linalg.inv(cps)
    feats = torch.cat([rgb, pts], -1)
    win_cpu = rz.splat_winners(pts, w2c, proj, h, w)
    args = (pts.to(cuda_device), w2c.to(cuda_device), proj.to(cuda_device), h, w)
    win, win2 = rz.splat_winners(*args), rz.splat_winners(*args)
    torch.cuda.synchronize()
    n = pts.shape[0]
    assert torch.equal(win, win2)
    differ = float(((win.cpu() < n) != (win_cpu < n)).float().mean())
    same = win.cpu() == win_cpu
    got = rz.gather_winners(feats.to(cuda_device), win)[0].cpu()
    want = rz.gather_winners(feats, win_cpu)[0]
    print(f"parity splat card vs CPU: masks differ at {differ:.3e}, winners equal at "
          f"{float(same.float().mean()):.6f}")
    assert differ <= 1e-3
    assert torch.equal(got[same], want[same])
    # the gather's backward (a scatter-add over sorted rows) repeats too
    feats = feats.to(cuda_device).requires_grad_(True)
    cot = torch.rand(win.shape + (6,), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    grads = [torch.autograd.grad((rz.gather_winners(feats, win)[0] * cot).sum(), feats)[0]
             for _ in range(2)]
    assert torch.equal(*grads)


def test_narrow_c2_step_on_card_matches_cpu(cuda_device):
    """One C2 step (d_model 128, 2 heads of 64, 1+1 layers, bf16, flash,
    dropout 0, batch 2 of 32x32 patches of a 48x64 frame): 12 K6 launches
    (3 transformer calls x 4 sites) and no K7/K8, since only the decoder
    trains; losses within 2e-2 of the same step on the CPU (the twins) and
    the decoder gradient at cosine >= 0.99."""
    from tgtc_torch.ops import rasterize as rz
    from tgtc_torch.train import temporal as tp

    h, w, focal = 48, 64, 60.0
    cfg = TransformerConfig(d_model=128, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
                            dim_feedforward=256, dropout=0.0, dtype=torch.bfloat16,
                            attn_impl="flash")
    ccfg = tp.TemporalTrainConfig(batch_size=2, patch=32)
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    z = -2.0 - 0.1 * (xs - w / 2) / focal
    world = np.stack([(xs - w / 2) / focal * -z, -(ys - h / 2) / focal * -z, z], -1)
    ndc = np.stack([-focal / (w / 2) * world[..., 0] / z, -focal / (h / 2) * world[..., 1] / z,
                    1 + 2 / z], -1)
    cps = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    cps[1, 0, 3] = 0.03
    rng = np.random.default_rng(12)
    origin = (7, 20)
    batch = [torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)),
             torch.from_numpy(np.stack([ndc, ndc])[:, 7:39, 20:52].astype(np.float32)),
             torch.from_numpy(cps),
             torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))]
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    out = {}
    for dev in ("cpu", cuda_device):
        model = make_stytrans(cfg, torch.Generator().manual_seed(3), device=dev)
        tp.init_temporal_train(model, ccfg)
        step = tp.make_temporal_train_step(model, ccfg, tp.SplatCamera.llff(h, w, focal,
                                                                             device=dev))
        before = [c.launches for c in counters]
        m, g = step.loss_and_grad(model, *(b.to(dev) for b in batch), origin, None)
        torch.cuda.synchronize()
        launched = [c.launches - b for c, b in zip(counters, before)]
        out[str(dev)] = ({k: float(v) for k, v in m.items()}, [x.double().cpu() for x in g],
                         launched)
    (m_cpu, g_cpu, l_cpu), (m_gpu, g_gpu, l_gpu) = out["cpu"], out[str(cuda_device)]
    assert l_cpu == [0, 0, 0] and l_gpu == [12, 0, 0]
    for k in m_cpu:
        assert abs(m_gpu[k] - m_cpu[k]) <= 2e-2 * max(1.0, abs(m_cpu[k])), k
    a, b = torch.cat([x.flatten() for x in g_gpu]), torch.cat([x.flatten() for x in g_cpu])
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    print(f"parity narrow C2 step, card vs CPU: loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f}, "
          f"loss_t {m_gpu['loss_t']:.6f} vs {m_cpu['loss_t']:.6f}, decoder gradient cosine "
          f"{cos:.6f} (limit 0.99)")
    assert m_cpu["loss_t"] > 0 and cos >= 0.99


def test_vae_step_on_card_matches_cpu(cuda_device):
    """One VAE step (1024 -> 512 x3 -> 32, batch 8) with the same features
    and eps on the card and on the CPU, TF32 off: loss within 1e-5
    relative, every gradient cosine >= 0.9999."""
    from tgtc_torch.models.vae import VaeConfig, make_vae
    from tgtc_torch.train import vae_trainer as vt

    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(13)
        x = torch.from_numpy(rng.uniform(0, 2, (8, 1024)).astype(np.float32))
        eps = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
        res = []
        for dev in ("cpu", cuda_device):
            vae = make_vae(VaeConfig(), torch.Generator().manual_seed(4), device=dev)
            m, g = vt.make_vae_train_step(vae, vt.VaeTrainConfig()).loss_and_grad(
                vae, x.to(dev), eps.to(dev))
            res.append((float(m["loss"]), [t.double().cpu() for t in g]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res
    cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(g_gpu, g_cpu)]
    print(f"parity VAE step, card vs CPU: loss {l_gpu:.7f} vs {l_cpu:.7f}, lowest cosine "
          f"{min(cos):.7f}")
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert min(cos) >= 0.9999
