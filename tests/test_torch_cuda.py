"""The CUDA kernels on a card: K1-K8 against their plain twins at sizes that
cut their tiles and at the full sizes of the paths that launch them (K3's
recompute against K1 bit for bit; K6-K8 with ``bh_offset`` against the
whole batch bit for bit), their launch counters, the reflection pad's
repeatable gradient, the fused render, the fused stylized render, one fused
training step, a narrow C3 stylization, a narrow C1 step (and the C1 step
replayed from its CUDA graphs against the eager step), C2's splat, a
narrow C2 step, a VAE step and a narrow Phase-E step on the card against the
same on the CPU
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
# K3 vs its twin, per packed layer: max|err| / max|twin| within the case's
# limit and cosine >= TOL_K3_COS. The kernel's forward is K1's, which rounds
# its bf16 activations apart from the twin's at the odd f32 tie, flipping a
# ReLU mask; at P = 300 one flip moves a few percent of a layer's max
# (4.2e-2 measured on the card), so the small cases' limit is 5e-2. At
# Phase A's fine pass (2048 rays x 128 samples, 300 points over) on a
# He-normal trunk no one flip moves a layer's max by percents: there the
# limit is 2e-2.
TOL_K3_COS = 0.999
K3_STEP_P = 2048 * 128 + 300
# (p, He-normal trunk, relative limit) of the K3 cases.
K3_CASES = [pytest.param(300, False, 5e-2, id="300"),
            pytest.param(64 * 1000 + 17, False, 5e-2, id="64017"),
            pytest.param(K3_STEP_P, True, 2e-2, id=f"{K3_STEP_P}-he")]


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


def _he(sd):
    """``sd`` with He-normal kernels: the LeCun-normal draws of ``make_nerf``
    and ``make_style_mlps`` scaled by sqrt(2). Activations then keep their
    size through the ReLU layers: a D8/W256 trunk's σ reaches ~2 and its rgb
    spreads ~0.13, where LeCun-normal leaves ~0.3 and ~0.03, under the
    limits' own scale."""
    return {k: v * 2 ** 0.5 if k.endswith(".weight") else v for k, v in sd.items()}


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
# The main path's blocks: 16,384 rays x 128 samples (the fine pass) and x 64
# (the coarse pass); the fine block and 300 points over.
FINE_BLOCK_P, COARSE_BLOCK_P = 16384 * 128, 16384 * 64
FULL_P = FINE_BLOCK_P + 300


@pytest.mark.parametrize("p", ENGINE_P + [FULL_P])
def test_cuda_k1_engine_tiles_match_twin_and_repeat(cuda_device, p):
    packed = tk.pack_nerf_params(_he(_state_dict(0)), device=cuda_device)
    pts, dirs = _points(p, cuda_device)
    rgb, sigma = tk.fused_nerf_apply_t(packed, pts, dirs)
    rgb2, sigma2 = tk.fused_nerf_apply_t(packed, pts, dirs)
    sigma_k2 = tk.fused_nerf_sigma_apply_t(packed, pts)
    torch.cuda.synchronize()
    rgb_p, sigma_p = tk.fused_nerf_apply_t_plain(packed, pts, dirs)
    assert rgb.shape == (3, p) and sigma.shape == (1, p)
    assert bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all())
    assert (rgb - rgb_p).abs().max() <= TOL_RGB
    assert (sigma - sigma_p).abs().max() <= TOL_SIGMA
    assert torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2)
    assert torch.equal(sigma, sigma_k2)


@pytest.mark.parametrize("p", ENGINE_P + [FULL_P])
def test_cuda_k2_engine_tiles_match_twin_and_repeat(cuda_device, p):
    """K2 on the engine's sigma-only kernel: its twin, a second launch bit
    for bit, and K1's sigma bit for bit (one trunk function)."""
    packed = tk.pack_nerf_params(_he(_state_dict(0)), device=cuda_device)
    pts, dirs = _points(p, cuda_device)
    sigma = tk.fused_nerf_sigma_apply_t(packed, pts)
    sigma2 = tk.fused_nerf_sigma_apply_t(packed, pts)
    _, sigma_k1 = tk.fused_nerf_apply_t(packed, pts, dirs)
    torch.cuda.synchronize()
    assert sigma.shape == (1, p)
    assert (sigma - tk.fused_nerf_sigma_apply_t_plain(packed, pts)).abs().max() <= TOL_SIGMA
    assert torch.equal(sigma, sigma2)
    assert torch.equal(sigma, sigma_k1)


# Point counts that cut K2-W128's 64-point tiles (csrc/proposal_sm90.cuh),
# leave warpgroups of its four a block idle, and wrap its persistent loop
# (132 blocks of 4 x 64 points).
W128_TILE = 64
W128_P = [W128_TILE - 1, W128_TILE + 1, 3 * W128_TILE + 1, 132 * 4 * W128_TILE + 17]
# The fast stack's coarse blocks: 8,192 rays x 64 samples (coarse_share 2)
# and 16,384 x 64, and 300 points over.
W128_FRAME_P = [COARSE_BLOCK_P // 2, COARSE_BLOCK_P, COARSE_BLOCK_P + 300]
# K2 at width 128 against its twin, He-normal kernels and every bias seeded
# (_w128_state_dict), set from K2-W128's largest reading over such trunks,
# 1.399e-02 (depth 3, 1,048,576 points, on an H100), the shared TOL_SIGMA
# 14 times it. Each bias path moves σ by more than BIAS_MARGIN times the
# limit.
TOL_SIGMA_W128, BIAS_MARGIN = 2e-2, 10
# (p, depth, limit): every depth at the tile-cutting sizes within
# TOL_SIGMA_W128, and every depth at the block sizes, where depth 8 runs on
# the engine's sigma-only kernel and is held to the engine's TOL_SIGMA (its
# bf16 σ reads 2.03-2.41e-02 from the twin there, on an H100).
W128_CASES = ([pytest.param(p, d, TOL_SIGMA_W128, id=f"{p}-{d}")
               for d in (1, 2, 3, 6, 8) for p in ENGINE_P + W128_P]
              + [pytest.param(p, d, TOL_SIGMA if d == 8 else TOL_SIGMA_W128, id=f"{p}-{d}")
                 for d in (1, 2, 3, 6, 8) for p in W128_FRAME_P])


def _with_biases(sd, seed):
    """``sd`` with every bias drawn anew, of magnitude in [0.25, 0.5] and
    either sign, rounded to bf16 (the values the packing keeps): K2-W128
    adds layer 0's and a skip layer's bias through the encoding's pad
    column, the others' in its epilogue, sigma's at the store."""
    g = torch.Generator().manual_seed(seed)
    out = dict(sd)
    for name, v in sd.items():
        if name.endswith(".bias"):
            mag = 0.25 * (1 + torch.rand(v.shape, generator=g))
            sign = torch.randint(0, 2, v.shape, generator=g) * 2 - 1
            out[name] = (mag * sign).bfloat16().float()
    return out


def _w128_state_dict(depth):
    """A 128-wide trunk of ``depth`` layers (skip 4): He-normal kernels and
    every bias seeded."""
    sd = make_nerf(NerfConfig(depth=depth, width=128), torch.Generator().manual_seed(4),
                   device="cpu").state_dict()
    return _with_biases(_he(sd), 5)


@pytest.mark.parametrize("p,depth,tol", W128_CASES)
def test_cuda_k2_proposal_width_matches_twin_and_repeats(cuda_device, p, depth, tol):
    """K2 on the distilled proposal's 128-wide trunk: K2-W128 (depth 2
    compiled in; 1, 3 and 6, whose layer 5 is the skip layer, at run time)
    and, past its depth cut-off, the engine's sigma-only kernel (depth 8):
    its twin within the case's limit with every bias seeded, a second
    launch bit for bit, and the launches counted in ``launches_w128``
    alone."""
    packed = tk.pack_nerf_params(_w128_state_dict(depth), depth=depth, width=128,
                                 device=cuda_device)
    pts, _ = _points(p, cuda_device)
    k2 = tk.fused_nerf_sigma_apply_t
    before = (k2.launches, k2.launches_w128)
    sigma, sigma2 = k2(packed, pts), k2(packed, pts)
    torch.cuda.synchronize()
    assert (k2.launches, k2.launches_w128) == (before[0], before[1] + 2)
    assert sigma.shape == (1, p) and torch.equal(sigma, sigma2)
    assert bool(torch.isfinite(sigma).all())
    assert (sigma - tk.fused_nerf_sigma_apply_t_plain(packed, pts)).abs().max() <= tol


def _bias_groups(packed):
    """K2-W128's bias paths at ``packed``'s depth, as (name, packed layers):
    layer 0's and a skip layer's go in the encoding's pad column, the other
    trunk layers' in the epilogue, σ's at the store."""
    d, skip = packed.depth, packed.skip
    rest = [i for i in range(1, d) if i != skip + 1]
    return ([("layer 0", [0])] + ([("skip layer", [skip + 1])] if skip + 1 < d else [])
            + ([("epilogue layers", rest)] if rest else []) + [("sigma", [d + 1])])


def _without_biases(packed, layers):
    """``packed`` with the biases of ``layers`` set to 0 (a copy)."""
    out = dataclasses.replace(packed, b=packed.b.clone())
    for i in layers:
        out.bias(i).zero_()
    return out


@pytest.mark.parametrize("depth,p", [(1, W128_P[-1]), (2, W128_FRAME_P[-1]),
                                     (3, W128_FRAME_P[-1]), (6, W128_P[-1]), (8, ENGINE_P[-1])])
def test_cuda_k2_proposal_width_bias_paths_move_sigma(cuda_device, depth, p):
    """Every bias path of K2 at width 128 shows in its twin test: on the
    same trunk at a size of that test, the twin without each path's biases
    moves σ by more than BIAS_MARGIN times TOL_SIGMA_W128, so no kernel
    that lost or misplaced a bias could pass."""
    packed = tk.pack_nerf_params(_w128_state_dict(depth), depth=depth, width=128,
                                 device=cuda_device)
    pts, _ = _points(p, cuda_device)
    ref = tk.fused_nerf_sigma_apply_t_plain(packed, pts)
    for name, layers in _bias_groups(packed):
        moved = float((tk.fused_nerf_sigma_apply_t_plain(_without_biases(packed, layers), pts)
                       - ref).abs().max())
        print(f"K2 at width 128, depth {depth}: the twin without the {name}'s biases moves sigma "
              f"by {moved:.3e}")
        assert moved > BIAS_MARGIN * TOL_SIGMA_W128, name


def test_cuda_k2_proposal_width_depth_cut_off(cuda_device):
    """K2-W128 keeps the trunk's weights in shared memory: every depth up to
    7 fits a block's 232,448 bytes whatever the skip, depth 8 does not (it
    runs on the engine); depth 2 takes 51 KB."""
    sizes = {(d, s): tk.w128_smem_bytes(d, s) for d in range(1, 10) for s in (0, 4, 8)}
    assert all((b <= 232448) == (d <= 7) for (d, _), b in sizes.items())
    assert sizes[(2, 4)] == 2048 + 3 * 16384 + 1024


@pytest.mark.parametrize("p", [ENGINE_TILE + 1, 132 * ENGINE_TILE + 17])
def test_cuda_k1_runtime_depth_matches_twin(cuda_device, p):
    """K1 at a depth and skip other than the configs' 8 and 4 (the kernel
    fixes those at compile time and takes any other at run time)."""
    cfg = NerfConfig(depth=6, skips=(2,))
    sd = _he(make_nerf(cfg, torch.Generator().manual_seed(3), device="cpu").state_dict())
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
    assert (sigma_k2 - tk.fused_nerf_sigma_apply_t_plain(packed, pts)).abs().max() <= TOL_SIGMA
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


def _assert_k3_matches_twin(packed, dw, db, tw, tb, tol):
    """Per packed layer (then the biases): max|err| <= ``tol`` max|twin|
    and cosine >= TOL_K3_COS."""
    assert bool(torch.isfinite(dw).all() and torch.isfinite(db).all())
    for i, (n, k) in enumerate(packed.layers()):
        a = dw[packed.offsets[i]: packed.offsets[i] + n * k].double()
        b = tw[packed.offsets[i]: packed.offsets[i] + n * k].double()
        assert (a - b).abs().max() <= tol * b.abs().max(), i
        assert (a * b).sum() >= TOL_K3_COS * a.norm() * b.norm(), i
    assert (db - tb).abs().max() <= tol * tb.abs().max()


@pytest.mark.parametrize("p,he,tol", K3_CASES)
def test_cuda_k3_matches_twin_and_repeats(cuda_device, p, he, tol):
    sd = _state_dict(0)
    packed = tk.pack_nerf_params(_he(sd) if he else sd, device=cuda_device)
    args = _points(p, cuda_device) + _cotangents(p, cuda_device)
    dw, db = tg.fused_nerf_bwd(packed, *args)
    dw2, db2 = tg.fused_nerf_bwd(packed, *args)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)  # deterministic
    tw, tb = tg.fused_nerf_bwd_plain(packed, *args)
    _assert_k3_matches_twin(packed, dw, db, tw, tb, tol)


@pytest.mark.parametrize("p,he", [pytest.param(*c.values[:2], id=c.id) for c in K3_CASES])
def test_cuda_k3_recompute_ties_k1(cuda_device, p, he):
    """K3 recomputes the forward with K1's own device code (trunk_tile and
    rgb_tail): its rgb and sigma equal K1's on the same inputs bit for bit."""
    sd = _state_dict(0)
    packed = tk.pack_nerf_params(_he(sd) if he else sd, device=cuda_device)
    args = _points(p, cuda_device) + _cotangents(p, cuda_device)
    fwd = torch.empty(4, p, device=cuda_device)
    tg.fused_nerf_bwd(packed, *args, forward_out=fwd)
    rgb, sigma = tk.fused_nerf_apply_t(packed, args[0], args[1])
    torch.cuda.synchronize()
    assert torch.equal(fwd[:3], rgb) and torch.equal(fwd[3:], sigma)


@pytest.mark.parametrize("p,he,tol", K3_CASES[1:])
def test_cuda_k3_runtime_depth_matches_twin(cuda_device, p, he, tol):
    """K3 at depth 6 with skip 2 (its run-time depth build): the twin per
    packed layer, a second launch and K1's forward bit for bit."""
    cfg = NerfConfig(depth=6, skips=(2,))
    sd = make_nerf(cfg, torch.Generator().manual_seed(3), device="cpu").state_dict()
    packed = tk.pack_nerf_params(_he(sd) if he else sd, depth=6, skip=2, device=cuda_device)
    args = _points(p, cuda_device) + _cotangents(p, cuda_device)
    fwd = torch.empty(4, p, device=cuda_device)
    dw, db = tg.fused_nerf_bwd(packed, *args, forward_out=fwd)
    dw2, db2 = tg.fused_nerf_bwd(packed, *args)
    rgb, sigma = tk.fused_nerf_apply_t(packed, args[0], args[1])
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert torch.equal(fwd[:3], rgb) and torch.equal(fwd[3:], sigma)
    tw, tb = tg.fused_nerf_bwd_plain(packed, *args)
    _assert_k3_matches_twin(packed, dw, db, tw, tb, tol)


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


def _style_sds(seed=1, he=False):
    sds = tuple(m.state_dict() for m in make_style_mlps(
        StyleFieldConfig(), torch.Generator().manual_seed(seed), device="cpu"))
    return tuple(_he(sd) for sd in sds) if he else sds


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


# With 128 samples a ray, the fine block takes one latent row a ray: 16,384
# distinct rows, as a stylized frame's block does.
@pytest.mark.parametrize("p,spr", [(p, 1) for p in ENGINE_P] + [
    (ENGINE_TILE, 128), (133 * ENGINE_TILE, 128), (FULL_P, 1), (FINE_BLOCK_P, 128)])
def test_cuda_k4_engine_tiles_match_twin_and_repeat(cuda_device, p, spr):
    packed = ts.pack_style_params(_he(_state_dict(0)), *_style_sds(he=True), device=cuda_device)
    pts, _ = _points(p, cuda_device)
    lat = torch.from_numpy(np.random.default_rng(5).normal(size=(p // spr, 32))
                           .astype(np.float32)).to(cuda_device)
    rgb, sigma = ts.fused_style_apply_t(packed, pts, lat, spr)
    rgb2, sigma2 = ts.fused_style_apply_t(packed, pts, lat, spr)
    sigma5 = ts.fused_sigma_apply_t(packed, pts)
    torch.cuda.synchronize()
    rgb_p, sigma_p = ts.fused_style_apply_t_plain(packed, pts, lat, spr)
    assert rgb.shape == (3, p) and sigma.shape == (1, p)
    assert bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all())
    assert (rgb - rgb_p).abs().max() <= TOL_RGB
    assert (sigma - sigma_p).abs().max() <= TOL_SIGMA
    assert torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2)
    assert torch.equal(sigma, sigma5)


@pytest.mark.parametrize("p", ENGINE_P + [ENGINE_TILE, 133 * ENGINE_TILE, COARSE_BLOCK_P, FULL_P])
def test_cuda_k5_engine_tiles_match_twin_and_repeat(cuda_device, p):
    """K5 on the engine's sigma-only kernel: its twin, a second launch bit
    for bit, and K2's sigma bit for bit on the same trunk (K4's packing
    holds the trunk and sigma matrices at K2's indices)."""
    sd = _he(_state_dict(0))
    packed = ts.pack_style_params(sd, *_style_sds(he=True), device=cuda_device)
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


# The engine's encodings (csrc/trunk_sm90.cuh, encode: a thread a row and
# half of the frequencies) in K1, K2, K4 and K5. Point counts: one point, a
# consumer's 64 rows and one either side, a tile and one over, 130 tiles
# (fewer than the SMs), 131 (odd) and 265 (odd, the persistent loop wrapping
# twice), the last two ragged.
ENCODE_P = [1, 63, 65, 129, 130 * ENGINE_TILE, 131 * ENGINE_TILE - 7, 265 * ENGINE_TILE - 5]
ENGINE_KERNELS = ["K1", "K2", "K4", "K5"]


def _engine_packs(device):
    sd = _state_dict(0)
    return {"nerf": tk.pack_nerf_params(sd, device=device),
            "style": ts.pack_style_params(sd, *_style_sds(), device=device)}


def _engine_inputs(p, device, seed=6):
    pts, dirs = _points(p, device, seed)
    lat = torch.from_numpy(np.random.default_rng(seed).normal(size=(p, 32))
                           .astype(np.float32)).to(device)
    return pts, dirs, lat


def _engine_call(kernel, packs, pts, dirs, lat, spr=1, plain=False):
    """One of the engine's forward kernels (or its twin) as a tuple of its
    outputs: (rgb, sigma) for K1 and K4, (sigma,) for K2 and K5."""
    if kernel == "K1":
        f = tk.fused_nerf_apply_t_plain if plain else tk.fused_nerf_apply_t
        return f(packs["nerf"], pts, dirs)
    if kernel == "K2":
        f = tk.fused_nerf_sigma_apply_t_plain if plain else tk.fused_nerf_sigma_apply_t
        return (f(packs["nerf"], pts),)
    if kernel == "K4":
        f = ts.fused_style_apply_t_plain if plain else ts.fused_style_apply_t
        return f(packs["style"], pts, lat, spr)
    f = ts.fused_sigma_apply_t_plain if plain else ts.fused_sigma_apply_t
    return (f(packs["style"], pts),)


@pytest.mark.parametrize("p", ENCODE_P)
@pytest.mark.parametrize("kernel", ENGINE_KERNELS)
def test_cuda_engine_tiles_match_twin_repeat_and_tie(cuda_device, kernel, p):
    """The twin within the kernels' limits, a second launch bit for bit, and
    the sigma ties of one trunk function (K2's equals K1's, K5's K4's)."""
    packs = _engine_packs(cuda_device)
    pts, dirs, lat = _engine_inputs(p, cuda_device)
    out = _engine_call(kernel, packs, pts, dirs, lat)
    again = _engine_call(kernel, packs, pts, dirs, lat)
    tie = {"K1": "K2", "K2": "K1", "K4": "K5", "K5": "K4"}[kernel]
    sigma_tie = _engine_call(tie, packs, pts, dirs, lat)[-1]
    torch.cuda.synchronize()
    twin = _engine_call(kernel, packs, pts, dirs, lat, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert torch.equal(out[-1], sigma_tie)
    assert out[-1].shape == (1, p)
    assert (out[-1] - twin[-1]).abs().max() <= TOL_SIGMA
    if len(out) == 2:
        assert out[0].shape == (3, p)
        assert (out[0] - twin[0]).abs().max() <= TOL_RGB


@pytest.mark.parametrize("kernel,shift,p,spr", [
    (k, shift, p, 1) for k in ENGINE_KERNELS for shift, p in [
        (1, 130 * ENGINE_TILE - 1), (64, 65), (64, 130 * ENGINE_TILE - 1),
        (64, 265 * ENGINE_TILE - 5)]] + [("K4", 64, 265 * ENGINE_TILE, 64)])
def test_cuda_engine_row_shift_is_bit_equal(cuda_device, kernel, shift, p, spr):
    """Points put in front move every point to another row of its tile: by
    one, to another thread and swizzle phase of the encodings; by 64, to the
    other consumer. Every output is the same bit for bit. With 64 samples a
    ray the shift is one latent row."""
    packs = _engine_packs(cuda_device)
    pts, dirs, lat = _engine_inputs(p + shift, cuda_device)
    lat = lat[: (p + shift) // spr]
    whole = _engine_call(kernel, packs, pts, dirs, lat, spr)
    rest = _engine_call(kernel, packs, pts[:, shift:].contiguous(), dirs[:, shift:].contiguous(),
                        lat[shift // spr:].contiguous(), spr)
    torch.cuda.synchronize()
    assert all(torch.equal(a[:, shift:], b) for a, b in zip(whole, rest))


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
# C3's tokens: a 756x1008 frame padded to 760x1008, in 8x8 patches.
C3_TOKENS = 95 * 126


def _qkv(heads, sq, sk, device, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(1, heads, n, 64)).astype(np.float32))
                 .to(device, torch.bfloat16) for n in (sq, sk, sk))


def _k6_case(heads, sq, sk, rate, scale=0.125, q_view=False):
    name = f"{heads}-{sq}-{sk}-{rate}" + (f"-scale{scale}" if scale != 0.125 else "")
    return pytest.param(heads, sq, sk, rate, scale, q_view, id=name + ("-qview" if q_view else ""))


# C3's attention (8 heads over its tokens, against themselves and against
# 4,096 keys) and C1's (8 images x 8 heads of 1,024 tokens as one batch,
# its dropout); then cases that cut K6's 128-row blocks and 128-key tiles:
# rows past Sq in a block's second warpgroup or second TMA box, one key,
# one key past a box; then a scale that is not a power of two, and q alone
# as a view.
@pytest.mark.parametrize("heads,sq,sk,rate,scale,q_view", [
    _k6_case(8, C3_TOKENS, C3_TOKENS, 0.0), _k6_case(8, C3_TOKENS, 4096, 0.0),
    _k6_case(64, 1024, 1024, 0.1),
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
    assert bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
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


@pytest.mark.parametrize("heads,rows", [(4, 200), (16, 1000)])
def test_k6_dropout_mask_probe(cuda_device, heads, rows):
    """q = 0 and row j of v = 2^(j // 64) e_(j mod 64): each output element
    encodes four keep bits, which must be the twin's hash mask."""
    sk, rate, seed = 256, 0.1, 7
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


TOL_K78_REL = 1e-2  # of max|twin|, for each of dq, dk, dv


def _qkvdo(batch, heads, sq, sk, device, seed=9):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(batch, heads, n, 64)).astype(np.float32))
                 .to(device, torch.bfloat16) for n in (sq, sk, sk, sq))


@pytest.mark.parametrize("batch,heads,sq,sk,rate", [(1, 16, 300, 180, 0.0), (1, 16, 300, 180, 0.25),
                                                    (8, 8, 1024, 1024, 0.0),
                                                    (8, 8, 1024, 1024, 0.1),
                                                    (8, 8, 1024, 1024, 0.25),
                                                    (1, 8, C3_TOKENS, 4096, 0.0),
                                                    (1, 4, 200, 130, 0.0), (1, 4, 200, 130, 0.25),
                                                    (1, 2, 1000, 1030, 0.0),
                                                    (1, 2, 1000, 1030, 0.25)])
def test_cuda_k78_match_twins_and_repeat(cuda_device, batch, heads, sq, sk, rate):
    """C1's shape at its dropout and at others, C3's tokens against 4,096
    keys, and shapes that fill and cut the kernels' 128-row blocks and
    64-row tiles."""
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
        assert bool(torch.isfinite(got.float()).all()), name
        e = float((got.float() - ref.float()).abs().max())
        lim = TOL_K78_REL * float(ref.float().abs().max())
        print(f"parity {name} vs twin, {batch}x{heads} heads, Sq {sq}, Sk {sk}, dropout {rate}: "
              f"{e:.3e} (limit {lim:.3e})")
        assert e <= lim, name
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("b0", [1, 3])
def test_cuda_k678_offset_rows_equal_the_whole_batch(cuda_device, b0):
    """K6, K7 and K8 at dropout 0.1 on rows b0.. of a batch with ``bh_offset
    = b0 · H`` give those rows' o, lse, dq, dk and dv of the whole batch bit
    for bit (a process's share of the C1 batch)."""
    q, k, v, do = _qkvdo(4, 2, 200, 130, cuda_device)
    sl, off = slice(b0, b0 + 1), b0 * q.shape[1]

    def run(q, k, v, do, **kw):
        o, lse = fa.flash_attention_fwd(q, k, v, 0.125, 0.1, 13, **kw)
        args = (q, k, v, do, lse, fa.attention_delta(o, do), 0.125, 0.1, 13)
        return (o, lse, fa.flash_attention_bwd_dq(*args, **kw)) + fa.flash_attention_bwd_dkv(
            *args, **kw)

    whole = run(q, k, v, do)
    rows = run(*(x[sl] for x in (q, k, v, do)), bh_offset=off)
    other = run(*(x[sl] for x in (q, k, v, do)))
    torch.cuda.synchronize()
    for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"), rows, whole):
        assert torch.equal(got, ref[sl]), name
    assert not torch.equal(other[0], whole[0][sl])  # the offset is what matches them


def test_cuda_reflect_pad_gradient_repeats(cuda_device):
    """The VGG's and the decoder's reflection pad: its fixed-order backward
    gives the same bf16 gradient on every call (the library's adds the
    reflected bands by atomics), and the library's gradient to bf16 rounding."""
    import torch.nn.functional as F

    from tgtc_torch.models.vgg import reflect_pad

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((8, 64, 66, 66), generator=gen, device=cuda_device).to(torch.bfloat16)
    g = torch.randn((8, 64, 68, 68), generator=gen, device=cuda_device).to(torch.bfloat16)
    x.requires_grad_()
    grads = [torch.autograd.grad(reflect_pad(x), x, g)[0] for _ in range(3)]
    lib = torch.autograd.grad(F.pad(x, (1, 1, 1, 1), mode="reflect"), x, g)[0]
    torch.cuda.synchronize()
    assert all(torch.equal(grads[0], other) for other in grads[1:])
    assert torch.equal(reflect_pad(x), F.pad(x, (1, 1, 1, 1), mode="reflect"))
    assert float((grads[0].float() - lib.float()).abs().max()) <= 2 ** -7 * float(
        lib.float().abs().max())


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


NARROW_C1_DROPOUT = TransformerConfig(d_model=128, nhead=2, num_encoder_layers=1,
                                      num_decoder_layers=1, dim_feedforward=256, dropout=0.1,
                                      dtype=torch.bfloat16, attn_impl="flash")


def _narrow_c1(dev):
    """A narrow C1 state and its step on ``dev``: d_model 128, 2 heads of 64,
    1+1 layers, bf16, flash, dropout 0.1; the same weights every call."""
    from tgtc_torch.train import transformer2d as t2

    model = make_stytrans(NARROW_C1_DROPOUT, torch.Generator().manual_seed(3), device=dev)
    tcfg = t2.TransformerTrainConfig()
    return t2.init_transformer_train(model, tcfg), t2.make_transformer_train_step(model, tcfg)


def _c1_crops(n, size, dev, seed=10):
    """``n`` (content, style) pairs of uint8 ``[2, size, size, 3]`` crops."""
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8))
                  .to(dev) for _ in range(2)) for _ in range(n)]


def _eager_c1_steps(dev, batches, seed):
    """Each batch's step from the eager building blocks (``generator``,
    ``loss_and_grad``, ``apply``): the metrics of every step and the final
    parameters."""
    state, step = _narrow_c1(dev)
    metrics = []
    for content, style in batches:
        m, g = step.loss_and_grad(state.model, content, style, step.generator(seed, state.step))
        step.apply(state, g)
        state.step += 1
        metrics.append(m)
    torch.cuda.synchronize()
    return metrics, [p.detach().clone() for p in state.model.parameters()]


def _c1_gap(a, b):
    """The largest elementwise difference over the metrics and parameters of
    two runs."""
    (ma, pa), (mb, pb) = a, b
    gaps = [float((x[k] - y[k]).abs()) for x, y in zip(ma, mb) for k in x]
    gaps += [float((x.float() - y.float()).abs().max()) for x, y in zip(pa, pb)]
    return max(gaps)


def test_c1_graphed_step_equals_eager_step(cuda_device):
    """Four C1 steps through ``__call__`` (eager, then captured and replayed
    from call 2) against the same four through the eager building blocks,
    same weights, batches and dropout seed: every step's metrics and the
    final parameters bit for bit. Two eager runs are compared first; were
    they not bitwise equal, the graphed run would be held to their
    difference instead."""
    batches = _c1_crops(4, 32, cuda_device)
    state, step = _narrow_c1(cuda_device)
    metrics = []
    for content, style in batches:
        state, m = step(state, content, style, seed=7)
        metrics.append(m)
    torch.cuda.synchronize()
    graphed = metrics, [p.detach().clone() for p in state.model.parameters()]
    eager, again = (_eager_c1_steps(cuda_device, batches, 7) for _ in range(2))
    eager_gap, gap = _c1_gap(eager, again), _c1_gap(graphed, eager)
    print(f"parity graphed C1 step vs eager over 4 steps: largest difference {gap:.3e}; "
          f"eager vs eager {eager_gap:.3e}; losses "
          + ", ".join(f"{float(m['loss']):.6f}" for m in metrics))
    assert (step.captures, step.replays) == (1, 3)
    if eager_gap == 0.0:
        assert all(torch.equal(x[k], y[k]) for x, y in zip(graphed[0], eager[0]) for k in x)
        assert all(torch.equal(x, y) for x, y in zip(graphed[1], eager[1]))
    else:
        assert gap <= eager_gap


def test_c1_graphed_metrics_outlive_later_replays(cuda_device):
    """The metrics of three consecutive calls (the second and third
    replayed), stacked after the third, equal those read after each call:
    no returned tensor lies in the graphs' memory."""
    state, step = _narrow_c1(cuda_device)
    kept, read = [], []
    for content, style in _c1_crops(3, 32, cuda_device):
        state, m = step(state, content, style, seed=7)
        kept.append(m)
        read.append([float(v) for v in m.values()])
    assert step.replays == 2
    assert torch.stack([torch.stack(list(m.values())) for m in kept]).tolist() == read
    assert read[1] != read[2]  # so an overwritten metric would show


def test_c1_graph_counters_recapture_and_spans(cuda_device):
    """Four calls capture once and replay three times; a 48x48 batch is a
    new key (one eager call, then a capture); a profiled replayed step
    opens the phase spans, K6 replayed by the graph launched under the
    forward's and K7/K8 by the one under the backward's."""
    from torch.profiler import ProfilerActivity, profile

    state, step = _narrow_c1(cuda_device)
    for content, style in _c1_crops(4, 32, cuda_device):
        state, _ = step(state, content, style, seed=7)
    assert (step.captures, step.replays) == (1, 3)
    wide = _c1_crops(3, 48, cuda_device, seed=11)
    state, _ = step(state, *wide[0], seed=7)
    assert (step.captures, step.replays) == (1, 3)
    state, _ = step(state, *wide[1], seed=7)
    assert (step.captures, step.replays) == (2, 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, *wide[2], seed=7)
        torch.cuda.synchronize()
    assert (step.captures, step.replays) == (2, 5)
    events = prof.events()
    # a graph's kernels carry the correlation id of the cudaGraphLaunch that
    # replayed them, and that launch's parent is the span open around it
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]

    def kernels_under(span):
        ids = {e.id for e in events if e.name == "cudaGraphLaunch"
               and e.cpu_parent is not None and e.cpu_parent.name == span}
        return {e.name for e in device if e.id in ids}

    names = {e.name for e in events}
    assert {f"tgtc.step.{p}" for p in ("draw", "forward", "backward", "optimizer")} <= names
    fwd, bwd = kernels_under("tgtc.step.forward"), kernels_under("tgtc.step.backward")
    print(f"profiled replay: {len(fwd)} kernel names under the forward span, {len(bwd)} under "
          f"the backward's")
    assert any("flash_fwd_kernel" in k for k in fwd)
    assert any("flash_bwd_dq_kernel" in k for k in bwd)
    assert any("flash_bwd_dkv_kernel" in k for k in bwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_transmittance_captures_and_equals_cumprods(cuda_device, dtype):
    """On the card the capturable product (``_CumprodNonzero``) and its
    gradient equal ``torch.cumprod``'s under autograd bit for bit (opaque
    samples included), and the transmittance's backward, captured in a CUDA
    graph, replays the eager gradient."""
    from tgtc_torch.ops.composite import _CumprodNonzero, _exclusive_trans

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    alpha = torch.rand((2048, 128), generator=gen, device=cuda_device).to(dtype)
    alpha[0, 5] = alpha[3, 0] = 1.0
    g = torch.randn((2048, 128), generator=gen, device=cuda_device).to(dtype)
    x1, x2 = ((1.0 - alpha + 1e-10).requires_grad_(True) for _ in range(2))
    got, want = _CumprodNonzero.apply(x1), torch.cumprod(x2, dim=-1)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, x1, g)[0], torch.autograd.grad(want, x2, g)[0])
    static = alpha.clone().requires_grad_(True)
    eager = torch.autograd.grad(_exclusive_trans(static), static, g)[0]
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = torch.autograd.grad(_exclusive_trans(static), static, g)[0]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


A_RAYS = 16384  # the rays the Phase-A graph tests draw their batches from


def _phase_a(dev, **tc_kw):
    """A fused Phase-A step at ``nerf-fern.train``'s shapes (batch 2048,
    64+64 samples, σ noise 1.0) and a state of seeded He-normal D8/W256
    trunks."""
    cfg = NerfConfig()
    tc = tt.NerfTrainConfig(batch_size=2048, n_samples=64, n_samples_fine=64,
                            sigma_noise_std=1.0, **tc_kw)
    state = tt.init_state(torch.Generator().manual_seed(0), cfg, tc, device=dev)
    for m in (state.coarse, state.fine):
        m.load_state_dict(_he(m.state_dict()))
    return state, tt.make_fused_train_step(cfg, tc, device=dev)


def _a_rays(dev, seed=5):
    """``A_RAYS`` rays into the -z half space and their colours."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(A_RAYS, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (rng.uniform(-0.3, 0.3, (A_RAYS, 3)), d, rng.uniform(0, 1, (A_RAYS, 3)))]


def _a_snapshot(state, metrics, grads):
    return metrics, [g.clone() for g in grads], [p.detach().clone() for p in state.parameters()]


@pytest.mark.parametrize("tc_kw", [{}, {"steps_per_opt": 2}, {"train_fine_budget": 80}],
                         ids=["default", "steps_per_opt2", "budget80"])
def test_phase_a_graphed_step_equals_eager_step(cuda_device, tc_kw):
    """Five fused Phase-A steps through ``__call__`` (eager, then captured
    and replayed from call 2) against the same five through ``draw`` +
    ``loss_and_grad`` + ``apply``, same trunks, rays and generator seeds:
    after every step the metrics, the gradients handed to ``apply`` and the
    parameters bit for bit."""
    rays, gen = _a_rays(cuda_device), torch.Generator(device=cuda_device)
    state, step = _phase_a(cuda_device, **tc_kw)
    apply, graphed, eager = step.apply, [], []
    step.apply = lambda st, grads: (graphed.append(_a_snapshot(st, {}, grads)),
                                    apply(st, grads))[-1]
    for s in range(5):
        state, m = step(state, *rays, generator=gen.manual_seed(s))
        graphed[-1] = _a_snapshot(state, m, graphed[-1][1])
    assert (step.captures, step.replays) == (1, 4)
    state, blocks = _phase_a(cuda_device, **tc_kw)
    for s in range(5):
        draws = blocks.draw(A_RAYS, gen.manual_seed(s))
        m, g = blocks.loss_and_grad(state.coarse, state.fine, *rays, draws)
        g = [x.clone() for x in g]
        blocks.apply(state, g)
        state.step += 1
        eager.append(_a_snapshot(state, m, g))
    torch.cuda.synchronize()
    print(f"parity graphed Phase-A step ({tc_kw or 'default'}) vs eager over 5 steps: losses "
          + ", ".join(f"{float(m['loss']):.6f}" for m, _, _ in graphed))
    assert (blocks.captures, blocks.replays) == (0, 0)
    for s, ((mg, gg, pg), (me, ge, pe)) in enumerate(zip(graphed, eager)):
        assert mg.keys() == me.keys() and all(torch.equal(mg[k], me[k]) for k in me), s
        assert all(torch.equal(a, b) for a, b in zip(gg, ge)), s
        assert all(torch.equal(a, b) for a, b in zip(pg, pe)), s


def test_phase_a_graphed_metrics_outlive_later_replays(cuda_device):
    """The metrics of four consecutive calls (the last three replayed),
    stacked after the fourth, equal those read after each call: no returned
    tensor lies in the graphs' memory."""
    rays, gen = _a_rays(cuda_device), torch.Generator(device=cuda_device)
    state, step = _phase_a(cuda_device)
    kept, read = [], []
    for s in range(4):
        state, m = step(state, *rays, generator=gen.manual_seed(s))
        kept.append(m)
        read.append([float(v) for v in m.values()])
    assert (step.captures, step.replays) == (1, 3)
    assert torch.stack([torch.stack(list(m.values())) for m in kept]).tolist() == read
    assert read[2] != read[3]  # so an overwritten metric would show


def test_phase_a_graph_recaptures_on_a_new_key_and_spans(cuda_device):
    """A batch of another size (the caller's draws), new ``rays_o`` and a
    return to the first key each drop the graphs: one eager call, then a
    capture. A step of another fine budget captures its own. A profiled
    replayed step opens the phase spans, K1 replayed by the graph launched
    under the forward's and K3 by the one under the backward's."""
    from torch.profiler import ProfilerActivity, profile

    rays, gen = _a_rays(cuda_device), torch.Generator(device=cuda_device)
    state, step = _phase_a(cuda_device)
    counts = []
    for s in range(3):
        state, _ = step(state, *rays, generator=gen.manual_seed(s))
    counts.append((step.captures, step.replays))
    half = tt.StepDraws(*(t[:1024] for t in dataclasses.astuple(
        step.draw(A_RAYS, gen.manual_seed(3)))))
    for _ in range(3):
        state, _ = step(state, *rays, draws=half)
    counts.append((step.captures, step.replays))
    other_o = rays[0].clone()
    for s in range(2):
        state, _ = step(state, other_o, *rays[1:], generator=gen.manual_seed(s))
    counts.append((step.captures, step.replays))
    for s in range(2):
        state, _ = step(state, *rays, generator=gen.manual_seed(s))
    counts.append((step.captures, step.replays))
    _, budget = _phase_a(cuda_device, train_fine_budget=80)
    for s in range(3):
        state, _ = budget(state, *rays, generator=gen.manual_seed(s))
    counts.append((budget.captures, budget.replays, step.captures, step.replays))
    assert counts == [(1, 2), (2, 4), (3, 5), (4, 6), (1, 2, 4, 6)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, *rays, generator=gen.manual_seed(7))
        torch.cuda.synchronize()
    assert (step.captures, step.replays) == (4, 7)
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]

    def kernels_under(span):
        ids = {e.id for e in events if e.name == "cudaGraphLaunch"
               and e.cpu_parent is not None and e.cpu_parent.name == span}
        return {e.name for e in device if e.id in ids}

    names = {e.name for e in events}
    assert {f"tgtc.step.{p}" for p in ("draw", "forward", "backward", "optimizer")} <= names
    fwd, bwd = kernels_under("tgtc.step.forward"), kernels_under("tgtc.step.backward")
    print(f"profiled Phase-A replay: {len(fwd)} kernel names under the forward span, "
          f"{len(bwd)} under the backward's")
    assert any("nerf_fwd_kernel" in k for k in fwd)
    assert any("nerf_bwd_tile_kernel" in k for k in bwd)
    assert not any("nerf_bwd" in k for k in fwd)


def test_train_nerf_replays_its_step_on_the_card(cuda_device, tmp_path, monkeypatch):
    """``train_nerf`` on the card, 5 fused steps on a 2-view 32x40 scene,
    logged every 2 steps and traced (``profile_dir``): its step captures once
    and replays the last four, the losses stay finite and the trace is
    written."""
    from tgtc_torch.data.llff import LlffScene

    made = []
    build = tt.make_fused_train_step
    monkeypatch.setattr(tt, "make_fused_train_step",
                        lambda *a, **k: made.append(build(*a, **k)) or made[-1])
    rng = np.random.default_rng(3)
    poses = np.zeros((2, 3, 5), np.float32)
    poses[:, :, :3] = np.eye(3)
    poses[:, :, 3] = [[0.0, 0.0, 4.0], [0.05, 0.0, 4.1]]
    poses[:, :, 4] = [32, 40, 50.0]
    scene = LlffScene(rng.uniform(0, 1, (2, 32, 40, 3)).astype(np.float32), poses,
                      np.array([[2.0, 8.0]] * 2, np.float32), poses, 1)
    tc = tt.NerfTrainConfig(batch_size=512, n_samples=32, n_samples_fine=32)
    state, hist = tt.train_nerf(scene, NerfConfig(), tc, 5, str(tmp_path / "run"), i_print=2,
                                device=cuda_device, print_fn=None,
                                profile_dir=str(tmp_path / "trace"))
    assert len(made) == 1 and (made[0].captures, made[0].replays) == (1, 4)
    assert state.step == 5 and len(hist["loss"]) == 5 and all(np.isfinite(hist["loss"]))
    assert (tmp_path / "trace" / "phase_a.json").is_file()


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


def test_narrow_style3d_step_on_card_matches_cpu(cuda_device):
    """One narrow Phase-E step (D2/W32 f32 trunks with the σ bias raised by
    2 as in tests/test_torch_style3d.py, ``style_d`` 2, width 32, latent 8,
    2 styles x 3 frames of 8x8, batch 16, 8+8 samples, σ noise 1.0, the
    coherence loss active) from the same state with the same draws on the
    card and on the CPU, TF32 off: each loss within 1e-3 relative, the
    gradient cosine of each group (concat, style, latents) >= 0.999."""
    from tgtc_torch.data.style_dataset import synthetic_style_scene
    from tgtc_torch.train import style3d as s3

    cfg = s3.StyleTrainConfig(batch_size=16, n_samples=8, n_samples_fine=8, origin_step=0)
    nerf_cfg = NerfConfig(depth=2, width=32, compute_dtype=torch.float32)
    field = StyleFieldConfig(style_d=2, width=32, latent_dim=8, embed_dim=nerf_cfg.input_ch)
    sds = []
    for seed in (0, 1):
        sd = make_nerf(nerf_cfg, torch.Generator().manual_seed(seed), device="cpu").state_dict()
        sd["sigma_layer.bias"] = sd["sigma_layer.bias"] + 2.0
        sds.append(sd)
    cpu_data = synthetic_style_scene(torch.Generator().manual_seed(2), 2, 3, 8, 8, device="cpu")
    rng = np.random.default_rng(3)
    buffers = [torch.from_numpy(rng.uniform(0, 1, (16, 3)).astype(np.float32)) for _ in range(3)]
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    res = []
    try:
        for dev in ("cpu", cuda_device):
            trunks = []
            for sd in sds:
                m = make_nerf(nerf_cfg, device=dev)
                m.load_state_dict(sd)
                trunks.append(m)
            data = s3.StyleSceneData(**{k: getattr(cpu_data, k).to(dev) for k in (
                "rays_o", "rays_d", "images", "stylized", "style_features")})
            state = s3.init_style_state(torch.Generator().manual_seed(4), field, cfg, 2, 3,
                                        device=dev)
            state.cnt = 1
            state.coh_x, state.coh_y, state.coh_x_origin = (b.to(dev) for b in buffers)
            step = s3.make_style_train_step(*trunks, cfg)
            draws = step.draw(cpu_data, state, seed=5)  # drawn on the host, used on both
            draws = s3.StyleStepDraws(*(
                tuple(t.to(dev) for t in v) if isinstance(v, tuple) else v.to(dev)
                for v in dataclasses.astuple(draws)))
            m, g, _ = step.loss_and_grad(state, data, draws)
            n = len(list(state.concat.parameters()))
            groups = [g[:n], g[n:-1], g[-1:]]
            res.append(({k: float(v) for k, v in m.items()},
                        [torch.cat([t.double().cpu().flatten() for t in grp]) for grp in groups]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (m_cpu, g_cpu), (m_gpu, g_gpu) = res
    cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(g_gpu, g_cpu)]
    print(f"parity narrow Phase-E step, card vs CPU: " + ", ".join(
        f"{k} {m_gpu[k]:.6f} vs {m_cpu[k]:.6f}" for k in m_cpu)
        + f"; gradient cosines concat/style/latents {cos}")
    assert m_cpu["loss_coh"] > 0
    for k in m_cpu:
        assert abs(m_gpu[k] - m_cpu[k]) <= 1e-3 * abs(m_cpu[k]), k
    assert min(cos) >= 0.999
