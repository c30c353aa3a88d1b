"""K3 (tgtc_torch.ops.kernels.nerf_mlp_grad): the differentiable pack, the
K1+K3 autograd function and the K3 twin, against the Pallas backward.

The JAX side is ``make_diff_apply(..., interpret=True)`` at tile 128 with
``jax.grad`` of the cotangent loss of tests/test_fused_grad.py:70-74 onto
the flax pytree; the port's side is autograd onto the ``NerfMLP``
parameters through ``pack_nerf_params_traceable`` and ``FusedNerfApply``
(whose backward runs the twin on the CPU). Full width, the same numpy
inputs on both sides, P = 1024: the two forwards round their bf16
activations in different places (the Pallas encoding computes cos as
sin(x + pi/2); XLA and torch sum in other orders), which flips the ReLU
mask of the odd pre-activation within a bf16 ulp of 0. Each flip moves one
point's term of a weight gradient, so the max-error ratio falls as 1/sqrt(P);
at P = 256 one such flip gave 6.9e-2 on rgb_layers.0.weight. Per leaf: max|err| / max|JAX| <= 5e-2 and
cosine >= 0.999. The twin is also held to test_fused_grad.py's f32-truth
yardstick (truth in torch f32): error <= 1.3x that of the bf16 eager path
+ 5e-3, and cosine > 0.99.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.nerf import NerfConfig as JNerfConfig
from tgtc.models.nerf import make_nerf as j_make_nerf
from tgtc.ops.pallas.nerf_mlp_grad import make_diff_apply, pack_nerf_params_traceable as j_pack
from tgtc_torch.convert import nerf_state_dict_from_flax
from tgtc_torch.models.nerf import NerfConfig, NerfMLP, nerf_apply
from tgtc_torch.ops.kernels import nerf_mlp as tk
from tgtc_torch.ops.kernels import nerf_mlp_grad as tg

torch.set_num_threads(1)

N = 1024
TOL_REL, TOL_COS = 5e-2, 0.999


def _inputs(n=N, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (pts, dirs, rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    _, params = j_make_nerf(JNerfConfig(compute_dtype=jnp.float32), jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return params, _inputs()


def _model(params, dtype=torch.float32):
    m = NerfMLP(NerfConfig(compute_dtype=dtype))
    m.load_state_dict(nerf_state_dict_from_flax(params))
    return m


def _port_grads(model, pts, dirs, crgb, csig, loss_of):
    model.zero_grad()
    loss = loss_of(model, torch.from_numpy(pts), torch.from_numpy(dirs))
    (loss(torch.from_numpy(crgb), torch.from_numpy(csig))).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _fused_loss(model, pts, dirs):
    packed = tg.pack_nerf_params_traceable(dict(model.named_parameters()))
    rgb_t, sigma_t = tg.fused_nerf_apply_diff(packed, pts.T, dirs.T)
    return lambda crgb, csig: (torch.sum(rgb_t.T * crgb) + torch.sum(sigma_t[0] * csig)) / N


def _eager_loss(model, pts, dirs):
    out = nerf_apply(model, pts, dirs)
    return lambda crgb, csig: (torch.sum(out["rgb"].float() * crgb)
                               + torch.sum(out["sigma"].float() * csig)) / N


@pytest.fixture(scope="module")
def jax_grads(setup):
    params, (pts, dirs, crgb, csig) = setup
    apply = make_diff_apply(8, 4, 10, 4, 256, tile=128, interpret=True)

    def loss(p):
        w1, w2, enc = j_pack(p, 8, 10, 4, 4, 256)
        rgb_t, sigma_t = apply(w1, w2, enc, jnp.asarray(pts.T), jnp.asarray(dirs.T))
        return (jnp.sum(rgb_t.T * crgb) + jnp.sum(sigma_t[0] * csig)) / N

    g = jax.tree.map(np.asarray, jax.grad(loss)(params))
    return nerf_state_dict_from_flax(g)


def _rel_cos(got, want):
    got, want = got.double(), want.double()
    rel = float((got - want).abs().max() / (want.abs().max() + 1e-12))
    cos = float((got * want).sum() / (got.norm() * want.norm() + 1e-30))
    return rel, cos


def test_twin_grads_match_pallas(setup, jax_grads):
    params, (pts, dirs, crgb, csig) = setup
    got = _port_grads(_model(params), pts, dirs, crgb, csig, _fused_loss)
    assert set(got) == set(jax_grads)
    worst_rel, worst_cos = 0.0, 1.0
    for name, g in got.items():
        rel, cos = _rel_cos(g, jax_grads[name])
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        assert rel <= TOL_REL and cos >= TOL_COS, (name, rel, cos)
    print(f"[parity] K3 twin vs Pallas backward: max rel {worst_rel:.3e} "
          f"(tol {TOL_REL:g}), min cos {worst_cos:.6f} (tol {TOL_COS})")


def test_twin_grads_no_worse_than_bf16_eager(setup):
    params, (pts, dirs, crgb, csig) = setup
    twin = _port_grads(_model(params), pts, dirs, crgb, csig, _fused_loss)
    truth = _port_grads(_model(params), pts, dirs, crgb, csig, _eager_loss)
    prod = _port_grads(_model(params, torch.bfloat16), pts, dirs, crgb, csig, _eager_loss)
    worst = (0.0, 0.0, 1.0)
    for name, gt in truth.items():
        scale = float(gt.abs().max()) + 1e-8
        err_k = float((twin[name] - gt).abs().max()) / scale
        err_p = float((prod[name].float() - gt).abs().max()) / scale
        _, cos = _rel_cos(twin[name], gt)
        assert err_k <= 1.3 * err_p + 5e-3, (name, err_k, err_p)
        assert cos > 0.99, (name, cos)
        worst = (max(worst[0], err_k), max(worst[1], err_p), min(worst[2], cos))
    print(f"[parity] K3 twin vs f32 truth: max rel {worst[0]:.3e}, bf16 eager "
          f"{worst[1]:.3e}, min cos {worst[2]:.6f}")


def test_points_and_dirs_get_no_gradient(setup):
    params, (pts, dirs, _, _) = setup
    packed = tg.pack_nerf_params_traceable(dict(_model(params).named_parameters()))
    p_t = torch.from_numpy(pts.T.copy()).requires_grad_()
    d_t = torch.from_numpy(dirs.T.copy()).requires_grad_()
    rgb_t, sigma_t = tg.fused_nerf_apply_diff(packed, p_t, d_t)
    (rgb_t.sum() + sigma_t.sum()).backward()
    assert p_t.grad is None and d_t.grad is None


def test_traceable_pack_equals_render_pack(setup):
    params, _ = setup
    model = _model(params)
    live = tg.pack_nerf_params_traceable(dict(model.named_parameters()))
    fixed = tk.pack_nerf_params(model.state_dict())
    assert live.w.requires_grad and live.offsets == fixed.offsets
    assert torch.equal(live.w, fixed.w) and torch.equal(live.b, fixed.b)


def test_autograd_routes_twin_gradient_through_the_pack(setup):
    """The parameters' gradients are the twin's packed dW/db, rounded to
    bf16 by the pack's cast, scattered back; padding columns get nothing."""
    params, (pts, dirs, crgb, csig) = setup
    model = _model(params)
    got = _port_grads(model, pts, dirs, crgb, csig, _fused_loss)
    packed = tk.pack_nerf_params(model.state_dict())
    dw, db = tg.fused_nerf_bwd_plain(
        packed, torch.from_numpy(pts.T.copy()), torch.from_numpy(dirs.T.copy()),
        torch.from_numpy(crgb.T.copy()) / N, torch.from_numpy(csig[None].copy()) / N)
    dw = dw.to(torch.bfloat16).float()
    dpk = dataclasses.replace(packed, w=dw)
    assert torch.equal(got["base_layers.0.weight"], dpk.weight(0)[:, :63])
    assert torch.equal(got["base_layers.5.weight"][:, 63:], dpk.weight(5)[:, 64:])
    assert torch.equal(got["rgb_layers.0.weight"][:, 256:], dpk.weight(10)[:, 256:283])
    assert torch.equal(got["sigma_layer.bias"], db[packed.offsets[len(packed.layers()) + 9]:][:1]
                       .to(torch.bfloat16).float())
    # padding columns of the encodings and the alignment gaps get zero
    assert dpk.weight(0)[:, 63:].abs().sum() == 0
    assert dpk.weight(5)[:, 63:64].abs().sum() == 0
    assert dpk.weight(10)[:, 256 + 27:].abs().sum() == 0
    used = sum(n * k for n, k in packed.layers())
    assert int((dw != 0).sum()) <= used


@pytest.mark.parametrize("p", [64, 300])
def test_twin_is_linear_in_the_cotangents(setup, p):
    """bwd(a) + bwd(b) ≈ bwd(a + b) up to the bf16 rounding of the
    gradients, and a zero cotangent gives an exactly zero gradient (also on
    a ragged P)."""
    params, _ = setup
    packed = tk.pack_nerf_params(_model(params).state_dict())
    pts, dirs, _, _ = _inputs(p, seed=3)
    pts_t, dirs_t = torch.from_numpy(pts.T.copy()), torch.from_numpy(dirs.T.copy())
    zero = tg.fused_nerf_bwd_plain(packed, pts_t, dirs_t, torch.zeros(3, p), torch.zeros(1, p))
    assert zero[0].abs().sum() == 0 and zero[1].abs().sum() == 0
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(3, p)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(1, p)).astype(np.float32))
    both = tg.fused_nerf_bwd_plain(packed, pts_t, dirs_t, a, s)
    only_rgb = tg.fused_nerf_bwd_plain(packed, pts_t, dirs_t, a, torch.zeros(1, p))
    only_sig = tg.fused_nerf_bwd_plain(packed, pts_t, dirs_t, torch.zeros(3, p), s)
    for i in range(2):
        rel, cos = _rel_cos(only_rgb[i] + only_sig[i], both[i])
        assert rel <= 2e-2 and cos >= 0.9999, (i, rel, cos)


def test_wrapper_takes_the_twin_only_on_cpu(setup):
    params, _ = setup
    packed = tk.pack_nerf_params(_model(params).state_dict())
    pts, dirs, crgb, csig = _inputs(64, seed=5)
    args = (torch.from_numpy(pts.T.copy()), torch.from_numpy(dirs.T.copy()),
            torch.from_numpy(crgb.T.copy()), torch.from_numpy(csig[None].copy()))
    before = tg.fused_nerf_bwd.launches
    got = tg.fused_nerf_bwd(packed, *args)
    want = tg.fused_nerf_bwd_plain(packed, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tg.fused_nerf_bwd.launches == before  # a CPU run is no launch
    meta = torch.empty(3, 64, device="meta")
    with pytest.raises(TypeError):
        tg.fused_nerf_bwd(packed, meta, meta, meta, torch.empty(1, 64, device="meta"))


def test_forward_out_receives_the_recompute(setup):
    """``forward_out`` (for the checks) gets the recomputed forward, rgb in
    rows 0-2 and sigma in row 3: on the CPU the K1 twin's, and the gradients
    do not change; a tensor of another shape is refused."""
    params, _ = setup
    packed = tk.pack_nerf_params(_model(params).state_dict())
    pts, dirs, crgb, csig = _inputs(80, seed=6)
    args = (torch.from_numpy(pts.T.copy()), torch.from_numpy(dirs.T.copy()),
            torch.from_numpy(crgb.T.copy()), torch.from_numpy(csig[None].copy()))
    fwd = torch.full((4, 80), float("nan"))
    got = tg.fused_nerf_bwd(packed, *args, forward_out=fwd)
    rgb, sigma = tk.fused_nerf_apply_t_plain(packed, args[0], args[1])
    assert torch.equal(fwd[:3], rgb) and torch.equal(fwd[3:], sigma)
    want = tg.fused_nerf_bwd_plain(packed, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        tg.fused_nerf_bwd(packed, *args, forward_out=torch.empty(3, 80))
