"""tgtc_torch.models.nerf + tgtc_torch.convert against tgtc.models.nerf.

The flax params go through the weight bridge into the torch NerfMLP, and
the same numpy inputs go through both: f32 to 1e-4, bf16 to the bounds the
JAX package holds its bf16 paths to (rgb 2e-2, sigma 1e-1), a shallow SIREN
(sin(30 x) composed 8 deep is chaotic, so depth 2), and the flax -> torch ->
flax round trip bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models import nerf as jnerf
from tgtc_torch.convert import nerf_flax_from_state_dict, nerf_state_dict_from_flax
from tgtc_torch.models import nerf as tnerf
from test_torch_ops import close

torch.set_num_threads(1)


JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(cfg_kw, dtype, seed=0):
    jcfg = jnerf.NerfConfig(compute_dtype=JDT[dtype], **cfg_kw)
    model, params = jnerf.make_nerf(jcfg, jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    tm = tnerf.NerfMLP(tnerf.NerfConfig(compute_dtype=dtype, **cfg_kw))
    tm.load_state_dict(nerf_state_dict_from_flax(params))
    return jcfg, model, params, tm


def _inputs(n=64, seed=1, low=-1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(low, 1, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype,tol_rgb,tol_sigma,tol_br", [
    (torch.float32, 1e-4, 1e-4, 1e-4),
    (torch.bfloat16, 2e-2, 1e-1, 1e-1),
])
def test_nerf_apply_full_width(dtype, tol_rgb, tol_sigma, tol_br):
    _, model, params, tm = _pair({}, dtype)
    pts, dirs = _inputs()
    ref = jnerf.nerf_apply(model, params, jnp.asarray(pts), jnp.asarray(dirs))
    with torch.no_grad():
        out = tnerf.nerf_apply(tm, torch.from_numpy(pts), torch.from_numpy(dirs))
    close(_np(out["rgb"]), np.asarray(ref["rgb"], np.float32), atol=tol_rgb)
    close(_np(out["sigma"]), np.asarray(ref["sigma"], np.float32),
          atol=tol_sigma)
    close(_np(out["base_remap"]),
          np.asarray(ref["base_remap"], np.float32), atol=tol_br)
    close(_np(out["pts_embed"]), np.asarray(ref["pts_embed"]), atol=1e-6)


@pytest.mark.parametrize("dtype,tol_rgb,tol_sigma", [
    (torch.float32, 1e-4, 1e-4),
    (torch.bfloat16, 2e-2, 1e-1),
])
def test_nerf_apply_t_full_width(dtype, tol_rgb, tol_sigma):
    jcfg, _, params, tm = _pair({}, dtype)
    pts, dirs = _inputs()
    ref = jnerf.nerf_apply_t(jcfg, params, jnp.asarray(pts.T), jnp.asarray(dirs.T))
    with torch.no_grad():
        out = tnerf.nerf_apply_t(tm, torch.from_numpy(pts.T.copy()),
                                 torch.from_numpy(dirs.T.copy()))
    close(_np(out["rgb"]), np.asarray(ref["rgb"]), atol=tol_rgb)
    close(_np(out["sigma"]), np.asarray(ref["sigma"]), atol=tol_sigma)
    close(_np(out["pts_embed"]), np.asarray(ref["pts_embed"]),
          atol=1e-2 if dtype == torch.bfloat16 else 1e-6)


@pytest.mark.parametrize("act", ["elu", "tanh"])
def test_other_activations_f32(act):
    kw = dict(depth=4, width=64, embed_freq_coor=6, embed_freq_dir=2, skips=(2,),
              act_type=act)
    _, model, params, tm = _pair(kw, torch.float32)
    pts, dirs = _inputs(32)
    ref = jnerf.nerf_apply(model, params, jnp.asarray(pts), jnp.asarray(dirs))
    with torch.no_grad():
        out = tnerf.nerf_apply(tm, torch.from_numpy(pts), torch.from_numpy(dirs))
    close(_np(out["rgb"]), np.asarray(ref["rgb"]), atol=1e-5)
    close(_np(out["sigma"]), np.asarray(ref["sigma"]), atol=1e-4)


def test_siren_shallow_f32():
    """Four sin(30 x) layers amplify f32 summation-order noise: torch's and
    XLA's f32 matmuls each sit ~4.5e-3 from an evaluation of the same net
    with an f64 trunk, while agreeing with each other to ~3e-4. So the port
    is held to 1e-3 of JAX and to the yardstick of tests/test_fused_grad.py:
    its error against that truth at most 1.3x JAX's."""
    kw = dict(depth=2, width=32, act_type="sine", skips=())
    _, model, params, tm = _pair(kw, torch.float32)
    pts, dirs = _inputs(32, low=0.0)  # the JAX package's own SIREN inputs
    ref = jnerf.nerf_apply(model, params, jnp.asarray(pts), jnp.asarray(dirs))
    t64 = tnerf.NerfMLP(tnerf.NerfConfig(compute_dtype=torch.float64, **kw))
    t64.load_state_dict(tm.state_dict())
    with torch.no_grad():
        out = tnerf.nerf_apply(tm, torch.from_numpy(pts), torch.from_numpy(dirs))
        truth = tnerf.nerf_apply(t64.double(), torch.from_numpy(pts).double(),
                                 torch.from_numpy(dirs).double())
    for key in ("rgb", "sigma"):
        got, want, exact = _np(out[key]), np.asarray(ref[key]), truth[key].numpy()
        close(got, want, atol=1e-3)
        assert np.abs(got - exact).max() <= 1.3 * np.abs(want - exact).max() + 1e-6


def test_state_dict_names_and_round_trip_bit_exact():
    _, _, params, tm = _pair({}, torch.float32)
    names = set(tm.state_dict())
    assert {"base_layers.0.weight", "base_layers.7.bias", "sigma_layer.weight",
            "base_remap_layer.bias", "rgb_layers.0.weight", "rgb_layers.1.bias"} <= names
    assert tm.base_layers[5].weight.shape == (256, 256 + 63)  # skip after layer 4
    back = nerf_flax_from_state_dict(tm.state_dict())
    assert set(back["params"]) == set(params["params"])
    for name, leaf in params["params"].items():
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back["params"][name][k], leaf[k])
            assert back["params"][name][k].dtype == np.float32


def test_make_nerf_uses_generator():
    cfg = tnerf.NerfConfig(depth=2, width=16, embed_freq_coor=2, embed_freq_dir=1)
    a = tnerf.make_nerf(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tnerf.make_nerf(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert float(a.base_layers[0].bias.detach().abs().sum()) == 0.0
