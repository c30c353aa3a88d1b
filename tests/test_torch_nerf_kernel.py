"""K1/K2 (tgtc_torch.ops.kernels.nerf_mlp): the plain twins against the
Pallas kernels in interpret mode, the CPU dispatch of the wrappers and the
packing. The CUDA kernels themselves are tested in test_torch_cuda.py.

The twins must agree with the Pallas kernels to the bounds
tests/test_pallas_kernel.py holds Pallas to against XLA (rgb 3e-2, sigma
2e-1) at full width, P = 256 and a ragged P = 300 (tile 128 on the JAX side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.nerf import NerfConfig, make_nerf
from tgtc.ops.pallas import nerf_mlp as jk
from tgtc_torch.convert import nerf_state_dict_from_flax
from tgtc_torch.ops.kernels import nerf_mlp as tk
from test_torch_ops import close

torch.set_num_threads(1)


TOL_RGB, TOL_SIGMA = 3e-2, 2e-1


def _params(seed=0, **cfg):
    _, params = make_nerf(NerfConfig(**cfg), jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def full_width():
    params = _params()
    return params, tk.pack_nerf_params(nerf_state_dict_from_flax(params))


def _points(p, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (3, p)).astype(np.float32),
            rng.normal(size=(3, p)).astype(np.float32))


@pytest.mark.parametrize("p", [256, 300])
def test_k1_twin_matches_pallas(full_width, p):
    params, packed = full_width
    pts, dirs = _points(p)
    ref = jk.fused_nerf_apply(jk.pack_nerf_params(params), jnp.asarray(pts.T),
                              jnp.asarray(dirs.T), tile=128, interpret=True)
    rgb, sigma = tk.fused_nerf_apply_t_plain(packed, torch.from_numpy(pts),
                                             torch.from_numpy(dirs))
    assert rgb.shape == (3, p) and sigma.shape == (1, p)
    close(rgb.numpy().T, np.asarray(ref["rgb"]), atol=TOL_RGB)
    close(sigma.numpy()[0], np.asarray(ref["sigma"]), atol=TOL_SIGMA)


@pytest.mark.parametrize("p", [256, 300])
def test_k2_twin_matches_pallas_and_k1(full_width, p):
    params, packed = full_width
    pts, _ = _points(p)
    p_pad = -(-p // 128) * 128
    pts_pad = np.zeros((3, p_pad), np.float32)
    pts_pad[:, :p] = pts
    w1, w2, enc = jk.pack_nerf_params(params)
    ref = jk.fused_nerf_sigma_apply_t(w1, w2, enc, jnp.asarray(pts_pad), tile=128,
                                      interpret=True)
    sigma = tk.fused_nerf_sigma_apply_t_plain(packed, torch.from_numpy(pts))
    close(sigma.numpy(), np.asarray(ref)[:, :p], atol=TOL_SIGMA)
    _, sigma_k1 = tk.fused_nerf_apply_t_plain(packed, torch.from_numpy(pts),
                                              torch.from_numpy(_points(p, 2)[1]))
    assert torch.equal(sigma, sigma_k1)


def test_twin_non_default_architecture():
    """The twin takes any width/depth/frequencies the packing describes."""
    cfg = dict(depth=4, width=64, embed_freq_coor=6, embed_freq_dir=2, skips=(2,))
    params = _params(**cfg)
    kw = dict(depth=4, width=64, num_freq_coor=6, num_freq_dir=2, skip=2)
    packed = tk.pack_nerf_params(nerf_state_dict_from_flax(params), **kw)
    pts, dirs = _points(128)
    ref = jk.fused_nerf_apply(jk.pack_nerf_params(params, **kw), jnp.asarray(pts.T),
                              jnp.asarray(dirs.T), tile=128, interpret=True, **kw)
    rgb, sigma = tk.fused_nerf_apply_t_plain(packed, torch.from_numpy(pts),
                                             torch.from_numpy(dirs))
    close(rgb.numpy().T, np.asarray(ref["rgb"]), atol=TOL_RGB)
    close(sigma.numpy()[0], np.asarray(ref["sigma"]), atol=TOL_SIGMA)


def test_packing_layout(full_width):
    _, packed = full_width
    shapes = packed.layers()
    assert shapes[0] == (256, 64) and shapes[5] == (256, 64 + 256)
    assert shapes[8:] == [(256, 256), (1, 256), (128, 256 + 32), (3, 128)]
    n = len(shapes)
    assert all(off % 16 == 0 for off in packed.offsets[:n])  # 32-byte aligned
    assert packed.w.dtype == torch.bfloat16 and packed.b.dtype == torch.float32
    # biases hold bf16-rounded values, as the TPU kernel's bf16 packing does
    assert torch.equal(packed.b, packed.b.to(torch.bfloat16).float())
    # padding columns of the encodings are zero
    assert packed.weight(0)[:, 63:].abs().sum() == 0
    assert packed.weight(10)[:, 256 + 27:].abs().sum() == 0


def test_wrappers_take_the_twin_only_on_cpu(full_width):
    _, packed = full_width
    pts, dirs = (torch.from_numpy(a) for a in _points(64))
    before = (tk.fused_nerf_apply_t.launches, tk.fused_nerf_sigma_apply_t.launches)
    rgb, sigma = tk.fused_nerf_apply_t(packed, pts, dirs)
    rgb_p, sigma_p = tk.fused_nerf_apply_t_plain(packed, pts, dirs)
    assert torch.equal(rgb, rgb_p) and torch.equal(sigma, sigma_p)
    assert torch.equal(tk.fused_nerf_sigma_apply_t(packed, pts), sigma_p)
    # a CPU run is no kernel launch
    assert (tk.fused_nerf_apply_t.launches, tk.fused_nerf_sigma_apply_t.launches) == before
    # any other device goes to the kernel path, which refuses what it cannot run
    meta = torch.empty(3, 64, device="meta")
    with pytest.raises(TypeError):
        tk.fused_nerf_apply_t(packed, meta, meta)
    with pytest.raises(TypeError):
        tk.fused_nerf_sigma_apply_t(packed, meta)
    narrow = tk.pack_nerf_params(
        nerf_state_dict_from_flax(_params(depth=2, width=64, skips=())),
        depth=2, width=64)
    with pytest.raises(NotImplementedError, match="width 256 .* or 128 \\(K2\\)"):
        tk.fused_nerf_sigma_apply_t(narrow, meta)
