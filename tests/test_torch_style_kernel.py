"""K4/K5 (tgtc_torch.ops.kernels.style_kernel): the plain twins against the
Pallas kernels in interpret mode and the XLA chain, the CPU dispatch of the
wrappers and the packing. The CUDA kernels themselves are tested in
test_torch_cuda.py.

* K4 twin vs Pallas ``fused_style_apply_t`` (interpret, tile 128) at trunk
  D8/W256 with style widths 256 and 128 (style_d 8), P = 256: rgb 3e-2 and
  σ 2e-1, the ROADMAP's bf16 kernel bounds; vs the XLA chain at JAX's own
  4e-2 (tests/test_style_kernel.py:48).
* K5 twin vs Pallas ``fused_sigma_apply_t``; its σ equals the K4 twin's
  and the K2 twin's on the same trunk bit for bit.
* A ragged P = 300, and per-ray latents (``samples_per_ray`` S > 1) equal
  to the per-point broadcast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.nerf import NerfConfig, make_nerf, nerf_apply
from tgtc.models.style_field import StyleFieldConfig, make_style_mlps
from tgtc.ops.pallas import style_kernel as jk
from tgtc_torch.convert import nerf_state_dict_from_flax, style_state_dicts_from_flax
from tgtc_torch.ops.kernels import nerf_mlp as k12
from tgtc_torch.ops.kernels import style_kernel as tk
from test_torch_ops import close

torch.set_num_threads(1)

TOL_RGB, TOL_SIGMA, TOL_XLA = 3e-2, 2e-1, 4e-2


def _setup(width, style_d=8, seed=0):
    key = jax.random.PRNGKey(seed)
    model, nerf_params = make_nerf(NerfConfig(), key)
    field = StyleFieldConfig(style_d=style_d, width=width, latent_dim=32, embed_dim=63)
    cm, p_concat, sm, p_style = make_style_mlps(field, jax.random.fold_in(key, 1))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    nerf_params, p_concat, p_style = np_tree(nerf_params), np_tree(p_concat), np_tree(p_style)
    jax_packed = jk.pack_style_params(nerf_params, p_concat, p_style, style_d=style_d,
                                      style_width=width)
    sd_c, sd_s = style_state_dicts_from_flax({"concat": p_concat, "style": p_style})
    packed = tk.pack_style_params(nerf_state_dict_from_flax(nerf_params), sd_c, sd_s,
                                  style_d=style_d, style_width=width)
    return dict(model=model, nerf=nerf_params, cm=cm, sm=sm, concat=p_concat,
                style=p_style, jax_packed=jax_packed, packed=packed, style_d=style_d,
                width=width)


@pytest.fixture(scope="module", params=[256, 128], ids=["w256", "w128"])
def setup(request):
    return _setup(request.param)


def _inputs(p, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (3, p)).astype(np.float32),
            (rng.normal(size=(p, 32)) * 0.3).astype(np.float32))


def _pallas(s, pts, lat, p_pad):
    """Pallas K4 in interpret mode on inputs zero-padded to ``p_pad``."""
    p = pts.shape[1]
    pts_pad = np.zeros((3, p_pad), np.float32)
    lat_pad = np.zeros((32, p_pad), np.float32)
    pts_pad[:, :p], lat_pad[:, :p] = pts, lat.T
    rgb, sigma = jk.fused_style_apply_t(*s["jax_packed"], jnp.asarray(pts_pad),
                                        jnp.asarray(lat_pad), style_d=s["style_d"],
                                        style_width=s["width"], tile=128, interpret=True)
    return np.asarray(rgb)[:, :p], np.asarray(sigma)[:, :p]


@pytest.mark.parametrize("p", [256, 300])
def test_k4_twin_matches_pallas(setup, p):
    pts, lat = _inputs(p)
    rgb_ref, sigma_ref = _pallas(setup, pts, lat, -(-p // 128) * 128)
    rgb, sigma = tk.fused_style_apply_t_plain(setup["packed"], torch.from_numpy(pts),
                                              torch.from_numpy(lat))
    assert rgb.shape == (3, p) and sigma.shape == (1, p)
    close(rgb, rgb_ref, atol=TOL_RGB)
    close(sigma, sigma_ref, atol=TOL_SIGMA)


def test_k4_twin_matches_xla_chain(setup):
    """The XLA chain of tests/test_style_kernel.py:40-46 (f32 style MLPs on
    the bf16 trunk's base_remap), at JAX's own 4e-2."""
    pts, lat = _inputs(256, seed=2)
    out = nerf_apply(setup["model"], setup["nerf"], jnp.asarray(pts.T), jnp.ones((256, 3)))
    cf = setup["cm"].apply(setup["concat"], out["pts_embed"], jnp.asarray(lat))
    concated = jnp.concatenate([out["base_remap"], cf], axis=-1)
    lat_scalar = jnp.broadcast_to(jnp.mean(jnp.asarray(lat), -1, keepdims=True), lat.shape)
    rgb_ref = setup["sm"].apply(setup["style"], out["pts_embed"], concated, lat_scalar)
    rgb, sigma = tk.fused_style_apply_t_plain(setup["packed"], torch.from_numpy(pts),
                                              torch.from_numpy(lat))
    close(rgb.T, np.asarray(rgb_ref), atol=TOL_XLA)
    close(sigma[0], np.asarray(out["sigma"]), atol=TOL_SIGMA)


@pytest.mark.parametrize("p", [256, 300])
def test_k5_twin_matches_pallas_k4_and_k2(setup, p):
    pts, lat = _inputs(p)
    p_pad = -(-p // 128) * 128
    pts_pad = np.zeros((3, p_pad), np.float32)
    pts_pad[:, :p] = pts
    w_trunk, _, w_sig, enc = setup["jax_packed"]
    ref = jk.fused_sigma_apply_t(w_trunk, w_sig, enc, jnp.asarray(pts_pad), tile=128,
                                 interpret=True)
    packed = setup["packed"]
    sigma = tk.fused_sigma_apply_t_plain(packed, torch.from_numpy(pts))
    close(sigma, np.asarray(ref)[:, :p], atol=TOL_SIGMA)
    _, sigma_k4 = tk.fused_style_apply_t_plain(packed, torch.from_numpy(pts),
                                               torch.from_numpy(lat))
    assert torch.equal(sigma, sigma_k4)
    k2 = k12.pack_nerf_params(nerf_state_dict_from_flax(setup["nerf"]))
    assert torch.equal(sigma, k12.fused_nerf_sigma_apply_t_plain(k2, torch.from_numpy(pts)))


def test_latents_per_ray_equal_the_per_point_broadcast(setup):
    rays, s = 24, 8
    pts, _ = _inputs(rays * s, seed=3)
    lat = np.random.default_rng(4).normal(size=(rays, 32)).astype(np.float32)
    per_ray = tk.fused_style_apply_t_plain(setup["packed"], torch.from_numpy(pts),
                                           torch.from_numpy(lat), samples_per_ray=s)
    per_point = tk.fused_style_apply_t_plain(setup["packed"], torch.from_numpy(pts),
                                             torch.from_numpy(np.repeat(lat, s, axis=0)))
    assert all(torch.equal(a, b) for a, b in zip(per_ray, per_point))
    with pytest.raises(ValueError, match="samples per ray"):
        tk.fused_style_apply_t_plain(setup["packed"], torch.from_numpy(pts),
                                     torch.from_numpy(lat), samples_per_ray=s - 1)


def test_packing_layout():
    packed = _setup(256)["packed"]
    shapes = packed.layers()
    assert len(shapes) == 23
    assert shapes[:10] == k12.pack_nerf_params(
        nerf_state_dict_from_flax(_setup(256)["nerf"])).layers()[:10]
    assert shapes[10:15] == [(256, 64 + 32)] + [(256, 256 + 32)] * 3 + [(256, 256 + 32 + 64)]
    assert shapes[15:] == ([(256, 256 + 256 + 64)] + [(256, 256)] * 3 + [(256, 256 + 64)]
                           + [(256, 256)] * 2 + [(3, 256)])
    assert len(packed.offsets) == 2 * 23 + 8
    assert all(off % 16 == 0 for off in packed.offsets[:23])  # 32-byte aligned
    assert packed.w.dtype == torch.bfloat16 and packed.b.dtype == torch.float32
    assert torch.equal(packed.b, packed.b.to(torch.bfloat16).float())
    assert packed.weight(10)[:, 63:64].abs().sum() == 0  # enc(pts) padding column
    # the trunk's matrices and biases are K2's, value for value
    k2 = k12.pack_nerf_params(nerf_state_dict_from_flax(_setup(256)["nerf"]))
    for i in range(10):
        assert torch.equal(packed.weight(i), k2.weight(i)) and torch.equal(packed.bias(i),
                                                                           k2.bias(i))


def test_wrappers_take_the_twin_only_on_cpu():
    s = _setup(256)
    packed = s["packed"]
    pts, lat = (torch.from_numpy(a) for a in _inputs(64))
    before = (tk.fused_style_apply_t.launches, tk.fused_sigma_apply_t.launches)
    rgb, sigma = tk.fused_style_apply_t(packed, pts, lat)
    rgb_p, sigma_p = tk.fused_style_apply_t_plain(packed, pts, lat)
    assert torch.equal(rgb, rgb_p) and torch.equal(sigma, sigma_p)
    assert torch.equal(tk.fused_sigma_apply_t(packed, pts), sigma_p)
    assert (tk.fused_style_apply_t.launches, tk.fused_sigma_apply_t.launches) == before
    meta = torch.empty(3, 64, device="meta")
    with pytest.raises(TypeError):
        tk.fused_style_apply_t(packed, meta, torch.empty(64, 32, device="meta"))
    with pytest.raises(TypeError):
        tk.fused_sigma_apply_t(packed, meta)
    narrow = _setup(128)["packed"]
    with pytest.raises(NotImplementedError, match="style width 256"):
        tk.fused_sigma_apply_t(narrow, meta)
