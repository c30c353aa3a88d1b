"""The density-grid proposal (tgtc_torch.render.grid) against tgtc's.

* ``sample_sigma_grid``, trilinear and nearest, at random points inside,
  on and outside the grid: within 1e-6 of JAX's;
* ``ray_bounds`` on tensors and on numpy arrays: JAX's bounds within 1e-6;
* ``build_sigma_grid`` at a tiny trunk (D2/W32, 4/2 frequencies, bf16
  packing; the plain K2 twin here) against JAX's ``build_sigma_grid`` with the Pallas
  kernel in interpret mode: within the bf16 kernel tolerance of σ, 1e-1
  (ROADMAP.md, Tolerances), and the max-pool's bound over the lattice σ;
* ``save_sigma_grid`` / ``load_sigma_grid`` across the two packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.render import grid as jg
from tgtc_torch.render import grid as tg
from test_torch_ops import close

torch.set_num_threads(1)
LO, HI = (-1.0, -1.0, 0.0), (1.0, 1.0, 1.0)


def _values(shape=(5, 6, 7), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("interp", ["trilinear", "nearest"])
def test_sample_sigma_grid_matches_jax(interp):
    vals = _values()
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.3, 1.3, (4, 50, 3)).astype(np.float32)  # some outside
    lat = np.stack(np.meshgrid(*[np.linspace(LO[i], HI[i], n, dtype=np.float32)
                                 for i, n in enumerate(vals.shape)], indexing="ij"), -1)
    pts[0, :20] = lat.reshape(-1, 3)[:20]  # lattice points
    want = jg.sample_sigma_grid(jnp.asarray(vals), jg.GridSpec(LO, HI, interp),
                                jnp.asarray(pts))
    got = tg.sample_sigma_grid(torch.from_numpy(vals), tg.GridSpec(LO, HI, interp),
                               torch.from_numpy(pts))
    assert got.shape == (4, 50)
    close(got, np.asarray(want), atol=1e-6)


def test_grid_spec_checks_as_jax():
    with pytest.raises(ValueError):
        tg.GridSpec(lo=(0, 0, 0), hi=(1, 1, 1), interp="cubic")
    with pytest.raises(ValueError):
        tg.GridSpec(lo=(0, 0, 0), hi=(1, 1, 0))


def test_ray_bounds_match_jax():
    rng = np.random.default_rng(3)
    ro = rng.uniform(-0.5, 0.5, (2, 30, 3)).astype(np.float32)
    rd = rng.normal(size=(2, 30, 3)).astype(np.float32)
    want = jg.ray_bounds(jnp.asarray(ro), jnp.asarray(rd), 0.1, 1.0)
    for got in (tg.ray_bounds(torch.from_numpy(ro), torch.from_numpy(rd), 0.1, 1.0),
                tg.ray_bounds(ro, rd, 0.1, 1.0)):
        for g, w in zip(got, want):
            close(np.asarray(g), np.asarray(w), atol=1e-6)


@pytest.fixture(scope="module")
def tiny_fine():
    from tgtc.models.nerf import NerfConfig, make_nerf

    cfg = NerfConfig(depth=2, width=32, embed_freq_coor=4, embed_freq_dir=2,
                     compute_dtype=jnp.float32)
    _, params = make_nerf(cfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


PKW = dict(depth=2, num_freq_coor=4, num_freq_dir=2, width=32)


def test_build_sigma_grid_matches_jax(tiny_fine, tmp_path):
    from tgtc.ops.pallas.nerf_mlp import pack_nerf_params as j_pack
    from tgtc_torch.convert import nerf_state_dict_from_flax
    from tgtc_torch.ops.kernels.nerf_mlp import (
        fused_nerf_sigma_apply_t,
        pack_nerf_params,
    )

    res = (4, 5, 6)
    spec = tg.GridSpec(LO, HI)
    want = jg.build_sigma_grid(j_pack(tiny_fine, **PKW), jg.GridSpec(LO, HI), res, depth=2,
                               num_freq_coor=4, width=32, tile=64, interpret=True, chunk=64)
    packed = pack_nerf_params(nerf_state_dict_from_flax(tiny_fine), device="cpu", **PKW)
    got = tg.build_sigma_grid(packed, spec, res, chunk=50)  # chunks cut the lattice
    assert got.shape == res and got.dtype == torch.float32
    close(got, np.asarray(want), atol=1e-1)
    # the max-pool bounds σ at the lattice points from above
    axes, _ = tg.lattice_offsets(spec, res)
    lat = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    direct = fused_nerf_sigma_apply_t(packed, torch.from_numpy(lat.T.copy())).reshape(res)
    assert bool((got >= direct).all())

    # each package reads the other's file
    p_t, p_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tg.save_sigma_grid(p_t, got, spec)
    jg.save_sigma_grid(p_j, want, jg.GridSpec(LO, HI))
    vals_j, spec_j = jg.load_sigma_grid(p_t)
    np.testing.assert_array_equal(np.asarray(vals_j), got.numpy())
    assert (spec_j.lo, spec_j.hi, spec_j.interp) == (spec.lo, spec.hi, spec.interp)
    vals_t, spec_t = tg.load_sigma_grid(p_j, device="cpu")
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(want))
    assert spec_t == spec
