"""The slice end to end on the CPU: tgtc_torch.render against tgtc.render.

* FusedNerfRenderer at D8/W256 (64 rays, 8+8 samples, coarse_rgb True and
  False) against JAX's FusedNerfRenderer in interpret mode: rgb and t_exp
  within 5e-2 (tests/test_pallas_kernel.py holds the fused path to that).
* The σ-only coarse pass gives a bitwise-equal fine image.
* The eager render_rays against JAX's in f32, deterministic and with JAX's
  random draws injected: 1e-4, except where resampled depths are
  ill-conditioned (see the test); the fine stage run from JAX's own fine
  depths is held to 1e-4 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.nerf import NerfConfig as JNerfConfig, make_nerf as j_make_nerf
from tgtc.render.fast import FusedNerfRenderer as JFused
from tgtc.render.volume import RenderSettings as JSettings, render_rays as j_render_rays
from tgtc_torch.convert import nerf_state_dict_from_flax
from tgtc_torch.models.nerf import NerfConfig, NerfMLP, nerf_apply
from tgtc_torch.ops.composite import alpha_composite
from tgtc_torch.render.fast import FusedNerfRenderer
from tgtc_torch.render.volume import RenderSettings, render_rays
from test_torch_ops import close

torch.set_num_threads(1)


def _flax_pair(cfg):
    out = []
    for seed in (0, 1):
        model, params = j_make_nerf(cfg, jax.random.PRNGKey(seed))
        out.append((model, jax.tree.map(np.asarray, params)))
    return out


@pytest.fixture(scope="module")
def full_width_params():
    return _flax_pair(JNerfConfig())


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    return ro, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


def _port_renderer(params, coarse_rgb, **kw):
    s = RenderSettings(n_samples=8, n_samples_fine=8, sigma_noise_std=0.0, **kw)
    return FusedNerfRenderer.from_params(
        nerf_state_dict_from_flax(params[0][1]), nerf_state_dict_from_flax(params[1][1]),
        s, coarse_rgb=coarse_rgb, device="cpu")


@pytest.mark.parametrize("coarse_rgb", [True, False])
def test_fused_renderer_matches_jax(full_width_params, coarse_rgb):
    ro, rd = _rays(64)
    jr = JFused.from_params(full_width_params[0][1], full_width_params[1][1],
                            JSettings(n_samples=8, n_samples_fine=8, sigma_noise_std=0.0),
                            tile=128, interpret=True, coarse_rgb=coarse_rgb)
    ref = jr.render(jnp.asarray(ro), jnp.asarray(rd))
    out = _port_renderer(full_width_params, coarse_rgb).render(torch.from_numpy(ro),
                                                              torch.from_numpy(rd))
    assert set(out) == set(ref)
    for key in ref:
        close(out[key].numpy(), np.asarray(ref[key]), atol=5e-2)


def test_sigma_only_coarse_gives_bitwise_equal_fine_image(full_width_params):
    ro, rd = (torch.from_numpy(a) for a in _rays(64))
    full = _port_renderer(full_width_params, True).render(ro, rd)
    sig = _port_renderer(full_width_params, False).render(ro, rd)
    assert "rgb_coarse" not in sig
    for key in ("rgb", "t_exp", "acc"):
        assert torch.equal(full[key], sig[key])


def test_render_image_blocks_pad_the_tail(full_width_params):
    ro, rd = (torch.from_numpy(a) for a in _rays(40))
    r = _port_renderer(full_width_params, False, white_bkgd=True)
    whole = r.render(ro, rd)
    blocked = r.render_image(ro, rd, block=16)  # 16 + 16 + 8 (padded to 16)
    for key in whole:
        assert blocked[key].shape == whole[key].shape
        close(blocked[key].numpy(), whole[key].numpy(), atol=1e-6)


@pytest.mark.parametrize("kw", [{"fine_budget": 12}, {"coarse_share": 2}, {"grid": True}])
def test_unported_options_raise(full_width_params, kw):
    """The levers this renderer once refused now render as JAX's do, each
    alone (tests/test_torch_render_levers.py: the same with a grid, the
    budget and the share together, and the proposal as coarse net)."""
    from test_torch_render_levers import plain_vs_jax

    out = plain_vs_jax(full_width_params[0][1], full_width_params[1][1], kw)
    assert out["rgb"].shape == (64, 3)


@pytest.mark.parametrize("perturb,feature_major", [(False, False), (True, False),
                                                   (True, True)])
def test_eager_render_rays_matches_jax_f32(perturb, feature_major):
    cfg = JNerfConfig(compute_dtype=jnp.float32)
    (cm, cp), (fm, fp) = _flax_pair(cfg)
    nc, nf, n = 16, 16, 32
    s_kw = dict(n_samples=nc, n_samples_fine=nf, sigma_noise_std=1.0 if perturb else 0.0,
                perturb=perturb, feature_major=feature_major)
    ro, rd = _rays(n, seed=3)
    key = jax.random.PRNGKey(7) if perturb else None
    ref = j_render_rays(cm, cp, fm, fp, jnp.asarray(ro), jnp.asarray(rd),
                        JSettings(**s_kw), key=key)

    draws = {}
    if perturb:  # the draws JAX's render_rays makes from its key
        k_coarse, k_noise_c, k_noise_f = jax.random.split(key, 3)
        draws = {
            "perturb_u": jax.random.uniform(k_coarse, (n, nc), jnp.float32),
            "noise_coarse": jax.random.normal(k_noise_c, (n, nc), jnp.float32),
            "noise_fine": jax.random.normal(k_noise_f, (n, nc + nf), jnp.float32),
        }
        draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    models = []
    for params in (cp, fp):
        m = NerfMLP(NerfConfig(compute_dtype=torch.float32))
        m.load_state_dict(nerf_state_dict_from_flax(params))
        models.append(m)
    with torch.no_grad():
        out = render_rays(models[0], models[1], torch.from_numpy(ro), torch.from_numpy(rd),
                          RenderSettings(**s_kw), **draws)
    close(out["ts"].numpy(), np.asarray(ref["ts"]), atol=1e-5)
    # sample_pdf divides CDF differences by denominators down to 1e-5, and
    # XLA and torch take the cumsum in different orders: a fine depth in a
    # near-empty bin may move by ~5e-4, with no weight there to show it
    close(out["ts_fine"].numpy(), np.asarray(ref["ts_fine"]), atol=1e-3)
    # With sigma noise the near-empty bins carry weight, so those moved fine
    # depths show in the fine stage (measured 1.9e-4 in its weights); the
    # coarse stage and the noise-free fine stage agree to 1e-4.
    tol = {"coarse": 1e-4, "fine": 5e-4 if perturb else 1e-4}
    for stage in ("coarse", "fine"):
        for field in ("rgb", "t_exp", "acc", "weights"):
            close(getattr(out[stage], field).numpy(),
                  np.asarray(getattr(ref[stage], field)),
                  atol=tol[stage])

    # The fine stage itself, from JAX's own fine depths: 1e-4 throughout.
    ts_f = torch.from_numpy(np.array(ref["ts_fine"]))
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    pts_f = ro_t[:, None, :] + rd_t[:, None, :] * ts_f[..., None]
    with torch.no_grad():
        out_f = nerf_apply(models[1], pts_f, rd_t[:, None, :].expand(pts_f.shape))
    comp_f = alpha_composite(out_f["rgb"], out_f["sigma"], ts_f,
                             noise_std=s_kw["sigma_noise_std"],
                             noise=draws.get("noise_fine"))
    for field in ("rgb", "t_exp", "acc", "weights"):
        close(getattr(comp_f, field).numpy(), np.asarray(getattr(ref["fine"], field)),
              atol=1e-4)
