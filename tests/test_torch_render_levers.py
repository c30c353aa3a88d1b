"""The fused renders with the proposal levers against tgtc's.

The port's ``FusedNerfRenderer`` and ``FusedStyleRenderer`` on the CPU
(their kernels' plain twins) against JAX's with the Pallas kernels in
interpret mode (tile 128), at fern's trunk width (D8/W256, 8+8 samples, 64
rays), with the same lever: ``fine_budget`` (12 of 16), ``coarse_share``
2, a density grid, and a distilled-proposal-shaped D2xW128 trunk as the
coarse net (``depth``/``width`` in the plain render, ``proposal`` in the
stylized one), alone and together. JAX's tolerance for the fused path,
5e-2 in rgb and t_exp (tests/test_pallas_kernel.py,
tests/test_style_kernel.py), holds, and the fine pass evaluates the budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.nerf import NerfConfig as JNerfConfig, make_nerf as j_make_nerf
from tgtc.render import grid as jg
from tgtc.render.fast import FusedNerfRenderer as JFused
from tgtc.render.fast_style import FusedStyleRenderer as JStyle
from tgtc.render.volume import RenderSettings as JSettings
from tgtc_torch.convert import (
    latent_state_from_jax,
    nerf_state_dict_from_flax,
    style_state_dicts_from_flax,
)
from tgtc_torch.render import grid as tg
from tgtc_torch.render.fast import FusedNerfRenderer
from tgtc_torch.render.fast_style import FusedStyleRenderer
from tgtc_torch.render.volume import RenderSettings
from test_torch_ops import close

torch.set_num_threads(1)
NC = NF = 8
N_RAYS, TOL_FUSED = 64, 5e-2
GRID_LO, GRID_HI = (-3.0, -3.0, -1.5), (3.0, 3.0, 1.5)


def rays(n=N_RAYS, seed=1):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    return ro, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


def tree(t):
    return jax.tree.map(np.asarray, t)


def proposal_params(seed=5):
    """A D2xW128 trunk, the distilled proposal's shape, its σ raised so the
    proposal's weights are not uniform."""
    _, p = j_make_nerf(JNerfConfig(depth=2, width=128), jax.random.PRNGKey(seed))
    p = tree(p)
    p["params"]["sigma"]["bias"] = p["params"]["sigma"]["bias"] + 1.0
    return p


def grid_values(seed=6):
    return (np.abs(np.random.default_rng(seed).normal(size=(8, 9, 10))) * 4).astype(np.float32)


def _levers(kw, jax_side: bool):
    """The renderers' lever arguments for one side: the grid's values and
    spec in that package's types."""
    kw = dict(kw)
    if kw.pop("grid", False):
        vals = grid_values()
        kw["sigma_grid"] = ((jnp.asarray(vals), jg.GridSpec(GRID_LO, GRID_HI)) if jax_side
                            else (torch.from_numpy(vals), tg.GridSpec(GRID_LO, GRID_HI)))
    return kw


def plain_vs_jax(coarse, fine, kw, coarse_dims=(8, 256)):
    """The plain fused render of both packages with the levers ``kw``
    (``grid=True`` for the grid) on ``coarse``/``fine`` flax params."""
    kw = dict(kw)
    ro, rd = rays()
    depth, width = coarse_dims
    settings = dict(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    dims = dict(depth=depth, width=width, depth_fine=8, width_fine=256)
    coarse_rgb = kw.pop("coarse_rgb", False)
    jr = JFused.from_params(coarse, fine, JSettings(**settings), tile=128, interpret=True,
                            coarse_rgb=coarse_rgb, **dims, **_levers(kw, True))
    ref = jr.render(jnp.asarray(ro), jnp.asarray(rd))
    pr = FusedNerfRenderer.from_params(nerf_state_dict_from_flax(coarse),
                                       nerf_state_dict_from_flax(fine),
                                       RenderSettings(**settings), coarse_rgb=coarse_rgb,
                                       device="cpu", **dims, **_levers(kw, False))
    out = pr.render(torch.from_numpy(ro), torch.from_numpy(rd))
    assert set(out) == set(ref)
    for key in ref:
        close(out[key], np.asarray(ref[key]), atol=TOL_FUSED)
    return out


@pytest.fixture(scope="module")
def full_width():
    return [tree(j_make_nerf(JNerfConfig(), jax.random.PRNGKey(s))[1]) for s in (0, 1)]


@pytest.mark.parametrize("kw", [
    dict(fine_budget=12, coarse_rgb=True),
    dict(fine_budget=12, coarse_share=2),
    dict(grid=True, fine_budget=12, coarse_share=2),
])
def test_plain_render_with_levers_matches_jax(full_width, kw):
    plain_vs_jax(*full_width, kw)


@pytest.mark.parametrize("kw", [dict(), dict(fine_budget=12, coarse_share=2)])
def test_plain_render_with_the_proposal_as_coarse_net_matches_jax(full_width, kw):
    plain_vs_jax(proposal_params(), full_width[1], kw, coarse_dims=(2, 128))


def test_lever_checks_match_jax(full_width):
    sd = nerf_state_dict_from_flax(full_width[0])
    s = RenderSettings(n_samples=NC, n_samples_fine=NF)
    build = lambda **kw: FusedNerfRenderer.from_params(sd, sd, s, device="cpu", **kw)
    for kw, match in ((dict(fine_budget=17, coarse_rgb=False), "fine_budget"),
                      (dict(coarse_share=0, coarse_rgb=False), "coarse_share"),
                      (dict(coarse_share=2), "coarse_rgb=False"),
                      (dict(sigma_grid=(torch.zeros(2, 2, 2), tg.GridSpec(GRID_LO, GRID_HI))),
                       "coarse_rgb=False")):
        with pytest.raises(ValueError, match=match):
            build(**kw)
    r = build(coarse_share=2, coarse_rgb=False)
    ro, rd = (torch.from_numpy(a) for a in rays(5))
    with pytest.raises(ValueError, match="divisible"):
        r.render(ro, rd)
    # the full budget takes the exact path
    exact, full = build(coarse_rgb=False), build(coarse_rgb=False, fine_budget=NC + NF)
    ro, rd = (torch.from_numpy(a) for a in rays(8))
    assert all(torch.equal(exact.render(ro, rd)[k], full.render(ro, rd)[k])
               for k in ("rgb", "t_exp", "acc"))


# ---------------------------------------------------------------- stylized


@pytest.fixture(scope="module")
def style_scene():
    from tgtc.models.style_field import (
        StyleFieldConfig,
        init_latents,
        make_style_mlps,
    )

    key = jax.random.PRNGKey(0)
    cfg = JNerfConfig()
    pc, pf = (tree(j_make_nerf(cfg, k)[1]) for k in (key, jax.random.fold_in(key, 1)))
    field = StyleFieldConfig(style_d=8, width=256, latent_dim=32, embed_dim=cfg.input_ch)
    _, p_concat, _, p_style = make_style_mlps(field, jax.random.fold_in(key, 2))
    lat = init_latents(jax.random.fold_in(key, 3), 1, 4, 32)
    return dict(pc=pc, pf=pf, concat=tree(p_concat), style=tree(p_style), lat=tree(lat))


def style_vs_jax(scene, kw):
    """The stylized fused render of both packages with the levers ``kw``
    (``grid=True`` for the grid, ``proposal=True`` for the D2xW128 trunk)
    and JAX's coarse jitter."""
    kw = dict(kw)
    coarse_rgb = kw.pop("coarse_rgb", False)
    prop = proposal_params() if kw.pop("proposal", False) else None
    ro, rd = rays()
    sid, fid = np.zeros(N_RAYS, np.int32), np.ones(N_RAYS, np.int32)
    key = jax.random.PRNGKey(7)
    settings = dict(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    jr = JStyle.from_params(scene["pc"], scene["pf"], scene["concat"], scene["style"],
                            scene["lat"], JSettings(**settings), tile=128, interpret=True,
                            llff_tile=False, coarse_rgb=coarse_rgb,
                            proposal=None if prop is None else (prop, 2, 128, 4),
                            **_levers(kw, True))
    ref = jr.render(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(sid), jnp.asarray(fid), key)
    rc = N_RAYS // kw.get("coarse_share", 1)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (rc, NC))))  # JAX's coarse jitter
    sd_c, sd_s = style_state_dicts_from_flax({"concat": scene["concat"],
                                              "style": scene["style"]})
    pr = FusedStyleRenderer.from_params(
        nerf_state_dict_from_flax(scene["pc"]), nerf_state_dict_from_flax(scene["pf"]), sd_c,
        sd_s, latent_state_from_jax(scene["lat"], device="cpu"), RenderSettings(**settings),
        llff_tile=False, coarse_rgb=coarse_rgb, device="cpu",
        proposal=None if prop is None else (nerf_state_dict_from_flax(prop), 2, 128, 4),
        **_levers(kw, False))
    out = pr.render(torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(sid).long(),
                    torch.from_numpy(fid).long(), u=u)
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], np.asarray(ref[k]), atol=TOL_FUSED)
    return out


@pytest.mark.parametrize("kw", [
    dict(proposal=True, fine_budget=12, coarse_share=2),
    dict(grid=True, fine_budget=12),
    dict(fine_budget=12, coarse_rgb=True),
])
def test_style_render_with_levers_matches_jax(style_scene, kw):
    style_vs_jax(style_scene, kw)


def test_style_proposal_and_grid_are_exclusive(style_scene):
    sd_c, sd_s = style_state_dicts_from_flax({"concat": style_scene["concat"],
                                              "style": style_scene["style"]})
    sd = nerf_state_dict_from_flax(style_scene["pc"])
    with pytest.raises(ValueError, match="pick one"):
        FusedStyleRenderer.from_params(
            sd, sd, sd_c, sd_s, latent_state_from_jax(style_scene["lat"], device="cpu"),
            RenderSettings(), coarse_rgb=False, device="cpu",
            sigma_grid=(torch.zeros(2, 2, 2), tg.GridSpec(GRID_LO, GRID_HI)),
            proposal=(nerf_state_dict_from_flax(proposal_params()), 2, 128, 4))
