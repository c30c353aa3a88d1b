"""Phase F end to end on the CPU: tgtc_torch's stylized chain, fused
renderer and frame loop against tgtc's.

* ``style_forward`` against JAX's at f32 (trunk, style MLPs, composite)
  with JAX's σ-noise draws injected: 1e-4.
* ``FusedStyleRenderer`` (K4/K5 twins) against JAX's (Pallas interpret,
  tile 128): D8/W256, style_d 8, 64 rays, 8+8 samples, ``llff_tile``
  False, JAX's coarse jitter injected; rgb, rgb_coarse and t_exp within
  5e-2 (tests/test_style_kernel.py:91 holds the fused JAX path to that),
  with ``coarse_rgb`` True and False. The σ-only coarse pass gives a
  bitwise-equal fine image.
* The eager ``make_stylized_render_fn`` against JAX's at f32, same jitter.
* The frame loop with a stub renderer (the port of
  tests/test_fused_phase_f.py:17-79), ``skip_existing`` and ``frame_sink``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.nerf import NerfConfig as JNerfConfig, make_nerf as j_make_nerf
from tgtc.models.style_field import (
    StyleFieldConfig as JField,
    init_latents as j_init_latents,
    make_style_mlps as j_make_style_mlps,
)
from tgtc.render.fast_style import FusedStyleRenderer as JFused
from tgtc.render.style import style_forward as j_style_forward
from tgtc.render.volume import RenderSettings as JSettings
from tgtc.train.render_style import make_stylized_render_fn as j_make_stylized_render_fn
from tgtc_torch.convert import (
    latent_state_from_jax,
    nerf_state_dict_from_flax,
    style_state_dicts_from_flax,
)
from tgtc_torch.models.nerf import NerfConfig, NerfMLP
from tgtc_torch.models.style_field import (
    StyleFieldConfig,
    StyleMLPBeforeConcat,
    StyleMLPWildMultilayers,
)
from tgtc_torch.render.fast_style import FusedStyleRenderer, block_generator
from tgtc_torch.render.style import style_forward
from tgtc_torch.render.volume import RenderSettings
from tgtc_torch.train.render_style import (
    make_stylized_render_fn,
    render_stylized_frames_fused,
    render_stylized_views,
)
from test_torch_ops import close

torch.set_num_threads(1)

NC = NF = 8
TOL_FUSED, TOL_F32 = 5e-2, 1e-4


def _jax_scene(compute_dtype=jnp.bfloat16, seed=0):
    """Two trunks, both style MLPs and a 1-style, 4-frame latent table, as
    JAX modules and numpy params."""
    key = jax.random.PRNGKey(seed)
    cfg = JNerfConfig(compute_dtype=compute_dtype)
    tree = lambda t: jax.tree.map(np.asarray, t)
    (mc, pc), (mf, pf) = (j_make_nerf(cfg, k) for k in (key, jax.random.fold_in(key, 1)))
    field = JField(style_d=8, width=256, latent_dim=32, embed_dim=cfg.input_ch)
    cm, p_concat, sm, p_style = j_make_style_mlps(field, jax.random.fold_in(key, 2))
    lat = j_init_latents(jax.random.fold_in(key, 3), 1, 4, 32)
    return dict(mc=mc, mf=mf, cm=cm, sm=sm, pc=tree(pc), pf=tree(pf),
                style={"concat": tree(p_concat), "style": tree(p_style)}, lat=tree(lat))


def _port_models(scene, dtype=torch.float32):
    trunks = []
    for p in (scene["pc"], scene["pf"]):
        m = NerfMLP(NerfConfig(compute_dtype=dtype))
        m.load_state_dict(nerf_state_dict_from_flax(p))
        trunks.append(m)
    cfg = StyleFieldConfig()
    concat, style = StyleMLPBeforeConcat(cfg), StyleMLPWildMultilayers(cfg)
    sd_c, sd_s = style_state_dicts_from_flax(scene["style"])
    concat.load_state_dict(sd_c)
    style.load_state_dict(sd_s)
    return trunks, concat, style


@pytest.fixture(scope="module")
def scene():
    return _jax_scene()


def _rays(n=64, seed=1):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    return ro, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


def _ids(n):
    return np.zeros(n, np.int32), np.ones(n, np.int32)


def _port_renderer(scene, coarse_rgb):
    sd_c, sd_s = style_state_dicts_from_flax(scene["style"])
    return FusedStyleRenderer.from_params(
        nerf_state_dict_from_flax(scene["pc"]), nerf_state_dict_from_flax(scene["pf"]),
        sd_c, sd_s, latent_state_from_jax(scene["lat"], device="cpu"),
        RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0),
        llff_tile=False, coarse_rgb=coarse_rgb, device="cpu")


@pytest.mark.parametrize("coarse_rgb", [True, False])
def test_fused_style_renderer_matches_jax(scene, coarse_rgb):
    ro, rd = _rays()
    sid, fid = _ids(64)
    key = jax.random.PRNGKey(7)
    jr = JFused.from_params(scene["pc"], scene["pf"], scene["style"]["concat"],
                            scene["style"]["style"], scene["lat"],
                            JSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0),
                            tile=128, interpret=True, llff_tile=False, coarse_rgb=coarse_rgb)
    ref = jr.render(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(sid), jnp.asarray(fid), key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (64, NC))))  # JAX's coarse jitter
    out = _port_renderer(scene, coarse_rgb).render(
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(sid),
        torch.from_numpy(fid), u=u)
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], np.asarray(ref[k]), atol=TOL_FUSED)


def test_sigma_only_coarse_gives_bitwise_equal_fine_image(scene):
    ro, rd, (sid, fid) = *(torch.from_numpy(a) for a in _rays()), map(torch.from_numpy, _ids(64))
    u = torch.rand((64, NC), generator=torch.Generator().manual_seed(0))
    full = _port_renderer(scene, True).render(ro, rd, sid, fid, u=u)
    sig = _port_renderer(scene, False).render(ro, rd, sid, fid, u=u)
    assert "rgb_coarse" not in sig
    for k in ("rgb", "t_exp"):
        assert torch.equal(full[k], sig[k])


def test_render_image_pads_the_tail_and_seeds_each_block(scene):
    r = _port_renderer(scene, False)
    ro, rd = (torch.from_numpy(a) for a in _rays(40))
    blocked = r.render_image(ro, rd, 0, 1, block=16, seed=3)  # 16 + 16 + 8 (padded)
    u = torch.cat([torch.rand((16, NC), generator=block_generator(3, 1, start, "cpu"))
                   for start in (0, 16, 32)])
    sid, fid = torch.zeros(48, dtype=torch.long), torch.ones(48, dtype=torch.long)
    pad = lambda t, v: torch.cat([t, torch.full((8, 3), v)])
    whole = r.render(pad(ro, 0.0), pad(rd, 1.0), sid, fid, u=u)
    for k in whole:
        assert blocked[k].shape == (40,) + whole[k].shape[1:]
        close(blocked[k], whole[k][:40], atol=1e-6)


@pytest.mark.parametrize("kw", [{"fine_budget": 12}, {"coarse_share": 2}, {"grid": True},
                                {"proposal": True}])
def test_unported_options_raise(scene, kw):
    """The levers this renderer once refused now render as JAX's do, each
    alone (tests/test_torch_render_levers.py combines them)."""
    from test_torch_render_levers import style_vs_jax

    out = style_vs_jax(dict(pc=scene["pc"], pf=scene["pf"], concat=scene["style"]["concat"],
                            style=scene["style"]["style"], lat=scene["lat"]), kw)
    assert out["rgb"].shape == (64, 3)


@pytest.fixture(scope="module")
def scene_f32():
    return _jax_scene(jnp.float32, seed=4)


def test_style_forward_matches_jax_f32(scene_f32):
    s = scene_f32
    ro, rd = _rays(32, seed=2)
    sid = np.array([0, 0] * 16, np.int32)
    fid = np.arange(32, dtype=np.int32) % 6  # ids past the 4 frames clamp
    ts = np.sort(np.random.default_rng(3).uniform(0, 1, (32, 16)), -1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    comp, weights, sigma = j_style_forward(
        s["mc"], s["pc"], s["cm"], s["style"]["concat"], s["sm"], s["style"]["style"],
        jax.tree.map(jnp.asarray, s["lat"]), jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(ts), jnp.asarray(sid), jnp.asarray(fid), sigma_scale=0.8,
        llff_tile=True, noise_std=1.0, noise_key=key, with_sigma=True)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (32, 16))))
    (trunk, _), concat, style = _port_models(s)
    t = lambda a: torch.from_numpy(a)
    with torch.no_grad():
        out = style_forward(trunk, concat, style, latent_state_from_jax(s["lat"], device="cpu"),
                            t(ro), t(rd), t(ts), t(sid), t(fid), sigma_scale=0.8,
                            llff_tile=True, noise_std=1.0, noise=noise, with_sigma=True)
    for got, want in zip((out[0].rgb, out[0].t_exp, out[1], out[2]),
                         (comp.rgb, comp.t_exp, weights, sigma)):
        close(got, np.asarray(want), atol=TOL_F32)


def test_eager_stylized_render_matches_jax_f32(scene_f32):
    s = scene_f32
    ro, rd = _rays(32, seed=6)
    key = jax.random.PRNGKey(8)
    j_fn = j_make_stylized_render_fn(s["mc"], s["mf"], s["cm"], s["sm"], NC, NF, 0.0, 1.0,
                                     llff_tile=True)
    ref = j_fn(s["pc"], s["pf"], s["style"], jax.tree.map(jnp.asarray, s["lat"]),
               jnp.asarray(ro), jnp.asarray(rd), 0, 2, key)
    (tc, tf), concat, style = _port_models(s)
    fn = make_stylized_render_fn(tc, tf, concat, style, NC, NF, 0.0, 1.0, llff_tile=True)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (32, NC))))
    out = fn(latent_state_from_jax(s["lat"], device="cpu"), torch.from_numpy(ro),
             torch.from_numpy(rd), torch.zeros(32, dtype=torch.long),
             torch.full((32,), 2, dtype=torch.long), u=u)
    for k in ("rgb", "t_exp", "rgb_coarse"):
        close(out[k], np.asarray(ref[k]), atol=TOL_F32)


class _StubRenderer:
    """The ``.render`` contract of FusedStyleRenderer, with a colour per
    (style, frame) so that the order of frames shows."""

    def render(self, bo, bd, sid, fid, generator=None):
        t = torch.linspace(0.0, 1.0, bo.shape[0])
        tag = (sid.float() * 2 + fid.float()) / 8.0
        return {"rgb": torch.stack([t, 1.0 - t, tag], -1), "t_exp": t}


def _frames(tmp_path, name, mode="full", views=2, styles=(0,), **kw):
    h, w = 6, 8
    rng = np.random.default_rng(0)
    ro = torch.from_numpy(rng.uniform(-1, 1, (views, h, w, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(views, h, w, 3)).astype(np.float32))
    out = str(tmp_path / name)
    n = render_stylized_frames_fused(_StubRenderer(), ro, rd, list(styles), out, seed=0,
                                     block=16, depth_png=mode, **kw)
    return out, n, h, w


@pytest.mark.parametrize("mode,depth_size", [("full", (8, 6)), ("half", (4, 3)),
                                             ("off", None)])
def test_frame_loop_depth_png_modes(tmp_path, mode, depth_size):
    from PIL import Image

    out, n, h, w = _frames(tmp_path, mode, mode)
    assert n == 2
    files = sorted(os.listdir(out))
    assert len([f for f in files if "depth" not in f]) == 2
    assert Image.open(os.path.join(out, "style_00000_fine_00000.png")).size == (w, h)
    if depth_size is None:
        assert not any("depth" in f for f in files)
    else:
        d = Image.open(os.path.join(out, "style_00000_fine_depth_00001.png"))
        assert d.size == depth_size


def test_frame_loop_rejects_a_bad_mode(tmp_path):
    with pytest.raises(ValueError, match="full/half/off"):
        _frames(tmp_path, "bad", "tiny")


def test_frame_loop_skips_existing_and_streams_in_playback_order(tmp_path):
    sink = []
    out, n, _, _ = _frames(tmp_path, "sink", styles=(0, 1), frame_sink=sink.append)
    assert n == 4 and len(sink) == 4
    assert all(f.dtype == np.uint8 and f.shape == (6, 8, 3) for f in sink)
    # (style, view) in playback order: blue = (2 s + f) / 8, as uint8
    assert [int(f[0, 0, 2]) for f in sink] == [int(v / 8 * 255 + 0.5) for v in (0, 1, 2, 3)]
    _, n2, _, _ = _frames(tmp_path, "sink", styles=(0, 1))
    assert n2 == 0


def test_eager_views_write_every_png(tmp_path, scene_f32):
    (tc, tf), concat, style = _port_models(scene_f32)
    fn = make_stylized_render_fn(tc, tf, concat, style, 4, 4, 0.0, 1.0, llff_tile=True)
    rng = np.random.default_rng(1)
    ro = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 4, 5, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(2, 4, 5, 3)).astype(np.float32))
    out = str(tmp_path / "eager")
    render_stylized_views(fn, latent_state_from_jax(scene_f32["lat"], device="cpu"), ro, rd,
                          [0], out, seed=1, block=8, depth_png="half")
    assert sorted(os.listdir(out)) == ["style_00000_fine_00000.png", "style_00000_fine_00001.png",
                                       "style_00000_fine_depth_00000.png",
                                       "style_00000_fine_depth_00001.png"]
