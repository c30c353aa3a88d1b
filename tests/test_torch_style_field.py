"""The style field (tgtc_torch.models.style_field) and its weight bridge
against tgtc.models.style_field.

* Both style MLPs against flax at f32 from converted params: 1e-5. The
  layer counts are pinned: the concat MLP has min(style_d - 1, skip + 1)
  layers (the reference's loop breaks at the skip), the style MLP
  style_d - 1 hidden layers and rgb_out.
* lookup_latents with and without the llff x7 tile, frame ids past the
  table's end included: JAX's gather clamps them to the last row, and so
  must the port. latent_minus_logp and set_latents_from_vae with JAX's
  draws injected: 1e-6.
* flax -> torch -> flax is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models import style_field as js
from tgtc_torch.convert import (
    latent_state_from_jax,
    style_flax_from_state_dicts,
    style_state_dicts_from_flax,
)
from tgtc_torch.models import style_field as ts
from test_torch_ops import close

torch.set_num_threads(1)

FIELDS = {"fern": dict(style_d=8, width=256, latent_dim=32, embed_dim=63, skip=4),
          "narrow": dict(style_d=4, width=32, latent_dim=8, embed_dim=27, skip=2)}


def _flax(name, seed=0):
    cfg = js.StyleFieldConfig(**FIELDS[name])
    cm, p_concat, sm, p_style = js.make_style_mlps(cfg, jax.random.PRNGKey(seed))
    params = {"concat": jax.tree.map(np.asarray, p_concat),
              "style": jax.tree.map(np.asarray, p_style)}
    return cfg, cm, sm, params


def _port(name, params):
    cfg = ts.StyleFieldConfig(**FIELDS[name])
    concat, style = ts.StyleMLPBeforeConcat(cfg), ts.StyleMLPWildMultilayers(cfg)
    sd_c, sd_s = style_state_dicts_from_flax(params)
    concat.load_state_dict(sd_c)
    style.load_state_dict(sd_s)
    return concat, style


@pytest.mark.parametrize("name", ["fern", "narrow"])
def test_style_mlps_match_flax_f32(name):
    cfg, cm, sm, params = _flax(name)
    concat, style = _port(name, params)
    rng = np.random.default_rng(1)
    n = 64
    x = rng.normal(size=(n, cfg.embed_dim)).astype(np.float32)
    lat = rng.normal(size=(n, cfg.latent_dim)).astype(np.float32)
    br = rng.uniform(0, 1, (n, 256)).astype(np.float32)
    cf_ref = np.asarray(cm.apply(params["concat"], jnp.asarray(x), jnp.asarray(lat)))
    with torch.no_grad():
        cf = concat(torch.from_numpy(x), torch.from_numpy(lat))
    close(cf, cf_ref, atol=1e-5)
    concated = np.concatenate([br, cf_ref], -1)
    rgb_ref = np.asarray(sm.apply(params["style"], jnp.asarray(x), jnp.asarray(concated),
                                  jnp.asarray(lat)))
    with torch.no_grad():
        rgb = style(torch.from_numpy(x), torch.from_numpy(concated), torch.from_numpy(lat))
    close(rgb, rgb_ref, atol=1e-5)


def test_layer_counts_and_reference_names():
    cfg = ts.StyleFieldConfig()
    concat, style = ts.make_style_mlps(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert cfg.n_concat == 5 and len(concat.layers) == 5
    assert len(style.layers) == 8 and style.layers[-1].out_features == 3  # 7 + rgb_out
    assert concat.layers[0].in_features == 63 + 32
    assert concat.layers[4].in_features == 256 + 32 + 63  # [h | lat | x] at the skip
    assert style.layers[0].in_features == 256 + 256 + 63 + 32
    assert style.layers[4].in_features == 256 + 32 + 63
    assert set(concat.state_dict()) == {f"layers.{i}.{k}" for i in range(5)
                                        for k in ("weight", "bias")}
    assert set(style.state_dict()) == {f"layers.{i}.{k}" for i in range(8)
                                       for k in ("weight", "bias")}
    _, _, _, params = _flax("fern")
    assert set(params["concat"]["params"]) == {f"layer_{i}" for i in range(5)}
    assert set(params["style"]["params"]) == {f"layer_{i}" for i in range(7)} | {"rgb_out"}


@pytest.mark.parametrize("name", ["fern", "narrow"])
def test_converter_round_trip_is_bitwise(name):
    _, _, _, params = _flax(name, seed=3)
    back = style_flax_from_state_dicts(*style_state_dicts_from_flax(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(np.asarray(leaf), flat_b[path]), path


def _latents(style_num=2, frame_num=3, dim=8, seed=2):
    return jax.tree.map(np.asarray, js.init_latents(jax.random.PRNGKey(seed), style_num,
                                                    frame_num, dim))


@pytest.mark.parametrize("llff_tile", [True, False])
def test_lookup_latents_matches_jax_and_clamps(llff_tile):
    state = _latents()
    # frame ids past the table's end (6 rows, 42 with the x7 tile), as a
    # 120-pose spiral gives a small scene
    sid = np.array([0, 1, 1, 0, 1, 0, 1, 1], np.int32)
    fid = np.array([0, 2, 1, 5, 7, 40, 119, 3], np.int32)
    ref = js.lookup_latents(jax.tree.map(jnp.asarray, state), jnp.asarray(sid),
                            jnp.asarray(fid), 0.7, llff_tile)
    got = ts.lookup_latents(latent_state_from_jax(state, device="cpu"), torch.from_numpy(sid),
                            torch.from_numpy(fid), 0.7, llff_tile)
    close(got, np.asarray(ref), atol=1e-6)


def test_latent_minus_logp_matches_jax():
    state = _latents()
    sid = np.array([0, 1, 1, 0], np.int32)
    fid = np.array([0, 2, 1, 9], np.int32)
    ref = js.latent_minus_logp(jax.tree.map(jnp.asarray, state), jnp.asarray(sid),
                               jnp.asarray(fid), 0.5, True)
    got = ts.latent_minus_logp(latent_state_from_jax(state, device="cpu"),
                               torch.from_numpy(sid), torch.from_numpy(fid), 0.5, True)
    close(got, np.asarray(ref), atol=1e-5 * max(1.0, abs(float(ref))))


def test_set_latents_from_vae_matches_jax_with_its_draw():
    state = _latents()
    rng = np.random.default_rng(4)
    mu = rng.normal(size=(2, 8)).astype(np.float32)
    logvar = rng.normal(size=(2, 8)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = js.set_latents_from_vae(key, state, jnp.asarray(mu), jnp.asarray(logvar))
    eps = torch.from_numpy(np.array(jax.random.normal(key, (2, 3, 8))))
    got = ts.set_latents_from_vae(latent_state_from_jax(state, device="cpu"),
                                  torch.from_numpy(mu), torch.from_numpy(logvar), eps=eps)
    for k in ("latents", "mu", "logvar"):
        close(got[k], np.asarray(ref[k]), atol=1e-6)


def test_latent_builders_draw_from_their_generator():
    a = ts.init_latents(torch.Generator().manual_seed(0), 2, 3, 8, device="cpu")
    b = ts.init_latents(torch.Generator().manual_seed(0), 2, 3, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "latents": (2, 3, 8), "mu": (2, 8), "logvar": (2, 8)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    s1, s2 = (ts.set_latents_from_vae(a, a["mu"], a["logvar"],
                                      generator=torch.Generator().manual_seed(1))
              for _ in range(2))
    assert torch.equal(s1["latents"], s2["latents"])
