"""The 2D stylization network on the CPU: tgtc_torch's transformer, decoder
and StyTrans against tgtc's, on the same numpy-seeded inputs and the same
weights carried across by ``convert.stytrans_state_dicts_from_flax``.

* f32 against JAX's "xla" path: 1e-4 on ``hs`` and the image, the style
  feature 1e-4 relative; all three ``pos_mode``s, square and rectangular
  content/style grids.
* bf16, the port's flash path (K6's twin on CPU tensors) against JAX's
  ``attn_impl="flash"`` (Pallas interpret): max|Δ| <= 5e-2 · max|JAX|; the
  bf16 "xla" branches likewise.
* The converter round trip flax → torch → flax, and JAX's own torch
  converters applied to the port's state dicts, bit for bit.
* ``train.pretrained`` loads reference-named ``.pth`` files (newest first,
  ``new_ps.*`` dropped) and refuses a wrong-shape one loudly; without a
  ``vgg_normalised.pth`` the VGG stays random.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.decoder import (
    Decoder as JDecoder,
    convert_torch_decoder,
    upsample_nearest as j_upsample_nearest,
)
from tgtc.models.stytrans import StyTrans as JStyTrans, style_feature_from_tokens as j_feature
from tgtc.models.torch_compat import convert_torch_patch_embed, convert_torch_transformer
from tgtc.models.vgg import reflect_pad as j_reflect_pad
from tgtc.models.transformer import (
    PatchEmbed as JPatchEmbed,
    StyleTransformer as JStyleTransformer,
    TransformerConfig as JConfig,
)
from tgtc_torch.convert import stytrans_flax_from_state_dicts, stytrans_state_dicts_from_flax
from tgtc_torch.models.decoder import upsample_nearest
from tgtc_torch.models.stytrans import make_stytrans, style_feature_from_tokens
from tgtc_torch.models.transformer import TransformerConfig
from tgtc_torch.models.vgg import reflect_pad
from tgtc_torch.train.pretrained import overlay_stytrans
from test_torch_ops import close

torch.set_num_threads(1)

NARROW = dict(d_model=32, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
              dim_feedforward=64)
TOL_F32, TOL_BF16_REL = 1e-4, 5e-2
GRIDS = {"square": ((32, 32), (32, 32)), "rect": ((40, 48), (24, 32))}  # content, style


def jax_params(seed=0):
    """A narrow flax StyTrans tree (embedding, transformer, decode), every
    leaf moved off its init value by numpy noise so that biases and
    LayerNorm parameters matter."""
    cfg = JConfig(**NARROW)
    d = cfg.d_model
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    tok = jnp.zeros((1, 2, 2, d))
    # "icc" makes every encoder's qk projection and "iss" its qkv one
    trans = {mode: JStyleTransformer(cfg).init(k[1], tok, tok, pos_mode=mode)["params"]
             for mode in ("icc", "iss")}
    transformer = {name: ({**sub, "qkv": trans["iss"][name]["qkv"]} if "qk" in sub else sub)
                   for name, sub in trans["icc"].items()}
    tree = {"embedding": JPatchEmbed(embed_dim=d).init(k[0], jnp.zeros((1, 16, 16, 3)))["params"],
            "transformer": transformer,
            "decode": JDecoder().init(k[2], tok)["params"]}
    rng = np.random.default_rng(seed)

    def perturb(x):  # biases (zeros) and LayerNorm scales (ones) only
        x = np.asarray(x)
        if np.all(x == x.flat[0]):
            x = x + np.float32(0.05) * rng.standard_normal(x.shape, np.float32)
        return x

    return {"params": jax.tree.map(perturb, tree)}


@pytest.fixture(scope="module")
def params():
    return jax_params()


def port_model(params, dtype=torch.float32, attn_impl="xla"):
    model = make_stytrans(TransformerConfig(dtype=dtype, attn_impl=attn_impl, **NARROW),
                          torch.Generator().manual_seed(0), device="cpu")
    sds = stytrans_state_dicts_from_flax(params)
    model.embedding.load_state_dict(sds["embedding"])
    model.transformer.load_state_dict(sds["transformer"])
    model.decode.load_state_dict(sds["decoder"])
    return model


def images(grid, seed=1):
    rng = np.random.default_rng(seed)
    (hc, wc), (hs, ws) = GRIDS[grid]
    return (rng.uniform(0, 1, (1, hc, wc, 3)).astype(np.float32),
            rng.uniform(0, 1, (1, hs, ws, 3)).astype(np.float32))


def rel_close(got, want, rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    close(got, want, rel * float(np.abs(want).max()))


@pytest.mark.parametrize("pos_mode", ["ics", "icc", "iss"])
@pytest.mark.parametrize("grid", ["square", "rect"])
def test_transformer_f32_matches_jax(params, pos_mode, grid):
    rng = np.random.default_rng(2)
    (hc, wc), (hs, ws) = GRIDS[grid]
    style = rng.standard_normal((1, hs // 8, ws // 8, 32)).astype(np.float32)
    content = rng.standard_normal((1, hc // 8, wc // 8, 32)).astype(np.float32)
    want = JStyleTransformer(JConfig(**NARROW)).apply(
        {"params": params["params"]["transformer"]}, jnp.asarray(style), jnp.asarray(content),
        pos_mode=pos_mode)
    model = port_model(params)
    got = model.transformer(torch.from_numpy(style), torch.from_numpy(content), pos_mode=pos_mode)
    assert got.shape == (1, hc // 8, wc // 8, 32) and got.dtype == torch.float32
    close(got, np.asarray(want), TOL_F32)


@pytest.mark.parametrize("grid", ["square", "rect"])
def test_stylize_f32_matches_jax(params, grid):
    content, style = images(grid)
    jm = JStyTrans(JConfig(**NARROW))
    ji, jh = jm.apply(params, jnp.asarray(content), jnp.asarray(style), method=jm.stylize)
    im, hs = port_model(params).stylize(torch.from_numpy(content), torch.from_numpy(style))
    assert im.shape == content.shape and im.dtype == torch.float32
    close(im, np.asarray(ji), TOL_F32)
    close(hs, np.asarray(jh), TOL_F32)
    rel_close(style_feature_from_tokens(hs), j_feature(jh), TOL_F32)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
@pytest.mark.parametrize("grid", ["square", "rect"])
def test_stylize_bf16_matches_jax(params, attn_impl, grid):
    content, style = images(grid, seed=3)
    jm = JStyTrans(JConfig(dtype=jnp.bfloat16, attn_impl=attn_impl, **NARROW))
    ji, jh = jm.apply(params, jnp.asarray(content), jnp.asarray(style), method=jm.stylize)
    im, hs = port_model(params, torch.bfloat16, attn_impl).stylize(
        torch.from_numpy(content), torch.from_numpy(style))
    rel_close(im, ji, TOL_BF16_REL)
    rel_close(hs, jh, TOL_BF16_REL)


@pytest.mark.parametrize("pos_mode", ["ics", "icc", "iss"])
def test_transformer_bf16_flash_matches_jax_flash(params, pos_mode):
    rng = np.random.default_rng(4)
    style, content = (rng.standard_normal((1, 4, 4, 32)).astype(np.float32) for _ in range(2))
    cfg = dict(dtype=jnp.bfloat16, attn_impl="flash", **NARROW)
    want = JStyleTransformer(JConfig(**cfg)).apply(
        {"params": params["params"]["transformer"]},
        jnp.asarray(style, jnp.bfloat16), jnp.asarray(content, jnp.bfloat16), pos_mode=pos_mode)
    model = port_model(params, torch.bfloat16, "flash")
    got = model.transformer(torch.from_numpy(style).bfloat16(),
                            torch.from_numpy(content).bfloat16(), pos_mode=pos_mode)
    rel_close(got, want, TOL_BF16_REL)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path


def test_converter_round_trip_is_bitwise(params):
    sds = stytrans_state_dicts_from_flax(params)
    _assert_trees_equal(stytrans_flax_from_state_dicts(sds), params)
    # JAX's own torch converters invert the port's
    back = {"embedding": convert_torch_patch_embed(sds["embedding"])["params"],
            "transformer": convert_torch_transformer(
                sds["transformer"], num_encoder_layers=1, num_decoder_layers=1)["params"],
            "decode": convert_torch_decoder(sds["decoder"])["params"]}
    _assert_trees_equal({"params": back}, params)
    # the port's modules carry exactly these names and shapes
    model = port_model(params)
    for name, module in (("embedding", model.embedding), ("transformer", model.transformer),
                         ("decoder", model.decode)):
        own = module.state_dict()
        assert set(own) == set(sds[name])
        assert all(own[k].shape == sds[name][k].shape for k in own)


def test_vgg_subtree_is_ignored(params):
    """The embedding, transformer and decoder state dicts ignore a ``vgg``
    subtree, which converts into a state dict of its own."""
    kernel = np.random.default_rng(3).standard_normal((3, 3, 3, 64)).astype(np.float32)
    with_vgg = {"params": {**params["params"],
                           "vgg": {"conv1_1": {"kernel": kernel, "bias": np.ones(64, np.float32)}}}}
    a, b = stytrans_state_dicts_from_flax(with_vgg), stytrans_state_dicts_from_flax(params)
    assert set(a) == set(b) | {"vgg"}
    assert all(torch.equal(a[n][k], b[n][k]) for n in b for k in b[n])
    assert torch.equal(a["vgg"]["2.weight"], torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    assert set(a["vgg"]) == {"2.weight", "2.bias"}


def test_pretrained_overlay_loads_newest_and_refuses_wrong_shapes(params, tmp_path, capsys):
    sds = stytrans_state_dicts_from_flax(params)
    pre = tmp_path / "pretrained"
    pre.mkdir()
    old = {k: torch.zeros_like(v) for k, v in sds["transformer"].items()}
    torch.save(old, pre / "transformer_iter_100.pth")
    torch.save({**sds["transformer"], "new_ps.weight": torch.ones(3)},
               pre / "transformer_iter_200.pth")
    torch.save(sds["embedding"], pre / "embedding_iter_200.pth")
    torch.save(sds["decoder"], tmp_path / "decoder.pth")
    model = make_stytrans(TransformerConfig(**NARROW), torch.Generator().manual_seed(5),
                          device="cpu")
    loaded = overlay_stytrans(model, str(tmp_path / "decoder.pth"), str(pre))
    assert loaded == {"vgg": False, "decoder": True, "transformer": True, "embedding": True}
    for name, module in (("embedding", model.embedding), ("transformer", model.transformer),
                         ("decoder", model.decode)):
        own = module.state_dict()
        assert all(torch.equal(own[k], sds[name][k]) for k in own), name

    # a 512-channel decoder does not fit a d_model 32 model: refused, loudly
    wide = make_stytrans(TransformerConfig(), torch.Generator().manual_seed(6), device="cpu")
    torch.save(wide.decode.state_dict(), tmp_path / "decoder_512.pth")
    before = {k: v.clone() for k, v in model.decode.state_dict().items()}
    capsys.readouterr()
    loaded = overlay_stytrans(model, str(tmp_path / "decoder_512.pth"), str(tmp_path / "none"))
    assert loaded == {"vgg": False, "decoder": False, "transformer": False, "embedding": False}
    assert "do NOT fit" in capsys.readouterr().out
    assert all(torch.equal(v, before[k]) for k, v in model.decode.state_dict().items())


def test_training_path_is_not_ported_yet(params):
    """C1's losses and the VGG pyramid are ported; AdaIN's two decoder
    trainers raise, naming ROADMAP."""
    from tgtc_torch.tools import train2d

    model = port_model(params)
    x = torch.zeros(1, 16, 16, 3)
    assert set(model.compute_losses(x, x)) == {"ics", "loss_c", "loss_s", "l_id1", "l_id2"}
    assert [tuple(f.shape) for f in model.encode_pyramid(x)][-1] == (1, 2, 2, 512)
    for task in ("finetune_decoder", "temporal_decoder"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train2d.main(["--task", task], device="cpu")


def test_make_stytrans_is_seeded():
    cfg = TransformerConfig(**NARROW)
    a, b, c = (make_stytrans(cfg, torch.Generator().manual_seed(s), device="cpu").state_dict()
               for s in (1, 1, 2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["transformer.encoder_s.layers.0.qkv.weight"],
                           c["transformer.encoder_s.layers.0.qkv.weight"])


@pytest.mark.parametrize("op", ["upsample_nearest", "reflect_pad"])
def test_layout_helpers_match_jax(op):
    x = np.random.default_rng(7).standard_normal((2, 3, 5, 4)).astype(np.float32)  # NHWC
    if op == "upsample_nearest":
        got = upsample_nearest(torch.from_numpy(x))
        want = j_upsample_nearest(jnp.asarray(x))
    else:  # the port's reflect_pad takes NCHW
        got = reflect_pad(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        want = j_reflect_pad(jnp.asarray(x))
    assert np.array_equal(got.numpy(), np.asarray(want))
