"""The port's style-statistics ops and VGG encoder against tgtc's, on the
same numpy-seeded inputs and the same weights.

* ``tgtc_torch.ops.style`` against ``tgtc.ops.style``, f32, 1e-5.
* ``VggEncoder`` pyramid shapes, truncated and full, as
  tests/test_style2d.py:30-62 holds JAX's.
* Features against flax's VggEncoder with the same weights: f32 1e-4, bf16
  2e-2 of max|JAX|.
* ``ceil_max_pool`` on odd sizes, exact.
* ``reflect_pad``: JAX's ``jnp.pad(mode="reflect")`` bit for bit, and its
  fixed-order gradient that of ``jax.vjp`` to f32 rounding (the library's
  CUDA backward adds the reflected bands by atomics, which do not repeat).
* A ``vgg_normalised.pth``-style state dict written by the test loads
  through ``train.pretrained.load_vgg_overlay`` (keys of the layers the
  truncated VGG does not build dropped) and gives JAX's features after its
  ``convert_torch_vgg``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgtc.ops.style as js
from tgtc.models.vgg import VggEncoder as JVgg, ceil_max_pool as j_ceil_max_pool, convert_torch_vgg
from tgtc_torch.convert import stytrans_flax_from_state_dicts, stytrans_state_dicts_from_flax
from tgtc_torch.models.vgg import VggEncoder, ceil_max_pool, make_vgg, reflect_pad
from tgtc_torch.ops import style as ts
from tgtc_torch.train.pretrained import load_vgg_overlay
from test_torch_ops import close

torch.set_num_threads(1)

TOL_OPS, TOL_F32, TOL_BF16_REL = 1e-5, 1e-4, 2e-2
IMG = (2, 37, 45, 3)  # odd sizes: every pool takes the ceil path


def _feat(seed, shape=(2, 6, 5, 8)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("op", ["calc_mean_std", "mean_variance_norm", "gram_matrix",
                                "adaptive_instance_normalization", "gram_style_loss"])
def test_style_ops_match_jax(op):
    one = op in ("calc_mean_std", "mean_variance_norm", "gram_matrix")
    args = (_feat(0),) if one else (_feat(0), _feat(1))
    got = getattr(ts, op)(*(torch.from_numpy(a) for a in args))
    want = getattr(js, op)(*(jnp.asarray(a) for a in args))
    for g, w in zip(got if op == "calc_mean_std" else [got],
                    want if op == "calc_mean_std" else [want]):
        assert tuple(g.shape) == tuple(np.shape(w))
        close(g, np.asarray(w), TOL_OPS)


def test_calc_mean_std_is_unbiased_with_eps_inside():
    x = _feat(2, (1, 3, 3, 2))
    _, std = ts.calc_mean_std(torch.from_numpy(x), eps=0.5)
    want = np.sqrt(x.reshape(9, 2).var(0, ddof=1) + 0.5)
    close(std.reshape(2), want, 1e-6)


def test_coral_matches_jax():
    rng = np.random.default_rng(3)
    src, tgt = rng.uniform(0, 1, (6, 5, 3)), rng.uniform(0, 1, (7, 4, 3))
    got = ts.coral(*(torch.from_numpy(x.astype(np.float32)) for x in (src, tgt)))
    want = js.coral(jnp.asarray(src, jnp.float32), jnp.asarray(tgt, jnp.float32))
    close(got, np.asarray(want), TOL_OPS)


@pytest.mark.parametrize("truncated,last", [(True, (2, 8, 8, 512)), (False, (2, 4, 4, 512))])
def test_pyramid_shapes(truncated, last):
    model = make_vgg(torch.Generator().manual_seed(0), truncated=truncated, device="cpu")
    with torch.no_grad():
        feats = model(torch.ones(2, 64, 64, 3))
    assert [tuple(f.shape) for f in feats] == [(2, 64, 64, 64), (2, 32, 32, 128),
                                               (2, 16, 16, 256), (2, 8, 8, 512), last]
    if truncated:  # the empty fifth stage: relu5_1 is relu4_1
        assert torch.equal(feats[3], feats[4])
    assert len(model) == (31 if truncated else 44)


def test_ceil_max_pool_odd_sizes_exact():
    for shape in ((1, 5, 5, 1), (2, 7, 4, 3), (1, 4, 9, 2)):
        x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
        got = ceil_max_pool(torch.from_numpy(x))
        want = np.asarray(j_ceil_max_pool(jnp.asarray(x)))
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    x = torch.arange(25, dtype=torch.float32).reshape(1, 5, 5, 1)
    assert float(ceil_max_pool(x)[0, 2, 2, 0]) == 24.0


@pytest.mark.parametrize("p", [1, 2, 3])
def test_reflect_pad_and_its_gradient_match_jax(p):
    rng = np.random.default_rng(p)
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    g = rng.standard_normal((2, 3, 5 + 2 * p, 7 + 2 * p)).astype(np.float32)
    pad = lambda a: jnp.pad(a, ((0, 0), (0, 0), (p, p), (p, p)), mode="reflect")
    want, vjp = jax.vjp(pad, jnp.asarray(x))
    want_g = np.asarray(vjp(jnp.asarray(g))[0])
    tx = torch.from_numpy(x).requires_grad_()
    got = reflect_pad(tx, p)
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    got_g = torch.autograd.grad(got, tx, torch.from_numpy(g))[0].numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-6)  # f32 sums of <= 4 terms


@pytest.fixture(scope="module", params=[True, False], ids=["truncated", "full"])
def jax_vgg(request):
    """A flax VggEncoder's params (numpy), every bias moved off 0."""
    truncated = request.param
    params = JVgg(truncated=truncated).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    rng = np.random.default_rng(5)
    tree = jax.tree.map(np.asarray, params["params"])
    for leaf in tree.values():
        leaf["bias"] = leaf["bias"] + np.float32(0.05) * rng.standard_normal(
            leaf["bias"].shape, np.float32)
    return truncated, {"params": tree}


def _port_vgg(jax_vgg, dtype=torch.float32):
    truncated, params = jax_vgg
    model = make_vgg(truncated=truncated, dtype=dtype, device="cpu")
    sds = stytrans_state_dicts_from_flax({"params": {"vgg": params["params"]}})
    model.load_state_dict(sds["vgg"])
    return model


def _img(seed=6):
    return np.random.default_rng(seed).uniform(0, 1, IMG).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_features_match_flax(jax_vgg, dtype):
    truncated, params = jax_vgg
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    x = _img()
    want = JVgg(truncated=truncated, dtype=jdt).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = _port_vgg(jax_vgg, tdt)(torch.from_numpy(x))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        w = np.asarray(w.astype(jnp.float32))
        close(g, w, TOL_F32 if dtype == "f32" else TOL_BF16_REL * float(np.abs(w).max()))


def test_converter_round_trip_is_bitwise(jax_vgg):
    _, params = jax_vgg
    tree = {"params": {"vgg": params["params"]}}
    back = stytrans_flax_from_state_dicts(stytrans_state_dicts_from_flax(tree))
    for name, leaf in params["params"].items():
        for k in ("kernel", "bias"):
            assert np.array_equal(back["params"]["vgg"][name][k], leaf[k]), (name, k)


def test_pth_loads_by_load_state_dict_as_jax_converts_it(tmp_path, capsys):
    """A full 44-layer sequential state dict, as vgg_normalised.pth holds
    (and more: a layer past conv5_1), into the truncated VGG."""
    full = make_vgg(torch.Generator().manual_seed(7), truncated=False, device="cpu")
    sd = {k: v + 0.01 if k.endswith("bias") else v for k, v in full.state_dict().items()}
    sd["46.weight"] = torch.zeros(512, 512, 3, 3)  # conv5_2, never built
    torch.save(sd, tmp_path / "vgg_normalised.pth")
    model = make_vgg(torch.Generator().manual_seed(8), device="cpu")
    assert load_vgg_overlay(model, str(tmp_path / "vgg_normalised.pth"))
    assert "loading pretrained VGG" in capsys.readouterr().out
    x = _img(9)
    jparams = convert_torch_vgg({k: v.numpy() for k, v in sd.items() if k in model.state_dict()})
    want = JVgg().apply(jparams, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        close(g, np.asarray(w), TOL_F32 * max(1.0, float(np.abs(w).max())))
    # missing: the loud random fallback, weights unchanged
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not load_vgg_overlay(model, str(tmp_path / "absent.pth"))
    assert "RANDOM VGG" in capsys.readouterr().out
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_encoder_is_a_sequential_at_the_reference_indices():
    model = VggEncoder(truncated=False)
    convs = [i for i, m in enumerate(model) if isinstance(m, torch.nn.Conv2d)]
    assert convs == [0, 2, 5, 9, 12, 16, 19, 22, 25, 29, 32, 35, 38, 42]
    assert model[0].kernel_size == (1, 1) and model[2].kernel_size == (3, 3)
