"""Phase C3 on the CPU: tgtc_torch's ``stylize_all`` against tgtc's on a tiny
``rgb_*.png`` directory (two 36x52 frames, so the edge padding to a
multiple of 8 and the crop back both happen), with one and two styles.

Held: the same file layout (``NNN.jpg``, ``style_XX/`` for more than one
style, ``stylized_data.npz``), the frame-sink images within 1e-4 of JAX's
stylized frames at f32, ``style_features`` within 1e-4 relative, the npz
keys and registry equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tgtc.models.stytrans import StyTrans as JStyTrans
from tgtc.models.transformer import TransformerConfig as JConfig
from tgtc.train.stylize import _pad_to_multiple, stylize_all as j_stylize_all
from tgtc_torch.train.stylize import pad_to_multiple, stylize_all
from test_torch_ops import close
from test_torch_stytrans import NARROW, jax_params, port_model, rel_close

torch.set_num_threads(1)

H, W = 36, 52
TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("c3")
    content = root / "gen"
    content.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        Image.fromarray(img).save(content / f"rgb_{i:05d}.png")
    styles = [rng.uniform(0, 1, (30, 44, 3)).astype(np.float32),
              rng.uniform(0, 1, (64, 48, 3)).astype(np.float32)]
    return root, str(content), styles, jax_params(seed=1)


def _jax_frames(params, content_dir, style):
    """JAX's stylized frames, computed as tgtc.train.stylize does."""
    jm = JStyTrans(JConfig(**NARROW))
    s_im = Image.fromarray((np.clip(style, 0, 1) * 255).astype(np.uint8)).resize(
        (W, H), Image.BILINEAR)
    s = _pad_to_multiple(jnp.asarray(np.asarray(s_im, np.float32) / 255.0)[None])
    out = []
    for f in sorted(os.listdir(content_dir)):
        img = np.asarray(Image.open(os.path.join(content_dir, f)), np.float32) / 255.0
        ics, _ = jm.apply(params, _pad_to_multiple(jnp.asarray(img)[None]), s,
                          method=jm.stylize)
        out.append(np.clip(np.asarray(ics[0, :H, :W]), 0.0, 1.0))
    return out


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("n_styles", [1, 2])
def test_stylize_all_matches_jax(setup, n_styles):
    root, content_dir, styles, params = setup
    styles, names = styles[:n_styles], [f"s{i}.png" for i in range(n_styles)]
    j_out, p_out = root / f"jax_{n_styles}", root / f"port_{n_styles}"
    jm = JStyTrans(JConfig(**NARROW))
    j_res = j_stylize_all(jm, params, content_dir, styles, names, str(j_out))
    sink = []
    p_res = stylize_all(port_model(params), content_dir, styles, names, str(p_out),
                        device="cpu", frame_sink=sink.append)

    files = _files(str(j_out))
    assert files == _files(str(p_out))
    jpgs = [f for f in files if f.endswith(".jpg")]
    assert len(jpgs) == 2 * n_styles
    for f in jpgs:
        assert Image.open(p_out / f).size == (W, H)

    want = [fr for s in styles for fr in _jax_frames(params, content_dir, s)]
    assert len(sink) == len(want)
    for got, ref in zip(sink, want):
        assert got.shape == (H, W, 3) and got.dtype == np.float32
        close(got, ref, TOL)

    rel_close(p_res["style_features"], j_res["style_features"], TOL)
    jz = np.load(j_out / "stylized_data.npz", allow_pickle=True)
    pz = np.load(p_out / "stylized_data.npz", allow_pickle=True)
    assert sorted(jz.files) == sorted(pz.files)
    assert jz["style_names"].item() == pz["style_names"].item()
    assert [os.path.relpath(p, j_out) for p in jz["style_paths"]] == \
        [os.path.relpath(p, p_out) for p in pz["style_paths"]]
    np.testing.assert_array_equal(pz["style_images"], jz["style_images"])
    rel_close(pz["style_features"], jz["style_features"], TOL)
    assert pz["style_features"].shape == (n_styles, 2 * NARROW["d_model"])


def test_pad_to_multiple_matches_jax():
    img = np.random.default_rng(1).uniform(0, 1, (13, 21, 3)).astype(np.float32)
    np.testing.assert_array_equal(pad_to_multiple(img),
                                  np.asarray(_pad_to_multiple(jnp.asarray(img)[None]))[0])
    same = np.zeros((16, 24, 3), np.float32)
    assert pad_to_multiple(same) is same


def test_stylize_all_checks_the_model_device_and_the_frames(setup, tmp_path):
    _, content_dir, styles, params = setup
    model = port_model(params)
    with pytest.raises(ValueError, match="lives on"):
        stylize_all(model, content_dir, styles[:1], ["a"], str(tmp_path / "o"), device="meta")
    with pytest.raises(FileNotFoundError):
        stylize_all(model, str(tmp_path), styles[:1], ["a"], str(tmp_path / "o"), device="cpu")
