"""The Phase-E dataset on the CPU: tgtc_torch.data.style_dataset against
tgtc.data.style_dataset on a scene the test writes (2 styles, 3 frames of
8x8) and on numpy-seeded tensors.

* ``load_style_scene``: renders and stylized frames bit for bit JAX's, the
  rays to 1e-6, the features equal; the flat-layout fallback (a recorded
  style directory missing) loads what JAX's does, with its warning; every
  style of several collapsing to the fallback raises ``FileNotFoundError``
  on both sides.
* ``gather_main_batch`` / ``gather_coh_batch`` / ``gather_patch_batch``
  given JAX's ids equal JAX's gathers bit for bit.
* ``advance_coh_counters`` equals JAX's over 500 transitions of three
  scene shapes.
* The coherent stream's pixels are one set for every frame of a cycle and
  change with the block; ``nearby_camera_batch`` draws what JAX's draws from
  the same ``np.random.Generator``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tgtc.data import style_dataset as jsd
from tgtc.data.llff import LlffScene as JScene
from tgtc_torch.data import style_dataset as tsd
from tgtc_torch.data.llff import LlffScene
from test_torch_ops import close

torch.set_num_threads(1)

S, F, H, W = 2, 3, 8, 8
TOL_RAYS = 1e-6


def _poses(f=F, h=H, w=W):
    rng = np.random.default_rng(1)
    poses = np.zeros((f, 3, 5), np.float32)
    for i in range(f):
        a = 0.1 * rng.standard_normal()
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = 0.1 * rng.standard_normal(3)
        poses[i, :, 4] = (h, w, 9.0)
    return poses


def _scenes():
    poses = _poses()
    kw = dict(images=np.zeros((F, H, W, 3), np.float32), poses=poses,
              bds=np.tile(np.float32([[1.0, 5.0]]), (F, 1)), render_poses=poses, i_test=0)
    return JScene(**kw), LlffScene(**kw)


def _write(root, record_dirs=True, s=S):
    """Phase B's renders and Phase C3's frames under ``root``; with
    ``record_dirs`` False the npz records directories that do not exist and
    the frames sit in the flat layout (the fallback's)."""
    rng = np.random.default_rng(2)
    gen, sty = os.path.join(root, "gen"), os.path.join(root, "stylized")
    os.makedirs(gen)
    for i in range(F):
        Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(
            os.path.join(gen, f"rgb_{i:05d}.png"))
    dirs = []
    for si in range(s):
        d = os.path.join(sty, f"style_{si:02d}") if record_dirs else sty
        os.makedirs(d, exist_ok=True)
        for i in range(F):
            Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(
                os.path.join(d, f"{i + 1:03d}.jpg"))
        dirs.append(d if record_dirs else os.path.join(root, "elsewhere", f"style_{si:02d}"))
    np.savez(os.path.join(sty, "stylized_data.npz"), style_paths=np.array(dirs),
             style_features=rng.standard_normal((s, 1024)).astype(np.float32))
    return gen, sty


def _assert_scene_equal(got, want):
    for k in ("images", "stylized", "style_features"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k))), k
    for k in ("rays_o", "rays_d"):
        close(getattr(got, k), np.asarray(getattr(want, k)), TOL_RAYS)
    assert (got.style_num, got.frame_num, got.hw) == (want.style_num, want.frame_num, want.hw)


def test_load_style_scene_matches_jax(tmp_path):
    gen, sty = _write(str(tmp_path))
    js, ts = _scenes()
    want = jsd.load_style_scene(js, gen, sty)
    got = tsd.load_style_scene(ts, gen, sty, device="cpu")
    _assert_scene_equal(got, want)
    assert got.stylized.shape == (S, F, H, W, 3)
    # distinct frames per style: the per-style dirs were read
    assert not torch.equal(got.stylized[0], got.stylized[1])


def test_flat_layout_fallback_matches_jax(tmp_path, capsys):
    gen, sty = _write(str(tmp_path), record_dirs=False, s=1)
    js, ts = _scenes()
    want = jsd.load_style_scene(js, gen, sty)
    got = tsd.load_style_scene(ts, gen, sty, device="cpu")
    _assert_scene_equal(got, want)
    out = capsys.readouterr().out
    assert out.count("falling back to") == 2  # JAX's warning, then the port's


def test_all_styles_collapsing_raises(tmp_path):
    gen, sty = _write(str(tmp_path), record_dirs=False, s=2)
    js, ts = _scenes()
    with pytest.raises(FileNotFoundError, match="collapse"):
        jsd.load_style_scene(js, gen, sty)
    with pytest.raises(FileNotFoundError, match="collapse"):
        tsd.load_style_scene(ts, gen, sty, device="cpu")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    arrays = dict(rays_o=rng.standard_normal((F, H, W, 3), np.float32),
                  rays_d=rng.standard_normal((F, H, W, 3), np.float32),
                  images=rng.uniform(0, 1, (F, H, W, 3)).astype(np.float32),
                  stylized=rng.uniform(0, 1, (S, F, H, W, 3)).astype(np.float32),
                  style_features=rng.standard_normal((S, 1024), np.float32))
    return (jsd.StyleSceneData(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tsd.StyleSceneData(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _assert_batch_equal(got, want):
    assert set(got) == set(want)
    for k in got:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]).astype(got[k].numpy().dtype)), k


def test_gathers_equal_jax_given_its_ids():
    jd, td = _data()
    key = jax.random.PRNGKey(4)
    want = jsd.gather_main_batch(jd, key, 64)
    ids = jax.random.randint(key, (64,), 0, S * F * H * W)  # the gather's own draw
    _assert_batch_equal(tsd.gather_main_batch(td, 64, idx=torch.from_numpy(np.array(ids))), want)
    for style, frame, block in ((0, 0, 0), (1, 2, 5)):
        want = jsd.gather_coh_batch(jd, key, jnp.asarray(style), jnp.asarray(frame),
                                    jnp.asarray(block), 32)
        pix_key = jax.random.fold_in(jax.random.fold_in(key, style), block)
        pix = torch.from_numpy(np.array(jax.random.randint(pix_key, (32,), 0, H * W)))
        _assert_batch_equal(tsd.gather_coh_batch(td, style, frame, block, 32, pix=pix), want)
    for args in ((1, 2, 0, 0, 4), (0, 1, 7, 7, 4), (1, 0, 3, 5, 8)):
        want = jsd.gather_patch_batch(jd, *(jnp.asarray(a) for a in args[:4]), args[4])
        _assert_batch_equal(tsd.gather_patch_batch(td, *args), want)


@pytest.mark.parametrize("s,f,batch,hw", [(2, 3, 16, 64), (1, 20, 256, 1024), (3, 1, 8, 20)])
def test_advance_coh_counters_matches_jax(s, f, batch, hw):
    jfn = jax.jit(jsd.advance_coh_counters, static_argnums=(4, 5, 6, 7))
    got = want = (0, 0, 0, 0)
    for _ in range(500):
        want = tuple(int(x) for x in jfn(*(jnp.asarray(v, jnp.int32) for v in want), s, f,
                                          batch, hw))
        got = tsd.advance_coh_counters(*got, s, f, batch, hw)
        assert got == want
    print(f"[parity] coherence counters after 500 steps (S {s}, F {f}): {got}")


def test_coh_pixels_are_stable_within_a_cycle():
    _, td = _data()
    a = tsd.gather_coh_batch(td, 1, 0, 3, 16, seed=9)
    b = tsd.gather_coh_batch(td, 1, 2, 3, 16, seed=9)
    pix = tsd.coh_pixel_ids(td, 1, 3, 16, seed=9)
    hid, wid = pix // W, pix % W
    assert torch.equal(a["rgb_origin"], td.images[0, hid, wid])
    assert torch.equal(b["rgb_origin"], td.images[2, hid, wid])
    assert not torch.equal(pix, tsd.coh_pixel_ids(td, 1, 4, 16, seed=9))
    assert not torch.equal(pix, tsd.coh_pixel_ids(td, 0, 3, 16, seed=9))


def test_nearby_camera_batch_matches_jax():
    cps = np.tile(np.eye(4, dtype=np.float32), (10, 1, 1))
    cps[:, :3, 3] = np.random.default_rng(3).standard_normal((10, 3))
    for batch in (4, 12):
        got = tsd.nearby_camera_batch(cps, batch, np.random.default_rng(5))
        assert np.array_equal(got, jsd.nearby_camera_batch(cps, batch, np.random.default_rng(5)))


def test_synthetic_scene_draws_from_its_generator():
    a, b = (tsd.synthetic_style_scene(torch.Generator().manual_seed(1), S, F, H, W, device="cpu")
            for _ in range(2))
    assert torch.equal(a.stylized, b.stylized) and a.stylized.shape == (S, F, H, W, 3)
    assert a.style_features.shape == (S, 1024) and (a.style_num, a.frame_num) == (S, F)
