"""Data and Phase B: tgtc_torch.data / tgtc_torch.train.geometry against
tgtc on the synthetic LLFF scene (tests/synthetic_scene.py).

Rays (NDC on and off) and the loaded scene match to 1e-6; minify writes
the same pixels; dump_geometry writes the same file set, with coor_map
within 5e-2 (both sides render through their fused trunk in bf16).
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.data import llff as jllff
from tgtc.data.rays import rays_for_poses as j_rays_for_poses
from tgtc_torch.data import llff as tllff
from tgtc_torch.data.rays import rays_for_poses
from test_torch_ops import close

torch.set_num_threads(1)


@pytest.mark.parametrize("use_ndc", [True, False])
@pytest.mark.parametrize("pixel_alignment", [False, True])
def test_rays_for_poses_match(synthetic_llff_dir, use_ndc, pixel_alignment):
    scene = jllff.load_llff_data(synthetic_llff_dir, factor=1)
    h, w, _ = scene.hwf
    ro_j, rd_j = j_rays_for_poses(h, w, jnp.asarray(scene.intrinsics),
                                  jnp.asarray(scene.poses), use_ndc=use_ndc,
                                  pixel_alignment=pixel_alignment)
    ro, rd = rays_for_poses(h, w, scene.intrinsics, scene.poses, use_ndc=use_ndc,
                            pixel_alignment=pixel_alignment, device="cpu")
    assert ro.shape == (scene.poses.shape[0], h, w, 3)
    close(ro.numpy(), np.asarray(ro_j), atol=1e-6, rtol=1e-6)
    close(rd.numpy(), np.asarray(rd_j), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"path_zflat": True},
                                {"recenter": False, "bd_factor": None}])
def test_load_llff_data_matches(synthetic_llff_dir, kw):
    a = jllff.load_llff_data(synthetic_llff_dir, factor=1, **kw)
    b = tllff.load_llff_data(synthetic_llff_dir, factor=1, **kw)
    for field in ("images", "poses", "bds", "render_poses"):
        close(getattr(b, field), getattr(a, field), atol=1e-6)
    assert b.i_test == a.i_test and b.hwf == a.hwf
    np.testing.assert_array_equal(b.intrinsics, a.intrinsics)
    np.testing.assert_array_equal(b.c2w44(), a.c2w44())


def test_spherify_poses_matches():
    """The synthetic cameras all face one way (spherify's fit is singular
    there), so spherify is held on cameras looking at a common centre."""
    rng = np.random.default_rng(0)
    poses = []
    for _ in range(6):
        pos = rng.normal(size=3) + np.array([0.0, 0.0, 4.0])
        poses.append(np.concatenate([jllff._view_matrix(pos, np.array([0.0, 1.0, 0.0]), pos),
                                     np.array([[32.0], [40.0], [50.0]])], axis=1))
    poses = np.stack(poses).astype(np.float32)
    bds = np.tile(np.array([[2.0, 8.0]], np.float32), (6, 1))
    for a, b in zip(jllff.spherify_poses(poses, bds), tllff.spherify_poses(poses, bds)):
        close(b, a, atol=1e-6)


def test_minify_matches(synthetic_llff_dir, tmp_path):
    dirs = []
    for name, mod in (("jax", jllff), ("torch", tllff)):
        root = str(tmp_path / name)
        shutil.copytree(os.path.join(synthetic_llff_dir, "images"),
                        os.path.join(root, "images"))
        shutil.copy(os.path.join(synthetic_llff_dir, "poses_bounds.npy"), root)
        dirs.append(mod.load_llff_data(root, factor=2))
    assert dirs[1].images.shape == (8, 16, 20, 3)
    np.testing.assert_array_equal(dirs[1].images, dirs[0].images)


def test_dump_geometry_matches(synthetic_llff_dir, tmp_path):
    """Two views through both packages' geometry dumps, each with its fused
    renderer (JAX: Pallas in interpret mode; port: the kernels' CPU twins)
    on the same D2/W32 weights."""
    from tgtc.models.nerf import NerfConfig, make_nerf
    from tgtc.render.fast import FusedNerfRenderer as JFused
    from tgtc.render.volume import RenderSettings as JSettings
    from tgtc.train.geometry import dump_geometry as j_dump
    from tgtc_torch.convert import nerf_state_dict_from_flax
    from tgtc_torch.render.fast import FusedNerfRenderer
    from tgtc_torch.render.volume import RenderSettings
    from tgtc_torch.train.geometry import dump_geometry

    arch = dict(depth=2, width=32)
    cfg = NerfConfig(skips=(), **arch)
    params = [jax.tree.map(np.asarray, make_nerf(cfg, jax.random.PRNGKey(s))[1])
              for s in (0, 1)]
    kw = dict(n_samples=8, n_samples_fine=8, sigma_noise_std=0.0)
    jr = JFused.from_params(*params, JSettings(**kw), tile=128, interpret=True,
                            coarse_rgb=False, **arch)
    tr = FusedNerfRenderer.from_params(*(nerf_state_dict_from_flax(p) for p in params),
                                       RenderSettings(**kw), coarse_rgb=False,
                                       device="cpu", **arch)

    def two_views(scene):
        return dataclasses.replace(scene, poses=scene.poses[:2])

    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_dump(jr, two_views(jllff.load_llff_data(synthetic_llff_dir, factor=1)), out_j,
           block=1280)
    dump_geometry(tr, two_views(tllff.load_llff_data(synthetic_llff_dir, factor=1)),
                  out_t, block=1280)
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    assert len(os.listdir(out_t)) == 2 * 3 + 1
    for name in ["geometry.npz", "geometry_00000.npz", "geometry_00001.npz"]:
        a, b = np.load(os.path.join(out_j, name)), np.load(os.path.join(out_t, name))
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            tol = 5e-2 if key.startswith("coor_map") else 1e-6
            close(b[key], a[key], atol=tol)

    # skip-if-exists: a second dump with a renderer that must not be called
    class Refuse:
        device = torch.device("cpu")

        def render_image(self, *a, **k):
            raise AssertionError("frame was re-rendered")

    dump_geometry(Refuse(), two_views(tllff.load_llff_data(synthetic_llff_dir, factor=1)),
                  out_t)


def test_native_shim_matches(tmp_path):
    from PIL import Image

    from tgtc.utils import native as jnative
    from tgtc_torch.utils import native

    img = np.random.default_rng(0).integers(0, 256, (12, 20, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_box(img, 4), jnative.resize_box(img, 4))
    path = str(tmp_path / "x.png")
    native.write_png_async(path, img)
    assert native.wait_writes() == 0
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
