"""The port's 3D IO (tgtc_torch/utils/io3d.py) against the JAX package's
(tgtc/utils/io3d.py) on seeded inputs: every function returns the same
arrays bit for bit and writes the same file bytes."""

import json

import numpy as np
import pytest
from PIL import Image

from tgtc.utils import io3d as jax_io3d
from tgtc_torch.utils import io3d

RNG_SEED = 11


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("colors", ["none", "uint8", "float"])
def test_ply_rgb_writes_and_reads_as_jax(tmp_path, colors):
    rng = np.random.default_rng(RNG_SEED)
    pts = rng.normal(size=(37, 3)).astype(np.float32)
    c = {"none": None, "uint8": rng.integers(0, 256, (37, 3), dtype=np.uint8),
         "float": rng.uniform(-0.2, 1.2, (37, 3))}[colors]
    io3d.write_ply_rgb(str(tmp_path / "port.ply"), pts, c)
    jax_io3d.write_ply_rgb(str(tmp_path / "jax.ply"), pts, c)
    assert _bytes(tmp_path / "port.ply") == _bytes(tmp_path / "jax.ply")
    got = io3d.read_ply(str(tmp_path / "jax.ply"))
    assert _equal(got, jax_io3d.read_ply(str(tmp_path / "port.ply")))
    assert np.array_equal(got[0], pts)


@pytest.mark.parametrize("pixel_alignment", [False, True])
def test_dep2pcl_equals_jax(pixel_alignment):
    rng = np.random.default_rng(RNG_SEED)
    depth = rng.uniform(1, 5, (6, 9)).astype(np.float32)
    intr = np.array([[30.0, 0, 4.5], [0, 30.0, 3.0], [0, 0, 1]], np.float32)
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                          rng.normal(size=(3, 1))], 1).astype(np.float32)
    got = io3d.dep2pcl(depth, intr, c2w, pixel_alignment)
    assert got.shape == (54, 3)
    assert _equal(got, jax_io3d.dep2pcl(depth, intr, c2w, pixel_alignment))


def test_ascii_writers_write_jax_bytes(tmp_path):
    rng = np.random.default_rng(RNG_SEED)
    v = rng.normal(size=(9, 3))
    f = rng.integers(1, 10, (4, 3))
    for name, ours, theirs, args in (
            ("a.obj", io3d.write_obj, jax_io3d.write_obj, (v, f)),
            ("b.obj", io3d.write_obj, jax_io3d.write_obj, (v,)),
            ("c.ply", io3d.write_ply_xyz, jax_io3d.write_ply_xyz, (v,)),
            ("d.json", io3d.json_save_depth, jax_io3d.json_save_depth, (v.astype(np.float32),))):
        ours(str(tmp_path / f"port_{name}"), *args)
        theirs(str(tmp_path / f"jax_{name}"), *args)
        assert _bytes(tmp_path / f"port_{name}") == _bytes(tmp_path / f"jax_{name}"), name


def test_rgbd_and_camera_json_read_as_jax(tmp_path):
    rng = np.random.default_rng(RNG_SEED)
    rgb = tmp_path / "rgb.png"
    Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)).save(rgb)
    depth = rng.uniform(0, 3, (8, 12)).astype(np.float32)
    io3d.json_save_depth(str(tmp_path / "depth.json"), depth)
    for factor in (1.0, 2.0):
        assert _equal(io3d.json_read_rgbd(str(tmp_path / "depth.json"), str(rgb), factor),
                      jax_io3d.json_read_rgbd(str(tmp_path / "depth.json"), str(rgb), factor))
    dimg = tmp_path / "depth.png"
    Image.fromarray(rng.integers(0, 65535, (8, 12), dtype=np.uint16)).save(dimg)
    assert _equal(io3d.read_rgbd(str(dimg), str(rgb)), jax_io3d.read_rgbd(str(dimg), str(rgb)))

    cp, intr = rng.normal(size=(4, 4)), rng.normal(size=(3, 3))
    io3d.json_save_camera_parameters(str(tmp_path / "port_cam.json"), cp, intr)
    jax_io3d.json_save_camera_parameters(str(tmp_path / "jax_cam.json"), cp, intr)
    assert _bytes(tmp_path / "port_cam.json") == _bytes(tmp_path / "jax_cam.json")
    got = io3d.json_read_camera_parameters(str(tmp_path / "jax_cam.json"))
    assert _equal(got, jax_io3d.json_read_camera_parameters(str(tmp_path / "port_cam.json")))
    assert np.array_equal(got[0], cp)

    frame = tmp_path / "frame_00003.json"
    frame.write_text(json.dumps({
        "projectionMatrix": rng.normal(size=16).tolist(), "intrinsics": rng.normal(size=9).tolist(),
        "cameraPoseARFrame": rng.normal(size=16).tolist(), "time": 1.25, "frame_index": 3}))
    assert _equal(io3d.read_frame_pose(str(frame)), jax_io3d.read_frame_pose(str(frame)))
