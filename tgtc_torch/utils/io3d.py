"""3D IO utilities: PLY/OBJ point clouds, depth→point cloud, and the RGB-D
and camera JSON files — the port's own copy of tgtc/utils/io3d.py
(host-side numpy; the files it writes are byte for byte the JAX package's).

Rewrites of the reference's IO grab-bag (its utils.py:23-197):
``write_ply_rgb`` / ``read_ply`` (binary little-endian PLY, no plyfile
dependency), ``dep2pcl`` (depth map + intrinsics + pose → world points),
``write_obj`` / ``write_ply_xyz`` (ASCII), and the RGB-D scan and ARKit
camera JSON readers and writers.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np


def write_ply_rgb(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Write ``points [N, 3]`` (+ optional uint8/float ``colors [N, 3]``)
    as binary PLY."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    has_c = colors is not None
    if has_c:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_c:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"], rec["rgb"] = points, colors
            f.write(rec.tobytes())
        else:
            f.write(points.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a binary PLY written by :func:`write_ply_rgb` → (points [N, 3],
    colors [N, 3] uint8 or None)."""
    with open(path, "rb") as f:
        n, has_c = 0, False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property uchar"):
                has_c = True
            elif line == "end_header":
                break
        if has_c:
            rec = np.frombuffer(f.read(n * 15),
                                dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.frombuffer(f.read(n * 12), np.float32).reshape(n, 3)
        return pts.copy(), None


def dep2pcl(depth: np.ndarray, intrinsics: np.ndarray, c2w: np.ndarray,
            pixel_alignment: bool = False) -> np.ndarray:
    """Depth map [H, W] + K + camera-to-world → world points [H*W, 3]
    (the reference's ``dep2pcl``; OpenGL camera: x right, y up, z backward,
    depth measured along -z)."""
    h, w = depth.shape
    i = np.arange(w, dtype=np.float32)
    j = np.arange(h, dtype=np.float32)
    if pixel_alignment:
        i, j = i + 0.5, j + 0.5
    ii, jj = np.meshgrid(i, j, indexing="xy")
    x = (ii - intrinsics[0, 2]) / intrinsics[0, 0] * depth
    y = -(jj - intrinsics[1, 2]) / intrinsics[1, 1] * depth
    z = -depth
    cam = np.stack([x, y, z, np.ones_like(z)], axis=-1).reshape(-1, 4)
    return cam @ np.asarray(c2w[:3, :4], np.float32).T


def write_obj(path: str, v: np.ndarray, f: Optional[np.ndarray] = None) -> None:
    """ASCII OBJ writer (vertices, optional 1-indexed faces; the
    reference's utils.py:51-63)."""
    with open(path, "w") as fh:
        for vv in np.asarray(v):
            fh.write(f"v {vv[0]} {vv[1]} {vv[2]}\n")
        if f is not None:
            for ff in np.asarray(f):
                fh.write(f"f {int(ff[0])} {int(ff[1])} {int(ff[2])}\n")


def write_ply_xyz(path: str, v: np.ndarray) -> None:
    """ASCII xyz-only PLY (the reference's ``write_ply``, utils.py:180-185)."""
    v = np.asarray(v)
    header = ("ply\nformat ascii 1.0\n"
              f"element vertex {len(v)}\n"
              "property double x\nproperty double y\nproperty double z\n"
              "end_header\n")
    with open(path, "w") as fh:
        fh.write(header)
        for vv in v:
            fh.write(f"{vv[0]} {vv[1]} {vv[2]}\n")


# --------------------------------------------------------------- RGB-D json
# (the reference's RGB-D scan residue, utils.py:23-49; cv2.resize replaced
# by PIL 'F'-mode bilinear)


def json_read_rgbd(depth_json_path: str, rgb_path: str, factor: float = 1.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    from PIL import Image

    with open(depth_json_path) as fh:
        depth = np.asarray(json.load(fh), np.float32)
    rgb = Image.open(rgb_path).convert("RGB")
    w, h = rgb.size
    rgb = rgb.resize((int(w / factor), int(h / factor)))
    d_im = Image.fromarray(depth, mode="F").resize(rgb.size, Image.BILINEAR)
    return np.asarray(d_im, np.float32), np.asarray(rgb, np.float32)


def read_rgbd(depth_img_path: str, rgb_path: str) -> Tuple[np.ndarray, np.ndarray]:
    from PIL import Image

    depth = np.asarray(Image.open(depth_img_path), np.float32)
    rgb = Image.open(rgb_path).convert("RGB").resize((depth.shape[1], depth.shape[0]))
    return depth, np.asarray(rgb, np.float32)


def json_save_depth(path: str, depth: np.ndarray) -> None:
    rows = [np.asarray(r).reshape(-1).tolist() for r in depth]
    with open(path, "w") as fh:
        json.dump(rows, fh)


# ------------------------------------------------------- ARKit camera json
# (the reference's utils.py:85-178)


def read_frame_pose(path: str):
    """ARKit ``frame_*.json`` → (projectionMatrix 4x4, intrinsic 3x3,
    cameraPose 4x4, time, index)."""
    with open(path) as fh:
        data = json.load(fh)
    return (np.reshape(data["projectionMatrix"], (4, 4)),
            np.reshape(data["intrinsics"], (3, 3)),
            np.reshape(data["cameraPoseARFrame"], (4, 4)),
            float(data["time"]), int(data["frame_index"]))


def json_read_camera_parameters(path: str):
    """Camera-parameter json → (cameraTransform 4x4, cameraIntrinsics 3x3),
    the only populated fields the reference reads and writes."""
    with open(path) as fh:
        data = json.load(fh)
    return (np.reshape(data["cameraTransform"], (4, 4)),
            np.reshape(data["cameraIntrinsics"], (3, 3)))


def json_save_camera_parameters(path: str, cp: np.ndarray, intr: np.ndarray) -> None:
    save = {"timeStamp": [], "cameraEulerAngle": [], "imageResolution": [],
            "cameraTransform": np.reshape(cp, -1).tolist(), "cameraPos": [],
            "cameraIntrinsics": np.reshape(intr, -1).tolist(),
            "cameraView": [], "cameraProjection": []}
    with open(path, "w") as fh:
        json.dump(save, fh)
