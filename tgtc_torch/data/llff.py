"""LLFF forward-facing scene loader (numpy host-side; arrays go to device once).

The port's own copy of tgtc/data/llff.py (the port imports nothing of
``tgtc``), itself a rewrite of the reference load_llff.py:

* ``poses_bounds.npy`` parsing (N x 17 → 3x5 pose+hwf + 2 bounds)
* in-process image minification (PIL resize) — replaces the reference's
  ImageMagick ``mogrify`` subprocess (the reference load_llff.py:43-49)
* pose recentering around the average camera, optional spherification
* spiral / zflat novel-view path generation (120 views, 2 rotations)

Outputs a :class:`LlffScene` with images ``[N, H, W, 3] float32`` and
4x4 camera poses, ready to be pushed to device memory wholesale.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _view_matrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Camera-to-world basis from forward vector, up hint, and position
    (parity with the reference load_llff.py:121-127)."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Mean camera: average center, summed forward/up
    (parity with ``poses_avg``, the reference load_llff.py:133-142)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_view_matrix(vec2, up, center), hwf], axis=1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rigidly transform all poses so the average camera is identity
    (parity with the reference load_llff.py:158-170)."""
    poses = poses.copy()
    bottom = np.array([[0.0, 0.0, 0.0, 1.0]])
    c2w = average_pose(poses)
    c2w44 = np.concatenate([c2w[:3, :4], bottom], axis=0)
    poses44 = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], (poses.shape[0], 1, 1))], axis=1
    )
    fixed = np.linalg.inv(c2w44) @ poses44
    poses[:, :3, :4] = fixed[:, :3, :4]
    return poses


def spiral_path(
    c2w: np.ndarray,
    up: np.ndarray,
    rads: np.ndarray,
    focal: float,
    zrate: float,
    rots: int,
    n_views: int,
) -> np.ndarray:
    """Spiral novel-view camera path
    (parity with ``render_path_spiral``, the reference load_llff.py:145-154)."""
    poses = []
    rads = np.asarray(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n_views + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads
        )
        z = _normalize(c - c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0]))
        poses.append(np.concatenate([_view_matrix(z, up, c), hwf], axis=1))
    return np.stack(poses, axis=0)


def spherify_poses(
    poses: np.ndarray, bds: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recenter 360-degree captures on the point of minimal ray distance and
    generate a circular render path
    (parity with the reference load_llff.py:175-231)."""
    def p34_to_44(p):
        bottom = np.tile(np.eye(4)[-1].reshape(1, 1, 4), (p.shape[0], 1, 1))
        return np.concatenate([p, bottom], axis=1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    a_i = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b_i = -a_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(a_i, (0, 2, 1)) @ a_i).mean(0)) @ b_i.mean(0)
    )

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], axis=1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0.0, 0.0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], axis=1))
    new_poses = np.stack(new_poses, axis=0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
        axis=-1,
    )
    poses_reset = np.concatenate(
        [
            poses_reset[:, :3, :4],
            np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
        ],
        axis=-1,
    )
    return poses_reset, new_poses, bds


def _list_images(imgdir: str) -> List[str]:
    return [
        os.path.join(imgdir, f)
        for f in sorted(os.listdir(imgdir))
        if f.endswith(_IMG_EXTS)
    ]


def _imread(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def minify(basedir: str, factor: int) -> str:
    """Create ``images_{factor}/`` by in-process resize (replaces the
    reference's ImageMagick subprocess, the reference load_llff.py:6-55;
    the reference also converts everything to png and removes the originals
    — ``mogrify -format png``, :46-52 — so png output is parity).

    Exactly-divisible images go through the native C++ box filter + PNG
    writer (tgtc_torch.utils.native) — mogrify's default scale filter is also an
    area average for integer downsampling; anything else falls back to PIL
    LANCZOS. Idempotent: returns immediately if the target exists.
    """
    from PIL import Image

    from tgtc_torch.utils import native

    imgdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(imgdir):
        return imgdir
    srcdir = os.path.join(basedir, "images")
    files = _list_images(srcdir)
    # Write into a temp dir and atomically rename at the end: the
    # idempotence check above is bare directory existence, so a crash or
    # interrupt mid-minify must not leave a partial images_{factor}/ that
    # every later run would treat as complete.
    tmpdir = imgdir + ".tmp"
    if os.path.exists(tmpdir):
        import shutil

        shutil.rmtree(tmpdir)  # leftover from an interrupted run
    os.makedirs(tmpdir)
    try:
        for f in files:
            out = os.path.join(
                tmpdir, os.path.splitext(os.path.basename(f))[0] + ".png"
            )
            with Image.open(f) as im:
                w, h = im.size
                if h % factor == 0 and w % factor == 0:
                    arr = np.asarray(im.convert("RGB"), np.uint8)
                    native.write_png_async(
                        out, native.resize_box(arr, factor)
                    )
                    continue
                im = im.convert("RGB").resize(
                    (round(w / factor), round(h / factor)), Image.LANCZOS
                )
                im.save(out)
    finally:
        errs = native.wait_writes()
    if errs:
        raise IOError(f"{errs} async png writes failed in {tmpdir}")
    os.rename(tmpdir, imgdir)
    return imgdir


@dataclass
class LlffScene:
    """A fully loaded LLFF scene (host numpy; push to device wholesale)."""

    images: np.ndarray        # [N, H, W, 3] float32 in [0, 1]
    poses: np.ndarray         # [N, 3, 5] pose + hwf column
    bds: np.ndarray           # [N, 2] near/far bounds
    render_poses: np.ndarray  # [M, 3, 5] spiral/circular path
    i_test: int               # holdout view index
    near: float = 0.0
    far: float = 1.0

    @property
    def hwf(self) -> Tuple[int, int, float]:
        h, w, f = self.poses[0, :3, -1]
        return int(h), int(w), float(f)

    @property
    def intrinsics(self) -> np.ndarray:
        h, w, f = self.hwf
        return np.array(
            [[f, 0, 0.5 * w], [0, f, 0.5 * h], [0, 0, 1]], dtype=np.float32
        )

    def c2w44(self, poses: Optional[np.ndarray] = None) -> np.ndarray:
        """Homogeneous 4x4 camera-to-world matrices."""
        p = self.poses if poses is None else poses
        n = p.shape[0]
        out = np.tile(np.eye(4, dtype=np.float32)[None], (n, 1, 1))
        out[:, :3, :4] = p[:, :3, :4]
        return out


def load_poses_bounds(basedir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``poses_bounds.npy`` → (poses [N,3,5], bds [N,2]).

    Includes the LLFF axis fix (down-right-back → right-up-back):
    the reference load_llff.py:239.
    """
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape(-1, 3, 5)
    bds = arr[:, -2:]
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2
    )
    return poses.astype(np.float32), bds.astype(np.float32)


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: Optional[float] = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
    n_render_views: int = 120,
) -> LlffScene:
    """Load an LLFF scene directory into a :class:`LlffScene`.

    Behavioral parity with ``load_llff_data``
    (the reference load_llff.py:233-302): axis reorder, bound rescale by
    ``1/(bds.min()*bd_factor)``, recentering, spiral path with 90th-percentile
    radii and disparity-mean focus depth, nearest-to-average holdout view.
    """
    poses, bds = load_poses_bounds(basedir)

    imgdir = os.path.join(basedir, "images") if factor in (None, 1) else minify(
        basedir, factor
    )
    files = _list_images(imgdir)
    if len(files) != poses.shape[0]:
        raise ValueError(
            f"{len(files)} images vs {poses.shape[0]} poses in {basedir}"
        )
    images = np.stack([_imread(f) for f in files], axis=0)

    # overwrite hwf with actual (downsampled) image size + scaled focal
    poses[:, 0, 4] = images.shape[1]
    poses[:, 1, 4] = images.shape[2]
    poses[:, 2, 4] = poses[:, 2, 4] / (1.0 if factor in (None, 1) else factor)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = average_pose(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        rots = 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w[:3, 3] = c2w[:3, 3] + zloc * c2w[:3, 2]
            rads[2] = 0.0
            rots = 1
            n_render_views = n_render_views // 2
        render_poses = spiral_path(
            c2w, up, rads, focal, zrate=0.5, rots=rots, n_views=n_render_views
        )

    c2w = average_pose(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return LlffScene(
        images=images.astype(np.float32),
        poses=poses.astype(np.float32),
        bds=bds.astype(np.float32),
        render_poses=np.asarray(render_poses, dtype=np.float32),
        i_test=i_test,
    )
