"""The Phase-E dataset — port of tgtc/data/style_dataset.py.

Every Phase-E tensor lives on the device once, in :class:`StyleSceneData`:
Phase B's renders, Phase C3's stylized frames per (style, frame), the rays
of every view and the per-style features. A batch is a gather.

Two streams:

* **main** — uniform-random rays over (style, frame, pixel);
* **coherent** — one pixel block revisited across consecutive frames (the
  mechanism of the coherence loss). Its pixel ids come from a generator
  seeded by ``(seed, style_start, block)`` only, never by the step, so the
  same pixels recur for every frame of a cycle.

The counters follow the reference's rule (:func:`advance_coh_counters`):
the frame advances every batch, a finished frame cycle advances the pixel
block, an exhausted pixel space advances the style. They are host ints:
each depends only on the earlier counters, so a step reads them without a
device sync. Ids can be passed in as tensors (the tests feed JAX's draws);
otherwise they are drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tgtc_torch.data.llff import LlffScene
from tgtc_torch.data.rays import rays_for_poses
from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.utils.seeds import step_seed


@dataclasses.dataclass
class StyleSceneData:
    """Device-resident Phase-E tensors."""

    rays_o: torch.Tensor          # [F, H, W, 3]
    rays_d: torch.Tensor          # [F, H, W, 3]
    images: torch.Tensor          # [F, H, W, 3]  NeRF renders (rgb_origin)
    stylized: torch.Tensor        # [S, F, H, W, 3] f32
    style_features: torch.Tensor  # [S, 1024]
    near: float = 0.0
    far: float = 1.0

    @property
    def style_num(self) -> int:
        return self.stylized.shape[0]

    @property
    def frame_num(self) -> int:
        return self.stylized.shape[1]

    @property
    def hw(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]


def _read_rgb(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def load_style_scene(scene: LlffScene, gen_dir: str, stylized_dir: str, use_ndc: bool = True,
                     pixel_alignment: bool = False, device: DeviceLike = None
                     ) -> StyleSceneData:
    """Phase-E tensors on ``device`` from Phase B's renders (``gen_dir``,
    ``rgb_*.png``) and Phase C3's output (``stylized_dir``: ``%03d.jpg``
    frames, 1-indexed, and ``stylized_data.npz``). Each style's frames come
    from the directory the npz's ``style_paths`` records; a recorded
    directory missing on this machine falls back to ``stylized_dir`` with a
    warning, and when every style of several collapses to that one
    directory, ``FileNotFoundError``."""
    dev = resolve_device(device)
    h, w, _ = scene.hwf
    images = np.stack([_read_rgb(p) for p in sorted(Path(gen_dir).glob("rgb_*.png"))], 0)
    f = images.shape[0]

    npz = np.load(os.path.join(stylized_dir, "stylized_data.npz"), allow_pickle=True)
    style_features = np.asarray(npz["style_features"], np.float32)
    s = style_features.shape[0]
    style_dirs = ([str(p) for p in npz["style_paths"]] if "style_paths" in npz
                  else [stylized_dir] * s)
    missing = [d for d in style_dirs if not os.path.isdir(d)]
    if missing:
        print(f"[style_dataset] WARNING: {len(missing)} recorded style dir(s) missing on this "
              f"machine (e.g. {missing[0]}); falling back to {stylized_dir}", flush=True)
    style_dirs = [d if os.path.isdir(d) else stylized_dir for d in style_dirs]
    style_dirs += [stylized_dir] * (s - len(style_dirs))
    if s > 1 and len(set(style_dirs)) == 1 and missing:
        # all S styles would load the same frames while their features differ
        raise FileNotFoundError(
            f"all {s} styles' recorded frame dirs are missing and collapse to the single "
            f"fallback {stylized_dir}; restore the per-style dirs recorded in "
            f"stylized_data.npz (style_paths) or re-run Phase C3")
    stylized = np.zeros((s, f, h, w, 3), np.float32)
    for si in range(s):
        for j in range(f):
            stylized[si, j] = _read_rgb(os.path.join(style_dirs[si], f"{j + 1:03d}.jpg"))

    ro, rd = rays_for_poses(h, w, scene.intrinsics, scene.poses, use_ndc=use_ndc,
                            pixel_alignment=pixel_alignment, device=dev)
    put = lambda a: torch.from_numpy(a).to(dev)
    return StyleSceneData(rays_o=ro, rays_d=rd, images=put(images), stylized=put(stylized),
                          style_features=put(style_features), near=scene.near, far=scene.far)


def synthetic_style_scene(generator: torch.Generator, s: int, f: int, h: int, w: int,
                          device: DeviceLike = None) -> StyleSceneData:
    """A random tiny instance for tests, drawn from ``generator`` (on the
    host) and moved to ``device``."""
    dev = resolve_device(device)
    draw = lambda fn, *shape: fn(shape, generator=generator).to(dev)
    return StyleSceneData(
        rays_o=draw(torch.rand, f, h, w, 3) - 0.5,
        rays_d=draw(torch.randn, f, h, w, 3),
        images=draw(torch.rand, f, h, w, 3),
        stylized=draw(torch.rand, s, f, h, w, 3),
        style_features=draw(torch.randn, s, 1024),
    )


def _gather(data: StyleSceneData, style_id: torch.Tensor, frame_id: torch.Tensor,
            hid: torch.Tensor, wid: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {
        "rays_o": data.rays_o[frame_id, hid, wid],
        "rays_d": data.rays_d[frame_id, hid, wid],
        "rgb_gt": data.stylized[style_id, frame_id, hid, wid],
        "rgb_origin": data.images[frame_id, hid, wid],
        "style_id": style_id,
        "frame_id": frame_id,
    }


def gather_main_batch(data: StyleSceneData, batch: int, idx: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The main stream: ``idx [batch]`` flat ids over (style, frame, row,
    column), drawn uniformly from ``generator`` when not given."""
    s, f = data.style_num, data.frame_num
    h, w = data.hw
    dev = data.images.device
    if idx is None:
        idx = torch.randint(0, s * f * h * w, (batch,), generator=generator, device=dev)
    idx = idx.to(dev).long()
    rem = idx % (f * h * w)
    return _gather(data, idx // (f * h * w), rem // (h * w), (rem % (h * w)) // w, rem % w)


def coh_pixel_ids(data: StyleSceneData, style_start: int, block: int, batch: int,
                  seed: int = 0) -> torch.Tensor:
    """The coherent stream's flat pixel ids ``[batch]``, from a generator
    seeded by (seed, style, block) alone: the same for every frame of one
    cycle."""
    h, w = data.hw
    dev = data.images.device
    gen = torch.Generator(device=dev).manual_seed(step_seed(step_seed(seed, style_start), block))
    return torch.randint(0, h * w, (batch,), generator=gen, device=dev)


def gather_coh_batch(data: StyleSceneData, style_start: int, frame_start: int, block: int,
                     batch: int, pix: Optional[torch.Tensor] = None, seed: int = 0
                     ) -> Dict[str, torch.Tensor]:
    """The coherent stream: ``pix [batch]`` flat pixel ids of frame
    ``frame_start`` of style ``style_start``, :func:`coh_pixel_ids` when not
    given."""
    h, w = data.hw
    dev = data.images.device
    if pix is None:
        pix = coh_pixel_ids(data, style_start, block, batch, seed)
    pix = pix.to(dev).long()
    full = lambda v: torch.full((batch,), v, dtype=torch.long, device=dev)
    return _gather(data, full(style_start), full(frame_start), pix // w, pix % w)


def nearby_camera_batch(cps: np.ndarray, batch: int, rng: np.random.Generator,
                        factor: float = 0.01) -> np.ndarray:
    """Indices of ``batch`` cameras near a random anchor, drawn by inverse
    pose distance (the reference's nearby-camera batching)."""
    n = cps.shape[0]
    anchor = int(rng.integers(n))
    d = np.linalg.norm(cps[:, :3, 3] - cps[anchor, :3, 3], axis=-1)
    p = 1.0 / (d + factor)
    p[anchor] = p.max()
    p = p / p.sum()
    rest = rng.choice(n, size=batch - 1, replace=batch - 1 > n - 1, p=p)
    return np.concatenate([[anchor], rest])


def gather_patch_batch(data: StyleSceneData, style_id: int, frame_id: int, hid: int, wid: int,
                       patch: int) -> Dict[str, torch.Tensor]:
    """A ``patch`` x ``patch`` square of rays centred near (``hid``, ``wid``)
    and clamped inside the frame, flattened row-major (the reference's
    patch batch)."""
    h, w = data.hw
    y0 = min(max(hid - patch // 2, 0), h - patch)
    x0 = min(max(wid - patch // 2, 0), w - patch)
    crop = lambda a: a[y0: y0 + patch, x0: x0 + patch].reshape(patch * patch, -1)
    dev = data.images.device
    full = lambda v: torch.full((patch * patch,), v, dtype=torch.long, device=dev)
    return {
        "rays_o": crop(data.rays_o[frame_id]),
        "rays_d": crop(data.rays_d[frame_id]),
        "rgb_origin": crop(data.images[frame_id]),
        "rgb_gt": crop(data.stylized[style_id, frame_id]),
        "style_id": full(style_id),
        "frame_id": full(frame_id),
    }


def advance_coh_counters(style_start: int, frame_start: int, block: int, start: int,
                         style_num: int, frame_num: int, batch: int, hw: int
                         ) -> Tuple[int, int, int, int]:
    """The reference's counter rule: ``(style_start, frame_start, block,
    start)`` after one batch."""
    next_style = frame_start == frame_num - 1 and style_start != style_num - 1 and start >= hw
    if next_style:
        return style_start + 1, 0, 0, 0
    if frame_start != frame_num - 1:
        return style_start, frame_start + 1, block, start
    return style_start, 0, block + 1, start + batch
