"""Phase B — geometry dump; port of tgtc/train/geometry.py.

Renders every training pose with the frozen NeRF and writes, per frame,
``rgb_%05d.png``, ``depth_%05d.png`` (normalized expected depth) and
``geometry_%05d.npz`` (``coor_map`` = per-pixel hit point ``o + t_exp d``,
camera pose ``cps``, ``hwf``, ``near``, ``far``), then the scene-wide
``geometry.npz``. Frames whose npz exists are skipped (resumable).
"""

from __future__ import annotations

import os

import numpy as np

from tgtc_torch.data.llff import LlffScene
from tgtc_torch.data.rays import rays_for_poses
from tgtc_torch.utils import native


def _to8b(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """Async native PNG write, so host encoding overlaps the next render."""
    if img.ndim == 2:
        img = img[..., None]
    native.write_png_async(path, img)


def dump_geometry(
    renderer,
    scene: LlffScene,
    out_dir: str,
    use_ndc: bool = True,
    pixel_alignment: bool = False,
    block: int = 16384,
    skip_existing: bool = True,
) -> str:
    """Render all training poses and write the Phase-B artifact set.

    ``renderer`` has ``device`` and ``render_image(rays_o, rays_d, block)``
    returning ``{"rgb": [N, 3], "t_exp": [N]}`` (e.g. FusedNerfRenderer);
    rays are made on its device."""
    os.makedirs(out_dir, exist_ok=True)
    h, w, focal = scene.hwf
    cps = scene.c2w44()
    hwf = np.array([h, w, focal], np.float32)

    all_coor = []
    for i in range(scene.poses.shape[0]):
        geo_path = os.path.join(out_dir, f"geometry_{i:05d}.npz")
        if skip_existing and os.path.exists(geo_path):
            all_coor.append(np.load(geo_path)["coor_map"])
            continue
        ro, rd = rays_for_poses(h, w, scene.intrinsics, scene.poses[i: i + 1],
                                use_ndc=use_ndc, pixel_alignment=pixel_alignment,
                                device=renderer.device)
        ro_f, rd_f = ro.reshape(-1, 3), rd.reshape(-1, 3)
        out = renderer.render_image(ro_f, rd_f, block=block)
        rgb = out["rgb"].cpu().numpy().reshape(h, w, 3)
        t_exp = out["t_exp"].cpu().numpy().reshape(h, w)
        coor = (ro_f + out["t_exp"][:, None] * rd_f).cpu().numpy()
        coor = coor.reshape(h, w, 3).astype(np.float32)

        save_png(os.path.join(out_dir, f"rgb_{i:05d}.png"), _to8b(rgb))
        t_norm = (t_exp - t_exp.min()) / max(t_exp.max() - t_exp.min(), 1e-8)
        save_png(os.path.join(out_dir, f"depth_{i:05d}.png"), _to8b(t_norm))
        np.savez(geo_path, coor_map=coor, cps=cps[i].astype(np.float32),
                 hwf=hwf, near=np.float32(scene.near), far=np.float32(scene.far))
        all_coor.append(coor)

    np.savez(os.path.join(out_dir, "geometry.npz"),
             coor_maps=np.stack(all_coor, 0), cps=cps.astype(np.float32),
             hwf=hwf, near=np.float32(scene.near), far=np.float32(scene.far))
    errs = native.wait_writes()
    if errs:
        raise IOError(f"{errs} async png writes failed in {out_dir}")
    return out_dir
