"""Batched pinhole ray generation + NDC projection — port of tgtc/data/rays.py."""

from __future__ import annotations

from typing import Tuple

import torch

from tgtc_torch.device import DeviceLike, resolve_device


def generate_rays(
    h: int,
    w: int,
    intrinsics: torch.Tensor,
    c2w: torch.Tensor,
    pixel_alignment: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel rays for camera-to-world poses ``c2w [..., 3, 4]`` (OpenGL
    convention). Returns ``rays_o, rays_d [..., H, W, 3]`` (unnormalized
    directions, z-depth parameterization)."""
    dev = c2w.device
    i = torch.arange(w, dtype=torch.float32, device=dev)
    j = torch.arange(h, dtype=torch.float32, device=dev)
    if pixel_alignment:
        i = i + 0.5
        j = j + 0.5
    jj, ii = torch.meshgrid(j, i, indexing="ij")  # [H, W] each
    dirs = torch.stack([(ii - intrinsics[0, 2]) / intrinsics[0, 0],
                        -(jj - intrinsics[1, 2]) / intrinsics[1, 1],
                        -torch.ones_like(ii)], dim=-1)  # [H, W, 3]
    # rotate into world frame: [..., 3, 3] applied to [H, W, 3]
    rays_d = torch.einsum("hwc,...bc->...hwb", dirs, c2w[..., :3, :3])
    rays_o = c2w[..., None, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(h: int, w: int, focal: float, near: float, rays_o: torch.Tensor,
             rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift origins to the near plane and project into NDC space."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (w / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (h / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def rays_for_poses(
    h: int,
    w: int,
    intrinsics,
    poses,
    use_ndc: bool = True,
    pixel_alignment: bool = False,
    near: float = 1.0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All rays for a stack of poses ``[N, 3+, 4]`` → ``[N, H, W, 3]`` pair
    on ``device``. ``intrinsics``/``poses`` may be numpy arrays or tensors;
    the focal length is ``intrinsics[0, 0]``."""
    dev = resolve_device(device)
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(poses, dtype=torch.float32, device=dev)[:, :3, :4]
    rays_o, rays_d = generate_rays(h, w, intr, c2w, pixel_alignment)
    if use_ndc:
        rays_o, rays_d = ndc_rays(h, w, float(intr[0, 0]), near, rays_o, rays_d)
    return rays_o, rays_d
