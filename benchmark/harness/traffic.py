"""The benchmark's inputs, made on the device from the seed: camera paths, the
rays of each view, synthetic images and seeded weights.

Nothing here imports the program. The camera path and the rays are written
out from the reference implementation's definitions (NeRF's
``render_path_spiral`` and ``get_rays`` + ``ndc_rays``, LLFF convention:
OpenGL camera axes, z-depth directions), so that the benchmark hands the same
rays to the program and to the plain reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

MIX = 0x9E3779B97F4A7C15  # odd: seed -> seed * MIX is one to one mod 2^64


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit generator seed for ``(seed, *keys)``: distinct streams for the
    weights, the feed of each step, each frame's jitter and the check's
    sample."""
    s = seed % (1 << 64)
    for k in keys:
        s = ((s + 1) * MIX + k) % (1 << 64)
    return s % (1 << 63)


def generator(device, seed: int, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


# ---------------------------------------------------------------- cameras


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _view_matrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    z = _normalize(z)
    x = _normalize(np.cross(up, z))
    y = _normalize(np.cross(z, x))
    return np.stack([x, y, z, pos], 1)


def spiral_poses(rads: Sequence[float], focus: float, zrate: float, rots: int,
                 n_views: int) -> np.ndarray:
    """``[n_views, 3, 4]`` camera-to-world poses on NeRF's spiral
    (``render_path_spiral``) around the identity average pose, up +y."""
    c2w = np.eye(4)[:3]
    up = np.array([0.0, 1.0, 0.0])
    r = np.array(list(rads) + [1.0])
    poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n_views + 1)[:-1]:
        c = c2w @ (np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * r)
        z = _normalize(c - c2w @ np.array([0.0, 0.0, -focus, 1.0]))
        poses.append(_view_matrix(z, up, c))
    return np.stack(poses, 0)


def rays(h: int, w: int, focal: float, poses: np.ndarray, device, ndc_near: float = 1.0
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC rays of every pixel of every pose: ``rays_o, rays_d [V, H*W, 3]``
    (f32, on ``device``), row-major pixels, principal point at the centre."""
    c2w = torch.as_tensor(poses, dtype=torch.float32, device=device)
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    dirs = torch.stack([(i - 0.5 * w) / focal, -(j - 0.5 * h) / focal, -torch.ones_like(i)],
                       -1).reshape(-1, 3)
    rd = torch.einsum("pc,vbc->vpb", dirs, c2w[:, :, :3])
    ro = c2w[:, None, :, 3].expand(rd.shape)
    # NDC (NeRF's ndc_rays): origins onto the near plane, then projected
    t = -(ndc_near + ro[..., 2]) / rd[..., 2]
    ro = ro + t[..., None] * rd
    ax, ay = -2.0 * focal / w, -2.0 * focal / h
    o = torch.stack([ax * ro[..., 0] / ro[..., 2], ay * ro[..., 1] / ro[..., 2],
                     1.0 + 2.0 * ndc_near / ro[..., 2]], -1)
    d = torch.stack([ax * (rd[..., 0] / rd[..., 2] - ro[..., 0] / ro[..., 2]),
                     ay * (rd[..., 1] / rd[..., 2] - ro[..., 1] / ro[..., 2]),
                     -2.0 * ndc_near / ro[..., 2]], -1)
    return o.contiguous(), d.contiguous()


def camera(config: Dict) -> Tuple[int, int, float]:
    return int(config["H"]), int(config["W"]), float(config["focal"])


def render_poses(config: Dict) -> np.ndarray:
    p = config["render_path"]
    return spiral_poses(p["rads"], p["focus"], p["zrate"], p["rots"], p["n_views"])


def train_poses(config: Dict) -> np.ndarray:
    p = config["train_views"]
    return spiral_poses(p["rads"], p["focus"], p["zrate"], 1, p["n_views"])


def smooth_images(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """``n`` synthetic photographs ``[n, h, w, 3]``: a smooth colour field a
    channel, 0.7 ± 0.25 with one to three periods across the frame and
    seeded phases (a photograph is smooth and its mean is off the 0.5 that
    a fresh network renders, so the first gradients do not cancel as they
    do against noise)."""
    freq = torch.randint(1, 4, (2, n, 1, 1, 3), generator=gen, device=device).float()
    phase = 2 * math.pi * torch.rand((2, n, 1, 1, 3), generator=gen, device=device)
    y = torch.linspace(0, 1, h, device=device)[None, :, None, None]
    x = torch.linspace(0, 1, w, device=device)[None, None, :, None]
    return 0.7 + 0.25 * torch.sin(2 * math.pi * freq[0] * x + phase[0]) * torch.cos(
        2 * math.pi * freq[1] * y + phase[1])


# ---------------------------------------------------------------- weights


def linear_shapes(config: Dict) -> List[Tuple[str, int, int]]:
    """``(name, out, in)`` of every layer of one NeRF trunk, under the
    reference's layer names."""
    d, w = int(config["netdepth"]), int(config["netwidth"])
    skips = [int(s) for s in config["skips"]]
    in_c = 3 + 6 * int(config["multires"])
    in_d = 3 + 6 * int(config["multires_views"])
    shapes = [("base_layers.0", w, in_c)]
    for i in range(d - 1):
        shapes.append((f"base_layers.{i + 1}", w, w + in_c if i in skips else w))
    shapes += [("sigma_layer", 1, w), ("base_remap_layer", 256, w),
               ("rgb_layers.0", w // 2, 256 + in_d), ("rgb_layers.1", 3, w // 2)]
    return shapes


def style_shapes(config: Dict) -> List[Tuple[str, int, int]]:
    """``(name, out, in)`` of the concat MLP (``concat.*``) and the style MLP
    (``style.*``) under the reference's layer names."""
    sd, w, lat = int(config["style_D"]), int(config["netwidth"]), int(config["vae_latent"])
    skip, emb = 4, 3 + 6 * int(config["multires"])
    shapes = []
    for i in range(min(sd - 1, skip + 1)):
        n_in = (emb if i == 0 else w) + lat + (emb if i == skip else 0)
        shapes.append((f"concat.layers.{i}", w, n_in))
    for i in range(sd - 1):
        n_in = (256 + w + emb if i == 0 else w) + lat + (emb if i == skip else 0)
        shapes.append((f"style.layers.{i}", w, n_in))
    shapes.append((f"style.layers.{sd - 1}", 3, w + lat))
    return shapes


def draw_linears(gen: torch.Generator, shapes: List[Tuple[str, int, int]], bias_std: float,
                 device) -> Dict[str, torch.Tensor]:
    """He-normal weights (std sqrt(2 / fan_in)) and normal biases of std
    ``bias_std`` for every ``(name, out, in)``, from one draw on ``device``."""
    total = sum(o * i + o for _, o, i in shapes)
    flat = torch.randn(total, generator=gen, device=device)
    out, k = {}, 0
    for name, o, i in shapes:
        out[f"{name}.weight"] = flat[k: k + o * i].view(o, i) * math.sqrt(2.0 / i)
        k += o * i
        out[f"{name}.bias"] = flat[k: k + o] * bias_std
        k += o
    return out
