"""Phase C3 — bulk stylization and style features; port of
tgtc/train/stylize.py.

Stylizes every Phase-B ``rgb_*.png`` (from :mod:`tgtc_torch.train.geometry`)
with each style image at full resolution, writes ``NNN.jpg`` (1-indexed),
averages the per-frame 2·d_model feature ([token mean ‖ unbiased token
variance] of the stylized token map) over the frames, and writes
``stylized_data.npz`` with the style registry. One style keeps the
reference's flat layout; more write ``style_XX/`` subdirectories.

Frames are edge-padded to a multiple of 8 and cropped back; the style image
is resized to the content size (PIL bilinear, on the host, once per style)
so both share one token grid. JPEGs are encoded on a host thread while the
card stylizes the next frame. The pipeline runs C3 with
``TransformerConfig(dtype=torch.bfloat16, attn_impl="flash")`` on the card:
every attention site launches K6.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.models.stytrans import StyTrans, style_feature_from_tokens


def pad_to_multiple(img: np.ndarray, m: int = 8) -> np.ndarray:
    """Edge-pad ``[H, W, C]`` at the bottom and right to multiples of ``m``."""
    ph, pw = (-img.shape[0]) % m, (-img.shape[1]) % m
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return img


def _load_rgb(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``[H, W, 3]`` float in [0, 1] → ``[h, w, 3]`` through uint8 and PIL
    bilinear, as the JAX package does."""
    from PIL import Image

    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(im.resize((w, h), Image.BILINEAR), np.float32) / 255.0


def _save_jpg(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def _stylize_one_style(model: StyTrans, content_dir: str, style_image: np.ndarray,
                       out_dir: str, device: torch.device, writer: ThreadPoolExecutor,
                       frame_sink: Optional[Callable[[np.ndarray], None]] = None
                       ) -> np.ndarray:
    """Stylize every ``rgb_*.png`` of ``content_dir`` into ``out_dir``
    (``NNN.jpg``, 1-indexed); returns the style's mean feature."""
    os.makedirs(out_dir, exist_ok=True)
    frames = sorted(Path(content_dir).glob("rgb_*.png"))
    if not frames:
        raise FileNotFoundError(f"no rgb_*.png in {content_dir}")
    feats, writes, style = [], [], None
    for i, f in enumerate(frames):
        img = _load_rgb(f)
        h, w = img.shape[:2]
        if style is None:
            style = torch.from_numpy(pad_to_multiple(_resize(style_image, w, h)))[None]
            style = style.to(device)
        content = torch.from_numpy(pad_to_multiple(img))[None].to(device)
        ics, hs = model.stylize(content, style)
        out = ics[0, :h, :w].clamp(0.0, 1.0)
        feats.append(style_feature_from_tokens(hs)[0])
        # the JAX package truncates to uint8 after the clip
        out8 = (out * 255).to(torch.uint8).cpu().numpy()
        writes.append(writer.submit(_save_jpg, os.path.join(out_dir, f"{i + 1:03d}.jpg"), out8))
        if frame_sink is not None:
            frame_sink(out.cpu().numpy())
    for fut in writes:
        fut.result()
    return torch.stack(feats).cpu().numpy().mean(axis=0)


def stylize_all(model: StyTrans, content_dir: str, style_images: List[np.ndarray],
                style_names: List[str], out_dir: str, device: DeviceLike = None,
                frame_sink: Optional[Callable[[np.ndarray], None]] = None
                ) -> Dict[str, np.ndarray]:
    """Phase C3 over every style image (``[H, W, 3]`` float in [0, 1]) on
    ``device`` (the card unless told otherwise; ``model`` must live there).
    ``frame_sink``, if given, receives each stylized frame as a host f32
    ``[H, W, 3]`` array in [0, 1], in order. Returns ``{"style_features":
    [S, 2·d_model]}``."""
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise ValueError(f"the model lives on {p.device}, stylize_all was asked for {dev}")
    os.makedirs(out_dir, exist_ok=True)
    feats, dirs = [], []
    with ThreadPoolExecutor(max_workers=2) as writer:
        for s, img in enumerate(style_images):
            sub = out_dir if len(style_images) == 1 else os.path.join(out_dir, f"style_{s:02d}")
            feats.append(_stylize_one_style(model, content_dir, img, sub, dev, writer,
                                            frame_sink))
            dirs.append(sub)
    style_feature = np.stack(feats, 0).astype(np.float32)
    thumbs = np.stack([_resize(im, 256, 256) for im in style_images], 0)
    np.savez(os.path.join(out_dir, "stylized_data.npz"),
             style_names={n: i for i, n in enumerate(style_names)},
             style_paths=np.array(dirs), style_images=thumbs, style_features=style_feature)
    return {"style_features": style_feature}


def stylize_directory(model: StyTrans, content_dir: str, style_image: np.ndarray,
                      style_name: str, out_dir: str, device: DeviceLike = None
                      ) -> Dict[str, np.ndarray]:
    """One style: :func:`stylize_all` with a single image."""
    return stylize_all(model, content_dir, [style_image], [style_name], out_dir, device)
