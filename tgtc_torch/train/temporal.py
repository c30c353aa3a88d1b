"""Phase C2 — the decoder finetune with the point-splat temporal loss; port
of tgtc/train/temporal.py and of the C2 loop of tgtc/train/pipeline.py.

Each step stylizes a random patch of a batch of NeRF renders, splats view
0's stylized patch as a point cloud into every view of the batch at full
resolution (:mod:`tgtc_torch.ops.rasterize`, which replaces the reference's
pytorch3d), crops the warped maps back to the patch, and adds
``temporal_weight · mean((ics − warped)² · hit · occl)`` to the four C1
losses, where ``occl`` keeps pixels whose warped world point lies within
``space_dist_threshold`` of the view's own. Only the CNN decoder trains:
C1's optimizer and schedule with ``train_keys=("decode",)``, so the
transformer, the embedding and the VGG are frozen with
``requires_grad_(False)`` and the attention's backward (K7/K8) never runs;
with ``attn_impl="flash"`` every attention site launches K6 forward only.

NDC coor maps are turned into world points first. Patch origins, view ids
and style crops are drawn on the host from one ``np.random.default_rng``
in the pipeline's order (:func:`draw_batch`), so the batches equal the JAX
pipeline's bit for bit; dropout draws from the step's generator seeded by
:func:`~tgtc_torch.utils.seeds.step_seed`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.models.stytrans import StyTrans
from tgtc_torch.ops.rasterize import llff_projection_matrix, ndc_to_world, rasterize_warp
from tgtc_torch.train.transformer2d import (
    TransformerTrainConfig,
    TransformerTrainState,
    TransformerTrainStep,
    init_transformer_train,
)
from tgtc_torch.utils import native
from tgtc_torch.utils.img import from_uint8, to_uint8
from tgtc_torch.utils.logging import MetricsLogger, fetch_scalars
from tgtc_torch.utils.seeds import step_seed

TRAIN_KEYS = ("decode",)
DEBUG_IMAGES = ("stylized_content", "warped_stylized_content", "warped_mask", "coor_dist_msk")


@dataclasses.dataclass(frozen=True)
class TemporalTrainConfig:
    temporal_weight: float = 3500.0
    content_weight: float = 7.0
    style_weight: float = 10.0
    id1_weight: float = 70.0
    id2_weight: float = 1.0
    lr: float = 5e-4
    max_iter: int = 100
    batch_size: int = 4
    patch: int = 256
    space_dist_threshold: float = 5e-2
    splat_radius: float = 1.5


def base_config(cfg: TemporalTrainConfig) -> TransformerTrainConfig:
    """C1's configuration with C2's learning rate and loss weights: the
    optimizer and schedule C2 shares with C1."""
    return TransformerTrainConfig(lr=cfg.lr, content_weight=cfg.content_weight,
                                  style_weight=cfg.style_weight, id1_weight=cfg.id1_weight,
                                  id2_weight=cfg.id2_weight)


@dataclasses.dataclass(frozen=True)
class SplatCamera:
    """The full frame the point cloud is splatted into: its size, focal,
    projection (``[4, 4]`` f32 on the model's device) and whether the coor
    maps are in NDC."""

    proj: torch.Tensor
    h: int
    w: int
    focal: float = 1.0
    is_ndc: bool = True

    @classmethod
    def llff(cls, h: int, w: int, focal: float, is_ndc: bool = True,
             device: DeviceLike = None) -> "SplatCamera":
        proj = torch.from_numpy(llff_projection_matrix(h, w, focal)).to(resolve_device(device))
        return cls(proj, h, w, focal, is_ndc)


def _stylize_and_warp(model: StyTrans, cfg: TemporalTrainConfig, cam: SplatCamera,
                      content: torch.Tensor, coor: torch.Tensor, cps: torch.Tensor,
                      style: torch.Tensor, patch_origin: Tuple[int, int],
                      generator: Optional[torch.Generator]):
    """The shared C2 core: stylize the patch batch, splat view 0's stylized
    point cloud into every view, crop back to the patch, and build the hit
    and occlusion masks. ``(losses, ics, warped_rgb, mask, occl)``."""
    out = model.compute_losses(from_uint8(content), from_uint8(style), deterministic=False,
                               generator=generator)
    ics = out["ics"]  # [B, P, P, 3]
    coor_world = ndc_to_world(coor, cam.h, cam.w, cam.focal) if cam.is_ndc else coor
    warped_rgb, warped_coor, mask = rasterize_warp(
        coor_world[0].reshape(-1, 3), ics[0].reshape(-1, 3), cps, cam.proj, cam.h, cam.w,
        radius=cfg.splat_radius)
    ph, pw = content.shape[1:3]
    # the start clamped so that the patch fits, as lax.dynamic_slice does
    y0 = min(max(int(patch_origin[0]), 0), cam.h - ph)
    x0 = min(max(int(patch_origin[1]), 0), cam.w - pw)
    warped_rgb, warped_coor, mask = (x[:, y0: y0 + ph, x0: x0 + pw]
                                     for x in (warped_rgb, warped_coor, mask))
    dist2 = torch.sum((warped_coor - coor_world) ** 2, dim=-1, keepdim=True)
    occl = (dist2 < cfg.space_dist_threshold ** 2).to(ics.dtype)
    return out, ics, warped_rgb, mask, occl


def temporal_loss(cfg: TemporalTrainConfig, ics: torch.Tensor, warped_rgb: torch.Tensor,
                  mask: torch.Tensor, occl: torch.Tensor) -> torch.Tensor:
    return cfg.temporal_weight * torch.mean((ics - warped_rgb) ** 2 * mask * occl)


class TemporalTrainStep:
    """``step(state, content, coor, cps, style, patch_origin, seed=0) ->
    (state, metrics)``: one C2 update of ``state`` in place (a
    :class:`TransformerTrainState` built with ``train_keys=("decode",)``).

    ``content``/``style`` are ``[B, P, P, 3]`` patches (uint8 or [0, 1]
    floats), ``coor`` the full-frame coor maps cropped to the same patch,
    ``cps [B, 4, 4]`` camera-to-world poses, ``patch_origin`` the patch's
    ``(y0, x0)`` in the full frame; all on the model's device. Dropout draws
    from the C1 step's generator seeded from ``(seed, state.step)``."""

    def __init__(self, model: StyTrans, cfg: TemporalTrainConfig, cam: SplatCamera):
        self.cfg, self.cam = cfg, cam
        self.base = TransformerTrainStep(model, base_config(cfg), TRAIN_KEYS)

    def loss_and_grad(self, model: StyTrans, content, coor, cps, style, patch_origin,
                      generator: Optional[torch.Generator]
                      ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """The metrics and the decoder's gradients, before any update."""
        out, ics, warped_rgb, mask, occl = _stylize_and_warp(
            model, self.cfg, self.cam, content, coor, cps, style, patch_origin, generator)
        loss_t = temporal_loss(self.cfg, ics, warped_rgb, mask, occl)
        loss = self.base.weighted_loss(out) + loss_t
        metrics = {"loss": loss, "loss_c": out["loss_c"], "loss_s": out["loss_s"],
                   "loss_t": loss_t, "l_id1": out["l_id1"], "l_id2": out["l_id2"]}
        return {k: v.detach() for k, v in metrics.items()}, self.base.grads(model, loss)

    def __call__(self, state: TransformerTrainState, content, coor, cps, style, patch_origin,
                 seed: int = 0, generator: Optional[torch.Generator] = None
                 ) -> Tuple[TransformerTrainState, Dict[str, torch.Tensor]]:
        if generator is None:
            generator = self.base.generator(seed, state.step)
        metrics, grads = self.loss_and_grad(state.model, content, coor, cps, style,
                                            patch_origin, generator)
        self.base.apply(state, grads)
        state.step += 1
        return state, metrics


def init_temporal_train(model: StyTrans, cfg: TemporalTrainConfig) -> TransformerTrainState:
    """C2's state from step 0: Adam over the decoder alone, everything else
    frozen."""
    return init_transformer_train(model, base_config(cfg), TRAIN_KEYS)


def make_temporal_train_step(model: StyTrans, cfg: TemporalTrainConfig,
                             cam: SplatCamera) -> TemporalTrainStep:
    return TemporalTrainStep(model, cfg, cam)


def make_temporal_debug_fn(model: StyTrans, cfg: TemporalTrainConfig, cam: SplatCamera
                           ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The end-of-C2 dumps: ``(content, coor, cps, style, patch_origin,
    seed=0) -> {name: uint8 [B, P, P, 3]}`` for each of
    :data:`DEBUG_IMAGES` (the stylized patch, view 0's stylization warped
    into the view, the hit mask, the occlusion mask), with dropout drawn as
    at step 0 of ``seed``."""
    @torch.no_grad()
    def debug(content, coor, cps, style, patch_origin, seed: int = 0):
        generator = torch.Generator(device=content.device).manual_seed(step_seed(seed, 0))
        _, ics, warped_rgb, mask, occl = _stylize_and_warp(
            model, cfg, cam, content, coor, cps, style, patch_origin, generator)
        b3 = lambda m: m.expand(*m.shape[:-1], 3)
        return dict(zip(DEBUG_IMAGES, (to_uint8(x) for x in
                                       (ics, warped_rgb, b3(mask), b3(occl)))))

    return debug


def sample_patch(rng: np.random.Generator, h: int, w: int, patch: int) -> Tuple[int, int]:
    """A random patch origin, drawn on the host (the reference's crop)."""
    if patch <= 0 or patch >= min(h, w):
        return 0, 0
    return int(rng.integers(0, h - patch)), int(rng.integers(0, w - patch))


@dataclasses.dataclass(frozen=True)
class HostBatch:
    """One C2 batch's host draws: the patch origin, the view ids, the style
    crop's origin and the style id."""

    origin: Tuple[int, int]
    ids: np.ndarray
    style_origin: Tuple[int, int]
    style_id: int


def draw_batch(rng: np.random.Generator, h: int, w: int, n_views: int, n_styles: int,
               style_hw: Tuple[int, int], cfg: TemporalTrainConfig) -> HostBatch:
    """The pipeline's draws for one step, in its order: the patch origin,
    the ids, ``sy``, ``sx``, then the style id."""
    patch = min(cfg.patch, h, w)
    origin = sample_patch(rng, h, w, patch)
    ids = rng.integers(0, n_views, cfg.batch_size)
    sy = int(rng.integers(0, style_hw[0] - patch + 1))
    sx = int(rng.integers(0, style_hw[1] - patch + 1))
    return HostBatch(origin, ids, (sy, sx), int(rng.integers(0, n_styles)))


def gather_batch(batch: HostBatch, renders: torch.Tensor, coor_maps: torch.Tensor,
                 cps: torch.Tensor, styles: torch.Tensor, patch: int):
    """``(content, coor, cps, style)`` of ``batch`` from the device-resident
    renders ``[V, H, W, 3]``, coor maps, poses ``[V, 4, 4]`` and styles
    ``[S, Hs, Ws, 3]``; the style crop is repeated over the batch."""
    (y0, x0), (sy, sx) = batch.origin, batch.style_origin
    ids = torch.from_numpy(batch.ids).to(renders.device)
    crop = lambda x: x[ids][:, y0: y0 + patch, x0: x0 + patch]
    style = styles[batch.style_id, sy: sy + patch, sx: sx + patch]
    return (crop(renders), crop(coor_maps), cps[ids],
            style[None].expand(len(batch.ids), -1, -1, -1).contiguous())


def run_temporal_finetune(model: StyTrans, renders: np.ndarray, coor_maps: np.ndarray,
                          cps: np.ndarray, styles: np.ndarray, hwf: Sequence[float],
                          cfg: TemporalTrainConfig = TemporalTrainConfig(), seed: int = 0,
                          is_ndc: bool = True, out_dir: str = ".", device: DeviceLike = None,
                          log_every: int = 20) -> StyTrans:
    """Phase C2 as the pipeline runs it: ``cfg.max_iter`` steps of the
    decoder finetune on ``model`` (which must live on ``device``, the card
    unless told otherwise), from Phase B's ``renders [V, H, W, 3]`` (f32 in
    [0, 1]), ``coor_maps [V, H, W, 3]`` and camera-to-world ``cps [V, 4,
    4]``, with a new style crop every step from ``styles [S, 512, 512, 3]``.

    The host draws come from ``np.random.default_rng(seed)``, dropout from
    ``seed + 4``. Every ``log_every`` steps one line goes to
    ``out_dir/logs/temporal.jsonl`` with ``steps_per_s`` over the steps
    since the last, the window closed by the log's fetch. After the last
    step the debug PNGs ``<name>_<view>.png`` and ``style_image.png`` go to
    ``out_dir``. Returns ``model``, finetuned in place."""
    dev = resolve_device(device)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"the model lives on {next(model.parameters()).device}, C2 was asked "
                         f"for {dev}")
    h, w, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    cam = SplatCamera.llff(h, w, focal, is_ndc, dev)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    renders_d, coor_d, cps_d, styles_d = (put(a) for a in (renders, coor_maps, cps, styles))
    patch = min(cfg.patch, h, w)
    state = init_temporal_train(model, cfg)
    step_fn = make_temporal_train_step(model, cfg, cam)
    rng = np.random.default_rng(seed)
    logger = MetricsLogger(os.path.join(out_dir, "logs"), name="temporal")
    try:
        last_log, t_log = 0, time.perf_counter()
        for i in range(cfg.max_iter):
            batch = draw_batch(rng, h, w, renders.shape[0], styles.shape[0], styles.shape[1:3],
                               cfg)
            args = gather_batch(batch, renders_d, coor_d, cps_d, styles_d, patch)
            state, metrics = step_fn(state, *args, batch.origin, seed=seed + 4)
            if (i + 1) % log_every == 0:
                scalars = fetch_scalars(metrics)  # syncs: closes the window
                scalars["steps_per_s"] = (i + 1 - last_log) / (time.perf_counter() - t_log)
                logger.log(i + 1, scalars, prefix="TEMPORAL")
                last_log, t_log = i + 1, time.perf_counter()
            if i + 1 == cfg.max_iter:  # the logger made out_dir
                dbg = make_temporal_debug_fn(model, cfg, cam)(*args, batch.origin, seed + 4)
                for name, imgs in dbg.items():
                    for b, img in enumerate(imgs.cpu().numpy()):
                        native.write_png_async(os.path.join(out_dir, f"{name}_{b:03d}.png"),
                                               img)
                native.write_png_async(os.path.join(out_dir, "style_image.png"),
                                       args[3][0].cpu().numpy())
    finally:
        logger.close()
    errors = native.wait_writes()
    if errors:
        raise IOError(f"{errors} C2 debug-image writes failed")
    return model
