"""The end-to-end phase machine — port of tgtc/train/pipeline.py (``Pipeline``).

The newest checkpoint's step decides where Phase A stands, and artifacts on
disk (the geometry dump, the stylized images, the VAE checkpoint) gate the
2D phases. The phases run in sequence in one process and are re-entrant:
kill the run anywhere, run it again, and it resumes from the checkpoints and
the artifacts, with the JAX package's directory layout under
``cfg.exp_dir`` (``ckpt_nerf``, ``ckpt_trans``, ``ckpt_trans_c2``,
``ckpt_vae``, ``ckpt_style``, ``nerf_gen_data2``, ``test``, ``logs``,
``render_*``) and ``<datadir>/stylized_gen_<factor>``.

Phases, each the port's module:
  A  NeRF pretraining            (train.nerf_trainer.train_nerf)
  B  geometry dump               (train.geometry.dump_geometry)
  C1 transformer pretrain        (train.transformer2d.train_transformer)
  C2 decoder temporal finetune   (train.temporal.run_temporal_finetune)
  C3 bulk stylize + features     (train.stylize.stylize_all)
  D  VAE                         (train.vae_trainer.train_vae)
  E  3D style distillation       (train.style3d.run_style3d)
  F  stylized renders            (train.style3d.load_style_field,
                                  train.render_style)

Which renderer runs is decided by the configuration and the device, never by
a failure: :meth:`Pipeline._fused_render_ok` and
:meth:`Pipeline._fused_style_ok` take the fused renderers (K1/K2, K4/K5) on
the card when ``use_pallas`` is set and the architecture is one the CUDA
kernels take; anything else runs the eager PyTorch path. The proposal levers
act on the fused plain and stylized renders, as in the JAX package:
``fine_budget``, ``coarse_share``, and in place of the coarse trunk either
the density grid (``sigma_grid``, built once a process by
:meth:`Pipeline._build_sigma_grid`) or the distilled proposal
(``proposal_width``, fitted once a process by
:meth:`Pipeline._build_proposal`, run by K2 at width 128); Phase A follows
the ``train_fine_budget`` schedule and Phase E its last segment's budget.
Phase B's geometry dump and ``evaluate`` render in full. Each phase's models
and optimizer state are local to its method and are released when it
returns. The JSONL logs go to ``<exp_dir>/logs``: ``nerf``, ``transformer``,
``temporal``, ``vae`` and ``style`` from the phases, ``train`` for the
holdout PSNR (``EVAL``).

A multi-process launch (``torchrun --nproc_per_node=N -m tgtc_torch.cli
...``, or the ``TGTC_*`` / SLURM environments of
:mod:`tgtc_torch.parallel.distributed`) takes :meth:`Pipeline._run_multihost`,
the JAX package's schedule: Phase A over every process, then Phase E over
every process once the 2D artifacts exist; B-D and the renders run in one
process, on the same ``basedir``. Rank 0 alone writes the checkpoints and
the logs.
Not carried over: ``_snap``, ``_feed``, ``_sync_every`` and ``_png_bg``,
devices of the TPU's dispatch and its slow device→host path. The port's
loops sync only at their log steps,
:meth:`~tgtc_torch.train.checkpoint.CheckpointManager.save_device_async`
already snapshots a state on the device, and images go to
:mod:`tgtc_torch.utils.native`'s writer threads.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from tgtc_torch.config import Config
from tgtc_torch.data.llff import LlffScene, load_llff_data
from tgtc_torch.data.prefetch import content_images, list_images
from tgtc_torch.data.rays import rays_for_poses
from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.models.nerf import NerfConfig
from tgtc_torch.models.transformer import TransformerConfig
from tgtc_torch.ops.kernels.nerf_mlp import CUDA_FREQS, CUDA_WIDTH, SIGMA_WIDTHS
from tgtc_torch.ops.kernels.style_kernel import CUDA_SHAPE
from tgtc_torch.parallel import (
    DataGroup,
    is_main_process,
    maybe_initialize_distributed,
    multi_process_launch,
)
from tgtc_torch.train.checkpoint import CheckpointManager
from tgtc_torch.train.nerf_trainer import NerfTrainConfig, NerfTrainState, train_nerf
from tgtc_torch.train.style3d import run_style3d
from tgtc_torch.train.stylize import stylize_all
from tgtc_torch.train.temporal import TemporalTrainConfig, run_temporal_finetune
from tgtc_torch.train.transformer2d import (
    TransformerTrainConfig,
    init_transformer_train,
    train_transformer,
)
from tgtc_torch.utils.logging import MetricsLogger

def _load_image(path: str, size=None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def _kernel_trunk(c: NerfConfig, widths: Tuple[int, ...] = (CUDA_WIDTH,)) -> bool:
    """A trunk the CUDA NeRF kernels take: its skip at 4, a width of
    ``widths``, 10/4 frequencies."""
    return (tuple(c.skips) == (4,) and c.width in widths
            and (c.embed_freq_coor, c.embed_freq_dir) == CUDA_FREQS)


class _EagerNerfRenderer:
    """Both trunks through the eager render (``make_render_fn``), behind the
    fused renderer's ``device`` / ``render_image`` interface."""

    def __init__(self, state: NerfTrainState, train_cfg: NerfTrainConfig, block: int):
        from tgtc_torch.train.nerf_trainer import make_render_fn

        self.state, self.block = state, block
        self._fn = make_render_fn(train_cfg)

    @property
    def device(self) -> torch.device:
        return next(self.state.coarse.parameters()).device

    def render_image(self, rays_o: torch.Tensor, rays_d: torch.Tensor, block=None):
        from tgtc_torch.train.nerf_trainer import render_image

        return render_image(self._fn, self.state.coarse, self.state.fine, rays_o, rays_d,
                            block or self.block)


class Pipeline:
    """The phase machine for one run configuration, on ``device`` (the
    card unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: Config, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = DataGroup()  # every process under _run_multihost
        self._sigma_grid_cache = self._proposal_cache = None
        if cfg.dataset_type != "llff":
            # the reference exits on unknown dataset types
            raise ValueError(f"dataset_type {cfg.dataset_type!r} not supported (llff only)")
        self.exp_dir = cfg.exp_dir
        os.makedirs(self.exp_dir, exist_ok=True)
        self.log_dir = os.path.join(self.exp_dir, "logs")
        self.log = MetricsLogger(self.log_dir)
        self.scene: LlffScene = load_llff_data(cfg.datadir, int(cfg.factor) if cfg.factor else 1,
                                               spherify=cfg.spherify)
        if cfg.no_ndc:
            self.near = float(self.scene.bds.min()) * 0.9
            self.far = float(self.scene.bds.max())
        else:
            self.near, self.far = 0.0, 1.0
        self.scene.near, self.scene.far = self.near, self.far

        arch = dict(embed_freq_coor=cfg.embed_freq_coor, embed_freq_dir=cfg.embed_freq_dir,
                    use_viewdir=cfg.use_viewdir, act_type=cfg.act_type,
                    siren_sigma_mul=cfg.siren_sigma_mul)
        self.nerf_cfg = NerfConfig(depth=cfg.netdepth, width=cfg.netwidth, **arch)
        # the fine net has its own dims (netdepth_fine / netwidth_fine)
        self.nerf_cfg_fine = NerfConfig(depth=cfg.netdepth_fine, width=cfg.netwidth_fine, **arch)
        # the 2D stack: bf16 with flash attention (K6-K8) on the card, f32
        # with the eager attention on the CPU, as the JAX package picks per
        # backend; override before calling a phase method (tests, small runs)
        card = self.device.type == "cuda"
        self.trans_cfg = TransformerConfig(dtype=torch.bfloat16 if card else torch.float32,
                                           attn_impl="flash" if card else "xla")
        self.vae_iters = 2000
        self.vae_patch = 256
        self.gen_dir = os.path.join(self.exp_dir, "nerf_gen_data2")
        self.stylized_dir = os.path.join(cfg.datadir, f"stylized_gen_{cfg.factor}")
        self.trans_ckpt = CheckpointManager(os.path.join(self.exp_dir, "ckpt_trans"),
                                            max_to_keep=2)
        self.nerf_ckpt = CheckpointManager(os.path.join(self.exp_dir, "ckpt_nerf"),
                                           max_to_keep=cfg.ckp_num)
        self.style_ckpt = CheckpointManager(os.path.join(self.exp_dir, "ckpt_style"),
                                            max_to_keep=cfg.ckp_num)
        self.vae_ckpt = CheckpointManager(os.path.join(self.exp_dir, "ckpt_vae"), max_to_keep=1)

    @property
    def _render_block(self) -> int:
        """Rays per render call: the reference's ``--chunk``, rounded up to a
        multiple of 4,096."""
        c = max(4096, int(self.cfg.chunk))
        return ((c + 4095) // 4096) * 4096

    def _check_proposals(self) -> None:
        if self.cfg.proposal_width > 0 and self.cfg.sigma_grid > 0:
            raise ValueError("--proposal_width and --sigma_grid are both frozen-density "
                             "proposals: pick one")

    def _build_sigma_grid(self, state: NerfTrainState):
        """The density-grid proposal (``--sigma_grid N``): the fine trunk's σ
        on an N³ lattice over the bounds of the training and spiral poses'
        rays (K2 at D8×W256), built once a process. ``(values, GridSpec)``,
        or None when off."""
        from tgtc_torch.ops.kernels.nerf_mlp import pack_nerf_params
        from tgtc_torch.render.grid import GridSpec, build_sigma_grid, ray_bounds

        cfg = self.cfg
        if cfg.sigma_grid <= 0:
            return None
        if self._sigma_grid_cache is None:
            t0 = time.perf_counter()
            h, w, _ = self.scene.hwf
            poses = np.concatenate([self.scene.poses, self.scene.render_poses], 0)
            ro, rd = rays_for_poses(h, w, self.scene.intrinsics, poses, use_ndc=not cfg.no_ndc,
                                    pixel_alignment=cfg.pixel_alignment, device=self.device)
            lo, hi = ray_bounds(ro, rd, self.near, self.far)
            del ro, rd
            spec = GridSpec(lo=lo, hi=hi)
            packed = pack_nerf_params(state.fine.state_dict(), depth=cfg.netdepth_fine,
                                      num_freq_coor=cfg.embed_freq_coor,
                                      num_freq_dir=cfg.embed_freq_dir, width=cfg.netwidth_fine,
                                      device=self.device)
            vals = build_sigma_grid(packed, spec, (cfg.sigma_grid,) * 3)
            print(f"[grid] {cfg.sigma_grid}^3 density snapshot built in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            self._sigma_grid_cache = (vals, spec)
        return self._sigma_grid_cache

    def _build_proposal(self, state: NerfTrainState):
        """The distilled proposal (``--proposal_width N``): a
        ``proposal_depth`` x N trunk fitted to the fine trunk's σ on the
        training rays (``render.distill``, seed ``seed + 7``), once a
        process. ``(state dict, depth, width, num_freq_dir)`` for the
        renderers, or None when off."""
        from tgtc_torch.render.distill import distill_proposal

        cfg = self.cfg
        if cfg.proposal_width <= 0:
            return None
        if self._proposal_cache is None:
            t0 = time.perf_counter()
            h, w, _ = self.scene.hwf
            ro, rd = rays_for_poses(h, w, self.scene.intrinsics, self.scene.poses,
                                    use_ndc=not cfg.no_ndc, pixel_alignment=cfg.pixel_alignment,
                                    device=self.device)
            params, stats = distill_proposal(
                cfg.seed + 7, state.fine, ro.reshape(-1, 3), rd.reshape(-1, 3), self.near,
                self.far, depth=cfg.proposal_depth, width=cfg.proposal_width,
                steps=cfg.proposal_steps, n_samples=cfg.N_samples)
            print(f"[proposal] distilled D{cfg.proposal_depth}xW{cfg.proposal_width} in "
                  f"{time.perf_counter() - t0:.1f}s (loss {stats['loss']:.4f}, relu-sigma bias "
                  f"{stats['relu_sigma_bias']:+.3f})", flush=True)
            self._proposal_cache = (params, cfg.proposal_depth, cfg.proposal_width,
                                    cfg.embed_freq_dir)
        return self._proposal_cache

    # ------------------------------------------------------------- phase A

    def _proposal_side_ok(self) -> Optional[bool]:
        """Whether the kernels take what replaces the coarse trunk in the
        lever renders: the distilled proposal (K2 at its width), the grid (no
        trunk); None when nothing replaces it."""
        from tgtc_torch.render.distill import proposal_config

        cfg = self.cfg
        if cfg.proposal_width > 0:
            p = proposal_config(self.nerf_cfg_fine, cfg.proposal_depth, cfg.proposal_width)
            return cfg.use_viewdir and _kernel_trunk(p, SIGMA_WIDTHS)
        return True if cfg.sigma_grid > 0 else None

    def _fused_render_ok(self, levers: bool = False) -> bool:
        """FusedNerfRenderer (K2 coarse, K1 fine) eligibility: on the card
        with ``use_pallas``, the relu trunk with a viewdir rgb head and its
        skip at 4, and the width and frequencies the CUDA kernels take, for
        both nets. ``levers``: the render's coarse side may be the distilled
        proposal or the grid instead (:meth:`_proposal_side_ok`). Anything
        else runs the eager render."""
        cfg = self.cfg
        side = self._proposal_side_ok() if levers else None
        coarse = _kernel_trunk(self.nerf_cfg) if side is None else side
        return (cfg.use_pallas and self.device.type == "cuda" and cfg.act_type == "relu"
                and cfg.use_viewdir and coarse and _kernel_trunk(self.nerf_cfg_fine))

    def _fused_style_ok(self) -> bool:
        """FusedStyleRenderer (K5 coarse, K4 fine) eligibility: on the card
        with ``use_pallas``, the relu trunk, and the one shape the CUDA style
        kernels take (trunk D8/W256 with its skip at 4 and 10 frequencies,
        ``style_D`` 8, style width 256, latent 32) for the fine net, and for
        the coarse one unless the distilled proposal or the grid replaces it
        (:meth:`_proposal_side_ok`). The viewdir head does not matter: the
        style chain discards trunk rgb."""
        cfg = self.cfg
        depth, skip, width, freqs, style_d, style_width, latent = CUDA_SHAPE

        def style_trunk(c: NerfConfig) -> bool:
            return (c.depth, tuple(c.skips), c.width, c.embed_freq_coor) == (
                depth, (skip,), width, freqs)

        side = self._proposal_side_ok()
        coarse = style_trunk(self.nerf_cfg) if side is None else side
        return (cfg.use_pallas and self.device.type == "cuda" and cfg.act_type == "relu"
                and (cfg.style_D, cfg.netwidth, cfg.vae_latent) == (style_d, style_width, latent)
                and coarse and style_trunk(self.nerf_cfg_fine))

    def _nerf_train_cfg(self) -> NerfTrainConfig:
        cfg = self.cfg
        return NerfTrainConfig(batch_size=cfg.batch_size, lrate=cfg.lrate,
                               lrate_decay=cfg.lrate_decay, n_samples=cfg.N_samples,
                               n_samples_fine=cfg.N_samples_fine,
                               sigma_noise_std=cfg.sigma_noise_std, near=self.near,
                               far=self.far, white_bkgd=cfg.white_bkgd)

    def _nerf_setup(self) -> Tuple[NerfTrainState, NerfTrainConfig]:
        """Phase A's state, restored from ``ckpt_nerf`` unless ``no_reload``."""
        from tgtc_torch.train.nerf_trainer import init_state

        train_cfg = self._nerf_train_cfg()
        state = init_state(torch.Generator().manual_seed(self.cfg.seed), self.nerf_cfg,
                           train_cfg, self.nerf_cfg_fine, device=self.device)
        if self.nerf_ckpt.latest_step() is not None and not self.cfg.no_reload:
            state.load_state_dict(self.nerf_ckpt.restore(map_location=self.device))
        return state, train_cfg

    def _nerf_renderer(self, state: NerfTrainState, train_cfg: NerfTrainConfig,
                       levers: bool = False):
        """The plain renderer of :meth:`_fused_render_ok`'s choice: fused
        with a σ-only coarse pass (16,384-ray blocks by default), or eager
        (``_render_block`` rays by default). ``levers``: the fused renderer
        takes the configuration's proposal levers (the eager one, as in the
        JAX package, none)."""
        if not self._fused_render_ok(levers):
            return _EagerNerfRenderer(state, train_cfg, self._render_block)
        from tgtc_torch.render.fast import FusedNerfRenderer
        from tgtc_torch.render.volume import RenderSettings

        cfg = self.cfg
        settings = RenderSettings(n_samples=cfg.N_samples, n_samples_fine=cfg.N_samples_fine,
                                  near=self.near, far=self.far, sigma_noise_std=0.0,
                                  white_bkgd=cfg.white_bkgd)
        kw = dict(num_freq_coor=cfg.embed_freq_coor, num_freq_dir=cfg.embed_freq_dir,
                  depth_fine=cfg.netdepth_fine, width_fine=cfg.netwidth_fine,
                  coarse_rgb=False, device=self.device)
        if not levers:
            return FusedNerfRenderer.from_params(
                state.coarse.state_dict(), state.fine.state_dict(), settings,
                depth=cfg.netdepth, width=cfg.netwidth, **kw)
        self._check_proposals()
        # the distilled proposal renders as the coarse net
        prop = self._build_proposal(state)
        return FusedNerfRenderer.from_params(
            prop[0] if prop else state.coarse.state_dict(), state.fine.state_dict(), settings,
            depth=prop[1] if prop else cfg.netdepth, width=prop[2] if prop else cfg.netwidth,
            fine_budget=cfg.fine_budget or None, coarse_share=cfg.coarse_share,
            sigma_grid=self._build_sigma_grid(state), **kw)

    def train_nerf(self) -> None:
        """Phase A up to ``origin_step`` (the reference's ``Origin_train``):
        resumes from ``ckpt_nerf``, logs every ``i_print`` steps, checkpoints
        every 500; the fused K1 + K3 step where the configuration allows it
        on the card; ``profile_dir`` traces the first 20 steps."""
        cfg = self.cfg
        train_nerf(self.scene, self.nerf_cfg, self._nerf_train_cfg(), cfg.origin_step,
                   self.exp_dir, fine_cfg=self.nerf_cfg_fine, seed=cfg.seed,
                   i_print=cfg.i_print, use_ndc=not cfg.no_ndc,
                   pixel_alignment=cfg.pixel_alignment, device=self.device,
                   ckpt_dir="ckpt_nerf", max_to_keep=cfg.ckp_num, fused=cfg.use_pallas,
                   reload=not cfg.no_reload, profile_dir=cfg.profile_dir,
                   budget_schedule=cfg.train_fine_budget, group=self.group)

    # ------------------------------------------------------------- phase B

    def ensure_geometry(self) -> None:
        """Phase B, skipped when ``geometry.npz`` exists."""
        from tgtc_torch.train.geometry import dump_geometry

        if os.path.exists(os.path.join(self.gen_dir, "geometry.npz")):
            return
        cfg = self.cfg
        state, train_cfg = self._nerf_setup()
        dump_geometry(self._nerf_renderer(state, train_cfg), self.scene, self.gen_dir,
                      use_ndc=not cfg.no_ndc, pixel_alignment=cfg.pixel_alignment)

    # ------------------------------------------------------------- phase C

    def _stytrans_setup(self):
        """StyTrans from ``seed + 2`` with the reference's pretrained assets
        overlaid where they exist (the frozen VGG and the decoder must start
        from ``vgg_normalised.pth`` / ``decoder.pth``)."""
        from tgtc_torch.models.stytrans import make_stytrans
        from tgtc_torch.train.pretrained import overlay_stytrans

        cfg = self.cfg
        model = make_stytrans(self.trans_cfg, torch.Generator().manual_seed(cfg.seed + 2),
                              device=self.device)
        overlay_stytrans(model, decoder_pth_path=cfg.decoder_pth_path,
                         pretrained_dir=os.path.dirname(cfg.vgg_pth_path or ""),
                         vgg_pth_path=cfg.vgg_pth_path)
        return model

    def ensure_style2d(self, c1_iters: Optional[int] = None,
                       c2_iters: Optional[int] = None) -> None:
        """C1 transformer pretrain → C2 temporal decoder finetune → C3 bulk
        stylize over every style (the reference's ``train_temporal_invoke``),
        skipped when ``stylized_data.npz`` exists."""
        if os.path.exists(os.path.join(self.stylized_dir, "stylized_data.npz")):
            return
        cfg = self.cfg
        model = self._stytrans_setup()
        content_paths = content_images(self.gen_dir)
        style_paths = list_images(cfg.styledir)
        if not (content_paths and style_paths):
            raise FileNotFoundError(f"no content images in {self.gen_dir} or no styles in "
                                    f"{cfg.styledir}")

        # ---- C1
        tcfg = TransformerTrainConfig(max_iter=c1_iters or 5000)
        tstate = init_transformer_train(model, tcfg)
        if self.trans_ckpt.latest_step() is not None:
            tstate.load_state_dict(self.trans_ckpt.restore(map_location=self.device))
        if tstate.step < tcfg.max_iter:
            # the content/style/stylized collage every 100 steps, in test/
            train_transformer(tstate, tcfg, content_paths, style_paths, self.trans_ckpt,
                              log_dir=self.log_dir, collage_dir=os.path.join(self.exp_dir, "test"),
                              print_interval=100, save_interval=1000,
                              dropout_seed=cfg.seed + 3, data_seed=cfg.seed,
                              workers=cfg.num_workers or 4)
        del tstate  # C2 trains the decoder alone with its own optimizer

        # ---- C2 (decoder finetune with the temporal loss; its debug PNGs
        # and style_image.png go to exp_dir)
        geo = np.load(os.path.join(self.gen_dir, "geometry.npz"))
        renders = np.stack([_load_image(p) for p in content_paths], 0)
        # a new random style every C2 step, from the 512² set
        styles_512 = np.stack([_load_image(p, (512, 512)) for p in style_paths], 0)
        c2_ckpt = CheckpointManager(os.path.join(self.exp_dir, "ckpt_trans_c2"), max_to_keep=1)
        try:
            run_temporal_finetune(model, renders, geo["coor_maps"], geo["cps"], styles_512,
                                  self.scene.hwf, TemporalTrainConfig(max_iter=c2_iters or 100),
                                  seed=cfg.seed, is_ndc=not cfg.no_ndc, out_dir=self.exp_dir,
                                  device=self.device, ckpt=c2_ckpt)
        finally:
            c2_ckpt.close()
        del renders, styles_512, geo

        # ---- C3 over every style: the [S, F] style axis Phase E reads
        stylize_all(model, self.gen_dir, [_load_image(p) for p in style_paths],
                    [os.path.basename(p) for p in style_paths], self.stylized_dir,
                    device=self.device)

    # ------------------------------------------------------------- phase D

    def ensure_vae(self, iters: Optional[int] = None):
        """The style-feature VAE (the reference's ``train_vae``): restored
        from ``ckpt_vae``, else taken from ``vae.pth`` where it exists and
        fits, else trained ``vae_iters`` steps on VGG features of the styles
        fitted to ``style_feature_dim``. Returns its
        :class:`~tgtc_torch.train.vae_trainer.VaeTrainState`."""
        from tgtc_torch.models.vae import VaeConfig
        from tgtc_torch.models.vgg import make_vgg
        from tgtc_torch.train.pretrained import _fits, load_vae_params, load_vgg_overlay
        from tgtc_torch.train.vae_trainer import VaeTrainConfig, init_vae_train, train_vae

        cfg = self.cfg
        vae_cfg = VaeConfig(data_dim=cfg.style_feature_dim, latent_dim=cfg.vae_latent,
                            width=cfg.vae_w, depth=cfg.vae_d, kl_lambda=cfg.vae_kl_lambda)
        tcfg = VaeTrainConfig(max_iter=iters if iters is not None else self.vae_iters)
        model, vstate = init_vae_train(torch.Generator().manual_seed(cfg.seed + 5), vae_cfg,
                                       tcfg, device=self.device)
        if self.vae_ckpt.latest_step() is not None:
            vstate.load_state_dict(self.vae_ckpt.restore(map_location=self.device))
            return vstate
        # a pretrained vae.pth short-circuits training (the reference's
        # load-if-exists)
        pre = load_vae_params(cfg.vae_pth_path, depth=cfg.vae_d)
        if pre is not None and _fits(model, pre, "VAE"):
            model.load_state_dict(pre)
            vstate.step = tcfg.max_iter
            self.vae_ckpt.save(vstate.step, vstate.state_dict())
            return vstate
        vgg = make_vgg(torch.Generator().manual_seed(0), device=self.device)
        load_vgg_overlay(vgg, cfg.vgg_pth_path)  # the features come from the pretrained VGG
        vgg.requires_grad_(False)
        logger = MetricsLogger(self.log_dir, name="vae")
        try:
            train_vae(vstate, vgg, list_images(cfg.styledir), tcfg, self.vae_ckpt, logger,
                      patch=self.vae_patch, data_dim=cfg.style_feature_dim,
                      data_seed=cfg.seed + 2, eps_seed=cfg.seed + 6, print_interval=500,
                      workers=cfg.num_workers or 4)
        finally:
            logger.close()
        return vstate

    # ------------------------------------------------------------- phase E

    def train_style3d(self) -> None:
        """Phase E up to ``total_step`` on the frozen trunks, with the latent
        table seeded from Phase D's VAE."""
        state, _ = self._nerf_setup()
        vstate = self.ensure_vae()
        run_style3d(self.cfg, self.scene, self.gen_dir, self.stylized_dir, state.coarse,
                    state.fine, vstate.model, self.exp_dir, device=self.device,
                    group=self.group)

    # ------------------------------------------------------------- phase F

    def render_stylized(self, poses: str = "valid") -> str:
        """``--render_valid_style`` / ``--render_train_style``: every style
        at the spiral (``valid``) or training poses, from the newest
        ``ckpt_style``, into ``exp_dir/render_<poses>_style``."""
        from tgtc_torch.train.style3d import load_style_field, style_field_config

        cfg = self.cfg
        state, _ = self._nerf_setup()
        concat, style, latent_state = load_style_field(
            os.path.join(self.exp_dir, "ckpt_style"), style_field_config(cfg, state.coarse),
            device=self.device)
        style_num = latent_state["latents"].shape[0]
        h, w, _ = self.scene.hwf
        pose_arr = self.scene.render_poses if poses == "valid" else self.scene.poses
        ro, rd = rays_for_poses(h, w, self.scene.intrinsics, pose_arr, use_ndc=not cfg.no_ndc,
                                pixel_alignment=cfg.pixel_alignment, device=self.device)
        out_dir = os.path.join(self.exp_dir, f"render_{poses}_style")
        if self._fused_style_ok():
            if self._render_stylized_fused(state, concat, style, latent_state, style_num, ro, rd,
                                           out_dir):
                return out_dir  # the turntable was streamed during the render
        else:
            from tgtc_torch.train.render_style import (
                make_stylized_render_fn,
                render_stylized_views,
            )

            render_fn = make_stylized_render_fn(
                state.coarse, state.fine, concat, style, cfg.N_samples, cfg.N_samples_fine,
                self.near, self.far, sigma_scale=cfg.sigma_scale,
                llff_tile=cfg.dataset_type == "llff")
            render_stylized_views(render_fn, latent_state, ro, rd, range(style_num), out_dir,
                                  seed=cfg.seed + 10, depth_png=cfg.depth_png)
        self._write_turntable(out_dir)
        return out_dir

    def _write_turntable(self, out_dir: str, pattern: Optional[str] = None) -> None:
        """The rendered frames as a turntable GIF (the working version of the
        reference's commented-out ``imageio.mimwrite``). A convenience
        artifact: a failure is printed, not raised."""
        from tgtc_torch.utils.video import write_video

        kw = {} if pattern is None else {"pattern": pattern}
        try:
            path = write_video(out_dir, **kw)
            print(f"[video] wrote {path}", flush=True)
        except Exception as e:  # video is a convenience artifact
            print(f"[video] skipped: {e}", flush=True)

    def _render_stylized_fused(self, state: NerfTrainState, concat, style, latent_state,
                               style_num: int, ro: torch.Tensor, rd: torch.Tensor,
                               out_dir: str) -> bool:
        """Phase F on K5 (σ-only coarse pass; K2 on the distilled proposal,
        or the grid, in its place) and K4 in ``_render_block``-ray blocks,
        with the proposal levers, the turntable GIF streamed as the frames
        come. True when the
        GIF was written that way; False when the caller must write it after
        the fact (a resumed run renders only the missing frames, which
        breaks the stream's playback order)."""
        from tgtc_torch.render.fast_style import FusedStyleRenderer
        from tgtc_torch.render.volume import RenderSettings
        from tgtc_torch.train.render_style import render_stylized_frames_fused
        from tgtc_torch.utils.video import StreamingGifWriter

        cfg = self.cfg
        self._check_proposals()
        os.makedirs(out_dir, exist_ok=True)
        settings = RenderSettings(n_samples=cfg.N_samples, n_samples_fine=cfg.N_samples_fine,
                                  near=self.near, far=self.far, sigma_noise_std=0.0,
                                  white_bkgd=cfg.white_bkgd)
        rend = FusedStyleRenderer.from_params(
            state.coarse.state_dict(), state.fine.state_dict(), concat.state_dict(),
            style.state_dict(), latent_state, settings, depth=cfg.netdepth,
            num_freq_coor=cfg.embed_freq_coor, style_d=cfg.style_D, style_width=cfg.netwidth,
            latent_dim=cfg.vae_latent, sigma_scale=cfg.sigma_scale,
            llff_tile=cfg.dataset_type == "llff", trunk_width=cfg.netwidth,
            depth_fine=cfg.netdepth_fine, trunk_width_fine=cfg.netwidth_fine,
            # frames read only the fine rgb and depth: the coarse pass runs σ only
            coarse_rgb=False, fine_budget=cfg.fine_budget or None,
            coarse_share=cfg.coarse_share, sigma_grid=self._build_sigma_grid(state),
            proposal=self._build_proposal(state), device=self.device)
        n_frames = style_num * ro.shape[0]
        writer = StreamingGifWriter(os.path.join(out_dir, "video.gif"))
        try:
            rendered = render_stylized_frames_fused(
                rend, ro, rd, range(style_num), out_dir, seed=cfg.seed + 10,
                block=self._render_block, frame_sink=writer.add, depth_png=cfg.depth_png)
        except BaseException:
            writer.abort()
            raise
        if rendered != n_frames:  # a resumed run: the stream lacks the frames on disk
            writer.abort()
            return False
        try:
            path = writer.close()
            print(f"[video] wrote {path} (streamed)", flush=True)
            return True
        except Exception as e:  # video is a convenience artifact
            print(f"[video] stream failed ({e}); falling back", flush=True)
            return False

    def render_plain(self, poses: str = "valid") -> str:
        """``--render_valid`` / ``--render_train``: plain NeRF renders (rgb
        and normalized depth) at the spiral or training poses, into
        ``exp_dir/render_<poses>``; frames on disk are kept."""
        from tgtc_torch.utils import native

        cfg = self.cfg
        state, train_cfg = self._nerf_setup()
        renderer = self._nerf_renderer(state, train_cfg, levers=True)
        h, w, _ = self.scene.hwf
        pose_arr = self.scene.render_poses if poses == "valid" else self.scene.poses
        ro, rd = rays_for_poses(h, w, self.scene.intrinsics, pose_arr, use_ndc=not cfg.no_ndc,
                                pixel_alignment=cfg.pixel_alignment, device=self.device)
        out_dir = os.path.join(self.exp_dir, f"render_{poses}")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(pose_arr.shape[0]):
            path = os.path.join(out_dir, f"rgb_{i:05d}.png")
            if os.path.exists(path):
                continue
            out = renderer.render_image(ro[i].reshape(-1, 3), rd[i].reshape(-1, 3))
            rgb = out["rgb"].reshape(h, w, 3).clamp(0, 1).cpu().numpy()
            t = out["t_exp"].reshape(h, w).cpu().numpy()
            t = (t - t.min()) / (t.max() - t.min() + 1e-7)
            native.write_png_async(path, rgb)
            native.write_png_async(os.path.join(out_dir, f"depth_{i:05d}.png"), t[..., None])
        errs = native.wait_writes()
        if errs:
            raise IOError(f"{errs} async png writes failed in {out_dir}")
        self._write_turntable(out_dir, pattern=r"rgb_\d{5}\.png")
        return out_dir

    def evaluate(self, view: Optional[int] = None) -> float:
        """PSNR of the trained NeRF against a ground-truth view (the LLFF
        holdout ``i_test`` by default), logged as an ``EVAL`` line."""
        from tgtc_torch.ops.losses import mse2psnr

        cfg = self.cfg
        state, train_cfg = self._nerf_setup()
        v = self.scene.i_test if view is None else view
        h, w, _ = self.scene.hwf
        ro, rd = rays_for_poses(h, w, self.scene.intrinsics, self.scene.poses[v: v + 1],
                                use_ndc=not cfg.no_ndc, pixel_alignment=cfg.pixel_alignment,
                                device=self.device)
        out = self._nerf_renderer(state, train_cfg).render_image(ro.reshape(-1, 3),
                                                                 rd.reshape(-1, 3))
        gt = torch.from_numpy(self.scene.images[v]).reshape(-1, 3).to(self.device)
        psnr = float(mse2psnr(torch.mean((out["rgb"] - gt) ** 2)))
        self.log.log(state.step, {"holdout_view": v, "psnr": psnr}, prefix="EVAL")
        return psnr

    # ----------------------------------------------------------------- run

    def run(self) -> None:
        cfg = self.cfg
        if multi_process_launch():
            self._run_multihost()
            return
        if cfg.render_valid_style:
            self.render_stylized("valid")
            return
        if cfg.render_train_style:
            self.render_stylized("train")
            return
        if cfg.render_valid:
            self.render_plain("valid")
            return
        if cfg.render_train:
            self.render_plain("train")
            return
        self.train_nerf()
        # the holdout PSNR right after Phase A on every run
        self._run_after_nerf()

    def _run_multihost(self) -> None:
        """The multi-process schedule (tgtc/train/pipeline.py:1241-1280):
        the two training loops, Phase A and Phase E, run over every process
        (one per GPU); B-D and the renders are IO loops that run in one
        process. The phase machine resumes from the shared checkpoints, so
        the production recipe is A over N processes → B-D in one → E over N
        → F in one, every launch on the same ``basedir`` (rank 0 writes,
        every rank reads). Phase E runs here once ``geometry.npz``,
        ``stylized_data.npz`` and a VAE checkpoint exist; otherwise rank 0
        prints what to run next."""
        cfg = self.cfg
        if cfg.render_valid_style or cfg.render_train_style or cfg.render_valid \
                or cfg.render_train:
            raise RuntimeError(
                "the render phases are single-process IO loops: run them without a "
                "multi-process launch (the phase machine resumes from the shared checkpoints)")
        maybe_initialize_distributed(device=self.device)
        self.group = DataGroup.world_group()
        self.train_nerf()
        have_2d = (os.path.exists(os.path.join(self.gen_dir, "geometry.npz"))
                   and os.path.exists(os.path.join(self.stylized_dir, "stylized_data.npz"))
                   and self.vae_ckpt.latest_step() is not None)
        if have_2d:
            self.train_style3d()
        elif is_main_process():
            print("[multihost] Phase A done. Run phases B-D single-process (same basedir), "
                  "then re-launch over several processes for Phase E.", flush=True)

    def _run_after_nerf(self) -> None:
        try:
            self.evaluate()
        except Exception as e:  # never let eval kill a training run
            print(f"[eval] holdout PSNR failed: {e}", flush=True)
        self.ensure_geometry()
        self.ensure_style2d()
        self.train_style3d()

    def close(self) -> None:
        for m in (self.nerf_ckpt, self.style_ckpt, self.trans_ckpt, self.vae_ckpt):
            m.close()
        self.log.close()
