"""Standalone 2D-stage trainer CLI — port of tgtc/tools/train2d.py.

The parser is the JAX package's, flag for flag, with its per-task
defaults, so a reference user's tuning commands port verbatim::

    python -m tgtc_torch.tools.train2d --task vae --style_dir ./all_styles
    python -m tgtc_torch.tools.train2d --task finetune_decoder \\
        --content_dir ./all_contents --style_dir ./all_styles
    python -m tgtc_torch.tools.train2d --task temporal_decoder \\
        --nerf_content_dir ./nerf_gen_data2 --style_dir ./all_styles
    python -m tgtc_torch.tools.train2d --task transformer \\
        --nerf_content_dir ./nerf_gen_data2 --style_dir ./all_styles

The four tasks: ``transformer`` (Phase C1), ``vae`` (Phase D) and AdaIN's
two decoder trainers, ``finetune_decoder`` and ``temporal_decoder``
(:mod:`tgtc_torch.train.adain_trainer`; the JAX tool's ``:202-325``).
``main(argv, device=None)`` runs on the card unless the caller passes
``device="cpu"`` (a Python argument, not a flag). On the card the
transformer is the pipeline's accelerator configuration (bf16, flash
attention on K6/K7/K8); on the CPU it is f32 with the eager attention, as
the JAX package picks per backend. The VAE task's VGG and VAE and the AdaIN
network are f32 on both. Under a multi-process launch (torchrun's or the
``TGTC_*`` environment) the transformer task trains over every process,
each on its rows of the global batch.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional

from tgtc_torch.data.prefetch import content_images, list_images
from tgtc_torch.device import DeviceLike, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tgtc_torch.tools.train2d")
    p.add_argument("--task", type=str, default="vae",
                   choices=["vae", "finetune_decoder", "temporal_decoder", "transformer"])
    p.add_argument("--content_dir", type=str, default="./all_contents/")
    p.add_argument("--nerf_content_dir", type=str, default="./nerf_gen_data2/")
    p.add_argument("--style_dir", type=str, default="./all_styles/")
    p.add_argument("--vgg", type=str, default="./pretrained/vgg_normalised.pth")
    p.add_argument("--decoder", type=str, default="./pretrained/decoder.pth")
    p.add_argument("--no_ndc", action="store_true")
    p.add_argument("--no_reload", action="store_true")
    p.add_argument("--save_dir", default="./pretrained/")
    p.add_argument("--ckp_num", type=int, default=3)
    p.add_argument("--log_dir", default="./logs/stylenet/")
    # shared flags whose reference defaults differ per task parse as None
    # and are resolved per task (_resolve_task_defaults), so an explicit
    # value equal to another task's default is honored
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_decay", type=float, default=None)
    p.add_argument("--max_iter", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--style_weight", type=float, default=None)
    p.add_argument("--content_weight", type=float, default=None)
    p.add_argument("--temporal_weight", type=float, default=50.0)
    p.add_argument("--n_threads", type=int, default=16)
    p.add_argument("--save_model_interval", type=int, default=None)
    p.add_argument("--print_interval", type=int, default=20)
    p.add_argument("--patch", type=int, default=256)  # the random crops' size
    p.add_argument("--seed", type=int, default=0)
    # parsed and ignored, as in the reference (position_embedding); the
    # transformer width (hidden_dim)
    p.add_argument("--position_embedding", type=str, default="sine")
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--vae_d", type=int, default=4)
    p.add_argument("--vae_w", type=int, default=512)
    p.add_argument("--vae_latent", type=int, default=32)
    p.add_argument("--vae_kl_lambda", type=float, default=0.1)
    return p


_TASK_DEFAULTS = {
    "vae": dict(lr=1e-4, lr_decay=5e-5, max_iter=160000, style_weight=2.0,
                content_weight=1.0, save_model_interval=200),
    "finetune_decoder": dict(lr=1e-4, lr_decay=5e-5, max_iter=160000,
                             style_weight=2.0, content_weight=1.0,
                             save_model_interval=200),
    "temporal_decoder": dict(lr=1e-4, lr_decay=5e-5, max_iter=160000,
                             style_weight=2.0, content_weight=1.0,
                             save_model_interval=200),
    "transformer": dict(lr=5e-4, lr_decay=1e-5, max_iter=5000,
                        style_weight=10.0, content_weight=7.0,
                        save_model_interval=1000),
}


def _resolve_task_defaults(args) -> None:
    """Fill the None-sentinel shared flags with the task's reference
    defaults; explicitly passed values win."""
    for k, v in _TASK_DEFAULTS[args.task].items():
        if getattr(args, k) is None:
            setattr(args, k, v)


def run_transformer(args, device: DeviceLike = None) -> int:
    """Phase C1: StyTrans pretraining on content/style crops with the
    four-term loss, through :func:`tgtc_torch.train.transformer2d.train_transformer`.
    Resumes from the newest checkpoint under ``save_dir/transformer`` unless
    ``--no_reload``; logs every ``print_interval`` steps to
    ``log_dir/transformer.jsonl``, writes the collage ``log_dir/<step>.png``
    every 100 steps and at the end, and checkpoints every
    ``save_model_interval`` steps and at the end. Under a multi-process
    launch every process trains on its rows of each global batch, and rank
    0 writes."""
    import torch

    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.parallel import DataGroup, maybe_initialize_distributed, multi_process_launch
    from tgtc_torch.train.checkpoint import CheckpointManager
    from tgtc_torch.train.pretrained import overlay_stytrans
    from tgtc_torch.train.transformer2d import (
        TransformerTrainConfig,
        init_transformer_train,
        train_transformer,
    )

    dev = resolve_device(device)
    group = DataGroup()
    if multi_process_launch():  # binds this process's card before anything lands there
        maybe_initialize_distributed(device=dev)
        group = DataGroup.world_group()
    tcfg = TransformerTrainConfig(
        lr=args.lr, lr_decay=args.lr_decay, max_iter=args.max_iter, batch_size=args.batch_size,
        style_weight=args.style_weight, content_weight=args.content_weight, patch=args.patch)
    card = dev.type == "cuda"
    mcfg = TransformerConfig(d_model=args.hidden_dim,
                             dtype=torch.bfloat16 if card else torch.float32,
                             attn_impl="flash" if card else "xla")
    model = make_stytrans(mcfg, torch.Generator().manual_seed(args.seed), device=dev)
    overlay_stytrans(model, decoder_pth_path=args.decoder,
                     pretrained_dir=os.path.dirname(args.vgg or ""), vgg_pth_path=args.vgg)
    state = init_transformer_train(model, tcfg)
    ckpt = CheckpointManager(os.path.join(args.save_dir, "transformer"), max_to_keep=args.ckp_num)
    if not args.no_reload and ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=dev))
    c_paths = content_images(args.nerf_content_dir)
    s_paths = list_images(args.style_dir)
    if not (c_paths and s_paths):
        raise ValueError(f"no images in {args.nerf_content_dir!r} or {args.style_dir!r}")
    try:
        train_transformer(state, tcfg, c_paths, s_paths, ckpt, log_dir=args.log_dir,
                          collage_dir=args.log_dir, print_interval=args.print_interval,
                          save_interval=args.save_model_interval, dropout_seed=args.seed + 3,
                          data_seed=args.seed, workers=min(args.n_threads, 8), group=group)
    finally:
        ckpt.close()
    return 0


def run_vae(args, device: DeviceLike = None) -> int:
    """Phase D: the VAE on VGG relu4_1 ``[mean ‖ std]`` features (1024-d)
    of random ``patch``² crops of the style images resized to ``2·patch``²,
    through :func:`tgtc_torch.train.vae_trainer.train_vae`. Resumes from the
    newest checkpoint under ``save_dir/vae`` unless ``--no_reload``; logs
    every ``print_interval`` steps to ``log_dir/vae.jsonl``; checkpoints
    every ``save_model_interval`` steps and at the end. The VGG carries
    ``--vgg``'s ``vgg_normalised.pth`` where it exists."""
    import torch

    from tgtc_torch.models.vae import VaeConfig
    from tgtc_torch.models.vgg import make_vgg
    from tgtc_torch.train.checkpoint import CheckpointManager
    from tgtc_torch.train.pretrained import load_vgg_overlay
    from tgtc_torch.train.vae_trainer import VaeTrainConfig, init_vae_train, train_vae
    from tgtc_torch.utils.logging import MetricsLogger

    dev = resolve_device(device)
    vcfg = VaeConfig(data_dim=1024, latent_dim=args.vae_latent, width=args.vae_w,
                     depth=args.vae_d, kl_lambda=args.vae_kl_lambda)
    tcfg = VaeTrainConfig(lr=args.lr, lr_decay=args.lr_decay, max_iter=args.max_iter,
                          batch_size=args.batch_size, kl_lambda=args.vae_kl_lambda)
    _, state = init_vae_train(torch.Generator().manual_seed(args.seed), vcfg, tcfg, device=dev)
    ckpt = CheckpointManager(os.path.join(args.save_dir, "vae"), max_to_keep=args.ckp_num)
    if not args.no_reload and ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=dev))
    vgg = make_vgg(torch.Generator().manual_seed(0), device=dev)
    load_vgg_overlay(vgg, args.vgg)
    vgg.requires_grad_(False)
    paths = list_images(args.style_dir)
    if not paths:
        raise ValueError(f"no images in {args.style_dir!r}")
    logger = MetricsLogger(args.log_dir, name="vae")
    try:
        train_vae(state, vgg, paths, tcfg, ckpt, logger, patch=args.patch,
                  data_dim=vcfg.data_dim, data_seed=args.seed, eps_seed=args.seed + 1,
                  print_interval=args.print_interval, save_interval=args.save_model_interval,
                  workers=min(args.n_threads, 8))
    finally:
        logger.close()
        ckpt.close()
    return 0


def _adain_setup(args, dev):
    """The AdaIN network from ``--seed``, with ``--vgg``'s
    ``vgg_normalised.pth`` and ``--decoder``'s ``decoder.pth`` overlaid
    where they exist, its training state and configuration."""
    import torch

    from tgtc_torch.models.adain_net import make_adain_net
    from tgtc_torch.train.adain_trainer import AdainTrainConfig, init_adain_train
    from tgtc_torch.train.pretrained import load_decoder_overlay, load_vgg_overlay

    model = make_adain_net(torch.Generator().manual_seed(args.seed), device=dev)
    load_vgg_overlay(model.vgg, args.vgg)
    load_decoder_overlay(model.decode, args.decoder)
    cfg = AdainTrainConfig(lr=args.lr, lr_decay=args.lr_decay,
                           content_weight=args.content_weight, style_weight=args.style_weight,
                           temporal_weight=args.temporal_weight, max_iter=args.max_iter)
    return model, init_adain_train(model, cfg), cfg


def _adain_loop(args, state, cfg, step_fn, next_batch: Callable[[], tuple], ckpt, name: str,
                prefix: str) -> None:
    """Steps up to ``cfg.max_iter`` from ``state``, one line to
    ``log_dir/<name>.jsonl`` every ``print_interval`` steps with
    ``steps_per_s`` over the steps since the last (the window closed by the
    log's fetch), a checkpoint through ``ckpt`` every
    ``save_model_interval`` steps and at the end (the last waited for)."""
    from tgtc_torch.utils.logging import MetricsLogger, fetch_scalars

    logger = MetricsLogger(args.log_dir, name=name)
    step = last_log = state.step
    t_log = time.perf_counter()
    try:
        while step < cfg.max_iter:
            state, metrics = step_fn(state, *next_batch())
            step = state.step
            if step % args.print_interval == 0:
                scalars = fetch_scalars(metrics)  # syncs: closes the window
                scalars["steps_per_s"] = (step - last_log) / (time.perf_counter() - t_log)
                logger.log(step, scalars, prefix=prefix)
                last_log, t_log = step, time.perf_counter()
            if step % args.save_model_interval == 0 or step >= cfg.max_iter:
                ckpt.save_device_async(step, state.state_dict(), wait=step >= cfg.max_iter)
    finally:
        logger.close()


def _adain_ckpt(args, state, name: str, dev):
    """``save_dir/<name>``'s checkpoints, ``state`` restored from the newest
    unless ``--no_reload``."""
    from tgtc_torch.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(os.path.join(args.save_dir, name), max_to_keep=args.ckp_num)
    if not args.no_reload and ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=dev))
    return ckpt


def run_finetune_decoder(args, device: DeviceLike = None) -> int:
    """AdaIN's decoder finetune: decoder-only AdaIN training on random
    ``patch``² crops of ``content_dir`` and ``style_dir`` (each resized to
    512², prefetchers seeded ``seed`` and ``seed + 1``). Resumes from the
    newest checkpoint under ``save_dir/adain_decoder`` unless
    ``--no_reload``; logs to ``log_dir/finetune_decoder.jsonl``."""
    from tgtc_torch.data.prefetch import CropBatchPrefetcher, upload
    from tgtc_torch.train.adain_trainer import make_adain_finetune_step

    dev = resolve_device(device)
    model, state, cfg = _adain_setup(args, dev)
    ckpt = _adain_ckpt(args, state, "adain_decoder", dev)
    c_paths, s_paths = list_images(args.content_dir), list_images(args.style_dir)
    if not (c_paths and s_paths):
        raise ValueError(f"no images in {args.content_dir!r} or {args.style_dir!r}")
    workers = min(args.n_threads, 8)
    try:
        with CropBatchPrefetcher(c_paths, args.batch_size, args.patch, seed=args.seed,
                                 workers=workers) as cpf, \
                CropBatchPrefetcher(s_paths, args.batch_size, args.patch, seed=args.seed + 1,
                                    workers=workers) as spf:
            _adain_loop(args, state, cfg, make_adain_finetune_step(model, cfg),
                        lambda: (upload(cpf.next(), dev), upload(spf.next(), dev)), ckpt,
                        "finetune_decoder", "ADAIN FT")
    finally:
        ckpt.close()
    return 0


def run_temporal_decoder(args, device: DeviceLike = None) -> int:
    """AdaIN's temporal decoder finetune: the AdaIN losses and the
    point-splat temporal term over a NeRF geometry dump (``nerf_content_dir``
    holds Phase B's renders and ``geometry.npz``; focal from its ``hwf``,
    else ``max(h, w)``), a batch of ``batch_size`` full frames drawn each
    step from ``default_rng(seed)`` (view ids, then one style, resized to
    the frame). Resumes from ``save_dir/adain_temporal`` unless
    ``--no_reload``; logs to ``log_dir/temporal_decoder.jsonl``."""
    import numpy as np
    import torch
    from PIL import Image

    from tgtc_torch.ops.rasterize import llff_projection_matrix
    from tgtc_torch.train.adain_trainer import make_adain_temporal_step

    dev = resolve_device(device)
    geo = np.load(os.path.join(args.nerf_content_dir, "geometry.npz"))
    coor_maps, cps = geo["coor_maps"], geo["cps"]
    c_paths = content_images(args.nerf_content_dir)
    if not len(c_paths) == coor_maps.shape[0] == cps.shape[0]:
        raise ValueError(
            f"{args.nerf_content_dir}: {len(c_paths)} render images but geometry.npz has "
            f"{coor_maps.shape[0]} coor_maps / {cps.shape[0]} poses — extra/missing PNGs "
            "would misalign frames with their geometry")
    renders = np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
                        for p in c_paths], 0)
    h, w = renders.shape[1:3]
    focal = float(geo["hwf"][2]) if "hwf" in geo else float(max(h, w))
    s_paths = list_images(args.style_dir)
    if not s_paths:
        raise ValueError(f"no images in {args.style_dir!r}")
    styles = np.stack([np.asarray(Image.open(p).convert("RGB").resize((w, h), Image.BILINEAR),
                                  np.float32) / 255.0 for p in s_paths], 0)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    renders_d, coor_d, cps_d, styles_d = (put(a) for a in (renders, coor_maps, cps, styles))
    proj = put(llff_projection_matrix(h, w, focal))
    model, state, cfg = _adain_setup(args, dev)
    step_fn = make_adain_temporal_step(model, cfg, proj, h, w, is_ndc=not args.no_ndc,
                                       focal=focal)
    ckpt = _adain_ckpt(args, state, "adain_temporal", dev)
    rng = np.random.default_rng(args.seed)

    def next_batch():
        ids = torch.from_numpy(rng.integers(0, renders.shape[0], args.batch_size)).to(dev)
        s_id = int(rng.integers(0, styles.shape[0]))
        style = styles_d[s_id, None].expand(args.batch_size, -1, -1, -1).contiguous()
        return renders_d[ids], coor_d[ids], cps_d[ids], style

    try:
        _adain_loop(args, state, cfg, step_fn, next_batch, ckpt, "temporal_decoder",
                    "ADAIN TEMPORAL")
    finally:
        ckpt.close()
    return 0


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> int:
    args = build_parser().parse_args(argv)
    _resolve_task_defaults(args)
    dev = resolve_device(device)  # before anything touches the disk
    os.makedirs(args.save_dir, exist_ok=True)
    return {"vae": run_vae, "finetune_decoder": run_finetune_decoder,
            "temporal_decoder": run_temporal_decoder,
            "transformer": run_transformer}[args.task](args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
