"""Standalone 2D-stage trainer CLI — port of tgtc/tools/train2d.py.

The parser is the JAX package's, flag for flag, with its per-task
defaults, so a reference user's tuning commands port verbatim::

    python -m tgtc_torch.tools.train2d --task transformer \\
        --nerf_content_dir ./nerf_gen_data2 --style_dir ./all_styles

The ``transformer`` (Phase C1) and ``vae`` (Phase D) tasks are ported;
``finetune_decoder`` and ``temporal_decoder`` (AdaIN's trainers) raise
``NotImplementedError`` naming their ROADMAP item. ``main(argv,
device=None)`` runs on the card unless the caller passes ``device="cpu"``
(a Python argument, not a flag). On the card the transformer is the
pipeline's accelerator configuration (bf16, flash attention on
K6/K7/K8); on the CPU it is f32 with the eager attention, as the JAX
package picks per backend. The VAE task's VGG and VAE are f32 on both.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

from tgtc_torch.device import DeviceLike, resolve_device


def _list_images(d: str) -> List[str]:
    exts = (".jpg", ".jpeg", ".png", ".JPG", ".PNG", ".JPEG")
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(exts))


def _content_images(d: str) -> List[str]:
    """NeRF-render content images without the Phase-B depth and geometry
    dumps, filtered on the basename (a parent directory named ``depth``
    must not exclude everything)."""
    return [p for p in _list_images(d)
            if "depth" not in os.path.basename(p) and "geometry" not in os.path.basename(p)]


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

_ADAIN = "ROADMAP.md queue 1, 'AdaIN and poses': adain_net.py, adain_trainer.py"
_NOT_PORTED = {
    "finetune_decoder": f"the AdaIN decoder finetune is not ported yet ({_ADAIN})",
    "temporal_decoder": f"AdaIN's temporal decoder finetune is not ported yet ({_ADAIN}; "
                        "the pipeline's C2 is tgtc_torch.train.temporal)",
}


def _resolve_task_defaults(args) -> None:
    """Fill the None-sentinel shared flags with the task's reference
    defaults; explicitly passed values win."""
    for k, v in _TASK_DEFAULTS[args.task].items():
        if getattr(args, k) is None:
            setattr(args, k, v)


def run_transformer(args, device: DeviceLike = None) -> int:
    """Phase C1: StyTrans pretraining on content/style crops with the
    four-term loss. Resumes from the newest checkpoint under
    ``save_dir/transformer`` unless ``--no_reload``; logs every
    ``print_interval`` steps to ``log_dir/transformer.jsonl`` (each line with
    ``steps_per_s`` over the steps since the last, the window closed by the
    log's fetch), writes the content/style/stylized collage
    ``log_dir/<step>.png`` every 100 steps and at the end, and checkpoints
    every ``save_model_interval`` steps and at the end (asynchronously; the
    last save is waited for)."""
    import torch

    from tgtc_torch.data.prefetch import CropBatchPrefetcher, ResizeCache
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train.checkpoint import CheckpointManager
    from tgtc_torch.train.pretrained import overlay_stytrans
    from tgtc_torch.train.transformer2d import (
        TransformerTrainConfig,
        init_transformer_train,
        make_collage_fn,
        make_transformer_train_step,
    )
    from tgtc_torch.utils import native
    from tgtc_torch.utils.logging import MetricsLogger, fetch_scalars

    dev = resolve_device(device)
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
    c_paths = _content_images(args.nerf_content_dir)
    s_paths = _list_images(args.style_dir)
    if not (c_paths and s_paths):
        raise ValueError(f"no images in {args.nerf_content_dir!r} or {args.style_dir!r}")
    os.makedirs(args.log_dir, exist_ok=True)
    logger = MetricsLogger(args.log_dir, name="transformer")
    collage_fn = make_collage_fn(model)
    step_fn = make_transformer_train_step(model, tcfg)
    workers, cache = min(args.n_threads, 8), ResizeCache()

    with CropBatchPrefetcher(c_paths, tcfg.batch_size, tcfg.patch, seed=args.seed,
                             workers=workers, cache=cache) as cpf, \
            CropBatchPrefetcher(s_paths, tcfg.batch_size, tcfg.patch, seed=args.seed + 1,
                                workers=workers, cache=cache) as spf:
        step = last_log = state.step
        t_log = time.perf_counter()
        try:
            while step < tcfg.max_iter:
                content, style = _upload(cpf.next(), dev), _upload(spf.next(), dev)
                state, metrics = step_fn(state, content, style, seed=args.seed + 3)
                step = state.step
                if step % args.print_interval == 0:
                    scalars = fetch_scalars(metrics)  # syncs: closes the window
                    now = time.perf_counter()
                    scalars["steps_per_s"] = (step - last_log) / (now - t_log)
                    logger.log(step, scalars, prefix="TRANS TRAIN")
                    last_log, t_log = step, time.perf_counter()
                if step % 100 == 0 or step >= tcfg.max_iter:
                    native.write_png_async(os.path.join(args.log_dir, f"{step}.png"),
                                           collage_fn(content, style).cpu().numpy())
                if step % args.save_model_interval == 0 or step >= tcfg.max_iter:
                    ckpt.save_device_async(step, state.state_dict(), wait=step >= tcfg.max_iter)
        finally:
            logger.close()
            ckpt.close()
    native.wait_writes()
    return 0


def _upload(batch, dev):
    """A host batch on ``dev``, pinned on the way to the card so that the
    copy does not wait for it."""
    import torch

    t = torch.from_numpy(batch)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def run_vae(args, device: DeviceLike = None) -> int:
    """Phase D: the VAE on VGG relu4_1 ``[mean ‖ std]`` features of random
    ``patch``² crops of the style images resized to ``2·patch``². Resumes
    from the newest checkpoint under ``save_dir/vae`` unless
    ``--no_reload``; logs every ``print_interval`` steps to
    ``log_dir/vae.jsonl`` (with ``steps_per_s`` over the steps since the
    last, the window closed by the log's fetch); checkpoints every
    ``save_model_interval`` steps and at the end. The VGG carries
    ``--vgg``'s ``vgg_normalised.pth`` where it exists."""
    import torch

    from tgtc_torch.data.prefetch import CropBatchPrefetcher
    from tgtc_torch.models.vae import VaeConfig
    from tgtc_torch.models.vgg import make_vgg
    from tgtc_torch.train.checkpoint import CheckpointManager
    from tgtc_torch.train.pretrained import load_vgg_overlay
    from tgtc_torch.train.vae_trainer import (
        VaeTrainConfig,
        init_vae_train,
        make_vae_train_step,
        vgg_style_feature,
    )
    from tgtc_torch.utils.img import from_uint8
    from tgtc_torch.utils.logging import MetricsLogger, fetch_scalars

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
    paths = _list_images(args.style_dir)
    if not paths:
        raise ValueError(f"no images in {args.style_dir!r}")
    os.makedirs(args.log_dir, exist_ok=True)
    logger = MetricsLogger(args.log_dir, name="vae")
    step_fn = make_vae_train_step(state.model, tcfg)
    with CropBatchPrefetcher(paths, tcfg.batch_size, args.patch, resize=2 * args.patch,
                             seed=args.seed, workers=min(args.n_threads, 8)) as pf:
        step = last_log = state.step
        t_log = time.perf_counter()
        try:
            while step < tcfg.max_iter:
                with torch.no_grad():
                    x = vgg_style_feature(vgg, from_uint8(_upload(pf.next(), dev)))
                state, metrics = step_fn(state, x, seed=args.seed + 1)
                step = state.step
                if step % args.print_interval == 0:
                    scalars = fetch_scalars(metrics)  # syncs: closes the window
                    now = time.perf_counter()
                    scalars["steps_per_s"] = (step - last_log) / (now - t_log)
                    logger.log(step, scalars, prefix="VAE")
                    last_log, t_log = step, time.perf_counter()
                if step % args.save_model_interval == 0 or step >= tcfg.max_iter:
                    ckpt.save_device_async(step, state.state_dict(), wait=step >= tcfg.max_iter)
        finally:
            logger.close()
            ckpt.close()
    return 0


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> int:
    args = build_parser().parse_args(argv)
    _resolve_task_defaults(args)
    if args.task in _NOT_PORTED:
        raise NotImplementedError(f"--task {args.task}: {_NOT_PORTED[args.task]}")
    dev = resolve_device(device)  # before anything touches the disk
    os.makedirs(args.save_dir, exist_ok=True)
    return (run_vae if args.task == "vae" else run_transformer)(args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
