"""Import a reference (PyTorch) experiment directory into the port's
checkpoints — port of tgtc/tools/import_reference.py.

The reference trains into ``<basedir>/<expname>.../`` with three checkpoint
families found by a substring of the file name:

* NeRF ``%06d.tar``      — {global_step, model, model_fine, ...}
* ``style_%06d.tar``     — {model (the style MLP), concat_model, ...}
* ``latent_%06d.tar``    — {train_set_1: the StyleLatents state dict}

The newest of each becomes the port's ``ckpt_nerf`` and ``ckpt_style``
checkpoints, from which :class:`tgtc_torch.train.pipeline.Pipeline`
resumes::

    python -m tgtc_torch.tools.import_reference --config configs/fern.txt \\
        --ref_dir /path/to/reference/logs/fern_...

The port's modules carry the reference's torch layer names, so the weights
load as they are (a ``net.`` prefix is dropped). The 2D assets
(``vgg_normalised.pth``, ``decoder.pth``, ``vae.pth``, the transformer and
embedding pths) need no import: the pipeline loads them from the config's
paths. ``device`` is where the states are built before they are written,
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from tgtc_torch.device import DeviceLike, resolve_device


def _newest(ref_dir: str, contains: str = "", excludes: List[str] = ()) -> Optional[str]:
    """The reference's discovery: the last sorted file name holding 'tar'
    and ``contains`` and none of ``excludes``."""
    hits = [f for f in sorted(os.listdir(ref_dir))
            if "tar" in f and contains in f and not any(x in f for x in excludes)]
    return os.path.join(ref_dir, hits[-1]) if hits else None


def _load_tar(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def _reference_weights(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> Dict:
    """``model``'s state dict from a reference one whose keys may carry
    the ``net.`` prefix."""
    return {k: sd[f"net.{k}"] if f"net.{k}" in sd else sd[k] for k in model.state_dict()}


def import_reference_checkpoints(cfg, ref_dir: str, exp_dir: Optional[str] = None,
                                 device: DeviceLike = None) -> dict:
    """Convert the newest NeRF / style / latent tars of ``ref_dir`` into
    checkpoints under ``exp_dir`` (default ``cfg.exp_dir``). Returns
    ``{"nerf_step": int | None, "style_step": int | None}``."""
    from tgtc_torch.models.nerf import NerfConfig
    from tgtc_torch.models.style_field import StyleFieldConfig
    from tgtc_torch.train.checkpoint import CheckpointManager
    from tgtc_torch.train.nerf_trainer import NerfTrainConfig, init_state
    from tgtc_torch.train.style3d import StyleTrainConfig, init_style_state

    dev = resolve_device(device)
    exp_dir = exp_dir or cfg.exp_dir
    os.makedirs(exp_dir, exist_ok=True)
    out = {"nerf_step": None, "style_step": None}
    arch = dict(embed_freq_coor=cfg.embed_freq_coor, embed_freq_dir=cfg.embed_freq_dir,
                use_viewdir=cfg.use_viewdir, act_type=cfg.act_type,
                siren_sigma_mul=cfg.siren_sigma_mul)
    nerf_cfg = NerfConfig(depth=cfg.netdepth, width=cfg.netwidth, **arch)
    fine_cfg = NerfConfig(depth=cfg.netdepth_fine, width=cfg.netwidth_fine, **arch)
    train_cfg = NerfTrainConfig(batch_size=cfg.batch_size, lrate=cfg.lrate,
                                lrate_decay=cfg.lrate_decay, n_samples=cfg.N_samples,
                                n_samples_fine=cfg.N_samples_fine)

    nerf_tar = _newest(ref_dir, excludes=["style", "latent"])
    if nerf_tar:
        ckpt = _load_tar(nerf_tar)
        step = int(ckpt.get("global_step", 0))
        state = init_state(torch.Generator().manual_seed(0), nerf_cfg, train_cfg, fine_cfg,
                           device=dev)
        state.coarse.load_state_dict(_reference_weights(state.coarse, ckpt["model"]))
        if "model_fine" in ckpt:
            state.fine.load_state_dict(_reference_weights(state.fine, ckpt["model_fine"]))
        state.step = step
        m = CheckpointManager(os.path.join(exp_dir, "ckpt_nerf"), max_to_keep=cfg.ckp_num)
        m.save(step, state.state_dict())
        m.close()
        out["nerf_step"] = step
        print(f"[import] NeRF {nerf_tar} → ckpt_nerf @ step {step}")

    style_tar = _newest(ref_dir, contains="style")
    latent_tar = _newest(ref_dir, contains="latent")
    if style_tar and latent_tar:
        mlps = _load_tar(style_tar)
        sd = _load_tar(latent_tar)
        sd = sd.get("train_set_1", sd)
        lat = {"latents": sd["latents"], "mu": sd["style_latents_mu"],
               "logvar": sd["style_latents_logvar"]}
        lat = {k: v.detach().float().to(dev) for k, v in lat.items()}
        s, f, _ = lat["latents"].shape
        field = StyleFieldConfig(style_d=cfg.style_D, width=cfg.netwidth,
                                 latent_dim=cfg.vae_latent, embed_dim=nerf_cfg.input_ch)
        step = int(os.path.basename(style_tar).split("_")[-1].split(".")[0])
        scfg = StyleTrainConfig(batch_size=cfg.batch_size_style, n_samples=cfg.N_samples,
                                n_samples_fine=cfg.N_samples_fine, origin_step=cfg.origin_step,
                                dataset_type=cfg.dataset_type)
        sstate = init_style_state(torch.Generator().manual_seed(0), field, scfg, s, f,
                                  latents_init=lat, device=dev)
        sstate.concat.load_state_dict(_reference_weights(sstate.concat, mlps["concat_model"]))
        sstate.style.load_state_dict(_reference_weights(sstate.style, mlps["model"]))
        sstate.step = step
        m = CheckpointManager(os.path.join(exp_dir, "ckpt_style"), max_to_keep=cfg.ckp_num)
        m.save(step, sstate.state_dict())
        m.close()
        out["style_step"] = step
        print(f"[import] style {style_tar} + {latent_tar} → ckpt_style @ step {step}")

    if out["nerf_step"] is None and out["style_step"] is None:
        raise FileNotFoundError(f"no reference .tar checkpoints in {ref_dir}")
    return out


def main(argv=None, device: DeviceLike = None) -> int:
    import argparse

    from tgtc_torch.config import load_config

    ap = argparse.ArgumentParser(prog="tgtc_torch.tools.import_reference")
    ap.add_argument("--ref_dir", required=True,
                    help="reference experiment directory holding the *.tar checkpoints")
    ap.add_argument("--exp_dir", default=None,
                    help="the port's experiment directory (default: the config's exp_dir)")
    args, rest = ap.parse_known_args(argv)
    import_reference_checkpoints(load_config(rest), args.ref_dir, args.exp_dir, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
