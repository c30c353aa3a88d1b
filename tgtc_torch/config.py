"""The run configuration — port of tgtc/config.py.

A typed dataclass of every pipeline knob whose field names match the
reference CLI flags one to one, so the reference-format ``configs/*.txt``
files (``key = value`` lines, bare flags, ``#`` comments) load unchanged,
and CLI overrides take precedence over the file, which takes precedence
over the defaults. The JAX package's module is jax-free; the port keeps
its own copy so that it imports nothing of ``tgtc``. Field comments that
explain the TPU-native levers live with the JAX module; here each names
what the port does with it.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional


@dataclass
class Config:
    """All knobs for the full pipeline (the reference CLI's flags)."""

    # experiment / paths
    config: str = ""
    expname: str = "exp"
    basedir: str = "./logs/"
    datadir: str = "./data/"
    styledir: str = "./style/"
    dataset_type: str = "llff"
    no_ndc: bool = False
    white_bkgd: bool = False
    half_res: bool = False
    spherify: bool = False

    # pretrained assets
    decoder_pth_path: str = "./pretrained/decoder.pth"
    vgg_pth_path: str = "./pretrained/vgg_normalised.pth"
    vae_pth_path: str = "./pretrained/vae.pth"

    # data factors
    factor: float = 1.0
    gen_factor: float = 0.2
    valid_factor: float = 0.05
    num_workers: int = 0
    store_rays: int = 1

    # training options
    use_viewdir: bool = False
    sample_type: str = "uniform"
    act_type: str = "relu"
    nerf_type: str = "nerf"
    style_type: str = "mlp"
    latent_type: str = "variational"
    nerf_type_fine: str = "nerf"
    sigma_noise_std: float = 1.0
    siren_sigma_mul: float = 20.0

    # loss weights
    rgb_loss_lambda: float = 1.0
    rgb_loss_lambda_2d: float = 10.0
    style_loss_lambda: float = 1.0
    content_loss_lambda: float = 1.0
    loss_coh_lambda: float = 5e3
    logp_loss_lambda: float = 0.1
    logp_loss_decay: float = 1.0
    # the last Phase-E step with the coherence loss: -1 derives it as
    # origin_step + 1999 (the reference's hardcoded 122000 for its
    # origin_step 120001); set it to pin an absolute step
    coh_until_step: int = -1
    lambda_u: float = 0.01

    # network
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    style_D: int = 8
    style_feature_dim: int = 1024

    # VAE
    vae_d: int = 4
    vae_w: int = 512
    vae_latent: int = 32
    vae_kl_lambda: float = 0.1

    # embedding / batching / lr
    embed_freq_coor: int = 10
    embed_freq_dir: int = 4
    batch_size: int = 2048
    batch_size_style: int = 1024
    lrate: float = 5e-4
    lrate_decay: int = 100000
    chunk: int = 1024 * 32
    no_reload: bool = False
    total_step: int = 50000001
    origin_step: int = 250000
    decoder_step: int = 170000
    steps_per_opt: int = 1
    steps_patch: int = -1

    N_samples: int = 64
    N_samples_fine: int = 64

    # logging/saving
    i_print: int = 100
    i_weights: int = 5000
    i_video: int = 50000 * 100  # read by nothing, in the reference too
    ckp_num: int = 3

    # render switches
    render_valid: bool = False
    render_train: bool = False
    render_valid_style: bool = False
    render_train_style: bool = False
    sigma_scale: float = 1.0

    pixel_alignment: bool = False
    TT_far: float = 8.0

    # --- additions of the JAX package (no reference analog) ---
    use_pallas: bool = True        # fused trunk kernels for bulk renders
    coh_lambda_auto: bool = False  # rescale loss_coh_lambda when the Phase-E
    #                                start diagnostic finds the coherence
    #                                gradient above COH_RATIO_WARN x rgb's
    fine_budget: int = 0           # fused renders: fine samples a ray (0 = all)
    train_fine_budget: str = ""    # Phase A's budget schedule, "96@60000,80@90000";
    #                                Phase E takes its last segment's budget
    coarse_share: int = 1          # fused renders: rays sharing one proposal ray
    proposal_width: int = 0        # fused renders: distilled proposal trunk width
    proposal_depth: int = 2        #   (0 = off), its depth
    proposal_steps: int = 3000     #   and its regression steps
    sigma_grid: int = 0            # fused renders: density-grid proposal, N^3 voxels
    depth_png: str = "full"        # "full", "half" or "off" (Phase F)
    mesh_devices: int = 0          # 0 = all local devices
    seed: int = 0
    debug_nans: bool = False
    profile_dir: str = ""

    @property
    def exp_dir(self) -> str:
        """The reference's run directory name under ``basedir``."""
        name = (
            f"{self.expname}_{self.nerf_type}_{self.act_type}"
            f"_Viewdir{self.use_viewdir}_factor{self.factor}"
        )
        return os.path.join(self.basedir, name)


_BOOL_FIELDS = {f.name for f in fields(Config) if f.type in ("bool", bool)}


def _coerce(name: str, raw: str) -> Any:
    ftypes = {f.name: f.type for f in fields(Config)}
    t = ftypes.get(name)
    raw = raw.strip()
    if t in ("bool", bool):
        return raw.lower() in ("1", "true", "yes", "on", "")
    if t in ("int", int):
        return int(float(raw))
    if t in ("float", float):
        return float(raw)
    return raw


def parse_config_file(path: str) -> Dict[str, Any]:
    """Parse a reference-format ``key = value`` config file; a bare word is
    a flag set to True."""
    out: Dict[str, Any] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                out[k.strip()] = _coerce(k.strip(), v)
            else:
                out[line] = True
    return out


def load_config(argv: Optional[List[str]] = None) -> Config:
    """``--config file.txt`` plus ``--key value`` overrides (CLI > file >
    defaults, as configargparse orders them); unknown file keys are
    dropped."""
    parser = argparse.ArgumentParser(prog="tgtc_torch")
    parser.add_argument("--config", type=str, default="")
    for f in fields(Config):
        if f.name == "config":
            continue
        if f.name in _BOOL_FIELDS:
            parser.add_argument(f"--{f.name}", action="store_true", default=None)
        else:
            parser.add_argument(f"--{f.name}", type=str, default=None)
    ns = parser.parse_args(argv)

    values: Dict[str, Any] = {}
    if ns.config:
        values.update(parse_config_file(ns.config))
        values["config"] = ns.config
    for f in fields(Config):
        v = getattr(ns, f.name, None)
        if v is not None and f.name != "config":
            values[f.name] = v if f.name in _BOOL_FIELDS else _coerce(f.name, v)
    known = {f.name for f in fields(Config)}
    values = {k: v for k, v in values.items() if k in known}
    return Config(**values)
