"""What the drivers share: the program's objects built from a configuration
file and the benchmark's seeded state dicts, and the checks of a train cell.

The weights are the benchmark's (:func:`draw_trunks`, :func:`draw_style`);
the program gets copies of them, and the plain reference the originals.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.harness import traffic as T
from benchmark.reference import compare

FEED_KEY, WEIGHTS_KEY, SAMPLE_KEY, JITTER_KEY, COH_KEY = 1, 0, 2, 3, 4


def draw_trunks(config: Dict, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The coarse and the fine trunk's state dicts, He-normal weights and
    normal biases of std ``bias_std``, the σ head's bias raised by
    ``sigma_bias`` so that every ray ends opaque."""
    sh = T.linear_shapes(config)
    out = {}
    for net in ("coarse", "fine"):
        out[net] = T.draw_linears(gen, sh, float(config["bias_std"]), device)
        out[net]["sigma_layer.bias"] = out[net]["sigma_layer.bias"] + float(config["sigma_bias"])
    return out


def draw_style(config: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Both style MLPs' state dicts (``concat.*``, ``style.*``)."""
    return T.draw_linears(gen, T.style_shapes(config), float(config["bias_std"]), device)


def draw_table(config: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The variational latent table: standard-normal latents ``[S, F, D]``,
    ``mu`` and ``logvar [S, D]``."""
    s, f, d = int(config["style_num"]), int(config["train_views"]["n_views"]), int(
        config["vae_latent"])
    flat = torch.randn(s * f * d + 2 * s * d, generator=gen, device=device)
    return {"latents": flat[: s * f * d].view(s, f, d),
            "mu": flat[s * f * d: s * f * d + s * d].view(s, d),
            "logvar": flat[s * f * d + s * d:].view(s, d)}


def sub(state: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def nerf_config(config: Dict):
    from tgtc_torch.models.nerf import NerfConfig

    return NerfConfig(depth=int(config["netdepth"]), width=int(config["netwidth"]),
                      embed_freq_coor=int(config["multires"]),
                      embed_freq_dir=int(config["multires_views"]), use_viewdir=True,
                      skips=tuple(int(s) for s in config["skips"]))


def nerf_module(config: Dict, state: Dict[str, torch.Tensor], device):
    """The program's trunk module holding a copy of ``state``."""
    from tgtc_torch.models.nerf import NerfMLP

    m = NerfMLP(nerf_config(config)).to(device)
    m.load_state_dict(state)
    return m


def exp_avg_grads(optimizer, names: List[str], params: List[torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The first step's gradient as Adam got it, from its state after that
    step: ``exp_avg / (1 - beta1)``; zero where the optimizer kept no state
    (it took no step)."""
    return {n: optimizer.state[p]["exp_avg"].detach() / 0.1 if "exp_avg" in optimizer.state[p]
            else torch.zeros_like(p.detach()) for n, p in zip(names, params)}


def train_checks(first: Dict, ref: Dict, params0: Dict[str, torch.Tensor],
                 losses: List[float]) -> Dict[str, float]:
    """The numbers of a train cell: the first steps against the reference,
    and the count of non-finite losses over the window."""
    out = compare.train_readings(first, ref, params0)
    out["nonfinite_losses"] = float(sum(not math.isfinite(x) for x in losses))
    return out


def sample(n_frames: int, n_rays: int, traffic: Dict, seed: int):
    """The check's sample, drawn from the seed: ``sample_frames`` distinct
    frames of the window (all where it has fewer) and ``sample_rays``
    distinct rays of each."""
    g = T.generator("cpu", seed, SAMPLE_KEY)
    k = min(int(traffic["sample_frames"]), n_frames)
    idx = sorted(torch.randperm(n_frames, generator=g)[:k].tolist())
    pix = [torch.randperm(n_rays, generator=g)[: int(traffic["sample_rays"])] for _ in idx]
    return idx, pix


class exact_f32:
    """Float32 products with TF32 off, for the reference; restores the
    flags on exit."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
