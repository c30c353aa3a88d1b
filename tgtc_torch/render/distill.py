"""Distilled proposal MLP — port of tgtc/render/distill.py.

The coarse network only steers fine sampling, yet it runs a D8xW256 trunk
on 64 samples of every ray of every frame. After Phase A the density is
frozen, so a far smaller trunk (D2xW128 by default, ~20x fewer operations a
point) is fitted to the fine trunk's σ once per checkpoint and renders as
the coarse net: K2 runs it at width 128
(:func:`~tgtc_torch.ops.kernels.nerf_mlp.fused_nerf_sigma_apply_t`).

The regression is the JAX package's: points drawn like render points (a
random training ray, a uniform depth in [near, far]); the target is the
fine ``NerfMLP``'s σ in its compute dtype, clipped at the alpha-saturation
point ``10 * n_samples / (far - near)``; the loss is the expectile-weighted
square (``tau`` 0.5, plain MSE, by default); Adam under a cosine decay to 0
(optax's ``cosine_decay_schedule(lr, steps)``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from tgtc_torch.models.nerf import NerfConfig, NerfMLP, make_nerf, nerf_sigma
from tgtc_torch.ops.encoding import positional_encoding

# one step's draws: ray indices [batch] and depths [batch, 1]
Draws = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


def proposal_config(fine_cfg: NerfConfig, depth: int = 2, width: int = 128) -> NerfConfig:
    """The proposal's architecture: a ``NerfMLP`` (so the packing and the
    kernels apply unchanged) with a small trunk and the fine net's
    encodings, skips and compute dtype."""
    return NerfConfig(depth=depth, width=width, embed_freq_coor=fine_cfg.embed_freq_coor,
                      embed_freq_dir=fine_cfg.embed_freq_dir,
                      use_viewdir=fine_cfg.use_viewdir, act_type="relu",
                      skips=fine_cfg.skips, compute_dtype=fine_cfg.compute_dtype)


def distill_proposal(
    seed: int,
    fine: NerfMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float,
    far: float,
    *,
    depth: int = 2,
    width: int = 128,
    steps: int = 3000,
    batch: int = 65536,
    lr: float = 3e-3,
    tau: float = 0.5,
    sigma_clip: Optional[Tuple[float, float]] = None,
    n_samples: int = 64,
    init: Optional[Dict[str, torch.Tensor]] = None,
    draws: Optional[Draws] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """Fit a ``depth`` x ``width`` proposal trunk to ``fine``'s σ on the
    training rays ``rays_o/rays_d [N, 3]``, on ``fine``'s device.

    The proposal starts from ``init`` (a state dict) or from ``make_nerf``
    with a generator seeded ``seed``; step ``i``'s draws come from
    ``draws(i)`` or from a device generator seeded ``seed``. Returns the
    proposal's state dict and the last step's ``loss`` and
    ``relu_sigma_bias`` (mean relu(pred) - relu(target)), computed before
    its update, with ``depth``, ``width`` and ``steps``."""
    if not 0.5 <= tau < 1.0:
        raise ValueError(f"tau {tau}: expectile weight must be in [0.5, 1)")
    if sigma_clip is None:
        sigma_clip = (-20.0, 10.0 * n_samples / max(far - near, 1e-6))
    lo, hi = sigma_clip
    dev = next(fine.parameters()).device
    fine_cfg = fine.cfg
    prop_cfg = proposal_config(fine_cfg, depth=depth, width=width)
    prop = make_nerf(prop_cfg, torch.Generator().manual_seed(seed), device=dev)
    if init is not None:
        prop.load_state_dict(init)
    ro = rays_o.reshape(-1, 3).float()
    rd = rays_d.reshape(-1, 3).float()
    n = ro.shape[0]
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def draws(_step):
            idx = torch.randint(0, n, (batch,), generator=gen, device=dev)
            return idx, near + (far - near) * torch.rand((batch, 1), generator=gen, device=dev)

    opt = torch.optim.Adam(prop.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    # optax.cosine_decay_schedule(lr, steps), alpha 0, at update count k
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: 0.5 * (1.0 + math.cos(math.pi * min(k, steps) / steps)))
    loss = bias = torch.tensor(float("nan"))
    for step in range(steps):
        idx, t = draws(step)
        pts = ro[idx] + t * rd[idx]
        pe_c = positional_encoding(pts, fine_cfg.embed_freq_coor)
        with torch.no_grad():  # the target takes no gradient
            tgt = nerf_sigma(fine, pe_c).clamp(lo, hi)
        pe_p = (pe_c if prop_cfg.embed_freq_coor == fine_cfg.embed_freq_coor
                else positional_encoding(pts, prop_cfg.embed_freq_coor))
        pred = nerf_sigma(prop, pe_p)
        err = tgt - pred
        w = torch.where(err > 0, tau, 1.0 - tau)
        loss_t = torch.mean(w * err * err)
        opt.zero_grad(set_to_none=True)
        loss_t.backward()
        opt.step()
        sched.step()
        loss = loss_t.detach()
        bias = torch.mean(torch.relu(pred.detach()) - torch.relu(tgt))
    state = {k: v.detach() for k, v in prop.state_dict().items()}
    return state, {"loss": float(loss), "relu_sigma_bias": float(bias), "depth": depth,
                   "width": width, "steps": steps}
