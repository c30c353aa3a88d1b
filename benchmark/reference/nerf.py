"""The plain reference of the NeRF cells: NeRF's coarse + fine MLP (Mildenhall
et al. 2020: D8, W256, positional encoding 10 / 4, skip at layer 4, viewdir
rgb head) as TGTC trains and renders it, in plain ``torch`` and float32 with
TF32 off. It imports nothing of the program; it reads weights from state
dicts under the reference implementation's layer names.

``precision="fp8"`` is the control: every matrix product takes operands
rounded to float8 e4m3 with one scale a tensor (the step below the
program's bf16), accumulated in f32.

Departures from the published NeRF, all TGTC's: view directions are the
unnormalised NDC ray directions; the σ head has no activation before the
compositing ReLU; ``base_remap`` is 256 wide; the last interval is 1e10 and
transmittance carries TGTC's ``+1e-10``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, back in f32;
    the gradient passes through unrounded (the products of the backward take
    the rounded operands that the forward saved)."""
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, precision: str
           ) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if precision == "fp8":
        x, w = fp8(x), fp8(w)
    elif precision != "f32":
        raise ValueError(precision)
    return torch.nn.functional.linear(x, w, b)


def encode(x: torch.Tensor, n_freq: int) -> torch.Tensor:
    """``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]``, each over the 3 axes."""
    f = 2.0 ** torch.arange(n_freq, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * f[:, None]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], -2).reshape(*x.shape[:-1], 6 * n_freq)
    return torch.cat([x, enc], -1)


def trunk(p: Dict[str, torch.Tensor], cfg: Dict, e_c: torch.Tensor, precision: str
          ) -> torch.Tensor:
    """The last hidden layer of the trunk on encoded points."""
    skips = [int(s) for s in cfg["skips"]]
    h = torch.relu(linear(e_c, p, "base_layers.0", precision))
    for i in range(int(cfg["netdepth"]) - 1):
        if i in skips:
            h = torch.cat([e_c, h], -1)
        h = torch.relu(linear(h, p, f"base_layers.{i + 1}", precision))
    return h


def nerf(p: Dict[str, torch.Tensor], cfg: Dict, pts: torch.Tensor, dirs: Optional[torch.Tensor],
         precision: str = "f32", remap: bool = False) -> Dict[str, torch.Tensor]:
    """σ ``[...]`` at ``pts [..., 3]``; with ``dirs`` also rgb ``[..., 3]``;
    with ``remap`` also ``base_remap [..., 256]`` and ``pts_embed``."""
    e_c = encode(pts, int(cfg["multires"]))
    h = trunk(p, cfg, e_c, precision)
    out = {"sigma": linear(h, p, "sigma_layer", precision)[..., 0]}
    if dirs is None and not remap:
        return out
    base = torch.relu(linear(h, p, "base_remap_layer", precision))
    if remap:
        out["base_remap"], out["pts_embed"] = base, e_c
    if dirs is not None:
        e_d = encode(dirs, int(cfg["multires_views"]))
        f = torch.relu(linear(torch.cat([base, e_d], -1), p, "rgb_layers.0", precision))
        out["rgb"] = torch.sigmoid(linear(f, p, "rgb_layers.1", precision))
    return out


# ---------------------------------------------------------------- sampling


def depths(n_rays: int, n: int, near: float, far: float, u: Optional[torch.Tensor],
           device) -> torch.Tensor:
    """``n`` depths a ray from ``near`` to ``far``, each jittered in its
    stratum by ``u [R, n]`` when given."""
    t = torch.linspace(0.0, 1.0, n, device=device) * (far - near) + near
    t = t.expand(n_rays, n)
    if u is None:
        return t
    mid = 0.5 * (t[:, 1:] + t[:, :-1])
    hi, lo = torch.cat([mid, t[:, -1:]], -1), torch.cat([t[:, :1], mid], -1)
    return lo + (hi - lo) * u


def weights(sigma: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Compositing weights of raw density (ReLU inside) at depths ``t``."""
    delta = torch.cat([t[:, 1:] - t[:, :-1], torch.full_like(t[:, :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    return alpha * torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)


def composite(rgb: torch.Tensor, sigma: torch.Tensor, t: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(rgb, t_exp, acc, weights)`` of one ray batch."""
    w = weights(sigma, t)
    return (w[..., None] * rgb).sum(-2), (w * t).sum(-1), w.sum(-1), w


def fine_depths(t: torch.Tensor, w: torch.Tensor, n_fine: int) -> torch.Tensor:
    """Inverse-CDF resampling at evenly spaced u from the coarse weights
    (bins at the coarse midpoints, end weights dropped), merged with the
    coarse depths and sorted."""
    bins = 0.5 * (t[:, 1:] + t[:, :-1])
    wt = w[:, 1:-1].detach() + 1e-5
    cdf = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    u = torch.linspace(0.0, 1.0, n_fine, device=t.device).expand(t.shape[0], n_fine).contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo = (idx - 1).clamp(0, cdf.shape[-1] - 1)
    hi = idx.clamp(0, cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b0, b1 = bins.gather(-1, lo), bins.gather(-1, hi)
    den = torch.where(c1 - c0 < 1e-5, torch.ones_like(c1), c1 - c0)
    t_new = b0 + (u - c0) / den * (b1 - b0)
    return torch.sort(torch.cat([t, t_new], -1), -1).values.detach()


def points(ro: torch.Tensor, rd: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return ro[:, None, :] + t[..., None] * rd[:, None, :]


# ---------------------------------------------------------------- rendering


@torch.no_grad()
def render(pc: Dict[str, torch.Tensor], pf: Dict[str, torch.Tensor], cfg: Dict,
           ro: torch.Tensor, rd: torch.Tensor, precision: str = "f32", block: int = 4096
           ) -> torch.Tensor:
    """The exact novel view of rays ``[R, 3]``: σ-only coarse pass at the
    unperturbed depths, resampling, the fine pass. Returns ``[R, 5]``: rgb,
    expected depth, accumulated opacity; in blocks of ``block`` rays."""
    nc, nf = int(cfg["N_samples"]), int(cfg["N_samples_fine"])
    out = []
    for s in range(0, ro.shape[0], block):
        o, d = ro[s: s + block], rd[s: s + block]
        t = depths(o.shape[0], nc, 0.0, 1.0, None, o.device)
        w = weights(nerf(pc, cfg, points(o, d, t), None, precision)["sigma"], t)
        tf = fine_depths(t, w, nf)
        f = nerf(pf, cfg, points(o, d, tf), d[:, None, :].expand(-1, tf.shape[1], 3), precision)
        rgb, t_exp, acc, _ = composite(f["rgb"], f["sigma"], tf)
        out.append(torch.cat([rgb, t_exp[:, None], acc[:, None]], -1))
    return torch.cat(out, 0)


# ---------------------------------------------------------------- training


def step_losses(pc, pf, cfg: Dict, ro, rd, rgb_gt, u, noise_c, noise_f, precision: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase A's two MSE terms on one batch: jittered coarse depths, σ noise
    (std ``sigma_noise_std``) on both passes before the ReLU."""
    std = float(cfg["sigma_noise_std"])
    nc, nf = int(cfg["N_samples"]), int(cfg["N_samples_fine"])
    t = depths(ro.shape[0], nc, 0.0, 1.0, u, ro.device)
    dirs = lambda n: rd[:, None, :].expand(-1, n, 3)
    c = nerf(pc, cfg, points(ro, rd, t), dirs(nc), precision)
    rgb_c, _, _, w = composite(c["rgb"], c["sigma"] + std * noise_c, t)
    tf = fine_depths(t, w, nf)
    f = nerf(pf, cfg, points(ro, rd, tf), dirs(nc + nf), precision)
    rgb_f, _, _, _ = composite(f["rgb"], f["sigma"] + std * noise_f, tf)
    return ((rgb_c - rgb_gt) ** 2).mean(), ((rgb_f - rgb_gt) ** 2).mean()


def train(params0: Dict[str, Dict[str, torch.Tensor]], cfg: Dict, batches: List[Dict],
          precision: str = "f32", half_batch: bool = False) -> Dict:
    """Phase A's first steps from ``params0`` (``{"coarse", "fine"}`` state
    dicts) on ``batches`` (one dict a step: ``ro, rd, rgb, u, noise_c,
    noise_f``), with Adam(0.9, 0.999, 1e-8) at ``lrate * 0.1 ** (n /
    lrate_decay)`` for update n from 0. Returns each step's loss, the first
    step's gradients and the parameters after the last step, by leaf
    (``coarse.<name>``, ``fine.<name>``). ``half_batch`` is a fault: each step
    takes the mean over the first half of its rows alone."""
    p = {f"{net}.{k}": v.detach().clone().float().requires_grad_(True)
         for net in ("coarse", "fine") for k, v in params0[net].items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    sub = lambda net: {k[len(net) + 1:]: v for k, v in p.items() if k.startswith(net + ".")}
    losses, grad0 = [], None
    for n, b in enumerate(batches):
        rows = slice(0, b["ro"].shape[0] // 2) if half_batch else slice(None)
        lc, lf = step_losses(sub("coarse"), sub("fine"), cfg, *(b[k][rows] for k in (
            "ro", "rd", "rgb", "u", "noise_c", "noise_f")), precision)
        loss = lc + lf
        g = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if grad0 is None:
            grad0 = {k: gi.detach().clone() for k, gi in zip(p, g)}
        lr = float(cfg["lrate"]) * 0.1 ** (n / float(cfg["lrate_decay"]))
        with torch.no_grad():
            for (k, w), gi in zip(p.items(), g):
                m[k].mul_(0.9).add_(gi, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(gi, gi, value=0.001)
                mh, vh = m[k] / (1 - 0.9 ** (n + 1)), v2[k] / (1 - 0.999 ** (n + 1))
                w.sub_(lr * mh / (vh.sqrt() + 1e-8))
    return {"losses": losses, "grad0": grad0,
            "params": {k: w.detach() for k, w in p.items()}}
