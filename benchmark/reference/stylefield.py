"""The plain reference of the style-field cells: TGTC's 3D style field (the
concat MLP and the style MLP with a variational latent table, on the frozen
NeRF trunk of :mod:`benchmark.reference.nerf`), its stylized render and its
Phase-E distillation step, in plain ``torch`` and float32 with TF32 off. It
imports nothing of the program.

``precision="fp8"`` is the control of the stylized render (the kernels run
bf16); ``"tf32"`` is the control of the Phase-E step, whose style MLPs run in
f32: their products in TF32 and the frozen trunk's in float8 e4m3 (the step
below its bf16).

TGTC's own layout, kept: the latent is re-fed at every layer of both MLPs
and the encoded point again at layer 4; the style MLP reads the per-ray
mean of the latent in each of its latent columns; the first layer of the
style MLP reads ``[base_remap | concat features | encoded point]``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import nerf as ref_nerf

SKIP = 4


def _lin(x, p, name, precision):
    if precision == "tf32":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.nn.functional.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return ref_nerf.linear(x, p, name, precision)


def trunk_precision(precision: str) -> str:
    return "fp8" if precision in ("fp8", "tf32") else "f32"


def style_rgb(ps: Dict[str, torch.Tensor], cfg: Dict, pts_embed: torch.Tensor,
              base_remap: torch.Tensor, lat: torch.Tensor, precision: str) -> torch.Tensor:
    """Stylized rgb ``[R, S, 3]`` from the trunk's ``base_remap`` and
    ``pts_embed`` ``[R, S, *]`` and per-ray latents ``lat [R, D]``."""
    sd = int(cfg["style_D"])
    r, s = pts_embed.shape[:2]
    lat_full = lat[:, None, :].expand(r, s, lat.shape[-1])
    lat_mean = lat.mean(-1, keepdim=True)[:, None, :].expand(r, s, lat.shape[-1])
    h = pts_embed
    for i in range(min(sd - 1, SKIP + 1)):
        h = torch.cat([h, lat_full] + ([pts_embed] if i == SKIP else []), -1)
        h = torch.relu(_lin(h, ps, f"concat.layers.{i}", precision))
    h = torch.cat([base_remap, h, pts_embed], -1)
    for i in range(sd - 1):
        h = torch.cat([h, lat_mean] + ([pts_embed] if i == SKIP else []), -1)
        h = torch.relu(_lin(h, ps, f"style.layers.{i}", precision))
    return torch.sigmoid(_lin(torch.cat([h, lat_mean], -1), ps, f"style.layers.{sd - 1}",
                              precision))


def stylized_pass(pn, ps, cfg, ro, rd, t, lat, precision: str, noise=None):
    """One stylized pass at depths ``t``: ``(rgb, t_exp, weights)``; the
    trunk takes no gradient."""
    with torch.no_grad():
        n = ref_nerf.nerf(pn, cfg, ref_nerf.points(ro, rd, t), None, trunk_precision(precision),
                          remap=True)
    rgb = style_rgb(ps, cfg, n["pts_embed"], n["base_remap"], lat, precision)
    sigma = n["sigma"] if noise is None else n["sigma"] + float(cfg["sigma_noise_std"]) * noise
    c_rgb, t_exp, _, w = ref_nerf.composite(rgb, sigma, t)
    return c_rgb, t_exp, w


@torch.no_grad()
def render(pc, pf, ps, cfg: Dict, ro, rd, lat, u, precision: str = "f32", block: int = 4096
           ) -> torch.Tensor:
    """Phase F's stylized view of rays ``[R, 3]`` with per-ray latents ``lat
    [R, D]`` and coarse jitter ``u [R, Nc]``: the coarse σ at the jittered
    depths, resampling, the stylized fine pass, no σ noise. Returns ``[R,
    4]``: rgb and expected depth."""
    nc, nf = int(cfg["N_samples"]), int(cfg["N_samples_fine"])
    out = []
    for s in range(0, ro.shape[0], block):
        o, d, la = ro[s: s + block], rd[s: s + block], lat[s: s + block]
        t = ref_nerf.depths(o.shape[0], nc, 0.0, 1.0, u[s: s + block], o.device)
        sig = ref_nerf.nerf(pc, cfg, ref_nerf.points(o, d, t), None,
                            trunk_precision(precision))["sigma"]
        tf = ref_nerf.fine_depths(t, ref_nerf.weights(sig, t), nf)
        rgb, t_exp, _ = stylized_pass(pf, ps, cfg, o, d, tf, la, precision)
        out.append(torch.cat([rgb, t_exp[:, None]], -1))
    return torch.cat(out, 0)


def _cos(a, b, eps=1e-8):
    na = torch.sqrt((a * a).sum(-1) + eps * eps)
    nb = torch.sqrt((b * b).sum(-1) + eps * eps)
    return (a * b).sum(-1) / (na * nb)


def _two_pass(pc, pf, ps, cfg, b, lat, u, noise, precision):
    nc, nf = int(cfg["N_samples"]), int(cfg["N_samples_fine"])
    t = ref_nerf.depths(b["ro"].shape[0], nc, 0.0, 1.0, u, b["ro"].device)
    rgb_c, _, w = stylized_pass(pc, ps, cfg, b["ro"], b["rd"], t, lat, precision, noise[0])
    tf = ref_nerf.fine_depths(t, w, nf)
    rgb_f, _, _ = stylized_pass(pf, ps, cfg, b["ro"], b["rd"], tf, lat, precision, noise[1])
    return rgb_c, rgb_f


def train(trunks: Dict[str, Dict[str, torch.Tensor]], ps0: Dict[str, torch.Tensor],
          table: Dict[str, torch.Tensor], cfg: Dict, steps: List[Dict], precision: str = "f32",
          half_batch: bool = False) -> Dict:
    """Phase E's first steps from the style MLPs ``ps0`` and the latent
    table ``table`` (``latents [S, F, D]``, ``mu``, ``logvar [S, D]``) on the
    frozen ``trunks`` (``{"coarse", "fine"}``), past the coherence gate
    (the coherence loss is computed, not trained). ``steps``: one dict a step
    with the main stream (``main``: ``ro, rd, rgb, style, frame``), the
    coherent stream (``coh``: ``ro, rd, origin``), the jitter ``u_main,
    u_coh`` and the σ noise ``noise_main, noise_coh`` (coarse, fine).
    Adam(0.9, 0.999, 1e-8) in two groups: ``lrate`` on the MLPs,
    ``latent_lrate`` on the table. Returns each step's loss (rgb + latent
    prior), each step's coherence loss, the first step's gradients and the
    trained leaves after the last step (``style.*``, ``concat.*``,
    ``latents``). ``half_batch`` is a fault: the main stream's mean over the
    first half of its rows alone."""
    pc, pf = trunks["coarse"], trunks["fine"]
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in ps0.items()}
    p["latents"] = table["latents"].detach().clone().float().requires_grad_(True)
    mu, logvar = table["mu"].float(), table["logvar"].float()
    lrs = {k: float(cfg["latent_lrate"] if k == "latents" else cfg["lrate"]) for k in p}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    s_num, f_num, d = p["latents"].shape
    losses, coh_losses, grad0, prev = [], [], None, None
    for n, st in enumerate(steps):
        mb = st["main"]
        rows = slice(0, mb["ro"].shape[0] // 2) if half_batch else slice(None)
        mb = {k: v[rows] for k, v in mb.items()}
        lat = p["latents"].reshape(-1, d)[mb["style"] * f_num + mb["frame"]]
        rgb_c, rgb_f = _two_pass(pc, pf, p, cfg, mb, lat, st["u_main"][rows],
                                 tuple(x[rows] for x in st["noise_main"]), precision)
        loss_rgb = float(cfg["rgb_loss_lambda"]) * (((rgb_c - mb["rgb"]) ** 2).mean()
                                                    + ((rgb_f - mb["rgb"]) ** 2).mean())
        mu_r, lv_r = mu[mb["style"]], logvar[mb["style"]]
        logp = (((lat - mu_r) ** 2) / (torch.exp(0.5 * lv_r) + 1e-3)).sum(-1).mean()
        loss = loss_rgb + float(cfg["logp_loss_lambda"]) * logp
        with torch.no_grad():
            cb = st["coh"]
            lat_c = p["latents"].detach().reshape(-1, d)[cb["style"] * f_num + cb["frame"]]
            c2, f2 = _two_pass(pc, pf, p, cfg, cb, lat_c, st["u_coh"], st["noise_coh"],
                               precision)
            if prev is None:
                coh_losses.append(0.0)
            else:
                origin = _cos(cb["origin"], prev[2])
                l2 = lambda x: torch.sqrt((x ** 2).sum() + 1e-8)
                coh_losses.append(float(l2(_cos(c2, prev[0]) - origin)
                                        + l2(_cos(f2, prev[1]) - origin)))
            prev = (c2, f2, cb["origin"])
        g = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if grad0 is None:
            grad0 = {k: gi.detach().clone() for k, gi in zip(p, g)}
        with torch.no_grad():
            for (k, w), gi in zip(p.items(), g):
                m[k].mul_(0.9).add_(gi, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(gi, gi, value=0.001)
                mh, vh = m[k] / (1 - 0.9 ** (n + 1)), v2[k] / (1 - 0.999 ** (n + 1))
                w.sub_(lrs[k] * mh / (vh.sqrt() + 1e-8))
    return {"losses": losses, "coh_losses": coh_losses, "grad0": grad0,
            "params": {k: w.detach() for k, w in p.items()}}
