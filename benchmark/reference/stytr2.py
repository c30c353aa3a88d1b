"""The plain reference of the StyTr² cell: StyTr² (Deng et al., "StyTr²: Image
Style Transfer with Transformers", CVPR 2022, arXiv:2105.14576) as TGTC-Style
trains it in Phase C1, in plain ``torch`` and float32 with TF32 off. It
imports nothing of the program; it reads weights from one state dict under
the reference implementation's torch names, each module under its prefix:
``embedding.*`` (``embedding_iter_*.pth``), ``transformer.*``
(``transformer_iter_*.pth``), ``decode.*`` (``decoder.pth``) and ``vgg.*``
(``vgg_normalised.pth``).

A C1 step: the patch embedding (a conv of kernel and stride 8), the style
and the content encoder, the decoder, the CNN decoder and the VGG pyramid;
the content, style and two identity losses and their weighted sum;
autograd's gradients of the trained leaves (``transformer.*`` and
``embedding.*``; the VGG and the CNN decoder are frozen and pass input
gradients); Adam(0.9, 0.999, 1e-8) under C1's schedule.

Departures from the published StyTr², all TGTC's:

* CAPE is replaced by three positional patterns, one a transformer call:
  ``ics`` (the style encoder without ``pos``, the content encoder with the
  content tokens as ``pos``, the decoder's query position the content
  tokens), ``icc`` (``pos`` on both encoders, the style tokens as the
  memory's position) and ``iss`` (no ``pos``). ``pos`` only chooses an
  encoder's branch; it is never added in an encoder.
* An encoder layer without ``pos`` takes a fused ``qkv`` projection (no
  bias) whose ``v`` replaces the residual stream; with ``pos`` a fused
  ``qk`` projection (no bias) and the raw input as ``v``.
* The decoder's "self"-attention is a second cross-attention over the
  style memory; both add the query position to the content stream.
* The VGG is truncated at relu4_1 (``vgg[:31]``), so its fifth level
  repeats relu4_1.
* LayerNorm's epsilon is 1e-6.

Dropout is part of the step, and the reference draws the program's masks:

* one ``torch.Generator`` a step on the program's device, seeded from the
  step's (seed, step) by :func:`step_seed`;
* the draws in the program's order: the Ics, then the Icc, then the Iss
  call; within a call the style encoder's layers, the content encoder's,
  then the decoder's; within a layer each attention's int32 hash seed
  (``torch.randint(2**31 - 1, (1,), dtype=int32)``) before the uniform
  ``[B, N, C]`` draw of its residual branch, then the FFN's hidden and
  output draws. A residual or FFN element is kept where its draw is below
  ``1 - rate`` and scaled by ``1 / (1 - rate)``;
* the attention probabilities' masks from :func:`keep_mask`, the murmur3
  counter hash of (seed, batch·head, row, col), written out below, with the
  keep threshold quantized to 2⁻³²; kept probabilities are scaled by the
  inverse of the quantized keep.

``precision="fp8"`` is the control: every matrix product and convolution
takes operands rounded to float8 e4m3 with one scale a tensor (the step
below the program's bf16), accumulated in f32. Two faults:
``half_batch`` (each step on the first half of its rows alone, with the
masks those rows have in the whole batch) and ``mask_seed`` (the dropout
drawn from another seed).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.nerf import fp8

GOLDEN = 0x9E3779B97F4A7C15
U32 = 0xFFFFFFFF
LN_EPS = 1e-6
SEED_HIGH = 2 ** 31 - 1  # the attention seeds' exclusive upper end
# VGG-19 through relu4_1 as the ten convs of vgg[:31] (``vgg_convs`` of the
# configuration): their torch indices, the convs a 2x2 max-pool precedes
# and the convs whose ReLU is a pyramid level
VGG_INDEX = (0, 2, 5, 9, 12, 16, 19, 22, 25, 29)
VGG_POOL_BEFORE = (3, 5, 9)
VGG_TAPS = (1, 3, 5, 9)
LEVELS = 5


def step_seed(seed: int, step: int) -> int:
    """The generator seed of C1 step ``step`` (counted from 0) of a run
    seeded ``seed``: ``((seed + 1) · 0x9E3779B97F4A7C15 + step) mod 2^63``."""
    return ((seed + 1) * GOLDEN + step) % (1 << 63)


def lr_at(cfg: Dict, n: int) -> float:
    """C1's learning rate at update ``n`` (from 0): warm-up, then decay."""
    if n < int(cfg["warmup_iters"]):
        return float(cfg["lr"]) * 0.1 * (1.0 + 3e-4 * n)
    return 2e-4 / (1.0 + float(cfg["lr_decay"]) * (n - 1e4))


# ---------------------------------------------------------------- dropout


def quantized_keep(rate: float):
    """``(threshold, keep)``: an attention probability is dropped where its
    uint32 hash is below ``round(rate · 2^32)``; ``keep`` is the exact share
    kept."""
    thr = min(max(int(round(rate * 2.0 ** 32)), 0), 2 ** 32 - 1)
    return thr, 1.0 - thr / 2.0 ** 32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2^32`` for int64 ``x`` in [0, 2^32), in two 16-bit halves
    of ``c`` so that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & U32


def keep_mask(seed: int, bh: torch.Tensor, n_q: int, n_k: int, thr: int) -> torch.Tensor:
    """``[len(bh), n_q, n_k]``: True where the attention probability of
    batch·head ``bh`` (counted in the whole batch), query row and key column
    is kept. The draw is murmur3's fmix32 of ``(row · 0x9E3779B9) ^ (col ·
    0x85EBCA6B) ^ salt``, ``salt = seed + bh · 0xC2B2AE35``, all mod 2^32;
    kept where the draw is at least ``thr``."""
    dev = bh.device
    salt = ((seed & U32) + (bh.long() & U32) * 0xC2B2AE35) & U32
    rows = _mul32(torch.arange(n_q, device=dev, dtype=torch.long), 0x9E3779B9)
    cols = _mul32(torch.arange(n_k, device=dev, dtype=torch.long), 0x85EBCA6B)
    x = (salt[:, None, None] ^ rows[None, :, None]) ^ cols[None, None, :]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= thr


class Draws:
    """One step's dropout: the generator the program's step seeds, drawn in
    the program's order. Every draw is the whole batch's (``total`` rows),
    cut to the first ``rows``."""

    def __init__(self, gen: Optional[torch.Generator], rate: float, rows: int, total: int):
        self.gen, self.rate, self.rows, self.total = gen, rate, rows, total

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand((self.total, *x.shape[1:]), generator=self.gen,
                       device=x.device)[: self.rows]
        return torch.where(u < keep, x / keep, 0.0)

    def attention_seed(self, device) -> Optional[int]:
        if self.rate <= 0.0:
            return None
        return int(torch.randint(SEED_HIGH, (1,), generator=self.gen, device=device,
                                 dtype=torch.int32).item())


# ---------------------------------------------------------------- layers


def _ops(precision: str):
    if precision == "fp8":
        return fp8
    if precision != "f32":
        raise ValueError(precision)
    return lambda x: x


def linear(x, w, b, precision: str):
    q = _ops(precision)
    return F.linear(q(x), q(w), b)


def conv(x, w, b, precision: str, stride: int = 1):
    q = _ops(precision)
    return F.conv2d(q(x), q(w), b, stride=stride)


def layer_norm(x, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def attention(p, name: str, q, k, v, heads: int, draws: Draws, precision: str):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight`` /
    ``in_proj_bias`` as three d → d projections, ``out_proj``) on ``[B, N,
    d]`` tensors; softmax(q kᵀ / sqrt(d_head)), its dropout, times v."""
    d = q.shape[-1]
    w, b = p[f"{name}.in_proj_weight"], p[f"{name}.in_proj_bias"]

    def heads_of(x, i):
        y = linear(x, w[i * d: (i + 1) * d], b[i * d: (i + 1) * d], precision)
        return y.view(x.shape[0], x.shape[1], heads, d // heads).transpose(1, 2)

    qh, kh, vh = heads_of(q, 0), heads_of(k, 1), heads_of(v, 2)
    cast = _ops(precision)
    prob = torch.softmax(cast(qh) @ cast(kh).transpose(-1, -2) / math.sqrt(d // heads), -1)
    seed = draws.attention_seed(q.device)
    if seed is not None:
        thr, keep = quantized_keep(draws.rate)
        bsz, _, n_q, n_k = prob.shape
        bh = torch.arange(bsz * heads, device=q.device)
        mask = keep_mask(seed, bh, n_q, n_k, thr).view(prob.shape)
        prob = torch.where(mask, prob * (1.0 / keep), 0.0)
    out = (cast(prob) @ cast(vh)).transpose(1, 2).reshape(q.shape[0], q.shape[1], d)
    return linear(out, p[f"{name}.out_proj.weight"], p[f"{name}.out_proj.bias"], precision)


def ffn(p, name: str, x, draws: Draws, precision: str):
    h = draws.residual(torch.relu(linear(x, p[f"{name}.linear1.weight"],
                                         p[f"{name}.linear1.bias"], precision)))
    return linear(h, p[f"{name}.linear2.weight"], p[f"{name}.linear2.bias"], precision)


def encoder_layer(p, name: str, src, pos, heads: int, draws: Draws, precision: str):
    if pos is None:  # v replaces src in the residual stream
        q, k, src = linear(src, p[f"{name}.qkv.weight"], None, precision).chunk(3, -1)
    else:
        q, k = linear(src, p[f"{name}.qk.weight"], None, precision).chunk(2, -1)
    a = attention(p, f"{name}.self_attn", q, k, src, heads, draws, precision)
    src = layer_norm(src + draws.residual(a), p, f"{name}.norm1")
    ff = ffn(p, name, src, draws, precision)
    return layer_norm(src + draws.residual(ff), p, f"{name}.norm2")


def decoder_layer(p, name: str, tgt, memory, pos, query_pos, heads: int, draws: Draws,
                  precision: str):
    key = memory if pos is None else memory + pos
    for attn, norm in (("self_attn", "norm1"), ("multihead_attn", "norm2")):
        query = tgt if query_pos is None else tgt + query_pos
        a = attention(p, f"{name}.{attn}", query, key, memory, heads, draws, precision)
        tgt = layer_norm(tgt + draws.residual(a), p, f"{name}.{norm}")
    ff = ffn(p, name, tgt, draws, precision)
    return layer_norm(tgt + draws.residual(ff), p, f"{name}.norm3")


def transformer(p, cfg: Dict, style, content, mode: str, draws: Draws, precision: str):
    """Style and content tokens ``[B, N, d]`` → the stylized content tokens."""
    pos_s, pos_c = {"ics": (None, content), "icc": (style, content),
                    "iss": (None, None)}[mode]
    heads = int(cfg["nhead"])
    s, c = style, content
    for i in range(int(cfg["num_encoder_layers"])):
        s = encoder_layer(p, f"transformer.encoder_s.layers.{i}", s, pos_s, heads, draws,
                          precision)
    for i in range(int(cfg["num_encoder_layers"])):
        c = encoder_layer(p, f"transformer.encoder_c.layers.{i}", c, pos_c, heads, draws,
                          precision)
    for i in range(int(cfg["num_decoder_layers"])):
        c = decoder_layer(p, f"transformer.decoder.layers.{i}", c, s, pos_s, pos_c, heads,
                          draws, precision)
    return layer_norm(c, p, "transformer.decoder.norm")


def embed(p, cfg: Dict, img, precision: str):
    """NHWC image → tokens ``[B, (H/8)(W/8), d]``, row-major."""
    y = conv(img.permute(0, 3, 1, 2), p["embedding.proj.weight"], p["embedding.proj.bias"],
             precision, stride=int(cfg["patch_size"]))
    return y.flatten(2).transpose(1, 2)


def pad(x):
    return F.pad(x, (1, 1, 1, 1), mode="reflect")


def decoder_indices(cfg: Dict) -> List[int]:
    """The torch indices of the CNN decoder's convs in its ``nn.Sequential``
    (an upsample, a reflection pad, the conv, a ReLU but after the last)."""
    up, out, i = set(cfg["decoder_upsample_before"]), [], 0
    for j in range(len(cfg["decoder_convs"])):
        i += 1 if j in up else 0
        out.append(i + 1)
        i += 3
    return out


def decode(p, cfg: Dict, tokens, hw, precision: str):
    """Tokens ``[B, h·w, d]`` → NHWC image ``[B, 8h, 8w, 3]``: 3x3 reflection-
    padded convs with ReLU but the last, three 2x nearest upsamples."""
    y = tokens.transpose(1, 2).reshape(tokens.shape[0], tokens.shape[2], *hw)
    up, idx = set(cfg["decoder_upsample_before"]), decoder_indices(cfg)
    last = len(idx) - 1
    for j, i in enumerate(idx):
        if j in up:
            y = F.interpolate(y, scale_factor=2, mode="nearest")
        y = conv(pad(y), p[f"decode.{i}.weight"], p[f"decode.{i}.bias"], precision)
        if j < last:
            y = torch.relu(y)
    return y.permute(0, 2, 3, 1)


def vgg(p, img, precision: str) -> List[torch.Tensor]:
    """NHWC image in [0, 1] → the five-level pyramid (NCHW): relu1_1,
    relu2_1, relu3_1, relu4_1 and relu4_1 again."""
    y, feats = img.permute(0, 3, 1, 2), []
    for j, i in enumerate(VGG_INDEX):
        w, b = p[f"vgg.{i}.weight"], p[f"vgg.{i}.bias"]
        if j == 0:  # the 1x1 RGB remap: no padding, no ReLU
            y = conv(y, w, b, precision)
            continue
        if j in VGG_POOL_BEFORE:
            y = F.max_pool2d(y, 2, 2, ceil_mode=True)
        y = torch.relu(conv(pad(y), w, b, precision))
        if j in VGG_TAPS:
            feats.append(y)
    return feats + [feats[-1]] * (LEVELS - len(feats))


def mean_std(f, eps: float = 1e-5):
    """Per-image, per-channel mean and std (unbiased, eps inside the root)."""
    return f.mean((2, 3)), torch.sqrt(f.var((2, 3), correction=1) + eps)


def normal(f):
    m, s = mean_std(f)
    return (f - m[..., None, None]) / s[..., None, None]


def mse(a, b):
    return torch.mean((a - b) ** 2)


def stylize(p, cfg: Dict, content, style, mode: str, draws: Draws, precision: str):
    patch = int(cfg["patch_size"])
    hw = (content.shape[1] // patch, content.shape[2] // patch)
    hs = transformer(p, cfg, embed(p, cfg, style, precision), embed(p, cfg, content, precision),
                     mode, draws, precision)
    return decode(p, cfg, hs, hw, precision)


def losses(p, cfg: Dict, content, style, draws: Draws, precision: str = "f32"
           ) -> Dict[str, torch.Tensor]:
    """C1's four losses of NHWC batches in [0, 1], each a mean over the
    batch's images, and ``loss``, their weighted sum."""
    c_feats, s_feats = vgg(p, content, precision), vgg(p, style, precision)
    ics = stylize(p, cfg, content, style, "ics", draws, precision)
    i_feats = vgg(p, ics, precision)
    loss_c = sum(mse(normal(i_feats[k]), normal(c_feats[k])) for k in (-1, -2))
    loss_s = 0.0
    for fi, ft in zip(i_feats, s_feats):
        (im, istd), (tm, tstd) = mean_std(fi), mean_std(ft)
        loss_s = loss_s + mse(im, tm) + mse(istd, tstd)
    icc = stylize(p, cfg, content, content, "icc", draws, precision)
    iss = stylize(p, cfg, style, style, "iss", draws, precision)
    l_id1 = mse(icc, content) + mse(iss, style)
    cc_feats, ss_feats = vgg(p, icc, precision), vgg(p, iss, precision)
    l_id2 = sum(mse(a, b) + mse(c, d)
                for a, b, c, d in zip(cc_feats, c_feats, ss_feats, s_feats))
    loss = (float(cfg["content_weight"]) * loss_c + float(cfg["style_weight"]) * loss_s
            + float(cfg["id1_weight"]) * l_id1 + float(cfg["id2_weight"]) * l_id2)
    return {"loss": loss, "loss_c": loss_c, "loss_s": loss_s, "l_id1": l_id1, "l_id2": l_id2}


def trained(name: str) -> bool:
    return name.split(".")[0] in ("transformer", "embedding")


def train(params0: Dict[str, torch.Tensor], cfg: Dict, batches: Sequence[Dict],
          seed: int, precision: str = "f32", half_batch: bool = False,
          mask_seed: bool = False) -> Dict:
    """C1's first steps from ``params0`` on ``batches`` (one dict a step:
    NHWC ``content`` and ``style`` in [0, 1]), each step's dropout from a
    generator on the batches' device seeded by :func:`step_seed` of
    ``seed`` and the step. Returns each step's loss, the first step's
    gradients and the trained leaves after the last step."""
    p = {k: v.detach().clone().float().requires_grad_(trained(k)) for k, v in params0.items()}
    leaves = {k: v for k, v in p.items() if trained(k)}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    rate = float(cfg["dropout"])
    out_losses, grad0 = [], None
    for n, b in enumerate(batches):
        total = b["content"].shape[0]
        rows = total // 2 if half_batch else total
        dev = b["content"].device
        gen = torch.Generator(device=dev).manual_seed(step_seed(seed + int(mask_seed), n))
        draws = Draws(gen, rate, rows, total)
        loss = losses(p, cfg, b["content"][:rows], b["style"][:rows], draws, precision)["loss"]
        g = torch.autograd.grad(loss, list(leaves.values()))
        out_losses.append(float(loss.detach()))
        if grad0 is None:
            grad0 = {k: gi.detach().clone() for k, gi in zip(leaves, g)}
        lr = lr_at(cfg, n)
        with torch.no_grad():
            for (k, w), gi in zip(leaves.items(), g):
                m[k].mul_(0.9).add_(gi, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(gi, gi, value=0.001)
                mh, vh = m[k] / (1 - 0.9 ** (n + 1)), v2[k] / (1 - 0.999 ** (n + 1))
                w.sub_(lr * mh / (vh.sqrt() + 1e-8))
    return {"losses": out_losses, "grad0": grad0,
            "params": {k: w.detach() for k, w in leaves.items()}}
