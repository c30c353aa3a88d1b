"""Phase C1's StyTr² training step, driven as a closed loop (``stytr2.c1-train``).

The program: ``train.transformer2d.make_transformer_train_step`` →
``TransformerTrainStep.__call__`` on ``models.stytrans.make_stytrans`` at the
configuration's widths and ``dtype`` (bf16) with the flash attention (K6
forward, K7 and K8 backward, dropout in the kernels), holding the benchmark's seeded
weights: three transformer calls (Ics, Icc, Iss), three CNN decoder passes
and five VGG pyramids a step, Adam over the transformer and the patch
embedding. The feed: the content and style pools made on the device and
put through the reference's train transform (each image resized to
``resize``² once, uint8); each step's rows are crops of ``crop``² at image
indices and corners from a generator seeded by (seed, step); the step seeds
its own dropout generator from (the run's dropout seed, step). Set-up takes
the first three steps through that same call and feed; the check follows
them with the plain reference, dropout masks and all.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.drivers import common as C
from benchmark.harness import attention_work as AW
from benchmark.harness import traffic as T
from benchmark.reference import compare
from benchmark.reference import stytr2 as R

CHECK_STEPS = 3
DROPOUT_KEY = 5
ATTENTION = ("K6", "K7", "K8")


# ---------------------------------------------------------------- weights


def shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(name, shape, init)`` of every parameter under the reference's torch
    names; ``init`` is ``lecun``, ``he``, ``zero`` or ``one``."""
    d, f, p = int(cfg["d_model"]), int(cfg["dim_feedforward"]), int(cfg["patch_size"])
    out = [("embedding.proj.weight", (d, 3, p, p), "lecun"), ("embedding.proj.bias", (d,), "zero")]

    def dense(name, n_out, n_in, bias=True):
        out.append((f"{name}.weight", (n_out, n_in), "lecun"))
        if bias:
            out.append((f"{name}.bias", (n_out,), "zero"))

    def attention(name):
        out.extend([(f"{name}.in_proj_weight", (3 * d, d), "lecun"),
                    (f"{name}.in_proj_bias", (3 * d,), "zero")])
        dense(f"{name}.out_proj", d, d)

    def norm(name):
        out.extend([(f"{name}.weight", (d,), "one"), (f"{name}.bias", (d,), "zero")])

    for enc in ("encoder_s", "encoder_c"):
        for i in range(int(cfg["num_encoder_layers"])):
            pre = f"transformer.{enc}.layers.{i}"
            dense(f"{pre}.qkv", 3 * d, d, bias=False)
            dense(f"{pre}.qk", 2 * d, d, bias=False)
            attention(f"{pre}.self_attn")
            dense(f"{pre}.linear1", f, d)
            dense(f"{pre}.linear2", d, f)
            norm(f"{pre}.norm1")
            norm(f"{pre}.norm2")
    for i in range(int(cfg["num_decoder_layers"])):
        pre = f"transformer.decoder.layers.{i}"
        attention(f"{pre}.self_attn")
        attention(f"{pre}.multihead_attn")
        dense(f"{pre}.linear1", f, d)
        dense(f"{pre}.linear2", d, f)
        for k in (1, 2, 3):
            norm(f"{pre}.norm{k}")
    norm("transformer.decoder.norm")
    for idx, (c_in, c_out) in zip(R.decoder_indices(cfg), cfg["decoder_convs"]):
        out += [(f"decode.{idx}.weight", (c_out, c_in, 3, 3), "he"),
                (f"decode.{idx}.bias", (c_out,), "zero")]
    for idx, (c_in, c_out, k) in zip(R.VGG_INDEX, cfg["vgg_convs"]):
        out += [(f"vgg.{idx}.weight", (c_out, c_in, k, k), "he"),
                (f"vgg.{idx}.bias", (c_out,), "zero")]
    return out


def draw_weights(cfg: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every parameter from one normal draw on ``device``: LeCun-normal (std
    1/sqrt(fan_in)) transformer and embedding weights, He-normal (std
    sqrt(2/fan_in)) VGG and CNN decoder weights, zero biases, unit
    LayerNorm scales. An in-projection's fan-in is d_model (three d → d
    projections)."""
    sh = shapes(cfg)
    normal = [(n, s, i) for n, s, i in sh if i in ("lecun", "he")]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=gen, device=device)
    out, k = {}, 0
    for name, shape, init in sh:
        if init == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif init == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            fan_in = n // shape[0]
            std = math.sqrt((2.0 if init == "he" else 1.0) / fan_in)
            out[name] = flat[k: k + n].view(shape) * std
            k += n
    return out


# ---------------------------------------------------------------- inputs


def resized(images: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC images in [0, 1] → uint8 ``[N, size, size, 3]``, bilinear, rounded
    to nearest."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False)
    return (x.permute(0, 2, 3, 1).clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).contiguous()


def pools(cfg: Dict, gen: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The content pool (smooth synthetic views) and the style pool (upsampled
    uniform noise), both through the train transform's resize."""
    cp, sp, size = cfg["content_pool"], cfg["style_pool"], int(cfg["resize"])
    content = resized(T.smooth_images(gen, int(cp["n_views"]), int(cp["H"]), int(cp["W"]),
                                      device), size)
    grid = int(sp["grid"])
    noise = torch.rand((int(sp["n_images"]), 3, grid, grid), generator=gen, device=device)
    style = F.interpolate(noise, size=(int(sp["size"]),) * 2, mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    return content, resized(style, size)


def crops(pool: torch.Tensor, idx: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
          size: int) -> torch.Tensor:
    """``pool[idx[b], y0[b]:y0[b]+size, x0[b]:x0[b]+size]`` for each row, in
    one gather."""
    ar = torch.arange(size, device=pool.device)
    ys = (y0[:, None] + ar)[:, :, None]
    xs = (x0[:, None] + ar)[:, None, :]
    return pool[idx[:, None, None], ys, xs]


# ---------------------------------------------------------------- work


def transformer_macs(cfg: Dict, n: int, mode: str) -> int:
    """Multiply-adds of one transformer call on one image of ``n`` style and
    ``n`` content tokens: the encoders' fused projection (``qkv`` without
    ``pos``, ``qk`` with it), in-projections, attention products, output
    projections and FFNs, and the decoder's two cross-attentions over the
    memory and its FFN."""
    d, f = int(cfg["d_model"]), int(cfg["dim_feedforward"])
    attn = n * 3 * d * d + 2 * n * n * d + n * d * d  # in-projections, q kᵀ and p v, out
    ffn = 2 * n * d * f
    fused = {"ics": (3, 2), "icc": (2, 2), "iss": (3, 3)}[mode]  # style, content encoders
    enc = sum(n * k * d * d + attn + ffn for k in fused) * int(cfg["num_encoder_layers"])
    dec = (2 * attn + ffn) * int(cfg["num_decoder_layers"])
    return enc + dec


def vgg_macs(cfg: Dict, h: int, w: int) -> int:
    total = 0
    for j, (c_in, c_out, k) in enumerate(cfg["vgg_convs"]):
        if j in R.VGG_POOL_BEFORE:
            h, w = -(-h // 2), -(-w // 2)
        total += h * w * c_in * c_out * k * k
    return total


def decoder_macs(cfg: Dict, h: int, w: int) -> int:
    """The CNN decoder on an ``h × w`` token grid."""
    total, up = 0, set(cfg["decoder_upsample_before"])
    for j, (c_in, c_out) in enumerate(cfg["decoder_convs"]):
        if j in up:
            h, w = 2 * h, 2 * w
        total += h * w * c_in * c_out * 9
    return total


def model_flop(cfg: Dict) -> int:
    """FLOP of one step: the forward of everything (five VGG pyramids, three
    transformer calls with two patch embeddings each, three CNN decoder
    passes); the backward of the trained part at twice its forward (weight
    and input gradients), of the patch embeddings at once (weight gradients:
    the image takes none) and of what only passes an input gradient at once
    (the CNN decoder, the VGG on Ics, Icc and Iss). No recompute."""
    b, s, p = int(cfg["batch_size"]), int(cfg["crop"]), int(cfg["patch_size"])
    g = s // p
    n = g * g
    emb = n * 3 * p * p * int(cfg["d_model"])
    trans = sum(transformer_macs(cfg, n, m) for m in ("ics", "icc", "iss"))
    vgg, dec = vgg_macs(cfg, s, s), decoder_macs(cfg, g, g)
    forward = 5 * vgg + trans + 6 * emb + 3 * dec
    backward = 2 * trans + 6 * emb + 3 * dec + 3 * vgg
    return 2 * b * (forward + backward)


def attention_launch(cfg: Dict) -> Tuple[int, int, int, int]:
    """``(batch·heads, Sq, Sk, D)`` of every attention of the step."""
    n = (int(cfg["crop"]) // int(cfg["patch_size"])) ** 2
    h = int(cfg["nhead"])
    return int(cfg["batch_size"]) * h, n, n, int(cfg["d_model"]) // h


def attention_launches(cfg: Dict) -> int:
    """Launches of each of K6, K7 and K8 a step: three transformer calls of
    one attention an encoder layer and two a decoder layer."""
    return 3 * (2 * int(cfg["num_encoder_layers"]) + 2 * int(cfg["num_decoder_layers"]))


# ---------------------------------------------------------------- the check


def attention_projection(name: str) -> bool:
    """The attention projections' weights: each attention's ``in_proj_weight``
    and each encoder layer's fused ``qkv`` and ``qk``."""
    return name.endswith(("in_proj_weight", ".qkv.weight", ".qk.weight"))


def sign_flips(cand: Dict, ref: Dict) -> float:
    """The share of the attention projections' first-gradient elements whose
    sign differs from the reference's. Adam's first step moves each weight
    by lr · sign(gradient), so this is the share that step moved the wrong
    way. The projections' gradients are sums over tokens that the softmax's
    gradient nearly cancels: another batch or other dropout masks flip many
    of their signs, the bf16 step's rounding few (``PERF.md`` §2)."""
    flips = n = 0
    for k, g in ref["grad0"].items():
        if attention_projection(k):
            flips += int(((cand["grad0"][k] > 0) != (g > 0)).sum())
            n += g.numel()
    return flips / n


def key_bias_out(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` flat, without the key third of an ``in_proj_bias``: the key bias
    shifts every score of a query alike, so the softmax makes its gradient
    zero; the bf16 step's residue there is above Adam's ε, f32's below, and
    Adam moves the one by ~lr a step and the other not."""
    t = t.flatten()
    if not name.endswith("in_proj_bias"):
        return t
    d = t.shape[0] // 3
    return torch.cat([t[:d], t[2 * d:]])


def change_gap_no_key_bias(cand: Dict, ref: Dict, params0: Dict[str, torch.Tensor]) -> float:
    """``compare``'s ``change_gap`` with the key biases left out."""
    norm = lambda rec, k: float(key_bias_out(k, rec["params"][k].float()
                                            - params0[k].float()).double().norm())
    g_ref = {k: float(v.double().norm()) for k, v in ref["grad0"].items()}
    med = statistics.median(g_ref.values())
    moved = {k for k, v in g_ref.items() if v >= 1e-3 * med}
    return max(compare.leaf_gaps({k: norm(cand, k) for k in g_ref},
                                 {k: norm(ref, k) for k in g_ref}, moved))


def readings(cand: Dict, ref: Dict, params0: Dict[str, torch.Tensor], losses) -> Dict[str, float]:
    """The train cells' numbers (``common.train_checks``) and this cell's two."""
    out = C.train_checks(cand, ref, params0, losses)
    out["attn_sign_flips"] = sign_flips(cand, ref)
    out["change_gap_no_key_bias"] = change_gap_no_key_bias(cand, ref, params0)
    return out


# ---------------------------------------------------------------- the cell


class Cell:
    kind = "train"

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from tgtc_torch.models.stytrans import make_stytrans
        from tgtc_torch.models.transformer import TransformerConfig
        from tgtc_torch.train.transformer2d import (
            TransformerTrainConfig,
            init_transformer_train,
            make_transformer_train_step,
            trained_parameters,
        )

        self.config, self.seed, self.device = config, seed, torch.device(device)
        self.fetch_every = int(traffic["fetch_every"])
        self.batch, self.crop = int(config["batch_size"]), int(config["crop"])
        self.dropout_seed = T.sub_seed(seed, DROPOUT_KEY)
        gen = T.generator(device, seed, C.WEIGHTS_KEY)
        self.params0 = draw_weights(config, gen, device)
        self.content, self.style = pools(config, gen, device)
        self.gen = torch.Generator(device=device)

        mcfg = TransformerConfig(
            d_model=int(config["d_model"]), nhead=int(config["nhead"]),
            num_encoder_layers=int(config["num_encoder_layers"]),
            num_decoder_layers=int(config["num_decoder_layers"]),
            dim_feedforward=int(config["dim_feedforward"]), dropout=float(config["dropout"]),
            dtype=getattr(torch, config["dtype"]), attn_impl="flash")
        self.model = make_stytrans(mcfg, torch.Generator().manual_seed(0), device=device)
        self.model.load_state_dict(self.params0)
        tcfg = TransformerTrainConfig(
            lr=float(config["lr"]), lr_decay=float(config["lr_decay"]),
            batch_size=self.batch, patch=self.crop,
            style_weight=float(config["style_weight"]),
            content_weight=float(config["content_weight"]),
            id1_weight=float(config["id1_weight"]), id2_weight=float(config["id2_weight"]),
            warmup_iters=int(config["warmup_iters"]), max_iter=int(config["max_iter"]))
        self.state = init_transformer_train(self.model, tcfg)
        self.step_fn = make_transformer_train_step(self.model, tcfg)
        self.k = 0

        names, params = zip(*trained_parameters(self.model))
        losses = []
        for i in range(CHECK_STEPS):
            losses.append(self.step())
            if i == 0:
                grad0 = C.exp_avg_grads(self.state.optimizer, list(names), list(params))
        self.first = {"losses": torch.stack(losses).float().cpu().tolist(), "grad0": grad0,
                      "params": {n: p.detach().clone() for n, p in zip(names, params)}}

    def feed(self, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Step ``k``'s uint8 content and style batches ``[B, crop, crop, 3]``."""
        g = self.gen.manual_seed(T.sub_seed(self.seed, C.FEED_KEY, k))
        b, dev, span = self.batch, self.device, int(self.config["resize"]) - self.crop + 1
        ic = torch.randint(self.content.shape[0], (b,), generator=g, device=dev)
        is_ = torch.randint(self.style.shape[0], (b,), generator=g, device=dev)
        yx = torch.randint(span, (4, b), generator=g, device=dev)
        return (crops(self.content, ic, yx[0], yx[1], self.crop),
                crops(self.style, is_, yx[2], yx[3], self.crop))

    def step(self) -> torch.Tensor:
        content, style = self.feed(self.k)
        self.k += 1
        _, metrics = self.step_fn(self.state, content, style, seed=self.dropout_seed)
        return metrics["loss"]

    def work(self) -> Dict:
        cfg = self.config
        bh, sq, sk, d = attention_launch(cfg)
        n = attention_launches(cfg)
        drop = float(cfg["dropout"]) > 0.0
        return {"model_flop": model_flop(cfg), "kernels": {},
                "attention_s": {k: n * AW.bound_s(k, bh, sq, sk, d, drop) for k in ATTENTION}}

    def _batches(self) -> List[Dict[str, torch.Tensor]]:
        return [{"content": c.float() / 255.0, "style": s.float() / 255.0}
                for c, s in (self.feed(k) for k in range(CHECK_STEPS))]

    def check(self, losses, extra: bool = False) -> Dict[str, Dict[str, float]]:
        """The numbers of ``correct`` for the program (``"program"``) and,
        with ``extra``, for the control and the two faults put in its place.
        Frees the program's state first."""
        del self.state, self.step_fn, self.model
        C.free(self.device)
        batches = self._batches()
        trained0 = {k: v for k, v in self.params0.items() if R.trained(k)}
        train = lambda **kw: R.train(self.params0, self.config, batches, self.dropout_seed, **kw)
        with C.exact_f32():
            ref = train()
            out = {"program": readings(self.first, ref, trained0, losses)}
            if extra:
                for name, kw in (("control", {"precision": "fp8"}),
                                 ("half_batch", {"half_batch": True}),
                                 ("mask_seed", {"mask_seed": True})):
                    out[name] = readings(train(**kw), ref, trained0, [])
        return out


def build(config: Dict, traffic: Dict, seed: int, device) -> Cell:
    return Cell(config, traffic, seed, device)
