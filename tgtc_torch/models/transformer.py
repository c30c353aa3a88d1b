"""StyTr²-style transformer (content/style encoders + cross decoder) — port
of tgtc/models/transformer.py.

* :class:`PatchEmbed`: Conv 3→d_model, kernel = stride = 8, NHWC in and out.
* Two post-norm encoders (style ``encoder_s``, content ``encoder_c``) with
  the reference's double projection: without ``pos`` a fused ``qkv`` linear
  makes q, k and v, and v REPLACES the residual input; with ``pos`` a fused
  ``qk`` linear makes q = k and v is the raw input. ``pos`` only selects the
  branch, it is never added in the encoder.
* A decoder whose "self"-attention is a second cross-attention over the
  style memory, with content as query position, then ``decoder.norm``.

Module names are the reference's torch names (``encoder_s.layers.{i}.{qkv,
qk,self_attn,linear1,linear2,norm1,norm2}``, ``decoder.layers.{i}.{self_attn,
multihead_attn,linear1,linear2,norm1,norm2,norm3}``, ``decoder.norm``, and
``in_proj_weight``/``in_proj_bias``/``out_proj`` per attention), so a
reference ``transformer_iter_*.pth`` loads with ``load_state_dict``.

The numerics are flax's: a dense layer casts its input, weight and bias to
``cfg.dtype`` and returns ``cfg.dtype``; LayerNorm (epsilon 1e-6) computes
and returns f32; residual adds promote as JAX does (bf16 + bf16 stays bf16,
f32 + bf16 is f32). Attention: ``attn_impl="flash"`` calls K6, with
K7/K8 as its backward (:mod:`tgtc_torch.ops.kernels.flash_attention`; the
twins on CPU tensors),
``"xla"`` the eager einsum path, f32 logits for f32 and the bf16 branch of
the JAX package for bf16.

Dropout (``TransformerConfig.dropout``) acts where ``deterministic=False``,
as in the JAX package, drawn from the caller's ``torch.Generator``:

* the attention probabilities: on the flash path through K6/K7/K8's
  counter hash, with one int32 seed per site and call drawn on the
  device; on the "xla" path as a mask of the f32 probabilities, or for
  bf16 as the JAX package's uint8 draw with the keep probability quantized
  to 1/256;
* the residual and FFN dropouts (flax ``nn.Dropout``: keep with
  probability 1 − rate, scale the kept values by 1 / (1 − rate)).

JAX's random streams cannot be reproduced, so only the rate-0 path is
held to JAX value for value; the masks are held by their statistics.

``rows=(first, total)`` says that the batch is rows ``first…`` of a
``total``-row batch (one process's share under
:class:`tgtc_torch.parallel.DataGroup`): every dropout then draws the whole
batch's mask and keeps its rows, and the flash kernels hash the batch·head
index counted in the whole batch (``bh_offset``), so the rows see the masks
they have in the whole batch and the generator advances as it would there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tgtc_torch.ops.kernels.flash_attention import flash_attention

LN_EPS = 1e-6  # flax LayerNorm's default


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    d_model: int = 512
    nhead: int = 8
    num_encoder_layers: int = 3
    num_decoder_layers: int = 3
    dim_feedforward: int = 2048
    dropout: float = 0.1                # applied where deterministic=False
    dtype: torch.dtype = torch.float32  # compute type of the dense layers and convs
    attn_impl: str = "xla"              # "xla" (eager einsum) or "flash" (K6; K7/K8 backward)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, weight and bias cast to
    ``dtype``, result in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


Rows = Optional[Tuple[int, int]]  # (first row, rows of the whole batch)


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: tuple, rows: Rows) -> torch.Tensor:
    """``draw(shape)``, or under ``rows`` the whole batch's draw cut to this
    batch's rows."""
    if rows is None:
        return draw(tuple(shape))
    first, total = rows
    return draw((total, *shape[1:]))[first: first + shape[0]]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None,
            rows: Rows = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)`` in x's type;
    the identity at rate 0."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device), x.shape, rows)
    return torch.where(u < keep, x / keep, 0.0)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm()``: computed and returned in f32."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


class PatchEmbed(nn.Module):
    """Image ``[B, H, W, 3]`` → token map ``[B, H/8, W/8, embed_dim]`` in
    ``dtype`` (reference ``tctrans.py:13-33``; ``proj`` is OIHW)."""

    def __init__(self, embed_dim: int = 512, patch_size: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=self.patch_size)
        return y.permute(0, 2, 3, 1)


class MultiHeadAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` parameters (packed q/k/v input
    projection with bias, ``out_proj``) on ``[B, N, C]`` tensors."""

    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "xla", dropout: float = 0.0):
        super().__init__()
        if attn_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.d_model, self.nhead, self.dtype, self.attn_impl = d_model, nhead, dtype, attn_impl
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def _eager(self, qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, rate: float,
               generator: Optional[torch.Generator], rows: Rows = None) -> torch.Tensor:
        """The JAX package's einsum branches, one head at a time (the
        logits of a head at full C3 size take 573 MB in f32)."""
        d_head = qh.shape[-1]
        out = torch.empty(qh.shape, dtype=vh.dtype, device=vh.device)
        for h in range(qh.shape[1]):
            q, k, v = qh[:, h], kh[:, h], vh[:, h]
            if self.dtype == torch.bfloat16:
                s = torch.matmul(q, k.transpose(-1, -2))  # bf16 logits, as JAX's branch
                s = s * torch.tensor(1.0 / math.sqrt(d_head), dtype=torch.bfloat16)
                p = torch.softmax(s.float(), dim=-1).to(torch.bfloat16)
                if rate > 0.0:  # uint8 draws, keep quantized to 1/256 (JAX's bf16 branch)
                    thr = int(round(rate * 256.0))
                    bits = draw_rows(lambda s: torch.randint(
                        256, s, generator=generator, device=p.device, dtype=torch.uint8),
                        p.shape, rows)
                    scale = torch.tensor(1.0 / (1.0 - thr / 256.0), dtype=torch.bfloat16)
                    p = torch.where(bits >= thr, p * scale, 0.0)
            else:
                s = torch.matmul(q.float(), k.float().transpose(-1, -2))
                p = dropout(torch.softmax(s / torch.tensor(float(d_head)).sqrt(), dim=-1),
                            rate, generator, rows)
            out[:, h] = torch.matmul(p.to(v.dtype), v)
        return out

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                rows: Rows = None) -> torch.Tensor:
        d, dt = self.d_model, self.dtype
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        bsz, n, _ = q.shape
        d_head = d // self.nhead

        def split(x, i):  # [B, S, C] → [B, H, S, d_head], a view of [B, S, H, d_head]
            y = F.linear(x.to(dt), w[i * d: (i + 1) * d], b[i * d: (i + 1) * d])
            return y.view(x.shape[0], x.shape[1], self.nhead, d_head).transpose(1, 2)

        qh, kh, vh = split(q, 0), split(k, 1), split(v, 2)
        rate = 0.0 if deterministic else self.dropout
        if self.attn_impl == "flash":
            seed = None  # one int32 of the kernels' hash, drawn on the device: no host sync
            if rate > 0.0:
                seed = torch.randint(2 ** 31 - 1, (1,), generator=generator, device=qh.device,
                                     dtype=torch.int32)
            out = flash_attention(qh, kh, vh, sm_scale=1.0 / math.sqrt(d_head),
                                  dropout_rate=rate, dropout_seed=seed,
                                  bh_offset=rows[0] * self.nhead if rows else 0)
        else:
            out = self._eager(qh, kh, vh, rate, generator, rows)
        out = out.transpose(1, 2).reshape(bsz, n, d)
        return dense(out, self.out_proj, dt)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.qk = nn.Linear(d, 2 * d, bias=False)
        self.self_attn = MultiHeadAttention(d, cfg.nhead, cfg.dtype, cfg.attn_impl, cfg.dropout)
        self.linear1 = nn.Linear(d, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, d)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                rows: Rows = None) -> torch.Tensor:
        dt = self.cfg.dtype
        rate = 0.0 if deterministic else self.cfg.dropout
        if pos is None:  # v replaces src in the residual stream
            q, k, src = dense(src, self.qkv, dt).chunk(3, dim=-1)
        else:
            q, k = dense(src, self.qk, dt).chunk(2, dim=-1)
        a = self.self_attn(q, k, src, deterministic, generator, rows)
        src = layer_norm(src + dropout(a, rate, generator, rows), self.norm1)
        ff = dropout(torch.relu(dense(src, self.linear1, dt)), rate, generator, rows)
        ff = dense(ff, self.linear2, dt)
        return layer_norm(src + dropout(ff, rate, generator, rows), self.norm2)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.self_attn = MultiHeadAttention(d, cfg.nhead, cfg.dtype, cfg.attn_impl, cfg.dropout)
        self.multihead_attn = MultiHeadAttention(d, cfg.nhead, cfg.dtype, cfg.attn_impl,
                                                 cfg.dropout)
        self.linear1 = nn.Linear(d, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, d)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, pos: Optional[torch.Tensor] = None,
                query_pos: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, rows: Rows = None
                ) -> torch.Tensor:
        def with_pos(x, p):
            return x if p is None else x + p

        dt = self.cfg.dtype
        rate = 0.0 if deterministic else self.cfg.dropout
        # both attentions take k and v from the memory (the reference's
        # DETR-modified "self"-attention)
        for attn, norm in ((self.self_attn, self.norm1), (self.multihead_attn, self.norm2)):
            a = attn(with_pos(tgt, query_pos), with_pos(memory, pos), memory, deterministic,
                     generator, rows)
            tgt = layer_norm(tgt + dropout(a, rate, generator, rows), norm)
        ff = dropout(torch.relu(dense(tgt, self.linear1, dt)), rate, generator, rows)
        ff = dense(ff, self.linear2, dt)
        return layer_norm(tgt + dropout(ff, rate, generator, rows), self.norm3)


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_encoder_layers))

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None, rows: Rows = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, pos, deterministic, generator, rows)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers))
        self.norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def forward(self, tgt, memory, pos, query_pos, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, rows: Rows = None) -> torch.Tensor:
        for layer in self.layers:
            tgt = layer(tgt, memory, pos, query_pos, deterministic, generator, rows)
        return layer_norm(tgt, self.norm)


class StyleTransformer(nn.Module):
    """``(style [B, hs, ws, C], content [B, hc, wc, C])`` token maps →
    stylized token map ``[B, hc, wc, C]`` (f32): the output follows the
    content grid.

    ``pos_mode`` is the reference's positional pattern: ``"ics"`` (the
    stylize call: the style encoder takes the ``qkv`` branch, the content
    encoder the ``qk`` branch, the decoder adds the content tokens as query
    position), ``"icc"`` (pos on both encoders; the decoder adds the raw
    style tokens to the memory too) or ``"iss"`` (no pos anywhere).
    ``deterministic=False`` turns dropout on, drawn from ``generator``;
    ``rows`` as in the module's docstring."""

    def __init__(self, cfg: TransformerConfig = TransformerConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder_s = TransformerEncoder(cfg)
        self.encoder_c = TransformerEncoder(cfg)
        self.decoder = TransformerDecoder(cfg)

    def forward(self, style: torch.Tensor, content: torch.Tensor, pos_mode: str = "ics",
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                rows: Rows = None) -> torch.Tensor:
        b, hs, ws, c = style.shape
        _, hc, wc, _ = content.shape
        s = style.reshape(b, hs * ws, c)
        ct = content.reshape(b, hc * wc, c)
        if pos_mode == "ics":
            pos_s, pos_c = None, ct
        elif pos_mode == "icc":
            pos_s, pos_c = s, ct
        elif pos_mode == "iss":
            pos_s, pos_c = None, None
        else:
            raise ValueError(f"unknown pos_mode {pos_mode!r}")
        s = self.encoder_s(s, pos_s, deterministic, generator, rows)
        ct = self.encoder_c(ct, pos_c, deterministic, generator, rows)
        out = self.decoder(ct, s, pos_s, pos_c, deterministic, generator, rows)
        return out.reshape(b, hc, wc, c)
