#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tgtc_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA source under tgtc_torch/csrc (one nvcc per source, all
started together), then:

0. prints the card (name, power limit), the torch/CUDA versions, the
   kernel build time and ptxas's report of every kernel (registers,
   barriers, spills, wgmma notes) with the dynamic shared memory of K1, K2,
   K4 and K5;
1. kernels: runs K1/K2 (both on the Hopper dense-layer engine of
   tgtc_torch/csrc/trunk_sm90.cuh and its one trunk function; K2 is the
   engine's sigma-only kernel) on random full-width weights (He init, numpy
   seed 0, D8/W256) against their plain PyTorch twins (rgb <= 3e-2, sigma
   <= 2e-1, K2 sigma == K1 sigma, and second K1 and K2 launches, bit for
   bit) at P = 2,097,152 + 300 and at P = 1, 127, 129 and 132 x 128 + 17
   (cutting the engine's 128-point tiles and wrapping its persistent loop
   over 132 SMs), then at depth 6 with skip 2 (their run-time depth
   builds: twins, K2 == K1, repeats) at P = 129 and 132 x 128 + 17, and
   times each at the main path's shapes (K1 P = 16384 rays x 128 samples,
   K2 P = 16384 x 64) by CUDA events and by the profiler's device time,
   beside its bound (and the share of it reached), its twin and, for
   orientation only, the same layer chain as bf16 torch.addmm calls
   (events and device time);
2. main path: renders a fern-shaped 756x1008 NDC frame with
   FusedNerfRenderer(coarse_rgb=False), 64+64 samples, 16384-ray blocks,
   three times after a warm-up frame; launch counts are zeroed just before
   each frame and must be 47 each; the first 16,384 rays are held against the eager
   f32 render_rays (TF32 off) to 5e-2 in rgb and t_exp, except rays whose
   last-sample f32 sigma lies within the sigma tolerance of 0 (a sign flip
   there moves the ray's weight onto the 1e10 last interval), of which at
   most 0.1% may differ;
3. K3: the backward (a tile kernel on the Hopper engine that recomputes
   K1's forward with K1's own trunk_tile and rgb_tail, a weight-gradient
   kernel on wgmma, an in-order reduce) on the same He weights at P =
   262,144 + 300 with random cotangents (numpy seed 2) against its plain
   twin, per packed layer max|err| / max|twin| <= 2e-2 and cosine >= 0.999,
   a second launch bitwise equal and the recomputed rgb and sigma equal to
   K1's on the same inputs bit for bit; the tie also at P = 300; the same
   checks at depth 6 with skip 2 (its run-time depth build, seeded weights);
   timed at the training step's two shapes (P = 2048 x 64 and 2048 x 128)
   by CUDA events and by the profiler's device time (each launch apart)
   beside its bound, the bound counting its workspace (bytes a point
   printed), its twin and, for orientation only, the same backward as bf16
   autograd through the torch.addmm chain;
4. train (Phase A): writes a 4-view 756x1008 synthetic LLFF scene and runs
   train_nerf at fern width (D8/W256, L 10/4, viewdirs, batch 2048, 64+64
   samples, perturb, sigma noise 1.0): 20 warm-up steps, then 300 counted
   steps resumed from the warm-up's checkpoint, with exactly 2 K1 and 2 K3
   launches per step and no K2; the loss must stay finite and the mean of
   its last 20 steps fall below that of its first 20; prints the counted
   steps over the loop's time (the log windows' times summed). Then one
   fused step on the card with one batch and one set of draws: from the
   initial state against the eager f32 step (TF32 off; losses within 2e-2,
   every parameter's gradient cosine >= 0.99); from the trained state K3
   against its twin on the step's own weights and cotangents (the bounds
   of phase 3) and the step against the same step on the CPU (losses within
   2e-2, every gradient cosine >= 0.99), with each leaf's error against
   the eager f32 step beside the eager bf16 step's printed (compare_steps);
   and a checkpoint round trip (save, restore, render bitwise equal);
5. Phase B from the trained weights: writes a 2-view 756x1008 synthetic
   LLFF scene, loads it and runs dump_geometry; every artifact must exist
   and coor_map be finite;
6. style kernels: K4/K5 (on the same engine: K4 the trunk and the style
   layers, K5 the sigma-only kernel on K4's packing) on random fern-width
   weights (the K1/K2 trunk, He style MLPs, numpy seed 0) with per-point
   latents against their twins (rgb <= 3e-2, sigma <= 2e-1), with sigmas
   bitwise equal (K5 and K4, K5 and K2 on the same trunk, two K4 launches,
   two K5 launches), at P = 2,097,152 + 300 and at phase 1's tile-cutting
   P, and with 128 samples per ray at 128 and 133 x 128 points; then each
   held against its twin again (same bounds) on the stylized frame's
   arguments (K4 P = 16384 rays x 128 samples with per-ray latents,
   distinct random rows, K5 P = 16384 x 64) and timed there as in phase 1;
7. Phase F from the trained trunks, with seeded style MLPs and a 1-style
   latent table: stylized 756x1008 NDC frames at the scene's spiral poses
   through FusedStyleRenderer(coarse_rgb=False), 64+64 samples, 16384-ray
   blocks, three timed after a warm-up frame, each with exactly 47 K5 and
   47 K4 launches and no K1/K2; the first 16,384 rays held against the
   eager f32 make_stylized_render_fn with the same jitter (phase 2's bounds
   and exemption); then render_stylized_frames_fused over three views with
   full-size depth PNGs: every PNG at 756x1008, and a second call renders
   nothing;
8. K6 (flash-attention forward): bf16 q/k/v (numpy seed 4) against its
   plain twin at the C3 shape (8 heads, Sq = Sk = 11,970, D 64, scale
   0.125), at 11,970 x 4,096, at a ragged 300 x 180 with 16 heads and at
   shapes that cut its 128-row blocks and 128-key tiles (4 heads 200 x 130,
   2 heads 1,000 x 1,030, 4 heads 300 x 1 and 300 x 65; these at dropout 0
   and 0.25) (max|o - twin| <= 1e-2 max|twin| and <= 3e-2, lse <= 1e-3),
   two launches bitwise equal; a mask probe with
   dropout 0.1, seed 7 (q = 0, Sk = 256, row j of v = 2^(j // 64)
   e_(j mod 64), so that each output element encodes four keep bits) whose
   decoded mask equals the twin's hash mask bit for bit over 16 heads and
   1,000 rows; K6 timed at both large shapes by CUDA events and by the
   profiler's device time, beside its four-floor bound (as phase 10's), its
   twin and the library call (scaled_dot_product_attention with scale 1 on
   the prescaled q, by events and device time; its kernels are printed),
   with K6 / SDPA by device time;
9. Phase C3: a full-width StyTrans (d_model 512, 8 heads, 3+3 layers, FFN
   2048, bf16, attn_impl="flash", torch seed 21) stylizes phase 5's
   rgb_00000.png (756x1008, padded to 760x1008: 11,970 tokens) with a seeded
   512x512 style resized to the content size: three frames timed after a
   warm-up, each with exactly 12 K6 launches; the same frame with the
   attention through the twin on the card (only K6 differs) within 5e-2 of
   its max, on the image and hs; the f32 eager path (TF32 off) read against
   it, not held; then stylize_all with one style over 20 views (fern's
   count: phase 5's views repeated under new names), timed per view:
   every NNN.jpg at 756x1008, stylized_data.npz complete with finite
   style_features [1, 1024], 12 K6 launches a view;
10. K7/K8 (flash-attention backward): bf16 q/k/v/dO (numpy seed 5), lse
   from K6 on the same inputs, against their plain twins at the C1 shape
   (8 x 8 heads, Sq = Sk = 1,024, D 64, scale 0.125) at dropout 0 and 0.1,
   at 11,970 x 4,096, at a ragged 300 x 180 with 16 heads and at 200 x 130
   and 1,000 x 1,030 (cutting the kernels' 128-row blocks) at dropout 0 and
   0.25: each of dq, dk, dv within 1e-2 max|twin|, two launches bitwise
   equal, and at 200 x 130 the [B, S, H, D] inputs seen through a
   transpose bitwise equal to the contiguous case; K6 at the C1 shape with
   dropout 0.1 against its twin (phase 8's bounds); K6, K7 and K8 timed at
   the C1 shape (dropout 0.1, the C1 path's, and 0) and K7/K8 at 11,970 x
   4,096, by CUDA events and by the profiler's device time, beside their
   bounds (flash_bound_ms: the largest of the tensor-core, HBM, SFU and,
   under dropout, INT32 floors at the card's maximum SM clock, each kernel
   with its own products and I/O), their twins and the
   library calls: scaled_dot_product_attention's forward and its backward
   at dropout 0 on the same tensors (torch.autograd.grad of one saved
   forward, the device time of its kernels and memsets from the profiler;
   the kernels are printed), with the ratios;
11. Phase C1 at full width (d_model 512, 8 heads, 3+3 layers, FFN 2048,
   dropout 0.1, bf16, flash attention, torch seed 21, random VGG and
   decoder): tools/train2d.main(["--task", "transformer", ...]) on phase
   5's renders as content and 8 seeded 512x512 style PNGs, batch 8, 256x256
   crops: 10 warm-up steps, then 100 counted steps resumed from the warm-
   up's checkpoint, logged every 10 steps: 36 K7 and 36 K8 launches a step
   and 36 K6 (plus 12 for each collage), finite losses, the collage PNGs
   and the checkpoint written, C1 steps/s over the counted loop's log
   windows; on one fixed batch and generator seed, the step's losses and
   gradients against the same step with the attention through the twins on
   the card (36 K6, K7 and K8 launches in the step; loss within 1e-2
   relative, the cosine of all trained leaves' gradients together >= 0.999,
   each leaf's error within 0.1 of its gradient norm or of the median
   leaf's, whichever is larger, and each row block of the attention
   projections that only dq, dk or dv feeds within 0.5 of its own
   gradient norm); at dropout 0 the same against the eager f32 "xla" step
   (TF32 off; cosine 0.99, the worst leaf's error within 1.3x the eager
   bf16 "xla" step's + 5e-3); 30 steps on one fixed batch lower the loss;
12. Phase C2 from phase 11's trained state (the same full-width StyTrans,
   dropout 0.1, bf16, flash): train.temporal.run_temporal_finetune at
   TemporalTrainConfig's defaults (batch 4 of 256x256 patches, 100 steps,
   temporal weight 3500, splat radius 1.5, threshold 5e-2) on phase 5's
   two renders, its NDC coor maps and poses, and phase 11's 8 styles at
   512x512, logged every 10 steps: 36 K6 launches a step plus 36 for the
   end-of-C2 debug pass, no K7 or K8; only the decoder moves; the five
   losses finite and loss_t > 0; the debug PNGs and style_image.png
   written; C2 steps/s over steps 11-100 (the log windows' times, the log's
   fetch the sync). On the first step's batch: the splat of its point cloud
   (65,536 points into 4 views of 756x1008) on the card against the CPU
   with one w2c (hit masks differ at <= 0.1% of the pixels, warped
   features equal where the winners are, a second card splat bitwise
   equal) and through rasterize_warp with each device's own pose inversion
   (masks within the same 0.1%); the patch splatted into its own camera
   covers > 95% of the patch (tests/test_rasterize.py's bound); one step
   (36 K6 launches, no K7/K8) against the same step with the twin's
   attention on the card (loss within 1e-2 relative, decoder gradient
   cosine >= 0.999), and whether the same step repeats bit for bit (read,
   not held: cuDNN's convolution backward does not promise a fixed order);
13. Phase C3 after C2: stylize_all with phase 12's model over phase 5's two
   views and all 8 styles: every style_XX/NNN.jpg at 756x1008,
   style_features [8, 1024] finite, 12 K6 launches a view and style,
   seconds a view and style;
14. Phase D: tools/train2d.main(["--task", "vae", ...]) on phase 11's
   styles at the pipeline's Phase-D settings (VaeConfig 1024 -> 512 x3 ->
   32, lr 1e-3, batch 8, 256x256 crops of the styles resized to 512, 2,000
   steps; TF32 at PyTorch's default), resumed after 20 warm-up steps,
   logged every step (one fetch a step): the loss finite, the mean of the
   last 100 steps below the first 100's, the checkpoint written, VAE
   steps/s over the resumed loop; one VAE step on the card against the same
   step on the CPU (same features and eps, TF32 off: loss within 1e-5
   relative, every gradient cosine >= 0.9999); the latent table seeded by
   train.vae_trainer.seed_latents_from_features from phase 13's
   style_features with one frame per phase 5 view: finite, [8, 2, 32],
   equal to eps exp(logvar / 2) + mu for the eps drawn; a 756x1008 frame of
   style 0 from the table through phase 7's FusedStyleRenderer settings,
   trunks and style MLPs (47 K4 and 47 K5 launches, no K1/K2), its first
   16,384 rays held to the eager f32 render as in phase 7;
15. prints the kernels line (JSON, K1-K8), then the result line.

Any failed check raises, so the script exits non-zero and prints no result.
It needs CUDA and the rest of the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W, FOCAL = 756, 1008, 815.0  # fern at factor 4 (configs/fern.txt)
BLOCK = 1 << 14
NC = NF = 64
FRAMES = 3  # timed frames of the main path, each with its own launch count
P_K1, P_K2 = BLOCK * (NC + NF), BLOCK * NC
RAGGED = 300
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# Per SM and clock on sm_90 (CUDA C++ Programming Guide, arithmetic
# instruction throughput): ex2 on the SFUs 16, 32-bit integer multiply,
# shift, logic and compare 64.
SMS, SFU_PER_CLK, INT32_PER_CLK = 132, 16, 64
# keep_hash per element of S (csrc/flash_attention.cu): one 3-input xor of
# the hoisted row and column terms and the salt, three shift-xor pairs, two
# multiplies, one compare.
HASH_INT_OPS = 1 + 3 * 2 + 2 + 1
# K3: recompute (K1's 593,408 MACs) + weight gradients (593,408) + input
# gradients of every layer but the first (7 x 65,536 trunk, 65,536
# base_remap, 256 sigma, 256 x 128 rgb_0, 3 x 128 rgb_1 = 557,696), x 2
# K4: K2's trunk and sigma (982,528) + base_remap 131,072 + concat MLP
# 670,720 + style MLP 1,113,088 + rgb_out 1,536; K5 is K2
FLOP_PER_POINT = {"K1": 1_186_816, "K2": 982_528, "K3": 3_489_024, "K4": 2_898_944,
                  "K5": 982_528}
TOL_RGB, TOL_SIGMA, TOL_RENDER = 3e-2, 2e-1, 5e-2
TOL_K3_REL, TOL_K3_COS = 2e-2, 0.999
BATCH = 2048
P_K3 = {"coarse": BATCH * NC, "fine": BATCH * (NC + NF)}
WARM_STEPS, TRAIN_STEPS, I_PRINT = 20, 300, 50
TOL_STEP_LOSS, TOL_STEP_COS = 2e-2, 0.99
LATENT, LATENT_FRAMES, F_VIEWS, F_SEED = 32, 20, 3, 10  # Phase F: fern's 20 training views
C3_TOKENS, C3_HEADS, D_HEAD = 95 * 126, 8, 64  # 756x1008 padded to 760x1008, 8x8 patches
K6_SCALE, TOL_K6_O, TOL_K6_LSE, TOL_C3 = 0.125, 3e-2, 1e-3, 5e-2
TOL_K6_O_REL = 1e-2  # of max|twin|: a typical |o| at C3 is ~0.012, under TOL_K6_O
C3_VIEWS = 20  # fern's view count, for the bulk stylize_all timing
C3_SITES = 12  # attention sites of one StyleTransformer call: 3 + 3 encoder, 2 x 3 decoder
C1_BATCH, C1_TOKENS, C1_RATE = 8, 32 * 32, 0.1  # 256x256 crops, 8x8 patches; dropout
C1_SITES = 3 * C3_SITES  # a C1 step's transformer calls: Ics, Icc, Iss
C1_WARM, C1_STEPS, C1_PRINT, C1_OVERFIT = 10, 100, 10, 30
TOL_K78_REL = 1e-2  # of max|twin|, for each of dq, dk, dv
# The C1 step's gradient witnesses: the loss, the cosine of all trained
# leaves' gradients together, and each leaf's error relative to its own
# gradient norm or the median leaf's, whichever is larger. A per-leaf cosine
# is no bound: the content encoder's qk weights see only logit gradients,
# far below the median leaf's, at the bf16 noise floor (cosine 0.963
# between the kernel and the twin-attention step at step 110, on an H100).
# Against the eager f32 step, the eager bf16 step is the yardstick (the form
# of tests/test_fused_grad.py): both bf16 steps are ~0.2 of a leaf's norm off
# f32 on the style encoder's qkv weights (H100 80GB HBM3, 700 W).
# The row blocks of the attention projections that only K7's dq or K8's dk
# or dv feeds are also held each to its own norm: the lowest leaf cosine
# read so far, 0.963, is a relative error of ~0.27, while a block whose dq,
# dk or dv is zeroed reads 1, and one scaled by 8 reads 7.
TOL_C1_LOSS, TOL_C1_COS, TOL_C1_LEAF = 1e-2, 0.999, 0.1      # vs the twin-attention step
TOL_C1_ATTN_LEAF = 0.5
TOL_C1_F32_COS, TOL_C1_F32_RATIO, TOL_C1_F32_ADD = 0.99, 1.3, 5e-3  # vs the eager f32 step
C2_SEED, C2_WARM, C2_PRINT = 21, 10, 10  # steps 11-100 counted, over log windows of 10
TOL_SPLAT_MASK, TOL_OWN_VIEW = 1e-3, 0.95  # tests/test_rasterize.py's coverage bound
D_WARM, D_STEPS = 20, 2000  # the pipeline's vae_iters
TOL_VAE_LOSS, TOL_VAE_COS = 1e-5, 0.9999


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def he_dense(rng: np.random.Generator, nin: int, nout: int):
    """A flax Dense layer with a He-normal kernel and a zero bias."""
    return {"kernel": rng.standard_normal((nin, nout), np.float32)
            * np.float32((2.0 / nin) ** 0.5),
            "bias": np.zeros((nout,), np.float32)}


def he_params(rng: np.random.Generator, depth=8, width=256, fc=10, fd=4, skip=4):
    """Random D8/W256 flax-layout params, He-normal kernels, zero biases."""
    in_pts, in_dir = 3 * (1 + 2 * fc), 3 * (1 + 2 * fd)

    def dense(nin, nout):
        return he_dense(rng, nin, nout)

    layers = {"base_0": dense(in_pts, width)}
    for i in range(depth - 1):
        layers[f"base_{i + 1}"] = dense(width + in_pts if i == skip else width, width)
    layers["sigma"] = dense(width, 1)
    layers["base_remap"] = dense(width, 256)
    layers["rgb_0"] = dense(256 + in_dir, width // 2)
    layers["rgb_1"] = dense(width // 2, 3)
    return {"params": layers}


def he_style_params(rng: np.random.Generator, style_d=8, width=256, latent=LATENT,
                    embed=63, skip=4):
    """Random flax-layout style MLPs at fern width (``concat``: 5 layers,
    ``style``: 7 + rgb_out), He-normal kernels, zero biases."""
    concat, style = {}, {}
    for i in range(min(style_d - 1, skip + 1)):
        nin = (embed if i == 0 else width) + latent + (embed if i == skip else 0)
        concat[f"layer_{i}"] = he_dense(rng, nin, width)
    for i in range(style_d - 1):
        nin = (256 + width + embed if i == 0 else width) + latent + (embed if i == skip else 0)
        style[f"layer_{i}"] = he_dense(rng, nin, width)
    style["rgb_out"] = he_dense(rng, width + latent, 3)
    return {"concat": {"params": concat}, "style": {"params": style}}


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Point counts that cut the Hopper engine's 128-point tiles (K1, K2, K4, K5:
# csrc/trunk_sm90.cuh) and wrap its persistent loop (133 tiles on 132 SMs).
ENGINE_TILE = 128
ENGINE_P = (1, ENGINE_TILE - 1, ENGINE_TILE + 1, 132 * ENGINE_TILE + 17)
# What each kernel on the engine runs (the kernels line's "design").
ENGINE_DESIGN = {
    "K1": "Hopper engine csrc/trunk_sm90.cuh: trunk_tile, then base_remap, rgb_0 and rgb",
    "K2": "Hopper engine csrc/trunk_sm90.cuh: sigma_kernel (trunk_tile and the sigma head)",
    "K4": "Hopper engine csrc/trunk_sm90.cuh: trunk_tile, then base_remap, concat and style",
    "K5": "Hopper engine csrc/trunk_sm90.cuh: sigma_kernel on K4's packing",
    "K3": "transposed weights; a tile kernel on the Hopper engine csrc/trunk_sm90.cuh "
          "(trunk_tile and rgb_tail, K1's forward, then the input-gradient products); a "
          "split-K weight-gradient kernel on wgmma; an in-order reduce",
}


def timed(fn, iters: int):
    """``fn``'s time by CUDA events and by the profiler's device time (ms)."""
    ms = cuda_ms(fn, iters)
    dev, _ = device_ms(fn, max(2, iters // 2))
    return ms, dev


def bound_ms(name: str, p: int, packed, io=None) -> float:
    """max(operations / bf16 peak, bytes / HBM rate); ``io`` defaults to
    pts(+dirs) in and sigma(+rgb) out, f32."""
    flops = FLOP_PER_POINT[name] * p
    io = (10 if name == "K1" else 4) * 4 * p if io is None else io
    weights = packed.w.numel() * 2 + packed.b.numel() * 4
    return 1e3 * max(flops / PEAK_BF16_FLOPS, (io + weights) / PEAK_BYTES)


def matmul_chain(packed, e_c, e_d, rgb_head: bool):
    """The kernel's layer chain as bf16 torch.addmm + relu_ calls (encoding
    precomputed; heads included). Orientation only."""
    bf = torch.bfloat16
    d = packed.depth
    wt = [packed.weight(i).t() for i in range(len(packed.layers()))]
    bs = [packed.bias(i).to(bf) for i in range(len(packed.layers()))]

    def run():
        h = torch.addmm(bs[0], e_c, wt[0]).relu_()
        for i in range(1, d):
            inp = torch.cat([e_c, h], 1) if i == packed.skip + 1 else h
            h = torch.addmm(bs[i], inp, wt[i]).relu_()
        sigma = torch.addmm(bs[d + 1], h, wt[d + 1])
        if rgb_head:
            br = torch.addmm(bs[d], h, wt[d]).relu_()
            rf = torch.addmm(bs[d + 2], torch.cat([br, e_d], 1), wt[d + 2]).relu_()
            return torch.addmm(bs[d + 3], rf, wt[d + 3]).sigmoid_(), sigma
        return sigma

    return run


def style_matmul_chain(packed, e_c, lat):
    """K4's layer chain as bf16 torch.addmm calls, the rank-1 latent term
    as addcmul_ (encoding and per-point bf16 latents precomputed).
    Orientation only."""
    bf = torch.bfloat16
    n, d, skip = len(packed.layers()), packed.depth, packed.skip
    wt = [packed.weight(i).t() for i in range(n)]
    bs = [packed.bias(i).to(bf) for i in range(n)]
    ls = [packed.lsum(i).to(bf)[None] for i in range(packed.style_d)]
    lmean = lat.float().mean(-1, keepdim=True).to(bf)

    def run():
        h = torch.addmm(bs[0], e_c, wt[0]).relu_()
        for i in range(1, d):
            inp = torch.cat([e_c, h], 1) if i == skip + 1 else h
            h = torch.addmm(bs[i], inp, wt[i]).relu_()
        sigma = torch.addmm(bs[d + 1], h, wt[d + 1])
        br = torch.addmm(bs[d], h, wt[d]).relu_()
        cf = e_c
        for i in range(packed.n_concat):
            j = packed.concat_index(i)
            cf = torch.addmm(bs[j], torch.cat([cf, lat] + ([e_c] if i == skip else []), 1),
                             wt[j]).relu_()
        s = torch.cat([br, cf, e_c], 1)
        for i in range(packed.style_d):
            j = packed.style_index(i)
            s = torch.addmm(bs[j], torch.cat([s, e_c], 1) if i == skip else s,
                            wt[j]).addcmul_(lmean, ls[i])
            s = s.relu_() if i < packed.style_d - 1 else s.sigmoid_()
        return s, sigma

    return run


def phase_kernels(ks, sd_c):
    """Twin comparison at P = 2^21 + 300 and at the engine's tile-cutting P,
    timings at the main path's shapes."""
    packed = ks.pack_nerf_params(sd_c, device="cuda")
    rng = np.random.default_rng(1)
    p = P_K1 + RAGGED
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, p)).astype(np.float32)).cuda()
    dirs = torch.from_numpy(rng.standard_normal((3, p)).astype(np.float32)).cuda()
    err = {"K1": (0.0, 0.0), "K2": (0.0, 0.0)}
    for n in ENGINE_P + (p,):
        pt, dr = pts[:, :n].contiguous(), dirs[:, :n].contiguous()
        rgb, sigma = ks.fused_nerf_apply_t(packed, pt, dr)
        rgb2, sigma2 = ks.fused_nerf_apply_t(packed, pt, dr)
        sigma_k2 = ks.fused_nerf_sigma_apply_t(packed, pt)
        sigma_k2b = ks.fused_nerf_sigma_apply_t(packed, pt)
        torch.cuda.synchronize()
        rgb_p, sigma_p = ks.fused_nerf_apply_t_plain(packed, pt, dr)
        sigma_k2_p = ks.fused_nerf_sigma_apply_t_plain(packed, pt)
        e1 = (float((rgb - rgb_p).abs().max()), float((sigma - sigma_p).abs().max()))
        e2 = float((sigma_k2 - sigma_k2_p).abs().max())
        same = {"K1 = K1": torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2),
                "K2 = K1": torch.equal(sigma, sigma_k2),
                "K2 = K2": torch.equal(sigma_k2, sigma_k2b)}
        print(f"[kernels] P={n}: K1 max|rgb err| {e1[0]:.3e} max|sigma err| {e1[1]:.3e}; K2 "
              f"max|sigma err| {e2:.3e}; |sigma| max {float(sigma_p.abs().max()):.3e}; bitwise: "
              + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)
        check(bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all()),
              "K1 output not finite")
        check(e1[0] <= TOL_RGB and e1[1] <= TOL_SIGMA, f"K1 disagrees with its twin at P={n}")
        check(e2 <= TOL_SIGMA, f"K2 disagrees with its twin at P={n}")
        check(all(same.values()), f"sigma or a repeat not bitwise equal at P={n}: {same}")
        err = {"K1": tuple(max(a, b) for a, b in zip(err["K1"], e1)),
               "K2": (0.0, max(err["K2"][1], e2))}
        del rgb, sigma, rgb2, sigma2, sigma_k2, sigma_k2b, rgb_p, sigma_p, sigma_k2_p
    phase_runtime_depth(ks, pts, dirs)

    rows = []
    for name, fn, twin, n in (("K1", ks.fused_nerf_apply_t, ks.fused_nerf_apply_t_plain, P_K1),
                              ("K2", ks.fused_nerf_sigma_apply_t,
                               ks.fused_nerf_sigma_apply_t_plain, P_K2)):
        args = (packed, pts[:, :n].contiguous()) + ((dirs[:, :n].contiguous(),) if name == "K1" else ())
        ms, dev = timed(lambda: fn(*args), 10)
        plain_ms = cuda_ms(lambda: twin(*args), 3)
        e_c = ks._encode_plain(args[1].T, 10, packed.k_coor).to(torch.bfloat16)
        e_d = (ks._encode_plain(args[2].T, 4, packed.k_dir).to(torch.bfloat16)
               if name == "K1" else None)
        chain_ms, chain_dev = timed(matmul_chain(packed, e_c, e_d, name == "K1"), 10)
        del e_c, e_d
        b = bound_ms(name, n, packed)
        print(f"[kernels] {name} P={n}: kernel {ms:.3f} ms ev, {dev:.3f} ms dev, bound {b:.3f} ms "
              f"(operations), {100 * b / dev:.2f}% of the bound by device time; plain twin "
              f"{plain_ms:.3f} ms; orientation only: bf16 torch.addmm chain {chain_ms:.3f} ms ev, "
              f"{chain_dev:.3f} ms dev (kernel / chain {dev / chain_dev:.3f})", flush=True)
        rows.append({
            "name": name, "route": "cuda", "source": "tgtc_torch/csrc/nerf_mlp.cu",
            "replaces": ("tgtc/ops/pallas/nerf_mlp.py:359" if name == "K1"
                         else "tgtc/ops/pallas/nerf_mlp.py:316"),
            "wrapper": ("tgtc_torch.ops.kernels.nerf_mlp." +
                        ("fused_nerf_apply_t" if name == "K1" else "fused_nerf_sigma_apply_t")),
            "design": ENGINE_DESIGN[name],
            "P": n, "max_abs_err": max(err[name]), "max_err": max(err[name]),
            "max_abs_err_rgb": err[name][0] if name == "K1" else None,
            "max_abs_err_sigma": err[name][1],
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": "operations", "bound_share": b / dev, "library_ms": None,
            "matmul_chain_ms": chain_ms, "matmul_chain_device_ms": chain_dev,
        })
    return rows


def phase_runtime_depth(ks, pts, dirs, depth=6, skip=2):
    """K1 and K2 at a depth and skip other than the configs' (their run-time
    depth builds, off the main path): each against its twin, K2 = K1 and
    both repeats bit for bit, at a tile cut and at the persistent wrap."""
    from tgtc_torch.convert import nerf_state_dict_from_flax

    sd = nerf_state_dict_from_flax(he_params(np.random.default_rng(6), depth=depth, skip=skip))
    packed = ks.pack_nerf_params(sd, depth=depth, skip=skip, device="cuda")
    for n in (ENGINE_TILE + 1, 132 * ENGINE_TILE + 17):
        pt, dr = pts[:, :n].contiguous(), dirs[:, :n].contiguous()
        rgb, sigma = ks.fused_nerf_apply_t(packed, pt, dr)
        rgb2, sigma2 = ks.fused_nerf_apply_t(packed, pt, dr)
        sigma_k2 = ks.fused_nerf_sigma_apply_t(packed, pt)
        sigma_k2b = ks.fused_nerf_sigma_apply_t(packed, pt)
        torch.cuda.synchronize()
        rgb_p, sigma_p = ks.fused_nerf_apply_t_plain(packed, pt, dr)
        e1 = (float((rgb - rgb_p).abs().max()), float((sigma - sigma_p).abs().max()))
        e2 = float((sigma_k2 - ks.fused_nerf_sigma_apply_t_plain(packed, pt)).abs().max())
        same = {"K1 = K1": torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2),
                "K2 = K1": torch.equal(sigma, sigma_k2),
                "K2 = K2": torch.equal(sigma_k2, sigma_k2b)}
        print(f"[kernels] depth {depth} skip {skip} P={n}: K1 max|rgb err| {e1[0]:.3e} "
              f"max|sigma err| {e1[1]:.3e}; K2 max|sigma err| {e2:.3e}; bitwise: "
              + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)
        check(e1[0] <= TOL_RGB and e1[1] <= TOL_SIGMA and e2 <= TOL_SIGMA,
              f"K1 or K2 at depth {depth} disagrees with its twin at P={n}")
        check(all(same.values()), f"depth {depth}: sigma or a repeat not bitwise equal at "
                                  f"P={n}: {same}")


def fern_camera():
    intr = np.array([[FOCAL, 0, 0.5 * W], [0, FOCAL, 0.5 * H], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)[None, :3, :4]
    return intr, pose


def phase_main_path(ks, sd_c, sd_f):
    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP, nerf_apply
    from tgtc_torch.render.fast import FusedNerfRenderer
    from tgtc_torch.render.volume import RenderSettings, render_rays

    settings = RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    renderer = FusedNerfRenderer.from_params(sd_c, sd_f, settings, coarse_rgb=False,
                                             device="cuda")
    intr, pose = fern_camera()
    ro, rd = rays_for_poses(H, W, intr, pose, use_ndc=True, device="cuda")
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    n = ro.shape[0]

    renderer.render_image(ro, rd, block=BLOCK)  # warm-up frame
    torch.cuda.synchronize()
    blocks = math.ceil(n / BLOCK)
    times = []
    for _ in range(FRAMES):
        ks.fused_nerf_apply_t.launches = 0
        ks.fused_nerf_sigma_apply_t.launches = 0
        t0 = time.perf_counter()
        out = renderer.render_image(ro, rd, block=BLOCK)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {"K1": ks.fused_nerf_apply_t.launches,
                    "K2": ks.fused_nerf_sigma_apply_t.launches}
        check(launches == {"K1": blocks, "K2": blocks},
              f"launch counts {launches} != {blocks}")
    dt = float(np.median(times))
    print(f"[main] frame {H}x{W} ({n} rays, {NC}+{NF} samples, block {BLOCK}), "
          f"{FRAMES} frames after a warm-up: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median {dt * 1e3:.1f} ms, "
          f"{n / dt:.1f} rays/s; launches per frame K1 {launches['K1']} "
          f"K2 {launches['K2']} (expect {blocks} each)", flush=True)
    check(out["rgb"].shape == (n, 3) and out["t_exp"].shape == (n,), "frame output shape")
    check(bool(torch.isfinite(out["rgb"]).all() and torch.isfinite(out["t_exp"]).all()),
          "frame output not finite")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = NerfConfig(compute_dtype=torch.float32)
    models = []
    for sd in (sd_c, sd_f):
        m = NerfMLP(cfg)
        m.load_state_dict(sd)
        models.append(m.cuda())
    bo, bd = ro[:BLOCK], rd[:BLOCK]
    with torch.no_grad():
        ref = render_rays(models[0], models[1], bo, bd, settings)
        last = nerf_apply(models[1], bo + ref["ts_fine"][:, -1:] * bd, bd)["sigma"]
    err = torch.maximum((out["rgb"][:BLOCK] - ref["fine"].rgb).abs().amax(-1),
                        (out["t_exp"][:BLOCK] - ref["fine"].t_exp).abs())
    bad = err > TOL_RENDER
    # The last sample's interval is 1e10, so its alpha jumps from 0 to 1 as
    # its sigma crosses 0: where the f32 sigma sits within bf16 error of 0
    # the two renders may legitimately put that ray's weight in different
    # places. Only such rays may differ, and only a few.
    flip = last.abs() <= TOL_SIGMA
    worst = float(err[~flip].max()) if bool((~flip).any()) else 0.0
    print(f"[main] first {BLOCK} rays vs eager f32 render_rays: max|err| over rgb "
          f"and t_exp {float(err.max()):.3e}; {int(bad.sum())} rays above {TOL_RENDER}, "
          f"all with |last-sample sigma| <= {TOL_SIGMA}: {bool((flip | ~bad).all())}; "
          f"max|err| over the other {int((~flip).sum())} rays {worst:.3e}", flush=True)
    check(bool((flip | ~bad).all()), "fused frame disagrees with the eager render")
    check(int(bad.sum()) <= BLOCK // 1000, "too many rays differ from the eager render")
    return renderer, launches, n / dt


def write_scene(root: str, n: int = 2) -> str:
    """The recipe of tests/synthetic_scene.py at 756x1008: forward-facing
    cameras, colored gradients, poses stored with the inverse LLFF axis fix."""
    from PIL import Image

    imgdir = os.path.join(root, "images")
    os.makedirs(imgdir, exist_ok=True)
    poses = []
    for k in range(n):
        c2w = np.eye(4)[:3]
        c2w[:, 3] = [0.02 * (k - n / 2), 0.01 * (k % 3), 4.0 + 0.03 * k]
        poses.append(np.concatenate([c2w, np.array([[H], [W], [FOCAL]])], axis=1))
        img = np.zeros((H, W, 3), np.uint8)
        img[..., 0] = np.linspace(0, 255, W, dtype=np.uint8)[None, :]
        img[..., 1] = np.linspace(0, 255, H, dtype=np.uint8)[:, None]
        img[..., 2] = (k * 30) % 255
        Image.fromarray(img).save(os.path.join(imgdir, f"img_{k:03d}.png"))
    poses = np.stack(poses)
    poses_disk = np.concatenate([-poses[:, :, 1:2], poses[:, :, 0:1], poses[:, :, 2:]], axis=2)
    bds = np.stack([np.full(n, 2.0), np.full(n, 8.0)], axis=1)
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([poses_disk.reshape(n, 15), bds], axis=1))
    return root


def addmm_backward(packed, e_c, e_d, g_rgb, g_sigma):
    """The same backward as bf16 autograd through matmul_chain's torch.addmm
    calls (weights and biases as leaves; encoding precomputed). Returns a
    closure that runs the backward only. Orientation only."""
    bf = torch.bfloat16
    n = len(packed.layers())
    wt = [packed.weight(i).t().detach().clone().requires_grad_() for i in range(n)]
    bs = [packed.bias(i).to(bf).detach().clone().requires_grad_() for i in range(n)]
    d = packed.depth
    h = torch.addmm(bs[0], e_c, wt[0]).relu()
    for i in range(1, d):
        inp = torch.cat([e_c, h], 1) if i == packed.skip + 1 else h
        h = torch.addmm(bs[i], inp, wt[i]).relu()
    sigma = torch.addmm(bs[d + 1], h, wt[d + 1])
    br = torch.addmm(bs[d], h, wt[d]).relu()
    rf = torch.addmm(bs[d + 2], torch.cat([br, e_d], 1), wt[d + 2]).relu()
    rgb = torch.addmm(bs[d + 3], rf, wt[d + 3]).sigmoid()
    outs, cots = (rgb, sigma), (g_rgb.T.to(bf).contiguous(), g_sigma.T.to(bf).contiguous())

    def run():
        return torch.autograd.grad(outs, wt + bs, cots, retain_graph=True)

    return run


def layer_errors(packed, dw, db, tw, tb):
    """Per packed layer: max|err| / max|twin| and cosine, and the max abs
    error over every gradient value."""
    out = []
    for i, (n, k) in enumerate(packed.layers()):
        a = dw[packed.offsets[i]: packed.offsets[i] + n * k].double()
        b = tw[packed.offsets[i]: packed.offsets[i] + n * k].double()
        out.append((float((a - b).abs().max() / b.abs().max()),
                    float((a * b).sum() / (a.norm() * b.norm()))))
    out.append((float((db - tb).abs().max() / tb.abs().max()),
                float((db.double() * tb.double()).sum() / (db.double().norm() * tb.double().norm()))))
    max_abs = max(float((dw - tw).abs().max()), float((db - tb).abs().max()))
    return out, max_abs


def k3_check(ks, kg, packed, args, what: str, twin: bool = True):
    """The recompute's rgb and sigma (forward_out) against K1's on the same
    inputs, bit for bit, and with ``twin``: K3 against its twin (per packed
    layer, TOL_K3_*) and a second launch bitwise equal. Without the twin at
    a P too small for its bounds (there one flipped ReLU mask moves a few
    percent of a layer). Returns (max abs error, worst relative error,
    lowest cosine), or None without the twin."""
    p = args[0].shape[1]
    fwd = torch.empty(4, p, device="cuda")
    dw, db = kg.fused_nerf_bwd(packed, *args, forward_out=fwd)
    rgb, sigma = ks.fused_nerf_apply_t(packed, args[0], args[1])
    torch.cuda.synchronize()
    tie = bool(torch.equal(fwd[:3], rgb) and torch.equal(fwd[3:], sigma))
    msg = f"recomputed rgb and sigma equal K1's bit for bit: {tie}"
    if not twin:
        print(f"[k3] {what} P={p}: {msg}", flush=True)
        check(tie, f"K3's recompute differs from K1's forward ({what}, P={p})")
        return None
    dw2, db2 = kg.fused_nerf_bwd(packed, *args)
    tw, tb = kg.fused_nerf_bwd_plain(packed, *args)
    errs, max_abs = layer_errors(packed, dw, db, tw, tb)
    worst_rel, worst_cos = max(e[0] for e in errs), min(e[1] for e in errs)
    repeat = bool(torch.equal(dw, dw2) and torch.equal(db, db2))
    print(f"[k3] {what} P={p}: per packed layer (then biases) max|err|/max|twin| "
          f"{', '.join(f'{e[0]:.2e}' for e in errs)}; cosine >= {worst_cos:.7f}; "
          f"max|err| {max_abs:.3e}; second launch bitwise equal: {repeat}; {msg}", flush=True)
    check(bool(torch.isfinite(dw).all() and torch.isfinite(db).all()), "K3 output not finite")
    check(worst_rel <= TOL_K3_REL and worst_cos >= TOL_K3_COS,
          f"K3 disagrees with its twin ({what}, P={p})")
    check(repeat, f"K3 is not bitwise repeatable ({what}, P={p})")
    check(tie, f"K3's recompute differs from K1's forward ({what}, P={p})")
    return max_abs, worst_rel, worst_cos


def phase_k3(ks, kg, sd_c):
    """K3 against its twin at P = 262,144 + 300 (D8 and, on its run-time
    depth build, D6 with skip 2), a repeat launch bitwise equal, the
    recompute's rgb and sigma equal to K1's bit for bit there and at P =
    300, and timings at the training step's two shapes by events and by
    device time, each launch apart."""
    from tgtc_torch.convert import nerf_state_dict_from_flax

    packed = ks.pack_nerf_params(sd_c, device="cuda")
    rng = np.random.default_rng(2)
    p = P_K3["fine"] + RAGGED
    arrs = (rng.uniform(-1, 1, (3, p)), rng.standard_normal((3, p)),
            rng.standard_normal((3, p)), rng.standard_normal((1, p)))
    pts, dirs, g_rgb, g_sig = (torch.from_numpy(a.astype(np.float32)).cuda() for a in arrs)
    full = (pts, dirs, g_rgb, g_sig)
    max_abs, worst_rel, worst_cos = k3_check(ks, kg, packed, full, "D8")
    k3_check(ks, kg, packed, tuple(t[:, :RAGGED].contiguous() for t in full), "D8", twin=False)
    sd6 = nerf_state_dict_from_flax(he_params(np.random.default_rng(6), depth=6, skip=2))
    packed6 = ks.pack_nerf_params(sd6, depth=6, skip=2, device="cuda")
    k3_check(ks, kg, packed6, full, "D6 skip 2")

    times, devs, per = {}, {}, {}
    for shape, n in P_K3.items():
        args = (packed,) + tuple(t[:, :n].contiguous() for t in full)
        times[shape] = cuda_ms(lambda: kg.fused_nerf_bwd(*args), 10)
        devs[shape], _, per[shape] = device_ms(lambda: kg.fused_nerf_bwd(*args), 5,
                                               per_kernel=True)
    n = P_K3["fine"]
    plain_ms = cuda_ms(lambda: kg.fused_nerf_bwd_plain(*args), 3)
    e_c = ks._encode_plain(args[1].T, 10, packed.k_coor).to(torch.bfloat16)
    e_d = ks._encode_plain(args[2].T, 4, packed.k_dir).to(torch.bfloat16)
    chain_ms = cuda_ms(addmm_backward(packed, e_c, e_d, args[3], args[4]), 10)
    del e_c, e_d
    nwb = packed.w.numel() + packed.b.numel()
    flops = FLOP_PER_POINT["K3"] * n
    fn_bytes = 40 * n + packed.w.numel() * 2 + packed.b.numel() * 4 + nwb * 4
    # this design's workspace (the saved activations and gradients, the
    # transposed weights, the masks and the per-chunk partials), each byte
    # written once and read once
    point_bytes = kg.workspace_point_bytes(packed.depth)
    ws_bytes = 2 * kg.workspace_bytes(packed, n)
    b = 1e3 * max(flops / PEAK_BF16_FLOPS, fn_bytes / PEAK_BYTES)
    b_ws = 1e3 * max(flops / PEAK_BF16_FLOPS, (fn_bytes + ws_bytes) / PEAK_BYTES)

    def launches(shape):
        return "; ".join(f"{name.replace('void ', '').replace('(anonymous namespace)::', '')} "
                         f"{ms:.3f}" for name, ms in sorted(per[shape].items(),
                                                            key=lambda kv: -kv[1]))

    print(f"[k3] kernel {times['coarse']:.3f} ms ev, {devs['coarse']:.3f} ms dev at "
          f"P={P_K3['coarse']}; {times['fine']:.3f} ms ev, {devs['fine']:.3f} ms dev at P={n}; "
          f"bound {b:.3f} ms (operations), {100 * b / devs['fine']:.2f}% of it by device time; "
          f"{b_ws:.3f} ms counting this design's workspace ({point_bytes} bytes a point, "
          f"{ws_bytes / 2 / n:.1f} with the fixed parts at this P, written and read once); "
          f"plain twin {plain_ms:.3f} ms; orientation only: bf16 autograd through the "
          f"torch.addmm chain {chain_ms:.3f} ms ev (kernel / chain {times['fine'] / chain_ms:.3f})",
          flush=True)
    for shape in P_K3:
        print(f"[k3] device time by launch at P={P_K3[shape]} (ms a call): {launches(shape)}",
              flush=True)
    return {
        "name": "K3", "route": "cuda", "source": "tgtc_torch/csrc/nerf_mlp_grad.cu",
        "replaces": "tgtc/ops/pallas/nerf_mlp_grad.py:268",
        "wrapper": "tgtc_torch.ops.kernels.nerf_mlp_grad.fused_nerf_bwd",
        "design": ENGINE_DESIGN["K3"],
        "P": n, "max_abs_err": max_abs, "max_err": max_abs, "max_rel_err": worst_rel,
        "min_cos": worst_cos,
        "ms": times["fine"], "ms_coarse": times["coarse"], "P_coarse": P_K3["coarse"],
        "dev_ms": devs["fine"], "dev_ms_coarse": devs["coarse"],
        "dev_ms_by_launch": per["fine"], "dev_ms_by_launch_coarse": per["coarse"],
        "plain_ms": plain_ms, "bound_ms": b, "bound_by": "operations",
        "bound_ms_with_workspace": b_ws, "workspace_bytes_per_point": point_bytes,
        "library_ms": None, "matmul_chain_ms": chain_ms,
    }


def grad_cos(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a * b).sum() / (a.norm() * b.norm()))


def grad_rel(a, b) -> float:
    """max|a - b| / max|b|, b the reference."""
    return float((a.double() - b.double()).abs().max() / (b.double().abs().max() + 1e-12))


def trunks(cfg, state, device, dtype=None):
    """``state``'s two trunks as new NerfMLPs on ``device`` (in ``dtype``
    if given), the weights copied."""
    from tgtc_torch.models.nerf import NerfMLP

    cfg = cfg if dtype is None else dataclasses.replace(cfg, compute_dtype=dtype)
    out = []
    for m in (state.coarse, state.fine):
        copy = NerfMLP(cfg)
        copy.load_state_dict(m.state_dict())
        out.append(copy.to(device))
    return out


def compare_steps(kg, tt, cfg, tc, fresh, trained, ro, rd, rgb):
    """The fused step on the card, with one batch and one set of draws:

    * from the initial state, against the eager f32 step: losses within
      2e-2, every parameter's gradient cosine >= 0.99;
    * from the trained state, two held witnesses that the kernels compute
      the fused step's gradient: K3 against its twin on the card with the
      step's own packed weights and cotangents (per packed layer, the bounds
      of phase 3), and the step against the same step on the CPU, where the
      wrappers run the twins (losses within 2e-2, every gradient cosine >=
      0.99); then, read and not held, each leaf's error against the eager
      f32 step beside the eager bf16 step's (the yardstick of
      tests/test_fused_grad.py:54-106, error <= 1.3x the bf16 step's +
      5e-3)."""
    fused = tt.make_fused_train_step(cfg, tc, device="cuda")
    eager = tt.make_train_step(tc, device="cuda")
    draws = fused.draw(ro.shape[0], torch.Generator(device="cuda").manual_seed(7))
    names = ([f"coarse.{n}" for n, _ in fresh.coarse.named_parameters()]
             + [f"fine.{n}" for n, _ in fresh.fine.named_parameters()])

    m_f, g_f = fused.loss_and_grad(fresh.coarse, fresh.fine, ro, rd, rgb, draws)
    m_e, g_e = eager.loss_and_grad(*trunks(cfg, fresh, "cuda", torch.float32), ro, rd, rgb,
                                   draws)
    cos = {n: grad_cos(a, b) for n, a, b in zip(names, g_f, g_e)}
    worst, dl = min(cos, key=cos.get), abs(float(m_f["loss"]) - float(m_e["loss"]))
    print(f"[train] initial state, fused step vs eager f32 step: loss {float(m_f['loss']):.6f} "
          f"vs {float(m_e['loss']):.6f} (|diff| {dl:.3e}); gradient cosine >= {cos[worst]:.6f} "
          f"({worst})", flush=True)
    check(dl <= TOL_STEP_LOSS, "initial state: fused step loss disagrees with the eager f32 step")
    check(cos[worst] >= TOL_STEP_COS, "initial state: fused step gradient disagrees with the "
          "eager f32 step")

    # the trained state's step, with the inputs of each K3 launch recorded
    backward, calls = kg.FusedNerfApply.backward, []

    def recording(ctx, g_rgb, g_sigma):
        w, b, pts, dirs = ctx.saved_tensors
        calls.append((dataclasses.replace(ctx.layout, w=w.detach(), b=b.detach()), pts, dirs,
                      g_rgb.float().contiguous().clone(), g_sigma.float().contiguous().clone()))
        return backward(ctx, g_rgb, g_sigma)

    kg.FusedNerfApply.backward = staticmethod(recording)
    try:
        m_f, g_f = fused.loss_and_grad(trained.coarse, trained.fine, ro, rd, rgb, draws)
    finally:
        kg.FusedNerfApply.backward = staticmethod(backward)
    check(len(calls) == 2, f"the fused step ran {len(calls)} backward passes, not 2")
    for packed, *args in calls:
        which = "coarse" if args[0].shape[1] == P_K3["coarse"] else "fine"
        dw, db = kg.fused_nerf_bwd(packed, *args)
        torch.cuda.synchronize()
        tw, tb = kg.fused_nerf_bwd_plain(packed, *args)
        errs, _ = layer_errors(packed, dw, db, tw, tb)
        rel, c = max(e[0] for e in errs), min(e[1] for e in errs)
        print(f"[train] trained state, K3 vs its twin on the step's own {which} pass (P = "
              f"{args[0].shape[1]}): per packed layer (then biases) max|err|/max|twin| "
              f"{', '.join(f'{e[0]:.2e}' for e in errs)}; cosine >= {c:.7f}", flush=True)
        check(rel <= TOL_K3_REL and c >= TOL_K3_COS,
              f"trained state: K3 disagrees with its twin on the {which} pass")
    del calls

    t0 = time.perf_counter()
    cpu = tt.make_fused_train_step(cfg, tc, device="cpu")
    d_cpu = tt.StepDraws(*(None if t is None else t.cpu() for t in (
        draws.idx, draws.perturb_u, draws.noise_coarse, draws.noise_fine)))
    m_c, g_c = cpu.loss_and_grad(*trunks(cfg, trained, "cpu"), ro.cpu(), rd.cpu(), rgb.cpu(),
                                 d_cpu)
    cpu_s = time.perf_counter() - t0
    cos = {n: grad_cos(a.cpu(), b) for n, a, b in zip(names, g_f, g_c)}
    rel = {n: grad_rel(a.cpu(), b) for n, a, b in zip(names, g_f, g_c)}
    worst, dl = min(cos, key=cos.get), abs(float(m_f["loss"]) - float(m_c["loss"]))
    print(f"[train] trained state, fused step on the card vs on the CPU (twins, {cpu_s:.1f} s): "
          f"loss {float(m_f['loss']):.6f} vs {float(m_c['loss']):.6f} (|diff| {dl:.3e}); "
          f"gradient cosine >= {cos[worst]:.6f} ({worst}); max|err|/max|CPU| <= "
          f"{max(rel.values()):.3e} ({max(rel, key=rel.get)})", flush=True)
    check(dl <= TOL_STEP_LOSS, "trained state: fused step loss on the card disagrees with the CPU")
    check(cos[worst] >= TOL_STEP_COS, "trained state: fused step gradient on the card "
          "disagrees with the CPU")
    del g_c

    m_e, g_e = eager.loss_and_grad(*trunks(cfg, trained, "cuda", torch.float32), ro, rd, rgb,
                                   draws)
    _, g_b = eager.loss_and_grad(trained.coarse, trained.fine, ro, rd, rgb, draws)  # bf16
    e_f = [grad_rel(a, t) for a, t in zip(g_f, g_e)]
    e_b = [grad_rel(b, t) for b, t in zip(g_b, g_e)]
    c_f = [grad_cos(a, t) for a, t in zip(g_f, g_e)]
    c_b = [grad_cos(b, t) for b, t in zip(g_b, g_e)]
    over = sum(f > 1.3 * b + 5e-3 for f, b in zip(e_f, e_b))
    print(f"[train] trained state vs the eager f32 step (read, not held): loss fused "
          f"{float(m_f['loss']):.6f}, f32 {float(m_e['loss']):.6f}; gradient cosine >= "
          f"{min(c_f):.6f} fused, {min(c_b):.6f} eager bf16; {over} of {len(names)} leaves "
          f"with a fused error above 1.3x the eager bf16 step's + 5e-3", flush=True)
    for which in ("coarse", "fine"):
        print(f"[train] trained state, {which} leaves, max|err|/max|f32| fused / eager bf16: "
              + ", ".join(f"{n.split('.', 1)[1]} {f:.3f}/{b:.3f}"
                          for n, f, b in zip(names, e_f, e_b) if n.startswith(which)),
              flush=True)


def phase_train(ks, kg):
    """Phase A at fern width through train_nerf, then compare_steps and a
    checkpoint round trip. Returns the trained renderer, the counted
    window's launches, its steps/s and the trained trunks' state dicts with
    the scene's intrinsics and spiral poses."""
    from tgtc_torch.data.llff import load_llff_data
    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.nerf import NerfConfig
    from tgtc_torch.render.fast import FusedNerfRenderer
    from tgtc_torch.render.volume import RenderSettings
    from tgtc_torch.train import nerf_trainer as tt
    from tgtc_torch.train.checkpoint import CheckpointManager

    cfg = NerfConfig()
    tc = tt.NerfTrainConfig(batch_size=BATCH, n_samples=NC, n_samples_fine=NF,
                            sigma_noise_std=1.0)
    check(tt.fused_train_supported(cfg), "the fern config must take the fused step")
    settings = RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        scene = load_llff_data(write_scene(os.path.join(tmp, "scene"), n=4), factor=1)
        run = os.path.join(tmp, "run")
        kw = dict(i_print=I_PRINT, device="cuda", print_fn=lambda m: print(m, flush=True))
        t0 = time.perf_counter()
        state, warm = tt.train_nerf(scene, cfg, tc, WARM_STEPS, run, **kw)
        warm_s = time.perf_counter() - t0
        for k in (ks.fused_nerf_apply_t, ks.fused_nerf_sigma_apply_t, kg.fused_nerf_bwd):
            k.launches = 0
        t0 = time.perf_counter()
        state, hist = tt.train_nerf(scene, cfg, tc, WARM_STEPS + TRAIN_STEPS, run, **kw)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"K1": ks.fused_nerf_apply_t.launches, "K2": ks.fused_nerf_sigma_apply_t.launches,
                    "K3": kg.fused_nerf_bwd.launches}
        losses = warm["loss"] + hist["loss"]
        # every counted step over the loop's time: the log windows' steps
        # over the sum of their times (set-up and restore excluded)
        ends = [WARM_STEPS] + [r["step"] for r in hist["records"]]
        sizes = np.diff(ends)
        loop_s = float(sum(n / r["steps_per_s"] for n, r in zip(sizes, hist["records"])))
        steps_per_s = float(sizes.sum()) / loop_s
        first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
        print(f"[train] {len(scene.images)} views {H}x{W}, D8/W256, batch {BATCH}, {NC}+{NF} "
              f"samples: {WARM_STEPS} warm-up steps in {warm_s:.2f} s, then {TRAIN_STEPS} steps "
              f"in {train_s:.2f} s (call, set-up and final save included), of which the loop "
              f"{loop_s:.3f} s: {steps_per_s:.2f} steps/s; per log window (steps: steps/s) "
              + ", ".join(f"{n}: {r['steps_per_s']:.2f}" for n, r in zip(sizes, hist["records"]))
              + f"; launches K1 {launches['K1']} K2 {launches['K2']} K3 "
              f"{launches['K3']} (expect {2 * TRAIN_STEPS}, 0, {2 * TRAIN_STEPS}); mean loss "
              f"of the first 20 steps {first:.5f}, of the last 20 {last:.5f}; psnr_fine "
              f"{warm['records'][-1]['psnr_fine']:.2f} -> {hist['records'][-1]['psnr_fine']:.2f}",
              flush=True)
        check(launches == {"K1": 2 * TRAIN_STEPS, "K2": 0, "K3": 2 * TRAIN_STEPS},
              f"training launch counts {launches}")
        check(int(sizes.sum()) == TRAIN_STEPS, f"the log windows cover {sizes.sum()} steps")
        check(len(losses) == WARM_STEPS + TRAIN_STEPS and all(math.isfinite(x) for x in losses),
              "training loss not finite")
        check(last < first, "training loss did not fall")

        # the fused step against the eager f32 step and its witnesses
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        h, w, _ = scene.hwf
        ro, rd = rays_for_poses(h, w, scene.intrinsics, scene.poses, device="cuda")
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        rgb = torch.as_tensor(scene.images, dtype=torch.float32).reshape(-1, 3).cuda()
        fresh = tt.init_state(torch.Generator().manual_seed(0), cfg, tc, device="cuda")
        compare_steps(kg, tt, cfg, tc, fresh, state, ro, rd, rgb)
        del fresh

        # checkpoint round trip: save, restore into a fresh state, render
        mgr = CheckpointManager(os.path.join(tmp, "roundtrip"))
        mgr.save(state.step, state.state_dict())
        restored = tt.init_state(torch.Generator().manual_seed(5), cfg, tc, device="cuda")
        restored.load_state_dict(mgr.restore(map_location="cuda"))
        renders = []
        for st in (state, restored):
            r = FusedNerfRenderer.from_params(st.coarse.state_dict(), st.fine.state_dict(),
                                              settings, coarse_rgb=False, device="cuda")
            renders.append(r.render(ro[:BLOCK], rd[:BLOCK]))
        same = restored.step == state.step and all(
            torch.equal(renders[0][k], renders[1][k]) for k in renders[0])
        print(f"[train] checkpoint round trip at step {restored.step}: render of {BLOCK} rays "
              f"bitwise equal: {same}", flush=True)
        check(same, "checkpoint round trip changed the render")
    trained = {"coarse": state.coarse.state_dict(), "fine": state.fine.state_dict(),
               "intrinsics": scene.intrinsics, "render_poses": scene.render_poses}
    renderer = FusedNerfRenderer.from_params(trained["coarse"], trained["fine"], settings,
                                             coarse_rgb=False, device="cuda")
    return renderer, launches, steps_per_s, trained


def phase_b(ks, renderer, root: str) -> str:
    """Phase B into ``root``; returns the geometry directory (phase 9
    stylizes its views)."""
    from tgtc_torch.data.llff import load_llff_data
    from tgtc_torch.train.geometry import dump_geometry

    scene = load_llff_data(write_scene(os.path.join(root, "scene")), factor=1)
    out_dir = os.path.join(root, "geometry")
    ks.fused_nerf_apply_t.launches = 0
    ks.fused_nerf_sigma_apply_t.launches = 0
    t0 = time.perf_counter()
    dump_geometry(renderer, scene, out_dir)
    dt = time.perf_counter() - t0
    n = scene.poses.shape[0]
    names = [f"{kind}_{i:05d}.{ext}" for i in range(n)
             for kind, ext in (("rgb", "png"), ("depth", "png"), ("geometry", "npz"))]
    missing = [f for f in names + ["geometry.npz"] if not os.path.exists(os.path.join(out_dir, f))]
    check(not missing, f"Phase B artifacts missing: {missing}")
    geo = np.load(os.path.join(out_dir, "geometry.npz"))
    check(geo["coor_maps"].shape == (n, H, W, 3), "coor_maps shape")
    check(bool(np.isfinite(geo["coor_maps"]).all()), "coor_map not finite")
    print(f"[phase_b] {n} views at {H}x{W}: dump_geometry {dt:.2f} s, "
          f"{len(names) + 1} files, launches K1 {ks.fused_nerf_apply_t.launches} "
          f"K2 {ks.fused_nerf_sigma_apply_t.launches}", flush=True)
    check(ks.fused_nerf_apply_t.launches > 0 and ks.fused_nerf_sigma_apply_t.launches > 0,
          "Phase B did not go through the kernels")
    return out_dir


def phase_style_kernels(ks, kst, sd_c, style_sds):
    """K4/K5 against their twins at P = 2^21 + 300 and at the engine's
    tile-cutting P (samples per ray 1, and 128 at one and 133 tiles), with
    sigmas bitwise equal (K5 and K4, K5 and K2 on the same trunk, two K4
    launches, two K5 launches), and timings at the stylized frame's
    shapes."""
    packed = kst.pack_style_params(sd_c, *style_sds, device="cuda")
    packed_k2 = ks.pack_nerf_params(sd_c, device="cuda")
    rng = np.random.default_rng(3)
    p = P_K1 + RAGGED
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, p)).astype(np.float32)).cuda()
    lat = torch.from_numpy(rng.standard_normal((p, LATENT)).astype(np.float32)).cuda()
    err = {"K4": (0.0, 0.0), "K5": (0.0, 0.0)}
    cases = ([(n, 1) for n in ENGINE_P] + [(ENGINE_TILE, 128), (133 * ENGINE_TILE, 128)]
             + [(p, 1)])
    for n, spr in cases:
        pt, lt = pts[:, :n].contiguous(), lat[:n // spr].contiguous()
        rgb, sigma = kst.fused_style_apply_t(packed, pt, lt, spr)
        rgb2, sigma2 = kst.fused_style_apply_t(packed, pt, lt, spr)
        sigma5 = kst.fused_sigma_apply_t(packed, pt)
        sigma5b = kst.fused_sigma_apply_t(packed, pt)
        sigma_k2 = ks.fused_nerf_sigma_apply_t(packed_k2, pt)
        torch.cuda.synchronize()
        rgb_p, sigma_p = kst.fused_style_apply_t_plain(packed, pt, lt, spr)
        sigma5_p = kst.fused_sigma_apply_t_plain(packed, pt)
        e4 = (float((rgb - rgb_p).abs().max()), float((sigma - sigma_p).abs().max()))
        e5 = float((sigma5 - sigma5_p).abs().max())
        same = {"K5 = K4": torch.equal(sigma5, sigma), "K5 = K2": torch.equal(sigma5, sigma_k2),
                "K4 = K4": torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2),
                "K5 = K5": torch.equal(sigma5, sigma5b)}
        print(f"[style_kernels] P={n} spr={spr}: K4 max|rgb err| {e4[0]:.3e} max|sigma err| "
              f"{e4[1]:.3e}; K5 max|sigma err| {e5:.3e}; |rgb| mean {float(rgb_p.mean()):.3f}, "
              f"|sigma| max {float(sigma_p.abs().max()):.3e}; bitwise: "
              + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)
        check(bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all()),
              "K4 output not finite")
        check(e4[0] <= TOL_RGB and e4[1] <= TOL_SIGMA, f"K4 disagrees with its twin at P={n}")
        check(e5 <= TOL_SIGMA, f"K5 disagrees with its twin at P={n}")
        check(all(same.values()), f"sigma not bitwise equal where it must be at P={n}: {same}")
        err = {"K4": tuple(max(a, b) for a, b in zip(err["K4"], e4)),
               "K5": (0.0, max(err["K5"][1], e5))}
        del rgb, sigma, rgb2, sigma2, sigma5, sigma5b, sigma_k2, rgb_p, sigma_p, sigma5_p

    rows = []
    lat_r = lat[:BLOCK].contiguous()  # one fine block's per-ray latents, distinct random rows
    for name, n in (("K4", P_K1), ("K5", P_K2)):
        pt = pts[:, :n].contiguous()
        e_c = ks._encode_plain(pt.T, 10, packed.k_coor).to(torch.bfloat16)
        if name == "K4":
            spr = n // BLOCK
            args = (packed, pt, lat_r, spr)
            fn, twin = kst.fused_style_apply_t, kst.fused_style_apply_t_plain
            chain = style_matmul_chain(packed, e_c,
                                       lat_r.to(torch.bfloat16).repeat_interleave(spr, 0))
            io = 32 * n + lat_r.numel() * 4  # pts in, rgb and sigma out, latent rows in
        else:
            args = (packed, pt)
            fn, twin = kst.fused_sigma_apply_t, kst.fused_sigma_apply_t_plain
            chain = matmul_chain(packed, e_c, None, False)
            io = 16 * n
        # the kernel against its twin on the main path's arguments (K4: a fine
        # block's per-ray latents, row p // samples_per_ray)
        got, want = fn(*args), twin(*args)
        torch.cuda.synchronize()
        if name == "K4":
            err_main = (float((got[0] - want[0]).abs().max()),
                        float((got[1] - want[1]).abs().max()))
        else:
            err_main = (0.0, float((got - want).abs().max()))
        del got, want
        print(f"[style_kernels] {name} P={n} on the frame's arguments: max|rgb err| "
              f"{err_main[0]:.3e} max|sigma err| {err_main[1]:.3e}", flush=True)
        check(err_main[0] <= TOL_RGB and err_main[1] <= TOL_SIGMA,
              f"{name} disagrees with its twin on the frame's arguments")
        err[name] = tuple(max(a, b) for a, b in zip(err[name], err_main))
        ms, dev = timed(lambda: fn(*args), 10)
        plain_ms = cuda_ms(lambda: twin(*args), 3)
        chain_ms, chain_dev = timed(chain, 10)
        del e_c, chain
        b = bound_ms(name, n, packed, io)
        print(f"[style_kernels] {name} P={n}: kernel {ms:.3f} ms ev, {dev:.3f} ms dev, bound "
              f"{b:.3f} ms (operations), {100 * b / dev:.2f}% of the bound by device time; plain "
              f"twin {plain_ms:.3f} ms; orientation only: bf16 torch.addmm chain {chain_ms:.3f} "
              f"ms ev, {chain_dev:.3f} ms dev (kernel / chain {dev / chain_dev:.3f})", flush=True)
        rows.append({
            "name": name, "route": "cuda", "source": "tgtc_torch/csrc/style_kernel.cu",
            "replaces": ("tgtc/ops/pallas/style_kernel.py:432" if name == "K4"
                         else "tgtc/ops/pallas/style_kernel.py:387"),
            "wrapper": ("tgtc_torch.ops.kernels.style_kernel." +
                        ("fused_style_apply_t" if name == "K4" else "fused_sigma_apply_t")),
            "design": ENGINE_DESIGN[name],
            "P": n, "max_abs_err": max(err[name]), "max_err": max(err[name]),
            "max_abs_err_rgb": err[name][0] if name == "K4" else None,
            "max_abs_err_sigma": err[name][1],
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": "operations", "bound_share": b / dev, "library_ms": None,
            "matmul_chain_ms": chain_ms, "matmul_chain_device_ms": chain_dev,
        })
    return rows


def style_mlps():
    """Phase 7's seeded style MLPs (torch seed 11) on the card."""
    from tgtc_torch.models.style_field import StyleFieldConfig, make_style_mlps

    return make_style_mlps(StyleFieldConfig(), torch.Generator().manual_seed(11), device="cuda")


def stylized_vs_eager(renderer, trained, concat, style, fo, fd, out, tag: str, what: str):
    """The first BLOCK rays of a stylized frame (style 0, frame 0, seed
    F_SEED) against the eager f32 chain with the same jitter: phase 2's
    bounds and exemption."""
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP, nerf_apply
    from tgtc_torch.render.fast_style import block_generator
    from tgtc_torch.train.render_style import make_stylized_render_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = []
    for sd in (trained["coarse"], trained["fine"]):
        m = NerfMLP(NerfConfig(compute_dtype=torch.float32))
        m.load_state_dict(sd)
        models.append(m.cuda())
    eager = make_stylized_render_fn(*models, concat, style, NC, NF, renderer.settings.near,
                                    renderer.settings.far)
    bo, bd = fo[:BLOCK], fd[:BLOCK]
    ids = torch.zeros(BLOCK, dtype=torch.long, device="cuda")
    u = torch.rand((BLOCK, NC), generator=block_generator(F_SEED, 0, 0, "cuda"), device="cuda")
    ref = eager(renderer.latent_state, bo, bd, ids, ids, u=u)
    with torch.no_grad():
        last = nerf_apply(models[1], bo + ref["ts_fine"][:, -1:] * bd, bd)["sigma"]
    err = torch.maximum((out["rgb"][:BLOCK] - ref["rgb"]).abs().amax(-1),
                        (out["t_exp"][:BLOCK] - ref["t_exp"]).abs())
    bad, flip = err > TOL_RENDER, last.abs() <= TOL_SIGMA  # phase 2's exemption
    worst = float(err[~flip].max()) if bool((~flip).any()) else 0.0
    print(f"[{tag}] first {BLOCK} rays vs the eager f32 stylized render: max|err| over rgb "
          f"and t_exp {float(err.max()):.3e}; {int(bad.sum())} rays above {TOL_RENDER}, all "
          f"with |last-sample sigma| <= {TOL_SIGMA}: {bool((flip | ~bad).all())}; max|err| "
          f"over the other {int((~flip).sum())} rays {worst:.3e}", flush=True)
    check(bool((flip | ~bad).all()), f"{what} disagrees with the eager render")
    check(int(bad.sum()) <= BLOCK // 1000, f"too many rays of the {what} differ from the eager "
          "render")


def phase_f(ks, kst, trained):
    """Phase F from the trained trunks: seeded style MLPs and a 1-style
    latent table; stylized 756x1008 frames at spiral poses through
    FusedStyleRenderer(coarse_rgb=False) (47 K5 and 47 K4 launches a frame,
    no K1/K2); the first 16,384 rays against the eager f32 render; then the
    frame loop over three views. Returns the launches of one frame, the
    median frame's rays/s and the loop's frames/min."""
    from PIL import Image

    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.style_field import init_latents
    from tgtc_torch.render.fast_style import FusedStyleRenderer
    from tgtc_torch.render.volume import RenderSettings
    from tgtc_torch.train.render_style import render_stylized_frames_fused

    concat, style = style_mlps()
    lat = init_latents(torch.Generator().manual_seed(12), 1, LATENT_FRAMES, LATENT,
                       device="cuda")
    settings = RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    renderer = FusedStyleRenderer.from_params(trained["coarse"], trained["fine"],
                                              concat.state_dict(), style.state_dict(), lat,
                                              settings, coarse_rgb=False, device="cuda")
    ro, rd = rays_for_poses(H, W, trained["intrinsics"], trained["render_poses"][:F_VIEWS],
                            use_ndc=True, device="cuda")
    fo, fd = ro[0].reshape(-1, 3), rd[0].reshape(-1, 3)
    n, blocks = fo.shape[0], math.ceil(fo.shape[0] / BLOCK)
    counters = {"K1": ks.fused_nerf_apply_t, "K2": ks.fused_nerf_sigma_apply_t,
                "K4": kst.fused_style_apply_t, "K5": kst.fused_sigma_apply_t}

    renderer.render_image(fo, fd, 0, 0, block=BLOCK, seed=F_SEED)  # warm-up frame
    torch.cuda.synchronize()
    times = []
    for _ in range(FRAMES):
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = renderer.render_image(fo, fd, 0, 0, block=BLOCK, seed=F_SEED)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {name: k.launches for name, k in counters.items()}
        check(launches == {"K1": 0, "K2": 0, "K4": blocks, "K5": blocks},
              f"stylized frame launch counts {launches}, expected {blocks} K4 and K5")
    dt = float(np.median(times))
    print(f"[phase_f] stylized frame {H}x{W} ({n} rays, {NC}+{NF} samples, block {BLOCK}), "
          f"{FRAMES} frames after a warm-up: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; "
          f"median {dt * 1e3:.1f} ms, {n / dt:.1f} rays/s; launches per frame "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    check(out["rgb"].shape == (n, 3) and out["t_exp"].shape == (n,), "stylized frame shape")
    check(bool(torch.isfinite(out["rgb"]).all() and torch.isfinite(out["t_exp"]).all()),
          "stylized frame not finite")

    stylized_vs_eager(renderer, trained, concat, style, fo, fd, out, "phase_f", "stylized frame")
    del out

    with tempfile.TemporaryDirectory() as tmp:
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        rendered = render_stylized_frames_fused(renderer, ro, rd, [0], tmp, seed=F_SEED,
                                                block=BLOCK, depth_png="full")
        loop_s = time.perf_counter() - t0
        names = [f"style_00000_fine{kind}_{f:05d}.png" for f in range(F_VIEWS)
                 for kind in ("", "_depth")]
        sizes = {f: Image.open(os.path.join(tmp, f)).size
                 for f in names if os.path.exists(os.path.join(tmp, f))}
        again = render_stylized_frames_fused(renderer, ro, rd, [0], tmp, seed=F_SEED,
                                             block=BLOCK)
        print(f"[phase_f] frame loop: {rendered} frames in {loop_s:.2f} s with the PNG writes "
              f"({60 * rendered / loop_s:.2f} frames/min), {len(sizes)} of {len(names)} PNGs "
              f"at {W}x{H}: {all(s == (W, H) for s in sizes.values())}; launches K4 "
              f"{counters['K4'].launches} K5 {counters['K5'].launches}; a second call "
              f"rendered {again}", flush=True)
        check(rendered == F_VIEWS, f"the frame loop rendered {rendered} frames")
        loop_launches = {name: k.launches for name, k in counters.items()}
        check(loop_launches == {"K1": 0, "K2": 0, "K4": F_VIEWS * blocks,
                                "K5": F_VIEWS * blocks},
              f"frame loop launch counts {loop_launches}")
        check(len(sizes) == len(names) and all(s == (W, H) for s in sizes.values()),
              "the frame loop's PNGs are missing or of the wrong size")
        check(again == 0, "skip_existing rendered frames again")
    return launches, n / dt, 60 * rendered / loop_s


def k6_inputs(rng: np.random.Generator, heads: int, sq: int, sk: int):
    """bf16 q [1, heads, sq, 64], k and v [1, heads, sk, 64] on the card."""
    return tuple(torch.from_numpy(rng.standard_normal((1, heads, n, D_HEAD)).astype(np.float32))
                 .to("cuda", torch.bfloat16) for n in (sq, sk, sk))


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


FLASH_PRODUCTS = {"K6": 2, "K7": 3, "K8": 4}  # matrix products per tile


def flash_io_bytes(kernel: str, bh: int, sq: int, sk: int) -> int:
    """The bytes ``kernel`` must move, each input read once and each output
    written once: K6 q, k, v in and o out in bf16, lse out in f32; K7 q, k,
    v, dO in and dq out in bf16, lse and delta in in f32; K8 as K7 with dk
    and dv out."""
    bf16_rows = {"K6": 2 * sq + 2 * sk, "K7": 3 * sq + 2 * sk, "K8": 2 * sq + 4 * sk}[kernel]
    f32_vals = sq if kernel == "K6" else 2 * sq
    return bh * (2 * bf16_rows * D_HEAD + 4 * f32_vals)


def flash_floors_ms(kernel: str, bh: int, sq: int, sk: int, dropout: bool, clock_hz: float):
    """The four floors of ``kernel`` (K6, K7 or K8) in ms. Tensor cores: 2
    Sq Sk D FLOP per product / bf16 peak. HBM: flash_io_bytes / HBM rate.
    SFU: one ex2 per element of S. INT32, under dropout only: the hash's
    integer operations per element of S (HASH_INT_OPS)."""
    elems = bh * sq * sk
    return {
        "tensor": 1e3 * FLASH_PRODUCTS[kernel] * 2 * elems * D_HEAD / PEAK_BF16_FLOPS,
        "hbm": 1e3 * flash_io_bytes(kernel, bh, sq, sk) / PEAK_BYTES,
        "sfu": 1e3 * elems / (SMS * SFU_PER_CLK * clock_hz),
        "int32": 1e3 * elems * HASH_INT_OPS / (SMS * INT32_PER_CLK * clock_hz) if dropout else 0.0,
    }


def flash_bound_ms(kernel: str, bh: int, sq: int, sk: int, dropout: bool, clock_hz: float):
    """(ms, floor): the largest of ``kernel``'s four floors and its name."""
    floors = flash_floors_ms(kernel, bh, sq, sk, dropout, clock_hz)
    floor = max(floors, key=floors.get)
    return floors[floor], floor


def phase_k6(fa):
    """K6 against its twin at the C3, rectangular and ragged shapes and at
    shapes that cut its 128-row blocks and 128-key tiles (at dropout 0 and
    0.25), a second launch bitwise equal; the dropout mask probe; timings
    at both large shapes by CUDA events and by the profiler's device time,
    beside the four-floor bound, the twin and SDPA."""
    rng = np.random.default_rng(4)
    shapes = {"c3": (C3_HEADS, C3_TOKENS, C3_TOKENS), "rect": (C3_HEADS, C3_TOKENS, 4096),
              "ragged": (16, 300, 180), "cut": (4, 200, 130), "cut2": (2, 1000, 1030),
              "sk1": (4, 300, 1), "sk65": (4, 300, 65)}
    cases = [(name, 0.0) for name in shapes]
    cases += [(name, 0.25) for name in ("cut", "cut2", "sk1", "sk65")]
    err_o, err_lse, inputs = 0.0, 0.0, {}
    for name, rate in cases:
        heads, sq, sk = shapes[name]
        if name not in inputs:
            inputs[name] = k6_inputs(rng, heads, sq, sk)
        q, k, v = inputs[name]
        o, lse = fa.flash_attention_fwd(q, k, v, K6_SCALE, rate, 11)
        o2, lse2 = fa.flash_attention_fwd(q, k, v, K6_SCALE, rate, 11)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, K6_SCALE, rate, 11)
        e_o = float((o.float() - o_p.float()).abs().max())
        e_l = float((lse - lse_p).abs().max())
        lim_o = min(TOL_K6_O, TOL_K6_O_REL * float(o_p.float().abs().max()))
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        print(f"[k6] {name} heads {heads} Sq {sq} Sk {sk} dropout {rate}: max|o - twin| {e_o:.3e} "
              f"(limit {lim_o:.3e} = min({TOL_K6_O}, {TOL_K6_O_REL} max|twin|)), max|lse - twin| "
              f"{e_l:.3e} (limit {TOL_K6_LSE}), |o| max {float(o_p.float().abs().max()):.3f}, "
              f"mean {float(o_p.float().abs().mean()):.4f}; second launch bitwise equal: {same}",
              flush=True)
        check(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()),
              f"K6 output not finite at {name}, dropout {rate}")
        check(e_o <= lim_o and e_l <= TOL_K6_LSE, f"K6 disagrees with its twin at {name}, "
              f"dropout {rate}")
        check(same, f"K6 is not bitwise repeatable at {name}, dropout {rate}")
        err_o, err_lse = max(err_o, e_o), max(err_lse, e_l)
        del o, lse, o2, lse2, o_p, lse_p

    # mask probe: q = 0 gives p = 1 everywhere (l = Sk), and row j of v is
    # 2^(j // 64) e_(j mod 64), so o[r, d] * Sk / bf16(1 / keep) is the sum
    # of 2^b over the kept keys 64 b + d of row r: four keep bits each
    heads, rows, sk, rate, seed = 16, 1000, 256, 0.1, 7
    q = torch.zeros((1, heads, rows, D_HEAD), dtype=torch.bfloat16, device="cuda")
    k = k6_inputs(rng, heads, 1, sk)[1]
    j = torch.arange(sk, device="cuda")
    v1 = torch.zeros((sk, D_HEAD), device="cuda")
    v1[j, j % D_HEAD] = 2.0 ** (j // D_HEAD).float()
    v = v1.to(torch.bfloat16).expand(1, heads, sk, D_HEAD).contiguous()
    thr, keep = fa.quantized_keep(rate)
    o = fa.flash_attention(q, k, v, 1.0, rate, seed)
    torch.cuda.synchronize()
    c = float(torch.tensor(1.0 / keep, dtype=torch.bfloat16))
    n = torch.round(o.float() * sk / c).long()  # [1, heads, rows, 64]
    decoded = torch.stack([(n >> b) & 1 for b in range(sk // D_HEAD)], dim=-2)
    decoded = decoded.reshape(heads, rows, sk).bool()
    want = torch.stack([fa.dropout_keep_mask(seed, bh, torch.arange(rows, device="cuda"), j, thr)
                        for bh in range(heads)])
    mismatched = int((decoded != want).sum())
    print(f"[k6] mask probe (dropout {rate}, seed {seed}, {heads} heads x {rows} rows x {sk} "
          f"keys): {mismatched} of {decoded.numel()} keep bits differ from the twin's hash; "
          f"kept share {float(decoded.float().mean()):.4f} (keep {keep:.4f})", flush=True)
    check(mismatched == 0, "K6's dropout mask differs from the twin's hash mask")

    clock = sm_clock_hz()
    timing = {}
    for name in ("c3", "rect"):
        q, k, v = inputs[name]
        heads, sq, sk = shapes[name]
        qs = q * torch.tensor(K6_SCALE, dtype=torch.bfloat16)

        def kernel():
            return fa.flash_attention_fwd(q, k, v, K6_SCALE)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qs, k, v, scale=1.0)

        ms, (dev, _) = cuda_ms(kernel, 20), device_ms(kernel, 20)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, K6_SCALE), 2)
        lib_ms, (lib_dev, backend) = cuda_ms(library, 20), device_ms(library, 20)
        floors = flash_floors_ms("K6", heads, sq, sk, False, clock)
        floor = max(floors, key=floors.get)
        b = floors[floor]
        flops = 4 * heads * sq * sk * D_HEAD
        print(f"[k6] {name} heads {heads} Sq {sq} Sk {sk}: kernel {ms:.4f} ms by events, {dev:.4f} "
              f"ms device time ({flops / dev * 1e-9:.1f} TFLOP/s, {b / dev:.2%} of the bound), "
              f"bound {b:.4f} ms ({floor}; floors "
              f"{', '.join(f'{f} {t:.4f}' for f, t in floors.items())}; SM clock "
              f"{clock * 1e-6:.0f} MHz), plain twin {plain_ms:.3f} ms, library "
              f"scaled_dot_product_attention {lib_ms:.4f} ms by events, {lib_dev:.4f} ms device "
              f"time; K6 / SDPA by device time {dev / lib_dev:.3f} [{backend}]", flush=True)
        timing[name] = {"ms": ms, "device_ms": dev, "plain_ms": plain_ms, "bound_ms": b,
                        "bound_by": "bytes" if floor == "hbm" else "operations",
                        "bound_floor": floor, "bound_ms_sfu": floors["sfu"], "library_ms": lib_ms,
                        "library_device_ms": lib_dev, "library_backend": backend,
                        "k6_over_library_device": dev / lib_dev}
    return {
        "name": "K6", "route": "cuda", "source": "tgtc_torch/csrc/flash_attention.cu",
        "replaces": "tgtc/ops/pallas/flash_attention.py:231",
        "wrapper": "tgtc_torch.ops.kernels.flash_attention.flash_attention_fwd",
        "shape": [C3_HEADS, C3_TOKENS, C3_TOKENS, D_HEAD],
        "max_abs_err": err_o, "max_err": err_o, "max_abs_err_lse": err_lse,
        "mask_probe_mismatches": mismatched, "sm_clock_mhz": clock * 1e-6,
        "library": "torch.nn.functional.scaled_dot_product_attention", **timing["c3"],
        "shape_rect": [C3_HEADS, C3_TOKENS, 4096, D_HEAD],
        **{f"{key}_rect": val for key, val in timing["rect"].items()},
    }


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max|a - ref| / max|ref|."""
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max())


def phase_c3(fa, geo_dir: str, root: str):
    """Phase C3 at full width on phase 5's views: timed frames (12 K6
    launches each), the frame against the same frame with the twin's
    attention, the f32 eager path read beside it, then stylize_all over
    C3_VIEWS views. Returns the launches of one frame, frames/s and seconds
    per view."""
    import shutil

    from PIL import Image

    import tgtc_torch.models.transformer as tr
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.train import stylize as st

    cfg = tr.TransformerConfig(dtype=torch.bfloat16, attn_impl="flash")
    model = make_stytrans(cfg, torch.Generator().manual_seed(21), device="cuda")
    img = st._load_rgb(os.path.join(geo_dir, "rgb_00000.png"))
    h, w = img.shape[:2]
    style_img = np.random.default_rng(22).uniform(0, 1, (512, 512, 3)).astype(np.float32)
    content = torch.from_numpy(st.pad_to_multiple(img))[None].cuda()
    style = torch.from_numpy(st.pad_to_multiple(st._resize(style_img, w, h)))[None].cuda()
    hp, wp = content.shape[1:3]  # 760 x 1008
    check((h, w) == (H, W) and (hp, wp) == (-(-H // 8) * 8, -(-W // 8) * 8),
          f"C3 content {tuple(content.shape)}")

    model.stylize(content, style)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(FRAMES):
        fa.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        im, hs = model.stylize(content, style)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = fa.flash_attention_fwd.launches
        check(launches == C3_SITES, f"C3 frame launched K6 {launches} times, not {C3_SITES}")
    peak = torch.cuda.max_memory_allocated()
    dt = float(np.median(times))
    print(f"[c3] StyTrans d_model 512, 8 heads, 3+3 layers, bf16, flash: frame {h}x{w} (padded "
          f"{hp}x{wp}, {hp * wp // 64} tokens), {FRAMES} frames after a "
          f"warm-up: {', '.join(f'{t * 1e3:.2f}' for t in times)} ms; median {dt * 1e3:.2f} ms, "
          f"{1 / dt:.3f} frames/s; K6 launches per frame {launches}; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    check(im.shape == (1, hp, wp, 3) and hs.shape == (1, hp // 8, wp // 8, 512),
          "C3 output shapes")
    check(bool(torch.isfinite(im).all() and torch.isfinite(hs).all()), "C3 output not finite")

    # the same frame with the attention through the twin on the card
    kernel = tr.flash_attention
    tr.flash_attention = fa.flash_attention_plain
    try:
        im_t, hs_t = model.stylize(content, style)
    finally:
        tr.flash_attention = kernel
    torch.cuda.synchronize()
    e_im, e_hs = rel_err(im, im_t), rel_err(hs, hs_t)
    print(f"[c3] vs the same frame with the twin's attention: max|d|/max|ref| image {e_im:.3e}, "
          f"hs {e_hs:.3e} (bound {TOL_C3})", flush=True)
    check(e_im <= TOL_C3 and e_hs <= TOL_C3, "C3 frame disagrees with the twin-attention frame")
    del im_t, hs_t

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eager = make_stytrans(tr.TransformerConfig(), device="cuda")
    eager.load_state_dict(model.state_dict())
    im_f, hs_f = eager.stylize(content, style)
    torch.cuda.synchronize()
    print(f"[c3] read, not held: bf16 flash frame vs the f32 eager frame (TF32 off): "
          f"max|d|/max|f32| image {rel_err(im, im_f):.3e}, hs {rel_err(hs, hs_f):.3e}",
          flush=True)
    del eager, im_f, hs_f

    # a bulk pass of fern's size: phase 5's views repeated under new names,
    # so that the first and last views weigh as little as in a real scene
    dumped = sorted(f for f in os.listdir(geo_dir) if f.startswith("rgb_"))
    content_dir, out = os.path.join(root, "c3_views"), os.path.join(root, "stylized")
    os.makedirs(content_dir)
    views = [f"rgb_{i:05d}.png" for i in range(C3_VIEWS)]
    for i, name in enumerate(views):
        shutil.copyfile(os.path.join(geo_dir, dumped[i % len(dumped)]),
                        os.path.join(content_dir, name))
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    res = st.stylize_all(model, content_dir, [style_img], ["style_00.png"], out, device="cuda")
    loop_s = time.perf_counter() - t0
    loop_launches = fa.flash_attention_fwd.launches
    jpgs = [os.path.join(out, f"{i + 1:03d}.jpg") for i in range(len(views))]
    sizes = [Image.open(p).size for p in jpgs if os.path.exists(p)]
    z = np.load(os.path.join(out, "stylized_data.npz"), allow_pickle=True)
    feats = z["style_features"]
    print(f"[c3] stylize_all over {len(views)} views ({len(dumped)} dumped views repeated): "
          f"{loop_s:.3f} s, {loop_s / len(views):.3f} s "
          f"per view with the JPEG writes; {len(sizes)} of {len(jpgs)} JPEGs at {W}x{H}: "
          f"{all(s == (W, H) for s in sizes)}; npz {sorted(z.files)}, style_features "
          f"{feats.shape} finite {bool(np.isfinite(feats).all())}; K6 launches {loop_launches}",
          flush=True)
    check(len(sizes) == len(jpgs) and all(s == (W, H) for s in sizes), "C3 JPEGs missing or "
          "of the wrong size")
    check(sorted(z.files) == ["style_features", "style_images", "style_names", "style_paths"],
          f"stylized_data.npz keys {z.files}")
    check(feats.shape == (1, 1024) and bool(np.isfinite(feats).all())
          and np.array_equal(feats, res["style_features"]), "style_features")
    check(loop_launches == C3_SITES * len(views), f"stylize_all launched K6 {loop_launches} times")
    return launches, 1 / dt, loop_s / len(views)


def k78_inputs(rng: np.random.Generator, batch: int, heads: int, sq: int, sk: int):
    """bf16 q, dO [batch, heads, sq, 64] and k, v [batch, heads, sk, 64] on the card."""
    return tuple(torch.from_numpy(rng.standard_normal((batch, heads, n, D_HEAD))
                                  .astype(np.float32)).to("cuda", torch.bfloat16)
                 for n in (sq, sk, sk, sq))


def device_ms(fn, iters: int, per_kernel: bool = False):
    """``fn``'s device time per call and the names of its kernels (and
    memsets), from the profiler over ``iters`` calls after one warm-up. Host
    time between kernels is not counted. A window can lose launches (seen on
    the card: the last of five calls' kernels in most windows, or two of five
    of K4's in every window of phase 6), so each window starts and ends with
    short spin kernels that are left out, and a window counts whole only
    where every kernel was recorded a multiple of ``iters`` times: then the
    time is the sum over ``iters``. After three windows that are not whole,
    the time is each kernel's mean recorded duration times its launches per
    call (its count over ``iters``, rounded up), and that is printed. A
    window that recorded nothing at all is a failure. With ``per_kernel``,
    also each kernel's (or memset's) device time per call, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(2000)
            for _ in range(iters):
                fn()
            for _ in range(4):
                torch.cuda._sleep(2000)
            torch.cuda.synchronize()
        durations = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us() * 1e-3)
        names = "; ".join(sorted({n[:80] for n in durations}))
        if durations and all(len(d) % iters == 0 for d in durations.values()):
            total = sum(sum(d) for d in durations.values()) / iters
            if per_kernel:
                return total, names, {n[:60]: sum(d) / iters for n, d in durations.items()}
            return total, names
        print(f"[profiler] window {attempt + 1} recorded "
              f"{sum(len(d) for d in durations.values())} device kernels of {len(durations)} "
              f"names over {iters} calls, not a whole number a call", flush=True)
    check(bool(durations), "the profiler recorded no device kernel")
    each = {n[:60]: math.ceil(len(d) / iters) * sum(d) / len(d) for n, d in durations.items()}
    total = sum(each.values())
    print(f"[profiler] taking each kernel's mean recorded duration times its launches per call: "
          f"{total:.4f} ms", flush=True)
    return (total, names, each) if per_kernel else (total, names)


def sdpa_bwd(q, k, v, do, iters: int):
    """The library's attention on the same tensors (scale 1 on the
    prescaled q, dropout 0), with autograd on: the forward's and the
    backward's (dq, dk and dv from one saved forward) device times per call
    from the profiler, and the backward's kernels."""
    qs = (q * torch.tensor(K6_SCALE, dtype=torch.bfloat16)).detach().requires_grad_()
    kk, vv = k.detach().requires_grad_(), v.detach().requires_grad_()

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(qs, kk, vv, scale=1.0)

    out = fwd()
    fwd_ms, _ = device_ms(fwd, iters)
    bwd_ms, backend = device_ms(
        lambda: torch.autograd.grad(out, (qs, kk, vv), do, retain_graph=True), iters)
    return fwd_ms, bwd_ms, backend


def phase_k78(fa):
    """K7/K8 against their twins at the C1 shape (dropout 0 and 0.1), the
    rectangular C3 shape, a ragged one and two that cut the 128-row blocks
    (dropout 0 and 0.25), a second launch bitwise equal, and the
    projections' [B, S, H, D] layout seen through a transpose bitwise equal
    to the contiguous case; K6 at the C1 shape with dropout; timings (CUDA
    events and the profiler's device time) beside the four-floor bounds, the
    twins and SDPA. Returns the K7 and K8 rows and K6's C1 readings."""
    rng = np.random.default_rng(5)
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")  # drawn on the card in C1
    cases = (("c1", (C1_BATCH, C3_HEADS, C1_TOKENS, C1_TOKENS), 0.0),
             ("c1", (C1_BATCH, C3_HEADS, C1_TOKENS, C1_TOKENS), C1_RATE),
             ("rect", (1, C3_HEADS, C3_TOKENS, 4096), 0.0),
             ("ragged", (1, 16, 300, 180), 0.0),
             ("cut", (1, 4, 200, 130), 0.0), ("cut", (1, 4, 200, 130), 0.25),
             ("cut2", (1, 2, 1000, 1030), 0.0), ("cut2", (1, 2, 1000, 1030), 0.25))
    err = {"K7": 0.0, "K8": 0.0}
    inputs = {}
    for name, (b, heads, sq, sk), rate in cases:
        if name not in inputs:
            inputs[name] = k78_inputs(rng, b, heads, sq, sk)
        q, k, v, do = inputs[name]
        o, lse = fa.flash_attention_fwd(q, k, v, K6_SCALE, rate, seed)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, K6_SCALE, rate, seed)
        dq, (dk, dv) = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)
        dq2, (dk2, dv2) = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)
        torch.cuda.synchronize()
        tq = fa.flash_attention_bwd_dq_plain(*args)
        tk, tv = fa.flash_attention_bwd_dkv_plain(*args)
        same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
        parts = []
        for what, got, want in (("dq", dq, tq), ("dk", dk, tk), ("dv", dv, tv)):
            e = float((got.float() - want.float()).abs().max())
            lim = TOL_K78_REL * float(want.float().abs().max())
            parts.append(f"{what} {e:.3e} (limit {lim:.3e})")
            check(bool(torch.isfinite(got.float()).all()), f"K7/K8 {what} not finite at {name}")
            check(e <= lim, f"K7/K8 {what} disagrees with its twin at {name}, dropout {rate}")
            kname = "K7" if what == "dq" else "K8"
            err[kname] = max(err[kname], e)
        print(f"[k78] {name} batch {b} heads {heads} Sq {sq} Sk {sk} dropout {rate}: max|kernel - "
              f"twin| {', '.join(parts)} (limits {TOL_K78_REL} max|twin|); second launches "
              f"bitwise equal: {same}", flush=True)
        check(same, f"K7/K8 are not bitwise repeatable at {name}")
        if name == "cut":  # the projections' layout, as the transformer feeds it
            views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v, do)]
            vargs = (*views, lse, delta, K6_SCALE, rate, seed)
            dq_v, (dk_v, dv_v) = fa.flash_attention_bwd_dq(*vargs), fa.flash_attention_bwd_dkv(*vargs)
            torch.cuda.synchronize()
            same_v = torch.equal(dq, dq_v) and torch.equal(dk, dk_v) and torch.equal(dv, dv_v)
            print(f"[k78] {name} dropout {rate}: [B, S, H, D] inputs seen through a transpose "
                  f"bitwise equal to the contiguous case: {same_v}", flush=True)
            check(same_v, f"K7/K8 differ on transposed views at {name}, dropout {rate}")
        del o, lse, delta, dq, dk, dv, dq2, dk2, dv2, tq, tk, tv

    # K6 at the C1 shape with dropout: no path launched it with dropout before C1
    q, k, v, do = inputs["c1"]
    o, lse = fa.flash_attention_fwd(q, k, v, K6_SCALE, C1_RATE, seed)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, K6_SCALE, C1_RATE, seed)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, K6_SCALE, C1_RATE, seed)
    e_o, e_l = float((o.float() - o_p.float()).abs().max()), float((lse - lse_p).abs().max())
    lim_o = min(TOL_K6_O, TOL_K6_O_REL * float(o_p.float().abs().max()))
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    print(f"[k78] K6 at the C1 shape, dropout {C1_RATE}: max|o - twin| {e_o:.3e} (limit "
          f"{lim_o:.3e}), max|lse - twin| {e_l:.3e} (limit {TOL_K6_LSE}); second launch bitwise "
          f"equal: {same}", flush=True)
    check(e_o <= lim_o and e_l <= TOL_K6_LSE and same, "K6 with dropout disagrees with its twin")
    del o2, lse2, o_p, lse_p

    clock = sm_clock_hz()
    bh = C1_BATCH * C3_HEADS
    times = {}  # rate -> kernel -> (event ms, device ms, twin ms)
    for rate in (C1_RATE, 0.0):
        o, lse = fa.flash_attention_fwd(q, k, v, K6_SCALE, rate, seed)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, K6_SCALE, rate, seed)
        calls = {"K6": (lambda: fa.flash_attention_fwd(q, k, v, K6_SCALE, rate, seed),
                        lambda: fa.flash_attention_fwd_plain(q, k, v, K6_SCALE, rate, seed)),
                 "K7": (lambda: fa.flash_attention_bwd_dq(*args),
                        lambda: fa.flash_attention_bwd_dq_plain(*args)),
                 "K8": (lambda: fa.flash_attention_bwd_dkv(*args),
                        lambda: fa.flash_attention_bwd_dkv_plain(*args))}
        times[rate] = {name: (cuda_ms(fn, 20), device_ms(fn, 20)[0], cuda_ms(plain, 2))
                       for name, (fn, plain) in calls.items()}
    lib_fwd, lib_bwd, backend = sdpa_bwd(q, k, v, do, 20)
    bounds = {rate: {name: flash_bound_ms(name, bh, C1_TOKENS, C1_TOKENS, rate > 0, clock)
                     for name in ("K6", "K7", "K8")}
              for rate in (C1_RATE, 0.0)}
    for name in ("K6", "K7", "K8"):
        for rate in (C1_RATE, 0.0):
            ms, dev, plain = times[rate][name]
            bnd, floor = bounds[rate][name]
            print(f"[k78] {name} at the C1 shape, dropout {rate}: kernel {ms:.4f} ms by events, "
                  f"{dev:.4f} ms device time ({bnd / dev:.2%} of the bound), bound {bnd:.4f} ms "
                  f"({floor}; SM clock {clock * 1e-6:.0f} MHz), plain twin {plain:.3f} ms",
                  flush=True)
    k78_dev = times[0.0]["K7"][1] + times[0.0]["K8"][1]
    print(f"[k78] library at the C1 shape, dropout 0, autograd on, device time of its kernels "
          f"(profiler): scaled_dot_product_attention forward {lib_fwd:.4f} ms (K6 / SDPA "
          f"{times[0.0]['K6'][1] / lib_fwd:.2f}), backward {lib_bwd:.4f} ms (dq, dk and dv; K7 + K8 "
          f"{k78_dev:.4f} ms device time, (K7 + K8) / SDPA backward {k78_dev / lib_bwd:.2f}) "
          f"[backward: {backend}]", flush=True)

    q, k, v, do = inputs["rect"]
    o, lse = fa.flash_attention_fwd(q, k, v, K6_SCALE)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, K6_SCALE)
    rect = {"K7": fa.flash_attention_bwd_dq, "K8": fa.flash_attention_bwd_dkv}
    rect = {name: (cuda_ms(lambda: fn(*args), 10), device_ms(lambda: fn(*args), 10)[0])
            for name, fn in rect.items()}
    plain_rect = {"K7": cuda_ms(lambda: fa.flash_attention_bwd_dq_plain(*args), 1),
                  "K8": cuda_ms(lambda: fa.flash_attention_bwd_dkv_plain(*args), 1)}
    _, lib_rect, _ = sdpa_bwd(q, k, v, do, 10)
    b_rect = {name: flash_bound_ms(name, C3_HEADS, C3_TOKENS, 4096, False, clock)
              for name in ("K7", "K8")}
    rect_dev = rect["K7"][1] + rect["K8"][1]
    print(f"[k78] at {C3_HEADS} heads x {C3_TOKENS} x 4096: K7 {rect['K7'][0]:.3f} ms by events, "
          f"{rect['K7'][1]:.3f} ms device time (bound {b_rect['K7'][0]:.3f}, {b_rect['K7'][1]}; "
          f"twin {plain_rect['K7']:.3f}), K8 {rect['K8'][0]:.3f} ms, {rect['K8'][1]:.3f} ms "
          f"(bound {b_rect['K8'][0]:.3f}, {b_rect['K8'][1]}; twin {plain_rect['K8']:.3f}); SDPA "
          f"backward {lib_rect:.3f} ms device time, (K7 + K8) / SDPA {rect_dev / lib_rect:.2f}",
          flush=True)
    rows = []
    for name, call_line in (("K7", 261), ("K8", 281)):
        ms, dev, plain = times[C1_RATE][name]
        bnd, floor = bounds[C1_RATE][name]
        bnd0, floor0 = bounds[0.0][name]
        rows.append({
            "name": name, "route": "cuda", "source": "tgtc_torch/csrc/flash_attention.cu",
            "replaces": f"tgtc/ops/pallas/flash_attention.py:{call_line}",
            "wrapper": ("tgtc_torch.ops.kernels.flash_attention." +
                        ("flash_attention_bwd_dq" if name == "K7" else "flash_attention_bwd_dkv")),
            "shape": [C1_BATCH, C3_HEADS, C1_TOKENS, C1_TOKENS, D_HEAD], "dropout": C1_RATE,
            "max_abs_err": err[name], "max_err": err[name],
            "ms": ms, "device_ms": dev, "ms_no_dropout": times[0.0][name][0],
            "device_ms_no_dropout": times[0.0][name][1], "plain_ms": plain,
            "bound_ms": bnd, "bound_by": "bytes" if floor == "hbm" else "operations",
            "bound_floor": floor,
            "bound_ms_no_dropout": bnd0, "bound_floor_no_dropout": floor0,
            "sm_clock_mhz": clock * 1e-6,
            "library_ms": lib_bwd,
            "library": "scaled_dot_product_attention backward (dq, dk, dv), device time "
                       "from the profiler",
            "library_backend": backend, "k7_k8_over_library_no_dropout": k78_dev / lib_bwd,
            "shape_rect": [C3_HEADS, C3_TOKENS, 4096, D_HEAD], "ms_rect": rect[name][0],
            "device_ms_rect": rect[name][1], "plain_ms_rect": plain_rect[name],
            "bound_ms_rect": b_rect[name][0], "bound_floor_rect": b_rect[name][1],
            "library_ms_rect": lib_rect, "k7_k8_over_library_rect": rect_dev / lib_rect,
        })
    k6_c1 = {"ms_c1": times[C1_RATE]["K6"][0], "device_ms_c1": times[C1_RATE]["K6"][1],
             "ms_c1_no_dropout": times[0.0]["K6"][0],
             "device_ms_c1_no_dropout": times[0.0]["K6"][1],
             "plain_ms_c1": times[C1_RATE]["K6"][2], "bound_ms_c1": bounds[C1_RATE]["K6"][0],
             "bound_floor_c1": bounds[C1_RATE]["K6"][1],
             "bound_ms_c1_no_dropout": bounds[0.0]["K6"][0],
             "bound_floor_c1_no_dropout": bounds[0.0]["K6"][1],
             "max_abs_err_c1_dropout": e_o, "library_ms_c1": lib_fwd}
    return rows, k6_c1


def write_styles(root: str, n: int = 8) -> str:
    """``n`` seeded 512x512 style PNGs of smoothed noise (numpy seed 23)."""
    from PIL import Image

    os.makedirs(root)
    rng = np.random.default_rng(23)
    for i in range(n):
        x = rng.uniform(0, 255, (16, 16, 3)).astype(np.uint8)
        Image.fromarray(x).resize((512, 512), Image.BILINEAR).save(
            os.path.join(root, f"style_{i:02d}.png"))
    return root


def c1_grad_agreement(names, got, ref):
    """``(cosine of all leaves together, the worst leaf's |got - ref| /
    max(|ref|, median leaf |ref|) as (value, name), the three lowest leaf
    cosines as text)``."""
    a = torch.cat([g.double().flatten() for g in got])
    b = torch.cat([g.double().flatten() for g in ref])
    norms = [float(g.double().norm()) for g in ref]
    median = float(np.median(norms))
    leaf = max((float((x.double() - y.double()).norm()) / max(nrm, median), n)
               for n, x, y, nrm in zip(names, got, ref, norms))
    cos = sorted((grad_cos(x, y), n, nrm / median) for n, x, y, nrm in zip(names, got, ref, norms))
    lows = ", ".join(f"{n} {c:.5f} ({r:.2e})" for c, n, r in cos[:3])
    return grad_cos(a, b), leaf, lows


def attn_leaf_errors(names, got, ref):
    """``|got - ref| / |ref|`` of each row block of the attention
    projections that only K7's dq or K8's dk or dv feeds: the q and k rows
    of ``qk``, ``qkv`` and ``in_proj_weight``, the v rows of
    ``in_proj_weight``, the q and v rows of ``in_proj_bias`` (its k rows have
    no gradient in exact arithmetic). The largest first, as (value, name)."""
    blocks = {".qk.": "qk", ".qkv.": "qk", ".in_proj_weight": "qkv", ".in_proj_bias": "qv"}
    out = []
    for n, x, y in zip(names, got, ref):
        parts = next((p for key, p in blocks.items() if key in n), "")
        d = x.shape[0] // (2 if ".qk." in n else 3)
        for part in parts:
            i = "qkv".index(part)
            a, b = x[i * d: (i + 1) * d].double(), y[i * d: (i + 1) * d].double()
            err, nrm = float((a - b).norm()), float(b.norm())
            out.append((err / nrm if nrm else (0.0 if err == 0 else math.inf), f"{n}[{part}]"))
    return sorted(out, reverse=True)


def phase_c1(fa, geo_dir: str, root: str):
    """Phase C1 at full width through tools/train2d's transformer task,
    then the fixed-batch witnesses. Returns the counted run's launches, its
    steps/s and the collages it wrote."""
    import shutil

    import tgtc_torch.models.transformer as tr
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.tools import train2d
    from tgtc_torch.train import transformer2d as t2

    content = os.path.join(root, "c1_content")
    os.makedirs(content)
    for f in sorted(os.listdir(geo_dir)):
        if f.startswith("rgb_"):
            shutil.copyfile(os.path.join(geo_dir, f), os.path.join(content, f))
    styles = write_styles(os.path.join(root, "c1_styles"))
    save, log = os.path.join(root, "c1_save"), os.path.join(root, "c1_log")
    argv = ["--task", "transformer", "--nerf_content_dir", content, "--style_dir", styles,
            "--save_dir", save, "--log_dir", log, "--print_interval", str(C1_PRINT),
            "--save_model_interval", "1000", "--vgg", "", "--decoder", "", "--seed", "21",
            "--n_threads", "8"]
    counters = {"K6": fa.flash_attention_fwd, "K7": fa.flash_attention_bwd_dq,
                "K8": fa.flash_attention_bwd_dkv}
    t0 = time.perf_counter()
    check(train2d.main(argv + ["--max_iter", str(C1_WARM)], device="cuda") == 0, "C1 warm-up")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    total = C1_WARM + C1_STEPS
    check(train2d.main(argv + ["--max_iter", str(total)], device="cuda") == 0, "C1 counted run")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    collages = len([s for s in range(C1_WARM + 1, total + 1) if s % 100 == 0 or s == total])
    with open(os.path.join(log, "transformer.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    counted = [r for r in records if r["step"] > C1_WARM]
    ends = [C1_WARM] + [r["step"] for r in counted]
    sizes = np.diff(ends)
    loop_s = float(sum(n / r["steps_per_s"] for n, r in zip(sizes, counted)))
    steps_per_s = float(sizes.sum()) / loop_s
    ckpt = os.path.join(save, "transformer", f"ckpt_{total:08d}.pt")
    pngs = [os.path.join(log, f"{s}.png") for s in (C1_WARM, 100, total)]
    print(f"[c1] StyTrans d_model 512, 8 heads, 3+3 layers, FFN 2048, dropout {C1_RATE}, bf16, "
          f"flash, random VGG and decoder; batch {C1_BATCH} of 256x256 crops from "
          f"{len(os.listdir(content))} renders and 8 styles: {C1_WARM} warm-up steps in "
          f"{warm_s:.2f} s (call, build and set-up included), then {C1_STEPS} steps in "
          f"{run_s:.2f} s (call, restore and the final save included), of which the loop "
          f"{loop_s:.3f} s: {steps_per_s:.3f} steps/s ({1e3 / steps_per_s:.2f} ms a step); per "
          f"log window (steps: steps/s) "
          + ", ".join(f"{n}: {r['steps_per_s']:.3f}" for n, r in zip(sizes, counted))
          + f"; launches K6 {launches['K6']} K7 {launches['K7']} K8 {launches['K8']} (expect "
          f"{C1_SITES * C1_STEPS} + {C3_SITES} x {collages} collages, {C1_SITES * C1_STEPS}, "
          f"{C1_SITES * C1_STEPS}); loss {records[0]['loss']:.4f} at step {records[0]['step']} "
          f"-> {records[-1]['loss']:.4f} at step {records[-1]['step']}", flush=True)
    check(launches == {"K6": C1_SITES * C1_STEPS + C3_SITES * collages,
                       "K7": C1_SITES * C1_STEPS, "K8": C1_SITES * C1_STEPS},
          f"C1 launch counts {launches}")
    check(int(sizes.sum()) == C1_STEPS, f"the log windows cover {sizes.sum()} steps")
    check(all(math.isfinite(r[k]) for r in records
              for k in ("loss", "loss_c", "loss_s", "l_id1", "l_id2")), "C1 losses not finite")
    check(os.path.exists(ckpt) and all(os.path.exists(p) for p in pngs),
          "C1 checkpoint or collage PNGs missing")

    # the fixed-batch witnesses, from the counted run's trained state
    cfg = tr.TransformerConfig(dtype=torch.bfloat16, attn_impl="flash")
    tcfg = t2.TransformerTrainConfig()
    model = make_stytrans(cfg, torch.Generator().manual_seed(21), device="cuda")
    state = t2.init_transformer_train(model, tcfg)
    state.load_state_dict(torch.load(ckpt, map_location="cuda", weights_only=True))
    rng = np.random.default_rng(24)
    batch = [torch.from_numpy(rng.integers(0, 256, (C1_BATCH, 256, 256, 3), dtype=np.uint8))
             .cuda() for _ in range(2)]
    step = t2.make_transformer_train_step(model, tcfg)
    names = [n for n, _ in t2.trained_parameters(model)]
    for c in counters.values():
        c.launches = 0
    m_k, g_k = step.loss_and_grad(model, *batch, step.generator(5, 0))
    torch.cuda.synchronize()
    step_launches = {n: c.launches for n, c in counters.items()}
    kernel = tr.flash_attention
    tr.flash_attention = fa.flash_attention_plain
    try:
        t0 = time.perf_counter()
        m_t, g_t = step.loss_and_grad(model, *batch, step.generator(5, 0))
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
    finally:
        tr.flash_attention = kernel
    dl = abs(float(m_k["loss"]) - float(m_t["loss"])) / abs(float(m_t["loss"]))
    cos_all, leaf, lows = c1_grad_agreement(names, g_k, g_t)
    attn = attn_leaf_errors(names, g_k, g_t)
    print(f"[c1] step {state.step}, one fixed batch and generator: launches in the step K6 "
          f"{step_launches['K6']} K7 {step_launches['K7']} K8 {step_launches['K8']}; vs the same "
          f"step with the twins' attention on the card ({twin_s:.2f} s): loss "
          f"{float(m_k['loss']):.6f} vs {float(m_t['loss']):.6f} (relative {dl:.3e}, limit "
          f"{TOL_C1_LOSS}); over {len(names)} trained leaves: cosine of the whole gradient "
          f"{cos_all:.7f} (limit {TOL_C1_COS}), worst leaf |err| / max(|g|, median leaf |g|) "
          f"{leaf[0]:.3e} ({leaf[1]}, limit {TOL_C1_LEAF}); lowest leaf cosines (|g| / median "
          f"|g|): {lows}; {len(attn)} attention projection leaves, |err| / |g| (limit "
          f"{TOL_C1_ATTN_LEAF}), the largest: "
          + ", ".join(f"{n} {e:.3e}" for e, n in attn[:4]), flush=True)
    check(step_launches == {"K6": C1_SITES, "K7": C1_SITES, "K8": C1_SITES},
          f"one C1 step launched {step_launches}")
    check(dl <= TOL_C1_LOSS, "C1 step loss disagrees with the twin-attention step")
    check(cos_all >= TOL_C1_COS and leaf[0] <= TOL_C1_LEAF,
          "C1 step gradient disagrees with the twin-attention step")
    check(bool(attn) and attn[0][0] <= TOL_C1_ATTN_LEAF,
          f"C1 attention leaf gradient disagrees with the twin-attention step: {attn[:1]}")
    del g_k, g_t

    # at dropout 0 against the eager f32 "xla" step, the same weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads = {}
    for key, mcfg in (("bf16 flash", dataclasses.replace(cfg, dropout=0.0)),
                      ("bf16 xla", tr.TransformerConfig(dtype=torch.bfloat16, dropout=0.0)),
                      ("f32 xla", tr.TransformerConfig(dropout=0.0))):
        m = make_stytrans(mcfg, device="cuda")
        m.load_state_dict(model.state_dict())
        t2.init_transformer_train(m, tcfg)
        grads[key] = t2.make_transformer_train_step(m, tcfg).loss_and_grad(m, *batch, None)
        del m
    (m_b, g_b), (m_x, g_x), (m_f, g_f) = grads["bf16 flash"], grads["bf16 xla"], grads["f32 xla"]
    cos_all, leaf, lows = c1_grad_agreement(names, g_b, g_f)
    cos_x, leaf_x, lows_x = c1_grad_agreement(names, g_x, g_f)
    print(f"[c1] dropout 0, vs the eager f32 xla step (TF32 off), loss {float(m_f['loss']):.6f}: "
          f"the bf16 flash step loss {float(m_b['loss']):.6f}, cosine of the whole gradient "
          f"{cos_all:.7f} (limit {TOL_C1_F32_COS}), worst leaf |err| / max(|g|, median leaf |g|) "
          f"{leaf[0]:.3e} ({leaf[1]}; limit {TOL_C1_F32_RATIO} x the eager bf16 xla step's + "
          f"{TOL_C1_F32_ADD}), lowest leaf cosines {lows}; the eager bf16 xla step: loss "
          f"{float(m_x['loss']):.6f}, {cos_x:.7f}, {leaf_x[0]:.3e} ({leaf_x[1]}), {lows_x}",
          flush=True)
    check(cos_all >= TOL_C1_F32_COS
          and leaf[0] <= TOL_C1_F32_RATIO * leaf_x[0] + TOL_C1_F32_ADD,
          "C1 bf16 flash step gradient disagrees with the f32 step")
    del grads, g_b, g_x, g_f

    # overfit one fixed batch
    fresh = t2.init_transformer_train(
        make_stytrans(cfg, torch.Generator().manual_seed(21), device="cuda"), tcfg)
    step = t2.make_transformer_train_step(fresh.model, tcfg)
    losses = []
    for _ in range(C1_OVERFIT):
        fresh, m = step(fresh, *batch, seed=6)
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"[c1] {C1_OVERFIT} steps on one fixed batch: mean loss of the first 5 {first:.5f}, of "
          f"the last 5 {last:.5f}", flush=True)
    check(all(math.isfinite(x) for x in losses) and last < first, "C1 overfit loss did not fall")
    return launches, steps_per_s, collages, ckpt, styles


def load_rgb(path: str, size=None) -> np.ndarray:
    """The pipeline's _load_image: RGB f32 in [0, 1], PIL-bilinear resized."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def grad_cosines(got, ref):
    return [grad_cos(a, b) for a, b in zip(got, ref)]


def phase_c2(fa, geo_dir: str, c1_ckpt: str, styles_dir: str, root: str):
    """Phase C2 at full width through train.temporal.run_temporal_finetune
    from phase 11's trained state, then the splat and step witnesses.
    Returns the finetuned model, the loop's K6/K7/K8 launches and its
    steps/s."""
    import tgtc_torch.models.transformer as tr
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.ops import rasterize as rz
    from tgtc_torch.train import temporal as tp

    cfg = tr.TransformerConfig(dtype=torch.bfloat16, attn_impl="flash")
    model = make_stytrans(cfg, torch.Generator().manual_seed(21), device="cuda")
    model.load_state_dict(torch.load(c1_ckpt, map_location="cuda", weights_only=True)["model"])
    geo = np.load(os.path.join(geo_dir, "geometry.npz"))
    coor_maps, cps = geo["coor_maps"], geo["cps"]
    renders = np.stack([load_rgb(os.path.join(geo_dir, f)) for f in sorted(os.listdir(geo_dir))
                        if f.startswith("rgb_")])
    style_files = sorted(os.listdir(styles_dir))
    styles = np.stack([load_rgb(os.path.join(styles_dir, f), (512, 512)) for f in style_files])
    ccfg = tp.TemporalTrainConfig()
    out = os.path.join(root, "c2")
    counters = {"K6": fa.flash_attention_fwd, "K7": fa.flash_attention_bwd_dq,
                "K8": fa.flash_attention_bwd_dkv}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    tp.run_temporal_finetune(model, renders, coor_maps, cps, styles, (H, W, FOCAL), ccfg,
                             seed=C2_SEED, is_ndc=True, out_dir=out, device="cuda",
                             log_every=C2_PRINT)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    with open(os.path.join(out, "logs", "temporal.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    counted = [r for r in records if r["step"] > C2_WARM]
    loop_s = float(sum(C2_PRINT / r["steps_per_s"] for r in counted))
    steps_per_s = C2_PRINT * len(counted) / loop_s
    moved = sorted({k.split(".")[0] for k, v in model.state_dict().items()
                    if not torch.equal(v, before[k])})
    pngs = [f"{n}_{b:03d}.png" for n in tp.DEBUG_IMAGES for b in range(ccfg.batch_size)]
    missing = [f for f in pngs + ["style_image.png"] if not os.path.exists(os.path.join(out, f))]
    print(f"[c2] StyTrans d_model 512, 8 heads, 3+3 layers, FFN 2048, dropout {C1_RATE}, bf16, "
          f"flash, from phase 11's state: {ccfg.max_iter} steps of batch {ccfg.batch_size} x "
          f"{ccfg.patch}x{ccfg.patch} patches of {renders.shape[0]} {H}x{W} renders, "
          f"{len(style_files)} 512x512 styles, temporal weight {ccfg.temporal_weight}, splat "
          f"radius {ccfg.splat_radius}, threshold {ccfg.space_dist_threshold}: {run_s:.2f} s "
          f"(call, set-up and the debug dumps included); steps {C2_WARM + 1}-{ccfg.max_iter} "
          f"in {loop_s:.3f} s over the log windows: {steps_per_s:.3f} steps/s "
          f"({1e3 / steps_per_s:.2f} ms a step); launches K6 {launches['K6']} K7 "
          f"{launches['K7']} K8 {launches['K8']} (expect {C1_SITES} x ({ccfg.max_iter} steps + "
          f"1 debug pass), 0, 0); loss {records[0]['loss']:.4f} at step {records[0]['step']} "
          f"-> {records[-1]['loss']:.4f}, loss_t {records[0]['loss_t']:.5f} -> "
          f"{records[-1]['loss_t']:.5f}; moved {moved}", flush=True)
    check(launches == {"K6": C1_SITES * (ccfg.max_iter + 1), "K7": 0, "K8": 0},
          f"C2 launch counts {launches}")
    check(len(counted) * C2_PRINT == ccfg.max_iter - C2_WARM,
          f"the log windows cover {len(counted) * C2_PRINT} steps")
    check(all(math.isfinite(r[k]) for r in records
              for k in ("loss", "loss_c", "loss_s", "loss_t", "l_id1", "l_id2"))
          and all(r["loss_t"] > 0 for r in records), "C2 losses not finite or loss_t not > 0")
    check(moved == ["decode"], f"C2 moved {moved}, not the decoder alone")
    check(not missing, f"C2 debug PNGs missing: {missing}")

    # the first step's batch again, for the witnesses
    dev_arrays = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
                  for a in (renders, coor_maps, cps, styles)]
    batch = tp.draw_batch(np.random.default_rng(C2_SEED), H, W, renders.shape[0],
                          styles.shape[0], styles.shape[1:3], ccfg)
    content, coor, cps_b, style = tp.gather_batch(batch, *dev_arrays, ccfg.patch)

    # the splat: card against CPU on the step's own point cloud and poses
    pcl = rz.ndc_to_world(coor, H, W, FOCAL)[0].reshape(-1, 3)
    feats = torch.cat([content[0].reshape(-1, 3), pcl], dim=-1)
    proj = torch.from_numpy(rz.llff_projection_matrix(H, W, FOCAL))
    w2c = torch.linalg.inv(cps_b.cpu())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    win = rz.splat_winners(pcl, w2c.cuda(), proj.cuda(), H, W, ccfg.splat_radius)
    torch.cuda.synchronize()
    splat_ms = (time.perf_counter() - t0) * 1e3
    win2 = rz.splat_winners(pcl, w2c.cuda(), proj.cuda(), H, W, ccfg.splat_radius)
    win_cpu = rz.splat_winners(pcl.cpu(), w2c, proj, H, W, ccfg.splat_radius)
    n = pcl.shape[0]
    hit, hit_cpu = win.cpu() < n, win_cpu < n
    same = win.cpu() == win_cpu
    mask_share = float((hit != hit_cpu).float().mean())
    warped = rz.gather_winners(feats, win)[0].cpu()
    warped_cpu = rz.gather_winners(feats.cpu(), win_cpu)[0]
    feats_equal = torch.equal(warped[same], warped_cpu[same])
    rgb_c, _, mask_c = rz.rasterize_warp(pcl, content[0].reshape(-1, 3), cps_b, proj.cuda(), H,
                                         W, ccfg.splat_radius)
    rgb_h, _, mask_h = rz.rasterize_warp(pcl.cpu(), content[0].reshape(-1, 3).cpu(),
                                         cps_b.cpu(), proj, H, W, ccfg.splat_radius)
    warp_share = float((mask_c.cpu() != mask_h).float().mean())
    own = rz.splat_winners(pcl, torch.linalg.inv(cps_b[:1]), proj.cuda(), H, W,
                           ccfg.splat_radius)[0]
    (y0, x0), p = batch.origin, ccfg.patch
    coverage = float((own[y0: y0 + p, x0: x0 + p] < n).float().mean())
    print(f"[c2] splat of the first step's cloud ({n} points, {ccfg.batch_size} views of "
          f"{H}x{W}, radius {ccfg.splat_radius}, one w2c): {splat_ms:.2f} ms on the card "
          f"(first call); card vs CPU: hit masks differ at {mask_share:.3e} of the pixels "
          f"(limit {TOL_SPLAT_MASK}), winners equal at {float(same.float().mean()):.6f}, warped "
          f"features equal where the winners are: {feats_equal}; a second card splat bitwise "
          f"equal: {torch.equal(win, win2)}; rasterize_warp with each device's own pose "
          f"inversion: masks differ at {warp_share:.3e}; view {int(batch.ids[0])}'s patch into "
          f"its own camera covers {coverage:.4f} of the patch (limit {TOL_OWN_VIEW})", flush=True)
    check(mask_share <= TOL_SPLAT_MASK and warp_share <= TOL_SPLAT_MASK,
          "the card's splat masks disagree with the CPU's")
    check(feats_equal, "warped features differ where the card and the CPU pick the same point")
    check(torch.equal(win, win2), "the card's splat does not repeat")
    check(coverage > TOL_OWN_VIEW, "the patch does not cover its own view")
    del rgb_c, rgb_h, mask_c, mask_h, warped, warped_cpu

    # one step with K6 against the same step with the twin's attention
    cam = tp.SplatCamera.llff(H, W, FOCAL, device="cuda")
    step = tp.make_temporal_train_step(model, ccfg, cam)
    args = (content, coor, cps_b, style, batch.origin)
    for c in counters.values():
        c.launches = 0
    m_k, g_k = step.loss_and_grad(model, *args, step.base.generator(C2_SEED + 4, 0))
    torch.cuda.synchronize()
    step_launches = {n: c.launches for n, c in counters.items()}
    kernel = tr.flash_attention
    tr.flash_attention = fa.flash_attention_plain
    try:
        m_t, g_t = step.loss_and_grad(model, *args, step.base.generator(C2_SEED + 4, 0))
        torch.cuda.synchronize()
    finally:
        tr.flash_attention = kernel
    m_r, g_r = step.loss_and_grad(model, *args, step.base.generator(C2_SEED + 4, 0))
    repeats = torch.equal(m_r["loss"], m_k["loss"]) and all(
        torch.equal(x, y) for x, y in zip(g_r, g_k))
    dl = abs(float(m_k["loss"]) - float(m_t["loss"])) / abs(float(m_t["loss"]))
    a = torch.cat([g.double().flatten() for g in g_k])
    b = torch.cat([g.double().flatten() for g in g_t])
    cos = grad_cos(a, b)
    lows = sorted(grad_cosines(g_k, g_t))[:3]
    print(f"[c2] one step, fixed batch and generator: launches K6 {step_launches['K6']} K7 "
          f"{step_launches['K7']} K8 {step_launches['K8']}; vs the same step with the twin's "
          f"attention on the card: loss {float(m_k['loss']):.6f} vs {float(m_t['loss']):.6f} "
          f"(relative {dl:.3e}, limit {TOL_C1_LOSS}), loss_t {float(m_k['loss_t']):.6f} vs "
          f"{float(m_t['loss_t']):.6f}; decoder gradient cosine {cos:.7f} (limit {TOL_C1_COS}), "
          f"lowest leaf cosines {', '.join(f'{c:.5f}' for c in lows)}; read, not held: the "
          f"same step again gives the same loss and decoder gradient bit for bit: {repeats}",
          flush=True)
    check(step_launches == {"K6": C1_SITES, "K7": 0, "K8": 0},
          f"one C2 step launched {step_launches}")
    check(dl <= TOL_C1_LOSS and cos >= TOL_C1_COS,
          "C2 step disagrees with the twin-attention step")
    del g_k, g_t, g_r, dev_arrays
    return model, launches, steps_per_s


def phase_c3c2(fa, model, geo_dir: str, styles_dir: str, root: str):
    """Phase C3 with phase 12's decoder over phase 5's views and all eight
    styles. Returns the launches, seconds per view and the style features."""
    from PIL import Image

    from tgtc_torch.train import stylize as st

    style_files = sorted(os.listdir(styles_dir))
    style_imgs = [load_rgb(os.path.join(styles_dir, f)) for f in style_files]
    views = sorted(f for f in os.listdir(geo_dir) if f.startswith("rgb_"))
    out = os.path.join(root, "stylized_c2")
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    res = st.stylize_all(model, geo_dir, style_imgs, style_files, out, device="cuda")
    loop_s = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    jpgs = [os.path.join(out, f"style_{s:02d}", f"{i + 1:03d}.jpg")
            for s in range(len(style_files)) for i in range(len(views))]
    sizes = [Image.open(p).size for p in jpgs if os.path.exists(p)]
    feats = res["style_features"]
    per_view = loop_s / len(jpgs)
    print(f"[c3c2] stylize_all with phase 12's decoder: {len(views)} views x "
          f"{len(style_files)} styles in {loop_s:.3f} s, {per_view:.4f} s per view and style with "
          f"the JPEG writes; {len(sizes)} of {len(jpgs)} JPEGs at {W}x{H}; style_features "
          f"{feats.shape} finite {bool(np.isfinite(feats).all())}; K6 launches {launches} "
          f"(expect {C3_SITES} x {len(jpgs)})", flush=True)
    check(len(sizes) == len(jpgs) and all(sz == (W, H) for sz in sizes),
          "C3 after C2: JPEGs missing or of the wrong size")
    check(feats.shape == (len(style_files), 1024) and bool(np.isfinite(feats).all()),
          "C3 after C2: style_features")
    check(launches == C3_SITES * len(jpgs), f"C3 after C2 launched K6 {launches} times")
    return launches, per_view, feats


def phase_d(ks, kst, trained, styles_dir: str, feats: np.ndarray, n_views: int, root: str):
    """Phase D: the VAE through tools/train2d's vae task at the pipeline's
    settings, the card step against the CPU step, the latent table seeded
    from phase 13's features, and a stylized frame rendered from it.
    Returns the VAE's steps/s and the frame's K4/K5 launches."""
    import contextlib

    from tgtc_torch.data.prefetch import load_crop
    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.vae import VaeConfig, make_vae
    from tgtc_torch.models.vgg import make_vgg
    from tgtc_torch.render.fast_style import FusedStyleRenderer
    from tgtc_torch.render.volume import RenderSettings
    from tgtc_torch.tools import train2d
    from tgtc_torch.train import vae_trainer as vt

    save, log = os.path.join(root, "d_save"), os.path.join(root, "d_log")
    argv = ["--task", "vae", "--style_dir", styles_dir, "--save_dir", save, "--log_dir", log,
            "--lr", "1e-3", "--lr_decay", "0", "--batch_size", "8", "--patch", "256",
            "--print_interval", "1", "--save_model_interval", "1000", "--vgg", "", "--seed",
            "21", "--n_threads", "8"]
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as a user's run has it
    quiet = open(os.path.join(root, "d_stdout.txt"), "w")
    t0 = time.perf_counter()
    with quiet, contextlib.redirect_stdout(quiet):  # one log line a step
        check(train2d.main(argv + ["--max_iter", str(D_WARM)], device="cuda") == 0,
              "VAE warm-up")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(train2d.main(argv + ["--max_iter", str(D_STEPS)], device="cuda") == 0,
              "VAE counted run")
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    with open(os.path.join(log, "vae.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    counted = [r for r in records if r["step"] > D_WARM]
    loop_s = float(sum(1 / r["steps_per_s"] for r in counted))
    steps_per_s = len(counted) / loop_s
    losses = [r["loss"] for r in records]
    first, last = float(np.mean(losses[:100])), float(np.mean(losses[-100:]))
    ckpt = os.path.join(save, "vae", f"ckpt_{D_STEPS:08d}.pt")
    print(f"[d] VAE 1024 -> 512 x3 -> 32 (kl 0.1, lr 1e-3, batch 8) on VGG relu4_1 features "
          f"of 256x256 crops of {len(os.listdir(styles_dir))} styles resized to 512: {D_WARM} "
          f"warm-up steps in {warm_s:.2f} s, then {D_STEPS - D_WARM} steps in {run_s:.2f} s "
          f"(call, restore and the final save included), of which the loop {loop_s:.3f} s: "
          f"{steps_per_s:.3f} steps/s ({1e3 / steps_per_s:.3f} ms a step, one log fetch a "
          f"step); mean loss of the first 100 steps {first:.4f}, of the last 100 {last:.4f}",
          flush=True)
    check(len(records) == D_STEPS and [r["step"] for r in records] == list(range(1, D_STEPS + 1)),
          "the VAE log does not hold every step")
    check(all(math.isfinite(x) for x in losses) and last < first, "the VAE loss did not fall")
    check(os.path.exists(ckpt), "the VAE checkpoint is missing")

    # one step on the card against the same step on the CPU, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vcfg, tcfg = VaeConfig(), vt.VaeTrainConfig()
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    vgg = make_vgg(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(25)
    paths = [os.path.join(styles_dir, f) for f in sorted(os.listdir(styles_dir))]
    crops = np.stack([load_crop(paths[i % len(paths)], rng, 256, 512) for i in range(8)])
    with torch.no_grad():
        x = vt.vgg_style_feature(vgg, torch.from_numpy(crops).cuda().float() / 255.0)
    eps = torch.randn((8, vcfg.latent_dim), generator=torch.Generator().manual_seed(26))
    steps = []
    for dev in ("cuda", "cpu"):
        vae = make_vae(vcfg, device=dev)
        vae.load_state_dict(sd)
        m, g = vt.make_vae_train_step(vae, tcfg).loss_and_grad(vae, x.to(dev), eps.to(dev))
        steps.append((float(m["loss"]), [t.cpu() for t in g]))
    (loss_card, g_card), (loss_cpu, g_cpu) = steps
    dl = abs(loss_card - loss_cpu) / abs(loss_cpu)
    cosines = grad_cosines(g_card, g_cpu)
    print(f"[d] one VAE step, card vs CPU (same x and eps, TF32 off): loss {loss_card:.7f} vs "
          f"{loss_cpu:.7f} (relative {dl:.3e}, limit {TOL_VAE_LOSS}); lowest gradient cosine "
          f"{min(cosines):.7f} (limit {TOL_VAE_COS})", flush=True)
    check(dl <= TOL_VAE_LOSS and min(cosines) >= TOL_VAE_COS,
          "the VAE step on the card disagrees with the CPU's")

    # the latent table from phase 13's style features
    vae = make_vae(vcfg, device="cuda")
    vae.load_state_dict(sd)
    f = torch.from_numpy(feats).cuda()
    eps = torch.randn((f.shape[0], n_views, vcfg.latent_dim),
                      generator=torch.Generator().manual_seed(27)).cuda()
    table = vt.seed_latents_from_features(vae, f, n_views, eps=eps)
    with torch.no_grad():
        mu, logvar = vae.encode(f)
    want = eps * torch.exp(0.5 * logvar[:, None]) + mu[:, None]
    lat = table["latents"]
    err = float((lat - want).abs().max())
    print(f"[d] latent table from phase 13's style_features {tuple(f.shape)}: "
          f"{tuple(lat.shape)}, finite {bool(torch.isfinite(lat).all())}, max|table - (eps "
          f"exp(logvar / 2) + mu)| {err:.3e}; |mu| mean {float(mu.abs().mean()):.4f}, std "
          f"exp(logvar / 2) mean {float(torch.exp(0.5 * logvar).mean()):.4f}", flush=True)
    check(lat.shape == (feats.shape[0], n_views, vcfg.latent_dim)
          and bool(torch.isfinite(lat).all()) and err == 0.0, "the seeded latent table")

    # a stylized frame of style 0 from the seeded table
    concat, style = style_mlps()
    settings = RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    renderer = FusedStyleRenderer.from_params(trained["coarse"], trained["fine"],
                                              concat.state_dict(), style.state_dict(), table,
                                              settings, coarse_rgb=False, device="cuda")
    ro, rd = rays_for_poses(H, W, trained["intrinsics"], trained["render_poses"][:1],
                            use_ndc=True, device="cuda")
    fo, fd = ro[0].reshape(-1, 3), rd[0].reshape(-1, 3)
    blocks = math.ceil(fo.shape[0] / BLOCK)
    counters = {"K1": ks.fused_nerf_apply_t, "K2": ks.fused_nerf_sigma_apply_t,
                "K4": kst.fused_style_apply_t, "K5": kst.fused_sigma_apply_t}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    frame = renderer.render_image(fo, fd, 0, 0, block=BLOCK, seed=F_SEED)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    print(f"[d] stylized {H}x{W} frame of style 0 from the seeded table: {frame_s * 1e3:.1f} ms "
          f"(first frame of this renderer), launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    check(launches == {"K1": 0, "K2": 0, "K4": blocks, "K5": blocks},
          f"seeded-latent frame launch counts {launches}")
    check(bool(torch.isfinite(frame["rgb"]).all()), "seeded-latent frame not finite")
    stylized_vs_eager(renderer, trained, concat, style, fo, fd, frame, "d",
                      "seeded-latent frame")
    return steps_per_s, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tgtc_torch.convert import nerf_state_dict_from_flax, style_state_dicts_from_flax
    from tgtc_torch.ops.kernels import _build
    from tgtc_torch.ops.kernels import flash_attention as fa
    from tgtc_torch.ops.kernels import nerf_mlp as ks
    from tgtc_torch.ops.kernels import nerf_mlp_grad as kg
    from tgtc_torch.ops.kernels import style_kernel as kst

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    libs = _build.build_all(sources)
    print(f"[build] torch {torch.__version__} CUDA {torch.version.cuda}; built "
          f"{', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:  # ptxas: registers, shared memory and spills per kernel
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "entry function", "warning",
                                               "(c75")):
                print(f"[build] {line.strip()}", flush=True)
    nerf_lib, style_lib = ks._nerf_lib(), kst._style_lib()
    print(f"[build] dynamic shared memory a block: K1 {nerf_lib.tgtc_nerf_mlp_fwd_smem()} B, "
          f"K2 {nerf_lib.tgtc_nerf_mlp_sigma_smem()} B, K4 {style_lib.tgtc_style_fwd_smem()} B, "
          f"K5 {style_lib.tgtc_style_sigma_smem()} B (the 1 KB alignment slack included)",
          flush=True)

    rng = np.random.default_rng(0)
    sd_c = nerf_state_dict_from_flax(he_params(rng))
    sd_f = nerf_state_dict_from_flax(he_params(rng))
    style_sds = style_state_dicts_from_flax(he_style_params(rng))

    rows = phase_kernels(ks, sd_c)
    renderer, launches, rays_per_s = phase_main_path(ks, sd_c, sd_f)
    for row in rows:
        row["launches"] = launches[row["name"]]
    rows.append(phase_k3(ks, kg, sd_c))
    trained_renderer, train_launches, steps_per_s, trained = phase_train(ks, kg)
    for row in rows:
        row["launches_train"] = train_launches[row["name"]]
        row["launches_per_step"] = train_launches[row["name"]] // TRAIN_STEPS
    rows[-1]["launches"] = train_launches["K3"]
    with tempfile.TemporaryDirectory() as tmp:
        geo_dir = phase_b(ks, trained_renderer, tmp)
        style_rows = phase_style_kernels(ks, kst, sd_c, style_sds)
        f_launches, f_rays_per_s, f_frames_per_min = phase_f(ks, kst, trained)
        for row in style_rows:  # on no training step: no launches_per_step
            row["launches"] = f_launches[row["name"]]
        rows += style_rows
        k6_row = phase_k6(fa)
        c3_launches, c3_frames_per_s, c3_s_per_view = phase_c3(fa, geo_dir, tmp)
        k78_rows, k6_c1 = phase_k78(fa)
        c1_launches, c1_steps_per_s, collages, c1_ckpt, styles = phase_c1(fa, geo_dir, tmp)
        model, c2_launches, c2_steps_per_s = phase_c2(fa, geo_dir, c1_ckpt, styles, tmp)
        c3c2_launches, c3c2_s_per_view, feats = phase_c3c2(fa, model, geo_dir, styles, tmp)
        del model
        n_views = len([f for f in os.listdir(geo_dir) if f.startswith("rgb_")])
        vae_steps_per_s, d_launches = phase_d(ks, kst, trained, styles, feats, n_views, tmp)
    # per C1 step of the counted run; K6 also ran once per site for each collage
    k6_row.update(k6_c1, launches=c3_launches, launches_c1=c1_launches["K6"],
                  launches_per_step=(c1_launches["K6"] - C3_SITES * collages) // C1_STEPS,
                  launches_c2=c2_launches["K6"], launches_c3c2=c3c2_launches)
    rows.append(k6_row)
    for row in k78_rows:
        row["launches"] = c1_launches[row["name"]]
        row["launches_per_step"] = c1_launches[row["name"]] // C1_STEPS
        row["launches_c2"] = c2_launches[row["name"]]
    rows += k78_rows
    for row in rows:  # the stylized frame from the seeded latents
        if row["name"] in ("K4", "K5"):
            row["launches_d"] = d_launches[row["name"]]

    print(f"[result] card {card}; frame {rays_per_s:.1f} rays/s; Phase A "
          f"{steps_per_s:.2f} steps/s; stylized frame {f_rays_per_s:.1f} rays/s; Phase F "
          f"{f_frames_per_min:.2f} frames/min; C3 {c3_frames_per_s:.3f} frames/s, "
          f"{c3_s_per_view:.3f} s per view with the JPEG writes ({C3_VIEWS} views); C1 "
          f"{c1_steps_per_s:.3f} steps/s; C2 {c2_steps_per_s:.3f} steps/s; C3 after C2 "
          f"{c3c2_s_per_view:.4f} s per view and style; VAE {vae_steps_per_s:.3f} steps/s",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
