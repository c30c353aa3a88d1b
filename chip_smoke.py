#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tgtc_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA source under tgtc_torch/csrc (one nvcc per source, all
started together), then:

0. prints the card (name, power limit), the torch/CUDA versions and the
   kernel build time;
1. kernels: runs K1/K2 on random full-width weights (He init, numpy seed
   0, D8/W256) at P = 2,097,152 + 300 against their plain PyTorch twins
   (rgb <= 3e-2, sigma <= 2e-1, K2 sigma == K1 sigma bit for bit) and times
   each at the main path's shapes (K1 P = 16384 rays x 128 samples, K2
   P = 16384 x 64) beside its bound, its twin and, for orientation only, the
   same layer chain as bf16 torch.addmm calls;
2. main path: renders a fern-shaped 756x1008 NDC frame with
   FusedNerfRenderer(coarse_rgb=False), 64+64 samples, 16384-ray blocks,
   three times after a warm-up frame; launch counts are zeroed just before
   each frame and must be 47 each; the first 16,384 rays are held against the eager
   f32 render_rays (TF32 off) to 5e-2 in rgb and t_exp, except rays whose
   last-sample f32 sigma lies within the sigma tolerance of 0 (a sign flip
   there moves the ray's weight onto the 1e10 last interval), of which at
   most 0.1% may differ;
3. K3: the backward kernel on the same He weights at P = 262,144 + 300
   with random cotangents (numpy seed 2) against its plain twin, per packed
   layer max|err| / max|twin| <= 2e-2 and cosine >= 0.999, and a second
   launch bitwise equal; timed at the training step's two shapes (P =
   2048 x 64 and 2048 x 128) beside its bound, its twin and, for
   orientation only, the same backward as bf16 autograd through the
   torch.addmm chain;
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
6. style kernels: K4/K5 on random fern-width weights (the K1/K2 trunk, He
   style MLPs, numpy seed 0) at P = 2,097,152 + 300 with per-point latents
   against their twins (rgb <= 3e-2, sigma <= 2e-1), with three sigmas
   bitwise equal (K5 and K4, K5 and K2 on the same trunk, two K4
   launches); then each held against its twin again (same bounds) on the
   stylized frame's arguments (K4 P = 16384 rays x 128 samples with
   per-ray latents, distinct random rows, K5 P = 16384 x 64) and timed
   there beside its bound, its twin and, for orientation only, the same
   chain as bf16 torch.addmm calls;
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
   0.125), at 11,970 x 4,096 and at a ragged 300 x 180 with 16 heads
   (max|o - twin| <= 1e-2 max|twin| and <= 3e-2, lse <= 1e-3), two
   launches bitwise equal; a mask probe with
   dropout 0.1, seed 7 (q = 0, Sk = 256, row j of v = 2^(j // 64)
   e_(j mod 64), so that each output element encodes four keep bits) whose
   decoded mask equals the twin's hash mask bit for bit over 16 heads and
   1,000 rows; K6 timed at both large shapes beside its bound, its twin and
   the library call (scaled_dot_product_attention with scale 1 on the
   prescaled q; the backend it took is printed);
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
   at 11,970 x 4,096 and at a ragged 300 x 180 with 16 heads: each of dq,
   dk, dv within 1e-2 max|twin|, two launches bitwise equal; K6 at the C1
   shape with dropout 0.1 against its twin (phase 8's bounds); K6, K7 and
   K8 timed at the C1 shape (dropout 0.1, the C1 path's, and 0) and K7/K8
   at 11,970 x 4,096 beside their bounds, their twins and the library call:
   the backward of scaled_dot_product_attention at dropout 0 on the same
   tensors (torch.autograd.grad of one saved forward, the device time of
   its kernels and memsets from the profiler; the kernels are printed);
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
12. prints the kernels line (JSON, K1-K8), then the result line.

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
    """Twin comparison at P = 2^21 + 300 and timings at the main path's shapes."""
    packed = ks.pack_nerf_params(sd_c, device="cuda")
    rng = np.random.default_rng(1)
    p = P_K1 + RAGGED
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, p)).astype(np.float32)).cuda()
    dirs = torch.from_numpy(rng.standard_normal((3, p)).astype(np.float32)).cuda()
    rgb, sigma = ks.fused_nerf_apply_t(packed, pts, dirs)
    sigma2 = ks.fused_nerf_sigma_apply_t(packed, pts)
    torch.cuda.synchronize()
    rgb_p, sigma_p = ks.fused_nerf_apply_t_plain(packed, pts, dirs)
    sigma2_p = ks.fused_nerf_sigma_apply_t_plain(packed, pts)
    err = {"K1": (float((rgb - rgb_p).abs().max()), float((sigma - sigma_p).abs().max())),
           "K2": (0.0, float((sigma2 - sigma2_p).abs().max()))}
    print(f"[kernels] P={p}: K1 max|rgb err| {err['K1'][0]:.3e} max|sigma err| "
          f"{err['K1'][1]:.3e}; K2 max|sigma err| {err['K2'][1]:.3e}; "
          f"|sigma| max {float(sigma_p.abs().max()):.3e}", flush=True)
    check(bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all()), "K1 output not finite")
    check(err["K1"][0] <= TOL_RGB and err["K1"][1] <= TOL_SIGMA, "K1 disagrees with its twin")
    check(err["K2"][1] <= TOL_SIGMA, "K2 disagrees with its twin")
    check(torch.equal(sigma, sigma2), "K2 sigma is not bitwise equal to K1 sigma")
    del rgb, sigma, sigma2, rgb_p, sigma_p, sigma2_p

    rows = []
    for name, fn, twin, n in (("K1", ks.fused_nerf_apply_t, ks.fused_nerf_apply_t_plain, P_K1),
                              ("K2", ks.fused_nerf_sigma_apply_t,
                               ks.fused_nerf_sigma_apply_t_plain, P_K2)):
        args = (packed, pts[:, :n].contiguous()) + ((dirs[:, :n].contiguous(),) if name == "K1" else ())
        ms = cuda_ms(lambda: fn(*args), 10)
        plain_ms = cuda_ms(lambda: twin(*args), 3)
        e_c = ks._encode_plain(args[1].T, 10, packed.k_coor).to(torch.bfloat16)
        e_d = (ks._encode_plain(args[2].T, 4, packed.k_dir).to(torch.bfloat16)
               if name == "K1" else None)
        chain_ms = cuda_ms(matmul_chain(packed, e_c, e_d, name == "K1"), 10)
        del e_c, e_d
        b = bound_ms(name, n, packed)
        print(f"[kernels] {name} P={n}: kernel {ms:.3f} ms, bound {b:.3f} ms "
              f"(operations), plain twin {plain_ms:.3f} ms, orientation only: "
              f"bf16 torch.addmm chain {chain_ms:.3f} ms", flush=True)
        rows.append({
            "name": name, "route": "cuda", "source": "tgtc_torch/csrc/nerf_mlp.cu",
            "replaces": ("tgtc/ops/pallas/nerf_mlp.py:359" if name == "K1"
                         else "tgtc/ops/pallas/nerf_mlp.py:316"),
            "wrapper": ("tgtc_torch.ops.kernels.nerf_mlp." +
                        ("fused_nerf_apply_t" if name == "K1" else "fused_nerf_sigma_apply_t")),
            "P": n, "max_abs_err": max(err[name]), "max_err": max(err[name]),
            "max_abs_err_rgb": err[name][0] if name == "K1" else None,
            "max_abs_err_sigma": err[name][1],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": "operations",
            "library_ms": None, "matmul_chain_ms": chain_ms,
        })
    return rows


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


def phase_k3(ks, kg, sd_c):
    """K3 against its twin at P = 262,144 + 300, a repeat launch bitwise
    equal, and timings at the training step's two shapes."""
    packed = ks.pack_nerf_params(sd_c, device="cuda")
    rng = np.random.default_rng(2)
    p = P_K3["fine"] + RAGGED
    arrs = (rng.uniform(-1, 1, (3, p)), rng.standard_normal((3, p)),
            rng.standard_normal((3, p)), rng.standard_normal((1, p)))
    pts, dirs, g_rgb, g_sig = (torch.from_numpy(a.astype(np.float32)).cuda() for a in arrs)
    dw, db = kg.fused_nerf_bwd(packed, pts, dirs, g_rgb, g_sig)
    dw2, db2 = kg.fused_nerf_bwd(packed, pts, dirs, g_rgb, g_sig)
    torch.cuda.synchronize()
    tw, tb = kg.fused_nerf_bwd_plain(packed, pts, dirs, g_rgb, g_sig)
    errs, max_abs = layer_errors(packed, dw, db, tw, tb)
    worst_rel, worst_cos = max(e[0] for e in errs), min(e[1] for e in errs)
    repeat = bool(torch.equal(dw, dw2) and torch.equal(db, db2))
    print(f"[k3] P={p}: per packed layer (then biases) max|err|/max|twin| "
          f"{', '.join(f'{e[0]:.2e}' for e in errs)}; cosine >= {worst_cos:.7f}; "
          f"max|err| {max_abs:.3e}; second launch bitwise equal: {repeat}", flush=True)
    check(bool(torch.isfinite(dw).all() and torch.isfinite(db).all()), "K3 output not finite")
    check(worst_rel <= TOL_K3_REL and worst_cos >= TOL_K3_COS, "K3 disagrees with its twin")
    check(repeat, "K3 is not bitwise repeatable")
    del dw, db, dw2, db2, tw, tb

    times = {}
    for shape, n in P_K3.items():
        args = (packed,) + tuple(t[:, :n].contiguous() for t in (pts, dirs, g_rgb, g_sig))
        times[shape] = cuda_ms(lambda: kg.fused_nerf_bwd(*args), 10)
    n = P_K3["fine"]
    plain_ms = cuda_ms(lambda: kg.fused_nerf_bwd_plain(*args), 3)
    e_c = ks._encode_plain(args[1].T, 10, packed.k_coor).to(torch.bfloat16)
    e_d = ks._encode_plain(args[2].T, 4, packed.k_dir).to(torch.bfloat16)
    chain_ms = cuda_ms(addmm_backward(packed, e_c, e_d, args[3], args[4]), 10)
    del e_c, e_d
    nwb = packed.w.numel() + packed.b.numel()
    flops = FLOP_PER_POINT["K3"] * n
    fn_bytes = 40 * n + packed.w.numel() * 2 + packed.b.numel() * 4 + nwb * 4
    # this design's workspace: saved activations and gradients written and
    # read (9,984 bytes per point), per-4096-point partials written and read
    ws_bytes = 2 * 9_984 * n + 2 * math.ceil(n / 4096) * nwb * 4
    b = 1e3 * max(flops / PEAK_BF16_FLOPS, fn_bytes / PEAK_BYTES)
    b_ws = 1e3 * max(flops / PEAK_BF16_FLOPS, (fn_bytes + ws_bytes) / PEAK_BYTES)
    print(f"[k3] kernel {times['coarse']:.3f} ms at P={P_K3['coarse']}, {times['fine']:.3f} ms "
          f"at P={n}; bound {b:.3f} ms (operations; {b_ws:.3f} ms counting this design's "
          f"workspace traffic); plain twin {plain_ms:.3f} ms; orientation only: bf16 "
          f"autograd through the torch.addmm chain {chain_ms:.3f} ms", flush=True)
    return {
        "name": "K3", "route": "cuda", "source": "tgtc_torch/csrc/nerf_mlp_grad.cu",
        "replaces": "tgtc/ops/pallas/nerf_mlp_grad.py:268",
        "wrapper": "tgtc_torch.ops.kernels.nerf_mlp_grad.fused_nerf_bwd",
        "P": n, "max_abs_err": max_abs, "max_err": max_abs, "max_rel_err": worst_rel,
        "min_cos": worst_cos,
        "ms": times["fine"], "ms_coarse": times["coarse"], "P_coarse": P_K3["coarse"],
        "plain_ms": plain_ms, "bound_ms": b, "bound_by": "operations",
        "bound_ms_with_workspace": b_ws, "library_ms": None, "matmul_chain_ms": chain_ms,
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
    """K4/K5 against their twins at P = 2^21 + 300 (three sigmas bitwise
    equal: K5 and K4, K5 and K2 on the same trunk, two K4 launches) and
    timings at the stylized frame's shapes."""
    packed = kst.pack_style_params(sd_c, *style_sds, device="cuda")
    rng = np.random.default_rng(3)
    p = P_K1 + RAGGED
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, p)).astype(np.float32)).cuda()
    lat = torch.from_numpy(rng.standard_normal((p, LATENT)).astype(np.float32)).cuda()
    rgb, sigma = kst.fused_style_apply_t(packed, pts, lat)
    rgb2, sigma2 = kst.fused_style_apply_t(packed, pts, lat)
    sigma5 = kst.fused_sigma_apply_t(packed, pts)
    sigma_k2 = ks.fused_nerf_sigma_apply_t(ks.pack_nerf_params(sd_c, device="cuda"), pts)
    torch.cuda.synchronize()
    rgb_p, sigma_p = kst.fused_style_apply_t_plain(packed, pts, lat)
    sigma5_p = kst.fused_sigma_apply_t_plain(packed, pts)
    err = {"K4": (float((rgb - rgb_p).abs().max()), float((sigma - sigma_p).abs().max())),
           "K5": (0.0, float((sigma5 - sigma5_p).abs().max()))}
    same = {"K5 = K4": torch.equal(sigma5, sigma), "K5 = K2": torch.equal(sigma5, sigma_k2),
            "K4 = K4": torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2)}
    print(f"[style_kernels] P={p}: K4 max|rgb err| {err['K4'][0]:.3e} max|sigma err| "
          f"{err['K4'][1]:.3e}; K5 max|sigma err| {err['K5'][1]:.3e}; |rgb| mean "
          f"{float(rgb_p.mean()):.3f}, |sigma| max {float(sigma_p.abs().max()):.3e}; bitwise: "
          + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)
    check(bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all()), "K4 output not finite")
    check(err["K4"][0] <= TOL_RGB and err["K4"][1] <= TOL_SIGMA, "K4 disagrees with its twin")
    check(err["K5"][1] <= TOL_SIGMA, "K5 disagrees with its twin")
    check(all(same.values()), f"sigma not bitwise equal where it must be: {same}")
    del rgb, sigma, rgb2, sigma2, sigma5, sigma_k2, rgb_p, sigma_p, sigma5_p

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
        ms = cuda_ms(lambda: fn(*args), 10)
        plain_ms = cuda_ms(lambda: twin(*args), 3)
        chain_ms = cuda_ms(chain, 10)
        del e_c, chain
        b = bound_ms(name, n, packed, io)
        print(f"[style_kernels] {name} P={n}: kernel {ms:.3f} ms, bound {b:.3f} ms "
              f"(operations), plain twin {plain_ms:.3f} ms, orientation only: bf16 "
              f"torch.addmm chain {chain_ms:.3f} ms", flush=True)
        rows.append({
            "name": name, "route": "cuda", "source": "tgtc_torch/csrc/style_kernel.cu",
            "replaces": ("tgtc/ops/pallas/style_kernel.py:432" if name == "K4"
                         else "tgtc/ops/pallas/style_kernel.py:387"),
            "wrapper": ("tgtc_torch.ops.kernels.style_kernel." +
                        ("fused_style_apply_t" if name == "K4" else "fused_sigma_apply_t")),
            "P": n, "max_abs_err": max(err[name]), "max_err": max(err[name]),
            "max_abs_err_rgb": err[name][0] if name == "K4" else None,
            "max_abs_err_sigma": err[name][1],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": "operations",
            "library_ms": None, "matmul_chain_ms": chain_ms,
        })
    return rows


def phase_f(ks, kst, trained):
    """Phase F from the trained trunks: seeded style MLPs and a 1-style
    latent table; stylized 756x1008 frames at spiral poses through
    FusedStyleRenderer(coarse_rgb=False) (47 K5 and 47 K4 launches a frame,
    no K1/K2); the first 16,384 rays against the eager f32 render; then the
    frame loop over three views. Returns the launches of one frame, the
    median frame's rays/s and the loop's frames/min."""
    from PIL import Image

    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP, nerf_apply
    from tgtc_torch.models.style_field import StyleFieldConfig, init_latents, make_style_mlps
    from tgtc_torch.render.fast_style import FusedStyleRenderer, block_generator
    from tgtc_torch.render.volume import RenderSettings
    from tgtc_torch.train.render_style import (
        make_stylized_render_fn,
        render_stylized_frames_fused,
    )

    concat, style = make_style_mlps(StyleFieldConfig(), torch.Generator().manual_seed(11),
                                    device="cuda")
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

    # the first block against the eager f32 chain with the same jitter
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = []
    for sd in (trained["coarse"], trained["fine"]):
        m = NerfMLP(NerfConfig(compute_dtype=torch.float32))
        m.load_state_dict(sd)
        models.append(m.cuda())
    eager = make_stylized_render_fn(*models, concat, style, NC, NF, settings.near,
                                    settings.far)
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
    print(f"[phase_f] first {BLOCK} rays vs the eager f32 stylized render: max|err| over rgb "
          f"and t_exp {float(err.max()):.3e}; {int(bad.sum())} rays above {TOL_RENDER}, all "
          f"with |last-sample sigma| <= {TOL_SIGMA}: {bool((flip | ~bad).all())}; max|err| "
          f"over the other {int((~flip).sum())} rays {worst:.3e}", flush=True)
    check(bool((flip | ~bad).all()), "stylized frame disagrees with the eager render")
    check(int(bad.sum()) <= BLOCK // 1000, "too many rays differ from the eager render")
    del models, eager, ref, out

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


def k6_bound_ms(heads: int, sq: int, sk: int) -> float:
    """max(4 Sq Sk D FLOP per head / bf16 peak, q, k, v and o in bf16 and
    lse in f32 / HBM rate)."""
    flops = 4 * heads * sq * sk * D_HEAD
    io = heads * (2 * (2 * sq + 2 * sk) * D_HEAD + 4 * sq)
    return 1e3 * max(flops / PEAK_BF16_FLOPS, io / PEAK_BYTES)


def sdpa_backend(q, k, v) -> str:
    """The device kernels of one scaled_dot_product_attention call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    return "; ".join(sorted(n[:80] for n in names)) or "no device kernel recorded"


def phase_k6(fa):
    """K6 against its twin at the C3, rectangular and ragged shapes (a
    second launch bitwise equal), the dropout mask probe, and timings at
    both large shapes beside the bound, the twin and SDPA."""
    rng = np.random.default_rng(4)
    shapes = {"c3": (C3_HEADS, C3_TOKENS, C3_TOKENS), "rect": (C3_HEADS, C3_TOKENS, 4096),
              "ragged": (16, 300, 180)}
    err_o, err_lse, inputs = 0.0, 0.0, {}
    for name, (heads, sq, sk) in shapes.items():
        q, k, v = inputs[name] = k6_inputs(rng, heads, sq, sk)
        o, lse = fa.flash_attention_fwd(q, k, v, K6_SCALE)
        o2, lse2 = fa.flash_attention_fwd(q, k, v, K6_SCALE)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, K6_SCALE)
        e_o = float((o.float() - o_p.float()).abs().max())
        e_l = float((lse - lse_p).abs().max())
        lim_o = min(TOL_K6_O, TOL_K6_O_REL * float(o_p.float().abs().max()))
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        print(f"[k6] {name} heads {heads} Sq {sq} Sk {sk}: max|o - twin| {e_o:.3e} (limit "
              f"{lim_o:.3e} = min({TOL_K6_O}, {TOL_K6_O_REL} max|twin|)), max|lse - twin| "
              f"{e_l:.3e} (limit {TOL_K6_LSE}), |o| max {float(o_p.float().abs().max()):.3f}, "
              f"mean {float(o_p.float().abs().mean()):.4f}; second launch bitwise equal: {same}",
              flush=True)
        check(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()),
              f"K6 output not finite at {name}")
        check(e_o <= lim_o and e_l <= TOL_K6_LSE, f"K6 disagrees with its twin at {name}")
        check(same, f"K6 is not bitwise repeatable at {name}")
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

    timing = {}
    for name in ("c3", "rect"):
        q, k, v = inputs[name]
        heads, sq, sk = shapes[name]
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, K6_SCALE), 20)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, K6_SCALE), 2)
        qs = q * torch.tensor(K6_SCALE, dtype=torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, k, v, scale=1.0), 20)
        backend = sdpa_backend(qs, k, v)
        b = k6_bound_ms(heads, sq, sk)
        flops = 4 * heads * sq * sk * D_HEAD
        print(f"[k6] {name} heads {heads} Sq {sq} Sk {sk}: kernel {ms:.3f} ms "
              f"({flops / ms * 1e-9:.1f} TFLOP/s, {b / ms:.2%} of the bound), bound {b:.3f} ms "
              f"(operations), plain twin {plain_ms:.3f} ms, library "
              f"scaled_dot_product_attention {lib_ms:.3f} ms [{backend}]", flush=True)
        timing[name] = (ms, plain_ms, lib_ms, b, backend)
    c3, rect = timing["c3"], timing["rect"]
    return {
        "name": "K6", "route": "cuda", "source": "tgtc_torch/csrc/flash_attention.cu",
        "replaces": "tgtc/ops/pallas/flash_attention.py:231",
        "wrapper": "tgtc_torch.ops.kernels.flash_attention.flash_attention_fwd",
        "shape": [C3_HEADS, C3_TOKENS, C3_TOKENS, D_HEAD],
        "max_abs_err": err_o, "max_err": err_o, "max_abs_err_lse": err_lse,
        "mask_probe_mismatches": mismatched,
        "ms": c3[0], "plain_ms": c3[1], "bound_ms": c3[3], "bound_by": "operations",
        "library_ms": c3[2], "library": "torch.nn.functional.scaled_dot_product_attention",
        "library_backend": c3[4],
        "shape_rect": [C3_HEADS, C3_TOKENS, 4096, D_HEAD], "ms_rect": rect[0],
        "plain_ms_rect": rect[1], "bound_ms_rect": rect[3], "library_ms_rect": rect[2],
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


def k78_bound_ms(products: int, outputs: int, bh: int, sq: int, sk: int) -> float:
    """max(2 Sq Sk D FLOP per product / bf16 peak, q, k, v and dO in bf16,
    lse and delta in f32 and the outputs in bf16 / HBM rate)."""
    flops = products * 2 * bh * sq * sk * D_HEAD
    rows_out = sq if outputs == 1 else 2 * sk
    io = bh * (2 * (2 * sq + 2 * sk + rows_out) * D_HEAD + 8 * sq)
    return 1e3 * max(flops / PEAK_BF16_FLOPS, io / PEAK_BYTES)


def device_ms(fn, iters: int):
    """``fn``'s device time per call, the sum of the kernels (and memsets)
    the profiler records over ``iters`` calls after one warm-up, and their
    names. Host time between kernels is not counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(events), "the profiler recorded no device kernel")
    names = "; ".join(sorted({e.name[:80] for e in events}))
    return sum(e.time_range.elapsed_us() for e in events) * 1e-3 / iters, names


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
    rectangular C3 shape and a ragged one, a second launch bitwise equal;
    K6 at the C1 shape with dropout; timings beside the bounds, the twins
    and SDPA's backward. Returns the K7 and K8 rows and K6's C1 readings."""
    rng = np.random.default_rng(5)
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")  # drawn on the card in C1
    cases = (("c1", (C1_BATCH, C3_HEADS, C1_TOKENS, C1_TOKENS), 0.0),
             ("c1", (C1_BATCH, C3_HEADS, C1_TOKENS, C1_TOKENS), C1_RATE),
             ("rect", (1, C3_HEADS, C3_TOKENS, 4096), 0.0),
             ("ragged", (1, 16, 300, 180), 0.0))
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

    bh = C1_BATCH * C3_HEADS
    times = {}
    for rate in (C1_RATE, 0.0):
        o, lse = fa.flash_attention_fwd(q, k, v, K6_SCALE, rate, seed)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, K6_SCALE, rate, seed)
        times[rate] = {
            "K6": (cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, K6_SCALE, rate, seed), 20),
                   cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, K6_SCALE, rate, seed), 2)),
            "K7": (cuda_ms(lambda: fa.flash_attention_bwd_dq(*args), 20),
                   cuda_ms(lambda: fa.flash_attention_bwd_dq_plain(*args), 2)),
            "K8": (cuda_ms(lambda: fa.flash_attention_bwd_dkv(*args), 20),
                   cuda_ms(lambda: fa.flash_attention_bwd_dkv_plain(*args), 2)),
        }
    lib_fwd, lib_bwd, backend = sdpa_bwd(q, k, v, do, 20)
    bounds = {"K6": k6_bound_ms(bh, C1_TOKENS, C1_TOKENS),
              "K7": k78_bound_ms(3, 1, bh, C1_TOKENS, C1_TOKENS),
              "K8": k78_bound_ms(4, 2, bh, C1_TOKENS, C1_TOKENS)}
    for name in ("K6", "K7", "K8"):
        (ms, plain), (ms0, _) = times[C1_RATE][name], times[0.0][name]
        print(f"[k78] {name} at the C1 shape: kernel {ms:.4f} ms with dropout {C1_RATE}, "
              f"{ms0:.4f} ms without ({bounds[name] / ms:.2%} of the bound), bound "
              f"{bounds[name]:.4f} ms (operations), plain twin {plain:.3f} ms", flush=True)
    print(f"[k78] library at the C1 shape, dropout 0, autograd on, device time of its kernels "
          f"(profiler): scaled_dot_product_attention forward {lib_fwd:.4f} ms, backward "
          f"{lib_bwd:.4f} ms (dq, dk and dv; K7 + K8 "
          f"{times[0.0]['K7'][0] + times[0.0]['K8'][0]:.4f} ms) [backward: {backend}]", flush=True)

    q, k, v, do = inputs["rect"]
    o, lse = fa.flash_attention_fwd(q, k, v, K6_SCALE)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, K6_SCALE)
    rect = {"K7": cuda_ms(lambda: fa.flash_attention_bwd_dq(*args), 10),
            "K8": cuda_ms(lambda: fa.flash_attention_bwd_dkv(*args), 10)}
    plain_rect = {"K7": cuda_ms(lambda: fa.flash_attention_bwd_dq_plain(*args), 1),
                  "K8": cuda_ms(lambda: fa.flash_attention_bwd_dkv_plain(*args), 1)}
    _, lib_rect, _ = sdpa_bwd(q, k, v, do, 10)
    b_rect = {"K7": k78_bound_ms(3, 1, C3_HEADS, C3_TOKENS, 4096),
              "K8": k78_bound_ms(4, 2, C3_HEADS, C3_TOKENS, 4096)}
    print(f"[k78] at {C3_HEADS} heads x {C3_TOKENS} x 4096: K7 {rect['K7']:.3f} ms (bound "
          f"{b_rect['K7']:.3f}, twin {plain_rect['K7']:.3f}), K8 {rect['K8']:.3f} ms (bound "
          f"{b_rect['K8']:.3f}, twin {plain_rect['K8']:.3f}); SDPA backward {lib_rect:.3f} ms",
          flush=True)
    rows = []
    for name, call_line in (("K7", 261), ("K8", 281)):
        ms, plain = times[C1_RATE][name]
        rows.append({
            "name": name, "route": "cuda", "source": "tgtc_torch/csrc/flash_attention.cu",
            "replaces": f"tgtc/ops/pallas/flash_attention.py:{call_line}",
            "wrapper": ("tgtc_torch.ops.kernels.flash_attention." +
                        ("flash_attention_bwd_dq" if name == "K7" else "flash_attention_bwd_dkv")),
            "shape": [C1_BATCH, C3_HEADS, C1_TOKENS, C1_TOKENS, D_HEAD], "dropout": C1_RATE,
            "max_abs_err": err[name], "max_err": err[name],
            "ms": ms, "ms_no_dropout": times[0.0][name][0], "plain_ms": plain,
            "bound_ms": bounds[name], "bound_by": "operations",
            "library_ms": lib_bwd,
            "library": "scaled_dot_product_attention backward (dq, dk, dv), device time "
                       "from the profiler",
            "library_backend": backend,
            "shape_rect": [C3_HEADS, C3_TOKENS, 4096, D_HEAD], "ms_rect": rect[name],
            "plain_ms_rect": plain_rect[name], "bound_ms_rect": b_rect[name],
            "library_ms_rect": lib_rect,
        })
    k6_c1 = {"ms_c1": times[C1_RATE]["K6"][0], "ms_c1_no_dropout": times[0.0]["K6"][0],
             "plain_ms_c1": times[C1_RATE]["K6"][1], "bound_ms_c1": bounds["K6"],
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
    return launches, steps_per_s, collages


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
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"[build] {line.strip()}", flush=True)

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
        c1_launches, c1_steps_per_s, collages = phase_c1(fa, geo_dir, tmp)
    # per C1 step of the counted run; K6 also ran once per site for each collage
    k6_row.update(k6_c1, launches=c3_launches, launches_c1=c1_launches["K6"],
                  launches_per_step=(c1_launches["K6"] - C3_SITES * collages) // C1_STEPS)
    rows.append(k6_row)
    for row in k78_rows:
        row["launches"] = c1_launches[row["name"]]
        row["launches_per_step"] = c1_launches[row["name"]] // C1_STEPS
    rows += k78_rows

    print(f"[result] card {card}; frame {rays_per_s:.1f} rays/s; Phase A "
          f"{steps_per_s:.2f} steps/s; stylized frame {f_rays_per_s:.1f} rays/s; Phase F "
          f"{f_frames_per_min:.2f} frames/min; C3 {c3_frames_per_s:.3f} frames/s, "
          f"{c3_s_per_view:.3f} s per view with the JPEG writes ({C3_VIEWS} views); C1 "
          f"{c1_steps_per_s:.3f} steps/s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
