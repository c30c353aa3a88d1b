#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tgtc_torch) on one NVIDIA GPU:
every phase end to end at full size, checked, not timed.

    python3 chip_smoke.py

The kernels against their plain twins on drawn inputs, at sizes that cut
their tiles and at the paths' full sizes, are tests/test_torch_cuda.py's
(``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q``);
here phases 2, 4, 7, 9, 11, 12 and 17 hold them to their twins on the
phases' own inputs. Speed is the benchmark's (``python3 benchmark/run.py --trace 1``). The
phases keep their numbers; 1, 3, 6, 8 and 10 are those tests' (K1/K2, K3,
K4/K5, K6, K7/K8). The script builds every CUDA source under tgtc_torch/csrc
(one nvcc per source, all started together), then:

0. prints the card (name, power limit), the torch/CUDA versions and
   ptxas's report of every kernel (registers, barriers, spills, wgmma
   notes) with the dynamic shared memory of K1, K2, K4 and K5;
2. main path: renders a fern-shaped 756x1008 NDC frame with
   FusedNerfRenderer(coarse_rgb=False) on He-normal D8/W256 trunks (numpy
   seed 0), 64+64 samples, 16384-ray blocks: launch counts are zeroed just
   before the frame and must be 47 each; the first 16,384 rays are held
   against the eager f32 render_rays (TF32 off) to 5e-2 in rgb and t_exp,
   except rays whose last-sample f32 sigma lies within the sigma tolerance
   of 0 (a sign flip there moves the ray's weight onto the 1e10 last
   interval), of which at most 0.1% may differ; and against the same block
   rendered with K1 and K2 swapped for their plain twins on the card (rgb
   and t_exp within 5e-2 on all but 0.1% of the rays);
4. train (Phase A): writes a 4-view 756x1008 synthetic LLFF scene and runs
   train_nerf at fern width (D8/W256, L 10/4, viewdirs, batch 2048, 64+64
   samples, perturb, sigma noise 1.0): 20 warm-up steps, then 300 steps
   resumed from the warm-up's checkpoint, with exactly 4 K1 and 4 K3
   launches counted and no K2 (2 each in the resumed run's eager first
   step and 2 in its capture of the CUDA graphs it replays from then on:
   a replay counts none); the loss must stay finite and the mean of
   its last 20 steps fall below that of its first 20. Then one fused step
   on the card with one batch and one set of draws: from the initial state
   against the eager f32 step (TF32 off; losses within 2e-2, every
   parameter's gradient cosine >= 0.99); from the trained state K3 against
   its twin on the step's own weights and cotangents (per packed layer
   max|err| / max|twin| <= 2e-2, cosine >= 0.999) and the step against the
   same step on the CPU (losses within 2e-2, every gradient cosine >=
   0.99), with each leaf's error against the eager f32 step beside the
   eager bf16 step's printed (compare_steps); and a checkpoint round trip
   (save, restore, render bitwise equal);
5. Phase B from the trained weights: writes a 2-view 756x1008 synthetic
   LLFF scene, loads it and runs dump_geometry; every artifact must exist
   and coor_map be finite;
7. Phase F from the trained trunks, with seeded style MLPs and a 1-style
   latent table: a stylized 756x1008 NDC frame at the scene's first spiral
   pose through FusedStyleRenderer(coarse_rgb=False), 64+64 samples,
   16384-ray blocks, with exactly 47 K5 and 47 K4 launches and no K1/K2;
   its first 16,384 rays held against the eager f32 make_stylized_render_fn
   with the same jitter (phase 2's bounds and exemption) and against the
   same block rendered with K4 and K5 swapped for their plain twins on the
   card (phase 2's bounds against the twins); then
   render_stylized_frames_fused over three views with full-size depth PNGs:
   every PNG at 756x1008, and a second call renders nothing;
9. Phase C3: a full-width StyTrans (d_model 512, 8 heads, 3+3 layers, FFN
   2048, bf16, attn_impl="flash", torch seed 21) stylizes phase 5's
   rgb_00000.png (756x1008, padded to 760x1008: 11,970 tokens) with a seeded
   512x512 style resized to the content size: one frame with exactly 12 K6
   launches; the same frame with the attention through the twin on the
   card (only K6 differs) within 5e-2 of its max, on the image and hs; the
   f32 eager path (TF32 off) read against it, not held; then stylize_all
   with one style over phase 5's views: every NNN.jpg at 756x1008,
   stylized_data.npz complete with finite style_features [1, 1024], 12 K6
   launches a view;
11. Phase C1 at full width (d_model 512, 8 heads, 3+3 layers, FFN 2048,
   dropout 0.1, bf16, flash attention, torch seed 21, random VGG and
   decoder): tools/train2d.main(["--task", "transformer", ...]) on phase
   5's renders as content and 8 seeded 512x512 style PNGs, batch 8, 256x256
   crops, cuDNN's deterministic algorithms (restored after the phase): 10
   warm-up steps, then 100 steps resumed from the warm-up's checkpoint,
   logged every 10 steps: 72 K7 and 72 K8 launches counted (the loop's
   eager first step and its CUDA graphs' capture; the replays count none)
   and 72 K6 (plus 12 for each collage), finite losses, the collage PNGs
   and the checkpoint written; the fingerprint (sha256, sum) of the trained
   state the witnesses read, and the kernel step taken twice there equal
   bit for bit; on one fixed batch and generator seed, the step's losses
   and gradients against the same step with the attention through the
   twins on the card (36 K6, K7 and K8 launches in the step; loss within
   1e-2 relative, the cosine of all trained leaves' gradients together >=
   0.999, each leaf's error within 0.1 of its gradient norm or of the
   median leaf's, whichever is larger, and each row block of the attention
   projections that only dq, dk or dv feeds within 0.5 of its own gradient
   norm); at dropout 0 the same against the eager f32 "xla" step (TF32 off;
   cosine 0.99, the worst leaf's error within 1.3x the eager bf16 "xla"
   step's + 5e-3); 30 steps on one fixed batch lower the loss;
12. Phase C2 from phase 11's trained state (the same full-width StyTrans,
   dropout 0.1, bf16, flash): train.temporal.run_temporal_finetune at
   TemporalTrainConfig's defaults (batch 4 of 256x256 patches, 100 steps,
   temporal weight 3500, splat radius 1.5, threshold 5e-2) on phase 5's
   two renders, its NDC coor maps and poses, and phase 11's 8 styles at
   512x512, logged every 10 steps: 36 K6 launches a step plus 36 for the
   end-of-C2 debug pass, no K7 or K8; only the decoder moves; the five
   losses finite and loss_t > 0; the debug PNGs and style_image.png
   written. On the first step's batch: the splat of its point cloud
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
   style_features [8, 1024] finite, 12 K6 launches a view and style;
14. Phase D: tools/train2d.main(["--task", "vae", ...]) on phase 11's
   styles at the pipeline's Phase-D settings (VaeConfig 1024 -> 512 x3 ->
   32, lr 1e-3, batch 8, 256x256 crops of the styles resized to 512, 2,000
   steps; TF32 at PyTorch's default), resumed after 20 warm-up steps,
   logged every step: the loss finite, the mean of the last 100 steps
   below the first 100's, the checkpoint written; one VAE step on the card
   against the same step on the CPU (same features and eps, TF32 off: loss
   within 1e-5 relative, every gradient cosine >= 0.9999); the latent table
   seeded by train.vae_trainer.seed_latents_from_features from phase 13's
   style_features with one frame per phase 5 view: finite, [8, 2, 32],
   equal to eps exp(logvar / 2) + mu for the eps drawn; a 756x1008 frame of
   style 0 from the table through phase 7's FusedStyleRenderer settings,
   trunks and style MLPs (47 K4 and 47 K5 launches, no K1/K2), its first
   16,384 rays held to the eager f32 render as in phase 7;
15. Phase E at fern's settings, read from configs/fern.txt through
   tgtc_torch/config.py (batch 256 a stream, 64+64 samples, σ noise 1.0,
   λ_coh 1e2, style_D 8, width 256, latent 32, lr 5e-4 / 1e-3, PyTorch's
   default full-f32 matmuls), with the coherence gate moved to the end of
   the warm-up: train/style3d.run_style3d on phase 4's trunks (bf16), phase
   5's two renders and rays, phase 13's 8 styles x 2 views and
   style_features and phase 14's VAE (the latent seed): 20 warm-up steps
   (the coherence diagnostic at the first, its ratio printed), then 300
   steps resumed from the warm-up's checkpoint, logged every 10: every loss
   finite, loss_coh 0 at the first step and at each cycle's reset and > 0
   elsewhere, the mean loss_rgb of the last 50 steps below the first 50's,
   both trunks bitwise unchanged, no hand-written kernel launched by a
   step; one step from the trained state (the coherence term and its
   gradient in, at fern's gate) on the card against the CPU with the same
   draws, TF32 off: losses within 1e-3 relative, the gradient cosine of
   concat, style and latents each >= 0.999; a 756x1008 frame of style 0
   from the Phase-E checkpoint through train/style3d.load_style_field and
   phase 7's FusedStyleRenderer settings (47 K4 and 47 K5 launches, nothing
   else), its first 16,384 rays held to the eager f32 render as in phase 7;
   the in-memory field renders the first block bit for bit as the
   checkpoint's;
16. the pipeline A→F (phase_pipeline): configs/fern.txt through
   tgtc_torch/config.py on a 4-view 756x1008 scene at factor 4 and 2 styles,
   origin_step 300, total_step 500, C1 50 steps, C2 20, the VAE 200;
   Pipeline.train_nerf() and _run_after_nerf() (A, evaluate, B, C1, C2, C3,
   D, E), then cli.main with --render_train_style (F), with --render_train
   and with no render flag (the re-entry run): every phase's artifacts,
   checkpoint steps and kernel launches held (K1-K8 each by its phase, K4/K5
   in F at 32,768-ray blocks), F's first block within phase 7's bounds of the
   eager f32 render, and the re-entry run adding no checkpoint and no
   training line and launching K1/K2 for evaluate only; each phase's peak
   allocated memory printed beside the card;
17. the proposal levers (phase_levers): render/distill.distill_proposal
   from phase 4's fine trunk on its 4 training views (300 steps of 3,000,
   batch 65,536), and K2-W128 (csrc/proposal_sm90.cuh) on that proposal's
   own packing against its twin at 8,192 x 64 points within TOL_SIGMA_W128,
   repeating bit for bit; the fern frame (phase 4's scene, spiral pose 0)
   through FusedNerfRenderer with the proposal as coarse net, fine_budget
   80 and coarse_share 2 (K1 and K2-W128 one launch a block, nothing else),
   beside the exact frame of the same trunks (its rgb agreement printed);
   the same with a 192^3 density grid (render/grid.build_sigma_grid: K2 at
   D8xW256 over the lattice x 9 offsets) in place of the proposal (K1
   only); a stylized frame through FusedStyleRenderer with the proposal
   (K4 and K2-W128, no K5); each lever frame's first 16,384 rays held to
   the same chain with the plain twins on the card (rgb and t_exp within
   5e-2 on all but 0.1% of the rays); 300 fused Phase-A steps under
   train_fine_budget "96@100,80@200" through train_nerf (K1 and K3 at 2048
   x 64 and at 2048 x 128, 96 and 80 in the three segments, counted in
   each segment's eager first step and its capture of the CUDA graphs), and
   a budget-80 step on the card against the CPU (loss within 1e-3 of its
   size, phase 4's gradient cosine); phase 16's pipeline re-entered with
   --proposal_width 128 --fine_budget 80 --coarse_share 2 --proposal_steps
   300 for --render_train and --render_train_style (launches held, frames
   written);
18. multi-process (phase_multi): this process joins a NCCL group of one
   (tgtc_torch.parallel.maybe_initialize_distributed with a TGTC_*
   environment) and runs 3 fused Phase-A steps at fern width (batch 2048,
   64+64 samples, sigma noise 1.0) through group= against the ungrouped
   steps: losses, the first step's gradients and the parameters bit for
   bit, 2 K1 and 2 K3 launches a step; then two worker processes
   (multi_worker, started together with TGTC_COORDINATOR/_NUM_PROCESSES/
   _PROCESS_ID) share the card over gloo, each with half of every global
   batch, against this process's 1-process steps: the fused Phase-A step
   (1024 rays a rank; the losses, the first step's averaged gradient and
   the parameters after 3 steps within TOL_MP_A_*), the full-width C1 step
   at dropout 0.1 (4 images a rank, bh_offset rank x 4 x 8; phase 11's
   bounds; 36 K6, K7 and K8 launches a rank), the Phase-E step from phase
   15's checkpoint at fern's settings with the coherence term on (128 rays
   a rank; phase 15's bounds), then cli.main under the two-process launch
   on phase 16's run: Phase A skipped, Phase E 20 more steps over both
   ranks, only rank 0 writing ckpt_style, which load_style_field reads;
   then, on the same two workers: (e) phase 2's 756x1008 frame from phase
   4's trunks through make_sharded_fused_render_fn (16,384-ray blocks, 47,
   split 24 / 23 over the ranks), exact and with phase 17's fast stack
   (proposal, fine_budget 80, coarse_share 2), each bit for bit the
   1-process frame of the same trunks and block size, each rank launching K1
   and K2 (K1 and K2-W128) exactly once a block of its share; (f)
   make_render_fn(group=) and make_stylized_render_fn(group=) (phase 15's
   trained field) on the frame's first two blocks, bit for bit their
   1-process renders; (g) train_transformer(group=) for 3 steps of phase 11's
   full-width C1 (batch 8, 4 a rank) against the 1-process loop: the first
   step's loss within 1e-5 relative (the C1 bound of
   tests/test_torch_multiprocess.py), the later losses within phase 11's 1e-2,
   every trained parameter within twice Adam's largest steps (the trained
   parameters' sum read), 72 K6, K7 and K8 launches counted a rank (the
   eager first step and the capture; +12 K6 for rank 0's collage), rank 0
   alone writing the checkpoint and the collage; a worker's failure or a
   worker outliving MP_TIMEOUT fails the phase;
19. AdaIN (phase_adain), f32, PyTorch's TF32 defaults (cuDNN's on, the
   matmuls' off; printed): (a) tools/train2d.main(["--task",
   "finetune_decoder", ...]) at the task's defaults (batch 8, patch 256, lr
   1e-4, decay 5e-5, style 2, content 1) on phase 5's renders and phase 11's 8
   styles with a seeded VGG and decoder: 20 warm-up steps, then 100 steps
   resumed, logged every step; the VGG bitwise unchanged, every decoder
   leaf moved, every loss finite, the last 20 losses' mean below the first
   20's, the checkpoint round-trips bit for bit; (b) one finetune step from
   that checkpoint on one fixed batch on the card against the CPU, TF32 off
   (loss within 1e-4 relative, decoder gradient cosine >= 0.9999); (c)
   --task temporal_decoder on phase 5's geometry dir (2 views, 756x1008) at
   batch 8 of full frames, 10 steps, the peak allocated memory, loss_t
   finite and > 0 at every step, the adain_temporal checkpoint written; (d)
   one temporal step from it on the card against the CPU at batch 2 (ids
   [0, 1]), TF32 off, (b)'s bounds;
20. prints the result line (the card) and the ok line.

Any failed check raises, so the script exits non-zero and prints no result.
It needs CUDA and the rest of the repository beside it.
"""

from __future__ import annotations

import collections
import contextlib
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
P_K2 = BLOCK * NC
TOL_SIGMA, TOL_RENDER = 2e-1, 5e-2
# K3 against its twin on the training step's own passes, per packed layer:
# max|err| / max|twin| and cosine (tests/test_torch_cuda.py's limits for
# K3 at Phase A's fine pass)
TOL_K3_REL, TOL_K3_COS = 2e-2, 0.999
BATCH = 2048
P_K3 = {"coarse": BATCH * NC, "fine": BATCH * (NC + NF)}
WARM_STEPS, TRAIN_STEPS, I_PRINT = 20, 300, 50
TOL_STEP_LOSS, TOL_STEP_COS = 2e-2, 0.99
# phase 17's budget step against the CPU, of the CPU's loss: a trained
# state's loss (~3e-3) sits under TOL_STEP_LOSS, so the limit scales with it
TOL_STEP_LOSS_REL = 1e-3
LATENT, LATENT_FRAMES, F_VIEWS, F_SEED = 32, 20, 3, 10  # Phase F: fern's 20 training views
TOL_C3 = 5e-2
C3_SITES = 12  # attention sites of one StyleTransformer call: 3 + 3 encoder, 2 x 3 decoder
C1_BATCH, C1_RATE = 8, 0.1  # 256x256 crops; dropout
C1_SITES = 3 * C3_SITES  # a C1 step's transformer calls: Ics, Icc, Iss


def a_loop_launches(steps: int) -> int:
    """K1's (and K3's) launches counted over a fused Phase-A loop of ``steps``
    steps on one batch key, two a counted call (the coarse and the fine
    pass): the step's first call runs eagerly, its second captures the CUDA
    graphs it replays from then on, and a replay counts none."""
    return 2 * min(steps, 2)


def c1_loop_launches(steps: int) -> int:
    """K7's (and K8's) launches counted over a C1 loop of ``steps`` steps on
    one batch shape: the step's first call runs eagerly, its second captures
    the CUDA graphs it replays from then on, and a replay counts none."""
    return C1_SITES * min(steps, 2)
C1_WARM, C1_STEPS, C1_PRINT, C1_OVERFIT = 10, 100, 10, 30
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
C2_SEED, C2_WARM, C2_PRINT = 21, 10, 10  # steps 11-100 logged after the warm-up, every 10
TOL_SPLAT_MASK, TOL_OWN_VIEW = 1e-3, 0.95  # tests/test_rasterize.py's coverage bound
D_WARM, D_STEPS = 20, 2000  # the pipeline's vae_iters
TOL_VAE_LOSS, TOL_VAE_COS = 1e-5, 0.9999
E_WARM, E_STEPS, E_PRINT, E_SEED = 20, 300, 10, 31  # the reference runs 8,000 Phase-E steps
# card vs CPU step: the trunks run bf16 on both (one bf16 ulp apart at places)
TOL_E_LOSS, TOL_E_COS = 1e-3, 0.999
# Phase 16, the pipeline A→F at configs/fern.txt's settings: a 4-view scene
# loaded at fern's factor 4 (756x1008), 2 styles; the cut step counts
PIPE_VIEWS, PIPE_STYLES, PIPE_FACTOR = 4, 2, 4
PIPE_ORIGIN, PIPE_TOTAL, PIPE_PRINT = 300, 500, 50
PIPE_C1, PIPE_C2, PIPE_VAE = 50, 20, 200
PIPE_PHASES = ("A", "evaluate", "B", "C1", "C2", "C3", "D", "E", "F", "plain")
# Phase 17, the proposal levers: the JAX package's fast stack (README.md's
# --proposal_width 128 --fine_budget 80 --coarse_share 2), the 192^3 grid,
# and Phase A under --train_fine_budget "96@100,80@200"; the proposal
# distilled in 300 steps (cut from the package's 3,000) at batch 65,536
LEVER_BUDGET, LEVER_SHARE, LEVER_SEED = 80, 2, 7
PROPOSAL_STEPS, PROPOSAL_BATCH, GRID_RES = 300, 65536, 192
A_SCHEDULE, A_STEPS, A_PRINT = "96@100,80@200", 300, 50
A_SEGMENTS = ((0, 100, None), (100, 200, 96), (200, 300, 80))  # (first, end, budget)
# K2 at width 128 against its twin on the distilled proposal's own packing
# (tests/test_torch_cuda.py's limit for K2-W128)
TOL_SIGMA_W128 = 2e-2
# Phase 18, multi-process on the card: the fused Phase-A step through a
# DataGroup of one over NCCL in this process (bit for bit the ungrouped
# step), then two worker processes sharing the card over gloo (NCCL takes
# no two ranks on one device; gloo takes CUDA tensors for all-reduce and
# broadcast, all DataGroup uses), each holding half of every global batch
MP_WORLD, MP_A_STEPS, MP_SEED, MP_E_STEPS, MP_TIMEOUT = 2, 3, 41, 20, 900
# Bounds of the 2-process runs against the 1-process step at the same global
# batch (PERF.md §6). Phase A's fused step: every per-point value is the
# same in both runs (K1 and the compositing are per ray; a rank's loss is the
# mean of 1,024 rays, so its cotangents are exactly twice the global ones),
# and K3 sums each weight's gradient over the same 8,192-point chunks, so the
# f32 sums differ only in the association of the chunk sums; but each weight
# gradient is then rounded to the packed weights' bf16 (unit roundoff 2^-8):
# once in the 1-process step, once on each rank before the average. So each
# element of the averaged gradient lies within 2^-8 (|g_0| + |g_1|) / 2 +
# 2^-8 |g| of the 1-process g (g_r rank r's own bf16 gradient), widened by
# (1 + 2^-7) and by 2^-20 of the leaf's largest |g| for the f32 sums.
TOL_MP_A_LOSS, MP_BF16_U = 1e-5, 2.0 ** -8
# after 3 steps a parameter differs by at most twice Adam's largest step
# each step: |m^/sqrt(v^)| <= 1.0035 for t <= 3 at betas (0.9, 0.999), so
# 2 x 3 x 1.0035 lr, reached only where a gradient element is itself f32
# noise and its sign differs between the runs
TOL_MP_A_PARAM = 2 * MP_A_STEPS * 1.0035 * 5e-4
# Phase 18(e)-(g): the sharded renders (bit for bit: each rank renders whole
# blocks of the 1-process block grid, so every kernel and library call sees
# the 1-process shapes) and the grouped C1 loop, 3 steps. The first step
# starts from the same parameters, so its loss is held at
# tests/test_torch_multiprocess.py's C1 bound (1e-5 relative); from there the
# bf16 rows that round apart by the batch (4 vs 8 images) move Adam's
# noise-sized gradient elements by up to lr either way (PERF.md §6),
# so the later losses take phase 11's bound (TOL_C1_LOSS) and each trained
# parameter after the 3 steps lies within twice Adam's largest step a step,
# 2 x 1.0035 x (the 3 steps' learning rates summed), as phase 18(b)'s
# TOL_MP_A_PARAM; the parameters' sum is read
MP_EAGER_BLOCKS, MP_C1_STEPS, TOL_MP_C1_FIRST = 2, 3, 1e-5
# Phase 19, AdaIN: the finetune task at its defaults (batch 8, patch 256, lr
# 1e-4, decay 5e-5, style 2, content 1), 20 warm-up and 100 counted steps;
# the temporal task at batch 8 of full 756x1008 frames, 10 steps; the card's
# step against the CPU's (f32 on both, TF32 off): the loss relative and the
# decoder gradient's cosine
ADAIN_WARM, ADAIN_STEPS, ADAIN_T_STEPS, ADAIN_SEED = 20, 100, 10, 21
TOL_ADAIN_LOSS, TOL_ADAIN_COS = 1e-4, 0.9999
# C1 and E: cuBLAS and cuDNN pick their algorithms by the batch (4 vs 8
# images, 128 vs 256 rays), so a row's result may round apart: phase 11's
# and phase 15's bounds (TOL_C1_*, TOL_E_*), which hold steps whose
# operations round apart by more (the twin attention, the CPU)


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


def fern_camera():
    intr = np.array([[FOCAL, 0, 0.5 * W], [0, FOCAL, 0.5 * H], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)[None, :3, :4]
    return intr, pose


def phase_main_path(ks, sd_c, sd_f):
    """Phase 2 (see the module docstring)."""
    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP, nerf_apply
    from tgtc_torch.render import fast as rf
    from tgtc_torch.render.fast import FusedNerfRenderer
    from tgtc_torch.render.volume import RenderSettings, render_rays

    settings = RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    renderer = FusedNerfRenderer.from_params(sd_c, sd_f, settings, coarse_rgb=False,
                                             device="cuda")
    intr, pose = fern_camera()
    ro, rd = rays_for_poses(H, W, intr, pose, use_ndc=True, device="cuda")
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    n = ro.shape[0]

    blocks = math.ceil(n / BLOCK)
    ks.fused_nerf_apply_t.launches = 0
    ks.fused_nerf_sigma_apply_t.launches = 0
    out = renderer.render_image(ro, rd, block=BLOCK)
    torch.cuda.synchronize()
    launches = {"K1": ks.fused_nerf_apply_t.launches, "K2": ks.fused_nerf_sigma_apply_t.launches}
    print(f"[main] frame {H}x{W} ({n} rays, {NC}+{NF} samples, block {BLOCK}): launches K1 "
          f"{launches['K1']} K2 {launches['K2']} (expect {blocks} each)", flush=True)
    check(launches == {"K1": blocks, "K2": blocks}, f"launch counts {launches} != {blocks}")
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

    with twins(rf, fused_nerf_apply_t=ks.fused_nerf_apply_t_plain,
               fused_nerf_sigma_apply_t=ks.fused_nerf_sigma_apply_t_plain):
        ref = renderer.render(bo, bd)
    block_vs_twins({"rgb": out["rgb"][:BLOCK], "t_exp": out["t_exp"][:BLOCK]}, ref, "main",
                   "the fused frame's first block (K1, K2)")


def write_scene(root: str, n: int = 2, factor: int = 1) -> str:
    """The recipe of tests/synthetic_scene.py at 756x1008: forward-facing
    cameras, colored gradients, poses stored with the inverse LLFF axis fix.
    With ``factor`` > 1 the images go to ``images_<factor>`` and the poses
    carry the full-size frame (``factor`` times 756x1008 and the focal), as
    an LLFF capture downsampled by ``factor`` (fern's 4) has them."""
    from PIL import Image

    imgdir = os.path.join(root, "images" if factor == 1 else f"images_{factor}")
    os.makedirs(imgdir, exist_ok=True)
    poses = []
    for k in range(n):
        c2w = np.eye(4)[:3]
        c2w[:, 3] = [0.02 * (k - n / 2), 0.01 * (k % 3), 4.0 + 0.03 * k]
        hwf = np.array([[H * factor], [W * factor], [FOCAL * factor]])
        poses.append(np.concatenate([c2w, hwf], axis=1))
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


def layer_errors(packed, dw, db, tw, tb):
    """Per packed layer (then the biases): max|err| / max|twin| and cosine."""
    out = []
    for i, (n, k) in enumerate(packed.layers()):
        a = dw[packed.offsets[i]: packed.offsets[i] + n * k].double()
        b = tw[packed.offsets[i]: packed.offsets[i] + n * k].double()
        out.append((float((a - b).abs().max() / b.abs().max()),
                    float((a * b).sum() / (a.norm() * b.norm()))))
    out.append((float((db - tb).abs().max() / tb.abs().max()),
                float((db.double() * tb.double()).sum() / (db.double().norm() * tb.double().norm()))))
    return out


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
      step's own packed weights and cotangents (per packed layer, TOL_K3_*),
      and the step against the same step on the CPU, where the
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
        errs = layer_errors(packed, dw, db, tw, tb)
        rel, c = max(e[0] for e in errs), min(e[1] for e in errs)
        print(f"[train] trained state, K3 vs its twin on the step's own {which} pass (P = "
              f"{args[0].shape[1]}): per packed layer (then biases) max|err|/max|twin| "
              f"{', '.join(f'{e[0]:.2e}' for e in errs)}; cosine >= {c:.7f}", flush=True)
        check(rel <= TOL_K3_REL and c >= TOL_K3_COS,
              f"trained state: K3 disagrees with its twin on the {which} pass")
    del calls

    cpu = tt.make_fused_train_step(cfg, tc, device="cpu")
    d_cpu = tt.StepDraws(*(None if t is None else t.cpu() for t in (
        draws.idx, draws.perturb_u, draws.noise_coarse, draws.noise_fine)))
    m_c, g_c = cpu.loss_and_grad(*trunks(cfg, trained, "cpu"), ro.cpu(), rd.cpu(), rgb.cpu(),
                                 d_cpu)
    cos = {n: grad_cos(a.cpu(), b) for n, a, b in zip(names, g_f, g_c)}
    rel = {n: grad_rel(a.cpu(), b) for n, a, b in zip(names, g_f, g_c)}
    worst, dl = min(cos, key=cos.get), abs(float(m_f["loss"]) - float(m_c["loss"]))
    print(f"[train] trained state, fused step on the card vs on the CPU (twins): "
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
    checkpoint round trip. Returns the trained renderer and the trained
    trunks' state dicts with the scene's intrinsics and spiral poses."""
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
        state, warm = tt.train_nerf(scene, cfg, tc, WARM_STEPS, run, **kw)
        for k in (ks.fused_nerf_apply_t, ks.fused_nerf_sigma_apply_t, kg.fused_nerf_bwd):
            k.launches = 0
        state, hist = tt.train_nerf(scene, cfg, tc, WARM_STEPS + TRAIN_STEPS, run, **kw)
        torch.cuda.synchronize()
        launches = {"K1": ks.fused_nerf_apply_t.launches, "K2": ks.fused_nerf_sigma_apply_t.launches,
                    "K3": kg.fused_nerf_bwd.launches}
        losses = warm["loss"] + hist["loss"]
        sizes = np.diff([WARM_STEPS] + [r["step"] for r in hist["records"]])  # log windows
        first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
        print(f"[train] {len(scene.images)} views {H}x{W}, D8/W256, batch {BATCH}, {NC}+{NF} "
              f"samples: {WARM_STEPS} warm-up steps, then {TRAIN_STEPS} steps resumed, logged in "
              f"windows of {', '.join(str(n) for n in sizes)}; launches K1 {launches['K1']} K2 "
              f"{launches['K2']} K3 "
              f"{launches['K3']} (expect {a_loop_launches(TRAIN_STEPS)}, 0, "
              f"{a_loop_launches(TRAIN_STEPS)}: the eager first step and the capture); mean loss "
              f"of the first 20 steps {first:.5f}, of the last 20 {last:.5f}; psnr_fine "
              f"{warm['records'][-1]['psnr_fine']:.2f} -> {hist['records'][-1]['psnr_fine']:.2f}",
              flush=True)
        check(launches == {"K1": a_loop_launches(TRAIN_STEPS), "K2": 0,
                           "K3": a_loop_launches(TRAIN_STEPS)},
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
               "intrinsics": scene.intrinsics, "render_poses": scene.render_poses,
               "poses": scene.poses}
    renderer = FusedNerfRenderer.from_params(trained["coarse"], trained["fine"], settings,
                                             coarse_rgb=False, device="cuda")
    return renderer, trained


def phase_b(ks, renderer, root: str) -> str:
    """Phase B into ``root``; returns the geometry directory (phase 9
    stylizes its views)."""
    from tgtc_torch.data.llff import load_llff_data
    from tgtc_torch.train.geometry import dump_geometry

    scene = load_llff_data(write_scene(os.path.join(root, "scene")), factor=1)
    out_dir = os.path.join(root, "geometry")
    ks.fused_nerf_apply_t.launches = 0
    ks.fused_nerf_sigma_apply_t.launches = 0
    dump_geometry(renderer, scene, out_dir)
    n = scene.poses.shape[0]
    names = [f"{kind}_{i:05d}.{ext}" for i in range(n)
             for kind, ext in (("rgb", "png"), ("depth", "png"), ("geometry", "npz"))]
    missing = [f for f in names + ["geometry.npz"] if not os.path.exists(os.path.join(out_dir, f))]
    check(not missing, f"Phase B artifacts missing: {missing}")
    geo = np.load(os.path.join(out_dir, "geometry.npz"))
    check(geo["coor_maps"].shape == (n, H, W, 3), "coor_maps shape")
    check(bool(np.isfinite(geo["coor_maps"]).all()), "coor_map not finite")
    print(f"[phase_b] {n} views at {H}x{W}: dump_geometry wrote "
          f"{len(names) + 1} files, launches K1 {ks.fused_nerf_apply_t.launches} "
          f"K2 {ks.fused_nerf_sigma_apply_t.launches}", flush=True)
    check(ks.fused_nerf_apply_t.launches > 0 and ks.fused_nerf_sigma_apply_t.launches > 0,
          "Phase B did not go through the kernels")
    return out_dir


def style_mlps():
    """Phase 7's seeded style MLPs (torch seed 11) on the card."""
    from tgtc_torch.models.style_field import StyleFieldConfig, make_style_mlps

    return make_style_mlps(StyleFieldConfig(), torch.Generator().manual_seed(11), device="cuda")


def stylized_vs_eager(renderer, trained, concat, style, fo, fd, out, tag: str, what: str):
    """The first BLOCK rays of a stylized frame (style 0, frame 0, seed
    F_SEED) against the eager f32 chain with the same jitter: phase 2's
    bounds and exemption."""
    from tgtc_torch.render.fast_style import block_generator

    u = torch.rand((BLOCK, NC), generator=block_generator(F_SEED, 0, 0, "cuda"), device="cuda")
    stylized_rays_vs_eager(trained, concat, style, renderer.latent_state, renderer.settings,
                           fo[:BLOCK], fd[:BLOCK], 0, 0, u, out["rgb"][:BLOCK],
                           out["t_exp"][:BLOCK], tag, what)


def stylized_rays_vs_eager(trained, concat, style, latent_state, settings, bo, bd, style_id,
                           frame_id, u, rgb, t_exp, tag: str, what: str):
    """Stylized rays ``bo``/``bd`` rendered with the coarse jitter ``u``
    (rgb, t_exp) against the eager f32 chain (TF32 off) on the same trunks
    (``trained``'s state dicts), style MLPs and latents, in pieces of BLOCK
    rays: phase 2's bounds and exemption."""
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP, nerf_apply
    from tgtc_torch.train.render_style import make_stylized_render_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = []
    for sd in (trained["coarse"], trained["fine"]):
        m = NerfMLP(NerfConfig(compute_dtype=torch.float32))
        m.load_state_dict(sd)
        models.append(m.cuda())
    eager = make_stylized_render_fn(*models, concat, style, settings.n_samples,
                                    settings.n_samples_fine, settings.near, settings.far)
    errs, flips = [], []
    for i in range(0, bo.shape[0], BLOCK):
        o, d = bo[i: i + BLOCK], bd[i: i + BLOCK]
        sid = torch.full((o.shape[0],), style_id, dtype=torch.long, device="cuda")
        fid = torch.full((o.shape[0],), frame_id, dtype=torch.long, device="cuda")
        ref = eager(latent_state, o, d, sid, fid, u=u[i: i + BLOCK])
        with torch.no_grad():
            last = nerf_apply(models[1], o + ref["ts_fine"][:, -1:] * d, d)["sigma"]
        errs.append(torch.maximum((rgb[i: i + BLOCK] - ref["rgb"]).abs().amax(-1),
                                  (t_exp[i: i + BLOCK] - ref["t_exp"]).abs()))
        flips.append(last.abs() <= TOL_SIGMA)  # phase 2's exemption
        del ref
    err, flip = torch.cat(errs), torch.cat(flips)
    n = err.shape[0]
    bad = err > TOL_RENDER
    worst = float(err[~flip].max()) if bool((~flip).any()) else 0.0
    print(f"[{tag}] first {n} rays vs the eager f32 stylized render: max|err| over rgb "
          f"and t_exp {float(err.max()):.3e}; {int(bad.sum())} rays above {TOL_RENDER}, all "
          f"with |last-sample sigma| <= {TOL_SIGMA}: {bool((flip | ~bad).all())}; max|err| "
          f"over the other {int((~flip).sum())} rays {worst:.3e}", flush=True)
    check(bool((flip | ~bad).all()), f"{what} disagrees with the eager render")
    check(int(bad.sum()) <= n // 1000, f"too many rays of the {what} differ from the eager "
          "render")


def phase_f(ks, kst, trained):
    """Phase F from the trained trunks: seeded style MLPs and a 1-style
    latent table; stylized 756x1008 frames at spiral poses through
    FusedStyleRenderer(coarse_rgb=False) (47 K5 and 47 K4 launches a frame,
    no K1/K2); the first 16,384 rays against the eager f32 render and
    against the twins' render; then the frame loop over three views."""
    from PIL import Image

    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.style_field import init_latents
    from tgtc_torch.render import fast_style as rfs
    from tgtc_torch.render.fast_style import FusedStyleRenderer, block_generator
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

    for k in counters.values():
        k.launches = 0
    out = renderer.render_image(fo, fd, 0, 0, block=BLOCK, seed=F_SEED)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    print(f"[phase_f] stylized frame {H}x{W} ({n} rays, {NC}+{NF} samples, block {BLOCK}): "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    check(launches == {"K1": 0, "K2": 0, "K4": blocks, "K5": blocks},
          f"stylized frame launch counts {launches}, expected {blocks} K4 and K5")
    check(out["rgb"].shape == (n, 3) and out["t_exp"].shape == (n,), "stylized frame shape")
    check(bool(torch.isfinite(out["rgb"]).all() and torch.isfinite(out["t_exp"]).all()),
          "stylized frame not finite")

    stylized_vs_eager(renderer, trained, concat, style, fo, fd, out, "phase_f", "stylized frame")
    sid = torch.zeros(BLOCK, dtype=torch.long, device="cuda")
    u = torch.rand((BLOCK, NC), generator=block_generator(F_SEED, 0, 0, "cuda"), device="cuda")
    with twins(rfs, fused_style_apply_t=kst.fused_style_apply_t_plain,
               fused_sigma_apply_t=kst.fused_sigma_apply_t_plain):
        ref = renderer.render(fo[:BLOCK], fd[:BLOCK], sid, sid, u=u)
    block_vs_twins({"rgb": out["rgb"][:BLOCK], "t_exp": out["t_exp"][:BLOCK]}, ref, "phase_f",
                   "the stylized frame's first block (K4, K5)")
    del out, ref

    with tempfile.TemporaryDirectory() as tmp:
        for k in counters.values():
            k.launches = 0
        rendered = render_stylized_frames_fused(renderer, ro, rd, [0], tmp, seed=F_SEED,
                                                block=BLOCK, depth_png="full")
        names = [f"style_00000_fine{kind}_{f:05d}.png" for f in range(F_VIEWS)
                 for kind in ("", "_depth")]
        sizes = {f: Image.open(os.path.join(tmp, f)).size
                 for f in names if os.path.exists(os.path.join(tmp, f))}
        again = render_stylized_frames_fused(renderer, ro, rd, [0], tmp, seed=F_SEED,
                                             block=BLOCK)
        print(f"[phase_f] frame loop: {rendered} frames, {len(sizes)} of {len(names)} PNGs "
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


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max|a - ref| / max|ref|."""
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max())


def phase_c3(fa, geo_dir: str, root: str):
    """Phase C3 at full width on phase 5's views: one frame (12 K6
    launches), the frame against the same frame with the twin's attention,
    the f32 eager path read beside it, then stylize_all over the views."""
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    im, hs = model.stylize(content, style)
    torch.cuda.synchronize()
    launches = fa.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"[c3] StyTrans d_model 512, 8 heads, 3+3 layers, bf16, flash: frame {h}x{w} (padded "
          f"{hp}x{wp}, {hp * wp // 64} tokens): K6 launches {launches}; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    check(launches == C3_SITES, f"C3 frame launched K6 {launches} times, not {C3_SITES}")
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

    # stylize_all over phase 5's views
    views = sorted(f for f in os.listdir(geo_dir) if f.startswith("rgb_"))
    out = os.path.join(root, "stylized")
    fa.flash_attention_fwd.launches = 0
    res = st.stylize_all(model, geo_dir, [style_img], ["style_00.png"], out, device="cuda")
    loop_launches = fa.flash_attention_fwd.launches
    jpgs = [os.path.join(out, f"{i + 1:03d}.jpg") for i in range(len(views))]
    sizes = [Image.open(p).size for p in jpgs if os.path.exists(p)]
    z = np.load(os.path.join(out, "stylized_data.npz"), allow_pickle=True)
    feats = z["style_features"]
    print(f"[c3] stylize_all over {len(views)} views: {len(sizes)} of {len(jpgs)} JPEGs at "
          f"{W}x{H}: "
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
    then the fixed-batch witnesses, all with cuDNN's deterministic
    algorithms (``cudnn.deterministic`` on, ``benchmark`` off; both restored
    after), so that the trained state the witnesses read repeats from run
    to run. Returns the C1 checkpoint and the styles' directory."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return _phase_c1(fa, geo_dir, root)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _phase_c1(fa, geo_dir: str, root: str):
    import hashlib
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
    check(train2d.main(argv + ["--max_iter", str(C1_WARM)], device="cuda") == 0, "C1 warm-up")
    for c in counters.values():
        c.launches = 0
    total = C1_WARM + C1_STEPS
    check(train2d.main(argv + ["--max_iter", str(total)], device="cuda") == 0, "C1 counted run")
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    collages = len([s for s in range(C1_WARM + 1, total + 1) if s % 100 == 0 or s == total])
    with open(os.path.join(log, "transformer.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    counted = [r for r in records if r["step"] > C1_WARM]
    sizes = np.diff([C1_WARM] + [r["step"] for r in counted])  # log windows
    ckpt = os.path.join(save, "transformer", f"ckpt_{total:08d}.pt")
    pngs = [os.path.join(log, f"{s}.png") for s in (C1_WARM, 100, total)]
    print(f"[c1] StyTrans d_model 512, 8 heads, 3+3 layers, FFN 2048, dropout {C1_RATE}, bf16, "
          f"flash, random VGG and decoder, cudnn.deterministic True and benchmark False; batch "
          f"{C1_BATCH} of 256x256 crops from "
          f"{len(os.listdir(content))} renders and 8 styles: {C1_WARM} warm-up steps, then "
          f"{C1_STEPS} steps resumed, logged in windows of {', '.join(str(n) for n in sizes)}"
          + f"; launches K6 {launches['K6']} K7 {launches['K7']} K8 {launches['K8']} (expect "
          f"{c1_loop_launches(C1_STEPS)} + {C3_SITES} x {collages} collages, "
          f"{c1_loop_launches(C1_STEPS)}, {c1_loop_launches(C1_STEPS)}: the eager first step "
          f"and the capture; replays count none); loss {records[0]['loss']:.4f} at step "
          f"{records[0]['step']} "
          f"-> {records[-1]['loss']:.4f} at step {records[-1]['step']}", flush=True)
    check(launches == {"K6": c1_loop_launches(C1_STEPS) + C3_SITES * collages,
                       "K7": c1_loop_launches(C1_STEPS), "K8": c1_loop_launches(C1_STEPS)},
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
    trained_leaves = [p.detach() for _, p in t2.trained_parameters(model)]
    digest = hashlib.sha256(b"".join(p.float().cpu().numpy().tobytes() for p in trained_leaves))
    total_sum = float(sum(p.double().sum() for p in trained_leaves))
    for c in counters.values():
        c.launches = 0
    m_k, g_k = step.loss_and_grad(model, *batch, step.generator(5, 0))
    torch.cuda.synchronize()
    step_launches = {n: c.launches for n, c in counters.items()}
    m_r, g_r = step.loss_and_grad(model, *batch, step.generator(5, 0))  # the witness again
    repeats = float(m_r["loss"]) == float(m_k["loss"]) and all(
        torch.equal(a, b) for a, b in zip(g_k, g_r))
    del g_r
    print(f"[c1] the witnesses' state: step {state.step}, sha256 of the trained leaves "
          f"{digest.hexdigest()[:16]}, their sum {total_sum:.9e}; the kernel step taken twice "
          f"gives the same loss and gradients bit for bit: {repeats}", flush=True)
    check(repeats, "the C1 witness step does not repeat at one state")
    kernel = tr.flash_attention
    tr.flash_attention = fa.flash_attention_plain
    try:
        m_t, g_t = step.loss_and_grad(model, *batch, step.generator(5, 0))
        torch.cuda.synchronize()
    finally:
        tr.flash_attention = kernel
    dl = abs(float(m_k["loss"]) - float(m_t["loss"])) / abs(float(m_t["loss"]))
    cos_all, leaf, lows = c1_grad_agreement(names, g_k, g_t)
    attn = attn_leaf_errors(names, g_k, g_t)
    print(f"[c1] step {state.step}, one fixed batch and generator: launches in the step K6 "
          f"{step_launches['K6']} K7 {step_launches['K7']} K8 {step_launches['K8']}; vs the same "
          f"step with the twins' attention on the card: loss "
          f"{float(m_k['loss']):.6f} vs {float(m_t['loss']):.6f} (relative {dl:.3e}, limit "
          f"{TOL_C1_LOSS}); over {len(names)} trained leaves: cosine of the whole gradient "
          f"{cos_all:.7f} (limit {TOL_C1_COS}), worst leaf |err| / max(|g|, median leaf |g|) "
          f"{leaf[0]:.3e} ({leaf[1]}, limit {TOL_C1_LEAF}); lowest leaf cosines (|g| / median "
          f"|g|): {lows}; {len(attn)} attention projection leaves, |err| / |g| (limit "
          f"{TOL_C1_ATTN_LEAF}), the largest: "
          + ", ".join(f"{n} {e:.3e}" for e, n in attn[:4]), flush=True)
    check(step_launches == {"K6": C1_SITES, "K7": C1_SITES, "K8": C1_SITES},
          f"one C1 step launched {step_launches}")
    if leaf[0] > TOL_C1_LEAF:  # a third reading at this state before the check fails
        f32 = make_stytrans(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
        f32.load_state_dict(model.state_dict())
        t2.init_transformer_train(f32, tcfg)
        tr.flash_attention = fa.flash_attention_plain  # the twins take f32
        try:
            _, g_f = t2.make_transformer_train_step(f32, tcfg).loss_and_grad(
                f32, *batch, step.generator(5, 0))
        finally:
            tr.flash_attention = kernel
        for tag, g in (("kernel", g_k), ("twin", g_t)):
            cos_f, leaf_f, _ = c1_grad_agreement(names, g, g_f)
            print(f"[c1] the {tag} step vs the f32 twin-attention step at this state: cosine "
                  f"{cos_f:.7f}, worst leaf {leaf_f[0]:.3e} ({leaf_f[1]})", flush=True)
        del f32, g_f
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
    return ckpt, styles


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
    Returns the finetuned model."""
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
    tp.run_temporal_finetune(model, renders, coor_maps, cps, styles, (H, W, FOCAL), ccfg,
                             seed=C2_SEED, is_ndc=True, out_dir=out, device="cuda",
                             log_every=C2_PRINT)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    with open(os.path.join(out, "logs", "temporal.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    counted = [r for r in records if r["step"] > C2_WARM]
    moved = sorted({k.split(".")[0] for k, v in model.state_dict().items()
                    if not torch.equal(v, before[k])})
    pngs = [f"{n}_{b:03d}.png" for n in tp.DEBUG_IMAGES for b in range(ccfg.batch_size)]
    missing = [f for f in pngs + ["style_image.png"] if not os.path.exists(os.path.join(out, f))]
    print(f"[c2] StyTrans d_model 512, 8 heads, 3+3 layers, FFN 2048, dropout {C1_RATE}, bf16, "
          f"flash, from phase 11's state: {ccfg.max_iter} steps of batch {ccfg.batch_size} x "
          f"{ccfg.patch}x{ccfg.patch} patches of {renders.shape[0]} {H}x{W} renders, "
          f"{len(style_files)} 512x512 styles, temporal weight {ccfg.temporal_weight}, splat "
          f"radius {ccfg.splat_radius}, threshold {ccfg.space_dist_threshold}: steps "
          f"{C2_WARM + 1}-{ccfg.max_iter} in {len(counted)} log windows; launches K6 "
          f"{launches['K6']} K7 "
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
    win = rz.splat_winners(pcl, w2c.cuda(), proj.cuda(), H, W, ccfg.splat_radius)
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
          f"{H}x{W}, radius {ccfg.splat_radius}, one w2c), card vs CPU: hit masks differ at "
          f"{mask_share:.3e} of the pixels "
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
    return model


def phase_c3c2(fa, model, geo_dir: str, styles_dir: str, root: str):
    """Phase C3 with phase 12's decoder over phase 5's views and all eight
    styles. Returns the style features."""
    from PIL import Image

    from tgtc_torch.train import stylize as st

    style_files = sorted(os.listdir(styles_dir))
    style_imgs = [load_rgb(os.path.join(styles_dir, f)) for f in style_files]
    views = sorted(f for f in os.listdir(geo_dir) if f.startswith("rgb_"))
    out = os.path.join(root, "stylized_c2")
    fa.flash_attention_fwd.launches = 0
    res = st.stylize_all(model, geo_dir, style_imgs, style_files, out, device="cuda")
    launches = fa.flash_attention_fwd.launches
    jpgs = [os.path.join(out, f"style_{s:02d}", f"{i + 1:03d}.jpg")
            for s in range(len(style_files)) for i in range(len(views))]
    sizes = [Image.open(p).size for p in jpgs if os.path.exists(p)]
    feats = res["style_features"]
    print(f"[c3c2] stylize_all with phase 12's decoder: {len(views)} views x "
          f"{len(style_files)} styles: {len(sizes)} of {len(jpgs)} JPEGs at {W}x{H}; "
          f"style_features "
          f"{feats.shape} finite {bool(np.isfinite(feats).all())}; K6 launches {launches} "
          f"(expect {C3_SITES} x {len(jpgs)})", flush=True)
    check(len(sizes) == len(jpgs) and all(sz == (W, H) for sz in sizes),
          "C3 after C2: JPEGs missing or of the wrong size")
    check(feats.shape == (len(style_files), 1024) and bool(np.isfinite(feats).all()),
          "C3 after C2: style_features")
    check(launches == C3_SITES * len(jpgs), f"C3 after C2 launched K6 {launches} times")
    return feats


def phase_d(ks, kst, trained, styles_dir: str, feats: np.ndarray, n_views: int, root: str):
    """Phase D: the VAE through tools/train2d's vae task at the pipeline's
    settings, the card step against the CPU step, the latent table seeded
    from phase 13's features, and a stylized frame rendered from it.
    Returns the VAE checkpoint."""
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
    with quiet, contextlib.redirect_stdout(quiet):  # one log line a step
        check(train2d.main(argv + ["--max_iter", str(D_WARM)], device="cuda") == 0,
              "VAE warm-up")
        check(train2d.main(argv + ["--max_iter", str(D_STEPS)], device="cuda") == 0,
              "VAE resumed run")
    with open(os.path.join(log, "vae.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    losses = [r["loss"] for r in records]
    first, last = float(np.mean(losses[:100])), float(np.mean(losses[-100:]))
    ckpt = os.path.join(save, "vae", f"ckpt_{D_STEPS:08d}.pt")
    print(f"[d] VAE 1024 -> 512 x3 -> 32 (kl 0.1, lr 1e-3, batch 8) on VGG relu4_1 features "
          f"of 256x256 crops of {len(os.listdir(styles_dir))} styles resized to 512: {D_WARM} "
          f"warm-up steps, then {D_STEPS - D_WARM} steps resumed; mean loss of the first 100 "
          f"steps {first:.4f}, of the last 100 {last:.4f}",
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
    frame = renderer.render_image(fo, fd, 0, 0, block=BLOCK, seed=F_SEED)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"[d] stylized {H}x{W} frame of style 0 from the seeded table: launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    check(launches == {"K1": 0, "K2": 0, "K4": blocks, "K5": blocks},
          f"seeded-latent frame launch counts {launches}")
    check(bool(torch.isfinite(frame["rgb"]).all()), "seeded-latent frame not finite")
    stylized_vs_eager(renderer, trained, concat, style, fo, fd, frame, "d",
                      "seeded-latent frame")
    return ckpt


class W128Launches:
    """K2's launches on a 128-wide trunk (the wrapper's ``launches_w128``)
    behind the ``launches`` attribute the other counters have."""

    def __init__(self, k2):
        self.k2 = k2

    @property
    def launches(self) -> int:
        return self.k2.launches_w128

    @launches.setter
    def launches(self, n: int) -> None:
        self.k2.launches_w128 = n


def all_counters(ks, kg, kst, fa):
    return {"K1": ks.fused_nerf_apply_t, "K2": ks.fused_nerf_sigma_apply_t,
            "K2-W128": W128Launches(ks.fused_nerf_sigma_apply_t),
            "K3": kg.fused_nerf_bwd, "K4": kst.fused_style_apply_t,
            "K5": kst.fused_sigma_apply_t, "K6": fa.flash_attention_fwd,
            "K7": fa.flash_attention_bwd_dq, "K8": fa.flash_attention_bwd_dkv}


def step_groups(state, grads):
    """A Phase-E gradient list as its three groups: concat, style, latents."""
    n = len(list(state.concat.parameters()))
    return [grads[:n], grads[n:-1], grads[-1:]]


def phase_e(ks, kg, kst, fa, trained, root: str, styles_dir: str, vae_ckpt: str):
    """Phase E at fern's settings (configs/fern.txt through
    tgtc_torch/config.py) through train/style3d.run_style3d: 20 warm-up
    steps, then 300 counted steps resumed from the warm-up's checkpoint; the
    card step against the CPU step; a 756x1008 frame of style 0 from the
    trained field through phase 7's renderer settings; a checkpoint round
    trip."""
    from tgtc_torch.config import load_config
    from tgtc_torch.data.llff import load_llff_data
    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP
    from tgtc_torch.models.vae import VaeConfig, make_vae
    from tgtc_torch.render.fast_style import FusedStyleRenderer
    from tgtc_torch.render.volume import RenderSettings
    from tgtc_torch.train import style3d as s3

    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(["--config", os.path.join(repo, "configs", "fern.txt"),
                       "--i_print", str(E_PRINT)])
    origin = cfg.origin_step
    # the coherence gate after the warm-up (fern's is origin + 1999): at
    # λ_coh 1e2 the coherence gradient owns the update while it is on (the
    # diagnostic reads it), and the counted loop runs the plain regime that
    # holds 6,000 of the reference's 8,000 Phase-E steps
    cfg = dataclasses.replace(cfg, coh_until_step=origin + E_WARM - 1)
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default: full f32 matmuls
    scene = load_llff_data(os.path.join(root, "scene"), factor=1)
    geo_dir = os.path.join(root, "geometry")

    def trunks(device):
        out = []
        for which in ("coarse", "fine"):
            m = NerfMLP(NerfConfig())
            m.load_state_dict(trained[which])
            out.append(m.to(device))
        return out

    nerf = trunks("cuda")
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in nerf]
    vae = make_vae(VaeConfig(), device="cuda")
    vae.load_state_dict(torch.load(vae_ckpt, map_location="cuda", weights_only=True)["model"])
    scfg = s3.style_train_config(cfg, 0.0, 1.0)
    print(f"[e] configs/fern.txt: batch_size_style {cfg.batch_size_style}, N_samples "
          f"{cfg.N_samples}+{cfg.N_samples_fine}, sigma_noise_std {cfg.sigma_noise_std}, "
          f"loss_coh_lambda {cfg.loss_coh_lambda:g} until step {scfg.coh_until_step}, style_D "
          f"{cfg.style_D}, netwidth {cfg.netwidth}, vae_latent {cfg.vae_latent}, lrate "
          f"{cfg.lrate:g} / latent {scfg.latent_lrate:g}, origin_step {origin}; trunks bf16 "
          f"(phase 4's), style MLPs f32, torch.backends.cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    out = os.path.join(root, "e_run")
    counters = all_counters(ks, kg, kst, fa)
    lines = []
    state, warm = s3.run_style3d(dataclasses.replace(cfg, total_step=origin + E_WARM), scene,
                                 geo_dir, styles_dir, *nerf, vae, out, device="cuda",
                                 print_fn=lines.append)
    for c in counters.values():
        c.launches = 0
    state, hist = s3.run_style3d(dataclasses.replace(cfg, total_step=origin + E_WARM + E_STEPS),
                                 scene, geo_dir, styles_dir, *nerf, vae, out, device="cuda",
                                 print_fn=lines.append)
    torch.cuda.synchronize()
    step_launches = {n: c.launches for n, c in counters.items()}
    with open(os.path.join(out, "logs", "style.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    diag = records[0]
    sizes = np.diff([origin + E_WARM] + [r["step"] for r in hist["records"]])  # log windows
    losses = {k: warm[k] + hist[k] for k in s3.LOSSES}
    first, last = (float(np.mean(losses["loss_rgb"][sl])) for sl in (slice(0, 50),
                                                                     slice(-50, None)))
    # the coherence term's steps: 0 at the first (no buffers yet) and at each
    # frame cycle's reset (cnt == frame_num: every other step with 2 views)
    cnt, active = 0, []
    for _ in losses["loss_coh"]:
        active.append(cnt not in (0, len(scene.images)))
        cnt = 1 if cnt == len(scene.images) else cnt + 1
    unchanged = all(torch.equal(v, b[k]) for m, b in zip(nerf, before)
                    for k, v in m.state_dict().items())
    coh_min = min(x for x, on in zip(losses["loss_coh"], active) if on)
    print(f"[e] {scene.images.shape[0]} views x {state.latents.shape[0]} styles of {H}x{W}: "
          f"coherence diagnostic at step {diag['step']}: ratio {diag.get('coh_grad_ratio')} "
          f"(|grad coh| {diag.get('grad_norm_coh')}, |grad rgb| {diag.get('grad_norm_rgb')}, "
          f"warning above {s3.COH_RATIO_WARN}); {E_WARM} warm-up steps (the coherence term "
          f"on), then {E_STEPS} steps resumed, logged in windows of "
          f"{', '.join(str(n) for n in sizes)}; loss_coh "
          f"{losses['loss_coh'][0]} at the first step, 0 at "
          f"{sum(x == 0.0 for x in losses['loss_coh'])} of {len(active)} steps (expect "
          f"{active.count(False)}), min over the active steps {coh_min:.5f}; mean loss_rgb of "
          f"the first 50 steps {first:.5f}, of the last 50 {last:.5f}; trunks bitwise unchanged "
          f"{unchanged}; hand-written kernel launches in the counted run {step_launches}",
          flush=True)
    check("coh_grad_ratio" in diag and diag["step"] == origin
          and math.isfinite(diag["coh_grad_ratio"]), "the coherence diagnostic did not run")
    check(len(losses["loss"]) == E_WARM + E_STEPS
          and all(math.isfinite(x) for k in s3.LOSSES for x in losses[k]),
          "Phase-E losses not finite or missing")
    check(all((x > 0.0) == on for x, on in zip(losses["loss_coh"], active)),
          "loss_coh must be 0 at the first step and at each cycle's reset, > 0 elsewhere")
    check(last < first, "Phase-E loss_rgb did not fall")
    check(unchanged, "Phase E changed a trunk")
    check(int(sizes.sum()) == E_STEPS, f"the log windows cover {sizes.sum()} steps")
    check(all(v == 0 for v in step_launches.values()),
          f"the Phase-E step launched a hand-written kernel: {step_launches}")

    # one step on the card against the same step on the CPU, TF32 off, with
    # fern's own gate, so that the coherence term's gradient is in the step
    field = s3.style_field_config(cfg, nerf[0])
    fern_cfg = s3.style_train_config(dataclasses.replace(cfg, coh_until_step=-1), 0.0, 1.0)
    res = []
    draws = None
    for dev in ("cpu", "cuda"):
        data = s3.load_style_scene(scene, geo_dir, styles_dir, device=dev)
        st = s3.init_style_state(torch.Generator().manual_seed(0), field, scfg, data.style_num,
                                 data.frame_num, device=dev)
        st.load_state_dict(state.state_dict())
        st.cnt = 1  # the coherence term active, as after a cycle's reset
        step = s3.make_style_train_step(*(nerf if dev == "cuda" else trunks("cpu")), fern_cfg)
        if draws is None:
            draws = step.draw(data, st, seed=E_SEED)
        d = s3.StyleStepDraws(*(tuple(t.to(dev) for t in v) if isinstance(v, tuple) else v.to(dev)
                                for v in dataclasses.astuple(draws)))
        m, g, _ = step.loss_and_grad(st, data, d)
        res.append(({k: float(v) for k, v in m.items()},
                    [torch.cat([t.double().cpu().flatten() for t in grp])
                     for grp in step_groups(st, g)]))
        del data, st
    (m_cpu, g_cpu), (m_gpu, g_gpu) = res
    cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(g_gpu, g_cpu)]
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    pairs = ", ".join(f"{k} {m_gpu[k]:.6f} vs {m_cpu[k]:.6f} (relative {rel[k]:.2e})"
                      for k in m_cpu)
    print(f"[e] one Phase-E step at step {state.step} (cnt 1 and fern's gate at step "
          f"{fern_cfg.coh_until_step}: the coherence term and its gradient in), card vs CPU "
          f"(same state and draws, TF32 off, bf16 trunks): {pairs}; gradient cosine concat "
          f"{cos[0]:.6f}, style {cos[1]:.6f}, latents {cos[2]:.6f} (limits {TOL_E_LOSS} and "
          f"{TOL_E_COS})", flush=True)
    check(max(rel.values()) <= TOL_E_LOSS and min(cos) >= TOL_E_COS,
          "the Phase-E step on the card disagrees with the CPU's")

    # Phase F from the trained field: the checkpoint through load_style_field
    concat, style, lat = s3.load_style_field(os.path.join(out, "ckpt_style"), field,
                                             device="cuda")
    settings = RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    renderer = FusedStyleRenderer.from_params(trained["coarse"], trained["fine"],
                                              concat.state_dict(), style.state_dict(), lat,
                                              settings, coarse_rgb=False, device="cuda")
    ro, rd = rays_for_poses(H, W, trained["intrinsics"], trained["render_poses"][:1],
                            use_ndc=True, device="cuda")
    fo, fd = ro[0].reshape(-1, 3), rd[0].reshape(-1, 3)
    blocks = math.ceil(fo.shape[0] / BLOCK)
    for c in counters.values():
        c.launches = 0
    frame = renderer.render_image(fo, fd, 0, 0, block=BLOCK, seed=F_SEED)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"[e] stylized {H}x{W} frame of style 0 from the trained field (checkpoint at step "
          f"{state.step}): launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    check(launches == {**{k: 0 for k in counters}, "K4": blocks, "K5": blocks},
          f"trained-field frame launch counts {launches}")
    check(bool(torch.isfinite(frame["rgb"]).all()), "trained-field frame not finite")
    stylized_vs_eager(renderer, trained, concat, style, fo, fd, frame, "e", "trained-field frame")

    # checkpoint round trip: the in-memory field renders what the checkpoint does
    mem = FusedStyleRenderer.from_params(trained["coarse"], trained["fine"],
                                         state.concat.state_dict(), state.style.state_dict(),
                                         state.latent_state(detach=True), settings,
                                         coarse_rgb=False, device="cuda")
    a, b = (r.render_image(fo[:BLOCK], fd[:BLOCK], 0, 0, block=BLOCK, seed=F_SEED)
            for r in (mem, renderer))
    same = all(torch.equal(a[k], b[k]) for k in a)
    print(f"[e] checkpoint round trip at step {state.step}: render of {BLOCK} rays bitwise "
          f"equal: {same}", flush=True)
    check(same, "the Phase-E checkpoint renders differently from the trained state")


def phase_pipeline(ks, kg, kst, fa, root: str, card: str):
    """Phase 16: the pipeline A→F as a user runs it, in this process, at
    configs/fern.txt's settings read through tgtc_torch/config.py (widths,
    samples, batches, λ's, chunk 32,768 and factor 4 kept). Cuts: a
    synthetic 4-view scene loaded at 756x1008 (write_scene at factor 4) for
    fern's 20 views; 2 seeded 512x512 styles; origin_step 300 (of 120,001),
    total_step 500 (200 Phase-E steps of 8,000), i_print 50; through the
    Pipeline's own arguments and attributes (the JAX end-to-end test's
    hooks) C1 50 steps (of 5,000), C2 20 (of 100), the VAE 200 (of 2,000).

    Runs: Pipeline.train_nerf() and _run_after_nerf() (A, evaluate, B, C1,
    C2, C3, D, E); cli.main([... "--render_train_style"]) (F);
    cli.main([... "--render_train"]) (plain renders); cli.main([...]) again
    (the re-entry run). Each phase method is wrapped here to read its peak
    allocated bytes and its kernel launches (a device sync at each end);
    each run's launch counts are zeroed just before it and read
    just after, and must equal the sum of its phases'. Checks every phase's
    artifacts, checkpoint steps and launches, F's first 32,768-ray block
    against the eager f32 stylized render (phase 7's bounds), and that the
    re-entry run adds no checkpoint and no training log line. Returns the
    run's argv and experiment directory."""
    import functools
    import json as _json

    from PIL import Image

    from tgtc_torch import cli
    from tgtc_torch.config import load_config
    from tgtc_torch.models.nerf import NerfConfig
    from tgtc_torch.models.style_field import StyleFieldConfig
    from tgtc_torch.render.fast_style import FusedStyleRenderer
    from tgtc_torch.train import pipeline as P
    from tgtc_torch.train.checkpoint import CheckpointManager
    from tgtc_torch.train.style3d import load_style_field
    from tgtc_torch.utils import video

    work = os.path.join(root, "pipeline")
    scene_dir = write_scene(os.path.join(work, "scene"), n=PIPE_VIEWS, factor=PIPE_FACTOR)
    styles_dir = write_styles(os.path.join(work, "styles"), n=PIPE_STYLES)
    repo = os.path.dirname(os.path.abspath(__file__))
    argv = ["--config", os.path.join(repo, "configs", "fern.txt"), "--datadir", scene_dir,
            "--styledir", styles_dir, "--basedir", os.path.join(work, "logs"),
            "--origin_step", str(PIPE_ORIGIN), "--total_step", str(PIPE_TOTAL),
            "--i_print", str(PIPE_PRINT)]
    cfg = load_config(argv)
    counters = all_counters(ks, kg, kst, fa)
    read = lambda: {k: c.launches for k, c in counters.items()}
    zero = {k: 0 for k in counters}
    phases, runs, run = {}, {}, ["A-E"]
    first_block, turntables, streamed = {}, [], []

    def watched(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held, before = torch.cuda.memory_allocated(), read()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                after = read()
                phases[(run[0], name)] = dict(
                    peak=torch.cuda.max_memory_allocated(), held=held,
                    launches={k: after[k] - before[k] for k in after})
        return wrapper

    def turntable(fn):
        def wrapper(self, out_dir, pattern=None):
            turntables.append(out_dir)
            return fn(self, out_dir, pattern)
        return wrapper

    def counting(fn):
        def add(self, frame):
            streamed.append(self._out_path)
            return fn(self, frame)
        return add

    def recording(fn):
        def render(self, rays_o, rays_d, style_ids, frame_ids, u=None, generator=None):
            if u is None:  # the draw FusedStyleRenderer.render makes
                u = torch.rand((rays_o.shape[0], self.settings.n_samples), generator=generator,
                               device=rays_o.device)
            out = fn(self, rays_o, rays_d, style_ids, frame_ids, u=u)
            if not first_block:
                first_block.update(bo=rays_o.clone(), bd=rays_d.clone(), u=u.clone(),
                                   sid=int(style_ids[0]), fid=int(frame_ids[0]),
                                   rgb=out["rgb"].clone(), t_exp=out["t_exp"].clone(),
                                   latent_state=self.latent_state, settings=self.settings)
            return out
        return render

    def drive(name, fn):
        run[0] = name
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        runs[name] = dict(launches=read())
        summed = dict(zero)
        for (r, _), rec in phases.items():
            if r == name:
                summed = {k: summed[k] + rec["launches"][k] for k in summed}
        check(summed == runs[name]["launches"], f"the {name} run launched kernels outside its "
              f"phases: {runs[name]['launches']} vs {summed}")

    def run_a_to_e():
        pipe = P.Pipeline(cfg)
        pipe.vae_iters = PIPE_VAE
        pipe.ensure_style2d = functools.partial(P.Pipeline.ensure_style2d, pipe,
                                                c1_iters=PIPE_C1, c2_iters=PIPE_C2)
        try:
            pipe.train_nerf()
            pipe._run_after_nerf()
        finally:
            pipe.close()

    wrapped = {(P.Pipeline, "train_nerf"): "A", (P.Pipeline, "evaluate"): "evaluate",
               (P.Pipeline, "ensure_geometry"): "B", (P, "train_transformer"): "C1",
               (P, "run_temporal_finetune"): "C2", (P, "stylize_all"): "C3",
               (P.Pipeline, "ensure_vae"): "D", (P, "run_style3d"): "E",
               (P.Pipeline, "render_stylized"): "F", (P.Pipeline, "render_plain"): "plain"}
    originals = {key: getattr(*key) for key in
                 list(wrapped) + [(P.Pipeline, "_write_turntable"), (FusedStyleRenderer, "render"),
                                  (video.StreamingGifWriter, "add")]}
    try:
        for (obj, name), phase in wrapped.items():
            setattr(obj, name, watched(phase, originals[(obj, name)]))
        P.Pipeline._write_turntable = turntable(originals[(P.Pipeline, "_write_turntable")])
        video.StreamingGifWriter.add = counting(originals[(video.StreamingGifWriter, "add")])
        drive("A-E", run_a_to_e)
        FusedStyleRenderer.render = recording(originals[(FusedStyleRenderer, "render")])
        drive("F", lambda: check(cli.main(argv + ["--render_train_style"]) == 0, "cli F"))
        FusedStyleRenderer.render = originals[(FusedStyleRenderer, "render")]
        drive("plain", lambda: check(cli.main(argv + ["--render_train"]) == 0, "cli plain"))
        exp, logs = cfg.exp_dir, os.path.join(cfg.exp_dir, "logs")
        ckpt_dirs = ("ckpt_nerf", "ckpt_trans", "ckpt_trans_c2", "ckpt_vae", "ckpt_style")
        listing = lambda: {d: sorted(os.listdir(os.path.join(exp, d))) for d in ckpt_dirs}
        lines = lambda: {f: len(open(os.path.join(logs, f)).read().splitlines())
                         for f in sorted(os.listdir(logs)) if f.endswith(".jsonl")}
        ckpts_before, lines_before = listing(), lines()
        drive("reentry", lambda: check(cli.main(argv) == 0, "cli re-entry"))
    finally:
        for (obj, name), fn in originals.items():
            setattr(obj, name, fn)

    # ---- checks, phase by phase
    blocks16 = math.ceil(H * W / BLOCK)          # FusedNerfRenderer.render_image's default
    blocks_f = math.ceil(H * W / (1 << 15))      # Pipeline._render_block at chunk 32,768
    want = {
        "A": {"K1": a_loop_launches(PIPE_ORIGIN), "K3": a_loop_launches(PIPE_ORIGIN)},
        "evaluate": {"K1": blocks16, "K2": blocks16},
        "B": {"K1": PIPE_VIEWS * blocks16, "K2": PIPE_VIEWS * blocks16},
        "C1": {"K6": c1_loop_launches(PIPE_C1) + C3_SITES, "K7": c1_loop_launches(PIPE_C1),
               "K8": c1_loop_launches(PIPE_C1)},
        "C2": {"K6": C1_SITES * PIPE_C2 + C1_SITES},
        "C3": {"K6": C3_SITES * PIPE_STYLES * PIPE_VIEWS},
        "D": {}, "E": {},
        "F": {"K4": PIPE_STYLES * PIPE_VIEWS * blocks_f, "K5": PIPE_STYLES * PIPE_VIEWS * blocks_f},
        "plain": {"K1": PIPE_VIEWS * blocks16, "K2": PIPE_VIEWS * blocks16}}
    run_of = {"F": "F", "plain": "plain"}
    for phase in PIPE_PHASES:
        rec = phases.get((run_of.get(phase, "A-E"), phase))
        check(rec is not None, f"pipeline phase {phase} did not run")
        check(rec["launches"] == {**zero, **want[phase]},
              f"pipeline phase {phase} launch counts {rec['launches']}, expected {want[phase]}")
    print("[pipeline] launches by phase: " + "; ".join(
        f"{p} " + ", ".join(f"{k} {v}" for k, v in want[p].items()) if want[p] else f"{p} none"
        for p in PIPE_PHASES) + " (each held; every other kernel 0)", flush=True)

    size_ok = lambda path: Image.open(path).size == (W, H)
    check(CheckpointManager(os.path.join(exp, "ckpt_nerf")).steps()[-1] == PIPE_ORIGIN,
          "ckpt_nerf's newest step")
    evals = [_json.loads(x) for x in open(os.path.join(logs, "train.jsonl"))]
    check(len(evals) == 2, f"{len(evals)} EVAL lines, not one from each training run")
    ev = evals[0]
    check(math.isfinite(ev["psnr"]) and ev["holdout_view"] >= 0, f"the EVAL line {ev}")
    gen = os.path.join(exp, "nerf_gen_data2")
    check(os.path.exists(os.path.join(gen, "geometry.npz")) and all(
        size_ok(os.path.join(gen, f"rgb_{i:05d}.png")) for i in range(PIPE_VIEWS)),
        "Phase B's artifacts")
    check(listing()["ckpt_trans"] == [f"ckpt_{PIPE_C1:08d}.pt"]
          and os.path.exists(os.path.join(exp, "test", f"{PIPE_C1}.png")), "C1's artifacts")
    check(listing()["ckpt_trans_c2"] == [f"ckpt_{PIPE_C2:08d}.pt"] and all(
        os.path.exists(os.path.join(exp, f"{n}_{b:03d}.png"))
        for n in ("stylized_content", "warped_stylized_content", "warped_mask", "coor_dist_msk")
        for b in range(4)) and os.path.exists(os.path.join(exp, "style_image.png")),
        "C2's artifacts")
    stylized = os.path.join(scene_dir, f"stylized_gen_{cfg.factor}")
    npz = np.load(os.path.join(stylized, "stylized_data.npz"))
    jpgs = [os.path.join(d, f"{i:03d}.jpg") for d in npz["style_paths"]
            for i in range(1, PIPE_VIEWS + 1)]
    check(npz["style_features"].shape == (PIPE_STYLES, 1024)
          and bool(np.isfinite(npz["style_features"]).all())
          and len(jpgs) == PIPE_STYLES * PIPE_VIEWS and all(size_ok(p) for p in jpgs),
          "C3's artifacts ([S, F] = [2, 4])")
    check(listing()["ckpt_vae"] == [f"ckpt_{PIPE_VAE:08d}.pt"], "ckpt_vae's step")
    check(listing()["ckpt_style"][-1] == f"ckpt_{PIPE_TOTAL:08d}.pt", "ckpt_style's step")
    style_lines = [_json.loads(x) for x in open(os.path.join(logs, "style.jsonl"))]
    losses = [v for r in style_lines for k, v in r.items() if k.startswith("loss")]
    check(len(losses) > 0 and all(math.isfinite(v) for v in losses),
          "a Phase-E loss is not finite")
    out_f = os.path.join(exp, "render_train_style")
    frames = [os.path.join(out_f, f"style_{s:05d}_fine{k}_{f:05d}.png")
              for s in range(PIPE_STYLES) for f in range(PIPE_VIEWS) for k in ("", "_depth")]
    gif = os.path.join(out_f, "video.gif")
    check(all(os.path.exists(p) and size_ok(p) for p in frames), "Phase F's frames")
    # PIL merges equal consecutive frames into one, so the GIF's frame count
    # is no witness: the frames handed to the streaming writer are
    check(os.path.exists(gif) and streamed.count(gif) == PIPE_STYLES * PIPE_VIEWS
          and out_f not in turntables,
          f"Phase F's turntable was not streamed ({streamed.count(gif)} frames streamed, "
          f"written after the fact: {out_f in turntables})")
    out_p = os.path.join(exp, "render_train")
    check(all(size_ok(os.path.join(out_p, f"{k}_{i:05d}.png"))
              for k in ("rgb", "depth") for i in range(PIPE_VIEWS))
          and out_p in turntables
          and os.path.exists(os.path.join(out_p, "video.gif")), "the plain renders")
    check(listing() == ckpts_before, f"the re-entry run changed the checkpoints: "
          f"{ckpts_before} -> {listing()}")
    after = lines()
    check(after.pop("train.jsonl") == lines_before.pop("train.jsonl") + 1 and after == lines_before,
          f"the re-entry run appended training log lines: {lines_before} -> {after}")
    check(runs["reentry"]["launches"] == {**zero, "K1": blocks16, "K2": blocks16},
          f"re-entry run launch counts {runs['reentry']['launches']}")
    print(f"[pipeline] artifacts held: ckpt_nerf at {PIPE_ORIGIN}, EVAL psnr {ev['psnr']:.3f} "
          f"dB (view {ev['holdout_view']}), geometry and {PIPE_VIEWS} renders, ckpt_trans at "
          f"{PIPE_C1} and test/{PIPE_C1}.png, ckpt_trans_c2 at {PIPE_C2} and the debug PNGs, "
          f"{len(jpgs)} stylized views, ckpt_vae at {PIPE_VAE}, ckpt_style at {PIPE_TOTAL} with "
          f"{len(losses)} finite logged losses, {len(frames)} Phase-F PNGs and a streamed "
          f"{PIPE_STYLES * PIPE_VIEWS}-frame GIF, {PIPE_VIEWS} plain renders; the re-entry run "
          f"added no checkpoint or training line and launched K1 {blocks16} and K2 {blocks16} "
          f"(evaluate) only", flush=True)

    # F's first block (32,768 rays x 128 samples in one K4 launch) against the
    # eager f32 stylized render of the same trunks, field and jitter
    check(first_block["bo"].shape[0] == 1 << 15, "F's first block size")
    sd = CheckpointManager(os.path.join(exp, "ckpt_nerf")).restore()
    field = StyleFieldConfig(style_d=cfg.style_D, width=cfg.netwidth, latent_dim=cfg.vae_latent,
                             embed_dim=NerfConfig().input_ch)
    concat, style, _ = load_style_field(os.path.join(exp, "ckpt_style"), field, device="cuda")
    b = first_block
    stylized_rays_vs_eager({"coarse": sd["coarse"], "fine": sd["fine"]}, concat, style,
                           b["latent_state"], b["settings"], b["bo"], b["bd"], b["sid"],
                           b["fid"], b["u"], b["rgb"], b["t_exp"], "pipeline",
                           "the pipeline's first Phase-F block")

    rec = lambda p: phases[(run_of.get(p, "A-E"), p)]
    gb = lambda n: n / 2 ** 30
    print(f"[pipeline] {card}: peak allocated GiB (held at the phase's start) " + ", ".join(
        f"{p} {gb(rec(p)['peak']):.2f} ({gb(rec(p)['held']):.2f})" for p in PIPE_PHASES),
        flush=True)
    return {"argv": argv, "exp": exp}


def w128_case(ks, packed, pts, tag: str) -> None:
    """K2 on a 128-wide packing against its twin on the card at ``pts``,
    launched twice: max|sigma err| within TOL_SIGMA_W128, the second launch
    bit for bit the first."""
    s1 = ks.fused_nerf_sigma_apply_t(packed, pts)
    s2 = ks.fused_nerf_sigma_apply_t(packed, pts)
    torch.cuda.synchronize()
    e = float((s1 - ks.fused_nerf_sigma_apply_t_plain(packed, pts)).abs().max())
    print(f"[levers] K2-W128 {tag} P={pts.shape[1]}: max|sigma err| {e:.3e}; repeat bit for bit "
          f"{torch.equal(s1, s2)}", flush=True)
    check(bool(torch.isfinite(s1).all()) and e <= TOL_SIGMA_W128,
          f"K2-W128 {tag} disagrees with its twin at P={pts.shape[1]}")
    check(torch.equal(s1, s2), f"K2-W128 {tag} repeat not bitwise equal at P={pts.shape[1]}")


@contextlib.contextmanager
def twins(module, **plain):
    """``module``'s kernel wrappers swapped for their plain twins (a
    comparison on the card), restored after."""
    saved = {name: getattr(module, name) for name in plain}
    for name, fn in plain.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def block_vs_twins(got, ref, tag: str, what: str) -> None:
    """A fused render's block against the same chain on the plain twins:
    rgb and t_exp within TOL_RENDER on all but 0.1% of the rays (the
    sample selection may tie-break apart where the kernel's σ and the
    twin's differ in their last bits)."""
    err = torch.maximum((got["rgb"] - ref["rgb"]).abs().amax(-1),
                        (got["t_exp"] - ref["t_exp"]).abs())
    bad = int((err > TOL_RENDER).sum())
    print(f"[{tag}] first {err.shape[0]} rays vs the same chain on the plain twins: max|err| "
          f"over rgb and t_exp {float(err.max()):.3e}, median {float(err.median()):.3e}; "
          f"{bad} rays above {TOL_RENDER}", flush=True)
    check(bool(torch.isfinite(got["rgb"]).all()), f"{what} not finite")
    check(bad <= err.shape[0] // 1000, f"{what} disagrees with the plain-twin chain")


def agreement_db(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(torch.mean((a.clamp(0, 1) - b.clamp(0, 1)) ** 2))
    return -10.0 * math.log10(max(mse, 1e-12))


def phase_levers(ks, kg, kst, trained, pipe: dict, root: str):
    """Phase 17 (see the module docstring). Returns the distilled
    proposal's state dict."""
    from PIL import Image

    from tgtc_torch import cli
    from tgtc_torch.data.llff import load_llff_data
    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP
    from tgtc_torch.models.style_field import init_latents
    from tgtc_torch.render import fast as rf
    from tgtc_torch.render import fast_style as rfs
    from tgtc_torch.render.distill import distill_proposal
    from tgtc_torch.render.fast import FusedNerfRenderer
    from tgtc_torch.render.fast_style import FusedStyleRenderer, block_generator
    from tgtc_torch.render.grid import GridSpec, build_sigma_grid, ray_bounds
    from tgtc_torch.render.volume import RenderSettings
    from tgtc_torch.train import nerf_trainer as tt

    counters = {"K1": ks.fused_nerf_apply_t, "K2": ks.fused_nerf_sigma_apply_t,
                "K2-W128": W128Launches(ks.fused_nerf_sigma_apply_t),
                "K3": kg.fused_nerf_bwd, "K4": kst.fused_style_apply_t,
                "K5": kst.fused_sigma_apply_t}
    zero = {k: 0 for k in counters}
    read = lambda: {k: c.launches for k, c in counters.items()}

    def reset():
        for c in counters.values():
            c.launches = 0

    # ---- 1. the distilled proposal from phase 4's fine trunk
    fine = NerfMLP(NerfConfig())
    fine.load_state_dict(trained["fine"])
    fine.cuda()
    ro_t, rd_t = rays_for_poses(H, W, trained["intrinsics"], trained["poses"], use_ndc=True,
                                device="cuda")
    prop_sd, stats = distill_proposal(LEVER_SEED, fine, ro_t.reshape(-1, 3), rd_t.reshape(-1, 3),
                                      0.0, 1.0, steps=PROPOSAL_STEPS, batch=PROPOSAL_BATCH)
    print(f"[levers] distilled D2xW128 proposal from phase 4's fine trunk on {ro_t.shape[0]} "
          f"views: {PROPOSAL_STEPS} steps (of the package's 3,000) at batch {PROPOSAL_BATCH}; "
          f"loss {stats['loss']:.5f}, relu-sigma bias "
          f"{stats['relu_sigma_bias']:+.4f}", flush=True)
    check(math.isfinite(stats["loss"]) and math.isfinite(stats["relu_sigma_bias"]),
          "the distilled proposal's loss is not finite")
    del fine, ro_t, rd_t
    # its own packing (trained biases) against its twin, at a fast-stack block's points
    pt = torch.from_numpy(np.random.default_rng(19).uniform(
        -1, 1, (3, P_K2 // LEVER_SHARE)).astype(np.float32)).cuda()
    w128_case(ks, ks.pack_nerf_params(prop_sd, depth=2, width=128, device="cuda"), pt,
              "distilled proposal")
    del pt

    # ---- 2. the fast-stack frame, beside the exact frame of the same trunks
    settings = RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    ro, rd = rays_for_poses(H, W, trained["intrinsics"], trained["render_poses"][:1],
                            use_ndc=True, device="cuda")
    fo, fd = ro[0].reshape(-1, 3), rd[0].reshape(-1, 3)
    n, blocks = fo.shape[0], math.ceil(fo.shape[0] / BLOCK)
    bo, bd = fo[:BLOCK], fd[:BLOCK]
    levers = dict(coarse_rgb=False, fine_budget=LEVER_BUDGET, coarse_share=LEVER_SHARE,
                  device="cuda")

    def frame(render, want, tag):
        reset()
        out = render()
        torch.cuda.synchronize()
        got = read()
        print(f"[levers] {tag} frame {H}x{W} ({n} rays, block {BLOCK}): launches "
              + ", ".join(f"{k} {v}" for k, v in got.items() if v), flush=True)
        check(got == {**zero, **want}, f"{tag} frame launch counts {got}, expected {want}")
        check(out["rgb"].shape == (n, 3) and bool(torch.isfinite(out["rgb"]).all()),
              f"{tag} frame shape or values")
        return out

    exact = FusedNerfRenderer.from_params(trained["coarse"], trained["fine"], settings,
                                          coarse_rgb=False, device="cuda")
    out_exact = frame(lambda: exact.render_image(fo, fd, block=BLOCK),
                      {"K1": blocks, "K2": blocks}, "exact (same trunks and pose)")
    del exact
    fast = FusedNerfRenderer.from_params(prop_sd, trained["fine"], settings, depth=2, width=128,
                                         depth_fine=8, width_fine=256, **levers)
    want_fast = {"K1": blocks, "K2-W128": blocks}
    out_fast = frame(lambda: fast.render_image(fo, fd, block=BLOCK), want_fast,
                     "fast-stack (proposal, budget 80, share 2)")
    print(f"[levers] fast-stack frame: rgb agreement with the exact frame "
          f"{agreement_db(out_fast['rgb'], out_exact['rgb']):.2f} dB PSNR", flush=True)
    got = fast.render(bo, bd)
    with twins(rf, fused_nerf_apply_t=ks.fused_nerf_apply_t_plain,
               fused_nerf_sigma_apply_t=ks.fused_nerf_sigma_apply_t_plain):
        ref = fast.render(bo, bd)
    block_vs_twins(got, ref, "levers", "the fast-stack frame")
    del got, ref, out_fast

    # ---- 3. the same frame with a 192^3 density grid in place of the proposal
    poses = np.concatenate([trained["poses"], trained["render_poses"]], 0)
    ro_all, rd_all = rays_for_poses(H, W, trained["intrinsics"], poses, use_ndc=True,
                                    device="cuda")
    spec = GridSpec(*ray_bounds(ro_all, rd_all, 0.0, 1.0))
    del ro_all, rd_all
    packed_f = ks.pack_nerf_params(trained["fine"], device="cuda")
    reset()
    values = build_sigma_grid(packed_f, spec, (GRID_RES,) * 3)
    torch.cuda.synchronize()
    grid_launches = read()
    lattice = GRID_RES ** 3
    print(f"[levers] {GRID_RES}^3 grid over {len(poses)} poses' bounds {spec.lo} .. {spec.hi} "
          f"(K2 at D8xW256 over {lattice} lattice points x 9 offsets, "
          f"{grid_launches['K2']} launches): sigma max {float(values.max()):.2f}, "
          f"{100 * float((values > 0).float().mean()):.2f}% of voxels > 0", flush=True)
    check(bool(torch.isfinite(values).all()), "the grid is not finite")
    check(grid_launches == {**zero, "K2": 9 * math.ceil(lattice / (1 << 21))},
          f"grid build launch counts {grid_launches}")
    gridr = FusedNerfRenderer.from_params(trained["coarse"], trained["fine"], settings,
                                          sigma_grid=(values, spec), **levers)
    out_grid = frame(lambda: gridr.render_image(fo, fd, block=BLOCK),
                     {"K1": blocks}, "grid (192^3, budget 80, share 2)")
    print(f"[levers] grid frame: rgb agreement with the exact frame "
          f"{agreement_db(out_grid['rgb'], out_exact['rgb']):.2f} dB PSNR", flush=True)
    got = gridr.render(bo, bd)
    with twins(rf, fused_nerf_apply_t=ks.fused_nerf_apply_t_plain):
        ref = gridr.render(bo, bd)
    block_vs_twins(got, ref, "levers", "the grid frame")
    del got, ref, out_grid, gridr, values

    # ---- 4. a stylized frame with the proposal
    concat, style = style_mlps()
    lat = init_latents(torch.Generator().manual_seed(12), 1, LATENT_FRAMES, LATENT,
                       device="cuda")
    sr = FusedStyleRenderer.from_params(trained["coarse"], trained["fine"], concat.state_dict(),
                                        style.state_dict(), lat, settings,
                                        proposal=(prop_sd, 2, 128, 4), **levers)
    want_style = {"K4": blocks, "K2-W128": blocks}
    frame(lambda: sr.render_image(fo, fd, 0, 0, block=BLOCK, seed=F_SEED), want_style,
          "stylized fast-stack (proposal, budget 80, share 2)")
    sid = torch.zeros(BLOCK, dtype=torch.long, device="cuda")
    u = torch.rand((BLOCK // LEVER_SHARE, NC), generator=block_generator(F_SEED, 0, 0, "cuda"),
                   device="cuda")
    got = sr.render(bo, bd, sid, sid, u=u)
    with twins(rfs, fused_nerf_sigma_apply_t=ks.fused_nerf_sigma_apply_t_plain,
               fused_style_apply_t=kst.fused_style_apply_t_plain,
               fused_sigma_apply_t=kst.fused_sigma_apply_t_plain):
        ref = sr.render(bo, bd, sid, sid, u=u)
    block_vs_twins(got, ref, "levers", "the stylized fast-stack frame")
    del got, ref, sr, concat, style

    # ---- 5. Phase A under the budget schedule
    cfg = NerfConfig()
    tc = tt.NerfTrainConfig(batch_size=BATCH, n_samples=NC, n_samples_fine=NF,
                            sigma_noise_std=1.0)
    scene = load_llff_data(write_scene(os.path.join(root, "levers_scene"), n=4), factor=1)
    points = {"K1": collections.Counter(), "K3": collections.Counter()}
    k1, backward = kg.fused_nerf_apply_t, kg.FusedNerfApply.backward

    def k1_rec(packed_, pts_t, dirs_t):  # the forward of the step's autograd node
        points["K1"][pts_t.shape[1]] += 1
        return k1(packed_, pts_t, dirs_t)

    def k3_rec(ctx, g_rgb, g_sigma):  # its backward, K3's one launch
        points["K3"][ctx.saved_tensors[2].shape[1]] += 1
        return backward(ctx, g_rgb, g_sigma)

    reset()
    kg.fused_nerf_apply_t, kg.FusedNerfApply.backward = k1_rec, staticmethod(k3_rec)
    try:
        state, hist = tt.train_nerf(scene, cfg, tc, A_STEPS, os.path.join(root, "levers_a"),
                                    i_print=A_PRINT, device="cuda",
                                    print_fn=lambda m: print(m, flush=True),
                                    budget_schedule=A_SCHEDULE)
        torch.cuda.synchronize()
    finally:
        kg.fused_nerf_apply_t, kg.FusedNerfApply.backward = k1, staticmethod(backward)
    a_launches = read()
    # each segment's step runs eagerly once, then captures once and replays
    seg_launches = sum(a_loop_launches(end - first) for first, end, _ in A_SEGMENTS)
    check(a_launches == {**zero, "K1": seg_launches, "K3": seg_launches},
          f"budgeted Phase-A launch counts {a_launches}")
    want_pts = collections.Counter()
    for first, end, budget in A_SEGMENTS:
        want_pts[BATCH * NC] += a_loop_launches(end - first) // 2
        want_pts[BATCH * (budget or NC + NF)] += a_loop_launches(end - first) // 2
    check(points["K1"] == want_pts and points["K3"] == want_pts,
          f"K1/K3 point counts {dict(points['K1'])} / {dict(points['K3'])}, expected "
          f"{dict(want_pts)}")
    losses = hist["loss"]
    check(len(losses) == A_STEPS and all(math.isfinite(x) for x in losses),
          "budgeted Phase-A loss not finite")
    print(f"[levers] Phase A under train_fine_budget {A_SCHEDULE!r}: {A_STEPS} steps; K1 and "
          f"K3 points a launch {dict(sorted(points['K1'].items()))}; mean loss of the first 20 "
          f"steps {np.mean(losses[:20]):.5f}, of the last 20 {np.mean(losses[-20:]):.5f}",
          flush=True)

    # the budget-80 step on the card against the same step on the CPU
    h, w, _ = scene.hwf
    ro_a, rd_a = rays_for_poses(h, w, scene.intrinsics, scene.poses, device="cuda")
    ro_a, rd_a = ro_a.reshape(-1, 3), rd_a.reshape(-1, 3)
    rgb_a = torch.as_tensor(scene.images, dtype=torch.float32).reshape(-1, 3).cuda()
    tc80 = dataclasses.replace(tc, train_fine_budget=LEVER_BUDGET)
    fused = tt.make_fused_train_step(cfg, tc80, device="cuda")
    draws = fused.draw(ro_a.shape[0], torch.Generator(device="cuda").manual_seed(7))
    check(draws.noise_fine.shape == (BATCH, LEVER_BUDGET), "the budget step's fine noise shape")
    m_f, g_f = fused.loss_and_grad(state.coarse, state.fine, ro_a, rd_a, rgb_a, draws)
    names = ([f"coarse.{nm}" for nm, _ in state.coarse.named_parameters()]
             + [f"fine.{nm}" for nm, _ in state.fine.named_parameters()])
    cpu = tt.make_fused_train_step(cfg, tc80, device="cpu")
    d_cpu = tt.StepDraws(*(None if t is None else t.cpu() for t in (
        draws.idx, draws.perturb_u, draws.noise_coarse, draws.noise_fine)))
    m_c, g_c = cpu.loss_and_grad(*trunks(cfg, state, "cpu"), ro_a.cpu(), rd_a.cpu(),
                                 rgb_a.cpu(), d_cpu)
    cos = {nm: grad_cos(a.cpu(), b) for nm, a, b in zip(names, g_f, g_c)}
    worst, dl = min(cos, key=cos.get), abs(float(m_f["loss"]) - float(m_c["loss"]))
    print(f"[levers] trained state, the budget-{LEVER_BUDGET} fused step on the card vs on the "
          f"CPU (twins): loss {float(m_f['loss']):.6f} vs "
          f"{float(m_c['loss']):.6f} (|diff| {dl:.3e}, {dl / abs(float(m_c['loss'])):.3e} of "
          f"it, limit {TOL_STEP_LOSS_REL:g}); gradient cosine >= {cos[worst]:.6f} "
          f"({worst})", flush=True)
    check(dl <= TOL_STEP_LOSS_REL * abs(float(m_c["loss"])),
          "the budget step's loss on the card disagrees with the CPU")
    check(cos[worst] >= TOL_STEP_COS, "the budget step's gradient on the card disagrees with "
          "the CPU")
    del g_f, g_c, state

    # ---- 6. phase 16's pipeline re-entered with the fast stack
    exp = pipe["exp"]
    for d in ("render_train", "render_train_style"):  # keep the exact renders beside
        os.rename(os.path.join(exp, d), os.path.join(exp, d + "_exact"))
    argv = pipe["argv"] + ["--proposal_width", "128", "--fine_budget", str(LEVER_BUDGET),
                           "--coarse_share", str(LEVER_SHARE), "--proposal_steps",
                           str(PROPOSAL_STEPS)]
    blocks16 = math.ceil(H * W / BLOCK)
    blocks_f = math.ceil(H * W / (1 << 15))
    for flag, want in (("--render_train", {"K1": PIPE_VIEWS * blocks16,
                                           "K2-W128": PIPE_VIEWS * blocks16}),
                       ("--render_train_style", {"K4": PIPE_STYLES * PIPE_VIEWS * blocks_f,
                                                 "K2-W128": PIPE_STYLES * PIPE_VIEWS * blocks_f})):
        reset()
        check(cli.main(argv + [flag]) == 0, f"cli {flag} with the fast stack")
        torch.cuda.synchronize()
        got = read()
        check(got == {**zero, **want},
              f"pipeline {flag} with the fast stack: launch counts {got}, expected {want}")
    load = lambda p: torch.from_numpy(np.asarray(Image.open(p), np.float32) / 255.0)
    plain = [agreement_db(load(os.path.join(exp, "render_train", f"rgb_{i:05d}.png")),
                          load(os.path.join(exp, "render_train_exact", f"rgb_{i:05d}.png")))
             for i in range(PIPE_VIEWS)]
    styled = [os.path.join(exp, "render_train_style", f"style_{s:05d}_fine_{f:05d}.png")
              for s in range(PIPE_STYLES) for f in range(PIPE_VIEWS)]
    check(all(os.path.exists(p) for p in styled), "the fast-stack stylized frames")
    print(f"[levers] pipeline re-entered with the fast stack (proposal distilled per run, "
          f"{PROPOSAL_STEPS} steps): --render_train ({PIPE_VIEWS} frames) and "
          f"--render_train_style ({len(styled)} frames); plain frames' agreement with phase "
          f"16's exact renders " + ", ".join(f"{v:.2f}" for v in plain) + " dB PSNR", flush=True)
    return {k: v.detach().cpu() for k, v in prop_sd.items()}


def mp_rays(views):
    """Phase 4's four training views (``intrinsics``, ``poses``) as rays on the
    card, and seeded targets."""
    from tgtc_torch.data.rays import rays_for_poses

    ro, rd = rays_for_poses(H, W, views["intrinsics"], views["poses"], device="cuda")
    rgb = np.random.default_rng(MP_SEED).uniform(0, 1, (ro.numel() // 3, 3)).astype(np.float32)
    return ro.reshape(-1, 3), rd.reshape(-1, 3), torch.from_numpy(rgb).cuda()


def mp_phase_a(group, ro, rd, rgb):
    """MP_A_STEPS fused Phase-A steps at fern width from seeded weights, each
    on its own draws of the global batch: the losses (averaged over the
    ranks), the first step's averaged gradients and the trunks after."""
    from tgtc_torch.models.nerf import NerfConfig
    from tgtc_torch.train import nerf_trainer as tt
    from tgtc_torch.utils.seeds import step_seed

    cfg = NerfConfig()
    tc = tt.NerfTrainConfig(batch_size=BATCH, n_samples=NC, n_samples_fine=NF,
                            sigma_noise_std=1.0)
    state = tt.init_state(torch.Generator().manual_seed(MP_SEED), cfg, tc, device="cuda")
    step = tt.make_fused_train_step(cfg, tc, device="cuda", group=group)
    gen = torch.Generator(device="cuda")
    losses, local, grads = [], None, None
    for s in range(MP_A_STEPS):
        gen.manual_seed(step_seed(MP_SEED, s))
        m, g = step.loss_and_grad(state.coarse, state.fine, ro, rd, rgb,
                                  step.draw(ro.shape[0], gen))
        local = local or [x.cpu() for x in g]  # this rank's own, before the average
        step.apply(state, g)  # averages g over the ranks in place
        state.step += 1
        losses.append(group.mean_scalars({"loss": m["loss"]})["loss"].reshape(1))
        grads = grads or [x.cpu() for x in g]
    return {"loss": torch.cat(losses).cpu().tolist(), "grads": grads, "local": local,
            "params": [p.detach().cpu() for p in state.parameters()]}


def mp_c1(group):
    """One full-width C1 step at dropout 0.1 from seeded weights on one fixed
    batch of 8 (phase 11's witness batch): the loss, the averaged gradients
    and the kernels' launches in the step."""
    import tgtc_torch.ops.kernels.flash_attention as fa
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train import transformer2d as t2

    model = make_stytrans(TransformerConfig(dtype=torch.bfloat16, attn_impl="flash"),
                          torch.Generator().manual_seed(21), device="cuda")
    tcfg = t2.TransformerTrainConfig()
    state = t2.init_transformer_train(model, tcfg)
    rng = np.random.default_rng(24)
    batch = [torch.from_numpy(rng.integers(0, 256, (C1_BATCH, 256, 256, 3), dtype=np.uint8))
             .cuda() for _ in range(2)]
    step = t2.make_transformer_train_step(model, tcfg, group=group)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for c in counters:
        c.launches = 0
    m, g = step.loss_and_grad(model, *batch, step.generator(5, 0))
    group.all_reduce_mean_(g)
    torch.cuda.synchronize()
    launches = dict(zip(("K6", "K7", "K8"), (c.launches for c in counters)))
    return {"loss": float(group.mean_scalars({"loss": m["loss"]})["loss"]),
            "grads": [x.cpu() for x in g], "launches": launches,
            "names": [n for n, _ in t2.trained_parameters(model)]}


def mp_e(group, job):
    """One Phase-E step at fern's settings from phase 15's checkpoint with the
    coherence term on (cnt 1, fern's gate), on the draws of global batch
    256: the losses (averaged) and the averaged gradients by group."""
    from tgtc_torch.config import load_config
    from tgtc_torch.data.llff import load_llff_data
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP
    from tgtc_torch.train import style3d as s3
    from tgtc_torch.train.checkpoint import CheckpointManager

    cfg = load_config(["--config", job["fern"]])
    trunks = []
    for which in ("coarse", "fine"):
        t = NerfMLP(NerfConfig())
        t.load_state_dict(job["trunks"][which])
        trunks.append(t.cuda())
    scene = load_llff_data(job["scene"], factor=1)
    data = s3.load_style_scene(scene, job["geo_dir"], job["styles_dir"], device="cuda")
    field = s3.style_field_config(cfg, trunks[0])
    scfg = s3.style_train_config(cfg, 0.0, 1.0)
    state = s3.init_style_state(torch.Generator().manual_seed(0), field, scfg, data.style_num,
                                data.frame_num, device="cuda", group=group)
    mgr = CheckpointManager(job["e_ckpt"])
    state.load_state_dict(mgr.restore(map_location="cuda"), group)
    mgr.close()
    state.cnt = 1  # the coherence term active, as after a cycle's reset
    step = s3.make_style_train_step(*trunks, scfg, group)
    m, g, _ = step.loss_and_grad(state, data, step.draw(data, state, seed=E_SEED))
    group.all_reduce_mean_(g)
    m = {k: float(v) for k, v in group.mean_scalars(m).items()}
    return {"loss": m, "grads": [torch.cat([t.double().cpu().flatten() for t in grp])
                                 for grp in step_groups(state, g)]}


def mp_frames(group, job):
    """Phase 18(e)-(f) over ``group``: phase 2's 756x1008 frame through
    ``make_sharded_fused_render_fn`` with phase 4's trunks (exact, then with
    phase 17's fast stack), one frame each with its K1, K2 and K2-W128
    launches; then the first
    MP_EAGER_BLOCKS blocks through ``make_render_fn(group=)`` (phase 4's
    trunks) and ``make_stylized_render_fn(group=)`` (phase 15's field, style 0,
    frame 0, jitter from a seeded generator on the card)."""
    import tgtc_torch.ops.kernels.nerf_mlp as ks
    from tgtc_torch.config import load_config
    from tgtc_torch.data.rays import rays_for_poses
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP
    from tgtc_torch.render.fast import FusedNerfRenderer, make_sharded_fused_render_fn
    from tgtc_torch.render.volume import RenderSettings
    from tgtc_torch.train.nerf_trainer import NerfTrainConfig, make_render_fn
    from tgtc_torch.train.render_style import make_stylized_render_fn
    from tgtc_torch.train.style3d import load_style_field, style_field_config

    settings = RenderSettings(n_samples=NC, n_samples_fine=NF, sigma_noise_std=0.0)
    intr, pose = fern_camera()
    ro, rd = rays_for_poses(H, W, intr, pose, use_ndc=True, device="cuda")
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    tr = job["trunks"]
    levers = dict(coarse_rgb=False, fine_budget=LEVER_BUDGET, coarse_share=LEVER_SHARE)
    stacks = {"exact": (FusedNerfRenderer.from_params(tr["coarse"], tr["fine"], settings,
                                                      coarse_rgb=False, device="cuda"),
                        dict(coarse_rgb=False)),
              "fast": (FusedNerfRenderer.from_params(job["proposal"], tr["fine"], settings,
                                                     depth=2, width=128, depth_fine=8,
                                                     width_fine=256, device="cuda", **levers),
                       levers)}
    k2 = ks.fused_nerf_sigma_apply_t
    out = {}
    for name, (r, kw) in stacks.items():
        fn = make_sharded_fused_render_fn(settings, group, BLOCK, **kw)
        ks.fused_nerf_apply_t.launches = k2.launches = k2.launches_w128 = 0
        frame = fn(r.packed_coarse, r.packed_fine, ro, rd)
        torch.cuda.synchronize()
        out[name] = {"frame": {k: v.cpu() for k, v in frame.items()},
                     "launches": {"K1": ks.fused_nerf_apply_t.launches, "K2": k2.launches,
                                  "K2-W128": k2.launches_w128}}
    del stacks
    trunks = []
    for which in ("coarse", "fine"):
        t = NerfMLP(NerfConfig())
        t.load_state_dict(tr[which])
        trunks.append(t.cuda())
    bo, bd = ro[:MP_EAGER_BLOCKS * BLOCK], rd[:MP_EAGER_BLOCKS * BLOCK]
    tc = NerfTrainConfig(n_samples=NC, n_samples_fine=NF)
    out["render_fn"] = {k: v.cpu() for k, v in
                        make_render_fn(tc, group=group, block=BLOCK)(*trunks, bo, bd).items()}
    cfg = load_config(["--config", job["fern"]])
    concat, style, lat = load_style_field(job["e_ckpt"], style_field_config(cfg, trunks[0]),
                                          device="cuda")
    fn = make_stylized_render_fn(*trunks, concat, style, NC, NF, 0.0, 1.0, group=group,
                                 block=BLOCK)
    ids = torch.zeros(bo.shape[0], dtype=torch.long, device="cuda")
    frame = fn(lat, bo, bd, ids, ids, generator=torch.Generator(device="cuda").manual_seed(F_SEED))
    out["stylized_fn"] = {k: v.cpu() for k, v in frame.items()}
    return out


def mp_c1_loop(group, job, name: str):
    """Phase 18(g) over ``group``: ``train_transformer`` at phase 11's full
    width (dropout 0.1, bf16, flash), batch 8 of 256x256 crops of phase 11's
    content and styles, MP_C1_STEPS steps logged every step, into
    ``job["root"]/name``: the logged lines, the sum of the trained
    parameters and the K6-K8 launches."""
    import tgtc_torch.ops.kernels.flash_attention as fa
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train import transformer2d as t2
    from tgtc_torch.train.checkpoint import CheckpointManager

    model = make_stytrans(TransformerConfig(dtype=torch.bfloat16, attn_impl="flash"),
                          torch.Generator().manual_seed(21), device="cuda")
    tcfg = t2.TransformerTrainConfig(max_iter=MP_C1_STEPS)
    state = t2.init_transformer_train(model, tcfg)
    root = os.path.join(job["root"], name)
    ckpt = CheckpointManager(os.path.join(root, "ckpt"))
    counters = {"K6": fa.flash_attention_fwd, "K7": fa.flash_attention_bwd_dq,
                "K8": fa.flash_attention_bwd_dkv}
    for c in counters.values():
        c.launches = 0
    try:
        t2.train_transformer(state, tcfg, job["c1_content"], job["c1_styles"], ckpt,
                             log_dir=os.path.join(root, "log"),
                             collage_dir=os.path.join(root, "collage"), print_interval=1,
                             save_interval=MP_C1_STEPS, dropout_seed=5, data_seed=21,
                             workers=4, group=group)
    finally:
        ckpt.close()
    torch.cuda.synchronize()
    with open(os.path.join(root, "log", "transformer.jsonl")) as fh:
        lines = [json.loads(line) for line in fh]
    params = [p.detach() for _, p in t2.trained_parameters(model)]
    return {"lines": lines, "fingerprint": float(sum(p.double().sum() for p in params)),
            "params": [p.cpu() for p in params],
            "lr_sum": sum(t2.lr_schedule(tcfg)(k) for k in range(MP_C1_STEPS)),
            "launches": {k: c.launches for k, c in counters.items()},
            "ckpts": sorted(os.listdir(os.path.join(root, "ckpt"))),
            "collages": sorted(os.listdir(os.path.join(root, "collage")))
            if os.path.isdir(os.path.join(root, "collage")) else []}


def tensors_sha(tree) -> str:
    """sha256 over the bytes of every tensor of a dict of dicts, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            h.update(tensors_sha(v).encode())
        elif isinstance(v, torch.Tensor):
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def mp_sharded(group, job):
    """Phase 18(e)-(g) in a worker (or, on ``DataGroup()``, the 1-process
    references): the frames and grouped renders, a sha256 of each, and the
    grouped C1 loop."""
    torch.cuda.empty_cache()
    frames = mp_frames(group, job)
    return {"frames": frames,
            "frames_sha": {k: tensors_sha(v["frame"] if "frame" in v else v)
                           for k, v in frames.items()},
            "loop": mp_c1_loop(group, job, "c1_loop_group" if group.active else "c1_loop_single")}


def check_sharded(outs, ref_frames, ref_loop, card: str):
    """Phase 18(e)-(g)'s checks of both workers' outputs ``outs`` against the
    1-process references."""
    got = outs[0]
    # (e) the sharded frames, (f) the grouped eager renders
    n_blocks = math.ceil(H * W / BLOCK)
    shares = [n_blocks // MP_WORLD + (r < n_blocks % MP_WORLD) for r in range(MP_WORLD)]
    frames = got["frames"]
    same_ranks = outs[0]["frames_sha"] == outs[1]["frames_sha"]
    for name, kernels in (("exact", ("K1", "K2")), ("fast", ("K1", "K2-W128"))):
        want = [{k: (n if k in kernels else 0) for k in ("K1", "K2", "K2-W128")} for n in shares]
        launches = [o["frames"][name]["launches"] for o in outs]
        equal = all(torch.equal(frames[name]["frame"][k], v)
                    for k, v in ref_frames[name]["frame"].items())
        print(f"[multi] (e) {card}: phase 2's {H}x{W} frame, phase 4's trunks, "
              f"{'exact' if name == 'exact' else 'fast stack (proposal, budget 80, share 2)'}, "
              f"through make_sharded_fused_render_fn over two processes sharing the card: "
              f"{n_blocks} blocks of {BLOCK}, launches rank 0 {launches[0]}, rank 1 "
              f"{launches[1]} (expected {want}); bit for bit the 1-process frame: {equal} "
              f"(keys {sorted(ref_frames[name]['frame'])})", flush=True)
        check(equal, f"the sharded {name} frame differs from the 1-process frame")
        check(launches == want, f"sharded {name} frame launches {launches}, expected {want}")
    for name in ("render_fn", "stylized_fn"):
        equal = all(torch.equal(frames[name][k], v) for k, v in ref_frames[name].items())
        print(f"[multi] (f) {name.replace('_fn', '')} render of the frame's first "
              f"{MP_EAGER_BLOCKS} blocks (group=, block {BLOCK}) over two processes: bit for "
              f"bit the 1-process render: {equal} (keys {sorted(ref_frames[name])})", flush=True)
        check(equal, f"the grouped {name} render differs from the 1-process render")
    print(f"[multi] (e)-(f) both ranks' outputs bitwise equal: {same_ranks}", flush=True)
    check(same_ranks, "the ranks' sharded renders differ")

    # (g) the grouped C1 loop
    loop = got["loop"]
    keys = ("loss", "loss_c", "loss_s", "l_id1", "l_id2")
    rel = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(loop["lines"], ref_loop["lines"])
              for k in keys)
    first = abs(loop["lines"][0]["loss"] - ref_loop["lines"][0]["loss"]) / abs(
        ref_loop["lines"][0]["loss"])
    first5 = max(abs(loop["lines"][0][k] - ref_loop["lines"][0][k]) / abs(ref_loop["lines"][0][k])
                 for k in keys)
    fp = [abs(o["loop"]["fingerprint"] - ref_loop["fingerprint"]) / abs(ref_loop["fingerprint"])
          for o in outs]
    dp = max(float((a.double() - b.double()).abs().max())
             for a, b in zip(loop["params"], ref_loop["params"]))
    moved = sum(int(((a.double() - b.double()).abs() > 1e-6).sum())
                for a, b in zip(loop["params"], ref_loop["params"]))
    n_params = sum(a.numel() for a in loop["params"])
    tol_dp = 2 * 1.0035 * ref_loop["lr_sum"]
    want_k6 = [c1_loop_launches(MP_C1_STEPS) + C3_SITES * (r == 0) for r in range(MP_WORLD)]
    print(f"[multi] (g) train_transformer over two processes, {MP_C1_STEPS} steps of phase 11's "
          f"C1 (global batch {C1_BATCH}, {C1_BATCH // MP_WORLD} a rank): logged steps "
          f"{[g['step'] for g in loop['lines']]}, losses "
          + ", ".join(f"{g['loss']:.6f} vs {w['loss']:.6f}"
                      for g, w in zip(loop["lines"], ref_loop["lines"]))
          + f"; the first step's loss relative {first:.3e} (limit {TOL_MP_C1_FIRST}; the five "
          f"losses' worst {first5:.3e}), the worst of the five losses over the steps {rel:.3e} "
          f"(limit {TOL_C1_LOSS}); after {MP_C1_STEPS} steps max|dp| {dp:.3e} (limit "
          f"{tol_dp:.3e}), {moved} of {n_params} elements apart by more than 1e-6; "
          f"trained-parameter sums relative {', '.join(f'{x:.3e}' for x in fp)} (read); launches "
          f"rank 0 {outs[0]['loop']['launches']}, rank 1 {outs[1]['loop']['launches']}; "
          f"checkpoints {loop['ckpts']}, collages {loop['collages']}", flush=True)
    check([g["step"] for g in loop["lines"]] == list(range(1, MP_C1_STEPS + 1))
          and first <= TOL_MP_C1_FIRST and rel <= TOL_C1_LOSS and dp <= tol_dp,
          "the grouped C1 loop disagrees with the 1-process loop")
    check([o["loop"]["launches"]["K6"] for o in outs] == want_k6
          and all(o["loop"]["launches"]["K7"] == o["loop"]["launches"]["K8"]
                  == c1_loop_launches(MP_C1_STEPS) for o in outs),
          f"grouped C1 loop launches {[o['loop']['launches'] for o in outs]}")
    check(loop["ckpts"] == [f"ckpt_{MP_C1_STEPS:08d}.pt"]
          and loop["collages"] == [f"{MP_C1_STEPS}.png"], "the grouped C1 loop's files")


def multi_worker(job_path: str, out_path: str) -> None:
    """One rank of phase 18(b): joins the two-process group (gloo, the card
    shared), runs the Phase-A, C1 and Phase-E steps and the pipeline's
    multi-process schedule, and saves what it read to ``out_path % rank``."""
    import hashlib

    import torch.distributed as dist

    import tgtc_torch.train.checkpoint as ck
    from tgtc_torch import cli
    from tgtc_torch.ops.kernels import flash_attention as fa
    from tgtc_torch.ops.kernels import nerf_mlp as ks
    from tgtc_torch.ops.kernels import nerf_mlp_grad as kg
    from tgtc_torch.parallel import DataGroup, maybe_initialize_distributed

    check(maybe_initialize_distributed(device="cuda", backend="gloo"), "no process group")
    group = DataGroup.world_group()
    job = torch.load(job_path, weights_only=False)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = job["tf32"]
    counters = {"K1": ks.fused_nerf_apply_t, "K3": kg.fused_nerf_bwd}
    for c in counters.values():
        c.launches = 0
    a = mp_phase_a(group, *mp_rays(job["views"]))
    torch.cuda.synchronize()
    out = {"a": a, "launches": {k: c.launches for k, c in counters.items()},
           "params_sha": hashlib.sha256(b"".join(p.numpy().tobytes() for p in a["params"]))
           .hexdigest()}
    out["c1"] = mp_c1(group)
    out["launches"].update(out["c1"]["launches"])
    out["e"] = mp_e(group, job)
    torch.cuda.empty_cache()

    writes, original = [], ck.CheckpointManager._write

    def counted(self, step, state, ready=None):
        writes.append(f"{os.path.basename(self._dir)}/{step}")
        return original(self, step, state, ready)

    ck.CheckpointManager._write = counted
    try:
        check(cli.main(job["pipe_argv"]) == 0, "cli under the two-process launch")
    finally:
        ck.CheckpointManager._write = original
    torch.cuda.synchronize()
    out.update(writes=writes)
    out.update(mp_sharded(group, job))
    if group.rank:  # rank 0's copy of what both ranks hold, and rank 1's own gradient
        out = {**{k: v for k, v in out.items() if k not in ("a", "c1", "e")},
               "a": {"local": a["local"]},
               "loop": {k: v for k, v in out["loop"].items() if k != "params"},
               "frames": {k: {kk: vv for kk, vv in v.items() if kk != "frame"}
                          for k, v in out["frames"].items() if "frame" in v}}
    torch.save(out, out_path % group.rank)
    dist.destroy_process_group()


def phase_multi(ks, kg, trained, pipe, proposal, c1_styles: str, root: str, card: str):
    """Phase 18. (a) this process as a NCCL group of one: the fused Phase-A
    step through ``group=`` equals the ungrouped step bit for bit (losses,
    gradients, parameters), K1 and K3 launched 2 a step. (b) two worker
    processes on the card over gloo against this process's 1-process steps
    at the same global batch: the fused Phase-A step (batch 2048, 1024 a
    rank; the first step's loss and gradient, the parameters after 3
    steps), the full-width C1 step at dropout 0.1 (batch 8, 4 a rank; 36 K6,
    K7 and K8 launches a rank), the Phase-E step at fern's settings (batch
    256, 128 a rank, the coherence term on), then ``cli.main`` re-entering
    phase 16's run under the two-process launch: Phase A skipped, Phase E
    20 more steps over both ranks, rank 0 alone writing ``ckpt_style``,
    which ``load_style_field`` reads; (e) phase 2's frame through
    ``make_sharded_fused_render_fn`` with phase 4's trunks, exact and with
    phase 17's fast stack (``proposal``), bit for bit the 1-process frame,
    each rank launching K1 and K2 (K2-W128) once a block of its share of
    the 47; (f) ``make_render_fn(group=)`` and ``make_stylized_render_fn(group=)``
    on the frame's first two blocks, bit for bit; (g) ``train_transformer``
    over both ranks, 3 steps of phase 11's C1 on its content and
    ``c1_styles``, held to the 1-process loop."""
    import torch.distributed as dist

    from tgtc_torch.parallel import DataGroup, maybe_initialize_distributed
    from tgtc_torch.train.style3d import load_style_field, style_field_config
    from tgtc_torch.config import load_config
    from tgtc_torch.models.nerf import NerfConfig, NerfMLP

    ro, rd, rgb = mp_rays(trained)
    # ---- (a) a NCCL group of one in this process
    env = {"TGTC_COORDINATOR": f"127.0.0.1:{free_port()}", "TGTC_NUM_PROCESSES": "1",
           "TGTC_PROCESS_ID": "0"}
    check(maybe_initialize_distributed(env, device="cuda"), "the group of one did not start")
    runs, launches_a = {}, None
    try:
        group = DataGroup.world_group()
        check(dist.get_backend() == "nccl" and group.world == 1 and group.active,
              f"expected a NCCL group of one, got {dist.get_backend()} x {group.world}")
        for name, g in (("plain", DataGroup()), ("group", group)):
            ks.fused_nerf_apply_t.launches = kg.fused_nerf_bwd.launches = 0
            runs[name] = mp_phase_a(g, ro, rd, rgb)
            torch.cuda.synchronize()
            launches_a = {"K1": ks.fused_nerf_apply_t.launches, "K3": kg.fused_nerf_bwd.launches}
    finally:
        dist.destroy_process_group()
    plain, grouped = runs["plain"], runs["group"]
    same = (plain["loss"] == grouped["loss"]
            and all(torch.equal(a, b) for k in ("grads", "params")
                    for a, b in zip(plain[k], grouped[k])))
    print(f"[multi] (a) {card}: the fused Phase-A step at fern width (D8/W256, batch {BATCH}, "
          f"{NC}+{NF} samples, sigma noise 1.0) through a NCCL DataGroup of one vs ungrouped, "
          f"{MP_A_STEPS} steps: losses {grouped['loss']} vs {plain['loss']}, the first step's "
          f"gradients and the parameters after bitwise equal: {same}; launches in the grouped "
          f"run {launches_a}", flush=True)
    check(same, "the grouped Phase-A step differs from the ungrouped one")
    check(launches_a == {"K1": 2 * MP_A_STEPS, "K3": 2 * MP_A_STEPS},
          f"the grouped Phase-A step launched {launches_a}")

    # ---- (b) the 1-process references, then two workers sharing the card
    ref_c1 = mp_c1(DataGroup())
    e_job = {"fern": os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                  "fern.txt"),
             "trunks": {k: {n: v.cpu() for n, v in trained[k].items()}
                        for k in ("coarse", "fine")},
             "scene": os.path.join(root, "scene"), "geo_dir": os.path.join(root, "geometry"),
             "styles_dir": os.path.join(root, "stylized_c2"),
             "e_ckpt": os.path.join(root, "e_run", "ckpt_style")}
    ref_e = mp_e(DataGroup(), e_job)
    torch.cuda.empty_cache()
    total = PIPE_TOTAL + MP_E_STEPS
    content = os.path.join(root, "c1_content")
    job = {"views": {k: trained[k] for k in ("intrinsics", "poses")},
           "tf32": (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32),
           "pipe_argv": pipe["argv"] + ["--total_step", str(total)], "root": root,
           "proposal": proposal,
           "c1_content": [os.path.join(content, f) for f in sorted(os.listdir(content))],
           "c1_styles": [os.path.join(c1_styles, f) for f in sorted(os.listdir(c1_styles))],
           **e_job}
    ref = mp_sharded(DataGroup(), job)
    ref_frames, ref_loop = ref["frames"], ref["loop"]
    del ref
    torch.cuda.empty_cache()
    job_path, out_path = os.path.join(root, "multi_job.pt"), os.path.join(root, "multi_%d.pt")
    torch.save(job, job_path)
    logs = run_workers(job_path, out_path)
    outs = [torch.load(out_path % r, weights_only=False) for r in range(MP_WORLD)]
    got = outs[0]

    # Phase A
    a = got["a"]
    dl = [abs(x - y) / abs(y) for x, y in zip(a["loss"], plain["loss"])]
    whole = grad_cos(torch.cat([g.flatten() for g in a["grads"]]),
                     torch.cat([g.flatten() for g in plain["grads"]]))
    leaf = max(grad_rel(x, y) for x, y in zip(a["grads"], plain["grads"]))
    over, leaf_limit = 0.0, 0.0  # the worst |err| over its bf16 bound; the leaf bound
    for g, ref, g0, g1 in zip(a["grads"], plain["grads"], a["local"], outs[1]["a"]["local"]):
        g, ref, g0, g1 = (x.double() for x in (g, ref, g0, g1))
        lim = (MP_BF16_U * (1 + 2 * MP_BF16_U) * ((g0.abs() + g1.abs()) / 2 + ref.abs())
               + 2.0 ** -20 * float(ref.abs().max()))
        over = max(over, float(((g - ref).abs() / lim).max()))
        leaf_limit = max(leaf_limit, float(lim.max()) / max(float(ref.abs().max()), 1e-30))
    dp = max(float((x.double() - y.double()).abs().max())
             for x, y in zip(a["params"], plain["params"]))
    moved = sum(int(((x.double() - y.double()).abs() > 1e-6).sum())
                for x, y in zip(a["params"], plain["params"]))
    n_params = sum(x.numel() for x in a["params"])
    print(f"[multi] (b) {card}: two processes on the card over gloo vs this process, the "
          f"fused Phase-A step at global batch {BATCH} ({BATCH // MP_WORLD} a rank): the first "
          f"step's loss relative {dl[0]:.2e} (limit {TOL_MP_A_LOSS}), the next steps' "
          + ", ".join(f"{x:.2e}" for x in dl[1:]) + " (read); the first step's averaged "
          f"gradient: cosine {whole:.9f}, worst leaf max|err| / max|g| {leaf:.3e}, every "
          f"element within {over:.3f} of its bf16 bound (limit 1; the bound reaches "
          f"{leaf_limit:.3e} of its leaf's max|g|); after {MP_A_STEPS} steps max|dp| "
          f"{dp:.3e} (limit {TOL_MP_A_PARAM:.3e}), {moved} of {n_params} elements apart by "
          f"more than 1e-6; both ranks' parameters equal: "
          f"{outs[0]['params_sha'] == outs[1]['params_sha']}", flush=True)
    check(dl[0] <= TOL_MP_A_LOSS and over <= 1.0 and dp <= TOL_MP_A_PARAM,
          "the 2-process Phase-A step disagrees with the 1-process")
    check(outs[0]["params_sha"] == outs[1]["params_sha"], "the ranks' parameters differ")

    # C1
    c1 = got["c1"]
    dl = abs(c1["loss"] - ref_c1["loss"]) / abs(ref_c1["loss"])
    cos_all, leaf, lows = c1_grad_agreement(ref_c1["names"], c1["grads"], ref_c1["grads"])
    print(f"[multi] (b) C1 step at full width, dropout {C1_RATE}, global batch {C1_BATCH} "
          f"({C1_BATCH // MP_WORLD} a rank, bh_offset rank x {C1_BATCH // MP_WORLD} x 8): loss "
          f"{c1['loss']:.6f} vs {ref_c1['loss']:.6f} (relative {dl:.3e}, limit {TOL_C1_LOSS}); "
          f"cosine of the whole averaged gradient {cos_all:.7f} (limit {TOL_C1_COS}), worst "
          f"leaf {leaf[0]:.3e} ({leaf[1]}, limit {TOL_C1_LEAF}); lowest leaf cosines {lows}; "
          f"launches a rank " + "; ".join(f"rank {r} {o['launches']}" for r, o in enumerate(outs)),
          flush=True)
    check(dl <= TOL_C1_LOSS and cos_all >= TOL_C1_COS and leaf[0] <= TOL_C1_LEAF,
          "the 2-process C1 step disagrees with the 1-process")
    want_all = {"K1": 2 * MP_A_STEPS, "K3": 2 * MP_A_STEPS, "K6": C1_SITES, "K7": C1_SITES,
                "K8": C1_SITES}
    check(all(o["launches"] == want_all for o in outs),
          f"worker launches {[o['launches'] for o in outs]}, expected {want_all} a rank")

    # Phase E
    e = got["e"]
    rel = {k: abs(e["loss"][k] - ref_e["loss"][k]) / abs(ref_e["loss"][k]) for k in ref_e["loss"]}
    cos = [grad_cos(x, y) for x, y in zip(e["grads"], ref_e["grads"])]
    print(f"[multi] (b) Phase-E step at fern's settings, global batch 256 (128 a rank), the "
          f"coherence term on: " + ", ".join(f"{k} {e['loss'][k]:.6f} vs {ref_e['loss'][k]:.6f} "
                                              f"({rel[k]:.2e})" for k in ref_e["loss"])
          + f"; gradient cosine concat {cos[0]:.7f}, style {cos[1]:.7f}, latents {cos[2]:.7f} "
          f"(limits {TOL_E_LOSS}, {TOL_E_COS})", flush=True)
    check(max(rel.values()) <= TOL_E_LOSS and min(cos) >= TOL_E_COS,
          "the 2-process Phase-E step disagrees with the 1-process")

    # the pipeline's multi-process schedule
    cfg = load_config(pipe["argv"])
    records = [json.loads(line) for line in open(os.path.join(pipe["exp"], "logs", "style.jsonl"))]
    new = [r for r in records if r["step"] > PIPE_TOTAL]
    ckpts = sorted(os.listdir(os.path.join(pipe["exp"], "ckpt_style")))
    trunk = NerfMLP(NerfConfig(embed_freq_coor=cfg.embed_freq_coor,
                               embed_freq_dir=cfg.embed_freq_dir))
    concat, style, lat = load_style_field(os.path.join(pipe["exp"], "ckpt_style"),
                                          style_field_config(cfg, trunk), device="cuda")
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [lat["latents"], *concat.parameters(), *style.parameters()])
    print(f"[multi] (b) cli.main under the two-process launch on phase 16's run: checkpoint "
          f"writes rank 0 {outs[0]['writes']}, rank 1 {outs[1]['writes']}; new style log lines "
          f"at steps {[r['step'] for r in new]}; ckpt_style {ckpts}; "
          f"load_style_field: latents {tuple(lat['latents'].shape)} finite {finite}",
          flush=True)
    check(outs[0]["writes"] == [f"ckpt_style/{total}"] and outs[1]["writes"] == [],
          "the multi-process schedule's checkpoint writes")
    check(bool(new) and new[-1]["step"] == total and f"ckpt_{total:08d}.pt" in ckpts and finite,
          "the multi-process Phase E did not reach its total step")
    check("[ORIGIN TRAIN]" not in logs[0] + logs[1], "Phase A ran again under the launch")

    check_sharded(outs, ref_frames, ref_loop, card)


def adain_frames(geo_dir: str, styles_dir: str):
    """The temporal task's inputs as tools/train2d loads them: phase 5's
    renders, coor maps, poses and focal, and the styles resized to the
    frame."""
    from PIL import Image

    from tgtc_torch.data.prefetch import content_images, list_images

    geo = np.load(os.path.join(geo_dir, "geometry.npz"))
    renders = np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
                        for p in content_images(geo_dir)])
    h, w = renders.shape[1:3]
    styles = np.stack([np.asarray(Image.open(p).convert("RGB").resize((w, h), Image.BILINEAR),
                                  np.float32) / 255.0 for p in list_images(styles_dir)])
    return renders, geo["coor_maps"], geo["cps"], float(geo["hwf"][2]), styles


def adain_step_on(dev: str, ckpt: str, batch, temporal=None):
    """One AdaIN step's loss and decoder gradients on ``dev`` from the
    checkpoint ``ckpt``; ``temporal`` = ``(h, w, focal)`` makes it the
    temporal step."""
    from tgtc_torch.models.adain_net import make_adain_net
    from tgtc_torch.ops.rasterize import llff_projection_matrix
    from tgtc_torch.train import adain_trainer as ta

    model = make_adain_net(torch.Generator().manual_seed(0), device=dev)
    cfg = ta.AdainTrainConfig(lr=1e-4, lr_decay=5e-5, content_weight=1.0, style_weight=2.0,
                              temporal_weight=50.0)
    state = ta.init_adain_train(model, cfg)
    state.load_state_dict(torch.load(ckpt, map_location=dev, weights_only=False))
    if temporal is None:
        step = ta.make_adain_finetune_step(model, cfg)
    else:
        h, w, focal = temporal
        proj = torch.from_numpy(llff_projection_matrix(h, w, focal)).to(dev)
        step = ta.make_adain_temporal_step(model, cfg, proj, h, w, focal=focal)
    m, g = step.loss_and_grad(model, *(torch.as_tensor(x).to(dev) for x in batch))
    return {k: float(v) for k, v in m.items()}, [x.cpu() for x in g]


def phase_adain(root: str, geo_dir: str, styles_dir: str, card: str):
    """Phase 19 (see the module docstring)."""
    import contextlib

    from tgtc_torch.data.prefetch import load_crop
    from tgtc_torch.models.adain_net import make_adain_net
    from tgtc_torch.tools import train2d
    from tgtc_torch.train import adain_trainer as ta
    from tgtc_torch.train.checkpoint import CheckpointManager

    # PyTorch's defaults: f32 matmuls, cuDNN's convolutions on TF32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    content = os.path.join(root, "c1_content")
    save, log = os.path.join(root, "adain_save"), os.path.join(root, "adain_log")
    common = ["--style_dir", styles_dir, "--save_dir", save, "--log_dir", log,
              "--print_interval", "1", "--save_model_interval", "1000", "--vgg", "",
              "--decoder", "", "--seed", str(ADAIN_SEED), "--n_threads", "8"]
    argv = ["--task", "finetune_decoder", "--content_dir", content] + common
    init = make_adain_net(torch.Generator().manual_seed(ADAIN_SEED), device="cpu").state_dict()

    # (a) the finetune loop
    quiet = open(os.path.join(root, "adain_stdout.txt"), "w")
    total = ADAIN_WARM + ADAIN_STEPS
    with quiet, contextlib.redirect_stdout(quiet):  # one log line a step
        check(train2d.main(argv + ["--max_iter", str(ADAIN_WARM)], device="cuda") == 0,
              "AdaIN finetune warm-up")
        check(train2d.main(argv + ["--max_iter", str(total)], device="cuda") == 0,
              "AdaIN finetune resumed run")
    with open(os.path.join(log, "finetune_decoder.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    losses = [r["loss"] for r in records]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    ckpt = os.path.join(save, "adain_decoder", f"ckpt_{total:08d}.pt")
    sd = torch.load(ckpt, map_location="cpu", weights_only=False)
    vgg_same = all(torch.equal(v, init[k]) for k, v in sd["model"].items()
                   if k.startswith("vgg."))
    moved = [k for k, v in sd["model"].items() if k.startswith("decode.")
             and not torch.equal(v, init[k])]
    n_decode = len([k for k in init if k.startswith("decode.")])
    # the checkpoint restored into a fresh state, saved and read back
    state = ta.init_adain_train(make_adain_net(device="cpu"), ta.AdainTrainConfig())
    state.load_state_dict(sd)
    mgr = CheckpointManager(os.path.join(root, "adain_roundtrip"))
    mgr.save(state.step, state.state_dict())
    back = mgr.restore()
    mgr.close()
    same = (back["step"] == sd["step"] == total
            and all(torch.equal(v, sd["model"][k]) for k, v in back["model"].items())
            and all(torch.equal(v, sd["optimizer"]["state"][i][n])
                    for i, st in back["optimizer"]["state"].items() for n, v in st.items()
                    if isinstance(v, torch.Tensor)))
    print(f"[adain] {card}: finetune_decoder at the task's defaults (VGG to relu4_1 and the "
          f"full decoder, f32; TF32 matmul {tf32[0]}, cuDNN TF32 {tf32[1]}), batch 8 of "
          f"256x256 crops of phase 5's renders and phase 11's 8 styles: {ADAIN_WARM} warm-up "
          f"steps, then {ADAIN_STEPS} steps resumed; mean loss of the first 20 steps "
          f"{first:.5f}, of the last 20 {last:.5f}; "
          f"VGG bitwise unchanged {vgg_same}, decoder leaves moved {len(moved)} of {n_decode}; "
          f"checkpoint round trip bitwise {same}", flush=True)
    check(len(records) == total and all(math.isfinite(x) for x in losses),
          "the AdaIN finetune log does not hold every step or a loss is not finite")
    check(last < first, "the AdaIN finetune loss did not fall")
    check(vgg_same and len(moved) == n_decode, "the AdaIN finetune moved the VGG or not the "
                                               "decoder")
    check(same, "the AdaIN checkpoint does not round-trip")

    # (b) one finetune step, card against CPU, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(ADAIN_SEED + 1)
    c_paths = sorted(os.path.join(content, f) for f in os.listdir(content))
    s_paths = sorted(os.path.join(styles_dir, f) for f in os.listdir(styles_dir))
    batch = [np.stack([load_crop(paths[i % len(paths)], rng, 256, 512) for i in range(8)])
             for paths in (c_paths, s_paths)]
    (m_card, g_card), (m_cpu, g_cpu) = (adain_step_on(d, ckpt, batch) for d in ("cuda", "cpu"))
    dl = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    cos = grad_cos(*(torch.cat([g.flatten() for g in gs]) for gs in (g_card, g_cpu)))
    print(f"[adain] one finetune step, card vs CPU (same state and batch, TF32 off): loss "
          f"{m_card['loss']:.7f} vs {m_cpu['loss']:.7f} (relative {dl:.3e}, limit "
          f"{TOL_ADAIN_LOSS}); decoder gradient cosine {cos:.7f} (limit {TOL_ADAIN_COS}), "
          f"lowest leaf {min(grad_cosines(g_card, g_cpu)):.7f}", flush=True)
    check(dl <= TOL_ADAIN_LOSS and cos >= TOL_ADAIN_COS,
          "the AdaIN finetune step on the card disagrees with the CPU's")

    # (c) the temporal loop: batch 8 of full frames
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tsave, tlog = os.path.join(root, "adain_t_save"), os.path.join(root, "adain_t_log")
    targv = ["--task", "temporal_decoder", "--nerf_content_dir", geo_dir, "--style_dir",
             styles_dir, "--save_dir", tsave, "--log_dir", tlog, "--max_iter",
             str(ADAIN_T_STEPS), "--print_interval", "1", "--save_model_interval", "1000",
             "--vgg", "", "--decoder", "", "--seed", str(ADAIN_SEED)]
    quiet = open(os.path.join(root, "adain_t_stdout.txt"), "w")
    with quiet, contextlib.redirect_stdout(quiet):
        check(train2d.main(targv, device="cuda") == 0, "AdaIN temporal run")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(tlog, "temporal_decoder.jsonl")) as fh:
        trec = [json.loads(line) for line in fh]
    tckpt = os.path.join(tsave, "adain_temporal", f"ckpt_{ADAIN_T_STEPS:08d}.pt")
    renders, coor, cps, focal, styles = adain_frames(geo_dir, styles_dir)
    h, w = renders.shape[1:3]
    print(f"[adain] {card}: temporal_decoder on phase 5's {len(renders)} views ({h}x{w}, "
          f"geometry.npz), batch 8 of full frames, {ADAIN_T_STEPS} steps; loss_t "
          + ", ".join(f"{r['loss_t']:.4g}" for r in trec)
          + f"; peak allocated {peak:.2f} GiB (cuDNN TF32 {tf32[1]})", flush=True)
    check(len(trec) == ADAIN_T_STEPS and all(math.isfinite(r["loss_t"]) and r["loss_t"] > 0
                                             for r in trec),
          "AdaIN temporal loss_t not finite and positive at every step")
    check(os.path.exists(tckpt), "the adain_temporal checkpoint is missing")

    # (d) one temporal step, card against CPU: batch 2, ids [0, 1], TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    ids = np.array([0, 1])
    batch = (renders[ids], coor[ids], cps[ids], np.broadcast_to(styles[0], (2, h, w, 3)).copy())
    (m_card, g_card), (m_cpu, g_cpu) = (adain_step_on(d, tckpt, batch, (h, w, focal))
                                        for d in ("cuda", "cpu"))
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    cos = grad_cos(*(torch.cat([g.flatten() for g in gs]) for gs in (g_card, g_cpu)))
    print(f"[adain] one temporal step, card vs CPU (batch 2, ids [0, 1], style 0, TF32 off): "
          + ", ".join(f"{k} {m_card[k]:.6g} vs {m_cpu[k]:.6g} ({rel[k]:.2e})" for k in m_cpu)
          + f" (limit {TOL_ADAIN_LOSS} on loss); decoder gradient cosine {cos:.7f} (limit "
          f"{TOL_ADAIN_COS})", flush=True)
    check(rel["loss"] <= TOL_ADAIN_LOSS and cos >= TOL_ADAIN_COS and m_cpu["loss_t"] > 0,
          "the AdaIN temporal step on the card disagrees with the CPU's")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def free_port() -> int:
    """A localhost port free at the time of the call."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(job_path: str, out_path: str):
    """Both ranks of ``multi_worker``; their logs. A rank that fails or
    outlives MP_TIMEOUT fails the phase, and both are stopped."""
    port = free_port()
    repo = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {repo!r}); import chip_smoke; "
            f"chip_smoke.multi_worker({job_path!r}, {out_path!r})")
    t0 = time.perf_counter()
    procs = []
    for r in range(MP_WORLD):
        env = dict(os.environ, TGTC_COORDINATOR=f"127.0.0.1:{port}",
                   TGTC_NUM_PROCESSES=str(MP_WORLD), TGTC_PROCESS_ID=str(r),
                   GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=repo, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = []
    try:
        for p in procs:
            left = max(1.0, MP_TIMEOUT - (time.perf_counter() - t0))
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, log in enumerate(logs):
        print("\n".join(f"[multi rank {r}] {line}" for line in log.splitlines()[-60:]),
              flush=True)
    check(all(p.returncode == 0 for p in procs),
          f"a worker failed: exit codes {[p.returncode for p in procs]}")
    return logs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tgtc_torch.convert import nerf_state_dict_from_flax
    from tgtc_torch.ops.kernels import _build
    from tgtc_torch.ops.kernels import flash_attention as fa
    from tgtc_torch.ops.kernels import nerf_mlp as ks
    from tgtc_torch.ops.kernels import nerf_mlp_grad as kg
    from tgtc_torch.ops.kernels import style_kernel as kst

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    sources = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    libs = _build.build_all(sources)
    print(f"[build] torch {torch.__version__} CUDA {torch.version.cuda}; built "
          f"{', '.join(p.name for p in libs)}", flush=True)
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
    phase_main_path(ks, sd_c, sd_f)
    trained_renderer, trained = phase_train(ks, kg)
    with tempfile.TemporaryDirectory() as tmp:
        geo_dir = phase_b(ks, trained_renderer, tmp)
        phase_f(ks, kst, trained)
        phase_c3(fa, geo_dir, tmp)
        c1_ckpt, styles = phase_c1(fa, geo_dir, tmp)
        model = phase_c2(fa, geo_dir, c1_ckpt, styles, tmp)
        feats = phase_c3c2(fa, model, geo_dir, styles, tmp)
        del model
        n_views = len([f for f in os.listdir(geo_dir) if f.startswith("rgb_")])
        vae_ckpt = phase_d(ks, kst, trained, styles, feats, n_views, tmp)
        phase_e(ks, kg, kst, fa, trained, tmp, os.path.join(tmp, "stylized_c2"), vae_ckpt)
        pipe = phase_pipeline(ks, kg, kst, fa, tmp, card)
        proposal = phase_levers(ks, kg, kst, trained, pipe, tmp)
        phase_multi(ks, kg, trained, pipe, proposal, styles, tmp, card)
        phase_adain(tmp, geo_dir, styles, card)

    print(f"[result] card {card}; every phase's checks held", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
