"""Device-time breakdown of a training step on the card.

    python3 -m tgtc_torch.tools.profile_step [--c1 | --c2 | --e]

Without a flag, the fused Phase-A step that chip_smoke.py's train phase runs
(D8/W256 trunks, L 10/4, viewdirs, batch 2048, 64+64 samples, perturb on, σ
noise 1.0) on the rays of a fern-shaped 756x1008 NDC camera with random
target colours. With ``--c1``, the Phase-C1 step that chip_smoke.py's C1
phase runs: a full-width StyTrans (d_model 512, 8 heads, 3+3 layers, FFN
2048, dropout 0.1, bf16, flash attention on K6/K7/K8, torch seed 21, random
VGG and decoder) on seeded uint8 batches of 8 256x256 crops, with device
time also summed by kind (K6, K7, K8, convolution, GEMM, LayerNorm, other).
With ``--c2``, the Phase-C2 step that chip_smoke.py's C2 phase runs: the
same network (decoder trained alone, so K6 only) at TemporalTrainConfig's
defaults on seeded batches of 4 256x256 patches, the point splat of the
patch into 4 views of a 756x1008 frame whose NDC coor maps are a tilted
plane seen from four nearby cameras, device time by kind too. With
``--e``, the Phase-E step that chip_smoke.py's Phase-E phase runs at fern's
settings (D8/W256 bf16 trunks, ``style_d`` 8, width 256, latent 32, batch
256 a stream, 64+64 samples, σ noise 1.0, λ_coh 1e2, PyTorch's default f32
matmuls) on 8 styles x 2 views of a fern-shaped 756x1008 NDC camera with
seeded random images, the coherence loss active after the warm-up; device
time by kind too (the latent table's gather backward is "index/scatter").
10 warm-up steps, 50 steps timed without the profiler (one sync at the
end), then 10 steps under ``torch.profiler``. Prints the card, the step
times, the device's busy time (the union of its kernels' and copies'
intervals) and idle share over the profiled steps, and device time by
kernel name, then one JSON line with the same numbers. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tgtc_torch.data.rays import rays_for_poses
from tgtc_torch.models.nerf import NerfConfig
from tgtc_torch.tools.profile_frame import FOCAL, H, W, busy_us, kind_of
from tgtc_torch.train import nerf_trainer as tt

WARMUP, TIMED, PROFILED = 10, 50, 10


def c1_step():
    """One Phase-C1 step at full width on fixed seeded uint8 batches, and
    its description."""
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train import transformer2d as t2

    tc = t2.TransformerTrainConfig()
    model = make_stytrans(TransformerConfig(dtype=torch.bfloat16, attn_impl="flash"),
                          torch.Generator().manual_seed(21), device="cuda")
    state = t2.init_transformer_train(model, tc)
    step = t2.make_transformer_train_step(model, tc)
    rng = np.random.default_rng(0)
    content, style = (torch.from_numpy(rng.integers(0, 256, (tc.batch_size, tc.patch, tc.patch, 3),
                                                    dtype=np.uint8)).cuda() for _ in range(2))
    return (lambda: step(state, content, style, seed=3),
            f"Phase-C1 step (batch {tc.batch_size} of {tc.patch}x{tc.patch}, d_model 512, "
            f"bf16, flash, dropout 0.1)")


def c2_step():
    """One Phase-C2 step at full width on fixed seeded batches, and its
    description."""
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train import temporal as tp

    cfg = tp.TemporalTrainConfig()
    model = make_stytrans(TransformerConfig(dtype=torch.bfloat16, attn_impl="flash"),
                          torch.Generator().manual_seed(21), device="cuda")
    state = tp.init_temporal_train(model, cfg)
    step = tp.make_temporal_train_step(model, cfg, tp.SplatCamera.llff(H, W, FOCAL,
                                                                        device="cuda"))
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    z = -2.0 - 0.1 * (xs - W / 2) / FOCAL
    ndc = np.stack([(xs - W / 2) / (W / 2), -(ys - H / 2) / (H / 2), 1 + 2 / z], -1)
    cps = np.stack([np.eye(4)] * cfg.batch_size).astype(np.float32)
    cps[:, 0, 3] = 0.02 * np.arange(cfg.batch_size)
    rng = np.random.default_rng(0)
    y0, x0, p = 200, 300, cfg.patch
    content, style = (torch.from_numpy(rng.integers(0, 256, (cfg.batch_size, p, p, 3),
                                                    dtype=np.uint8)).cuda() for _ in range(2))
    coor = torch.from_numpy(np.stack([ndc[y0: y0 + p, x0: x0 + p]] * cfg.batch_size)
                            .astype(np.float32)).cuda()
    cps = torch.from_numpy(cps).cuda()
    return (lambda: step(state, content, coor, cps, style, (y0, x0), seed=3),
            f"Phase-C2 step (batch {cfg.batch_size} of {p}x{p}, splat into {H}x{W}, d_model "
            f"512, bf16, flash, dropout 0.1, decoder only)")


def e_step():
    """One Phase-E step at fern's settings on a seeded scene, and its
    description."""
    from tgtc_torch.data.style_dataset import StyleSceneData
    from tgtc_torch.models.nerf import make_nerf
    from tgtc_torch.models.style_field import StyleFieldConfig
    from tgtc_torch.train import style3d as s3

    s, f = 8, 2
    cfg = s3.StyleTrainConfig(origin_step=0, coh_until_step=1999)
    nerf = [make_nerf(NerfConfig(), torch.Generator().manual_seed(i), device="cuda")
            for i in (0, 1)]
    intr = np.array([[FOCAL, 0, 0.5 * W], [0, FOCAL, 0.5 * H], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * f)
    poses[1, 0, 3] = 0.05
    ro, rd = rays_for_poses(H, W, intr, poses, use_ndc=True, device="cuda")
    gen = torch.Generator().manual_seed(1)
    data = StyleSceneData(ro, rd, torch.rand((f, H, W, 3), generator=gen).cuda(),
                          torch.rand((s, f, H, W, 3), generator=gen).cuda(),
                          torch.randn((s, 1024), generator=gen).cuda())
    field = StyleFieldConfig(embed_dim=nerf[0].cfg.input_ch)
    state = s3.init_style_state(torch.Generator().manual_seed(2), field, cfg, s, f,
                                device="cuda")
    step = s3.make_style_train_step(*nerf, cfg)
    return (lambda: step(state, data, seed=3),
            f"Phase-E step (batch {cfg.batch_size} a stream, {cfg.n_samples}+"
            f"{cfg.n_samples_fine} samples, style_d {field.style_d}, width {field.width}, "
            f"latent {field.latent_dim}, {s} styles x {f} views of {H}x{W})")


def phase_a_step():
    """One fused Phase-A step at fern width, and its description."""
    cfg, tc = NerfConfig(), tt.NerfTrainConfig()
    state = tt.init_state(torch.Generator().manual_seed(0), cfg, tc, device="cuda")
    step = tt.make_fused_train_step(cfg, tc, device="cuda")
    intr = np.array([[FOCAL, 0, 0.5 * W], [0, FOCAL, 0.5 * H], [0, 0, 1]], np.float32)
    ro, rd = rays_for_poses(H, W, intr, np.eye(4, dtype=np.float32)[None, :3, :4],
                            use_ndc=True, device="cuda")
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    rgb = torch.rand(ro.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                     device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    return (lambda: step(state, ro, rd, rgb, generator=gen),
            f"Phase-A step (batch {tc.batch_size}, {tc.n_samples}+{tc.n_samples_fine} samples, "
            f"D{cfg.depth}/W{cfg.width})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--c1", action="store_true",
                       help="profile the Phase-C1 step (K6 + K7 + K8) instead of Phase A's")
    which.add_argument("--c2", action="store_true",
                       help="profile the Phase-C2 step (K6 and the splat) instead of Phase A's")
    which.add_argument("--e", action="store_true",
                       help="profile the Phase-E step (no hand-written kernel) instead of "
                            "Phase A's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    one_step, what = (c1_step() if args.c1 else c2_step() if args.c2 else e_step() if args.e
                      else phase_a_step())

    def run(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            one_step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(WARMUP)  # builds the kernels, fills the allocator
    plain_s = run(TIMED) / TIMED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = run(PROFILED) / PROFILED

    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise SystemExit("torch.profiler recorded no device events")
    busy_s = busy_us([(e.time_range.start, e.time_range.end) for e in device]) * 1e-6
    busy_step_s = busy_s / PROFILED
    by_name = defaultdict(lambda: [0, 0.0])
    for e in device:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() * 1e-3 / PROFILED
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    print(f"{what}: {plain_s * 1e3:.3f} ms without the "
          f"profiler ({1 / plain_s:.2f} steps/s), {profiled_s * 1e3:.3f} ms under it; "
          f"device busy {busy_step_s * 1e3:.3f} ms per step, idle share "
          f"{1 - busy_step_s / profiled_s:.4f}", flush=True)
    for name, (count, ms) in top[:16]:
        print(f"  {ms:10.3f} ms/step  {count // PROFILED:5d}x  "
              f"{ms / (busy_step_s * 1e3):7.2%}  {name[:90]}")
    kinds = defaultdict(lambda: [0, 0.0])
    for name, (count, ms) in by_name.items():
        kinds[kind_of(name)][0] += count
        kinds[kind_of(name)][1] += ms
    if args.c1 or args.c2 or args.e:
        for kind, (count, ms) in sorted(kinds.items(), key=lambda kv: -kv[1][1]):
            print(f"  by kind: {kind:12s} {ms:10.3f} ms/step  {count // PROFILED:5d}x  "
                  f"{ms / (busy_step_s * 1e3):7.2%}")
    print(json.dumps({
        "card": card, "c1": args.c1, "c2": args.c2, "e": args.e, "step_ms": plain_s * 1e3,
        "steps_per_s": 1 / plain_s,
        "profiled_step_ms": profiled_s * 1e3, "device_busy_ms_per_step": busy_step_s * 1e3,
        "idle_share": 1 - busy_step_s / profiled_s,
        "kernels": [{"name": n, "count_per_step": c / PROFILED, "ms_per_step": ms}
                    for n, (c, ms) in top[:16]],
        "kinds": {k: {"count_per_step": c / PROFILED, "ms_per_step": ms}
                  for k, (c, ms) in kinds.items()},
    }))


if __name__ == "__main__":
    main()
