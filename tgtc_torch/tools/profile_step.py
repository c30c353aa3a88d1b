"""Device-time breakdown of the Phase-A training step on the card.

    python3 -m tgtc_torch.tools.profile_step

Runs the fused step that chip_smoke.py's train phase runs (D8/W256 trunks,
L 10/4, viewdirs, batch 2048, 64+64 samples, perturb on, σ noise 1.0) on the
rays of a fern-shaped 756x1008 NDC camera with random target colours: 10
warm-up steps, 50 steps timed without the profiler (one sync at the end),
then 10 steps under ``torch.profiler``. Prints the card, the step times, the
device's busy time (the union of its kernels' and copies' intervals) and
idle share over the profiled steps, and device time by kernel name, then one
JSON line with the same numbers. Needs CUDA.
"""

from __future__ import annotations

import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tgtc_torch.data.rays import rays_for_poses
from tgtc_torch.models.nerf import NerfConfig
from tgtc_torch.tools.profile_frame import FOCAL, H, W, busy_us
from tgtc_torch.train import nerf_trainer as tt

WARMUP, TIMED, PROFILED = 10, 50, 10


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

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

    def run(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, ro, rd, rgb, generator=gen)
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
    print(f"Phase-A step (batch {tc.batch_size}, {tc.n_samples}+{tc.n_samples_fine} "
          f"samples, D{cfg.depth}/W{cfg.width}): {plain_s * 1e3:.3f} ms without the "
          f"profiler ({1 / plain_s:.2f} steps/s), {profiled_s * 1e3:.3f} ms under it; "
          f"device busy {busy_step_s * 1e3:.3f} ms per step, idle share "
          f"{1 - busy_step_s / profiled_s:.4f}", flush=True)
    for name, (count, ms) in top[:16]:
        print(f"  {ms:10.3f} ms/step  {count // PROFILED:5d}x  "
              f"{ms / (busy_step_s * 1e3):7.2%}  {name[:90]}")
    print(json.dumps({
        "card": card, "step_ms": plain_s * 1e3, "steps_per_s": 1 / plain_s,
        "profiled_step_ms": profiled_s * 1e3, "device_busy_ms_per_step": busy_step_s * 1e3,
        "idle_share": 1 - busy_step_s / profiled_s,
        "kernels": [{"name": n, "count_per_step": c / PROFILED, "ms_per_step": ms}
                    for n, (c, ms) in top[:16]],
    }))


if __name__ == "__main__":
    main()
