"""Device-time breakdown of one fused-render frame on the card.

    python3 -m tgtc_torch.tools.profile_frame

Renders the frame that chip_smoke.py's main path renders (fern-shaped
756x1008 NDC camera, D8/W256 trunks with random weights, 64+64 samples,
σ-only coarse pass, 16,384-ray blocks): one warm-up frame, one frame timed
without the profiler, then one frame under ``torch.profiler``. Prints the
card, the two wall times, the device's busy time (the union of its
kernels' and copies' intervals) and idle share over the profiled frame,
and device time by kernel name, then one JSON line with the same numbers.
Needs CUDA.
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
from tgtc_torch.models.nerf import NerfConfig, make_nerf
from tgtc_torch.render.fast import FusedNerfRenderer
from tgtc_torch.render.volume import RenderSettings

H, W, FOCAL = 756, 1008, 815.0  # fern at factor 4 (configs/fern.txt)
BLOCK = 1 << 14


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    sds = [make_nerf(NerfConfig(), torch.Generator().manual_seed(s), device="cpu").state_dict()
           for s in (0, 1)]
    settings = RenderSettings(n_samples=64, n_samples_fine=64, sigma_noise_std=0.0)
    renderer = FusedNerfRenderer.from_params(*sds, settings, coarse_rgb=False, device="cuda")
    intr = np.array([[FOCAL, 0, 0.5 * W], [0, FOCAL, 0.5 * H], [0, 0, 1]], np.float32)
    ro, rd = rays_for_poses(H, W, intr, np.eye(4, dtype=np.float32)[None, :3, :4],
                            use_ndc=True, device="cuda")
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)

    def frame() -> float:
        t0 = time.perf_counter()
        renderer.render_image(ro, rd, block=BLOCK)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    frame()  # warm-up: builds the kernels, fills the allocator
    plain_s = frame()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = frame()

    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise SystemExit("torch.profiler recorded no device events")
    busy_s = busy_us([(e.time_range.start, e.time_range.end) for e in device]) * 1e-6
    by_name = defaultdict(lambda: [0, 0.0])
    for e in device:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() * 1e-3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    print(f"frame {H}x{W}, {ro.shape[0]} rays: {plain_s * 1e3:.1f} ms without the "
          f"profiler, {profiled_s * 1e3:.1f} ms under it; device busy "
          f"{busy_s * 1e3:.1f} ms, idle share {1 - busy_s / profiled_s:.4f}", flush=True)
    for name, (count, ms) in top[:12]:
        print(f"  {ms:10.3f} ms  {count:5d}x  {ms / (busy_s * 1e3):7.2%}  {name[:90]}")
    print(json.dumps({
        "card": card, "frame_ms": plain_s * 1e3, "profiled_frame_ms": profiled_s * 1e3,
        "device_busy_ms": busy_s * 1e3, "idle_share": 1 - busy_s / profiled_s,
        "kernels": [{"name": n, "count": c, "ms": ms} for n, (c, ms) in top[:12]],
    }))


if __name__ == "__main__":
    main()
