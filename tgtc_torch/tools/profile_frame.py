"""Device-time breakdown of one fused-render frame on the card.

    python3 -m tgtc_torch.tools.profile_frame [--stylized | --c3]

Renders the frame that chip_smoke.py's main path renders (fern-shaped
756x1008 NDC camera, D8/W256 trunks with random weights, 64+64 samples,
σ-only coarse pass, 16,384-ray blocks) — with ``--stylized`` the Phase-F
frame instead: the same trunks with fern-width style MLPs and a 1-style
latent table through FusedStyleRenderer (K5 coarse, K4 fine); with ``--c3``
one Phase-C3 frame: a full-width bf16 StyTrans (d_model 512, 8 heads, 3+3
layers, attention on K6, seeded weights) on a seeded 756x1008 image padded
to 760x1008 and a style of the same size, with device time also summed by
kind (K6, GEMM, convolution, LayerNorm, other). One warm-up
frame, one frame timed without the profiler, then one frame under
``torch.profiler``. Prints the card, the two wall times, the device's busy
time (the union of its kernels' and copies' intervals) and idle share over
the profiled frame, and device time by kernel name, then one JSON line
with the same numbers. Needs CUDA.
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
from tgtc_torch.models.nerf import NerfConfig, make_nerf
from tgtc_torch.models.style_field import StyleFieldConfig, init_latents, make_style_mlps
from tgtc_torch.render.fast import FusedNerfRenderer
from tgtc_torch.render.fast_style import FusedStyleRenderer
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
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--stylized", action="store_true",
                      help="profile the Phase-F stylized frame (K5 + K4)")
    mode.add_argument("--c3", action="store_true",
                      help="profile one Phase-C3 stylization frame (K6)")
    args = parser.parse_args()
    stylized = args.stylized
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    if args.c3:
        render = c3_frame()
    else:
        render = nerf_frame(stylized)

    def frame() -> float:
        t0 = time.perf_counter()
        render()
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
    what = "C3 " if args.c3 else "stylized " if stylized else ""
    print(f"{what}frame {H}x{W}: "
          f"{plain_s * 1e3:.1f} ms without the profiler, {profiled_s * 1e3:.1f} ms under it; "
          f"device busy {busy_s * 1e3:.1f} ms, idle share {1 - busy_s / profiled_s:.4f}",
          flush=True)
    for name, (count, ms) in top[:12]:
        print(f"  {ms:10.3f} ms  {count:5d}x  {ms / (busy_s * 1e3):7.2%}  {name[:90]}")
    kinds = defaultdict(lambda: [0, 0.0])
    for name, (count, ms) in by_name.items():
        kinds[kind_of(name)][0] += count
        kinds[kind_of(name)][1] += ms
    if args.c3:
        for kind, (count, ms) in sorted(kinds.items(), key=lambda kv: -kv[1][1]):
            print(f"  by kind: {kind:12s} {ms:10.3f} ms  {count:5d}x  {ms / (busy_s * 1e3):7.2%}")
    print(json.dumps({
        "card": card, "stylized": stylized, "c3": args.c3, "frame_ms": plain_s * 1e3,
        "profiled_frame_ms": profiled_s * 1e3,
        "device_busy_ms": busy_s * 1e3, "idle_share": 1 - busy_s / profiled_s,
        "kernels": [{"name": n, "count": c, "ms": ms} for n, (c, ms) in top[:12]],
        "kinds": {k: {"count": c, "ms": ms} for k, (c, ms) in kinds.items()},
    }))


def kind_of(name: str) -> str:
    """A device kernel's kind, by its name."""
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "K6"
    if "flash_bwd_dq_kernel" in n:
        return "K7"
    if "flash_bwd_dkv_kernel" in n:
        return "K8"
    if "conv" in n or "cudnn" in n or "implicit" in n or "xmma_fprop" in n:
        return "convolution"
    if "gemm" in n or "cutlass" in n or "sm90_xmma" in n or "nvjet" in n:
        return "GEMM"
    if "layer_norm" in n or "layernorm" in n:
        return "LayerNorm"
    if any(k in n for k in ("index_reduce", "indexfunc", "indexing_backward",
                            "index_elementwise", "scatter", "gather")):
        return "index/scatter"  # C2's splat: the z-buffer passes, the gather and its backward
    return "other"


def c3_frame():
    """One Phase-C3 stylization of a 756x1008 frame (padded to 760x1008)."""
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train.stylize import pad_to_multiple

    model = make_stytrans(TransformerConfig(dtype=torch.bfloat16, attn_impl="flash"),
                          torch.Generator().manual_seed(21), device="cuda")
    rng = np.random.default_rng(0)
    content, style = (torch.from_numpy(pad_to_multiple(
        rng.uniform(0, 1, (H, W, 3)).astype(np.float32)))[None].cuda() for _ in range(2))
    return lambda: model.stylize(content, style)


def nerf_frame(stylized: bool):
    """The fused render of one frame (plain or stylized)."""
    sds = [make_nerf(NerfConfig(), torch.Generator().manual_seed(s), device="cpu").state_dict()
           for s in (0, 1)]
    settings = RenderSettings(n_samples=64, n_samples_fine=64, sigma_noise_std=0.0)
    intr = np.array([[FOCAL, 0, 0.5 * W], [0, FOCAL, 0.5 * H], [0, 0, 1]], np.float32)
    ro, rd = rays_for_poses(H, W, intr, np.eye(4, dtype=np.float32)[None, :3, :4],
                            use_ndc=True, device="cuda")
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    if stylized:
        concat, style = make_style_mlps(StyleFieldConfig(), torch.Generator().manual_seed(2),
                                        device="cpu")
        lat = init_latents(torch.Generator().manual_seed(3), 1, 20, 32, device="cpu")
        renderer = FusedStyleRenderer.from_params(
            *sds, concat.state_dict(), style.state_dict(), lat, settings, coarse_rgb=False,
            device="cuda")
        render = lambda: renderer.render_image(ro, rd, 0, 0, block=BLOCK)
    else:
        renderer = FusedNerfRenderer.from_params(*sds, settings, coarse_rgb=False,
                                                 device="cuda")
        render = lambda: renderer.render_image(ro, rd, block=BLOCK)
    return render


if __name__ == "__main__":
    main()
