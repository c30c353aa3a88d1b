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
3. Phase B: writes a 2-view 756x1008 synthetic LLFF scene, loads it and
   runs dump_geometry; every artifact must exist and coor_map be finite;
4. prints the kernels line (JSON), then the result line.

Any failed check raises, so the script exits non-zero and prints no result.
It needs CUDA and the rest of the repository beside it.
"""

from __future__ import annotations

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
FLOP_PER_POINT = {"K1": 1_186_816, "K2": 982_528}
TOL_RGB, TOL_SIGMA, TOL_RENDER = 3e-2, 2e-1, 5e-2


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def he_params(rng: np.random.Generator, depth=8, width=256, fc=10, fd=4, skip=4):
    """Random D8/W256 flax-layout params, He-normal kernels, zero biases."""
    in_pts, in_dir = 3 * (1 + 2 * fc), 3 * (1 + 2 * fd)

    def dense(nin, nout):
        return {"kernel": rng.standard_normal((nin, nout), np.float32)
                * np.float32((2.0 / nin) ** 0.5),
                "bias": np.zeros((nout,), np.float32)}

    layers = {"base_0": dense(in_pts, width)}
    for i in range(depth - 1):
        layers[f"base_{i + 1}"] = dense(width + in_pts if i == skip else width, width)
    layers["sigma"] = dense(width, 1)
    layers["base_remap"] = dense(width, 256)
    layers["rgb_0"] = dense(256 + in_dir, width // 2)
    layers["rgb_1"] = dense(width // 2, 3)
    return {"params": layers}


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


def bound_ms(name: str, p: int, packed) -> float:
    flops = FLOP_PER_POINT[name] * p
    io = (10 if name == "K1" else 4) * 4 * p  # pts(+dirs) in, sigma(+rgb) out
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


def phase_b(ks, renderer):
    from tgtc_torch.data.llff import load_llff_data
    from tgtc_torch.train.geometry import dump_geometry

    with tempfile.TemporaryDirectory() as tmp:
        scene = load_llff_data(write_scene(os.path.join(tmp, "scene")), factor=1)
        out_dir = os.path.join(tmp, "geometry")
        ks.fused_nerf_apply_t.launches = 0
        ks.fused_nerf_sigma_apply_t.launches = 0
        t0 = time.perf_counter()
        dump_geometry(renderer, scene, out_dir)
        dt = time.perf_counter() - t0
        n = scene.poses.shape[0]
        names = [f"{kind}_{i:05d}.{ext}" for i in range(n)
                 for kind, ext in (("rgb", "png"), ("depth", "png"), ("geometry", "npz"))]
        missing = [f for f in names + ["geometry.npz"]
                   if not os.path.exists(os.path.join(out_dir, f))]
        check(not missing, f"Phase B artifacts missing: {missing}")
        geo = np.load(os.path.join(out_dir, "geometry.npz"))
        check(geo["coor_maps"].shape == (n, H, W, 3), "coor_maps shape")
        check(bool(np.isfinite(geo["coor_maps"]).all()), "coor_map not finite")
        print(f"[phase_b] {n} views at {H}x{W}: dump_geometry {dt:.2f} s, "
              f"{len(names) + 1} files, launches K1 {ks.fused_nerf_apply_t.launches} "
              f"K2 {ks.fused_nerf_sigma_apply_t.launches}", flush=True)
        check(ks.fused_nerf_apply_t.launches > 0 and ks.fused_nerf_sigma_apply_t.launches > 0,
              "Phase B did not go through the kernels")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tgtc_torch.convert import nerf_state_dict_from_flax
    from tgtc_torch.ops.kernels import _build
    from tgtc_torch.ops.kernels import nerf_mlp as ks

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

    rows = phase_kernels(ks, sd_c)
    renderer, launches, rays_per_s = phase_main_path(ks, sd_c, sd_f)
    for row in rows:
        row["launches"] = launches[row["name"]]
    phase_b(ks, renderer)

    print(f"[result] card {card}; frame {rays_per_s:.1f} rays/s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
