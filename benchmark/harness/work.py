"""Operations and bytes of the kernels and models the cells run, from the layer
shapes of a configuration, and the card's peaks.

The counts are the work the algorithm needs at the cell's shapes, whatever
implements it: a multiply-add is 2 FLOP; bytes are each input read once and
each output and weight written or read once, never a kernel's workspace.
They follow ``chip_smoke.py``'s ``FLOP_PER_POINT`` and ``bound_ms`` for K1, K2,
K4 and K5 (D8/W256: 1,186,816, 982,528, 2,898,944, 982,528 FLOP a point),
and correct K3: its 3,489,024 counted the forward it recomputes; the
backward needs the weight gradients of every layer and the input gradients
of every layer whose input is trained (not the encodings): 2,302,208.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.harness.traffic import linear_shapes, style_shapes

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet, 700 W)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3


def _macs(shapes: List[Tuple[str, int, int]], names) -> int:
    return sum(o * i for n, o, i in shapes if n in names)


def trunk_flop(config: Dict) -> Dict[str, int]:
    """FLOP a point of one NeRF trunk: ``sigma`` (the trunk and σ head: K2,
    K5), ``full`` (with ``base_remap`` and the rgb head: K1), ``remap``
    (the trunk, σ and ``base_remap``: what the style chain reads) and
    ``backward`` (K3: weight gradients of all, input gradients of the parts
    of each input that are trained)."""
    sh = linear_shapes(config)
    d = int(config["netdepth"])
    in_c, in_d = 3 + 6 * int(config["multires"]), 3 + 6 * int(config["multires_views"])
    trunk = {f"base_layers.{i}" for i in range(d)} | {"sigma_layer"}
    sigma = 2 * _macs(sh, trunk)
    remap = sigma + 2 * _macs(sh, {"base_remap_layer"})
    full = 2 * sum(o * i for _, o, i in sh)
    # input gradients: every layer but the first; the skip layer and rgb_0
    # without their encoding columns
    dx = sum(o * (i - (in_c if n.startswith("base_layers.") and i > int(config["netwidth"])
                       else in_d if n == "rgb_layers.0" else 0))
             for n, o, i in sh if n != "base_layers.0")
    backward = full + 2 * dx
    return {"sigma": sigma, "remap": remap, "full": full, "backward": backward}


def style_flop(config: Dict) -> int:
    """FLOP a point of the concat and style MLPs (no trunk). The style MLP's
    latent input is the per-ray mean of the latent repeated over its columns
    (the reference's ``lat_scalar``), so its latent columns add one term a
    ray and a layer (their row sum times the mean), not a term a point, as K4
    computes it; the concat MLP's latent columns count a point."""
    sh = style_shapes(config)
    lat = int(config["vae_latent"])
    concat = 2 * sum(o * i for n, o, i in sh if n.startswith("concat."))
    style = 2 * sum(o * (i - lat) for n, o, i in sh if n.startswith("style."))
    return concat + style


def k4_flop(config: Dict) -> int:
    """K4 a point: the trunk to σ and ``base_remap``, then both style MLPs."""
    return trunk_flop(config)["remap"] + style_flop(config)


def trunk_weight_bytes(config: Dict, sigma_only: bool = False) -> int:
    """A packed trunk as the kernels read it: bf16 weights and f32 biases."""
    sh = linear_shapes(config)
    if sigma_only:
        d = int(config["netdepth"])
        keep = {f"base_layers.{i}" for i in range(d)} | {"sigma_layer"}
        sh = [s for s in sh if s[0] in keep]
    return sum(2 * o * i + 4 * o for _, o, i in sh)


def style_weight_bytes(config: Dict) -> int:
    """Both style MLPs as bf16 weights and f32 biases, beside a trunk."""
    return sum(2 * o * i + 4 * o for _, o, i in style_shapes(config))


def bound_s(flop: float, nbytes: float) -> float:
    """The least time the card could take: max(FLOP / bf16 peak, bytes / HBM)."""
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def kernel_work(name: str, config: Dict, points: int, rays: int, launches: int
                ) -> Tuple[float, float]:
    """``(FLOP, bytes)`` of ``launches`` launches of kernel ``name`` over
    ``points`` points of ``rays`` rays in all: f32 points (and directions)
    in, f32 σ (and rgb) out, weights once a launch."""
    t = trunk_flop(config)
    if name == "K1":  # pts + dirs in, rgb + sigma out
        return t["full"] * points, 40 * points + launches * trunk_weight_bytes(config)
    if name in ("K2", "K5"):  # pts in, sigma out
        return t["sigma"] * points, 16 * points + launches * trunk_weight_bytes(config, True)
    if name == "K3":  # pts, dirs, d rgb, d sigma in; f32 weight gradients out
        wb = trunk_weight_bytes(config)
        n_wb = sum(o * i + o for _, o, i in linear_shapes(config))
        return t["backward"] * points, 40 * points + launches * (wb + 4 * n_wb)
    if name == "K4":  # pts in and a latent a ray, rgb + sigma out
        lat = 4 * int(config["vae_latent"])
        wb = trunk_weight_bytes(config) + style_weight_bytes(config)
        return k4_flop(config) * points, 28 * points + lat * rays + launches * wb
    raise KeyError(name)
