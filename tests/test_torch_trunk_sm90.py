"""What the Hopper dense-layer engine (tgtc_torch/csrc/trunk_sm90.cuh: K1,
K2, K4 and K5) assumes of the packed weights, held on the CPU for both
packers at fern widths and at the narrow widths of the twin tests.

Each tensor-core layer is one packed row-major [N, K] bf16 matrix streamed
by TMA in boxes of 64 columns x N rows: its start must be 16-byte aligned
(the packer aligns to 32), its row of K bf16 a multiple of 16 bytes, N at
most a box's 256 rows, and its input segments (the reference's column
order) must add up to K, each a multiple of 16 columns so that every wgmma
k step of 16 columns lies in one segment. K splits into ceil(K / 64)
chunks; the last chunk's columns past K arrive as TMA's zero fill. The
heads on CUDA cores (sigma, rgb) are not streamed. The sigma-only kernels
K2 and K5 stream the trunk's layers alone, the same matrices and segments
that begin K1's and K4's plans: that, and the one trunk function all four
run, is why their sigmas tie bit for bit.
"""

import math

import pytest
import torch

from tgtc_torch.models.nerf import NerfConfig, make_nerf
from tgtc_torch.models.style_field import StyleFieldConfig, make_style_mlps
from tgtc_torch.ops.kernels import nerf_mlp as tk
from tgtc_torch.ops.kernels import style_kernel as ts

# What csrc/trunk_sm90.cuh streams: each tensor-core layer's packed [N, K]
# matrix in TMA boxes of TMA_BOX_COLS columns x N rows (N <= TMA_MAX_ROWS).
TMA_BOX_COLS, TMA_MAX_ROWS = 64, 256

# (depth, width, frequencies, skip): fern's, and the narrow one of
# tests/test_torch_nerf_kernel.py
NERF_SHAPES = [(8, 256, (10, 4), 4), (4, 64, (6, 2), 2)]
# style width and style_d: fern's, and tests/test_torch_style_kernel.py's
STYLE_SHAPES = [(256, 8), (128, 8), (256, 4)]


def _nerf(depth, width, freqs, skip):
    cfg = NerfConfig(depth=depth, width=width, embed_freq_coor=freqs[0],
                     embed_freq_dir=freqs[1], skips=(skip,))
    sd = make_nerf(cfg, torch.Generator().manual_seed(0), device="cpu").state_dict()
    return sd, tk.pack_nerf_params(sd, depth=depth, num_freq_coor=freqs[0],
                                   num_freq_dir=freqs[1], skip=skip, width=width)


def _style(width, style_d):
    sd, _ = _nerf(8, 256, (10, 4), 4)
    concat, style = make_style_mlps(StyleFieldConfig(style_d=style_d, width=width),
                                    torch.Generator().manual_seed(1), device="cpu")
    return ts.pack_style_params(sd, concat.state_dict(), style.state_dict(),
                                style_d=style_d, style_width=width)


def _k1_layers(packed):
    """K1's tensor-core layers in the engine's order (csrc/nerf_mlp.cu):
    (packed matrix index, input segments (name, columns) in column order).
    The trunk, base_remap and rgb_0; sigma and rgb_1 run on CUDA cores."""
    d, kc, w = packed.depth, packed.k_coor, packed.width
    layers = [(i, (("enc_pts", kc),) if i == 0 else
               (("enc_pts", kc), ("h", w)) if i == packed.skip + 1 else (("h", w),))
              for i in range(d)]
    return layers + [(d, (("h", w),)),
                     (d + 2, (("base_remap", tk.TRUNK_W), ("enc_dirs", packed.k_dir)))]


def _k4_layers(packed):
    """K4's tensor-core layers in the engine's order (csrc/style_kernel.cu):
    the trunk, base_remap, the concat and the hidden style layers; sigma and
    rgb_out run on CUDA cores. The concat features replace the trunk's h."""
    kc, sw, nl, skip = packed.k_coor, packed.style_width, packed.latent_dim, packed.skip
    layers = [(i, (("enc_pts", kc),) if i == 0 else
               (("enc_pts", kc), ("h", packed.width)) if i == skip + 1
               else (("h", packed.width),)) for i in range(packed.depth)]
    layers.append((packed.depth, (("h", packed.width),)))
    for i in range(packed.n_concat):
        segs = ((("enc_pts", kc) if i == 0 else ("h", sw)), ("lat", nl))
        layers.append((packed.concat_index(i), segs + ((("enc_pts", kc),) if i == skip else ())))
    for i in range(packed.style_d - 1):
        segs = ((("base_remap", tk.TRUNK_W), ("h", sw), ("enc_pts", kc)) if i == 0
                else (("h", sw),) + ((("enc_pts", kc),) if i == skip else ()))
        layers.append((packed.style_index(i), segs))
    return layers


def _k2_layers(packed):
    """K2's tensor-core layers (csrc/trunk_sm90.cuh, sigma_kernel): the
    trunk's depth layers, [enc(pts) | h] at skip + 1; sigma runs on CUDA
    cores from matrix depth + 1."""
    d, kc, w = packed.depth, packed.k_coor, packed.width
    return [(i, (("enc_pts", kc),) if i == 0 else
             (("enc_pts", kc), ("h", w)) if i == packed.skip + 1 else (("h", w),))
            for i in range(d)]


def _k5_layers(packed):
    """K5's tensor-core layers: K2's plan on K4's packing, whose trunk
    matrices are 0..depth-1 and sigma depth + 1 as in K2's."""
    return _k2_layers(packed)


def _chunks(k):
    """The engine's chunks of a layer: (first column, columns streamed,
    columns of TMA zero fill)."""
    n = math.ceil(k / TMA_BOX_COLS)
    return [(c * TMA_BOX_COLS, TMA_BOX_COLS,
             max(0, (c + 1) * TMA_BOX_COLS - k)) for c in range(n)]


def _check_engine_layout(packed, layers, expect_mats):
    shapes = packed.layers()
    assert [m for m, _ in layers] == expect_mats
    for mat, segs in layers:
        n, k = shapes[mat]
        off = packed.offsets[mat]
        assert (off * 2) % 32 == 0, (mat, off)            # TMA: 16-byte aligned start
        assert (k * 2) % 16 == 0, (mat, k)                # TMA: row stride in 16 bytes
        assert 1 <= n <= TMA_MAX_ROWS, (mat, n)           # one box holds every row
        assert sum(c for _, c in segs) == k, (mat, segs, k)
        assert all(c % 16 == 0 for _, c in segs), (mat, segs)
        assert packed.weight(mat).shape == (n, k)
        chunks = _chunks(k)
        assert sum(cols - zero for _, cols, zero in chunks) == k
        assert all(zero == 0 for _, _, zero in chunks[:-1])
        assert 0 <= chunks[-1][2] < TMA_BOX_COLS and chunks[-1][2] % 16 == 0
        # the matrix occupies its own elements: the next one starts past it
        assert off + n * k <= packed.w.numel()


@pytest.mark.parametrize("depth,width,freqs,skip", NERF_SHAPES)
def test_k1_packing_meets_the_engines_tma_boxes(depth, width, freqs, skip):
    _, packed = _nerf(depth, width, freqs, skip)
    layers = _k1_layers(packed)
    _check_engine_layout(packed, layers, list(range(depth)) + [depth, depth + 2])
    ks = [packed.layers()[m][1] for m, _ in layers]
    if (depth, width, freqs) == (8, 256, (10, 4)):  # the shape the CUDA kernel takes
        assert ks == [64, 256, 256, 256, 256, 320, 256, 256, 256, 288]
        assert [len(_chunks(k)) for k in ks] == [1, 4, 4, 4, 4, 5, 4, 4, 4, 5]
        assert _chunks(288)[-1] == (256, 64, 32)  # rgb_0: [base_remap | enc(dirs) 32]


@pytest.mark.parametrize("width,style_d", STYLE_SHAPES)
def test_k4_packing_meets_the_engines_tma_boxes(width, style_d):
    packed = _style(width, style_d)
    layers = _k4_layers(packed)
    expect = (list(range(packed.depth + 1))
              + [packed.concat_index(i) for i in range(packed.n_concat)]
              + [packed.style_index(i) for i in range(style_d - 1)])
    _check_engine_layout(packed, layers, expect)
    if (width, style_d) == (256, 8):  # the shape the CUDA kernel takes
        ks = [packed.layers()[m][1] for m, _ in layers]
        assert ks[9:] == [96, 288, 288, 288, 352, 576, 256, 256, 256, 320, 256, 256]
        assert [_chunks(k)[-1][2] for k in ks[9:14]] == [32, 32, 32, 32, 32]
        assert len(layers) == 21


# The sigma-only plan at fern width: (columns, chunks) of each trunk layer.
SIGMA_KS = [64, 256, 256, 256, 256, 320, 256, 256]
SIGMA_CHUNKS = [1, 4, 4, 4, 4, 5, 4, 4]


@pytest.mark.parametrize("depth,width,freqs,skip", NERF_SHAPES)
def test_k2_packing_meets_the_engines_tma_boxes(depth, width, freqs, skip):
    _, packed = _nerf(depth, width, freqs, skip)
    layers = _k2_layers(packed)
    _check_engine_layout(packed, layers, list(range(depth)))
    assert packed.layers()[depth + 1] == (1, width)  # sigma, on CUDA cores
    if (depth, width, freqs) == (8, 256, (10, 4)):  # the shape the CUDA kernel takes
        ks = [packed.layers()[m][1] for m, _ in layers]
        assert ks == SIGMA_KS
        assert [len(_chunks(k)) for k in ks] == SIGMA_CHUNKS
        assert sum(SIGMA_CHUNKS) == 30  # 983,040 B of weights a tile


@pytest.mark.parametrize("width,style_d", STYLE_SHAPES)
def test_k5_packing_meets_the_engines_tma_boxes(width, style_d):
    packed = _style(width, style_d)
    layers = _k5_layers(packed)
    _check_engine_layout(packed, layers, list(range(packed.depth)))
    assert packed.layers()[packed.depth + 1] == (1, packed.width)  # sigma
    ks = [packed.layers()[m][1] for m, _ in layers]
    assert ks == SIGMA_KS and [len(_chunks(k)) for k in ks] == SIGMA_CHUNKS


@pytest.mark.parametrize("kind,shape", [("nerf", s) for s in NERF_SHAPES]
                         + [("style", s) for s in STYLE_SHAPES])
def test_sigma_plan_is_the_head_of_k1s_and_k4s(kind, shape):
    """K2's plan is the first depth entries of K1's, K5's of K4's: the same
    matrices with the same segments, so the four kernels stream the same
    trunk. On the same trunk K5's matrices, biases and sigma head equal
    K2's element for element."""
    if kind == "nerf":
        _, packed = _nerf(*shape)
        sigma_plan, full_plan = _k2_layers(packed), _k1_layers(packed)
    else:
        packed = _style(*shape)
        sigma_plan, full_plan = _k5_layers(packed), _k4_layers(packed)
        _, nerf = _nerf(8, 256, (10, 4), 4)  # _style's trunk
        assert _k2_layers(nerf) == sigma_plan
        for m in list(range(packed.depth)) + [packed.depth + 1]:
            assert torch.equal(packed.weight(m), nerf.weight(m)), m
            assert torch.equal(packed.bias(m), nerf.bias(m)), m
    assert sigma_plan == full_plan[:packed.depth]
