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

import numpy as np
import pytest
import torch

from tgtc_torch.models.nerf import NerfConfig, make_nerf
from tgtc_torch.models.style_field import StyleFieldConfig, make_style_mlps
from tgtc_torch.ops.kernels import nerf_mlp as tk
from tgtc_torch.ops.kernels import nerf_mlp_grad as tg
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


# ---------------------------------------------------------------- K3
#
# K3 (csrc/nerf_mlp_grad.cu) recomputes K1's forward (K1's plan above), then
# streams the backward's input-gradient products through the same ring: each
# is a transposed copy (WT) of the propagating columns of one packed matrix,
# [256 input columns, K output rows], in K-major boxes of 64 columns x 256
# rows. Then a weight-gradient kernel forms dW = G^T A per (layer, input
# segment) in tiles of 128 rows x up to 4 boxes of 64 columns; sigma and
# rgb_1 run on CUDA cores. The mirrors below follow the C code, and the
# emulation runs K3's dataflow on them in f32, held against the twin.

K3_TILE_ROWS, K3_TILE_BOXES = 128, 4


def _k3_backward_products(packed):
    """The backward's products in the producer's order: (packed matrix,
    first propagating input column, propagating columns, output rows
    contracted). rgb_0's base_remap columns, base_remap, then trunk layers
    depth-1 .. 1 (their h columns: the last width columns, KC.. at skip + 1)."""
    d, w = packed.depth, packed.width
    prods = [(d + 2, 0, tk.TRUNK_W, w // 2), (d, 0, w, tk.TRUNK_W)]
    for i in range(d - 1, 0, -1):
        prods.append((i, packed.k_coor if i == packed.skip + 1 else 0, w, w))
    return prods


def _k3_wt(packed, prods):
    """WT as transpose_kernel builds it: product m's propagating columns of
    its matrix, transposed, [columns, output rows]."""
    return [packed.weight(mat)[:, c0:c0 + n].float().T for mat, c0, n, _ in prods]


def _k3_jobs(packed):
    """The weight-gradient jobs of tgtc_nerf_mlp_bwd: (G array and its layer,
    A array and its layer, rows n, columns k, element offset of dW[0, 0],
    row stride, bias offset or None), and their tiles (job, n0, k0, boxes)."""
    d, w, kc, kd = packed.depth, packed.width, packed.k_coor, packed.k_dir
    n_l = len(packed.layers())
    woff, boff = packed.offsets[:n_l], packed.offsets[n_l:]
    jobs = [(("g", 0), ("ec", 0), w, kc, woff[0], kc, boff[0])]
    for i in range(1, d):
        if i == packed.skip + 1:
            jobs.append((("g", i), ("ec", 0), w, kc, woff[i], kc + w, boff[i]))
            jobs.append((("g", i), ("h", i - 1), w, w, woff[i] + kc, kc + w, None))
        else:
            jobs.append((("g", i), ("h", i - 1), w, w, woff[i], w, boff[i]))
    jobs.append((("g", d), ("h", d - 1), tk.TRUNK_W, w, woff[d], w, boff[d]))
    jobs.append((("grf", 0), ("xrf", 0), w // 2, tk.TRUNK_W + kd, woff[d + 2],
                 tk.TRUNK_W + kd, boff[d + 2]))
    tiles = []
    for j, (_, _, n, k, _, _, _) in enumerate(jobs):
        for n0 in range(0, n, K3_TILE_ROWS):
            for k0 in range(0, k, K3_TILE_BOXES * TMA_BOX_COLS):
                tiles.append((j, n0, k0, min(K3_TILE_BOXES, math.ceil((k - k0) / TMA_BOX_COLS))))
    return jobs, tiles


def _emulate_k3(packed, pts_t, dirs_t, g_rgb, g_sigma):
    """K3's dataflow in f32 on its plans: K1's forward with every input kept,
    the masked bf16 gradients through the WT products, dW and the biases from
    the jobs' tiles (zero fill past each array's columns), the heads."""
    d, bf = packed.depth, tk._bf16
    e_c = tk._encode_plain(pts_t.T.float(), packed.num_freq_coor, packed.k_coor)
    arrays = {("ec", 0): e_c}
    h = e_c
    for i in range(d):
        inp = e_c if i == 0 else (torch.cat([e_c, h], -1) if i == packed.skip + 1 else h)
        h = bf(torch.relu(tk._linear(inp, packed, i)))
        arrays[("h", i)] = h
    e_d = tk._encode_plain(dirs_t.T.float(), packed.num_freq_dir, packed.k_dir)
    br = bf(torch.relu(tk._linear(h, packed, d)))
    arrays[("xrf", 0)] = torch.cat([br, e_d], -1)
    rf = bf(torch.relu(tk._linear(arrays[("xrf", 0)], packed, d + 2)))
    rgb = torch.sigmoid(tk._linear(rf, packed, d + 3))
    gs = bf(g_rgb.T.float() * rgb * (1 - rgb))
    g = bf(torch.where(rf > 0, gs @ packed.weight(d + 3).float(), 0.0))
    arrays[("grf", 0)] = g
    masks = [br] + [arrays[("h", i)] for i in range(d - 1, -1, -1)]
    prods = _k3_backward_products(packed)
    g_sig = bf(g_sigma.T.float())
    for m, wt in enumerate(_k3_wt(packed, prods)):
        pre = g @ wt.T
        if m == 1:  # the sigma head's rank-1 term
            pre = pre + g_sig @ packed.weight(d + 1).float()
        g = bf(torch.where(masks[m] > 0, pre, 0.0))
        arrays[("g", d if m == 0 else d - m)] = g
    dw = torch.zeros(packed.w.numel())
    db = torch.zeros(packed.b.numel())
    jobs, tiles = _k3_jobs(packed)
    for j, n0, k0, kb in tiles:
        gk, ak, n, k, w_off, ldw, b_off = jobs[j]
        gt = arrays[gk][:, n0:n0 + K3_TILE_ROWS]
        at = torch.nn.functional.pad(arrays[ak], (0, 512))[:, k0:k0 + kb * TMA_BOX_COLS]
        part = gt.T @ at
        for r in range(gt.shape[1]):
            cols = min(part.shape[1], k - k0)
            dw[w_off + (n0 + r) * ldw + k0: w_off + (n0 + r) * ldw + k0 + cols] = part[r, :cols]
        if k0 == 0 and b_off is not None:
            db[b_off + n0: b_off + n0 + gt.shape[1]] = gt.sum(0)
    n_l = len(packed.layers())
    w_sig, w_rgb1 = packed.offsets[d + 1], packed.offsets[d + 3]
    dw[w_sig: w_sig + packed.width] = (g_sig.T @ arrays[("h", d - 1)])[0]
    db[packed.offsets[n_l + d + 1]] = g_sigma.sum()
    dw[w_rgb1: w_rgb1 + 3 * (packed.width // 2)] = (gs.T @ rf).reshape(-1)
    db[packed.offsets[n_l + d + 3]: packed.offsets[n_l + d + 3] + 3] = gs.sum(0)
    return dw, db


@pytest.mark.parametrize("depth,width,freqs,skip", NERF_SHAPES)
def test_k3_forward_plan_is_k1s(depth, width, freqs, skip):
    """K3's recompute streams K1's plan: the same matrices, segments and
    chunks, then the backward's products; at fern width 39 + 34 chunks a
    tile."""
    _, packed = _nerf(depth, width, freqs, skip)
    layers = _k1_layers(packed)
    _check_engine_layout(packed, layers, list(range(depth)) + [depth, depth + 2])
    prods = _k3_backward_products(packed)
    assert len(prods) == depth + 1  # layer 0 needs no input gradient
    if (depth, width, freqs) == (8, 256, (10, 4)):
        fwd = sum(len(_chunks(packed.layers()[m][1])) for m, _ in layers)
        bwd = sum(len(_chunks(k)) for _, _, _, k in prods)
        assert (fwd, bwd) == (39, 34)


@pytest.mark.parametrize("depth,width,freqs,skip", NERF_SHAPES)
def test_k3_backward_products_meet_the_ring(depth, width, freqs, skip):
    """Each backward product is a [propagating columns, output rows] WT
    matrix streamed as the forward's: at most 256 rows a box, K (the layer's
    output rows) in whole 64-column chunks, the skip layer's h columns and
    rgb_0's base_remap columns picked by offset."""
    _, packed = _nerf(depth, width, freqs, skip)
    prods = _k3_backward_products(packed)
    shapes = packed.layers()
    assert [m for m, _, _, _ in prods] == [depth + 2, depth] + list(range(depth - 1, 0, -1))
    for (mat, c0, n, k), wt in zip(prods, _k3_wt(packed, prods)):
        out_rows, in_cols = shapes[mat]
        assert k == out_rows and wt.shape == (n, k)
        assert 1 <= n <= TMA_MAX_ROWS and k % 16 == 0
        assert c0 + n <= in_cols
        if (depth, width, freqs) == (8, 256, (10, 4)):
            assert k % TMA_BOX_COLS == 0  # no zero fill in the backward
        torch.testing.assert_close(wt.T, packed.weight(mat)[:, c0:c0 + n].float())
    # rgb_0: [base_remap | enc(dirs)], the first 256 columns propagate
    assert prods[0][1:3] == (0, tk.TRUNK_W)
    assert shapes[depth + 2][1] == tk.TRUNK_W + packed.k_dir
    # the skip layer: [enc(pts) | h], only the h columns propagate
    skip_prod = [p for p in prods if p[0] == skip + 1]
    if skip + 1 < depth:
        assert skip_prod == [(skip + 1, packed.k_coor, width, width)]
        assert shapes[skip + 1][1] == packed.k_coor + width


@pytest.mark.parametrize("depth,width,freqs,skip", NERF_SHAPES)
def test_k3_weight_gradient_jobs_cover_every_weight_once(depth, width, freqs, skip):
    """The jobs' tiles and the two heads write every element of the packed
    weight and bias buffers exactly once (alignment gaps never), each tile
    in boxes of 64 columns that stay inside its job, TMA's zero fill only
    past an array's last column."""
    _, packed = _nerf(depth, width, freqs, skip)
    jobs, tiles = _k3_jobs(packed)
    shapes = packed.layers()
    n_l = len(shapes)
    wcount = torch.zeros(packed.w.numel(), dtype=torch.int32)
    bcount = torch.zeros(packed.b.numel(), dtype=torch.int32)
    for j, n0, k0, kb in tiles:
        _, _, n, k, w_off, ldw, b_off = jobs[j]
        assert n0 < n and k0 < k and 1 <= kb <= K3_TILE_BOXES
        # a tile's last box reaches past its job's columns by less than a box
        assert kb == K3_TILE_BOXES or 0 <= k0 + kb * TMA_BOX_COLS - k < TMA_BOX_COLS
        for r in range(n0, min(n, n0 + K3_TILE_ROWS)):
            lo = w_off + r * ldw + k0
            wcount[lo: lo + min(kb * TMA_BOX_COLS, k - k0)] += 1
        if k0 == 0 and b_off is not None:
            bcount[b_off + n0: b_off + min(n, n0 + K3_TILE_ROWS)] += 1
    for head in (depth + 1, depth + 3):  # sigma, rgb_1 on CUDA cores
        n, k = shapes[head]
        wcount[packed.offsets[head]: packed.offsets[head] + n * k] += 1
        bcount[packed.offsets[n_l + head]: packed.offsets[n_l + head] + n] += 1
    used = torch.zeros(packed.w.numel(), dtype=torch.int32)
    for i, (n, k) in enumerate(shapes):
        used[packed.offsets[i]: packed.offsets[i] + n * k] = 1
    assert torch.equal(wcount, used)
    assert bool((bcount == 1).all())
    # the skip layer's two segments and rgb_0's one job of [base_remap | enc(dirs)]
    if skip + 1 < depth:
        seg = [jb for jb in jobs if jb[0] == ("g", skip + 1)]
        assert [(a, k, w_off - packed.offsets[skip + 1]) for _, a, _, k, w_off, _, _ in seg] == [
            (("ec", 0), packed.k_coor, 0), (("h", skip), width, packed.k_coor)]
    last = jobs[-1]
    assert last[:4] == (("grf", 0), ("xrf", 0), width // 2, tk.TRUNK_W + packed.k_dir)
    if (depth, width, freqs) == (8, 256, (10, 4)):
        assert len(jobs) == 11 and len(tiles) == 22
        # rgb_0's last box holds enc(dirs)'s 32 columns and 32 of zero fill
        assert tiles[-1] == (10, 0, 256, 1)


@pytest.mark.parametrize("depth,width,freqs,skip", NERF_SHAPES)
def test_k3_emulated_on_its_plans_matches_the_twin(depth, width, freqs, skip):
    """K3's dataflow on its plans (WT products, jobs, tiles, heads) gives the
    twin's gradients: the offsets, segments and transposes are the packing's."""
    _, packed = _nerf(depth, width, freqs, skip)
    rng = np.random.default_rng(3)
    p = 96
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.uniform(-1, 1, (3, p)), rng.normal(size=(3, p)), rng.normal(size=(3, p)),
        rng.normal(size=(1, p)))]
    dw, db = _emulate_k3(packed, *args)
    tw, tb = tg.fused_nerf_bwd_plain(packed, *args)
    torch.testing.assert_close(dw, tw, rtol=1e-5, atol=1e-5 * float(tw.abs().max()))
    torch.testing.assert_close(db, tb, rtol=1e-5, atol=1e-5 * float(tb.abs().max()))
