// K3: backward of the fused NeRF trunk for Hopper (sm_90a) — the packed
// weight and bias gradients from the rgb/sigma cotangents.
//
// Replaces the TPU kernel of tgtc/ops/pallas/nerf_mlp_grad.py:
//   K3  tgtc_nerf_mlp_bwd  <- _fused_nerf_bwd (body _make_bwd_kernel)
// The plain PyTorch twin of the same arithmetic, fused_nerf_bwd_plain, lives
// beside the wrapper in tgtc_torch/ops/kernels/nerf_mlp_grad.py.
//
// What bounds it: operations for the function (the recompute, the
// input-gradient and the weight-gradient products: about three K1
// forwards), but the sum over points has to leave the SM. The TPU kernel
// keeps dW in VMEM across a grid that runs in order; here blocks run in
// parallel and the f32 gradient (2.4 MB) does not fit on an SM, so every
// layer's input and output gradient goes through a point-major workspace
// (tgtc_nerf_mlp_bwd_point_bytes: 9,932 bytes a point at depth 8), written
// once and read about 1.5 times. Four launches and a memset on one stream:
//
// 1. transpose_kernel: the input-gradient products contract over a layer's
//    output rows, so each layer's propagating columns are copied transposed
//    (WT, [(depth + 1) * 256, 256] bf16, 1.2 MB at depth 8): rgb_0's
//    base_remap columns, base_remap, then trunk layers depth-1 .. 1 (their h
//    columns, KC.. at the skip layer). The backward then streams K-major
//    boxes through the ring exactly as the forward does.
// 2. nerf_bwd_tile_kernel, on the dense-layer engine (trunk_sm90.cuh):
//    persistent blocks over 128-point tiles, two consumer warpgroups of 64
//    rows on wgmma, one producer thread streaming every weight chunk by TMA
//    through K1's four-slot ring and shared memory. Per tile, the forward is
//    K1's own code (sm90::trunk_tile, sm90::rgb_tail), so the ReLU masks,
//    sigma and rgb are K1's bit for bit; hooks keep each layer's output: its
//    ReLU mask (128 bits a thread, 4 words) goes to a per-block scratch that
//    stays in L2, and the activation to the workspace. Then each consumer
//    runs the backward for its rows: gs and g_rf on CUDA cores, then g_br,
//    g at h[depth-1] (the sigma head's rank-1 term in the epilogue) and
//    trunk layers depth-1 .. 1 on the tensor cores, each masked, bf16 g the
//    next product's A fragments in registers and a workspace output. The
//    workspace is written straight from the registers (a quad transpose
//    makes each store 16 bytes of a row) with streaming stores, which keep
//    the 2.6 GB of a fine pass from evicting the weights from L2.
// 3. nerf_bwd_wgrad_kernel: dW_l = G_l^T A_l as a split-K product over
//    chunks of 8,192 points. A block owns a 128 x (up to) 256 tile of one
//    (layer, input segment) and streams G and A in boxes of 64 points by TMA
//    (zero fill past P) through a four-slot ring; wgmma m64n64k16 reads both
//    operands MN-major through the transpose bits. The bias sums come from
//    the G boxes on CUDA cores. The sigma and rgb_1 heads (N = 1, 3) run on
//    CUDA cores in one more block per chunk. Each block writes its chunk's
//    slice of a partial buffer.
// 4. nerf_bwd_reduce_kernel: sums the chunks' partials in chunk order.
//
// No atomics: every sum runs in a fixed order, so the result is bitwise
// repeatable.
//
// Rounding points follow _make_bwd_kernel: gs, g_rf, g_br and every trunk
// layer's masked g are bf16 and feed both the weight-gradient product and
// the next input-gradient product; the mask is taken on the bf16
// activation; bias gradients are f32 sums of the bf16 values, except the
// sigma bias, which sums the f32 g_sigma; the sigma head has no ReLU.

#include "trunk_sm90.cuh"

namespace {

using namespace tgtc;
using namespace hopper;

constexpr int STAGES = 4;

// The tile kernel's shared memory, K1's: h holds h for the sigma head, rf
// for the rgb head and gs (block 2).
struct TileSmem {
  uint8_t ring[STAGES][sm90::CHUNK_BYTES];
  uint8_t h[4][sm90::BLK_BYTES];
  uint8_t ec[sm90::BLK_BYTES];
  uint8_t ed[sm90::BLK_BYTES];
  uint64_t full[STAGES], empty[STAGES];
};
constexpr int TILE_SMEM = (int)sizeof(TileSmem) + 1024;  // + the 1 KB alignment slack
static_assert(TILE_SMEM <= 232448, "K3's shared memory exceeds a block's 227 KB");

// The workspace arrays, as the weight-gradient kernel reads them: 3-D tensor
// maps (columns, P, layers) with boxes of 64 columns x 64 points, 128-byte
// swizzle.
enum { M_EC, M_H, M_XRF, M_RF, M_G, M_GRF, N_ACT_MAPS };

struct TileMaps {
  sm90::Maps fwd;  // K1's layers (sm90::rgb_plan)
  CUtensorMap wt;  // transposed weights, boxes of 64 columns x 256 rows
};

// Bits of a ReLU layer's bf16 output in A fragments: bit 2 (k % 16) + half of
// word k / 16 is 1 where the half of act[k] is > 0 (a ReLU output is never
// negative or NaN, so any magnitude bit will do).
__device__ __forceinline__ uint4 relu_mask(const uint32_t (&act)[64]) {
  uint32_t m[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    const uint32_t lo = (act[k] & 0x7fffu) != 0u, hi = (act[k] & 0x7fff0000u) != 0u;
    m[k / 16] |= (lo | (hi << 1)) << (2 * (k % 16));
  }
  return make_uint4(m[0], m[1], m[2], m[3]);
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// act = bf16(mask ? acc (+ wx[n] lm) : 0) as the next product's A
// fragments, the accumulator's (row, column) pairs being those of the
// forward epilogue whose mask `mask` holds; lm0 and lm1 are the rank-1
// scalars of the thread's rows (the sigma head's bf16(g_sigma)).
template <bool RANK1>
__device__ __forceinline__ void bwd_epilogue(const float (&acc)[128], uint32_t (&act)[64],
                                             uint4 mask, const bf16* __restrict__ wx, float lm0,
                                             float lm1, int t) {
  const uint32_t mw[4] = {mask.x, mask.y, mask.z, mask.w};
  const bf16* wt = RANK1 ? wx + 2 * t : nullptr;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
    if constexpr (RANK1) {
      const uint32_t x = __ldg(reinterpret_cast<const unsigned int*>(wt + 8 * j));
      v[0] = fmaf(lo_bf16(x), lm0, v[0]);
      v[1] = fmaf(hi_bf16(x), lm0, v[1]);
      v[2] = fmaf(lo_bf16(x), lm1, v[2]);
      v[3] = fmaf(hi_bf16(x), lm1, v[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = sm90::act_at(j) + (e >> 1);
      if (!((mw[k / 16] >> (2 * (k % 16) + (e & 1))) & 1u)) v[e] = 0.0f;
    }
    act[sm90::act_at(j)] = pack_bf16(v[0], v[1]);
    act[sm90::act_at(j) + 1] = pack_bf16(v[2], v[3]);
  }
}

// x[e] of quad lane s becomes x[s] of quad lane e (t = this lane's index in
// its quad): two exchanges across the lane bits.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int t) {
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const uint32_t w = __shfl_xor_sync(0xffffffffu, (t & 1) ? x[e] : x[e + 1], 1);
    if (t & 1)
      x[e] = w;
    else
      x[e + 1] = w;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint32_t w = __shfl_xor_sync(0xffffffffu, (t & 2) ? x[e] : x[e + 2], 2);
    if (t & 2)
      x[e] = w;
    else
      x[e + 2] = w;
  }
}

// act's first N columns (this consumer's 64 rows, A fragments) to rows p0..
// of a [P, cols] array, straight from the registers, rows past P left out.
// A quad holds 16 bytes of each column block of 8 in its rows g and g + 8;
// transposed across the quad, each lane stores one block whole, so a warp
// writes 64 contiguous bytes of each of 8 rows a store.
template <int N>
__device__ __forceinline__ void store_rows(const uint32_t (&act)[64], bf16* dst, int cols,
                                           long long P, long long p0, int tid) {
  const int t = tid & 3;
  const long long ra = p0 + (tid / 32) * 16 + ((tid % 32) >> 2);
  uint4* rows[2] = {reinterpret_cast<uint4*>(dst + ra * cols + 8 * t),
                    reinterpret_cast<uint4*>(dst + (ra + 8) * cols + 8 * t)};
#pragma unroll
  for (int k = 0; k < N / 32; ++k)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      uint32_t x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = act[sm90::act_at(4 * k + e) + hr];
      quad_transpose(x, t);
      if (ra + 8 * hr < P) __stcs(&rows[hr][4 * k], make_uint4(x[0], x[1], x[2], x[3]));
    }
}

// The first `ncols` columns of this consumer's rows of a swizzled block to
// columns col0.. of rows p0.. of a [P, cols] array, 16 bytes a thread.
__device__ __forceinline__ void store_block(const uint8_t* blk, int ncols, bf16* dst, int cols,
                                            int col0, long long P, long long p0, int tid) {
  for (int idx = tid; idx < sm90::WG_ROWS * ncols / 8; idx += 128) {
    const int r = idx / (ncols / 8), cb = idx % (ncols / 8);
    if (p0 + r < P)
      *reinterpret_cast<uint4*>(dst + (p0 + r) * cols + col0 + 8 * cb) = sm90::row8(blk, r, cb);
  }
}

// The producer: per tile, K1's chunks (the forward), then the backward's
// depth + 1 products in the consumers' order: rgb_0^T (its 128 output rows
// contracted), base_remap^T, trunk depth-1 .. 1 (WT's matrices 0..depth).
__device__ __forceinline__ void produce(const TileMaps& maps, const sm90::Plan& plan, int depth,
                                        int tiles, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty) {
  uint32_t q = 0;
  auto load = [&](const CUtensorMap* map, int rows, int c0, int c1) {
    const uint32_t s = q % STAGES;
    if (q >= STAGES) mbar_wait(&empty[s], (q / STAGES - 1) & 1);
    mbar_expect(&full[s], rows * sm90::CK * 2);
    tma_load_2d(ring + s * sm90::CHUNK_BYTES, map, &full[s], c0, c1);
    ++q;
  };
  for (int t = 0; t < tiles; ++t) {
    for (int l = 0; l < depth + 2; ++l)
      for (int c = 0; c < sm90::chunks(plan.k[l]); ++c)
        load(&maps.fwd.m[l], plan.n[l], c * sm90::CK, 0);
    for (int m = 0; m <= depth; ++m)
      for (int c = 0; c < sm90::chunks(m == 0 ? HW : W); ++c)
        load(&maps.wt, W, c * sm90::CK, m * W);
  }
}

// The workspace's point-major arrays [P, cols] bf16 (h: depth and g:
// depth + 1 of them, P rows apart).
struct Acts {
  bf16* ec;   // enc(pts) [P, 64]
  bf16* h;    // trunk outputs [depth][P, 256]
  bf16* xrf;  // [base_remap | enc(dirs)] [P, 288]
  bf16* rf;   // [P, 128]
  bf16* g;    // masked gradients at the trunk outputs, then at base_remap [depth + 1][P, 256]
  bf16* grf;  // at rf [P, 128]
};

// What a consumer keeps of its tile's forward, as trunk_tile's and
// rgb_tail's hooks: each ReLU layer's mask (this thread's words, layer l at
// mask[128 l]; rf's stays in registers) and every layer input the weight
// gradients read.
struct Keep {
  uint32_t (&act)[64];
  const Acts& a;
  uint4* mask;
  const uint8_t *ec, *ed;  // this consumer's rows of enc(pts), enc(dirs)
  long long P, p0;
  int depth, tid;

  // after trunk layer i: h[i], and enc(pts) with h[0]
  __device__ __forceinline__ void operator()(int i) const {
    mask[128 * i] = relu_mask(act);
    if (i == 0) store_block(ec, KC, a.ec, KC, 0, P, p0, tid);
    store_rows<W>(act, a.h + i * P * W, W, P, p0, tid);
  }
};

// rgb_tail's hook: base_remap with enc(dirs) as [base_remap | enc(dirs)],
// then rf.
struct KeepTail {
  const Keep& k;
  __device__ __forceinline__ void operator()(int i) const {
    if (i == k.depth) {
      k.mask[128 * k.depth] = relu_mask(k.act);
      store_rows<W>(k.act, k.a.xrf, W + KD, k.P, k.p0, k.tid);
      store_block(k.ed, KD, k.a.xrf, W + KD, W, k.P, k.p0, k.tid);
    } else {
      store_rows<HW>(k.act, k.a.rf, HW, k.P, k.p0, k.tid);
    }
  }
};

// rgb_tail's output: rgb (if wanted) and gs = bf16(g_rgb rgb (1 - rgb)) into
// gs [64][4] f32 (block 2 of h, free once the heads have read it).
struct Gs {
  float* rgb_out;
  const float* g_rgb;
  float* gs;
  long long P, p0;
  __device__ __forceinline__ void operator()(int r, int c, float y) const {
    const long long p = p0 + r;
    if (rgb_out) rgb_out[c * P + p] = y;
    gs[4 * r + c] = __bfloat162float(__float2bfloat16(g_rgb[c * P + p] * y * (1.0f - y)));
  }
};

// K3's tile kernel (see the header). DEPTH > 0 fixes depth and skip at
// compile time, as K1's. rgb_out [3, P] may be null; sigma [P] is written.
// P < 2^31 (TMA's coordinates are 32-bit).
template <int DEPTH, int SKIP>
__global__ void __launch_bounds__(sm90::THREADS, 1)
nerf_bwd_tile_kernel(const __grid_constant__ TileMaps maps, const sm90::Plan plan,
                     const float* __restrict__ pts_t, const float* __restrict__ dirs_t,
                     const float* __restrict__ g_rgb, const float* __restrict__ g_sigma,
                     long long P, const bf16* __restrict__ w, const float* __restrict__ b,
                     Layout L, int depth_rt, int skip_rt, const Acts a,
                     float* __restrict__ rgb_out, float* __restrict__ sigma,
                     uint4* __restrict__ masks, bf16* __restrict__ gs_out) {
  const int depth = DEPTH > 0 ? DEPTH : depth_rt;
  extern __shared__ uint8_t smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(align_1k(smem_raw));
  const long long ntiles = (P + sm90::ROWS - 1) / sm90::ROWS;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  sm90::init_ring<STAGES>(sm.full, sm.empty);

  if (wg == sm90::CONSUMERS) {  // producer
    setmaxnreg_dec<sm90::PRODUCER_REGS>();
    if (tid == 0)
      produce(maps, plan, depth, (int)((ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x),
              sm.ring[0], sm.full, sm.empty);
    return;
  }
  setmaxnreg_inc<sm90::CONSUMER_REGS>();
  const int bar = 1 + wg;
  const int rows = wg * sm90::WG_BLK_BYTES;  // this consumer's rows of each block
  uint8_t* h = sm.h[0] + rows;
  uint8_t* ec = sm.ec + rows;
  uint8_t* ed = sm.ed + rows;
  float* gs = reinterpret_cast<float*>(h + 2 * sm90::BLK_BYTES);
  const uint32_t ring = smem_u32(sm.ring[0]);
  // this thread's mask words: layer l (trunk 0..depth-1, base_remap at depth) at mask[128 l]
  uint4* mask = masks + ((long long)blockIdx.x * sm90::CONSUMERS + wg) * (depth + 1) * 128 + tid;
  float acc[128];
  uint32_t act[64];
  uint32_t q = 0;
  using sm90::REGS;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * sm90::ROWS + wg * sm90::WG_ROWS;
    const Keep keep = {act, a, mask, ec, ed, P, p0, depth, tid};

    // ---- forward: K1's code, keeping every layer's mask and output
    sm90::trunk_tile<DEPTH, SKIP, STAGES, false>(
        acc, act, depth_rt, skip_rt, pts_t, P, p0, ec, h, w, b, L, sigma, ring, sm.full,
        sm.empty, q, tid, bar, [=] { sm90::encode<FD, KD>(dirs_t, P, p0, ed, tid); }, keep);
    sm90::rgb_tail<STAGES>(acc, act, depth, P, p0, h, smem_u32(ed), w, b, L, ring, sm.full,
                           sm.empty, q, tid, bar, tid / 32, (tid % 32) >> 2, tid & 3,
                           smem_u32(h), Gs{rgb_out, g_rgb, gs, P, p0}, KeepTail{keep});
    bar_sync(bar, 128);  // gs

    // ---- backward. gs (rows past P: 0) and g_rf on CUDA cores
    const int r0 = (tid / 32) * 16 + ((tid % 32) >> 2), t = tid & 3;
    float s0[3], s1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s0[c] = p0 + r0 < P ? gs[4 * r0 + c] : 0.0f;
      s1[c] = p0 + r0 + 8 < P ? gs[4 * (r0 + 8) + c] : 0.0f;
    }
    if (tid < sm90::WG_ROWS && p0 + tid < P) {
      uint2 v;
      v.x = pack_bf16(gs[4 * tid], gs[4 * tid + 1]);
      v.y = pack_bf16(gs[4 * tid + 2], 0.0f);
      *reinterpret_cast<uint2*>(gs_out + 4 * (p0 + tid)) = v;
    }
    const bf16* wr1 = w + L.w[depth + 3] + 2 * t;
#pragma unroll
    for (int j = 0; j < HW / 8; ++j) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint32_t x = __ldg(reinterpret_cast<const unsigned int*>(wr1 + c * HW + 8 * j));
        v[0] = fmaf(lo_bf16(x), s0[c], v[0]);
        v[1] = fmaf(hi_bf16(x), s0[c], v[1]);
        v[2] = fmaf(lo_bf16(x), s1[c], v[2]);
        v[3] = fmaf(hi_bf16(x), s1[c], v[3]);
      }
      const uint32_t a0 = act[sm90::act_at(j)], a1 = act[sm90::act_at(j) + 1];  // rf
      act[sm90::act_at(j)] =
          pack_bf16((a0 & 0x7fffu) ? v[0] : 0.0f, (a0 & 0x7fff0000u) ? v[1] : 0.0f);
      act[sm90::act_at(j) + 1] =
          pack_bf16((a1 & 0x7fffu) ? v[2] : 0.0f, (a1 & 0x7fff0000u) ? v[3] : 0.0f);
    }
    store_rows<HW>(act, a.grf, HW, P, p0, tid);

    // g_br = mask(br) (g_rf . W_rgb0[:, :256])
    sm90::mma_layer<W, STAGES, REGS, HW>(acc, act, 0, 0, 0, ring, sm.full, sm.empty, q);
    bwd_epilogue<false>(acc, act, mask[128 * depth], nullptr, 0.0f, 0.0f, t);
    store_rows<W>(act, a.g + depth * P * W, W, P, p0, tid);

    // g at h[depth-1] = mask (g_br . W_br + bf16(g_sigma) w_sigma)
    const float lm0 = p0 + r0 < P ? __bfloat162float(__float2bfloat16(g_sigma[p0 + r0])) : 0.0f;
    const float lm1 =
        p0 + r0 + 8 < P ? __bfloat162float(__float2bfloat16(g_sigma[p0 + r0 + 8])) : 0.0f;
    sm90::mma_layer<W, STAGES, REGS, W>(acc, act, 0, 0, 0, ring, sm.full, sm.empty, q);
    bwd_epilogue<true>(acc, act, mask[128 * (depth - 1)], w + L.w[depth + 1], lm0, lm1, t);
    store_rows<W>(act, a.g + (depth - 1) * P * W, W, P, p0, tid);

    // trunk layers depth-1 .. 1: g at h[i-1] = mask (g_i . W_i[:, h columns])
#pragma unroll 1
    for (int i = depth - 1; i >= 1; --i) {
      sm90::mma_layer<W, STAGES, REGS, W>(acc, act, 0, 0, 0, ring, sm.full, sm.empty, q);
      bwd_epilogue<false>(acc, act, mask[128 * (i - 1)], nullptr, 0.0f, 0.0f, t);
      store_rows<W>(act, a.g + (i - 1) * P * W, W, P, p0, tid);
    }
  }
}

// WT[m] = the propagating columns of a layer, transposed: m = 0 rgb_0's
// base_remap columns (its 128 output rows, zero past them), 1 base_remap,
// 2..depth trunk layers depth-1 .. 1 (their h columns).
__global__ void transpose_kernel(const bf16* __restrict__ w, Layout L, int depth, int skip,
                                 bf16* __restrict__ wt) {
  __shared__ bf16 tile[32][34];
  const int m = blockIdx.z, r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  int mat, ldw = W, coff = 0, nout = W;
  if (m == 0) {
    mat = depth + 2;
    ldw = W + KD;
    nout = HW;
  } else if (m == 1) {
    mat = depth;
  } else {
    mat = depth + 1 - m;
    if (mat == skip + 1) {
      ldw = KC + W;
      coff = KC;
    }
  }
  const bf16* src = w + L.w[mat];
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i;  // a source row: an output of the layer
    tile[i][threadIdx.x] =
        c < nout ? src[(long long)c * ldw + coff + r0 + threadIdx.x] : __float2bfloat16(0.0f);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8)
    wt[((long long)m * W + r0 + i) * W + c0 + threadIdx.x] = tile[threadIdx.x][i];
}

// ---- weight gradients: split-K products over points on wgmma

constexpr int WG_STAGES = 4;
constexpr int WPTS = 64;                    // points a stage
constexpr int WBOX = WPTS * sm90::CK * 2;   // one 64-point x 64-column box, 8 KB
constexpr int WSLOT = 6 * WBOX;             // two G boxes and up to four A boxes
constexpr int CHUNK = 8192;                 // points a block
constexpr int MAX_JOBS = MAX_LAYERS + 4;
constexpr int MAX_TILES = 4 * MAX_JOBS;

struct WgradSmem {
  uint8_t ring[WG_STAGES][WSLOT];
  float bsum[sm90::CONSUMERS][2][64];
  uint64_t full[WG_STAGES], empty[WG_STAGES];
};
constexpr int WGRAD_SMEM = (int)sizeof(WgradSmem) + 1024;
static_assert(WGRAD_SMEM <= 232448, "the weight-gradient kernel's shared memory exceeds 227 KB");
static_assert((sm90::THREADS / 32) * ((W + 1) + 2 * (3 * HW + 3)) * 4 <= WGRAD_SMEM - 1024,
              "the heads' partials exceed the weight-gradient kernel's shared memory");

// dW[n, k] (+)= sum_p G[p, n] A[p, k] for one (layer, input segment): G
// and A are layers of workspace maps; dW[0, 0] at w_off, rows ldw apart.
struct Job {
  int gmap, glayer, amap, alayer, k, ldw;
  long long w_off, b_off;  // b_off: the bias, or -1 (a layer's later segments)
};
// A block's tile: rows n0 .. n0 + 127 of a job's dW, columns k0 .. k0 + 64 kb.
struct WTile {
  int job, n0, k0, kb;
};
struct Jobs {
  Job j[MAX_JOBS];
  WTile t[MAX_TILES];
  int ntiles;
};
struct ActMaps {
  CUtensorMap m[N_ACT_MAPS];
};
// The heads on CUDA cores: sigma (dW = bf16(g_sigma)^T h[depth-1], bias the
// sum of the f32 g_sigma) and rgb_1 (gs^T rf, the sum of gs).
struct Heads {
  const float* g_sigma;
  const bf16* h_last;  // [P, 256]
  const bf16* rf;      // [P, 128]
  const bf16* gs;      // [P, 4]
  long long w_sig, b_sig, w_rgb1, b_rgb1;
};

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// The heads over points pa..pb: each warp sums a range of points (lane l
// holds sigma's columns 8 l .. 8 l + 7; for rgb_1 the half-warps take
// alternate points, lane l % 16 holding columns 8 (l % 16) .. + 7 of all
// three channels), then the warps' partials are summed in warp order.
__device__ void heads(const Heads& hd, long long pa, long long pb, float* out, long long nw,
                      float* red) {
  constexpr int NWARP = sm90::THREADS / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, half = lane / 16, l16 = lane % 16;
  const long long per = (pb - pa + NWARP - 1) / NWARP;
  const long long q0 = pa + warp * per, q1 = pb < q0 + per ? pb : q0 + per;
  float as[8] = {}, ar[3][8] = {}, sb = 0.0f, rb[3] = {};
#pragma unroll 4
  for (long long p = q0; p < q1; ++p) {
    const float gs = hd.g_sigma[p], gb = __bfloat162float(__float2bfloat16(gs));
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(hd.h_last + p * W) + lane);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      as[2 * e] = fmaf(gb, lo_bf16(xs[e]), as[2 * e]);
      as[2 * e + 1] = fmaf(gb, hi_bf16(xs[e]), as[2 * e + 1]);
    }
    sb += gs;
  }
#pragma unroll 4
  for (long long p = q0 + half; p < q1; p += 2) {
    const uint2 gv = __ldg(reinterpret_cast<const uint2*>(hd.gs + 4 * p));
    const float gc[3] = {lo_bf16(gv.x), hi_bf16(gv.x), lo_bf16(gv.y)};
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(hd.rf + p * HW) + l16);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ar[c][2 * e] = fmaf(gc[c], lo_bf16(xs[e]), ar[c][2 * e]);
        ar[c][2 * e + 1] = fmaf(gc[c], hi_bf16(xs[e]), ar[c][2 * e + 1]);
      }
      rb[c] += gc[c];
    }
  }
  // red: sigma [NWARP][W + 1], then rgb_1 [2 NWARP][3 HW + 3]
  float* rs = red + warp * (W + 1);
  float* rr = red + NWARP * (W + 1) + (2 * warp + half) * (3 * HW + 3);
#pragma unroll
  for (int e = 0; e < 8; ++e) rs[8 * lane + e] = as[e];
  if (lane == 0) rs[W] = sb;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int e = 0; e < 8; ++e) rr[c * HW + 8 * l16 + e] = ar[c][e];
    if (l16 == 0) rr[3 * HW + c] = rb[c];
  }
  __syncthreads();
  const int tid = threadIdx.x;
  for (int i = tid; i <= W; i += sm90::THREADS) {
    float s = 0.0f;
    for (int k = 0; k < NWARP; ++k) s += red[k * (W + 1) + i];
    if (i < W)
      out[hd.w_sig + i] = s;
    else
      out[nw + hd.b_sig] = s;
  }
  const float* rr0 = red + NWARP * (W + 1);
  for (int i = tid; i < 3 * HW + 3; i += sm90::THREADS) {
    float s = 0.0f;
    for (int k = 0; k < 2 * NWARP; ++k) s += rr0[k * (3 * HW + 3) + i];
    if (i < 3 * HW)
      out[hd.w_rgb1 + i] = s;
    else
      out[nw + hd.b_rgb1 + i - 3 * HW] = s;
  }
}

// Block (x, y): tile x of `jobs` (or the heads, x = ntiles) over the points
// of chunk y, into partial slice y.
__global__ void __launch_bounds__(sm90::THREADS, 1)
nerf_bwd_wgrad_kernel(const __grid_constant__ ActMaps maps, const __grid_constant__ Jobs jobs,
                      Heads hd, long long P, float* __restrict__ part, long long nwb,
                      long long nw) {
  const long long pa = (long long)blockIdx.y * CHUNK;
  const long long pb = P < pa + CHUNK ? P : pa + CHUNK;
  float* out = part + (long long)blockIdx.y * nwb;
  extern __shared__ uint8_t smem_raw[];
  if ((int)blockIdx.x >= jobs.ntiles) {
    heads(hd, pa, pb, out, nw, reinterpret_cast<float*>(align_1k(smem_raw)));
    return;
  }
  WgradSmem& sm = *reinterpret_cast<WgradSmem*>(align_1k(smem_raw));
  const WTile tl = jobs.t[blockIdx.x];
  const Job& jb = jobs.j[tl.job];
  const int stages = (int)((pb - pa + WPTS - 1) / WPTS);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  sm90::init_ring<WG_STAGES>(sm.full, sm.empty);

  if (wg == sm90::CONSUMERS) {  // producer
    setmaxnreg_dec<sm90::PRODUCER_REGS>();
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) {
        const int slot = s % WG_STAGES;
        if (s >= WG_STAGES) mbar_wait(&sm.empty[slot], (s / WG_STAGES - 1) & 1);
        mbar_expect(&sm.full[slot], (2 + tl.kb) * WBOX);
        const int p = (int)(pa + s * WPTS);
        for (int c = 0; c < sm90::CONSUMERS; ++c)
          tma_load_3d(sm.ring[slot] + c * WBOX, &maps.m[jb.gmap], &sm.full[slot],
                      tl.n0 + sm90::CK * c, p, jb.glayer);
        for (int bx = 0; bx < tl.kb; ++bx)
          tma_load_3d(sm.ring[slot] + (2 + bx) * WBOX, &maps.m[jb.amap], &sm.full[slot],
                      tl.k0 + sm90::CK * bx, p, jb.alayer);
      }
    }
    return;
  }
  setmaxnreg_inc<sm90::CONSUMER_REGS>();
  const bool bias = tl.k0 == 0 && jb.b_off >= 0;
  const int bn = tid % 64, bh = tid / 64;  // the bias sum's column and half of a stage's points
  float acc[4][32];
  float bs = 0.0f;
  for (int s = 0; s < stages; ++s) {
    const int slot = s % WG_STAGES;
    mbar_wait(&sm.full[slot], (s / WG_STAGES) & 1);
    __syncwarp();
    const uint32_t base = smem_u32(sm.ring[slot]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WPTS / 16; ++kk) {
      const uint64_t da = sw128_desc_at(base + wg * WBOX + kk * 2048, 1024 >> 4);
#pragma unroll
      for (int bx = 0; bx < 4; ++bx)
        if (bx < tl.kb)
          wgmma_ss_tt(acc[bx], da, sw128_desc_at(base + (2 + bx) * WBOX + kk * 2048, 1024 >> 4),
                      s > 0 || kk > 0);
    }
    wg_commit();
    if (bias) {
      const uint8_t* gb = sm.ring[slot] + wg * WBOX;
#pragma unroll 8
      for (int r = 32 * bh; r < 32 * bh + 32; ++r)
        bs += bf(*reinterpret_cast<const bf16*>(gb + r * 128 + (((bn >> 3) ^ (r & 7)) << 4) +
                                                 (bn & 7) * 2));
    }
    wg_wait<0>();
#pragma unroll
    for (int bx = 0; bx < 4; ++bx) reg_fence(acc[bx]);
    release(&sm.empty[slot]);
  }

  const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
#pragma unroll
  for (int bx = 0; bx < 4; ++bx) {
    if (bx >= tl.kb) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long n = tl.n0 + sm90::WG_ROWS * wg + 16 * warp + g + 8 * hr;
        const int k = tl.k0 + sm90::CK * bx + 8 * j + 2 * t;
        if (k >= jb.k) continue;
        float* o = out + jb.w_off + n * jb.ldw + k;
        o[0] = acc[bx][4 * j + 2 * hr];
        o[1] = acc[bx][4 * j + 2 * hr + 1];
      }
  }
  if (bias) {
    sm.bsum[wg][bh][bn] = bs;
    bar_sync(1 + wg, 128);
    if (tid < 64)
      out[nw + jb.b_off + tl.n0 + sm90::WG_ROWS * wg + tid] =
          sm.bsum[wg][0][tid] + sm.bsum[wg][1][tid];
  }
}

__global__ void nerf_bwd_reduce_kernel(const float* __restrict__ part, int chunks,
                                       long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += part[(long long)c * n + i];
  out[i] = s;
}

// ------------------------------------------------------------ host side

long long align256(long long x) { return (x + 255) / 256 * 256; }

// bf16 values a point: ec, h[0..depth-1], [base_remap | enc(dirs)], rf;
// g[0..depth-1], g_br, g_rf; gs (4)
long long point_cols(int depth) {
  return KC + (long long)W * depth + W + KD + HW + (long long)W * (depth + 1) + HW + 4;
}

// Byte offsets of the workspace's regions.
struct WsLayout {
  long long wt, act[N_ACT_MAPS], gs, sigma, masks, part, total;
};

WsLayout ws_layout(long long P, int depth, long long nwb, int grid) {
  WsLayout ws = {};
  long long at = 0;
  auto take = [&](long long bytes) {
    const long long here = at;
    at = align256(at + bytes);
    return here;
  };
  ws.wt = take((long long)(depth + 1) * W * W * 2);
  ws.act[M_EC] = take(P * KC * 2);
  ws.act[M_H] = take((long long)depth * P * W * 2);
  ws.act[M_XRF] = take(P * (W + KD) * 2);
  ws.act[M_RF] = take(P * HW * 2);
  ws.act[M_G] = take((long long)(depth + 1) * P * W * 2);
  ws.act[M_GRF] = take(P * HW * 2);
  ws.gs = take(P * 4 * 2);
  ws.sigma = take(P * 4);
  ws.masks = take((long long)grid * sm90::CONSUMERS * (depth + 1) * 128 * 16);
  ws.part = take((P + CHUNK - 1) / CHUNK * nwb * 4);
  ws.total = at;
  return ws;
}

int tile_grid(long long P) { return sm90::persistent_grid((P + sm90::ROWS - 1) / sm90::ROWS); }

// A workspace array [layers, rows, cols] bf16: boxes of 64 columns x 64 rows.
bool act_map(CUtensorMap* map, void* base, int cols, long long rows, int layers) {
  static const EncodeTiled encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)(rows * cols * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)sm90::CK, (cuuint32_t)sm90::WG_ROWS, 1},
                   ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// WT [(depth + 1) * 256, 256] bf16: boxes of 64 columns x 256 rows.
bool wt_map(CUtensorMap* map, void* base, int depth) {
  static const EncodeTiled encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)(depth + 1) * W};
  const cuuint64_t strides[1] = {(cuuint64_t)W * 2};
  const cuuint32_t box[2] = {(cuuint32_t)sm90::CK, (cuuint32_t)W}, ones[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Workspace bytes a point at `depth` (the saved activations and gradients;
// tgtc_nerf_mlp_bwd_workspace adds the transposed weights, the masks and
// the per-chunk partials).
extern "C" long long tgtc_nerf_mlp_bwd_point_bytes(int depth) {
  return point_cols(depth) * 2 + 4;  // + the f32 sigma of the recompute
}

// Workspace bytes for tgtc_nerf_mlp_bwd.
extern "C" long long tgtc_nerf_mlp_bwd_workspace(long long P, int depth, long long nwb) {
  return ws_layout(P, depth, nwb, tile_grid(P)).total;
}

// out: [nw + nb] f32, the weight gradient in the packed weight layout, then
// the bias gradient. offsets as tgtc_nerf_mlp_fwd. forward_out, if not null,
// receives the recompute's rgb [3, P] and sigma [1, P] (K1's, bit for bit).
// Returns the first CUDA error of the launches, or 0.
extern "C" int tgtc_nerf_mlp_bwd(const float* pts_t, const float* dirs_t,
                                 const float* g_rgb, const float* g_sigma,
                                 long long P, const void* w, const float* b,
                                 const long long* offsets, int depth, int skip,
                                 long long nw, long long nb, void* workspace,
                                 float* out, float* forward_out, void* stream) {
  if (depth < 1 || depth + 4 > MAX_LAYERS || P >= (1LL << 31) - 2 * sm90::ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nwb = nw + nb;
  auto tile_kernel =
      depth == 8 && skip == 4 ? nerf_bwd_tile_kernel<8, 4> : nerf_bwd_tile_kernel<0, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nerf_bwd_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WGRAD_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return (int)cudaMemsetAsync(out, 0, nwb * 4, st);
  const Layout L = make_layout(offsets, depth + 4);
  const int grid = tile_grid(P);
  if (grid <= 0) return (int)cudaErrorInvalidDevice;
  const WsLayout ws = ws_layout(P, depth, nwb, grid);
  char* base = (char*)workspace;
  bf16* wt = (bf16*)(base + ws.wt);

  TileMaps maps;
  sm90::Plan plan;
  ActMaps amaps;
  const int cols[N_ACT_MAPS] = {KC, W, W + KD, HW, W, HW};
  const int layers[N_ACT_MAPS] = {1, depth, 1, 1, depth + 1, 1};
  bool ok = sm90::rgb_plan(&maps.fwd, &plan, w, L, depth, skip) && wt_map(&maps.wt, wt, depth);
  for (int m = 0; m < N_ACT_MAPS; ++m)
    ok = ok && act_map(&amaps.m[m], base + ws.act[m], cols[m], P, layers[m]);
  if (!ok) return (int)cudaErrorInvalidValue;
  bf16* act[N_ACT_MAPS];
  for (int m = 0; m < N_ACT_MAPS; ++m) act[m] = (bf16*)(base + ws.act[m]);
  const Acts acts = {act[M_EC], act[M_H], act[M_XRF], act[M_RF], act[M_G], act[M_GRF]};

  // one job per (layer, input segment), tiles of 128 rows x up to 256 columns
  Jobs jobs = {};
  int njobs = 0;
  auto add = [&](int gm, int gl, int am, int al, int n, int k, long long w_off, int ldw,
                 long long b_off) {
    jobs.j[njobs] = {gm, gl, am, al, k, ldw, w_off, b_off};
    for (int n0 = 0; n0 < n; n0 += 2 * sm90::WG_ROWS)
      for (int k0 = 0; k0 < k; k0 += 4 * sm90::CK) {
        const int kb = (k - k0 + sm90::CK - 1) / sm90::CK;
        jobs.t[jobs.ntiles++] = {njobs, n0, k0, kb < 4 ? kb : 4};
      }
    ++njobs;
  };
  add(M_G, 0, M_EC, 0, W, KC, L.w[0], KC, L.b[0]);
  for (int i = 1; i < depth; ++i) {
    if (i == skip + 1) {
      add(M_G, i, M_EC, 0, W, KC, L.w[i], KC + W, L.b[i]);
      add(M_G, i, M_H, i - 1, W, W, L.w[i] + KC, KC + W, -1);
    } else {
      add(M_G, i, M_H, i - 1, W, W, L.w[i], W, L.b[i]);
    }
  }
  add(M_G, depth, M_H, depth - 1, W, W, L.w[depth], W, L.b[depth]);
  add(M_GRF, 0, M_XRF, 0, HW, W + KD, L.w[depth + 2], W + KD, L.b[depth + 2]);
  const Heads hd = {g_sigma,
                    (const bf16*)(base + ws.act[M_H]) + (long long)(depth - 1) * P * W,
                    (const bf16*)(base + ws.act[M_RF]),
                    (const bf16*)(base + ws.gs),
                    L.w[depth + 1], L.b[depth + 1], L.w[depth + 3], L.b[depth + 3]};
  const int chunks = (int)((P + CHUNK - 1) / CHUNK);
  float* part = (float*)(base + ws.part);

  transpose_kernel<<<dim3(W / 32, W / 32, depth + 1), dim3(32, 8), 0, st>>>(
      (const bf16*)w, L, depth, skip, wt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_kernel<<<grid, sm90::THREADS, TILE_SMEM, st>>>(
      maps, plan, pts_t, dirs_t, g_rgb, g_sigma, P, (const bf16*)w, b, L, depth, skip, acts,
      forward_out, forward_out ? forward_out + 3 * P : (float*)(base + ws.sigma),
      (uint4*)(base + ws.masks), (bf16*)(base + ws.gs));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // partials: every gradient value is written by one block per chunk, but
  // the alignment gaps between layers are not
  err = cudaMemsetAsync(part, 0, (size_t)chunks * nwb * 4, st);
  if (err != cudaSuccess) return (int)err;
  nerf_bwd_wgrad_kernel<<<dim3((unsigned)jobs.ntiles + 1, (unsigned)chunks), sm90::THREADS,
                          WGRAD_SMEM, st>>>(amaps, jobs, hd, P, part, nwb, nw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  nerf_bwd_reduce_kernel<<<(unsigned)((nwb + 255) / 256), 256, 0, st>>>(part, chunks, nwb, out);
  return (int)cudaGetLastError();
}
