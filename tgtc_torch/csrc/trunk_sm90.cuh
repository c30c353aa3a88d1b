// Dense-layer engine for Hopper (sm_90a): persistent blocks that run a
// chain of 256- or 128-wide bf16 layers on tiles of 128 points with wgmma,
// the weights streamed by TMA through a ring of mbarrier slots. Every kernel
// on it runs the NeRF trunk through one function, trunk_tile: K1 and K4
// (nerf_mlp.cu, style_kernel.cu) go on from the h it leaves in registers;
// K2 and K5, the sigma-only kernels, are sigma_kernel below, one body
// launched by launch_sigma on either packing (trunk 0..depth-1 and sigma at
// depth + 1 in both); K3, the backward (nerf_mlp_grad.cu), recomputes K1's
// forward with trunk_tile and K1's tail, rgb_tail, then runs the
// input-gradient products on the same ring. So K2's sigma equals K1's, K5's
// equals K4's and K2's on the same trunk, and K3's forward is K1's, bit for
// bit by construction.
//
// What bounds the kernels on it: operations (K1 1,186,816, K2 and K5
// 982,528, K4 2,898,944 FLOP a point against at most 156 bytes of point
// I/O). Between the first design (64-point blocks on WMMA, retired) and the
// tensor cores stood mma.sync fragments loaded by every warp from L2 at
// every k step, and the weights re-read from L2 for every 64-point tile (39
// GB a K1 launch at 16,384 x 128 points, 16 GB a K2 launch at 16,384 x 64).
// The engine's answer:
// * One block of 384 threads per SM walks over tiles of ROWS = 128 points
//   (tile = blockIdx.x, += gridDim.x). Warpgroups 0 and 1 are consumers,
//   each owning 64 rows of the tile through every layer; warpgroup 2 is the
//   producer, whose first thread issues every TMA load. setmaxnreg gives
//   the consumers 232 registers and the producer 40 (128 x 40 + 256 x 232 =
//   384 x 168: the producer's release covers the consumers' growth).
// * Weights: each layer's packed matrix, row-major [N, K] bf16 (K-major B
//   as wgmma wants it), has its own 2-D tensor map with boxes of 64 columns
//   x N rows (32 KB at N = 256) and the 128-byte swizzle. The producer
//   streams every layer's K in chunks of 64 columns through a ring of
//   STAGES slots on full/empty mbarriers, layer after layer and tile after
//   tile, so the next layer's weights arrive while the consumers finish a
//   layer. Both consumers read every chunk, so each weight byte is read from
//   L2 once per 128 points (half the first design's traffic). A chunk that
//   runs past K arrives zero-filled (TMA's out-of-bounds fill) and its
//   steps past K are not issued.
// * Activations pass from layer to layer in registers: a consumer's 64 rows
//   of a 256-wide layer output are 64 registers a thread of bf16 pairs in
//   the wgmma A layout (the accumulator's layout repacked, as K6's P), so the
//   next layer's wgmma m64n256k16 (m64n128k16 at N = 128) takes A from
//   registers and B from the ring. Inputs that do not come from the previous
//   layer (enc(pts), enc(dirs), the latents, K4's base_remap) sit in shared
//   memory in the swizzled K-major A layout: 64-column blocks of ROWS x 128 B
//   (16 KB), element (row, col) at row * 128 + ((col / 8) ^ (row % 8)) * 16 +
//   (col % 8) * 2, each consumer's 64 rows at 8 KB into a block. A layer's
//   input is a list of up to three segments fixed at compile time (the
//   reference's column order, e.g. [enc(pts) | h]), and every k step of 16
//   columns is one wgmma on its segment, so no input is copied to
//   concatenate it. With the activations in registers a layer needs no
//   barrier: a consumer syncs with itself (named barrier 1 + its index) only
//   where shared memory changes hands, once or twice a tile.
// * The two consumers run each chunk in step. Putting consumer 1 a chunk or
//   two behind (turns on named barriers or mbarriers, a one-sided lag, a
//   start offset), so that one's epilogue would run under the other's
//   wgmma, was slower in every form on the four-slot rings: the consumer
//   behind holds each slot a chunk longer, and the producer, which refills a
//   slot once both consumers freed it, falls behind the consumer ahead.
// * The epilogue runs in registers: (rank-1 latent term,) bias, ReLU and a
//   bf16 round, in the order of the reference's layer, straight into the
//   next layer's A fragments. Only the outputs that CUDA-core heads
//   or a later layer read from shared memory are stored there (st.shared:
//   the 1 KB alignment arithmetic hides the space from the compiler).
// * Small heads run on CUDA cores in a fixed order: sigma (256 -> 1) in four
//   64-column partials (two threads a point, one shuffle; 128 -> 1 in two),
//   rgb (128 or 256 -> 3) one thread per point and channel.
// * The trunk's width is a template argument (TW, W = 256 by default): the
//   sigma-only kernel also runs a 128-wide trunk too deep for K2-W128's
//   resident weights (depth 8 and beyond; the distilled proposal's D2 runs
//   on K2-W128, proposal_sm90.cuh), whose layers are wgmma m64n128k16 with
//   half the A fragments, the ring's slots then half filled (boxes of 128
//   rows).
// * The sigma-only kernel streams the trunk's depth layers and nothing else
//   (at D8: K = 64, 256 x 4, 320, 256 x 2, so 30 chunks, 983,040 B, a tile,
//   half the first design's weight traffic). Its shared memory: the ring,
//   SIGMA_KERNEL_STAGES x 32 KB, h 4 x 16 KB for the sigma head, enc(pts) 16 KB
//   and the barriers (SIGMA_KERNEL_SMEM with the 1 KB alignment slack).
//
// Packed weights (pack_nerf_params, pack_style_params): one bf16 buffer of
// row-major [out, in_padded] matrices and one f32 bias buffer (bf16-rounded
// values), at the element offsets of Layout. Inputs are padded to 64 (pts
// encoding, 63 used) and 32 (dirs encoding, 27 used) columns; the skip
// layer's columns are [enc(pts) | h], rgb_0's [base_remap | enc(dirs)].
// Every matrix starts 32-byte aligned and K is a multiple of 16, so each row
// is a multiple of 16 bytes, as TMA requires. The encodings use accurate
// sinf/cosf in f32 (arguments reach 2^9 |x|): build without fast math.

#pragma once

#include "hopper.cuh"

namespace tgtc {

typedef __nv_bfloat16 bf16;

constexpr int W = 256;   // trunk width by default (base_remap's width always)
constexpr int HW = 128;  // rgb hidden width
constexpr int FC = 10, FD = 4;
constexpr int KC = 64;  // 3 + 6*FC = 63, padded
constexpr int KD = 32;  // 3 + 6*FD = 27, padded
constexpr int MAX_LAYERS = 24;

// Element offsets into the packed buffers: entries 0..depth-1 are the trunk
// layers, then base_remap, sigma, rgb_0, rgb_1 (the style packing goes on
// with its own layers).
struct Layout {
  long long w[MAX_LAYERS];
  long long b[MAX_LAYERS];
};

inline Layout make_layout(const long long* offsets, int n) {
  Layout L = {};
  for (int i = 0; i < n; ++i) {
    L.w[i] = offsets[i];
    L.b[i] = offsets[n + i];
  }
  return L;
}

namespace sm90 {

using namespace hopper;

constexpr int ROWS = 128;        // points per tile
constexpr int WG_ROWS = 64;      // rows per consumer warpgroup
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CK = 64;                           // weight columns per chunk (128 B)
constexpr int CHUNK_BYTES = 256 * CK * 2;        // one ring slot: 256 rows x 64 columns
constexpr int BLK_BYTES = ROWS * CK * 2;         // one 64-column activation block
constexpr int WG_BLK_BYTES = WG_ROWS * CK * 2;   // a consumer's rows of a block
constexpr int MAX_MMA = 22;                      // tensor-core layers of one kernel

// Tensor maps of the layers on the tensor cores, in the order they run.
struct Maps {
  CUtensorMap m[MAX_MMA];
};

// Columns (K) and rows (N) of those layers.
struct Plan {
  int k[MAX_MMA];
  int n[MAX_MMA];
};

__host__ __device__ constexpr int chunks(int k) { return (k + CK - 1) / CK; }

// Where a segment of a layer's input lives: shared memory (swizzled
// 64-column blocks), or this consumer's registers (the previous layer's
// output as wgmma A fragments, `act`).
enum SegKind { NONE = 0, SMEM = 1, REGS = 2 };

// Block start: full[s] completes on the producer's arrival and its TMA
// bytes, empty[s] on one arrival per consumer warp.
template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer: every chunk of every layer of every tile this block runs,
// in the consumers' order.
template <int STAGES>
__device__ __forceinline__ void produce(const Maps& maps, const Plan& plan, int layers,
                                        int tiles, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty) {
  uint32_t q = 0;
  for (int t = 0; t < tiles; ++t)
    for (int l = 0; l < layers; ++l)
      for (int c = 0; c < chunks(plan.k[l]); ++c, ++q) {
        const uint32_t s = q % STAGES;
        if (q >= STAGES) mbar_wait(&empty[s], (q / STAGES - 1) & 1);
        mbar_expect(&full[s], plan.n[l] * CK * 2);
        tma_load_2d(ring + s * CHUNK_BYTES, &maps.m[l], &full[s], c * CK, 0);
      }
}

// acc[0 .. N/2) = this consumer's 64 rows of input @ W^T for the layer whose
// chunks come next in the ring (chunk counter q). The input is up to three
// segments (kind, columns) in the packed matrix's column order, fixed at
// compile time; shared-memory segments start at at0..at2 (this consumer's
// rows of their first block). Every k step of 16 columns is one wgmma: A from
// `act` (registers) or from shared memory, B from the chunk. Steps past K
// are not issued (the chunk's zero fill is never read).
template <int N, int STAGES, int KIND0, int C0, int KIND1 = NONE, int C1 = 0, int KIND2 = NONE,
          int C2 = 0>
__device__ __forceinline__ void mma_layer(float (&acc)[128], const uint32_t (&act)[64],
                                          uint32_t at0, uint32_t at1, uint32_t at2,
                                          uint32_t ring, uint64_t* full, uint64_t* empty,
                                          uint32_t& q) {
  constexpr int K = C0 + C1 + C2;
  wg_fence();
#pragma unroll
  for (int c = 0; c < chunks(K); ++c, ++q) {
    const uint32_t s = q % STAGES;
    mbar_wait(&full[s], (q / STAGES) & 1);
    __syncwarp();  // converged again for the .aligned wgmma instructions
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      const int col = c * CK + kk * 16;  // constants once unrolled
      if (col >= K) continue;
      const int seg = col < C0 ? 0 : (col < C0 + C1 ? 1 : 2);
      const int kind = seg == 0 ? KIND0 : (seg == 1 ? KIND1 : KIND2);
      const int cs = col - (seg == 0 ? 0 : (seg == 1 ? C0 : C0 + C1));
      const uint64_t db = sw128_desc_at(ring + s * CHUNK_BYTES + kk * 32, 1);
      if (kind == REGS) {
        const int r = 4 * (cs / 16);
        if constexpr (N == 256)
          wgmma_rs_n256(acc, act[r], act[r + 1], act[r + 2], act[r + 3], db, col > 0);
        else
          wgmma_rs_n128(acc, act[r], act[r + 1], act[r + 2], act[r + 3], db, col > 0);
      } else {
        const uint32_t at =
            (seg == 0 ? at0 : (seg == 1 ? at1 : at2)) + (cs / CK) * BLK_BYTES + (cs % CK) * 2;
        if constexpr (N == 256)
          wgmma_ss_n256(acc, sw128_desc_at(at, 1), db, col > 0);
        else
          wgmma_ss_n128(acc, sw128_desc_at(at, 1), db, col > 0);
      }
    }
    wg_commit();
    if (c > 0) {
      wg_wait<1>();
      release(&empty[(q - 1) % STAGES]);
    }
  }
  wg_wait<0>();
  reg_fence(acc);
  release(&empty[(q - 1) % STAGES]);
}

// The A fragments of accumulator n8 group j (columns 8 j .. 8 j + 7) for
// the thread's rows g and g + 8: k step j / 2, registers 2 (j % 2) and + 1.
__host__ __device__ constexpr int act_at(int j) { return 4 * (j / 2) + 2 * (j % 2); }

// act = bf16(relu(acc (+ lsum[n] lm) + bias[n])) as the next layer's A
// fragments; lm0 and lm1 are the rank-1 scalars of the thread's rows (warp *
// 16 + g and + 8): the f32 sum, the rank-1 term, the bias, ReLU, one bf16
// round.
template <int N, bool RANK1>
__device__ __forceinline__ void epilogue(const float (&acc)[128], uint32_t (&act)[64],
                                         const float* __restrict__ bias,
                                         const float* __restrict__ lsum, float lm0, float lm1,
                                         int t) {
  const float* bt = bias + 2 * t;
  const float* lt = RANK1 ? lsum + 2 * t : nullptr;
  asm("" : "+l"(bt), "+l"(lt));  // one base a thread, so the loads take immediate offsets
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j;
    float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
    if constexpr (RANK1) {
      const float l0 = __ldg(lt + col), l1 = __ldg(lt + col + 1);
      v[0] = fmaf(l0, lm0, v[0]);
      v[1] = fmaf(l1, lm0, v[1]);
      v[2] = fmaf(l0, lm1, v[2]);
      v[3] = fmaf(l1, lm1, v[3]);
    }
    const float b0 = __ldg(bt + col), b1 = __ldg(bt + col + 1);
    act[act_at(j)] = pack_bf16(fmaxf(v[0] + b0, 0.0f), fmaxf(v[1] + b1, 0.0f));
    act[act_at(j) + 1] = pack_bf16(fmaxf(v[2] + b0, 0.0f), fmaxf(v[3] + b1, 0.0f));
  }
}

// The first N columns of `act` into this consumer's rows of the 64-column
// blocks at shared address `dst`, swizzled.
template <int N>
__device__ __forceinline__ void store_act(const uint32_t (&act)[64], uint32_t dst, int warp,
                                          int g, int t) {
  const uint32_t row0 = dst + (warp * 16 + g) * 128 + t * 4;  // rows r0 and r0 + 8: r0 % 8 == g
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const uint32_t at = row0 + (j / 8) * BLK_BYTES + (((j % 8) ^ g) << 4);
    st_shared_b32(at, act[act_at(j)]);
    st_shared_b32(at + 8 * 128, act[act_at(j) + 1]);
  }
}

// Element (row, col) of a swizzled block at a consumer's rows.
__device__ __forceinline__ int sw(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// This consumer's 64 rows of bf16([x, sin(2^0 x), cos(2^0 x), ..., 0 pad]),
// KPAD columns, at `blk`; points past P encode 0. Thread tid takes row tid %
// 64 and half of the frequencies (warps 0-1 the first half, the three
// coordinates and the pad; warps 2-3 the rest): it loads its point's three
// coordinates at once (a warp's loads coalesced) and computes its columns
// from registers, so that a tile waits out one load's latency, not one a
// column. The frequency loop stays rolled: unrolled, its inlined sinf/cosf
// made K2 slower.
template <int NFREQ, int KPAD>
__device__ __forceinline__ void encode(const float* __restrict__ x_t, long long P,
                                       long long p0, uint8_t* blk, int tid) {
  constexpr int NFEAT = 3 + 6 * NFREQ;
  static_assert(NFEAT <= KPAD, "the encoding's columns fit its block");
  const int p = tid % WG_ROWS, half = tid / WG_ROWS;
  const long long q = p0 + p;
  const bool in = q < P;
  float x[3] = {0.0f, 0.0f, 0.0f};
  if (in) {
    x[0] = x_t[q];
    x[1] = x_t[P + q];
    x[2] = x_t[2 * P + q];
  }
  auto put = [&](int f, float v) {
    *reinterpret_cast<bf16*>(blk + sw(p, f)) = __float2bfloat16(in ? v : 0.0f);
  };
  if (half == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) put(d, x[d]);
#pragma unroll
    for (int f = NFEAT; f < KPAD; ++f) put(f, 0.0f);
  }
  const int k_end = half == 0 ? NFREQ / 2 : NFREQ;
#pragma unroll 1
  for (int k = half * (NFREQ / 2); k < k_end; ++k) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float arg = x[d] * (float)(1 << k);
      put(3 + 6 * k + d, sinf(arg));
      put(6 + 6 * k + d, cosf(arg));
    }
  }
}

// Eight bf16 of row `row` of a swizzled block, columns 8 cb .. 8 cb + 7.
__device__ __forceinline__ uint4 row8(const uint8_t* blk, int row, int cb) {
  return *reinterpret_cast<const uint4*>(blk + row * 128 + ((cb ^ (row & 7)) << 4));
}

// acc = fma over the 8 columns of a row8 against 8 weights, in column order.
__device__ __forceinline__ float dot8(uint4 a, uint4 w, float acc) {
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc = fmaf(__bfloat162float(y[e]), __bfloat162float(x[e]), acc);
  return acc;
}

// sigma = wsig . h + bsig for this consumer's 64 rows of the TW-wide h
// (TW / 64 blocks): two threads a point, each TW / 128 64-column partials
// summed in column order, then (p0 + p1) + (p2 + p3) at TW = 256, so that
// the same h gives the same sigma bit for bit in every kernel.
template <int TW = W>
__device__ __forceinline__ void sigma_head(const uint8_t* h, const bf16* __restrict__ wsig,
                                           float bsig, long long P, long long p0,
                                           float* __restrict__ sigma, int tid) {
  constexpr int PER = TW / CK / 2;  // blocks a thread
  static_assert(PER == 1 || PER == 2, "the sigma head takes widths 128 and 256");
  const int r = tid / 2, half = tid % 2;
  float part[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int blk = PER * half + i;
    float acc = 0.0f;
#pragma unroll
    for (int cb = 0; cb < 8; ++cb)
      acc = dot8(row8(h + blk * BLK_BYTES, r, cb),
                 __ldg(reinterpret_cast<const uint4*>(wsig + blk * CK + cb * 8)), acc);
    part[i] = acc;
  }
  float s = PER == 2 ? part[0] + part[PER - 1] : part[0];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (half == 0 && p0 + r < P) sigma[p0 + r] = s + bsig;
}

// acc = w[c] . x[row] over `blocks` 64-column blocks, in column order.
__device__ __forceinline__ float row_dot(const uint8_t* x, int blocks, const bf16* __restrict__ w,
                                         int row) {
  float acc = 0.0f;
  for (int blk = 0; blk < blocks; ++blk)
#pragma unroll
    for (int cb = 0; cb < 8; ++cb)
      acc = dot8(row8(x + blk * BLK_BYTES, row, cb),
                 __ldg(reinterpret_cast<const uint4*>(w + blk * CK + cb * 8)), acc);
  return acc;
}

// A per-layer hook that does nothing: K1, K2, K4 and K5 keep no activation.
struct NoHook {
  __device__ __forceinline__ void operator()(int) const {}
};

// One tile's trunk, the sequence every kernel on the engine runs: enc(pts)
// into `ec` and whatever `extra` writes beside it (K1's and K3's enc(dirs),
// K4's latents), the depth tensor-core layers with h in registers ([enc(pts)
// | h] at layer skip + 1), hook(i) after layer i's epilogue (K3 keeps each
// layer's output and ReLU mask there), h into this consumer's rows of `hs`
// (TW / 64 blocks) and sigma on CUDA cores. TW is the trunk's width. Leaves act = h (wgmma A fragments)
// for a caller that goes on, and q past the trunk's chunks. DEPTH > 0 fixes
// depth and skip at compile time (the configs' D8, skip 4), and ptxas then
// keeps the wgmma pipeline (with run-time depth and skip it serializes it,
// C7511). UNROLL unrolls the layer loop, as K1, K2 and K5 want; K4 and K3,
// long kernels, leave it to the compiler. The barrier after the encodings also orders the
// previous tile's reads of hs (its heads) before this tile's store into it.
template <int DEPTH, int SKIP, int STAGES, bool UNROLL, int TW = W, class Extra,
          class Hook = NoHook>
__device__ __forceinline__ void trunk_tile(float (&acc)[128], uint32_t (&act)[64], int depth_rt,
                                           int skip_rt, const float* __restrict__ pts_t,
                                           long long P, long long p0, uint8_t* ec, uint8_t* hs,
                                           const bf16* __restrict__ w,
                                           const float* __restrict__ b, const Layout& L,
                                           float* __restrict__ sigma, uint32_t ring,
                                           uint64_t* full, uint64_t* empty, uint32_t& q, int tid,
                                           int bar, Extra&& extra, Hook&& hook = Hook{}) {
  const int depth = DEPTH > 0 ? DEPTH : depth_rt, skip = DEPTH > 0 ? SKIP : skip_rt;
  const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
  const uint32_t s_ec = smem_u32(ec);
  encode<FC, KC>(pts_t, P, p0, ec, tid);
  extra();
  fence_proxy_async();
  bar_sync(bar, 128);
  auto layer = [&](int i) {
    if (i == 0)
      mma_layer<TW, STAGES, SMEM, KC>(acc, act, s_ec, 0, 0, ring, full, empty, q);
    else if (i == skip + 1)
      mma_layer<TW, STAGES, SMEM, KC, REGS, TW>(acc, act, s_ec, 0, 0, ring, full, empty, q);
    else
      mma_layer<TW, STAGES, REGS, TW>(acc, act, 0, 0, 0, ring, full, empty, q);
    epilogue<TW, false>(acc, act, b + L.b[i], nullptr, 0.0f, 0.0f, t);
    hook(i);
  };
  if constexpr (UNROLL) {
#pragma unroll(DEPTH > 0 ? DEPTH : 1)
    for (int i = 0; i < depth; ++i) layer(i);
  } else {
    for (int i = 0; i < depth; ++i) layer(i);
  }
  store_act<TW>(act, smem_u32(hs), warp, g, t);
  bar_sync(bar, 128);
  sigma_head<TW>(hs, w + L.w[depth + 1], b[L.b[depth + 1]], P, p0, sigma, tid);
}

// K1's tail of a tile, after trunk_tile (act = h): base_remap, rgb_0 on
// [base_remap | enc(dirs)] (wgmma m64n128k16; enc(dirs) at shared address
// s_ed) into the first two of this consumer's blocks of `hs` (at shared
// address s_hs; warp, g and t are the thread's, as in epilogue), and the rgb
// head on CUDA cores, out(r, c, sigmoid(wr1[c] . rf[r] + br1[c])) for each
// row r of this consumer below P and channel c. hook(depth) runs after
// base_remap's epilogue and hook(depth + 2) after rgb_0's, before rf goes to
// `hs`. Leaves act = rf. K1 and K3 both run it, so K3's recompute is K1's.
template <int STAGES, class Out, class Hook = NoHook>
__device__ __forceinline__ void rgb_tail(float (&acc)[128], uint32_t (&act)[64], int depth,
                                         long long P, long long p0, uint8_t* hs, uint32_t s_ed,
                                         const bf16* __restrict__ w,
                                         const float* __restrict__ b, const Layout& L,
                                         uint32_t ring, uint64_t* full, uint64_t* empty,
                                         uint32_t& q, int tid, int bar, int warp, int g,
                                         int t, uint32_t s_hs, Out&& out, Hook&& hook = Hook{}) {
  mma_layer<W, STAGES, REGS, W>(acc, act, 0, 0, 0, ring, full, empty, q);
  epilogue<W, false>(acc, act, b + L.b[depth], nullptr, 0.0f, 0.0f, t);
  hook(depth);
  mma_layer<HW, STAGES, REGS, W, SMEM, KD>(acc, act, 0, s_ed, 0, ring, full, empty, q);
  epilogue<HW, false>(acc, act, b + L.b[depth + 2], nullptr, 0.0f, 0.0f, t);
  hook(depth + 2);
  bar_sync(bar, 128);  // sigma_head has read hs
  store_act<HW>(act, s_hs, warp, g, t);
  bar_sync(bar, 128);
  for (int idx = tid; idx < 3 * WG_ROWS; idx += 128) {
    const int r = idx % WG_ROWS, c = idx / WG_ROWS;
    if (p0 + r >= P) continue;
    const float v = row_dot(hs, HW / CK, w + L.w[depth + 3] + c * HW, r);
    out(r, c, 1.0f / (1.0f + expf(-(v + b[L.b[depth + 3] + c]))));
  }
}

// The sigma-only kernel's ring depth and shared memory.
constexpr int SIGMA_KERNEL_STAGES = 4;
struct SigmaSmem {
  uint8_t ring[SIGMA_KERNEL_STAGES][CHUNK_BYTES];
  uint8_t h[4][BLK_BYTES];
  uint8_t ec[BLK_BYTES];
  uint64_t full[SIGMA_KERNEL_STAGES], empty[SIGMA_KERNEL_STAGES];
};
constexpr int SIGMA_KERNEL_SMEM = (int)sizeof(SigmaSmem) + 1024;  // + the 1 KB alignment slack
static_assert(SIGMA_KERNEL_SMEM <= 232448, "the sigma kernel's shared memory exceeds 227 KB");

// K2 and K5: persistent blocks over 128-point tiles, each tile the trunk
// and sigma (trunk_tile) and nothing after it. The maps and plan list the
// depth trunk layers, TW wide.
template <int DEPTH, int SKIP, int TW = W>
__global__ void __launch_bounds__(THREADS, 1)
sigma_kernel(const __grid_constant__ Maps maps, const Plan plan, const float* __restrict__ pts_t,
             long long P, const bf16* __restrict__ w, const float* __restrict__ b, Layout L,
             int depth_rt, int skip_rt, float* __restrict__ sigma) {
  extern __shared__ uint8_t smem_raw[];
  SigmaSmem& sm = *reinterpret_cast<SigmaSmem*>(align_1k(smem_raw));
  const long long ntiles = (P + ROWS - 1) / ROWS;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  init_ring<SIGMA_KERNEL_STAGES>(sm.full, sm.empty);

  if (wg == CONSUMERS) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0)
      produce<SIGMA_KERNEL_STAGES>(maps, plan, DEPTH > 0 ? DEPTH : depth_rt,
                                   (int)((ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x),
                                   sm.ring[0], sm.full, sm.empty);
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int rows = wg * WG_BLK_BYTES;  // this consumer's rows of each block
  const uint32_t ring = smem_u32(sm.ring[0]);
  float acc[128];
  uint32_t act[64];
  uint32_t q = 0;  // chunks consumed
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
    trunk_tile<DEPTH, SKIP, SIGMA_KERNEL_STAGES, true, TW>(
        acc, act, depth_rt, skip_rt, pts_t, P, tile * ROWS + wg * WG_ROWS, sm.ec + rows,
        sm.h[0] + rows, w, b, L, sigma, ring, sm.full, sm.empty, q, tid, 1 + wg, [] {});
}

// ------------------------------------------------------------ host side

// The tensor map of a packed [n, k] bf16 matrix at element offset `off` of
// `w`: boxes of 64 columns x n rows, 128-byte swizzle, zeros past k.
inline bool weight_map(CUtensorMap* map, const void* w, long long off, int n, int k) {
  static const EncodeTiled encode = encode_fn();
  if (!encode || n < 1 || n > 256 || k % 16 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {(cuuint32_t)CK, (cuuint32_t)n}, ones[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<bf16*>(static_cast<const bf16*>(w) + off), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K1's tensor-core layers, in the order they run: trunk 0..depth-1,
// base_remap, rgb_0 (matrices 0..depth-1, depth, depth + 2 of the packing).
// False if a map cannot be made.
inline bool rgb_plan(Maps* maps, Plan* plan, const void* w, const Layout& L, int depth,
                     int skip) {
  *plan = {};
  for (int i = 0; i <= depth + 1; ++i) {
    const int mat = i < depth ? i : (i == depth ? depth : depth + 2);
    plan->k[i] =
        i == 0 ? KC : (i == skip + 1 && i < depth ? KC + W : (i == depth + 1 ? W + KD : W));
    plan->n[i] = i == depth + 1 ? HW : W;
    if (!weight_map(&maps->m[i], w, L.w[mat], plan->n[i], plan->k[i])) return false;
  }
  return true;
}

// Blocks of a persistent launch over `tiles` tiles: one per SM at most.
inline int persistent_grid(long long tiles) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return (int)(tiles < sms ? tiles : sms);
}

// Launches sigma_kernel<DEPTH, SKIP, TW> (DEPTH 0: any depth and skip) on
// the TW-wide trunk of a packing whose matrices 0..depth-1 are the trunk
// layers and depth + 1 the sigma head (pack_nerf_params's and
// pack_style_params's). Returns cudaGetLastError() after the launch.
template <int DEPTH, int SKIP, int TW = W>
inline int launch_sigma(const float* pts_t, long long P, const void* w, const float* b,
                        const Layout& L, int depth, int skip, float* sigma,
                        cudaStream_t stream) {
  if (depth < 1 || depth > MAX_MMA) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sigma_kernel<DEPTH, SKIP, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SIGMA_KERNEL_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return 0;
  Maps maps;
  Plan plan = {};
  for (int i = 0; i < depth; ++i) {
    plan.k[i] = i == 0 ? KC : (i == skip + 1 ? KC + TW : TW);
    plan.n[i] = TW;
    if (!weight_map(&maps.m[i], w, L.w[i], TW, plan.k[i])) return (int)cudaErrorInvalidValue;
  }
  const int grid = persistent_grid((P + ROWS - 1) / ROWS);
  if (grid <= 0) return (int)cudaErrorInvalidDevice;
  sigma_kernel<DEPTH, SKIP, TW><<<grid, THREADS, SIGMA_KERNEL_SMEM, stream>>>(
      maps, plan, pts_t, P, static_cast<const bf16*>(w), b, L, depth, skip, sigma);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace tgtc
