// K2 at width 128 (K2-W128) for Hopper (sm_90a): the distilled proposal's
// sigma kernel, sigma = w_sigma . h + b_sigma over a 128-wide ReLU trunk on
// bf16(enc(pts)) (tgtc/render/distill.py; D2 by default). It replaces the TPU
// kernel fused_nerf_sigma_apply_t (tgtc/ops/pallas/nerf_mlp.py:296, call
// :316) at that width, as K2 (trunk_sm90.cuh's sigma_kernel) does at 256.
//
// What bounds it: operations. At D2 a point carries 2 x (64 x 128 + 128 x
// 128) tensor-core FLOP, the encoding's 30 sin/cos pairs and two 128-wide
// epilogues on CUDA cores, against 16 bytes of point I/O; the tensor-core
// floor and the CUDA-core work are of one size, so the design overlaps them.
// The dense-layer engine (trunk_sm90.cuh), built for D8 x W256 at ~1 MFLOP a
// point, carried this trunk at 5% of its tensor floor: its producer streamed
// the 48 KB of weights again for every 128-point tile, eight consumer warps
// ran encode, wgmma, h to shared memory, a barrier and the sigma head one
// after another, and the encoding took 60 sinf/cosf and 63 scalar loads a
// point. Here:
// * Weights resident. Each block copies the trunk (matrices 0..depth-1 of
//   the packing) and the sigma row, padded to 8 rows, into shared memory
//   once, swizzled as wgmma's K-major B wants them (the 128-byte pattern a
//   TMA box of 64 columns gives), and never again: no ring, no producer,
//   no per-tile barrier. Depth 2 takes 51 KB; any depth up to 7 fits
//   (smem_bytes), deeper trunks stay on the engine.
// * Four independent consumer warpgroups a block (512 threads, 128
//   registers a thread), one block per SM, each warpgroup walking its own
//   64-point tiles (tile = block x 4 + warpgroup, += grid x 4) through
//   every step in order, so one warpgroup's encode and epilogues run while
//   another's wgmma does. Four fill the SM's 64 K registers at 128 a
//   thread, which holds a tile's 64 accumulators, 32 activation and 16
//   encoding fragments. Encoding the next tile while the warpgroup's own
//   last layer or sigma product ran was slower when tried on an H100, and
//   is not done.
// * The encoding in registers, straight into layer 0's wgmma A fragments
//   (the RS form): each thread loads the 3 coordinates of its two rows once
//   (the next tile's while this one runs) and computes one accurate sincosf
//   a (coordinate, frequency) pair. The fragments hold 32 bf16 pairs a row,
//   and the kernel orders layer 0's columns so that each pair is one
//   sincosf: pair 0 (x, y), pair 1 (z, 1), pair 2 + 3k + d (sin, cos)(2^k
//   x_d). The copy into shared memory permutes the packed matrix's columns
//   to that order (ref_col); the packing and the twin keep the reference's.
// * Biases: a layer that reads the encoding (layer 0, a skip layer) carries
//   its bias in the encoding's pad column, whose input is 1 (the biases are
//   bf16 values, so the tensor cores add them exactly); the others' are
//   added in f32 in the epilogue.
// * Activations in registers from layer to layer (wgmma m64n128k16, A from
//   registers); the epilogue rounds with one cvt.rn.relu.bf16x2 (ReLU then
//   the bf16 round, the reference's order: rounding is monotonic and keeps
//   0).
// * The sigma head on the tensor cores: wgmma m64n8k16 of h (the last
//   layer's A fragments) against the padded sigma row, whose column 0 is
//   w_sigma . h; h never goes to shared memory. The sum's order is the
//   tensor core's, fixed, so a launch repeats bit for bit (no atomics); no
//   other kernel computes this trunk, so no bitwise tie with K1 is owed.
// * Depth 2 is compiled in (the layer loop unrolled); other depths run on a
//   run-time-depth instance (DEPTH 0) that keeps the encoding's fragments
//   for a skip layer ([enc(pts) | h], 192 columns).
// Accurate sincosf in f32 (the arguments reach 2^9 |x|): build without fast
// math.

#pragma once

#include "trunk_sm90.cuh"

namespace tgtc {
namespace proposal {

using namespace hopper;

constexpr int PW = 128;          // trunk width
constexpr int ROWS = 64;         // points per tile: one warpgroup's wgmma rows
constexpr int WARPGROUPS = 4;    // consumer warpgroups a block, each on its own tiles
constexpr int BLK = PW * 128;    // one 64-column block of a [128, K] matrix: 16 KB
constexpr int SIG_BYTES = 2048;  // the sigma row padded to 8 rows: 2 blocks of 1 KB
constexpr int SMEM_LIMIT = 232448;
static_assert(3 + 6 * FC == KC - 1, "the encoding fills 63 of layer 0's 64 columns");

// 64-column weight blocks of trunk layer i (1 <= i < depth at the skip layer).
__host__ __device__ constexpr int layer_blocks(int i, int skip) {
  return i == 0 ? 1 : (i == skip + 1 ? 3 : 2);
}

// Dynamic shared memory of a block: the sigma tile, the trunk's weight
// blocks, the 1 KB alignment slack. The kernel takes the trunk while this
// is at most SMEM_LIMIT: every depth up to 7, whatever the skip.
__host__ __device__ inline int smem_bytes(int depth, int skip) {
  int blocks = 0;
  for (int i = 0; i < depth; ++i) blocks += layer_blocks(i, skip);
  return SIG_BYTES + blocks * BLK + 1024;
}

// The packed (reference) column of the kernel's layer-0 column j: pair j / 2
// is (x, y), (z, pad) or (sin, cos)(2^k x_d) at pair 2 + 3k + d. The pad
// column carries the layer's bias (see load_weights).
__host__ __device__ constexpr int ref_col(int j) {
  return j / 2 == 0   ? j % 2
         : j / 2 == 1 ? (j % 2 ? KC - 1 : 2)
                      : 3 + 6 * ((j / 2 - 2) / 3) + (j / 2 - 2) % 3 + 3 * (j % 2);
}

// bf16(relu(lo)) in the low half, bf16(relu(hi)) in the high half.
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The trunk into shared memory at `sm` (1 KB aligned): the sigma row (matrix
// depth + 1) as row 0 of an 8-row tile, then matrices 0..depth-1, each as
// its 64-column blocks in the 128-byte swizzle; the encoding's columns (all
// of layer 0, the first 64 of the skip layer) in the kernel's order, with
// the layer's bias in the pad column (the encoding's 1 there: the biases
// are bf16 values, so the product is exact and the tensor cores add it).
__device__ __forceinline__ void load_weights(uint8_t* sm, const bf16* __restrict__ w,
                                             const float* __restrict__ b, const Layout& L,
                                             int depth, int skip) {
  const bf16 zero = __float2bfloat16(0.0f);
  for (int e = threadIdx.x; e < 8 * PW; e += blockDim.x) {
    const int n = e / PW, k = e % PW;
    *reinterpret_cast<bf16*>(sm + (k / 64) * 1024 + sm90::sw(n, k % 64)) =
        n == 0 ? w[L.w[depth + 1] + k] : zero;
  }
  uint8_t* dst = sm + SIG_BYTES;
  for (int i = 0; i < depth; ++i) {
    const bool with_enc = i == 0 || i == skip + 1;
    const int k = i == 0 ? KC : (with_enc ? KC + PW : PW), nenc = with_enc ? KC : 0;
    const bf16* src = w + L.w[i];
    for (int e = threadIdx.x; e < PW * nenc; e += blockDim.x) {
      const int n = e / KC, j = e % KC;
      *reinterpret_cast<bf16*>(dst + sm90::sw(n, j)) =
          ref_col(j) == KC - 1 ? __float2bfloat16(b[L.b[i] + n]) : src[n * k + ref_col(j)];
    }
    const int chunks = (k - nenc) / 8;  // 16-byte chunks a row past the encoding
    for (int e = threadIdx.x; e < PW * chunks; e += blockDim.x) {
      const int n = e / chunks, c = nenc / 8 + e % chunks;
      *reinterpret_cast<uint4*>(dst + (c / 8) * BLK + n * 128 + (((c % 8) ^ (n % 8)) << 4)) =
          __ldg(reinterpret_cast<const uint4*>(src + n * k + 8 * c));
    }
    dst += layer_blocks(i, skip) * BLK;
  }
}

// x[r][d]: coordinate d of row `row` + 8 r (0 past P).
__device__ __forceinline__ void load_points(float (&x)[2][3], const float* __restrict__ pts_t,
                                            long long P, long long row) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      x[r][d] = row + 8 * r < P ? __ldg(pts_t + d * P + row + 8 * r) : 0.0f;
}

// Layer 0's A fragments of the thread's rows g and g + 8 (x[0], x[1]):
// register 4 s + 2 h + r holds pair 8 s + 4 h + t of row g + 8 r (the
// fragments' layout), so the thread's pairs are p = 4 m + t, m = 0..7, each
// one sincosf in the kernel's column order (see ref_col); the pad column is
// 1, the bias's factor.
__device__ __forceinline__ void encode(uint32_t (&a)[16], const float (&x)[2][3], int t) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int q = m == 0 && t < 2 ? 0 : 4 * m + t - 2;  // pairs 0 and 1 are no sincos
    const int k = q / 3, d = q - 3 * k;
    const float scale = __int_as_float((127 + k) << 23);  // 2^k, exactly
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s, c;
      sincosf((d == 0 ? x[r][0] : (d == 1 ? x[r][1] : x[r][2])) * scale, &s, &c);
      uint32_t v = pack_bf16(s, c);
      if (m == 0 && t < 2) v = t == 0 ? pack_bf16(x[r][0], x[r][1]) : pack_bf16(x[r][2], 1.0f);
      a[4 * (m / 2) + 2 * (m % 2) + r] = v;
    }
  }
}

// act = bf16(relu(acc (+ bias))) as the next layer's A fragments (the
// engine's act_at layout): n8 group j of the accumulator is k step j / 2's
// registers 2 (j % 2) and + 1. A layer that reads the encoding has its bias
// in acc already (BIAS false).
template <bool BIAS>
__device__ __forceinline__ void epilogue(const float (&acc)[64], uint32_t (&act)[32],
                                         const float* __restrict__ bias, int t) {
  const float2* bt = reinterpret_cast<const float2*>(bias + 2 * t);  // trunk biases: even offsets
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
    if constexpr (BIAS) {
      const float2 bb = __ldg(bt + 4 * j);
      v[0] += bb.x;
      v[1] += bb.y;
      v[2] += bb.x;
      v[3] += bb.y;
    }
    act[sm90::act_at(j)] = relu_bf16x2(v[0], v[1]);
    act[sm90::act_at(j) + 1] = relu_bf16x2(v[2], v[3]);
  }
}

// The B descriptor of k step s of a matrix whose 64-column blocks start at
// shared address `base`, `blk` bytes apart.
__device__ __forceinline__ uint64_t b_desc(uint32_t base, int s, int blk) {
  return sw128_desc_at(base + (s / 4) * blk + (s % 4) * 32, 1);
}

// acc = a layer's 64 x 128 product over k steps of A fragments `a` against
// the matrix at `base`, from k step s0 of its blocks on (no wait).
template <int STEPS>
__device__ __forceinline__ void issue_layer(float (&acc)[64], const uint32_t* a, uint32_t base,
                                            int s0, bool first) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    wgmma_rs_n128(acc, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3],
                  b_desc(base, s0 + s, BLK), !first || s > 0);
}

// K2-W128: see the header. DEPTH > 0 fixes the depth at compile time with
// no skip layer reached (the C entry point sends depth 2 with skip != 0
// here); DEPTH 0 takes depth_rt and skip_rt. A warpgroup's tile runs its
// steps in order (encode, layer 0, epilogue, ..., the sigma product); the
// overlap comes from the block's other warpgroups.
template <int DEPTH>
__global__ void __launch_bounds__(128 * WARPGROUPS, 1)
sigma_kernel(const float* __restrict__ pts_t, long long P, const bf16* __restrict__ w,
             const float* __restrict__ b, Layout L, int depth_rt, int skip_rt,
             float* __restrict__ sigma) {
  const int depth = DEPTH > 0 ? DEPTH : depth_rt, skip = DEPTH > 0 ? -1 : skip_rt;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1k(smem_raw);
  load_weights(sm, w, b, L, depth, skip);
  fence_proxy_async();  // the copies before the tensor cores' reads
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
  const uint32_t s_sig = smem_u32(sm), s_w0 = s_sig + SIG_BYTES;
  const float bsig = b[L.b[depth + 1]];
  const long long ntiles = (P + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * WARPGROUPS;
  long long tile = (long long)blockIdx.x * WARPGROUPS + wg;
  float x[2][3];
  load_points(x, pts_t, P, tile * ROWS + warp * 16 + g);
  for (; tile < ntiles; tile += stride) {
    const long long row = tile * ROWS + warp * 16 + g;
    uint32_t enc[16], act[32];
    float acc[64];
    encode(enc, x, t);
    load_points(x, pts_t, P, row + stride * ROWS);  // the next tile's, while this one runs
    wg_fence();
    issue_layer<4>(acc, enc, s_w0, 0, true);
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    epilogue<false>(acc, act, nullptr, t);
    uint32_t wl = s_w0 + BLK;
#pragma unroll(DEPTH > 0 ? DEPTH : 1)
    for (int i = 1; i < depth; ++i) {
      wg_fence();
      if (i == skip + 1) {  // [enc(pts) | h], the bias in enc's pad column
        issue_layer<4>(acc, enc, wl, 0, true);
        issue_layer<8>(acc, act, wl, 4, false);
      } else {
        issue_layer<8>(acc, act, wl, 0, true);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
      if (i == skip + 1)
        epilogue<false>(acc, act, nullptr, t);
      else
        epilogue<true>(acc, act, b + L.b[i], t);
      wl += layer_blocks(i, skip) * BLK;
    }

    float sg[4];
    wg_fence();
#pragma unroll
    for (int s = 0; s < PW / 16; ++s)
      wgmma_rs_n8(sg, act + 4 * s, b_desc(s_sig, s, 1024), s > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(sg);
    if (t == 0) {  // column 0: rows g and g + 8
      if (row < P) sigma[row] = sg[0] + bsig;
      if (row + 8 < P) sigma[row + 8] = sg[2] + bsig;
    }
  }
}

// ------------------------------------------------------------ host side

// Launches sigma_kernel<DEPTH> on a 128-wide trunk of a packing whose
// matrices 0..depth-1 are the trunk layers and depth + 1 the sigma head.
// Returns cudaGetLastError() after the launch.
template <int DEPTH>
inline int launch_sigma(const float* pts_t, long long P, const void* w, const float* b,
                        const Layout& L, int depth, int skip, float* sigma,
                        cudaStream_t stream) {
  const int smem = smem_bytes(depth, skip);
  if (depth < 1 || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sigma_kernel<DEPTH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return 0;
  const long long tiles = (P + ROWS - 1) / ROWS;
  const int grid = sm90::persistent_grid((tiles + WARPGROUPS - 1) / WARPGROUPS);
  if (grid <= 0) return (int)cudaErrorInvalidDevice;
  sigma_kernel<DEPTH><<<grid, 128 * WARPGROUPS, smem, stream>>>(
      pts_t, P, static_cast<const bf16*>(w), b, L, depth, skip, sigma);
  return (int)cudaGetLastError();
}

}  // namespace proposal
}  // namespace tgtc
