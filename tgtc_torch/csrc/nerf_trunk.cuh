// Device code of the first NeRF trunk design, used by the backward K3
// (nerf_mlp_grad.cu) alone: K3 recomputes the forward with these functions
// (trunk_sigma, rgb_features, rgb_out, store_rows) into its workspace.
// The forward kernels K1, K2, K4 and K5 run on the Hopper engine
// (trunk_sm90.cuh), which takes Layout, make_layout and the encoding
// constants from here. Its epilogue rounds as gemm_bias_relu, its sigma
// head sums as trunk_sigma, and wgmma accumulates a row's k steps in the
// order of this file's mma.sync, so K3 recomputes the activations of the K1
// launch whose loss it differentiates.
//
// Per point: positional encoding of pts (L=10) and dirs (L=4) with accurate
// sinf/cosf in f32 (arguments reach 2^9 |x|; build without fast math), an
// 8x256 ReLU trunk with the encoded input re-injected before layer skip+1,
// the sigma head, 256-d base_remap, a 128-wide rgb layer on
// [base_remap | enc(dirs)] and a 3-d sigmoid rgb. Matmul operands are bf16
// with f32 accumulation; bias + ReLU run in f32 and round to bf16, at the
// same points as the TPU kernel. Sigma and rgb heads use bf16 weights, f32
// sums.
//
// A block owns a tile of T=64 points and keeps its activations in shared
// memory as bf16 ([T, 256+8] rows, padded against bank conflicts). Eight
// warps split the output columns of every layer; each warp keeps a 64x32
// f32 accumulator in WMMA fragments (mma.sync bf16, 16x16x16) and streams
// its weight columns straight from global memory, where the 1.2 MB packed
// weight buffer stays resident in L2. The epilogue goes through a per-warp
// 16x16 f32 scratch. The ragged tail of P is masked in-kernel.
//
// Packed weights (pack_nerf_params): one bf16 buffer of row-major
// [out, in_padded] matrices and one f32 bias buffer (bf16-rounded values);
// the per-layer offsets come from the caller. Inputs are padded to 64
// (pts encoding, 63 used) and 32 (dirs encoding, 27 used) columns; the skip
// layer's columns are [enc(pts) | h], rgb_0's are [base_remap | enc(dirs)].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace tgtc {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int T = 64;  // points per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int W = 256;   // trunk width (also base_remap width)
constexpr int HW = 128;  // rgb hidden width
constexpr int FC = 10, FD = 4;
constexpr int KC = 64;  // 3 + 6*FC = 63, padded
constexpr int KD = 32;  // 3 + 6*FD = 27, padded
constexpr int LDH = W + 8;  // shared-memory row strides in bf16 elements
constexpr int LDC = KC + 8;
constexpr int LDD = KD + 8;
constexpr int LDR = HW + 8;
constexpr int MAX_LAYERS = 24;

constexpr int H_BYTES = T * LDH * 2;
constexpr int EC_BYTES = T * LDC * 2;
constexpr int ED_BYTES = T * LDD * 2;
constexpr int RF_BYTES = T * LDR * 2;
constexpr int SCRATCH_BYTES = NWARPS * 256 * 4;
constexpr int SMEM_BYTES = H_BYTES + EC_BYTES + ED_BYTES + RF_BYTES + SCRATCH_BYTES;

// Element offsets into the packed buffers: entries 0..depth-1 are the trunk
// layers, then base_remap, sigma, rgb_0, rgb_1.
struct Layout {
  long long w[MAX_LAYERS];
  long long b[MAX_LAYERS];
};

// Point-major [P, cols] global copies of a tile's activations, written
// during the forward for the backward kernel; null where not wanted.
struct Saved {
  bf16* ec;              // [P, KC]
  bf16* h[MAX_LAYERS];   // [P, W], trunk layer outputs 0..depth-1
};

struct Seg {  // one K-segment of a layer's input
  const bf16* a;  // shared-memory activations [T, lda]
  int lda;
  int k;     // columns used (multiple of 16)
  int wcol;  // first weight column of this segment
};

// out[T, 16*NT*NWARPS] = relu(sum_seg A_seg @ W[:, seg]^T + bias), as bf16.
// `out` may alias an input: every warp finishes reading before any writes.
// RANK1 (the style layers of style_kernel.cu) adds lsum[n] * lmean[row]
// to the f32 sum before the bias; the default compiles to the plain form.
template <int NT, bool RANK1 = false>
__device__ void gemm_bias_relu(const Seg* segs, int nseg,
                               const bf16* __restrict__ w, int ldw,
                               const float* __restrict__ bias, bf16* out,
                               int ldo, float* scratch,
                               const float* __restrict__ lsum = nullptr,
                               const float* lmean = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T / 16][NT];
#pragma unroll
  for (int i = 0; i < T / 16; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int s = 0; s < nseg; ++s) {
    const Seg sg = segs[s];
    for (int k0 = 0; k0 < sg.k; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[T / 16];
#pragma unroll
      for (int i = 0; i < T / 16; ++i)
        wmma::load_matrix_sync(a[i], sg.a + i * 16 * sg.lda + k0, sg.lda);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n0 = (warp * NT + j) * 16;
        // W row-major [n, ldw] read as a col-major [k, n] operand
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w + (long long)n0 * ldw + sg.wcol + k0, ldw);
#pragma unroll
        for (int i = 0; i < T / 16; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }
  __syncthreads();

  float* sc = scratch + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < T / 16; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n0 = (warp * NT + j) * 16;
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float v = sc[r * 16 + c0 + c];
        if constexpr (RANK1) v += lsum[n0 + c0 + c] * lmean[i * 16 + r];
        v += bias[n0 + c0 + c];
        out[(i * 16 + r) * ldo + n0 + c0 + c] = __float2bfloat16(fmaxf(v, 0.0f));
      }
      __syncwarp();
    }
  __syncthreads();
}

// enc[T, ld] = bf16([x, sin(2^0 x), cos(2^0 x), ..., 0 pad]) for the block's
// points; points past P encode x = 0.
__device__ void encode(const float* __restrict__ x_t, long long P, long long p0,
                       int nfreq, int kpad, bf16* enc, int ld) {
  const int nfeat = 3 + 6 * nfreq;
  for (int idx = threadIdx.x; idx < T * kpad; idx += NTHREADS) {
    const int p = idx / kpad, f = idx % kpad;
    const long long q = p0 + p;
    float v = 0.0f;
    if (f < nfeat && q < P) {
      if (f < 3) {
        v = x_t[f * P + q];
      } else {
        const int g = f - 3, k = g / 6, d = g % 3;
        const float arg = x_t[d * P + q] * (float)(1 << k);
        v = ((g % 6) < 3) ? sinf(arg) : cosf(arg);
      }
    }
    enc[p * ld + f] = __float2bfloat16(v);
  }
}

// g[(p0 + r) * cols + c] = s[r * lds + c] for the tile's rows below P, in
// 16-byte pieces (cols and lds are multiples of 8).
__device__ void store_rows(const bf16* s, int lds, int cols, bf16* g,
                           long long P, long long p0) {
  const int pieces = cols / 8;
  for (int idx = threadIdx.x; idx < T * pieces; idx += NTHREADS) {
    const int r = idx / pieces, c = (idx % pieces) * 8;
    if (p0 + r < P)
      *reinterpret_cast<uint4*>(g + (p0 + r) * cols + c) =
          *reinterpret_cast<const uint4*>(s + r * lds + c);
  }
}

// Encoding + trunk (h left in shared memory) + sigma head. Shared by K1, K2
// and K3 so that all give the same trunk bit for bit. `sigma_out` and `sv`
// may be null.
__device__ void trunk_sigma(const float* __restrict__ pts_t, long long P,
                            long long p0, const bf16* __restrict__ w,
                            const float* __restrict__ b, const Layout& L,
                            int depth, int skip, bf16* h, bf16* ec,
                            float* scratch, float* __restrict__ sigma_out,
                            const Saved* sv) {
  encode(pts_t, P, p0, FC, KC, ec, LDC);
  __syncthreads();
  if (sv) store_rows(ec, LDC, KC, sv->ec, P, p0);

  Seg s0[1] = {{ec, LDC, KC, 0}};
  gemm_bias_relu<W / 16 / NWARPS>(s0, 1, w + L.w[0], KC, b + L.b[0], h, LDH, scratch);
  if (sv) store_rows(h, LDH, W, sv->h[0], P, p0);
  for (int i = 1; i < depth; ++i) {
    if (i == skip + 1) {
      Seg s[2] = {{ec, LDC, KC, 0}, {h, LDH, W, KC}};
      gemm_bias_relu<W / 16 / NWARPS>(s, 2, w + L.w[i], KC + W, b + L.b[i], h, LDH, scratch);
    } else {
      Seg s[1] = {{h, LDH, W, 0}};
      gemm_bias_relu<W / 16 / NWARPS>(s, 1, w + L.w[i], W, b + L.b[i], h, LDH, scratch);
    }
    if (sv) store_rows(h, LDH, W, sv->h[i], P, p0);
  }

  // sigma = wsig . h + bsig: four threads per point, 64 columns each, then a
  // fixed shuffle tree (deterministic order)
  const bf16* wsig = w + L.w[depth + 1];
  const int p = threadIdx.x / 4, part = threadIdx.x % 4;
  float acc = 0.0f;
  for (int k = part * (W / 4); k < (part + 1) * (W / 4); ++k)
    acc = fmaf(__bfloat162float(wsig[k]), __bfloat162float(h[p * LDH + k]), acc);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (sigma_out && part == 0 && p0 + p < P) sigma_out[p0 + p] = acc + b[L.b[depth + 1]];
}

// After trunk_sigma: dirs encoding into ed, base_remap in place over h (the
// gemm syncs before it writes, after the sigma head has read h), then the
// 128-wide rgb layer into rf.
__device__ void rgb_features(const float* __restrict__ dirs_t, long long P,
                             long long p0, const bf16* __restrict__ w,
                             const float* __restrict__ b, const Layout& L,
                             int depth, bf16* h, bf16* ed, bf16* rf,
                             float* scratch) {
  encode(dirs_t, P, p0, FD, KD, ed, LDD);
  Seg sr[1] = {{h, LDH, W, 0}};
  gemm_bias_relu<W / 16 / NWARPS>(sr, 1, w + L.w[depth], W, b + L.b[depth], h, LDH, scratch);
  Seg s0[2] = {{h, LDH, W, 0}, {ed, LDD, KD, W}};
  gemm_bias_relu<HW / 16 / NWARPS>(s0, 2, w + L.w[depth + 2], W + KD, b + L.b[depth + 2], rf, LDR, scratch);
}

// rgb channel c of tile point p: sigmoid(wr1[c] . rf[p] + br1[c]).
__device__ float rgb_out(const bf16* __restrict__ w, const float* __restrict__ b,
                         const Layout& L, int depth, const bf16* rf, int p, int c) {
  const bf16* wr1 = w + L.w[depth + 3];
  float acc = 0.0f;
  for (int k = 0; k < HW; ++k)
    acc = fmaf(__bfloat162float(wr1[c * HW + k]), __bfloat162float(rf[p * LDR + k]), acc);
  return 1.0f / (1.0f + expf(-(acc + b[L.b[depth + 3] + c])));
}

inline Layout make_layout(const long long* offsets, int n) {
  Layout L = {};
  for (int i = 0; i < n; ++i) {
    L.w[i] = offsets[i];
    L.b[i] = offsets[n + i];
  }
  return L;
}

}  // namespace tgtc
