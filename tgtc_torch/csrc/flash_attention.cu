// Flash-attention forward for Hopper (sm_90a): K6.
//
// Replaces the TPU kernel of tgtc/ops/pallas/flash_attention.py:
//   K6  tgtc_flash_fwd  <- _fwd_call (body _fwd_kernel)
// The plain PyTorch twin of the same arithmetic lives beside the wrapper in
// tgtc_torch/ops/kernels/flash_attention.py (flash_attention_fwd_plain).
//
// Computes, per batch*head and query row, with q already scaled:
//   s = q k^T (f32 from bf16 operands); keys >= Sk get -1e30;
//   online softmax over key tiles: m_new = max(m, rowmax s),
//   p = exp(s - m_new), alpha = exp(m - m_new), l = l alpha + rowsum p
//   (l sums the UNDROPPED p); optional dropout: p = keep ? p / keep : 0,
//   keep from the murmur3 counter hash of (seed, bh, row, col);
//   acc = acc alpha + bf16(p) v;
//   o = bf16(acc / l), lse = m + log l (f32).
// q is scaled inside the kernel, in the order of _prep: bf16(q * scale) with
// the scale already rounded to q's type, before the first product.
//
// What bounds it: operations. 4 Sq Sk D FLOP against (2 Sq + 2 Sk) D bf16
// values and Sq f32 of I/O: at the C3 shape (8 heads, Sq = Sk = 11,970,
// D 64) 2.934e11 FLOP and 49 MB, 0.297 ms at the bf16 tensor-core peak and
// 0.015 ms at the HBM rate. Its Sq Sk exponentials (1.15e9 at C3) are a
// second floor of about the same size on the SFUs.
//
// Design (first, simple version): one block of four warps per (bh, 64 query
// rows); each warp owns 16 rows and keeps its Q fragments, its S tile
// (16 x 64) and its O accumulator (16 x 64) in registers, as mma.sync
// m16n8k16 bf16 fragments with f32 accumulation, so the S tile's C layout
// is reused as the A operand of P V without a trip through shared memory.
// K/V tiles of 64 keys are staged through shared memory (V transposed, rows
// padded to 72 values so the 32-bit fragment loads are bank-conflict free),
// loaded synchronously: several blocks per SM hide the latency. Tails need
// no padding: key rows >= Sk are zero-filled in shared memory and masked to
// -1e30, query rows >= Sq read zeros and are never written. q, k, v and o
// are addressed through (batch, head, row) strides with D contiguous, so
// the [B, S, H, D] layout of the projections needs no transposes. wgmma,
// TMA and pipelining are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int LDS = D + 8;  // shared row pitch in bf16 values (144 B)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // element strides; the head dimension is contiguous
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// _dropout_mask of the TPU kernel, bit for bit: uint32 arithmetic that wraps
// mod 2^32, murmur3 fmix32, keep when the draw is >= thr.
__device__ __forceinline__ bool keep_elem(uint32_t row, uint32_t col, uint32_t salt,
                                          uint32_t thr) {
  uint32_t x = (row * 0x9E3779B9u) ^ (col * 0x85EBCA6Bu) ^ salt;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thr;
}

// Register fragments of one warp, lane = 4 g + t:
//   A (16x16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16x8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16x8):  c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
template <bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk, Strides qs, Strides ks_, Strides vs, Strides os,
                 float scale, uint32_t seed, uint32_t thr, float inv_keep) {
  __shared__ __align__(16) bf16 ks[BK * LDS];  // K tile, ks[key][d]
  __shared__ __align__(16) bf16 vt[D * LDS];   // V tile transposed, vt[d][key]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ + warp * 16;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const uint32_t salt = seed + (uint32_t)bh * 0xC2B2AE35u;

  // this warp's 16 query rows as A fragments, bf16(q * scale)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + (i & 1) * 8, col = kk * 16 + 2 * t + (i >> 1) * 8;
      float x0 = 0.0f, x1 = 0.0f;
      if (row < Sq) {
        const bf16* p = qb + row * qs.s + col;
        x0 = __bfloat162float(p[0]) * scale;
        x1 = __bfloat162float(p[1]) * scale;
      }
      qa[kk][i] = pack_bf16(x0, x1);
    }
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int ntiles = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < BK * D / 8; c += NTHREADS) {
      const int r = c / (D / 8), d0 = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * ks_.s + d0);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * vs.s + d0);
      }
      *reinterpret_cast<uint4*>(&ks[r * LDS + d0]) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(d0 + j) * LDS + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T: eight 16x8 tiles over the tile's 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* kr = &ks[(n * 8 + g) * LDS + kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask the keys past Sk, then the new row maxima (rows g and g + 8)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + n * 8 + 2 * t + (e & 1) >= Sk) s[n][e] = NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }

    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[n][e] - mx[e >> 1]) * LOG2E);
        rs[e >> 1] += p;
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }

    if (DROPOUT) {  // after the normalizer: only the p that meets V is dropped
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t row = (uint32_t)(q0 + g + (e >> 1) * 8);
          const uint32_t col = (uint32_t)(k0 + n * 8 + 2 * t + (e & 1));
          s[n][e] = keep_elem(row, col, salt, thr) ? s[n][e] * inv_keep : 0.0f;
        }
      }
    }

    // acc = acc * alpha + bf16(P) V; P's C fragments are A fragments of P V
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vr = &vt[(n * 8 + g) * LDS + kk * 16 + 2 * t];
        mma_bf16(acc[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + r * 8;
    if (row >= Sq) continue;
    bf16* orow = o + b * os.b + h * os.h + (long long)row * os.s;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r]);
    if (t == 0) lse[(long long)bh * Sq + row] = m[r] + logf(l[r]);
  }
}

}  // namespace

// q [B, H, Sq, 64], k/v [B, H, Sk, 64], o [B, H, Sq, 64] bf16, each given by
// element strides (batch, head, row; 12 values in that order for q, k, v,
// o) with the head dimension contiguous; rows 16-byte aligned for k and v.
// lse [B * H, Sq] f32. scale: sm_scale rounded to bf16. dropout != 0 drops
// where the hash draw is < thr and scales the rest by inv_keep. Returns
// cudaGetLastError() after the launch.
extern "C" int tgtc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int H, int Sq, int Sk, const long long* strides,
                              float scale, int dropout, unsigned int seed, unsigned int thr,
                              float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]}, ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]}, os{strides[9], strides[10], strides[11]};
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  if (dropout)
    flash_fwd_kernel<true><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        qp, kp, vp, op, lse, H, Sq, Sk, qs, ks, vs, os, scale, seed, thr, inv_keep);
  else
    flash_fwd_kernel<false><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        qp, kp, vp, op, lse, H, Sq, Sk, qs, ks, vs, os, scale, seed, thr, inv_keep);
  return (int)cudaGetLastError();
}
