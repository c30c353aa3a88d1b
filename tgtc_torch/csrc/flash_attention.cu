// Flash attention for Hopper (sm_90a): the forward K6 and the backward K7
// (dQ) and K8 (dK, dV).
//
// Replaces the TPU kernels of tgtc/ops/pallas/flash_attention.py:
//   K6  tgtc_flash_fwd      <- _fwd_call (body _fwd_kernel)
//   K7  tgtc_flash_bwd_dq   <- _bwd_call's dq call (body _dq_kernel)
//   K8  tgtc_flash_bwd_dkv  <- _bwd_call's dkv call (body _dkv_kernel)
// The plain PyTorch twins of the same arithmetic live beside the wrappers in
// tgtc_torch/ops/kernels/flash_attention.py (flash_attention_fwd_plain,
// flash_attention_bwd_dq_plain, flash_attention_bwd_dkv_plain).
//
// K6 computes, per batch*head and query row, with q already scaled:
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
//
// K7 and K8 (the comments at each kernel give the arithmetic) follow the
// same design: one block of four warps per (bh, 64 rows) of the output,
// each warp's 16 rows of the fixed operands and its f32 accumulators in
// registers, the walked operand's 64-row tiles through shared memory, row-
// major for the A B^T products and transposed for the (C-fragment) B
// products. Neither needs atomics, so a launch repeats bit for bit. Both
// regenerate the dropout mask from the hash of the absolute (query row, key
// col), as K6 drew it. Bound: operations. K7 makes 3 products (6 Sq Sk D
// FLOP), K8 4 (8 Sq Sk D); at the C1 shape (64 batch*heads, 1,024^2, D 64)
// 2.58e10 and 3.44e10 FLOP, 0.026 and 0.035 ms at the bf16 peak, against
// about 42 MB of I/O each (0.0125 ms at the HBM rate).

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

// The hash's per-(seed, batch*head) term. The seed is one int32 in device
// memory, so a caller can draw it on the device without a host sync.
__device__ __forceinline__ uint32_t dropout_salt(const int* seed, int bh) {
  return (uint32_t)seed[0] + (uint32_t)bh * 0xC2B2AE35u;
}

// One 64-row tile of a [rows, 64] bf16 operand into shared memory: rows
// >= n are zero-filled (NaN x 0 is NaN, so the tail must be real zeros);
// row-major in `rm` ([row][d]) if given, transposed in `tr` ([d][row]) if
// given, and multiplied by `scale` with one bf16 rounding if SCALE.
template <bool SCALE>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ base, long long stride,
                                          int r0, int n, float scale, bf16* rm, bf16* tr) {
  for (int c = threadIdx.x; c < 64 * D / 8; c += NTHREADS) {
    const int r = c / (D / 8), d0 = (c % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) x = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * stride + d0);
    bf16* e = reinterpret_cast<bf16*>(&x);
    if (SCALE) {
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    if (rm) *reinterpret_cast<uint4*>(&rm[r * LDS + d0]) = x;
    if (tr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(d0 + j) * LDS + r] = e[j];
    }
  }
}

// Sixteen rows of a [rows, 64] bf16 operand as the A fragments of one warp
// (rows >= n read as zeros), multiplied by `scale` with one bf16 rounding.
__device__ __forceinline__ void load_a(const bf16* __restrict__ base, long long stride, int r0,
                                       int n, float scale, uint32_t a[D / 16][4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + (i & 1) * 8, col = kk * 16 + 2 * t + (i >> 1) * 8;
      float x0 = 0.0f, x1 = 0.0f;
      if (row < n) {
        const bf16* p = base + row * stride + col;
        x0 = __bfloat162float(p[0]) * scale;
        x1 = __bfloat162float(p[1]) * scale;
      }
      a[kk][i] = pack_bf16(x0, x1);
    }
  }
}

// C (16 x 64) += A (16 x 64, fragments) B^T, B's 64 rows in shared memory
// as [n][k] with pitch LDS: eight 16x8 tiles of four k16 steps.
__device__ __forceinline__ void mma_abt(float c[8][4], const uint32_t a[D / 16][4],
                                        const bf16* bsm) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* br = &bsm[(n * 8 + g) * LDS + kk * 16 + 2 * t];
      mma_bf16(c[n], a[kk], *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// C (16 x 64) += bf16(X) B, X a 16 x 64 f32 tile in C-fragment layout
// (reused as A fragments without a trip through shared memory) and B
// given transposed in shared memory as [n][k] with pitch LDS.
__device__ __forceinline__ void mma_cb(float c[8][4], const float x[8][4], const bf16* btr) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* br = &btr[(n * 8 + g) * LDS + kk * 16 + 2 * t];
      mma_bf16(c[n], a, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// Sixteen rows of a 16 x 64 f32 accumulator (C fragments) to bf16 rows
// r0.. of `base` (rows >= n are not written), each value times `scale`
// after a first bf16 rounding when RESCALE.
template <bool RESCALE>
__device__ __forceinline__ void store_rows(bf16* __restrict__ base, long long stride, int r0,
                                           int n, const float acc[8][4], float scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + r * 8;
    if (row >= n) continue;
    bf16* out = base + (long long)row * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float x0 = acc[j][2 * r], x1 = acc[j][2 * r + 1];
      if (RESCALE) {
        x0 = __bfloat162float(__float2bfloat16(x0)) * scale;
        x1 = __bfloat162float(__float2bfloat16(x1)) * scale;
      }
      *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t) = pack_bf16(x0, x1);
    }
  }
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
                 float scale, const int* __restrict__ seed, uint32_t thr, float inv_keep) {
  __shared__ __align__(16) bf16 ks[BK * LDS];  // K tile, ks[key][d]
  __shared__ __align__(16) bf16 vt[D * LDS];   // V tile transposed, vt[d][key]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ + warp * 16;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const uint32_t salt = DROPOUT ? dropout_salt(seed, bh) : 0u;

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


// K7: dQ of one block of four warps per (bh, 64 query rows), each warp 16
// rows with its Q (scaled) and dO fragments, its lse and delta, and a
// 16 x 64 f32 dQ accumulator in registers; K/V tiles of 64 keys pass
// through shared memory (K also transposed, the B operand of dS K). Per
// tile, as _dq_kernel: s = q k^T, p = exp(s - lse) (0 past Sk),
// dp = dO v^T masked and scaled by 1/keep under dropout, ds = p (dp - delta)
// with the undropped p, dq += bf16(ds) k. dq = bf16(bf16(dq) scale): the
// sm_scale of _flash_bwd applied in q's type.
template <bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Sq, int Sk, Strides qs, Strides ks_,
                    Strides vs, Strides dos, Strides dqs, float scale,
                    const int* __restrict__ seed, uint32_t thr, float inv_keep) {
  __shared__ __align__(16) bf16 ksm[BK * LDS];  // K tile, [key][d]
  __shared__ __align__(16) bf16 ktr[D * LDS];   // K tile transposed, [d][key]
  __shared__ __align__(16) bf16 vsm[BK * LDS];  // V tile, [key][d]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ + warp * 16;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const uint32_t salt = DROPOUT ? dropout_salt(seed, bh) : 0u;

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a(q + b * qs.b + h * qs.h, qs.s, q0, Sq, scale, qa);
  load_a(dout + b * dos.b + h * dos.h, dos.s, q0, Sq, 1.0f, da);
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + r * 8;
    lr[r] = row < Sq ? lse[(long long)bh * Sq + row] : 0.0f;
    dr[r] = row < Sq ? delta[(long long)bh * Sq + row] : 0.0f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int ntiles = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<false>(kb, ks_.s, k0, Sk, 1.0f, ksm, ktr);
    load_tile<false>(vb, vs.s, k0, Sk, 1.0f, vsm, nullptr);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
    mma_abt(s, qa, ksm);   // S = Q K^T
    mma_abt(dp, da, vsm);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1), r = e >> 1;
        const float p = col < Sk ? exp2f((s[n][e] - lr[r]) * LOG2E) : 0.0f;
        float d = dp[n][e];
        if (DROPOUT)
          d = keep_elem((uint32_t)(q0 + g + r * 8), (uint32_t)col, salt, thr) ? d * inv_keep
                                                                             : 0.0f;
        s[n][e] = p * (d - dr[r]);  // dS, from the undropped p
      }
    }
    mma_cb(acc, s, ktr);  // dQ += bf16(dS) K
  }
  store_rows<true>(dq + b * dqs.b + h * dqs.h, dqs.s, q0, Sq, acc, scale);
}

// K8: dK and dV of one block of four warps per (bh, 64 key rows), each
// warp 16 keys with its K and V fragments and two 16 x 64 f32 accumulators
// in registers, walking every query tile of 64 rows (Q scaled, and dO, both
// also transposed, with their lse and delta, through shared memory). The
// products are taken transposed, keys as rows: s^T = k q^T,
// p^T = exp(s^T - lse) (0 for query rows >= Sq), dp^T = v dO^T; under
// dropout the mask of (query row, key col) -- the same bits K6 drew -- gives
// pd = mask p / keep and masks and scales dp; dv += bf16(pd)^T dO,
// ds = p (dp - delta), dk += bf16(ds)^T q, as _dkv_kernel.
template <bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk,
                     Strides qs, Strides ks_, Strides vs, Strides dos, Strides dks, Strides dvs,
                     float scale, const int* __restrict__ seed, uint32_t thr, float inv_keep) {
  __shared__ __align__(16) bf16 qsm[BQ * LDS];  // Q tile (scaled), [query][d]
  __shared__ __align__(16) bf16 qtr[D * LDS];   // the same transposed, [d][query]
  __shared__ __align__(16) bf16 dsm[BQ * LDS];  // dO tile, [query][d]
  __shared__ __align__(16) bf16 dtr[D * LDS];   // the same transposed, [d][query]
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK + warp * 16;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* db = dout + b * dos.b + h * dos.h;
  const uint32_t salt = DROPOUT ? dropout_salt(seed, bh) : 0u;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a(k + b * ks_.b + h * ks_.h, ks_.s, k0, Sk, 1.0f, ka);
  load_a(v + b * vs.b + h * vs.h, vs.s, k0, Sk, 1.0f, va);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = dva[n][0] = dva[n][1] = dva[n][2] =
        dva[n][3] = 0.0f;

  const int ntiles = (Sq + BQ - 1) / BQ;
  for (int qt = 0; qt < ntiles; ++qt) {
    const int r0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<true>(qb, qs.s, r0, Sq, scale, qsm, qtr);
    load_tile<false>(db, dos.s, r0, Sq, 1.0f, dsm, dtr);
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const bool in = r0 + i < Sq;
      lse_s[i] = in ? lse[(long long)bh * Sq + r0 + i] : 0.0f;
      delta_s[i] = in ? delta[(long long)bh * Sq + r0 + i] : 0.0f;
    }
    __syncthreads();

    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
    mma_abt(s, ka, qsm);   // S^T = K Q^T
    mma_abt(dp, va, dsm);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), row = r0 + c;
        const float p = row < Sq ? exp2f((s[n][e] - lse_s[c]) * LOG2E) : 0.0f;
        float pd = p, d = dp[n][e];
        if (DROPOUT) {
          const bool keep = keep_elem((uint32_t)row, (uint32_t)(k0 + g + (e >> 1) * 8), salt, thr);
          pd = keep ? p * inv_keep : 0.0f;
          d = keep ? d * inv_keep : 0.0f;
        }
        s[n][e] = pd;
        dp[n][e] = p * (d - delta_s[c]);  // dS^T, from the undropped p
      }
    }
    mma_cb(dva, s, dtr);   // dV += bf16(pd)^T dO
    mma_cb(dka, dp, qtr);  // dK += bf16(dS)^T Q
  }
  store_rows<false>(dk + b * dks.b + h * dks.h, dks.s, k0, Sk, dka, 1.0f);
  store_rows<false>(dv + b * dvs.b + h * dvs.h, dvs.s, k0, Sk, dva, 1.0f);
}

}  // namespace

// q [B, H, Sq, 64], k/v [B, H, Sk, 64], o [B, H, Sq, 64] bf16, each given by
// element strides (batch, head, row; 12 values in that order for q, k, v,
// o) with the head dimension contiguous; rows 16-byte aligned for k and v.
// lse [B * H, Sq] f32. scale: sm_scale rounded to bf16. dropout != 0 drops
// where the hash draw is < thr and scales the rest by inv_keep; seed points
// to the hash's int32 seed in device memory (read only under dropout).
// Returns cudaGetLastError() after the launch.
extern "C" int tgtc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int H, int Sq, int Sk, const long long* strides,
                              float scale, int dropout, const int* seed, unsigned int thr,
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

namespace {

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

// K7. q, k, v, dO [B, H, S, 64] and dq [B, H, Sq, 64] bf16 with (batch,
// head, row) element strides, 15 values for q, k, v, dO, dq in that order,
// the head dimension contiguous, rows 16-byte aligned for k and v; lse and
// delta = rowsum(dO o) [B * H, Sq] f32; the rest as tgtc_flash_fwd.
extern "C" int tgtc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq, int B, int H,
                                 int Sq, int Sk, const long long* strides, float scale,
                                 int dropout, const int* seed, unsigned int thr, float inv_keep,
                                 void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  auto kernel = dropout ? flash_bwd_dq_kernel<true> : flash_bwd_dq_kernel<false>;
  kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, Sq, Sk,
      strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
      strides_at(strides, 3), strides_at(strides, 4), scale, seed, thr, inv_keep);
  return (int)cudaGetLastError();
}

// K8. As K7, with dk, dv [B, H, Sk, 64] bf16: 18 strides for q, k, v, dO,
// dk, dv in that order; q and dO rows 16-byte aligned.
extern "C" int tgtc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv,
                                  int B, int H, int Sq, int Sk, const long long* strides,
                                  float scale, int dropout, const int* seed, unsigned int thr,
                                  float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Sk <= 0) return 0;
  if (Sq <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Sk + BK - 1) / BK), (unsigned)(B * H));
  auto kernel = dropout ? flash_bwd_dkv_kernel<true> : flash_bwd_dkv_kernel<false>;
  kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Sk, strides_at(strides, 0), strides_at(strides, 1),
      strides_at(strides, 2), strides_at(strides, 3), strides_at(strides, 4),
      strides_at(strides, 5), scale, seed, thr, inv_keep);
  return (int)cudaGetLastError();
}
