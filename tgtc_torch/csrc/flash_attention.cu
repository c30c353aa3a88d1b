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
//   keep from the murmur3 counter hash of (seed, bh + bh_offset, row, col);
//   acc = acc alpha + bf16(p) v;
//   o = bf16(acc / l), lse = m + log l (f32).
// q is scaled inside the kernel, in the order of _prep: bf16(q * scale) with
// the scale already rounded to q's type (any scale), before the first
// product.
//
// What bounds them: the largest of four floors (chip_smoke.flash_bound_ms),
// at the card's 1,980 MHz maximum SM clock:
//   tensor cores: 2 Sq Sk D FLOP per product, 2 products for K6, 3 for K7,
//     4 for K8, at the bf16 dense peak;
//   HBM: every input read once, every output written once (K6: q, k, v in,
//     o out in bf16, lse out in f32; K7/K8: q, k, v, dO, lse, delta in, dq
//     or dk, dv out);
//   SFU: one ex2 per element of S at 16 a clock per SM;
//   INT32, under dropout only: keep_hash's 10 integer operations per
//     element (one 3-input xor, three shift-xor pairs, two multiplies, one
//     compare; the row and column products are hoisted) at 64 a clock per SM.
// K6 at the C3 shape (8 heads, Sq = Sk = 11,970, D 64): tensor 2.934e11
// FLOP, 0.297 ms -- the binding floor, with the SFU's 1.146e9 exponentials,
// 0.274 ms, right below it; HBM 49 MB, 0.015 ms. K6 at the C1 shape (64
// batch*heads, Sq = Sk = 1,024; 6.7e7 elements of S): with dropout 0.1 the
// INT32 floor binds, 0.040 ms; without it the tensor cores, 0.017 ms (SFU
// 0.016 ms). K7 and K8 at C1: tensor 2.58e10 and 3.44e10 FLOP,
// 0.026 and 0.035 ms; HBM 42 and 51 MB; SFU 0.016 ms; INT32 0.040 ms, the
// binding floor with dropout.
//
// Design of all three: warp-specialized blocks, one per SM: consumer
// warpgroups of 64 output rows each and one producer warpgroup whose first
// warp issues TMA; setmaxnreg moves registers from the producer to the
// consumers. The producer brings the block's fixed operands once by TMA and
// streams the walked operands, 64 rows a slot, through a ring of STAGES
// slots on full/empty mbarriers. TMA descriptors are 4-D (d, row, head,
// batch) maps over the (batch, head, row) strides the entry points
// receive, with the 128-byte swizzle (a 64-wide bf16 row is 128 B), so the
// [B, S, H, D] projections seen through a transpose load as they lie; rows
// past S arrive as zeros (TMA's out-of-bounds fill) and are never written.
// Every product is a wgmma with f32 accumulators; wgmma's accumulator
// repeats the mma.sync C pattern for each warp's 16 rows, so an f32
// accumulator repacks as the bf16 A fragments of the next product. No
// operand is transposed in shared memory: B is read K-major, or MN-major
// through the descriptor's transpose bit. A slot is released when every
// consumer's last product on it has completed.
//
// K6 (flash_fwd_kernel): a block of 512 threads per (bh, 192 query rows):
// three consumer warpgroups at 160 registers and the producer at 24; q of
// the block's rows is its fixed operand, k and v tiles of 64 keys its
// walked ones. Each consumer reads its 64 rows of q once from the swizzled
// tile, scales them in f32 by any bf16 scale and keeps bf16(q scale) as A
// fragments, so S = q k^T is a wgmma m64n64k16 with A from registers and k
// K-major, and P V one with P's A fragments from registers and v MN-major.
// The online softmax stays in f32 registers (row max and sum by two xor
// shuffles, one FFMA and one ex2 an element); keys >= Sk are masked in the
// last tile only. The consumers take turns on the tensor cores: named
// barriers 1-3 let a consumer issue its products -- S of tile i, then P V
// of tile i - 1 -- only after the previous one has issued its own, so that
// the others' softmax runs while one's products run. Nothing overlaps
// inside one warpgroup: each waits for its products right after issuing
// them (ptxas serialized in-warpgroup pipelining in K7/K8). o is written
// from registers into [B, Sq, H, D] through its strides, lse in f32 [B*H,
// Sq]. Why 192 rows and 64 keys (FlashAttention-3's row count at D 64),
// as timed on an H100 against other builds of this kernel: 192-row blocks
// read k and v from L2 a third as often as 64-row ones, give 504 blocks at
// C3 (3.8 waves of 132 SMs), and let three warpgroups' softmax hide one
// another's products, where two consumers of 128 rows ran slower; S of 64
// keys (32 registers) fits 160 registers with P's fragments (16), q's (16)
// and the output (32), where 128-key tiles spilled.
//
// K7 and K8 (the comments at each kernel give the arithmetic) recompute
// S = q k^T and dP = dO v^T tile by tile and accumulate dq = dS k (K7, 3
// products: 6 Sq Sk D FLOP) or dv = P^T dO and dk = dS^T q (K8, 4
// products: 8 Sq Sk D FLOP). Neither needs atomics, so a launch repeats bit
// for bit. Both regenerate the dropout mask from the hash of the absolute
// (query row, key col), as K6 drew it. Blocks of 384 threads per (bh, 128
// rows of the output): two consumer warpgroups at 232 registers, the
// producer at 40; fixed operands K7: q and dO, K8: k and v (128 x 64 bf16
// each); walked K7: k and v tiles, K8: q and dO tiles with their lse and
// delta slices. Every product is a wgmma m64n64k16: S (or S^T = k q^T, keys
// as rows in K8) and dP from shared memory, both operands K-major; then dq
// += bf16(dS) k, dv += bf16(pd)^T dO and dk += bf16(dS)^T q with A from
// registers and B the same k, dO or q tile read MN-major. The scale must be
// a power of two (0.125 = 1/sqrt(64) on every path), so S is scaled in f32
// and dk's accumulator once at the end, which equals the products of
// bf16(q scale) exactly.

#include <math.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, setmaxnreg, the tensor-map encoder

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int BT = 64;                    // rows of a TMA box and of a streamed tile
constexpr int STAGES = 4;                 // slots of the ring
constexpr int TILE_BYTES = BT * D * 2;    // one 64 x 64 bf16 box, 8 KB
// K6: three consumer warpgroups of 64 query rows, then one producer
// warpgroup. setmaxnreg.inc waits for registers that a .dec released: the
// producer's 128 x (128 - 24) = 13,312 cover the consumers' 384 x (160 - 128)
// = 12,288, and 128 x 24 + 384 x 160 = 64,512 fit the SM's 65,536.
constexpr int FWD_CONSUMERS = 3;
constexpr int FWD_ROWS = 64 * FWD_CONSUMERS;  // query rows per block
constexpr int FWD_THREADS = 128 * (FWD_CONSUMERS + 1);
constexpr int FWD_PRODUCER_REGS = 24, FWD_CONSUMER_REGS = 160;
// K7/K8: two consumer warpgroups of 64 output rows, one producer warpgroup
constexpr int BROWS = 128;                // output rows per block
constexpr int BWD_THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 = 384 x 168

struct Strides {
  long long b, h, s;  // element strides; the head dimension is contiguous
};

// 2^x on the SFU (one MUFU.EX2; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// _dropout_mask of the TPU kernel, bit for bit: uint32 arithmetic that wraps
// mod 2^32, murmur3 fmix32, keep when the draw is >= thr. keep_hash takes
// (row * 0x9E3779B9) ^ (col * 0x85EBCA6B) ^ salt, so that a caller can hoist
// the row and column products.
__device__ __forceinline__ bool keep_hash(uint32_t x, uint32_t thr) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thr;
}

__device__ __forceinline__ uint32_t row_term(int row) { return (uint32_t)row * 0x9E3779B9u; }
__device__ __forceinline__ uint32_t col_term(int col) { return (uint32_t)col * 0x85EBCA6Bu; }

// The hash's per-(seed, batch*head) term, bh counted in the whole batch (the
// block's bh plus the launch's bh_offset). The seed is one int32 in device
// memory, so a caller can draw it on the device without a host sync.
__device__ __forceinline__ uint32_t dropout_salt(const int* seed, int bh) {
  return (uint32_t)seed[0] + (uint32_t)bh * 0xC2B2AE35u;
}

// ------------------------------------------- TMA and barriers of K6, K7, K8

// One 64-row box of a (d, row, head, batch) tensor map into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int h, int b) {
  tma_load_4d(dst, map, bar, 0, row, h, b);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// The barriers: `fixed` completes once the fixed operands have landed;
// full[s] when slot s holds its tile (TMA bytes, and in K8 the producer
// warp's 32 lse/delta stores); empty[s] when every consumer warp is done
// with it.
template <typename Smem>
__device__ __forceinline__ void init_barriers(Smem& sm, uint32_t full_count,
                                              uint32_t consumer_warps) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], full_count);
      mbar_init(&sm.empty[s], consumer_warps);
    }
    mbar_init(&sm.fixed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The 128 rows starting at `row` of a tensor map, as two 64-row boxes.
__device__ __forceinline__ void tma_rows128(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                            int row, int h, int b) {
  tma_load(dst, map, bar, row, h, b);
  tma_load(dst + BT * D, map, bar, row + BT, h, b);
}

// -------------------------------------------------------------------- K6

// Shared memory of K6: q of the block's 192 query rows, a ring of k and v
// tiles of 64 keys. Every tile starts on a 1 KB boundary.
struct FwdSmem {
  bf16 q[FWD_ROWS * D];
  bf16 k[STAGES][BT * D];
  bf16 v[STAGES][BT * D];
  uint64_t full[STAGES], empty[STAGES], fixed;
};

// The consumers' turns on the tensor cores, in the order of their indices:
// warpgroup wg waits on named barrier 1 + wg (256 threads: its own 128 at
// bar.sync, the previous warpgroup's 128 at bar.arrive) and passes the turn
// by arriving on the next one's barrier.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(1 + (wg + 1) % FWD_CONSUMERS) : "memory");
}

// The online softmax of one 64 x 64 tile of S (a warpgroup's; this thread's
// registers cover rows g and g + 8 of its warp): masks keys >= Sk in the
// last tile, updates the row max m and the normalizer l (undropped p),
// applies dropout, leaves bf16(p) as the A fragments of P V in pa and
// rescales the output accumulator o by exp(m_old - m_new).
template <bool DROPOUT>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[32], uint32_t (&pa)[4][4],
                                             float (&m)[2], float (&l)[2], int k0, int Sk, int t,
                                             const uint32_t (&rt)[2], uint32_t thr,
                                             float inv_keep) {
  if (k0 + BT > Sk) {  // the last tile: its keys >= Sk arrived as zeros
#pragma unroll
    for (int x = 0; x < 32; ++x)
      if (k0 + 8 * (x >> 2) + 2 * t + (x & 1) >= Sk) s[x] = NEG_INF;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int x = 0; x < 32; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
  float alpha[2], nb[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * LOG2E);
    nb[r] = -mx[r] * LOG2E;
    m[r] = mx[r];
  }
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const float p = ex2(fmaf(s[x], LOG2E, nb[(x >> 1) & 1]));  // exp(s - m)
    rs[(x >> 1) & 1] += p;
    s[x] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * alpha[r] + rs[r];
  }
  if (DROPOUT) {  // after the normalizer: only the p that meets v is dropped
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k0 + 8 * j + 2 * t;
      const uint32_t ct[2] = {col_term(c), col_term(c + 1)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = keep_hash(rt[e >> 1] ^ ct[e & 1], thr) ? s[4 * j + e] * inv_keep : 0.0f;
    }
  }
  to_a(s, pa);
#pragma unroll
  for (int x = 0; x < 32; ++x) o[x] *= alpha[(x >> 1) & 1];
}

// K6: o and lse of one block per (bh, 192 query rows); see the header.
template <bool DROPOUT>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, Strides os, float scale,
                 const int* __restrict__ seed, uint32_t thr, float inv_keep,
                 int bh_offset) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(align_1k(smem_raw));
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row_blk = blockIdx.x * FWD_ROWS;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int ntiles = (Sk + BT - 1) / BT;
  init_barriers(sm, 1, 4 * FWD_CONSUMERS);

  if (wg == FWD_CONSUMERS) {  // producer
    setmaxnreg_dec<FWD_PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      mbar_expect(&sm.fixed, FWD_CONSUMERS * TILE_BYTES);
#pragma unroll
      for (int c = 0; c < FWD_CONSUMERS; ++c)
        tma_load(sm.q + c * BT * D, &tq, &sm.fixed, row_blk + c * BT, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&sm.empty[s], (i / STAGES - 1) & 1);
        mbar_expect(&sm.full[s], 2 * TILE_BYTES);
        tma_load(sm.k[s], &tk, &sm.full[s], i * BT, h, b);
        tma_load(sm.v[s], &tv, &sm.full[s], i * BT, h, b);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<FWD_CONSUMER_REGS>();
    const int g = lane >> 2, t = lane & 3;
    const int r_thr = row_blk + wg * 64 + warp * 16 + g;  // rows r_thr and r_thr + 8
    const uint32_t salt = DROPOUT ? dropout_salt(seed, bh + bh_offset) : 0u;
    const uint32_t rt[2] = {row_term(r_thr) ^ salt, row_term(r_thr + 8) ^ salt};
    if (wg == FWD_CONSUMERS - 1) turn_pass(wg);  // warpgroup 0 takes the first turn

    // this warpgroup's 64 rows of bf16(q scale) as A fragments: element
    // (row, col) of the swizzled tile lies at row * 128 + ((col / 8) ^ (row
    // % 8)) * 16 + (col % 8) * 2 bytes, and row % 8 = g here
    mbar_wait(&sm.fixed, 0);
    __syncwarp();
    const uint8_t* qt = reinterpret_cast<const uint8_t*>(sm.q + wg * 64 * D);
    uint32_t qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = warp * 16 + g + 8 * (i & 1), col = kk * 16 + 2 * t + 8 * (i >> 1);
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            qt + row * 128 + (((col >> 3) ^ g) << 4) + (col & 7) * 2));
        qa[kk][i] = pack_bf16(f.x * scale, f.y * scale);
      }
    }

    float oa[32], s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) oa[i] = 0.0f;

    // turn 0: S of tile 0
    mbar_wait(&sm.full[0], 0);
    __syncwarp();
    turn_wait(wg);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_k(s, qa[kk], kmajor(sm.k[0], kk), kk > 0);
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    reg_fence(s);
    softmax_tile<DROPOUT>(s, oa, pa, m, l, 0, Sk, t, rt, thr, inv_keep);

    // turn i: S of tile i, then P V of tile i - 1
    for (int i = 1; i < ntiles; ++i) {
      const int sp = (i - 1) % STAGES, sn = i % STAGES;
      mbar_wait(&sm.full[sn], (i / STAGES) & 1);
      __syncwarp();
      turn_wait(wg);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_k(s, qa[kk], kmajor(sm.k[sn], kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(oa, pa[kk], mnmajor(sm.v[sp], kk));
      wg_commit();
      turn_pass(wg);
      wg_wait<0>();
      reg_fence(oa);
      reg_fence(s);
      release(&sm.empty[sp]);
      softmax_tile<DROPOUT>(s, oa, pa, m, l, i * BT, Sk, t, rt, thr, inv_keep);
    }

    // P V of the last tile, outside the turns; warpgroup 0 takes the last
    // warpgroup's last pass, so that every arrival on a named barrier is
    // consumed
    if (wg == 0) turn_wait(0);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t(oa, pa[kk], mnmajor(sm.v[(ntiles - 1) % STAGES], kk));
    wg_commit();
    wg_wait<0>();
    reg_fence(oa);

    bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_thr + 8 * r;
      if (row >= Sq) continue;
      bf16* orow = ob + (long long)row * os.s;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(oa[4 * j + 2 * r] / l[r], oa[4 * j + 2 * r + 1] / l[r]);
      if (t == 0) lse[(long long)bh * Sq + row] = m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------- K7, K8

// Shared memory of K7: q and dO of the block's 128 query rows, a ring of k
// and v tiles. Every tile starts on a 1 KB boundary (the swizzle atom).
struct DqSmem {
  bf16 q[BROWS * D];
  bf16 dout[BROWS * D];
  bf16 k[STAGES][BT * D];
  bf16 v[STAGES][BT * D];
  uint64_t full[STAGES], empty[STAGES], fixed;
};

// Shared memory of K8: k and v of the block's 128 keys, a ring of q and dO
// tiles with the lse and delta of their 64 query rows.
struct DkvSmem {
  bf16 k[BROWS * D];
  bf16 v[BROWS * D];
  bf16 q[STAGES][BT * D];
  bf16 dout[STAGES][BT * D];
  float lse[STAGES][BT];
  float delta[STAGES][BT];
  uint64_t full[STAGES], empty[STAGES], fixed;
};

// K7: dQ of one block per (bh, 128 query rows). Each consumer warpgroup owns
// 64 rows: S = q k^T and dP = dO v^T (wgmma from shared memory) for each
// streamed tile of 64 keys; as _dq_kernel, p = exp(s scale - lse) (0 past
// Sk), dp masked and scaled by 1/keep under dropout, ds = p (dp - delta)
// with the undropped p, dq += bf16(ds) k (A from registers, k read
// MN-major). dq = bf16(bf16(dq) scale): the sm_scale of _flash_bwd applied
// in q's type.
template <bool DROPOUT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Sq, int Sk, Strides dqs, float scale,
                    const int* __restrict__ seed, uint32_t thr, float inv_keep,
                    int bh_offset) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(align_1k(smem_raw));
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row_blk = blockIdx.x * BROWS;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int ntiles = (Sk + BT - 1) / BT;
  init_barriers(sm, 1, 8);

  if (wg == 2) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      mbar_expect(&sm.fixed, 4 * TILE_BYTES);
      tma_rows128(sm.q, &tq, &sm.fixed, row_blk, h, b);
      tma_rows128(sm.dout, &tdo, &sm.fixed, row_blk, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&sm.empty[s], (i / STAGES - 1) & 1);
        mbar_expect(&sm.full[s], 2 * TILE_BYTES);
        tma_load(sm.k[s], &tk, &sm.full[s], i * BT, h, b);
        tma_load(sm.v[s], &tv, &sm.full[s], i * BT, h, b);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int g = lane >> 2, t = lane & 3;
    const int r_thr = row_blk + wg * 64 + warp * 16 + g;  // rows r_thr and r_thr + 8
    const uint32_t salt = DROPOUT ? dropout_salt(seed, bh + bh_offset) : 0u;
    float lr[2], dr[2];
    uint32_t rt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_thr + 8 * r;
      lr[r] = row < Sq ? lse[(long long)bh * Sq + row] : pos_inf();  // p = 0 past Sq
      dr[r] = row < Sq ? delta[(long long)bh * Sq + row] : 0.0f;
      rt[r] = row_term(row) ^ salt;
    }
    const bf16* qw = sm.q + wg * 64 * D;
    const bf16* dw = sm.dout + wg * 64 * D;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    mbar_wait(&sm.fixed, 0);
    __syncwarp();

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES, k0 = i * BT;
      mbar_wait(&sm.full[s], (i / STAGES) & 1);
      __syncwarp();  // converged again for the .aligned wgmma instructions
      float sc[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, kmajor(qw, kk), kmajor(sm.k[s], kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, kmajor(dw, kk), kmajor(sm.v[s], kk), kk > 0);
      wg_commit();
      wg_wait<1>();
      reg_fence(sc);
      const bool tail = k0 + BT > Sk;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          const float p = exp2f((sc[x] * scale - lr[e >> 1]) * LOG2E);
          sc[x] = (tail && k0 + 8 * j + 2 * t + (e & 1) >= Sk) ? 0.0f : p;
        }
      }
      wg_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + 8 * j + 2 * t;
        const uint32_t ct[2] = {col_term(c), col_term(c + 1)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          float d = dp[x];
          if (DROPOUT) d = keep_hash(rt[e >> 1] ^ ct[e & 1], thr) ? d * inv_keep : 0.0f;
          sc[x] = sc[x] * (d - dr[e >> 1]);  // dS, from the undropped p
        }
      }
      uint32_t a[4][4];
      to_a(sc, a);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(acc, a[kk], mnmajor(sm.k[s], kk));
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
      release(&sm.empty[s]);
    }

    bf16* out = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_thr + 8 * r;
      if (row >= Sq) continue;
      bf16* o = out + (long long)row * dqs.s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x0 = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * r])) * scale;
        const float x1 = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * r + 1])) * scale;
        *reinterpret_cast<uint32_t*>(o + 8 * j + 2 * t) = pack_bf16(x0, x1);
      }
    }
  }
}

// K8: dK and dV of one block per (bh, 128 key rows). Each consumer
// warpgroup owns 64 keys and walks every streamed tile of 64 query rows,
// taking the products transposed, keys as rows: s^T = k q^T, p^T =
// exp(s^T scale - lse) (0 for query rows >= Sq: their lse reads +inf),
// dp^T = v dO^T; under dropout the mask of (query row, key col) -- the same
// bits K6 drew -- gives pd = mask p / keep and masks and scales dp;
// dv += bf16(pd)^T dO, ds = p (dp - delta), dk += bf16(ds)^T q, as
// _dkv_kernel; dk = bf16(dk scale) at the end (q's power-of-two scale
// taken out of the products).
template <bool DROPOUT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Sk, Strides dks, Strides dvs,
                     float scale, const int* __restrict__ seed, uint32_t thr, float inv_keep,
                     int bh_offset) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(align_1k(smem_raw));
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key_blk = blockIdx.x * BROWS;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int ntiles = (Sq + BT - 1) / BT;
  init_barriers(sm, 1 + 32, 8);  // the TMA arrival and the producer warp's 32 lanes

  if (wg == 2) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect(&sm.fixed, 4 * TILE_BYTES);
        tma_rows128(sm.k, &tk, &sm.fixed, key_blk, h, b);
        tma_rows128(sm.v, &tv, &sm.fixed, key_blk, h, b);
      }
      const float* lrow = lse + (long long)bh * Sq;
      const float* drow = delta + (long long)bh * Sq;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES, r0 = i * BT;
        if (i >= STAGES) mbar_wait(&sm.empty[s], (i / STAGES - 1) & 1);
        if (lane == 0) {
          mbar_expect(&sm.full[s], 2 * TILE_BYTES);
          tma_load(sm.q[s], &tq, &sm.full[s], r0, h, b);
          tma_load(sm.dout[s], &tdo, &sm.full[s], r0, h, b);
        }
#pragma unroll
        for (int r = lane; r < BT; r += 32) {
          const bool in = r0 + r < Sq;
          sm.lse[s][r] = in ? lrow[r0 + r] : pos_inf();  // p = 0 past Sq
          sm.delta[s][r] = in ? drow[r0 + r] : 0.0f;
        }
        mbar_arrive(&sm.full[s]);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int g = lane >> 2, t = lane & 3;
    const int k_thr = key_blk + wg * 64 + warp * 16 + g;  // keys k_thr and k_thr + 8
    const uint32_t salt = DROPOUT ? dropout_salt(seed, bh + bh_offset) : 0u;
    const uint32_t kt[2] = {col_term(k_thr) ^ salt, col_term(k_thr + 8) ^ salt};
    const bf16* kw = sm.k + wg * 64 * D;
    const bf16* vw = sm.v + wg * 64 * D;
    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.0f;
    mbar_wait(&sm.fixed, 0);
    __syncwarp();

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES, r0 = i * BT;
      mbar_wait(&sm.full[s], (i / STAGES) & 1);
      __syncwarp();  // converged again for the .aligned wgmma instructions
      float sc[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, kmajor(kw, kk), kmajor(sm.q[s], kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, kmajor(vw, kk), kmajor(sm.dout[s], kk), kk > 0);
      wg_commit();
      wg_wait<1>();
      reg_fence(sc);
      float lc[16];  // lse of this thread's 16 query columns
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[s][8 * j + 2 * t]);
        lc[2 * j] = l2.x;
        lc[2 * j + 1] = l2.y;
      }
#pragma unroll
      for (int x = 0; x < 32; ++x)
        sc[x] = exp2f((sc[x] * scale - lc[2 * (x / 4) + (x & 1)]) * LOG2E);
      wg_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 d2 = *reinterpret_cast<const float2*>(&sm.delta[s][c]);
        const uint32_t rt[2] = {row_term(r0 + c), row_term(r0 + c + 1)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          const float p = sc[x];
          float pd = p, d = dp[x];
          if (DROPOUT) {
            const bool keep = keep_hash(rt[e & 1] ^ kt[e >> 1], thr);
            pd = keep ? p * inv_keep : 0.0f;
            d = keep ? d * inv_keep : 0.0f;
          }
          sc[x] = pd;
          dp[x] = p * (d - ((e & 1) ? d2.y : d2.x));  // dS^T, from the undropped p
        }
      }
      uint32_t apd[4][4], ads[4][4];
      to_a(sc, apd);
      to_a(dp, ads);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(dva, apd[kk], mnmajor(sm.dout[s], kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(dka, ads[kk], mnmajor(sm.q[s], kk));
      wg_commit();
      wg_wait<0>();
      reg_fence(dva);
      reg_fence(dka);
      release(&sm.empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k_thr + 8 * r;
      if (key >= Sk) continue;
      bf16* ko = dk + b * dks.b + h * dks.h + (long long)key * dks.s;
      bf16* vo = dv + b * dvs.b + h * dvs.h + (long long)key * dvs.s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(ko + 8 * j + 2 * t) =
            pack_bf16(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(vo + 8 * j + 2 * t) =
            pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ host side

// A (d, row, head, batch) map of a bf16 [B, H, rows, 64] tensor given by
// element strides, 64 x 64 boxes, 128-byte swizzle, zeros out of bounds. A
// dimension of extent 1 is never stepped, so its stride may be anything;
// it is given one TMA takes.
bool make_map(CUtensorMap* map, const void* base, int rows, int H, int B, Strides st) {
  static const EncodeTiled encode = encode_fn();
  if (!encode) return false;
  auto bytes = [](long long stride, int n) { return (cuuint64_t)(n == 1 ? 128 : stride * 2); };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(st.s, rows), bytes(st.h, H), bytes(st.b, B)};
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)BT, 1, 1}, ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

bool pow2(float x) {
  int e;
  return x != 0.0f && isfinite(x) && frexpf(fabsf(x), &e) == 0.5f;
}

}  // namespace

// q [B, H, Sq, 64], k/v [B, H, Sk, 64], o [B, H, Sq, 64] bf16, each given by
// element strides (batch, head, row; 12 values in that order for q, k, v,
// o) with the head dimension contiguous; rows and bases 16-byte aligned for
// q, k and v (they are read by TMA). lse [B * H, Sq] f32. scale: sm_scale
// rounded to bf16, any value. dropout != 0 drops where the hash draw is <
// thr and scales the rest by inv_keep; seed points to the hash's int32 seed
// in device memory (read only under dropout). bh_offset is added to each
// batch*head index the hash takes, so that a launch on rows b0.. of a batch
// draws the masks those rows have in the whole batch (b0 * H; 0 for a whole
// batch). Returns cudaGetLastError() after the launch.
extern "C" int tgtc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int H, int Sq, int Sk, const long long* strides,
                              float scale, int dropout, const int* seed, unsigned int thr,
                              float inv_keep, int bh_offset, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, Sq, H, B, strides_at(strides, 0)) ||
      !make_map(&mk, k, Sk, H, B, strides_at(strides, 1)) ||
      !make_map(&mv, v, Sk, H, B, strides_at(strides, 2)))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(FwdSmem) + 1024;  // + the slack of the 1 KB alignment
  auto kernel = dropout ? flash_fwd_kernel<true> : flash_fwd_kernel<false>;
  // Set on every launch: the attribute belongs to the current device's context.
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)((Sq + FWD_ROWS - 1) / FWD_ROWS), (unsigned)(B * H));
  kernel<<<grid, FWD_THREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, H, Sq, Sk, strides_at(strides, 3), scale, seed,
      thr, inv_keep, bh_offset);
  return (int)cudaGetLastError();
}

// K7. q, k, v, dO [B, H, S, 64] and dq [B, H, Sq, 64] bf16 with (batch,
// head, row) element strides, 15 values for q, k, v, dO, dq in that order,
// the head dimension contiguous, rows and bases 16-byte aligned for q, k,
// v and dO (they are read by TMA); lse and delta = rowsum(dO o) [B * H, Sq]
// f32; scale a power of two; the rest as tgtc_flash_fwd.
extern "C" int tgtc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq, int B, int H,
                                 int Sq, int Sk, const long long* strides, float scale,
                                 int dropout, const int* seed, unsigned int thr, float inv_keep,
                                 int bh_offset, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || B * H > 65535 || !pow2(scale)) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, Sq, H, B, strides_at(strides, 0)) ||
      !make_map(&mk, k, Sk, H, B, strides_at(strides, 1)) ||
      !make_map(&mv, v, Sk, H, B, strides_at(strides, 2)) ||
      !make_map(&mdo, dout, Sq, H, B, strides_at(strides, 3)))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(DqSmem) + 1024;  // + the slack of the 1 KB alignment
  auto kernel = dropout ? flash_bwd_dq_kernel<true> : flash_bwd_dq_kernel<false>;
  // Set on every launch: the attribute belongs to the current device's context.
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)((Sq + BROWS - 1) / BROWS), (unsigned)(B * H));
  kernel<<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dq), H, Sq, Sk, strides_at(strides, 4),
      scale, seed, thr, inv_keep, bh_offset);
  return (int)cudaGetLastError();
}

// K8. As K7, with dk, dv [B, H, Sk, 64] bf16: 18 strides for q, k, v, dO,
// dk, dv in that order.
extern "C" int tgtc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv,
                                  int B, int H, int Sq, int Sk, const long long* strides,
                                  float scale, int dropout, const int* seed, unsigned int thr,
                                  float inv_keep, int bh_offset, void* stream) {
  if (B <= 0 || H <= 0 || Sk <= 0) return 0;
  if (Sq <= 0 || B * H > 65535 || !pow2(scale)) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, Sq, H, B, strides_at(strides, 0)) ||
      !make_map(&mk, k, Sk, H, B, strides_at(strides, 1)) ||
      !make_map(&mv, v, Sk, H, B, strides_at(strides, 2)) ||
      !make_map(&mdo, dout, Sq, H, B, strides_at(strides, 3)))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(DkvSmem) + 1024;
  auto kernel = dropout ? flash_bwd_dkv_kernel<true> : flash_bwd_dkv_kernel<false>;
  // Set on every launch: the attribute belongs to the current device's context.
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)((Sk + BROWS - 1) / BROWS), (unsigned)(B * H));
  kernel<<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk,
      strides_at(strides, 4), strides_at(strides, 5), scale, seed, thr, inv_keep,
      bh_offset);
  return (int)cudaGetLastError();
}
