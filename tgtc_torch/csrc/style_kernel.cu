// Fused stylized-point kernels for Hopper (sm_90a): K4 (NeRF trunk -> concat
// MLP -> style MLP -> rgb, sigma) and K5 (trunk -> sigma only).
//
// Replaces the TPU kernels of tgtc/ops/pallas/style_kernel.py:
//   K4  tgtc_style_fwd    <- fused_style_apply_t (body _make_kernel)
//   K5  tgtc_style_sigma  <- fused_sigma_apply_t (body _make_sigma_kernel)
// Plain PyTorch twins of the same arithmetic live beside the wrappers in
// tgtc_torch/ops/kernels/style_kernel.py, and so does the packing
// (pack_style_params: row-major [out, in_padded] bf16 matrices; biases and
// the style layers' latent row sums as bf16-rounded f32 vectors).
//
// Per point, at the one shape these kernels take (trunk D8/W256, skip 4,
// L=10; style_d 8, style width 256, latent 32):
//   the trunk and sigma, K1's arithmetic -> h, sigma;
//   base_remap = relu(h) in its own buffer;
//   concat MLP, 5 layers: [enc(pts) | lat], then [cf | lat] with enc(pts)
//     appended at layer index skip (the reference's column order);
//   style MLP, 7 layers: [base_remap | cf | enc(pts)], then [s] with
//     enc(pts) appended at layer index skip; the reference feeds every style
//     layer the per-point mean of the latent broadcast over its 32 columns,
//     which is the rank-1 term lsum[n] * mean(bf16(lat)) (lsum: the
//     bf16-rounded row sum of the layer's latent columns);
//   rgb = sigmoid(w_out . s + lsum_out * mean + b_out).
// Rounding as _make_kernel: bf16 operands, f32 sums, (rank-1 term,) bias
// and ReLU in f32, a bf16 round after every layer.
//
// Latents come per ray, [R, 32] f32: point p reads row p / samples_per_ray
// and rounds it to bf16 in shared memory (the TPU path broadcast them to
// [32, P] in device memory first).
//
// What bounds it: operations. 2,898,944 FLOP per point for K4 (trunk with
// sigma 982,528; base_remap 131,072; concat 670,720; style 1,113,088;
// rgb_out 1,536) against at most 156 bytes of point I/O (one latent row
// per point); 982,528 for K5, as K2. Both far above the card's
// operations-per-byte balance, so the bound is the bf16 tensor-core rate.
//
// Both run on the Hopper dense-layer engine (trunk_sm90.cuh), as K1 and K2:
// persistent blocks over 128-point tiles, two consumer warpgroups of 64 rows,
// wgmma m64n256k16, the weights streamed by TMA through a ring of 32 KB
// slots, and the engine's one trunk function (sm90::trunk_tile). K4 runs all
// 21 tensor-core layers (trunk, base_remap, 5 concat, 7 style) through a ring
// of four slots. Per tile: enc(pts), the bf16 latents and their means into
// shared memory, the trunk with h in registers, h to shared memory for sigma
// on CUDA cores, base_remap into h's buffer once sigma has read it (kept
// until style layer 0), the concat and style layers with the previous layer's
// output in registers and the other inputs as shared-memory segments in the
// reference's column order (the latent's 32 columns a segment of their own,
// [base_remap | cf | enc(pts)] at style layer 0), the rank-1 term in the
// style layers' epilogue, the last style layer to shared memory for rgb_out
// on CUDA cores. K5 is the engine's sigma-only kernel (sm90::sigma_kernel,
// K2's body) on K4's packing, whose trunk and sigma matrices sit at K2's
// indices: K5's sigma equals K4's, and K2's on the same trunk, bit for bit
// (phase 6 of chip_smoke.py holds it).
//
// K4's shared memory (the 1 KB alignment slack on top): ring 4 x 32 KB =
// 128 KB; one 64 KB buffer for h (the sigma head's input), then base_remap
// (style layer 0's), then the last style layer's output (rgb_out's);
// enc(pts) 16 KB, latents 16 KB (32 of 64 columns used), latent means 512 B,
// barriers 64 B: 230,976 B of the 232,448 a block may have. (With base_remap
// in a buffer of its own only two slots fitted, and K4 ran 7% slower.) K5's
// is K2's: ring 4 x 32 KB, h 64 KB, enc(pts) 16 KB, barriers 64 B: 213,056 B
// (sm90::SIGMA_KERNEL_SMEM).

#include "trunk_sm90.cuh"

namespace {

using namespace tgtc;
using namespace hopper;

constexpr int DEPTH = 8, SKIP = 4;
constexpr int NCONCAT = 5;  // min(style_d - 1, skip + 1)
constexpr int NSTYLE = 7;   // style_d - 1 hidden style layers
constexpr int LAT = 32;
// packed matrices: trunk 0..7, base_remap, sigma, concat, style, rgb_out
constexpr int BR = DEPTH, CONCAT0 = DEPTH + 2, STYLE0 = CONCAT0 + NCONCAT;
constexpr int RGB_OUT = STYLE0 + NSTYLE;
constexpr int NMATS = RGB_OUT + 1;
static_assert(NMATS <= MAX_LAYERS, "Layout holds the style matrices");

constexpr int NMMA = NMATS - 2;  // all but sigma and rgb_out run on the tensor cores
static_assert(NMMA <= sm90::MAX_MMA, "the engine's maps hold K4's layers");
constexpr int K4_STAGES = 4;

struct K4Smem {
  uint8_t ring[K4_STAGES][sm90::CHUNK_BYTES];
  uint8_t h[4][sm90::BLK_BYTES];  // h, then base_remap, then the last style layer's output
  uint8_t ec[sm90::BLK_BYTES];
  uint8_t lat[sm90::BLK_BYTES];
  float lmean[sm90::ROWS];
  uint64_t full[K4_STAGES], empty[K4_STAGES];
};
constexpr int K4_SMEM = (int)sizeof(K4Smem) + 1024;  // + the slack of the 1 KB alignment
static_assert(K4_SMEM <= 232448, "K4's shared memory exceeds a block's 227 KB");

// The packed matrix of tensor-core layer i (trunk, base_remap, concat,
// style) and its input columns.
__host__ __device__ constexpr int mma_mat(int i) { return i <= BR ? i : i + 1; }
__host__ __device__ constexpr int mma_k(int i) {
  return i == 0 ? KC
       : i == SKIP + 1 ? KC + W
       : i <= BR ? W
       : i == BR + 1 ? KC + LAT
       : i < BR + 1 + SKIP ? W + LAT
       : i == BR + 1 + SKIP ? W + LAT + KC
       : i == BR + 1 + NCONCAT ? 2 * W + KC
       : i == BR + 1 + NCONCAT + SKIP ? W + KC
       : W;
}

struct LatentSums {  // element offsets of the latent row sums in b
  long long off[NSTYLE + 1];
};

// K4: persistent blocks over 128-point tiles (see the header).
__global__ void __launch_bounds__(sm90::THREADS, 1)
style_fwd_kernel(const __grid_constant__ sm90::Maps maps, const sm90::Plan plan,
                 const float* __restrict__ pts_t, const float* __restrict__ lat, long long P,
                 int spr, const bf16* __restrict__ w, const float* __restrict__ b, Layout L,
                 LatentSums S, float* __restrict__ rgb, float* __restrict__ sigma) {
  extern __shared__ uint8_t smem_raw[];
  K4Smem& sm = *reinterpret_cast<K4Smem*>(align_1k(smem_raw));
  const long long ntiles = (P + sm90::ROWS - 1) / sm90::ROWS;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  sm90::init_ring<K4_STAGES>(sm.full, sm.empty);

  if (wg == sm90::CONSUMERS) {  // producer
    setmaxnreg_dec<sm90::PRODUCER_REGS>();
    if (tid == 0)
      sm90::produce<K4_STAGES>(maps, plan, NMMA,
                               (int)((ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x),
                               sm.ring[0], sm.full, sm.empty);
    return;
  }
  setmaxnreg_inc<sm90::CONSUMER_REGS>();
  const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3, bar = 1 + wg;
  const int rows = wg * sm90::WG_BLK_BYTES;  // this consumer's rows of each block
  uint8_t* h = sm.h[0] + rows;
  uint8_t* ec = sm.ec + rows;
  uint8_t* ls = sm.lat + rows;
  float* lmean = sm.lmean + wg * sm90::WG_ROWS;
  const uint32_t s_h = smem_u32(h), s_ec = smem_u32(ec), s_lat = smem_u32(ls);
  const uint32_t ring = smem_u32(sm.ring[0]);
  float acc[128];
  uint32_t act[64];  // the layer input's 256 columns as wgmma A fragments
  uint32_t q = 0;    // chunks consumed
  using sm90::REGS;
  using sm90::SMEM;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * sm90::ROWS + wg * sm90::WG_ROWS;
    // beside enc(pts): bf16(lat[(p0 + p) / spr]) (zero past P), then the f32
    // mean of each point's bf16 latents
    sm90::trunk_tile<DEPTH, SKIP, K4_STAGES, false>(
        acc, act, DEPTH, SKIP, pts_t, P, p0, ec, h, w, b, L, sigma, ring, sm.full, sm.empty, q,
        tid, bar, [=] {
          for (int idx = tid; idx < sm90::WG_ROWS * LAT; idx += 128) {
            const int p = idx / LAT, k = idx % LAT;
            const long long pq = p0 + p;
            *reinterpret_cast<bf16*>(ls + sm90::sw(p, k)) =
                __float2bfloat16(pq < P ? lat[(pq / spr) * LAT + k] : 0.0f);
          }
          bar_sync(bar, 128);
          if (tid < sm90::WG_ROWS) {
            float s = 0.0f;
            for (int k = 0; k < LAT; ++k)
              s += __bfloat162float(*reinterpret_cast<const bf16*>(ls + sm90::sw(tid, k)));
            lmean[tid] = s / (float)LAT;
          }
        });
    const float lm0 = lmean[warp * 16 + g], lm1 = lmean[warp * 16 + g + 8];

    // base_remap into h's buffer, kept until style layer 0
    sm90::mma_layer<W, K4_STAGES, REGS, W>(acc, act, 0, 0, 0, ring, sm.full, sm.empty, q);
    sm90::epilogue<W, false>(acc, act, b + L.b[BR], nullptr, 0.0f, 0.0f, t);
    bar_sync(bar, 128);  // sigma_head has read h
    sm90::store_act<W>(act, s_h, warp, g, t);
    fence_proxy_async();

    // the concat MLP: [enc(pts) | lat], [cf | lat] ..., [cf | lat | enc(pts)] at the skip
    sm90::mma_layer<W, K4_STAGES, SMEM, KC, SMEM, LAT>(acc, act, s_ec, s_lat, 0, ring, sm.full,
                                                       sm.empty, q);
    sm90::epilogue<W, false>(acc, act, b + L.b[CONCAT0], nullptr, 0.0f, 0.0f, t);
    for (int c = 1; c < NCONCAT; ++c) {
      if (c == SKIP)
        sm90::mma_layer<W, K4_STAGES, REGS, W, SMEM, LAT, SMEM, KC>(acc, act, 0, s_lat, s_ec,
                                                                    ring, sm.full, sm.empty, q);
      else
        sm90::mma_layer<W, K4_STAGES, REGS, W, SMEM, LAT>(acc, act, 0, s_lat, 0, ring, sm.full,
                                                          sm.empty, q);
      sm90::epilogue<W, false>(acc, act, b + L.b[CONCAT0 + c], nullptr, 0.0f, 0.0f, t);
    }

    // the style MLP with the rank-1 latent term: [base_remap | cf | enc(pts)],
    // then [s], with enc(pts) appended at the skip
    bar_sync(bar, 128);  // base_remap is in shared memory
    sm90::mma_layer<W, K4_STAGES, SMEM, W, REGS, W, SMEM, KC>(acc, act, s_h, 0, s_ec, ring,
                                                              sm.full, sm.empty, q);
    sm90::epilogue<W, true>(acc, act, b + L.b[STYLE0], b + S.off[0], lm0, lm1, t);
    for (int s = 1; s < NSTYLE; ++s) {
      if (s == SKIP)
        sm90::mma_layer<W, K4_STAGES, REGS, W, SMEM, KC>(acc, act, 0, s_ec, 0, ring, sm.full,
                                                         sm.empty, q);
      else
        sm90::mma_layer<W, K4_STAGES, REGS, W>(acc, act, 0, 0, 0, ring, sm.full, sm.empty, q);
      sm90::epilogue<W, true>(acc, act, b + L.b[STYLE0 + s], b + S.off[s], lm0, lm1, t);
    }
    sm90::store_act<W>(act, s_h, warp, g, t);
    bar_sync(bar, 128);

    // rgb channel c of row r: sigmoid(w_out[c] . s[r] + lsum_out[c] mean + b_out[c])
    for (int idx = tid; idx < 3 * sm90::WG_ROWS; idx += 128) {
      const int r = idx % sm90::WG_ROWS, c = idx / sm90::WG_ROWS;
      if (p0 + r >= P) continue;
      const float acc_c = sm90::row_dot(h, W / sm90::CK, w + L.w[RGB_OUT] + c * W, r);
      const float v = acc_c + b[S.off[NSTYLE] + c] * lmean[r] + b[L.b[RGB_OUT] + c];
      rgb[c * P + p0 + r] = 1.0f / (1.0f + expf(-v));
    }
  }
}

}  // namespace

// offsets: the 23 matrices' element offsets into w, their 23 bias offsets
// into b, then the 8 latent-row-sum offsets into b (style layers 0..6 and
// rgb_out). lat: [P / spr, 32] f32. Returns cudaGetLastError() after the
// launch.
extern "C" int tgtc_style_fwd(const float* pts_t, const float* lat, long long P, int spr,
                              const void* w, const float* b, const long long* offsets,
                              float* rgb, float* sigma, void* stream) {
  if (spr < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      style_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K4_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return 0;
  const Layout L = make_layout(offsets, NMATS);
  LatentSums S;
  for (int i = 0; i <= NSTYLE; ++i) S.off[i] = offsets[2 * NMATS + i];
  sm90::Maps maps;
  sm90::Plan plan = {};
  for (int i = 0; i < NMMA; ++i) {
    plan.k[i] = mma_k(i);
    plan.n[i] = W;
    if (!sm90::weight_map(&maps.m[i], w, L.w[mma_mat(i)], W, plan.k[i]))
      return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (P + sm90::ROWS - 1) / sm90::ROWS;
  const int grid = sm90::persistent_grid(tiles);
  if (grid <= 0) return (int)cudaErrorInvalidDevice;
  style_fwd_kernel<<<grid, sm90::THREADS, K4_SMEM, (cudaStream_t)stream>>>(
      maps, plan, pts_t, lat, P, spr, (const bf16*)w, b, L, S, rgb, sigma);
  return (int)cudaGetLastError();
}

// K4's dynamic shared memory a block, in bytes.
extern "C" int tgtc_style_fwd_smem() { return K4_SMEM; }

// K5: K2's kernel on K4's packing (trunk 0..7, sigma 9). Returns
// cudaGetLastError() after the launch.
extern "C" int tgtc_style_sigma(const float* pts_t, long long P, const void* w,
                                const float* b, const long long* offsets, float* sigma,
                                void* stream) {
  const Layout L = make_layout(offsets, NMATS);
  return sm90::launch_sigma<DEPTH, SKIP>(pts_t, P, w, b, L, DEPTH, SKIP, sigma,
                                         (cudaStream_t)stream);
}

// K5's dynamic shared memory a block, in bytes.
extern "C" int tgtc_style_sigma_smem() { return sm90::SIGMA_KERNEL_SMEM; }
