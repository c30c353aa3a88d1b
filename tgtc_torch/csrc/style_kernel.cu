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
//   trunk_sigma (nerf_trunk.cuh, the code of K1/K2) -> h, sigma;
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
// Design (first, simple version): K1's. A block owns 64 points; eight warps
// split every layer's 256 output columns over WMMA bf16 16x16x16 tiles,
// weights streamed from L2 (the 2.8 MB packed buffer stays resident). Shared
// memory (90,368 B): one activation buffer serves the trunk h, then the
// concat features, then the style activations, each layer written in place;
// base_remap keeps a second buffer until style layer 0; plus enc(pts), the
// bf16 latents, their means and the epilogue scratch. Nothing but points,
// latents, rgb and sigma touches device memory. K4 and K5 call the same
// trunk_sigma, so their sigma is bitwise equal (and equal to K2's on the
// same trunk weights).

#include "nerf_trunk.cuh"

namespace {

using namespace tgtc;

constexpr int DEPTH = 8, SKIP = 4;
constexpr int NCONCAT = 5;  // min(style_d - 1, skip + 1)
constexpr int NSTYLE = 7;   // style_d - 1 hidden style layers
constexpr int LAT = 32;
constexpr int LDL = LAT + 8;
// packed matrices: trunk 0..7, base_remap, sigma, concat, style, rgb_out
constexpr int BR = DEPTH, CONCAT0 = DEPTH + 2, STYLE0 = CONCAT0 + NCONCAT;
constexpr int RGB_OUT = STYLE0 + NSTYLE;
constexpr int NMATS = RGB_OUT + 1;
static_assert(NMATS <= MAX_LAYERS, "Layout holds the style matrices");

constexpr int LAT_BYTES = T * LDL * 2;
constexpr int LMEAN_BYTES = T * 4;
constexpr int STYLE_SMEM = 2 * H_BYTES + EC_BYTES + LAT_BYTES + LMEAN_BYTES + SCRATCH_BYTES;
constexpr int SIGMA_SMEM = H_BYTES + EC_BYTES + SCRATCH_BYTES;
constexpr int NT = W / 16 / NWARPS;

struct LatentSums {  // element offsets of the latent row sums in b
  long long off[NSTYLE + 1];
};

// ls[T, LDL] = bf16(lat[(p0 + p) / spr]) (zero past P); lmean[p] = the f32
// mean of a point's bf16 latents. Ordered before their readers by the
// trunk's first __syncthreads.
__device__ void load_latents(const float* __restrict__ lat, long long P, long long p0,
                             int spr, bf16* ls, float* lmean) {
  for (int idx = threadIdx.x; idx < T * LAT; idx += NTHREADS) {
    const int p = idx / LAT, k = idx % LAT;
    const long long q = p0 + p;
    ls[p * LDL + k] = __float2bfloat16(q < P ? lat[(q / spr) * LAT + k] : 0.0f);
  }
  __syncthreads();
  if (threadIdx.x < T) {
    float s = 0.0f;
    for (int k = 0; k < LAT; ++k) s += __bfloat162float(ls[threadIdx.x * LDL + k]);
    lmean[threadIdx.x] = s / (float)LAT;
  }
}

__global__ void __launch_bounds__(NTHREADS)
style_sigma_kernel(const float* __restrict__ pts_t, long long P,
                   const bf16* __restrict__ w, const float* __restrict__ b,
                   Layout L, float* __restrict__ sigma) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h = reinterpret_cast<bf16*>(smem);
  bf16* ec = reinterpret_cast<bf16*>(smem + H_BYTES);
  float* scratch = reinterpret_cast<float*>(smem + H_BYTES + EC_BYTES);
  const long long p0 = (long long)blockIdx.x * T;
  trunk_sigma(pts_t, P, p0, w, b, L, DEPTH, SKIP, h, ec, scratch, sigma, nullptr);
}

__global__ void __launch_bounds__(NTHREADS)
style_fwd_kernel(const float* __restrict__ pts_t, const float* __restrict__ lat,
                 long long P, int spr, const bf16* __restrict__ w,
                 const float* __restrict__ b, Layout L, LatentSums S,
                 float* __restrict__ rgb, float* __restrict__ sigma) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h = reinterpret_cast<bf16*>(smem);
  bf16* br = reinterpret_cast<bf16*>(smem + H_BYTES);
  bf16* ec = reinterpret_cast<bf16*>(smem + 2 * H_BYTES);
  bf16* ls = reinterpret_cast<bf16*>(smem + 2 * H_BYTES + EC_BYTES);
  float* lmean = reinterpret_cast<float*>(smem + 2 * H_BYTES + EC_BYTES + LAT_BYTES);
  float* scratch = reinterpret_cast<float*>(smem + 2 * H_BYTES + EC_BYTES + LAT_BYTES +
                                            LMEAN_BYTES);
  const long long p0 = (long long)blockIdx.x * T;

  load_latents(lat, P, p0, spr, ls, lmean);
  trunk_sigma(pts_t, P, p0, w, b, L, DEPTH, SKIP, h, ec, scratch, sigma, nullptr);
  Seg sr[1] = {{h, LDH, W, 0}};
  gemm_bias_relu<NT>(sr, 1, w + L.w[BR], W, b + L.b[BR], br, LDH, scratch);

  // concat MLP, in place over h
  for (int i = 0; i < NCONCAT; ++i) {
    const bf16* wi = w + L.w[CONCAT0 + i];
    const float* bi = b + L.b[CONCAT0 + i];
    if (i == 0) {
      Seg s[2] = {{ec, LDC, KC, 0}, {ls, LDL, LAT, KC}};
      gemm_bias_relu<NT>(s, 2, wi, KC + LAT, bi, h, LDH, scratch);
    } else if (i == SKIP) {
      Seg s[3] = {{h, LDH, W, 0}, {ls, LDL, LAT, W}, {ec, LDC, KC, W + LAT}};
      gemm_bias_relu<NT>(s, 3, wi, W + LAT + KC, bi, h, LDH, scratch);
    } else {
      Seg s[2] = {{h, LDH, W, 0}, {ls, LDL, LAT, W}};
      gemm_bias_relu<NT>(s, 2, wi, W + LAT, bi, h, LDH, scratch);
    }
  }

  // style MLP, in place over h, with the rank-1 latent term
  for (int i = 0; i < NSTYLE; ++i) {
    const bf16* wi = w + L.w[STYLE0 + i];
    const float* bi = b + L.b[STYLE0 + i];
    const float* li = b + S.off[i];
    if (i == 0) {
      Seg s[3] = {{br, LDH, W, 0}, {h, LDH, W, W}, {ec, LDC, KC, 2 * W}};
      gemm_bias_relu<NT, true>(s, 3, wi, 2 * W + KC, bi, h, LDH, scratch, li, lmean);
    } else if (i == SKIP) {
      Seg s[2] = {{h, LDH, W, 0}, {ec, LDC, KC, W}};
      gemm_bias_relu<NT, true>(s, 2, wi, W + KC, bi, h, LDH, scratch, li, lmean);
    } else {
      Seg s[1] = {{h, LDH, W, 0}};
      gemm_bias_relu<NT, true>(s, 1, wi, W, bi, h, LDH, scratch, li, lmean);
    }
  }

  // rgb_out: threads 0..2 of each group of four write one point's rgb
  const int p = threadIdx.x / 4, c = threadIdx.x % 4;
  if (c < 3 && p0 + p < P) {
    const bf16* wo = w + L.w[RGB_OUT] + c * W;
    float acc = 0.0f;
    for (int k = 0; k < W; ++k)
      acc = fmaf(__bfloat162float(wo[k]), __bfloat162float(h[p * LDH + k]), acc);
    const float v = acc + b[S.off[NSTYLE] + c] * lmean[p] + b[L.b[RGB_OUT] + c];
    rgb[c * P + p0 + p] = 1.0f / (1.0f + expf(-v));
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
      style_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STYLE_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return 0;
  const Layout L = make_layout(offsets, NMATS);
  LatentSums S;
  for (int i = 0; i <= NSTYLE; ++i) S.off[i] = offsets[2 * NMATS + i];
  const unsigned grid = (unsigned)((P + T - 1) / T);
  style_fwd_kernel<<<grid, NTHREADS, STYLE_SMEM, (cudaStream_t)stream>>>(
      pts_t, lat, P, spr, (const bf16*)w, b, L, S, rgb, sigma);
  return (int)cudaGetLastError();
}

extern "C" int tgtc_style_sigma(const float* pts_t, long long P, const void* w,
                                const float* b, const long long* offsets, float* sigma,
                                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      style_sigma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SIGMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return 0;
  const Layout L = make_layout(offsets, NMATS);
  const unsigned grid = (unsigned)((P + T - 1) / T);
  style_sigma_kernel<<<grid, NTHREADS, SIGMA_SMEM, (cudaStream_t)stream>>>(
      pts_t, P, (const bf16*)w, b, L, sigma);
  return (int)cudaGetLastError();
}
