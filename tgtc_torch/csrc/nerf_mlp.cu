// Fused NeRF trunk for Hopper (sm_90a): K1 (full trunk -> rgb, sigma) and
// K2 (trunk -> sigma only).
//
// Replaces the TPU kernels of tgtc/ops/pallas/nerf_mlp.py:
//   K1  tgtc_nerf_mlp_fwd    <- fused_nerf_apply_t       (body _make_kernel)
//   K2  tgtc_nerf_mlp_sigma  <- fused_nerf_sigma_apply_t (body _make_sigma_kernel)
// Plain PyTorch twins of the same arithmetic live beside the wrappers in
// tgtc_torch/ops/kernels/nerf_mlp.py.
//
// The shared device code (encoding, trunk, heads) is in nerf_trunk.cuh.
//
// What bounds it: operations. 1,186,816 FLOP/point for K1 (982,528 for
// K2) against ~40 bytes of point I/O, far above the card's
// operations-per-byte balance, so the bound is the bf16 tensor-core rate.
//
// Design (first, simple version; see nerf_trunk.cuh): a block owns 64
// points and keeps their activations in shared memory; nothing but points,
// rgb and sigma touch device memory. K1 and K2 share the trunk/sigma device
// function, so their sigma outputs are bitwise equal.

#include "nerf_trunk.cuh"

namespace {

using namespace tgtc;

__global__ void __launch_bounds__(NTHREADS)
nerf_sigma_kernel(const float* __restrict__ pts_t, long long P,
                  const bf16* __restrict__ w, const float* __restrict__ b,
                  Layout L, int depth, int skip, float* __restrict__ sigma) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h = reinterpret_cast<bf16*>(smem);
  bf16* ec = reinterpret_cast<bf16*>(smem + H_BYTES);
  float* scratch = reinterpret_cast<float*>(smem + H_BYTES + EC_BYTES + ED_BYTES + RF_BYTES);
  const long long p0 = (long long)blockIdx.x * T;
  trunk_sigma(pts_t, P, p0, w, b, L, depth, skip, h, ec, scratch, sigma, nullptr);
}

__global__ void __launch_bounds__(NTHREADS)
nerf_fwd_kernel(const float* __restrict__ pts_t, const float* __restrict__ dirs_t,
                long long P, const bf16* __restrict__ w,
                const float* __restrict__ b, Layout L, int depth, int skip,
                float* __restrict__ rgb, float* __restrict__ sigma) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h = reinterpret_cast<bf16*>(smem);
  bf16* ec = reinterpret_cast<bf16*>(smem + H_BYTES);
  bf16* ed = reinterpret_cast<bf16*>(smem + H_BYTES + EC_BYTES);
  bf16* rf = reinterpret_cast<bf16*>(smem + H_BYTES + EC_BYTES + ED_BYTES);
  float* scratch = reinterpret_cast<float*>(smem + H_BYTES + EC_BYTES + ED_BYTES + RF_BYTES);
  const long long p0 = (long long)blockIdx.x * T;

  trunk_sigma(pts_t, P, p0, w, b, L, depth, skip, h, ec, scratch, sigma, nullptr);
  rgb_features(dirs_t, P, p0, w, b, L, depth, h, ed, rf, scratch);
  // threads 0..2 of each group of four write one point's rgb
  const int p = threadIdx.x / 4, c = threadIdx.x % 4;
  if (c < 3 && p0 + p < P) rgb[c * P + p0 + p] = rgb_out(w, b, L, depth, rf, p, c);
}

}  // namespace

// offsets: 2*(depth+4) element offsets, the weight offsets then the bias
// offsets (see Layout). Returns cudaGetLastError() after the launch.
extern "C" int tgtc_nerf_mlp_fwd(const float* pts_t, const float* dirs_t,
                                 long long P, const void* w, const float* b,
                                 const long long* offsets, int depth, int skip,
                                 float* rgb, float* sigma, void* stream) {
  if (depth < 1 || depth + 4 > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nerf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return 0;
  const Layout L = make_layout(offsets, depth + 4);
  const unsigned grid = (unsigned)((P + T - 1) / T);
  nerf_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      pts_t, dirs_t, P, (const bf16*)w, b, L, depth, skip, rgb, sigma);
  return (int)cudaGetLastError();
}

extern "C" int tgtc_nerf_mlp_sigma(const float* pts_t, long long P,
                                   const void* w, const float* b,
                                   const long long* offsets, int depth,
                                   int skip, float* sigma, void* stream) {
  if (depth < 1 || depth + 4 > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nerf_sigma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return 0;
  const Layout L = make_layout(offsets, depth + 4);
  const unsigned grid = (unsigned)((P + T - 1) / T);
  nerf_sigma_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      pts_t, P, (const bf16*)w, b, L, depth, skip, sigma);
  return (int)cudaGetLastError();
}
