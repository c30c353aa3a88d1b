// Fused NeRF trunk for Hopper (sm_90a): K1 (full trunk -> rgb, sigma) and
// K2 (trunk -> sigma only).
//
// Replaces the TPU kernels of tgtc/ops/pallas/nerf_mlp.py:
//   K1  tgtc_nerf_mlp_fwd    <- fused_nerf_apply_t       (body _make_kernel)
//   K2  tgtc_nerf_mlp_sigma  <- fused_nerf_sigma_apply_t (body _make_sigma_kernel)
// Plain PyTorch twins of the same arithmetic live beside the wrappers in
// tgtc_torch/ops/kernels/nerf_mlp.py.
//
// What bounds them: operations. 1,186,816 FLOP/point for K1 (982,528 for
// K2) against ~40 bytes of point I/O, far above the card's
// operations-per-byte balance, so the bound is the bf16 tensor-core rate.
// K2 also runs the distilled proposal's D2xW128 trunk (49,408 FLOP/point,
// tgtc/render/distill.py) on a kernel of its own, K2-W128
// (proposal_sm90.cuh): there the encoding and the epilogues on CUDA cores
// weigh as much as the tensor-core work.
//
// Both run on the Hopper dense-layer engine (trunk_sm90.cuh): persistent
// blocks over 128-point tiles, two consumer warpgroups of 64 rows with wgmma
// m64n256k16, the weights of every layer streamed by TMA through a ring of
// four 32 KB slots, and one trunk function (sm90::trunk_tile) for both. Per
// K1 tile: enc(pts) and enc(dirs) into their swizzled blocks, the trunk with
// h in registers ([enc(pts) | h] at the skip layer), h to shared memory for
// the sigma head on CUDA cores, then K1's tail (sm90::rgb_tail, which K3
// recomputes with too): base_remap, rgb_0 (wgmma m64n128k16) on [base_remap
// | enc(dirs)] into shared memory, the sigmoid rgb on CUDA cores. K2 is the
// engine's sigma-only kernel (sm90::sigma_kernel): the same trunk and sigma
// head, nothing after them, so K2's sigma equals K1's bit for bit (phase 1
// of chip_smoke.py holds it). Depth 8 with skip 4 is compiled in for both;
// other depths run on a run-time-depth build of each. K1 takes width 256
// only (no path runs the proposal's rgb). A 128-wide trunk (the proposal)
// goes to K2-W128, proposal::sigma_kernel (weights resident in shared
// memory, four independent consumer warpgroups of 64-point tiles, the
// encoding in registers, the sigma head on the tensor cores): depth 2
// compiled in, any depth up to 7 at run time (proposal::smem_bytes); a
// deeper 128-wide trunk, whose weights do not fit in a block's shared
// memory, stays on the engine's sigma_kernel<0, 0, 128>. The choice is made
// by shape before the launch.
//
// K1's shared memory (the 1 KB alignment slack on top): ring 4 x 32 KB =
// 128 KB, h 4 x 16 KB = 64 KB (for the heads), enc(pts) 16 KB, enc(dirs)
// 16 KB (32 of 64 columns used), barriers 64 B: 229,440 B of the 232,448 a
// block may have. K2's: ring 4 x 32 KB, h 64 KB, enc(pts) 16 KB, barriers
// 64 B: 213,056 B (sm90::SIGMA_KERNEL_SMEM).

#include "proposal_sm90.cuh"
#include "trunk_sm90.cuh"

namespace {

using namespace tgtc;
using namespace hopper;

constexpr int K1_STAGES = 4;

struct K1Smem {
  uint8_t ring[K1_STAGES][sm90::CHUNK_BYTES];
  uint8_t h[4][sm90::BLK_BYTES];
  uint8_t ec[sm90::BLK_BYTES];
  uint8_t ed[sm90::BLK_BYTES];
  uint64_t full[K1_STAGES], empty[K1_STAGES];
};
constexpr int K1_SMEM = (int)sizeof(K1Smem) + 1024;  // + the slack of the 1 KB alignment
static_assert(K1_SMEM <= 232448, "K1's shared memory exceeds a block's 227 KB");

// K1: persistent blocks over 128-point tiles (see the header). The maps and
// plan list the depth + 2 tensor-core layers: trunk 0..depth-1, base_remap,
// rgb_0. Activations pass from layer to layer in registers; h goes to
// shared memory for the sigma head, rgb_0's output for the rgb head.
// DEPTH > 0 fixes depth and skip at compile time (sm90::trunk_tile).
template <int DEPTH, int SKIP>
__global__ void __launch_bounds__(sm90::THREADS, 1)
nerf_fwd_kernel(const __grid_constant__ sm90::Maps maps, const sm90::Plan plan,
                const float* __restrict__ pts_t, const float* __restrict__ dirs_t, long long P,
                const bf16* __restrict__ w, const float* __restrict__ b, Layout L, int depth_rt,
                int skip_rt, float* __restrict__ rgb, float* __restrict__ sigma) {
  const int depth = DEPTH > 0 ? DEPTH : depth_rt;
  extern __shared__ uint8_t smem_raw[];
  K1Smem& sm = *reinterpret_cast<K1Smem*>(align_1k(smem_raw));
  const long long ntiles = (P + sm90::ROWS - 1) / sm90::ROWS;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  sm90::init_ring<K1_STAGES>(sm.full, sm.empty);

  if (wg == sm90::CONSUMERS) {  // producer
    setmaxnreg_dec<sm90::PRODUCER_REGS>();
    if (tid == 0)
      sm90::produce<K1_STAGES>(maps, plan, depth + 2,
                               (int)((ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x),
                               sm.ring[0], sm.full, sm.empty);
    return;
  }
  setmaxnreg_inc<sm90::CONSUMER_REGS>();
  const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3, bar = 1 + wg;
  const int rows = wg * sm90::WG_BLK_BYTES;  // this consumer's rows of each block
  uint8_t* h = sm.h[0] + rows;
  uint8_t* ec = sm.ec + rows;
  uint8_t* ed = sm.ed + rows;
  const uint32_t s_h = smem_u32(h), s_ed = smem_u32(ed);
  const uint32_t ring = smem_u32(sm.ring[0]);
  float acc[128];
  uint32_t act[64];  // the layer input's 256 columns as wgmma A fragments
  uint32_t q = 0;    // chunks consumed

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * sm90::ROWS + wg * sm90::WG_ROWS;
    sm90::trunk_tile<DEPTH, SKIP, K1_STAGES, true>(
        acc, act, depth_rt, skip_rt, pts_t, P, p0, ec, h, w, b, L, sigma, ring, sm.full,
        sm.empty, q, tid, bar, [=] { sm90::encode<FD, KD>(dirs_t, P, p0, ed, tid); });

    sm90::rgb_tail<K1_STAGES>(acc, act, depth, P, p0, h, s_ed, w, b, L, ring, sm.full, sm.empty,
                              q, tid, bar, warp, g, t, s_h,
                              [=](int r, int c, float y) { rgb[c * P + p0 + r] = y; });
  }
}

}  // namespace

// offsets: 2*(depth+4) element offsets, the weight offsets then the bias
// offsets (see Layout). Returns cudaGetLastError() after the launch.
extern "C" int tgtc_nerf_mlp_fwd(const float* pts_t, const float* dirs_t,
                                 long long P, const void* w, const float* b,
                                 const long long* offsets, int depth, int skip,
                                 float* rgb, float* sigma, void* stream) {
  if (depth < 1 || depth + 4 > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  auto kernel = depth == 8 && skip == 4 ? nerf_fwd_kernel<8, 4> : nerf_fwd_kernel<0, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K1_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return 0;
  const Layout L = make_layout(offsets, depth + 4);
  sm90::Maps maps;
  sm90::Plan plan;
  if (!sm90::rgb_plan(&maps, &plan, w, L, depth, skip)) return (int)cudaErrorInvalidValue;
  const long long tiles = (P + sm90::ROWS - 1) / sm90::ROWS;
  const int grid = sm90::persistent_grid(tiles);
  if (grid <= 0) return (int)cudaErrorInvalidDevice;
  kernel<<<grid, sm90::THREADS, K1_SMEM, (cudaStream_t)stream>>>(
      maps, plan, pts_t, dirs_t, P, (const bf16*)w, b, L, depth, skip, rgb, sigma);
  return (int)cudaGetLastError();
}

// K1's dynamic shared memory a block, in bytes.
extern "C" int tgtc_nerf_mlp_fwd_smem() { return K1_SMEM; }

// K2: as tgtc_nerf_mlp_fwd, sigma only, on a trunk `width` (256 or 128)
// wide: K2 at 256, K2-W128 at 128 while its weights fit (depth <= 7), the
// engine's sigma-only kernel beyond. Returns cudaGetLastError() after the
// launch.
extern "C" int tgtc_nerf_mlp_sigma(const float* pts_t, long long P,
                                   const void* w, const float* b,
                                   const long long* offsets, int depth,
                                   int skip, int width, float* sigma, void* stream) {
  if (depth < 1 || depth + 4 > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(offsets, depth + 4);
  decltype(&sm90::launch_sigma<8, 4>) launch;
  if (width == W)
    launch = depth == 8 && skip == 4 ? sm90::launch_sigma<8, 4> : sm90::launch_sigma<0, 0>;
  else if (width == proposal::PW && proposal::smem_bytes(depth, skip) <= proposal::SMEM_LIMIT)
    launch = depth == 2 && skip != 0 ? proposal::launch_sigma<2> : proposal::launch_sigma<0>;
  else if (width == proposal::PW)
    launch = sm90::launch_sigma<0, 0, proposal::PW>;
  else
    return (int)cudaErrorInvalidValue;
  return launch(pts_t, P, w, b, L, depth, skip, sigma, (cudaStream_t)stream);
}

// K2's dynamic shared memory a block, in bytes.
extern "C" int tgtc_nerf_mlp_sigma_smem() { return sm90::SIGMA_KERNEL_SMEM; }

// K2-W128's dynamic shared memory a block at this depth and skip, in bytes;
// above 232,448 the trunk runs on the engine instead.
extern "C" int tgtc_nerf_mlp_sigma_w128_smem(int depth, int skip) {
  return proposal::smem_bytes(depth, skip);
}
