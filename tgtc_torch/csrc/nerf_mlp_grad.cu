// K3: backward of the fused NeRF trunk for Hopper (sm_90a) — the packed
// weight and bias gradients from the rgb/sigma cotangents.
//
// Replaces the TPU kernel of tgtc/ops/pallas/nerf_mlp_grad.py:
//   K3  tgtc_nerf_mlp_bwd  <- _fused_nerf_bwd (body _make_bwd_kernel)
// The plain PyTorch twin of the same arithmetic, fused_nerf_bwd_plain, lives
// beside the wrapper in tgtc_torch/ops/kernels/nerf_mlp_grad.py.
//
// The TPU kernel keeps dW in VMEM across a grid that runs in order and adds
// each tile's contribution in place. Here blocks run in parallel and the
// f32 gradient (2.4 MB) does not fit on an SM, so the sum over points leaves
// the SM, in three launches on one stream:
//
// 1. nerf_bwd_tile_kernel, one block per 64 points (as K1): recompute the
//    forward with K1's own device functions (nerf_trunk.cuh), so the ReLU
//    masks are the forward's bit for bit, then backpropagate the cotangents
//    through the heads and the trunk in shared memory (input-gradient
//    products on WMMA, weights read from L2). Every layer's bf16 input and
//    masked bf16 output gradient go to a point-major workspace.
// 2. nerf_bwd_wgrad_kernel: dW_l = G_l^T A_l as a split-K product over
//    points. A block owns a 64x64 tile of one layer's dW and 4096 points,
//    and writes its f32 partial (and the bias partial, the f32 column sums
//    of G_l) to its chunk's slice of a partial buffer.
// 3. nerf_bwd_reduce_kernel: sums the chunks' partials in chunk order.
//
// No atomics: every sum runs in a fixed order, so the result is bitwise
// repeatable.
//
// Rounding points follow _make_bwd_kernel: gs, g_rf, g_br and every trunk
// layer's masked g are bf16 and feed both the weight-gradient product and
// the next input-gradient product; the mask is taken on the bf16
// activation; bias gradients are f32 sums of the bf16 values, except the
// sigma bias, which sums the f32 g_sigma; the sigma head has no ReLU.
//
// What bounds it: operations for the function (about three K1 forwards:
// the recompute, the weight-gradient and the input-gradient products), but
// this design also writes and reads the saved activations and gradients
// (9,984 bytes per point at depth 8) and the per-chunk partials, which at
// 3.35 TB/s cost more than the products at 989 TFLOP/s. Keeping them on
// chip (a persistent block per SM holding its share of dW) is later work.

#include "nerf_trunk.cuh"

namespace {

using namespace tgtc;

constexpr int G_BYTES = T * LDH * 2;         // the running gradient, bf16
constexpr int GS_BYTES = T * 4 * 4;          // gs (3 used) as f32 values of bf16
constexpr int GSIG_BYTES = T * 4;            // bf16(g_sigma) as f32
constexpr int TILE_SMEM = SMEM_BYTES + G_BYTES + GS_BYTES + GSIG_BYTES;

constexpr int SMALL = 16;  // column width of the stored gs / g_sigma arrays

// The workspace's point-major [P, cols] arrays.
struct Grads {
  bf16* h[MAX_LAYERS];  // [P, W] masked gradient at trunk layer i's output
  bf16* br;             // [P, W] at base_remap's output
  bf16* rf;             // [P, HW] at rgb_0's output
  bf16* gs;             // [P, SMALL], columns 0..2: at rgb_1's pre-sigmoid
  bf16* gsig;           // [P, SMALL], column 0: bf16(g_sigma)
};

struct Acts {
  Saved sv;   // ec, h[0..depth-1]
  bf16* br;   // [P, W]
  bf16* ed;   // [P, KD]
  bf16* rf;   // [P, HW]
};

// out[T, W] = bf16(mask > 0 ? g[T, K] @ Wm[:, col0 : col0 + W] (+ extra) : 0),
// where Wm is a layer's row-major [K, ldw] weight (its output rows are the
// product's K). The extra term, if any, is wx[n] * xs[p] in f32 (the sigma
// head's rank-1 input gradient). The mask is a [rows, ldm] bf16 array
// (shared or global memory); rows at or past `rows` count as masked. The
// result goes to out (in shared memory; may alias g) and, for rows below P,
// to gout [P, W].
__device__ void gemm_bwd(const bf16* g, int K, const bf16* __restrict__ wm,
                         int ldw, int col0, const bf16* __restrict__ wx,
                         const float* xs, const bf16* mask, long long ldm,
                         int rows, bf16* out, bf16* __restrict__ gout,
                         long long P, long long p0, float* scratch) {
  constexpr int NT = W / 16 / NWARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T / 16][NT];
#pragma unroll
  for (int i = 0; i < T / 16; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[T / 16];
#pragma unroll
    for (int i = 0; i < T / 16; ++i)
      wmma::load_matrix_sync(a[i], g + i * 16 * LDH + k0, LDH);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n0 = (warp * NT + j) * 16;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, wm + (long long)k0 * ldw + col0 + n0, ldw);
#pragma unroll
      for (int i = 0; i < T / 16; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
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
      const int p = i * 16 + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = n0 + c0 + c;
        float v = sc[r * 16 + c0 + c];
        if (wx) v += __bfloat162float(wx[n]) * xs[p];
        const bool on = p < rows && __bfloat162float(mask[p * ldm + n]) > 0.0f;
        const bf16 o = __float2bfloat16(on ? v : 0.0f);
        out[p * LDH + n] = o;
        if (p0 + p < P) gout[(p0 + p) * W + n] = o;
      }
      __syncwarp();
    }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS)
nerf_bwd_tile_kernel(const float* __restrict__ pts_t, const float* __restrict__ dirs_t,
                     const float* __restrict__ g_rgb, const float* __restrict__ g_sigma,
                     long long P, const bf16* __restrict__ w,
                     const float* __restrict__ b, Layout L, int depth, int skip,
                     Acts acts, Grads gr) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h = reinterpret_cast<bf16*>(smem);
  bf16* ec = reinterpret_cast<bf16*>(smem + H_BYTES);
  bf16* ed = reinterpret_cast<bf16*>(smem + H_BYTES + EC_BYTES);
  bf16* rf = reinterpret_cast<bf16*>(smem + H_BYTES + EC_BYTES + ED_BYTES);
  float* scratch = reinterpret_cast<float*>(smem + H_BYTES + EC_BYTES + ED_BYTES + RF_BYTES);
  bf16* g = reinterpret_cast<bf16*>(smem + SMEM_BYTES);
  float* gs = reinterpret_cast<float*>(smem + SMEM_BYTES + G_BYTES);
  float* gsig = reinterpret_cast<float*>(smem + SMEM_BYTES + G_BYTES + GS_BYTES);
  const long long p0 = (long long)blockIdx.x * T;
  const int rows = (int)(P - p0 < T ? P - p0 : T);

  // ---- forward recompute (K1's code), saving every layer's input
  trunk_sigma(pts_t, P, p0, w, b, L, depth, skip, h, ec, scratch, nullptr, &acts.sv);
  rgb_features(dirs_t, P, p0, w, b, L, depth, h, ed, rf, scratch);  // h := base_remap
  store_rows(h, LDH, W, acts.br, P, p0);
  store_rows(ed, LDD, KD, acts.ed, P, p0);
  store_rows(rf, LDR, HW, acts.rf, P, p0);

  // ---- heads: gs = bf16(g_rgb * rgb * (1 - rgb)), bf16(g_sigma)
  {
    const int p = threadIdx.x / 4, c = threadIdx.x % 4;
    const long long q = p0 + p;
    float v = 0.0f;
    if (c < 3 && q < P) {
      const float y = rgb_out(w, b, L, depth, rf, p, c);
      v = __bfloat162float(__float2bfloat16(g_rgb[c * P + q] * y * (1.0f - y)));
    }
    gs[p * 4 + c] = v;
    if (c == 3) gsig[p] = q < P ? __bfloat162float(__float2bfloat16(g_sigma[q])) : 0.0f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * SMALL; idx += NTHREADS) {
    const int p = idx / SMALL, c = idx % SMALL;
    if (p0 + p < P) {
      gr.gs[(p0 + p) * SMALL + c] = __float2bfloat16(c < 3 ? gs[p * 4 + c] : 0.0f);
      gr.gsig[(p0 + p) * SMALL + c] = __float2bfloat16(c == 0 ? gsig[p] : 0.0f);
    }
  }

  // g_rf = bf16(rf > 0 ? wr1^T gs : 0)
  const bf16* wr1 = w + L.w[depth + 3];
  for (int idx = threadIdx.x; idx < T * HW; idx += NTHREADS) {
    const int p = idx / HW, j = idx % HW;
    float acc = 0.0f;
    for (int c = 0; c < 3; ++c) acc = fmaf(__bfloat162float(wr1[c * HW + j]), gs[p * 4 + c], acc);
    const bool on = p < rows && __bfloat162float(rf[p * LDR + j]) > 0.0f;
    g[p * LDH + j] = __float2bfloat16(on ? acc : 0.0f);
  }
  __syncthreads();
  store_rows(g, LDH, HW, gr.rf, P, p0);

  // g_br = bf16(br > 0 ? g_rf @ wr0[:, :256] : 0); br is in h
  gemm_bwd(g, HW, w + L.w[depth + 2], W + KD, 0, nullptr, nullptr, h, LDH, rows,
           g, gr.br, P, p0, scratch);
  // g at the trunk's output: wrm^T g_br + wsig^T bf16(g_sigma), masked by h
  gemm_bwd(g, W, w + L.w[depth], W, 0, w + L.w[depth + 1], gsig,
           acts.sv.h[depth - 1] + p0 * W, W, rows, g, gr.h[depth - 1], P, p0, scratch);
  for (int i = depth - 1; i >= 1; --i) {
    const bool sk = i == skip + 1;  // columns [enc(pts) | h]: only h propagates
    gemm_bwd(g, W, w + L.w[i], sk ? KC + W : W, sk ? KC : 0, nullptr, nullptr,
             acts.sv.h[i - 1] + p0 * W, W, rows, g, gr.h[i - 1], P, p0, scratch);
  }
}

// ---- weight gradients: split-K products over points

constexpr int WT = 64;         // dW tile: 64 output rows x 64 input columns
constexpr int WP = 32;         // points staged per step
constexpr int CHUNK = 4096;    // points per block
constexpr int WTHREADS = 128;  // 4 warps, a 32x32 quarter of the tile each
constexpr int LDS = WT + 8;
constexpr int LDA = WT + 4;
constexpr int MAX_JOBS = 32;

// dW[n, col0 + k] (+)= sum_p G[p, n] A[p, k] for one layer input segment.
struct Job {
  const bf16* g;
  const bf16* a;
  const float* b_src;  // f32 bias source [P] (sigma), else null
  long long w_off;     // element offset of dW[0, col0]
  long long b_off;     // bias offset, or -1 (only a layer's first segment)
  int ldg, n, lda, k, ldw;
  int tiles_k, tile0;
};

struct Jobs {
  Job j[MAX_JOBS];
  int n;
};

__global__ void __launch_bounds__(WTHREADS)
nerf_bwd_wgrad_kernel(Jobs jobs, long long P, float* __restrict__ part, long long nwb,
                      long long nw) {
  __shared__ __align__(128) bf16 gsm[WP * LDS];
  __shared__ __align__(128) bf16 asm_[WP * LDS];
  __shared__ __align__(128) float acc_s[WT * LDA];
  __shared__ float bred[WT];

  int ji = 0;
  while (ji + 1 < jobs.n && (int)blockIdx.x >= jobs.j[ji + 1].tile0) ++ji;
  const Job jb = jobs.j[ji];
  const int t = (int)blockIdx.x - jb.tile0;
  const int n0 = (t / jb.tiles_k) * WT, k0 = (t % jb.tiles_k) * WT;
  const long long pa = (long long)blockIdx.y * CHUNK;
  const long long pb = P < pa + CHUNK ? P : pa + CHUNK;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  const bool bias = jb.b_off >= 0 && k0 == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  float bsum = 0.0f;

  for (long long p = pa; p < pb; p += WP) {
    // stage G[p : p+WP, n0 : n0+64] and A[p : p+WP, k0 : k0+64] in 16-byte
    // pieces; rows past pb and columns past the arrays' width are zero
    for (int c = threadIdx.x; c < WP * (WT / 8); c += WTHREADS) {
      const int r = c / (WT / 8), col = (c % (WT / 8)) * 8;
      const long long q = p + r;
      uint4 gv = make_uint4(0, 0, 0, 0), av = make_uint4(0, 0, 0, 0);
      if (q < pb && n0 + col < jb.ldg)
        gv = *reinterpret_cast<const uint4*>(jb.g + q * jb.ldg + n0 + col);
      if (q < pb && k0 + col < jb.lda)
        av = *reinterpret_cast<const uint4*>(jb.a + q * jb.lda + k0 + col);
      *reinterpret_cast<uint4*>(gsm + r * LDS + col) = gv;
      *reinterpret_cast<uint4*>(asm_ + r * LDS + col) = av;
    }
    __syncthreads();
    if (bias && !jb.b_src && threadIdx.x < WT)
      for (int r = 0; r < WP; ++r) bsum += __bfloat162float(gsm[r * LDS + threadIdx.x]);
#pragma unroll
    for (int kk = 0; kk < WP; kk += 16) {
      // G^T as the row operand: element (n, p) sits at gsm[p * LDS + n]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], gsm + kk * LDS + wr + i * 16, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bm[j], asm_ + kk * LDS + wc + j * 16, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bm[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (long long)blockIdx.y * nwb;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(acc_s + (wr + i * 16) * LDA + wc + j * 16, acc[i][j], LDA,
                              wmma::mem_row_major);
  if (bias && jb.b_src) {  // the sigma bias: the f32 g_sigma, 64 strided sums + fixed tree
    if (threadIdx.x < WT) {
      for (long long q = pa + threadIdx.x; q < pb; q += WT) bsum += jb.b_src[q];
      bred[threadIdx.x] = bsum;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < WT * WT; idx += WTHREADS) {
    const int r = idx / WT, c = idx % WT;
    if (n0 + r < jb.n && k0 + c < jb.k)
      out[jb.w_off + (long long)(n0 + r) * jb.ldw + k0 + c] = acc_s[r * LDA + c];
  }
  if (bias && threadIdx.x < WT) {
    float v = bsum;
    if (jb.b_src) {
      v = 0.0f;
      if (threadIdx.x == 0)
        for (int i = 0; i < WT; ++i) v += bred[i];
    }
    if (n0 + (int)threadIdx.x < jb.n && (!jb.b_src || threadIdx.x == 0))
      out[nw + jb.b_off + n0 + threadIdx.x] = v;
  }
}

__global__ void nerf_bwd_reduce_kernel(const float* __restrict__ part, int chunks,
                                       long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += part[(long long)c * n + i];
  out[i] = s;
}

long long saved_cols(int depth) {  // bf16 values per point in the workspace
  return KC + (long long)W * depth + W + KD + HW     // activations
         + (long long)W * depth + W + HW + 2 * SMALL;  // gradients
}

long long align256(long long x) { return (x + 255) / 256 * 256; }

}  // namespace

// Workspace bytes for tgtc_nerf_mlp_bwd: the saved activations and
// gradients, then the per-chunk partials of the nw + nb gradient values.
extern "C" long long tgtc_nerf_mlp_bwd_workspace(long long P, int depth, long long nwb) {
  const long long chunks = (P + CHUNK - 1) / CHUNK;
  return align256(P * saved_cols(depth) * 2) + chunks * nwb * 4;
}

// out: [nw + nb] f32, the weight gradient in the packed weight layout, then
// the bias gradient. offsets as tgtc_nerf_mlp_fwd. Returns the first CUDA
// error of the launches, or 0.
extern "C" int tgtc_nerf_mlp_bwd(const float* pts_t, const float* dirs_t,
                                 const float* g_rgb, const float* g_sigma,
                                 long long P, const void* w, const float* b,
                                 const long long* offsets, int depth, int skip,
                                 long long nw, long long nb, void* workspace,
                                 float* out, void* stream) {
  if (depth < 1 || depth + 4 > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nwb = nw + nb;
  cudaError_t err = cudaFuncSetAttribute(
      nerf_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (P == 0) return (int)cudaMemsetAsync(out, 0, nwb * 4, st);
  const Layout L = make_layout(offsets, depth + 4);
  const bf16* wb = (const bf16*)w;

  // carve the workspace
  bf16* cur = (bf16*)workspace;
  auto take = [&](int cols) { bf16* p = cur; cur += P * cols; return p; };
  Acts acts = {};
  Grads gr = {};
  acts.sv.ec = take(KC);
  for (int i = 0; i < depth; ++i) acts.sv.h[i] = take(W);
  acts.br = take(W);
  acts.ed = take(KD);
  acts.rf = take(HW);
  for (int i = 0; i < depth; ++i) gr.h[i] = take(W);
  gr.br = take(W);
  gr.rf = take(HW);
  gr.gs = take(SMALL);
  gr.gsig = take(SMALL);
  const int chunks = (int)((P + CHUNK - 1) / CHUNK);
  float* part = (float*)((char*)workspace + align256(P * saved_cols(depth) * 2));

  // one job per (layer, input segment)
  Jobs jobs = {};
  int tiles = 0;
  auto add = [&](const bf16* g, int ldg, int n, const bf16* a, int lda, int k,
                 long long w_off, int ldw, long long b_off, const float* b_src) {
    Job& j = jobs.j[jobs.n++];
    j.g = g; j.ldg = ldg; j.n = n; j.a = a; j.lda = lda; j.k = k;
    j.w_off = w_off; j.ldw = ldw; j.b_off = b_off; j.b_src = b_src;
    j.tiles_k = (k + WT - 1) / WT;
    j.tile0 = tiles;
    tiles += ((n + WT - 1) / WT) * j.tiles_k;
  };
  add(gr.h[0], W, W, acts.sv.ec, KC, KC, L.w[0], KC, L.b[0], nullptr);
  for (int i = 1; i < depth; ++i) {
    if (i == skip + 1) {
      add(gr.h[i], W, W, acts.sv.ec, KC, KC, L.w[i], KC + W, L.b[i], nullptr);
      add(gr.h[i], W, W, acts.sv.h[i - 1], W, W, L.w[i] + KC, KC + W, -1, nullptr);
    } else {
      add(gr.h[i], W, W, acts.sv.h[i - 1], W, W, L.w[i], W, L.b[i], nullptr);
    }
  }
  add(gr.br, W, W, acts.sv.h[depth - 1], W, W, L.w[depth], W, L.b[depth], nullptr);
  add(gr.gsig, SMALL, 1, acts.sv.h[depth - 1], W, W, L.w[depth + 1], W, L.b[depth + 1],
      g_sigma);
  add(gr.rf, HW, HW, acts.br, W, W, L.w[depth + 2], W + KD, L.b[depth + 2], nullptr);
  add(gr.rf, HW, HW, acts.ed, KD, KD, L.w[depth + 2] + W, W + KD, -1, nullptr);
  add(gr.gs, SMALL, 3, acts.rf, HW, HW, L.w[depth + 3], HW, L.b[depth + 3], nullptr);

  // partials: every gradient value is written by one block per chunk, but
  // the alignment gaps between layers are not
  err = cudaMemsetAsync(part, 0, (size_t)chunks * nwb * 4, st);
  if (err != cudaSuccess) return (int)err;
  nerf_bwd_tile_kernel<<<(unsigned)((P + T - 1) / T), NTHREADS, TILE_SMEM, st>>>(
      pts_t, dirs_t, g_rgb, g_sigma, P, wb, b, L, depth, skip, acts, gr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  nerf_bwd_wgrad_kernel<<<dim3((unsigned)tiles, (unsigned)chunks), WTHREADS, 0, st>>>(
      jobs, P, part, nwb, nw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  nerf_bwd_reduce_kernel<<<(unsigned)((nwb + 255) / 256), 256, 0, st>>>(part, chunks, nwb, out);
  return (int)cudaGetLastError();
}
