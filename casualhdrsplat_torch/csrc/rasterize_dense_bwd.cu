// Dense per-tile front-to-back alpha compositor, backward (CUDA C++ for
// sm_90a).
//
// Replaces: casualhdrsplat_tpu/ops/rasterize_pallas.py::_bwd_kernel (the
// Pallas TPU kernel launched by `backward`).  Python launcher:
// casualhdrsplat_torch/ops/rasterize_dense.py; differentiable entry point
// and plain PyTorch version: casualhdrsplat_torch/ops/composite.py.
//
// What it computes.  Inputs are the gathered payload table
// [tiles, capacity, 16] of the forward kernel (rasterize_dense_fwd.cu), the
// forward's output out4 [tiles, 4, P] and its upstream gradient g4
// [tiles, 4, P].  For every occupied slot k of tile i's list and every pixel
// of the tile, with T_k rebuilt front to back as the forward built it,
// c4 = (r, g, b, one) of the slot and cg = c4 . g4:
//     w = alpha T_k;  r += w cg  (the scalar suffix carry, slot k included)
//     dL/dalpha = T_k cg - (out4 . g4 - r) / (1 - alpha)
// which is chained through alpha = min(opa exp(power), clip) (zero at the
// clip and under the threshold) and summed over the tile's pixels into
// d(mx, my, cxx, cxy, cyy, opa, r, g, b): columns 0..8 of d_gathered[i][k].
// The kernel writes every row of d_gathered[i]: columns 9..15, the pad slots
// from counts[i] on and the chunks the early stop skipped are zero, as in the
// TPU kernel, which zeroes the tile's block first.  The early stop is the
// forward's: a vote at each chunk of G slots on the recomputed T.
//
// Design.  The TPU kernel forms a chunk's T and its suffix term as
// triangular matrix products and the nine sums as (G,P)@(P,k) products.
// Here one CTA owns one tile, as in the forward kernel; T and the carry r
// are running values in registers beside out4 . g4 and the four g4 values
// of each of a thread's PPT pixels.  A chunk's occupied rows are staged in
// shared memory in pieces of SUB slots.  Per slot the nine sums over the
// tile's pixels are reduced in two levels: over a thread's pixels in
// registers and over the warp with shuffles, then lane 0 stores the warp's
// nine partial sums in shared memory; after the piece, the warps' partials
// are added in a fixed order and each slot's row is written once, its seven
// unused columns as zeros.  A warp none of whose pixels a slot touches
// (alpha = 0 at all of them) skips the shuffles.  The tile owns its rows:
// plain stores, no atomics, the same bits on every run.  Rows the loop did
// not reach are zeroed at the end with 16-byte stores.
//
// What bounds it on an H100.  About 16 fp32 operations and one exp per
// (occupied slot, pixel) for alpha, and about 47 more and one division at
// the pairs the slot touches, against 64 bytes read per occupied slot and 64
// bytes written per slot of the whole table, occupied or not.  On sparse
// tables the bytes of the gradient table are the larger term, on full ones
// the fp32 arithmetic.  The 45 shuffles per (slot, warp) of the reduction
// come on top.  This first version is plain SIMT code: no tensor cores, no
// TMA, no cross-tile load balancing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPayloadDim = 16;
// gradient columns = payload columns 0..8: mx, my, cxx, cxy, cyy, opa, r, g, b
constexpr int kGradCols = 9;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int PPT, int THREADS, int SUB>
__global__ void __launch_bounds__(THREADS) rasterize_dense_bwd_kernel(
    const float* __restrict__ gathered, const int* __restrict__ tile_indices,
    const int* __restrict__ counts, const float* __restrict__ out4,
    const float* __restrict__ g4, float* __restrict__ d_gathered, int cap,
    int P, int tile_h, int tile_w, int ntx, int tiles_per_view, int g,
    float alpha_clip, float alpha_threshold, float eps) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float4 piece[SUB * (kPayloadDim / 4)];  // SUB payload rows
  __shared__ float partial[WARPS][SUB][kGradCols];

  const int i = blockIdx.x;
  const int count = min(counts[i], cap);
  const int tile = tile_indices[i] % tiles_per_view;
  const int ox = (tile % ntx) * tile_w;
  const int oy = (tile / ntx) * tile_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float4* list = reinterpret_cast<const float4*>(gathered) +
                       (size_t)i * cap * (kPayloadDim / 4);
  float* d_list = d_gathered + (size_t)i * cap * kPayloadDim;

  const float* o_row = out4 + (size_t)i * 4 * P;
  const float* g_row = g4 + (size_t)i * 4 * P;
  float px[PPT], py[PPT], T[PPT], r[PPT], tot[PPT];
  float g0[PPT], g1[PPT], g2[PPT], g3[PPT];
  bool active[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    active[j] = p < P;
    px[j] = (float)(p % tile_w + ox) + 0.5f;
    py[j] = (float)(p / tile_w + oy) + 0.5f;
    T[j] = 1.0f;
    r[j] = 0.0f;
    g0[j] = g1[j] = g2[j] = g3[j] = tot[j] = 0.0f;
    if (active[j] && count > 0) {
      g0[j] = g_row[0 * P + p];
      g1[j] = g_row[1 * P + p];
      g2[j] = g_row[2 * P + p];
      g3[j] = g_row[3 * P + p];
      tot[j] = o_row[0 * P + p] * g0[j] + o_row[1 * P + p] * g1[j] +
               o_row[2 * P + p] * g2[j] + o_row[3 * P + p] * g3[j];
    }
  }

  int done = 0;  // rows of the list whose gradient has been written
  for (int s = 0; s < count; s += g) {
    // the forward's tile-wide vote, on the same recomputed T
    int live = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) live |= (active[j] && T[j] >= eps);
    if (!__syncthreads_or(live)) break;

    const int e = min(count, s + g);
    for (int s0 = s; s0 < e; s0 += SUB) {
      const int n = min(SUB, e - s0);
      const float4* src = list + (size_t)s0 * (kPayloadDim / 4);
      for (int q = threadIdx.x; q < n * (kPayloadDim / 4); q += blockDim.x)
        piece[q] = src[q];
      __syncthreads();

      for (int k = 0; k < n; ++k) {
        const float4 q0 = piece[4 * k + 0];  // mx, my, cxx, cxy
        const float4 q1 = piece[4 * k + 1];  // cyy, opa, r, g
        const float4 q2 = piece[4 * k + 2];  // b, one, -, -
        float a_mx = 0.0f, a_my = 0.0f, a_cxx = 0.0f, a_cxy = 0.0f, a_cyy = 0.0f;
        float a_opa = 0.0f, a_r = 0.0f, a_g = 0.0f, a_b = 0.0f;
        bool touched = false;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float dx = px[j] - q0.x;
          const float dy = py[j] - q0.y;
          const float power =
              -(0.5f * (q0.z * dx * dx + q1.x * dy * dy) + q0.w * dx * dy);
          const float ex = expf(fminf(power, 0.0f));
          const float alpha_raw = q1.y * ex;
          float alpha = fminf(alpha_raw, alpha_clip);
          alpha = alpha >= alpha_threshold ? alpha : 0.0f;
          if (alpha > 0.0f && active[j]) {
            touched = true;
            const float t_k = T[j];
            const float w = alpha * t_k;
            const float cg = q1.z * g0[j] + q1.w * g1[j] + q2.x * g2[j] + q2.y * g3[j];
            r[j] += w * cg;  // inclusive: slot k itself before term2
            const float one_minus = 1.0f - alpha;  // >= 1 - clip > 0
            const float dl_da = t_k * cg - (tot[j] - r[j]) / one_minus;
            const float g_a = alpha_raw < alpha_clip ? dl_da : 0.0f;
            const float g_pw = g_a * alpha;
            a_mx += g_pw * (q0.z * dx + q0.w * dy);
            a_my += g_pw * (q1.x * dy + q0.w * dx);
            a_cxx += g_pw * (-0.5f * dx * dx);
            a_cxy += g_pw * (-dx * dy);
            a_cyy += g_pw * (-0.5f * dy * dy);
            a_opa += g_a * ex;
            a_r += w * g0[j];
            a_g += w * g1[j];
            a_b += w * g2[j];
            T[j] = t_k * one_minus;
          }
        }
        if (__any_sync(0xffffffffu, touched)) {
          a_mx = warp_sum(a_mx);
          a_my = warp_sum(a_my);
          a_cxx = warp_sum(a_cxx);
          a_cxy = warp_sum(a_cxy);
          a_cyy = warp_sum(a_cyy);
          a_opa = warp_sum(a_opa);
          a_r = warp_sum(a_r);
          a_g = warp_sum(a_g);
          a_b = warp_sum(a_b);
        }
        if (lane == 0) {
          float* d = partial[warp][k];
          d[0] = a_mx;
          d[1] = a_my;
          d[2] = a_cxx;
          d[3] = a_cxy;
          d[4] = a_cyy;
          d[5] = a_opa;
          d[6] = a_r;
          d[7] = a_g;
          d[8] = a_b;
        }
      }
      __syncthreads();

      // the warps' partial sums, added in warp order: each slot's 16 columns
      // are stored once, the seven that carry no gradient as zeros
      for (int q = threadIdx.x; q < n * kPayloadDim; q += blockDim.x) {
        const int k = q / kPayloadDim;
        const int c = q - k * kPayloadDim;
        float sum = 0.0f;
        if (c < kGradCols)
          for (int w = 0; w < nwarps; ++w) sum += partial[w][k][c];
        d_list[(size_t)(s0 + k) * kPayloadDim + c] = sum;
      }
      __syncthreads();  // before the next piece overwrites piece and partial
    }
    done = e;
  }

  // pad slots, and the chunks the early stop skipped
  float4* d_rest = reinterpret_cast<float4*>(d_list + (size_t)done * kPayloadDim);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q = threadIdx.x; q < (cap - done) * (kPayloadDim / 4); q += blockDim.x)
    d_rest[q] = zero;
}

template <int PPT, int THREADS, int SUB>
cudaError_t launch(const float* gathered, const int* tile_indices,
                   const int* counts, const float* out4, const float* g4,
                   float* d_gathered, int num_tiles, int threads, int cap, int P,
                   int tile_h, int tile_w, int ntx, int tiles_per_view, int g,
                   float alpha_clip, float alpha_threshold, float eps,
                   cudaStream_t cu_stream) {
  rasterize_dense_bwd_kernel<PPT, THREADS, SUB>
      <<<num_tiles, threads, 0, cu_stream>>>(
          gathered, tile_indices, counts, out4, g4, d_gathered, cap, P, tile_h,
          tile_w, ntx, tiles_per_view, g, alpha_clip, alpha_threshold, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code: 0
// on a successful launch.  d_gathered may come uninitialised: the kernel
// writes all of it.  A thread holds at most 8 pixels (nine floats of state
// each): tiles of up to 2048 pixels run 256 threads, larger ones up to 4096
// pixels run 512; more are refused with cudaErrorInvalidValue, and the
// launcher checks that first.
extern "C" int chs_rasterize_dense_bwd(
    const float* gathered, const int* tile_indices, const int* counts,
    const float* out4, const float* g4, float* d_gathered, int num_tiles,
    int cap, int P, int tile_h, int tile_w, int ntx, int tiles_per_view, int g,
    float alpha_clip, float alpha_threshold, float eps, void* cu_stream) {
  if (num_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
#define CHS_LAUNCH(N, THREADS, SUB)                                            \
  return (int)launch<N, THREADS, SUB>(                                         \
      gathered, tile_indices, counts, out4, g4, d_gathered, num_tiles,         \
      threads, cap, P, tile_h, tile_w, ntx, tiles_per_view, g, alpha_clip,     \
      alpha_threshold, eps, s)
  if (P <= 2048) {
    const int threads = P >= 256 ? 256 : ((P + 31) / 32) * 32;
    const int ppt = (P + threads - 1) / threads;
    if (ppt <= 1) CHS_LAUNCH(1, 256, 128);
    if (ppt <= 2) CHS_LAUNCH(2, 256, 128);
    if (ppt <= 4) CHS_LAUNCH(4, 256, 128);
    CHS_LAUNCH(8, 256, 128);
  }
  if (P <= 4096) {
    const int threads = 512;
    CHS_LAUNCH(8, 512, 64);
  }
#undef CHS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
