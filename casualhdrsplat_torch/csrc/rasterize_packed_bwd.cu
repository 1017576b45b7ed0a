// Streaming front-to-back alpha compositor, backward (CUDA C++ for sm_90a).
//
// Replaces: casualhdrsplat_tpu/ops/rasterize_packed.py::_bwd_kernel (the
// Pallas TPU kernel launched by `backward`).  Python wrapper and its plain
// PyTorch version: casualhdrsplat_torch/ops/rasterize_packed.py.
//
// What it computes.  Inputs are the depth-sorted stream [M, 16] of the
// forward kernel (rasterize_packed_fwd.cu), the forward's output out4
// [rows, 4, P] and its upstream gradient g4 [rows, 4, P].  Output row r owns
// the stream slots [lo_r, hi_r).  For every slot k of the row and every
// pixel of the row's tile, with T_k rebuilt front to back as the forward
// built it, c4 = (r, g, b, one) of the slot and cg = c4 . g4:
//     w = alpha T_k;  r += w cg  (the scalar suffix carry, slot k included)
//     dL/dalpha = T_k cg - (out4 . g4 - r) / (1 - alpha)
// which is chained through alpha = min(opa exp(power), clip) (zero at the
// clip and under the threshold) and summed over the tile's pixels into
// d(mx, my, cxx, cxy, cyy, opa, r, g, b): columns 0..8 of d_stream[k].
// Columns 9..15, slots no row owns and the windows the early stop skipped
// are left as the wrapper allocated them: zero.  The early stop is the
// forward's: a vote at each G-aligned window on the recomputed T.
//
// Design.  The TPU kernel walks a flat chunk schedule in grid order,
// carries T and r in VMEM scratch, zeroes a stream block on its first visit
// and sums the two visits of a block shared by two tiles.  Here one CTA owns
// one output row and walks its windows itself, as the forward kernel does;
// the row owns its slots, so the CTA writes their gradients with plain
// stores: no atomics, no zeroing pass, the same bits on every run.  Each
// thread owns PPT pixels and keeps their T, r, out4 . g4 and the four g4
// values in registers.  A window is staged in shared memory in pieces of
// SUB slots.  Per slot the nine sums over the tile's pixels are reduced in
// two levels: over a thread's pixels in registers and over the warp with
// shuffles, then lane 0 stores the warp's nine partial sums in shared
// memory; after the piece, the warps' partials are added in a fixed order
// and each slot's nine values are written once.  A warp none of whose
// pixels a slot touches (alpha = 0 at all of them) skips the shuffles: on
// 16x128 tiles most slots touch a small part of the tile.
//
// What bounds it on an H100.  About 16 fp32 operations and one exp per
// (slot, pixel) for alpha, and about 47 more and one division at the pairs
// the slot touches, against 128 bytes per slot (the payload row read, the
// gradient row written): the fp32 arithmetic rate bounds it, as it bounds
// the forward.  The 45 shuffles per (slot, warp) of the reduction come on
// top.  This first version is plain SIMT code: no tensor cores, no
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
__global__ void __launch_bounds__(THREADS) rasterize_packed_bwd_kernel(
    const float* __restrict__ stream, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const float* __restrict__ out4,
    const float* __restrict__ g4, float* __restrict__ d_stream, int P,
    int tile_h, int tile_w, int ntx, int tiles_per_view, int g,
    float alpha_clip, float alpha_threshold, float eps) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float4 window[SUB * (kPayloadDim / 4)];  // SUB payload rows
  __shared__ float partial[WARPS][SUB][kGradCols];

  const int row = blockIdx.x;
  const int lo = row_lo[row];
  const int hi = row_hi[row];
  if (hi <= lo) return;  // the whole CTA: an empty row owns no slot
  const int tile = row % tiles_per_view;
  const int ox = (tile % ntx) * tile_w;
  const int oy = (tile / ntx) * tile_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  const float* o_row = out4 + (size_t)row * 4 * P;
  const float* g_row = g4 + (size_t)row * 4 * P;
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
    if (active[j]) {
      g0[j] = g_row[0 * P + p];
      g1[j] = g_row[1 * P + p];
      g2[j] = g_row[2 * P + p];
      g3[j] = g_row[3 * P + p];
      tot[j] = o_row[0 * P + p] * g0[j] + o_row[1 * P + p] * g1[j] +
               o_row[2 * P + p] * g2[j] + o_row[3 * P + p] * g3[j];
    }
  }

  const int first_block = lo / g;
  const int last_block = (hi - 1) / g;
  for (int b = first_block; b <= last_block; ++b) {
    // the forward's tile-wide skip vote, on the same recomputed T
    int live = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) live |= (active[j] && T[j] >= eps);
    if (!__syncthreads_or(live)) break;

    const int s = max(lo, b * g);
    const int e = min(hi, (b + 1) * g);
    for (int s0 = s; s0 < e; s0 += SUB) {
      const int n = min(SUB, e - s0);
      const float4* src = reinterpret_cast<const float4*>(stream) +
                          (size_t)s0 * (kPayloadDim / 4);
      for (int i = threadIdx.x; i < n * (kPayloadDim / 4); i += blockDim.x)
        window[i] = src[i];
      __syncthreads();

      for (int k = 0; k < n; ++k) {
        const float4 q0 = window[4 * k + 0];  // mx, my, cxx, cxy
        const float4 q1 = window[4 * k + 1];  // cyy, opa, r, g
        const float4 q2 = window[4 * k + 2];  // b, one, -, -
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

      // the warps' partial sums, added in warp order: one store per value
      for (int i = threadIdx.x; i < n * kGradCols; i += blockDim.x) {
        const int k = i / kGradCols;
        const int c = i - k * kGradCols;
        float sum = 0.0f;
        for (int w = 0; w < nwarps; ++w) sum += partial[w][k][c];
        d_stream[(size_t)(s0 + k) * kPayloadDim + c] = sum;
      }
      __syncthreads();  // before the next piece overwrites window and partial
    }
  }
}

template <int PPT, int THREADS, int SUB>
cudaError_t launch(const float* stream, const int* row_lo, const int* row_hi,
                   const float* out4, const float* g4, float* d_stream,
                   int num_rows, int threads, int P, int tile_h, int tile_w,
                   int ntx, int tiles_per_view, int g, float alpha_clip,
                   float alpha_threshold, float eps, cudaStream_t cu_stream) {
  rasterize_packed_bwd_kernel<PPT, THREADS, SUB>
      <<<num_rows, threads, 0, cu_stream>>>(
          stream, row_lo, row_hi, out4, g4, d_stream, P, tile_h, tile_w, ntx,
          tiles_per_view, g, alpha_clip, alpha_threshold, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code: 0
// on a successful launch.  d_stream must come zeroed.  A thread holds at
// most 8 pixels (nine floats of state each): tiles of up to 2048 pixels run
// 256 threads, larger ones up to 4096 pixels run 512; more are refused with
// cudaErrorInvalidValue, and the wrapper checks that first.
extern "C" int chs_rasterize_packed_bwd(
    const float* stream, const int* row_lo, const int* row_hi,
    const float* out4, const float* g4, float* d_stream, int num_rows, int P,
    int tile_h, int tile_w, int ntx, int tiles_per_view, int g,
    float alpha_clip, float alpha_threshold, float eps, void* cu_stream) {
  if (num_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
#define CHS_LAUNCH(N, THREADS, SUB)                                           \
  return (int)launch<N, THREADS, SUB>(                                        \
      stream, row_lo, row_hi, out4, g4, d_stream, num_rows, threads, P,       \
      tile_h, tile_w, ntx, tiles_per_view, g, alpha_clip, alpha_threshold,    \
      eps, s)
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
