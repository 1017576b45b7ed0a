// Streaming front-to-back alpha compositor, forward (CUDA C++ for sm_90a).
//
// Replaces: casualhdrsplat_tpu/ops/rasterize_packed.py::_fwd_kernel (the
// Pallas TPU kernel launched by `forward`).  Python wrapper and its plain
// PyTorch version: casualhdrsplat_torch/ops/rasterize_packed.py.
//
// What it computes.  The input is the depth-sorted intersection stream
// [M, 16] (one payload row per (tile, Gaussian) pair, binning.py layout:
// mx, my, cxx, cxy, cyy, opacity, r, g, b, one, 0...).  Output row r (one
// tile of one view) owns the stream segment [lo_r, hi_r).  For every pixel
// of the tile it composites the segment front to back:
//     alpha = min(opa * exp(min(power, 0)), clip), 0 below threshold
//     out4 += [r, g, b, one] * alpha * T;   T *= 1 - alpha
// over windows of G stream positions aligned to multiples of G, the
// windows the TPU kernel's grid visits.  At the start of each window the
// tile votes: once no pixel has T >= eps the rest of the segment is
// skipped.  This is the TPU kernel's window-granular early stop; a
// per-pixel stop would differ from it by up to eps.
//
// Design.  The TPU kernel walks a flat chunk schedule in grid order and
// carries T in VMEM scratch from one grid step to the next.  CUDA blocks
// run in no order, so here one CTA owns one output row and walks that
// row's windows itself.  Each thread owns PPT pixels of the tile (strided
// by blockDim, so the final stores coalesce) and keeps their T and their
// 4-channel sums in registers; each window's payload rows are staged once
// in shared memory (G x 64 B, 8 KB at G = 128) and read by every thread as
// broadcasts; the skip vote is __syncthreads_or.  The row is written once,
// at the end.
//
// What bounds it on an H100.  Every real intersection is evaluated at all
// P pixels of its tile: about 16 fp32 operations and one exp per
// (slot, pixel) for alpha and 10 more where it blends (alpha above the
// threshold), against 64 bytes of stream read per slot.  That is
// hundreds of operations per byte, so the card's fp32 issue rate bounds
// it, not memory.  This first version is plain SIMT code: no tensor
// cores, no TMA, no cross-tile load balancing (a CTA with a long segment
// runs alone at the end).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPayloadDim = 16;
constexpr int kThreads = 256;

template <int PPT>
__global__ void __launch_bounds__(kThreads) rasterize_packed_fwd_kernel(
    const float* __restrict__ stream, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, float* __restrict__ out, int P, int tile_h,
    int tile_w, int ntx, int tiles_per_view, int g, float alpha_clip,
    float alpha_threshold, float eps) {
  extern __shared__ float4 window[];  // [g * 4] float4 = g payload rows

  const int row = blockIdx.x;
  const int lo = row_lo[row];
  const int hi = row_hi[row];
  const int tile = row % tiles_per_view;
  const int ox = (tile % ntx) * tile_w;
  const int oy = (tile / ntx) * tile_h;

  float px[PPT], py[PPT], T[PPT], acc[4][PPT];
  bool active[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    active[j] = p < P;
    px[j] = (float)(p % tile_w + ox) + 0.5f;
    py[j] = (float)(p / tile_w + oy) + 0.5f;
    T[j] = 1.0f;
    acc[0][j] = acc[1][j] = acc[2][j] = acc[3][j] = 0.0f;
  }

  if (hi > lo) {
    const int first_block = lo / g;
    const int last_block = (hi - 1) / g;
    for (int b = first_block; b <= last_block; ++b) {
      // tile-wide skip vote; it is also the barrier that keeps the next
      // staging from overwriting rows still being read
      int live = 0;
#pragma unroll
      for (int j = 0; j < PPT; ++j) live |= (active[j] && T[j] >= eps);
      if (!__syncthreads_or(live)) break;

      const int s = max(lo, b * g);
      const int e = min(hi, (b + 1) * g);
      const int n = e - s;
      const float4* src = reinterpret_cast<const float4*>(stream) +
                          (size_t)s * (kPayloadDim / 4);
      for (int i = threadIdx.x; i < n * (kPayloadDim / 4); i += blockDim.x)
        window[i] = src[i];
      __syncthreads();

      for (int k = 0; k < n; ++k) {
        const float4 q0 = window[4 * k + 0];  // mx, my, cxx, cxy
        const float4 q1 = window[4 * k + 1];  // cyy, opa, r, g
        const float4 q2 = window[4 * k + 2];  // b, one, -, -
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float dx = px[j] - q0.x;
          const float dy = py[j] - q0.y;
          const float power =
              -(0.5f * (q0.z * dx * dx + q1.x * dy * dy) + q0.w * dx * dy);
          float alpha = fminf(q1.y * expf(fminf(power, 0.0f)), alpha_clip);
          alpha = alpha >= alpha_threshold ? alpha : 0.0f;
          const float w = alpha * T[j];
          acc[0][j] += q1.z * w;
          acc[1][j] += q1.w * w;
          acc[2][j] += q2.x * w;
          acc[3][j] += q2.y * w;
          T[j] *= 1.0f - alpha;
        }
      }
    }
  }

  float* dst = out + (size_t)row * 4 * P;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    if (active[j]) {
      dst[0 * P + p] = acc[0][j];
      dst[1 * P + p] = acc[1][j];
      dst[2 * P + p] = acc[2][j];
      dst[3 * P + p] = acc[3][j];
    }
  }
}

template <int PPT>
cudaError_t launch(const float* stream, const int* row_lo, const int* row_hi,
                   float* out, int num_rows, int threads, int P, int tile_h,
                   int tile_w, int ntx, int tiles_per_view, int g,
                   float alpha_clip, float alpha_threshold, float eps,
                   cudaStream_t cu_stream) {
  const size_t smem = (size_t)g * kPayloadDim * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_packed_fwd_kernel<PPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  rasterize_packed_fwd_kernel<PPT><<<num_rows, threads, smem, cu_stream>>>(
      stream, row_lo, row_hi, out, P, tile_h, tile_w, ntx, tiles_per_view, g,
      alpha_clip, alpha_threshold, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code:
// 0 on a successful launch.  Pixels per thread above 16 (P > 4096) are
// refused with cudaErrorInvalidValue; the wrapper checks that first.
extern "C" int chs_rasterize_packed_fwd(
    const float* stream, const int* row_lo, const int* row_hi, float* out,
    int num_rows, int P, int tile_h, int tile_w, int ntx, int tiles_per_view,
    int g, float alpha_clip, float alpha_threshold, float eps,
    void* cu_stream) {
  if (num_rows == 0) return (int)cudaSuccess;
  const int threads = P >= kThreads ? kThreads : ((P + 31) / 32) * 32;
  const int ppt = (P + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
#define CHS_LAUNCH(N)                                                        \
  return (int)launch<N>(stream, row_lo, row_hi, out, num_rows, threads, P,   \
                        tile_h, tile_w, ntx, tiles_per_view, g, alpha_clip,  \
                        alpha_threshold, eps, s)
  if (ppt <= 1) CHS_LAUNCH(1);
  if (ppt <= 2) CHS_LAUNCH(2);
  if (ppt <= 4) CHS_LAUNCH(4);
  if (ppt <= 8) CHS_LAUNCH(8);
  if (ppt <= 16) CHS_LAUNCH(16);
#undef CHS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
