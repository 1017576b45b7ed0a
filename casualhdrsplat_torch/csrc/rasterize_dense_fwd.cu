// Dense per-tile front-to-back alpha compositor, forward (CUDA C++ for
// sm_90a).
//
// Replaces: casualhdrsplat_tpu/ops/rasterize_pallas.py::_fwd_kernel (the
// Pallas TPU kernel launched by `forward`).  Python launcher:
// casualhdrsplat_torch/ops/rasterize_dense.py; differentiable entry point
// and plain PyTorch version: casualhdrsplat_torch/ops/composite.py.
//
// What it computes.  The input is the gathered payload table
// [tiles, capacity, 16]: tile i's own depth-ordered list of payload rows
// (binning.py layout: mx, my, cxx, cxy, cyy, opacity, r, g, b, one, 0...),
// of which the first counts[i] are occupied and the rest are zero pad rows.
// For every pixel of the tile it composites the list front to back:
//     alpha = min(opa * exp(min(power, 0)), clip), 0 below threshold
//     out4 += [r, g, b, one] * alpha * T;   T *= 1 - alpha
// over chunks of G slots, only the ceil(counts[i] / G) occupied ones.  At
// the start of each chunk the tile votes: once no pixel has T >= eps the
// rest of the list is skipped.  This is the TPU kernel's chunk-granular
// early stop; a per-pixel stop would differ from it by up to eps.  The
// tile's pixel origin comes from tile_indices[i] % tiles_per_view, so a
// caller may composite a slice of the tiles with a padded stride.
//
// Design.  The TPU kernel turns a chunk's transmittance into a triangular
// matrix product over log(1 - alpha) and the blend into a (4,G)@(G,P)
// product for its matrix unit.  Here T is a running product and the four
// sums running sums in registers: one CTA per tile, each thread owns PPT
// pixels (strided by blockDim, so the final stores coalesce); a chunk's
// occupied payload rows are staged once in shared memory (G x 64 B, 8 KB at
// G = 128) and read by every thread as broadcasts; the vote is
// __syncthreads_or.  Pad slots past counts[i] are not read at all.  The
// tile's output is written once, at the end.
//
// What bounds it on an H100.  Every occupied slot of a visited chunk is
// evaluated at all P pixels of its tile: about 16 fp32 operations and one
// exp per (slot, pixel) for alpha and 10 more where it blends, against 64
// bytes of table read per slot: the fp32 arithmetic rate bounds it, not memory.
// This first version is plain SIMT code: no tensor cores, no TMA, no
// cross-tile load balancing (a CTA with a full list runs alone at the end).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPayloadDim = 16;
constexpr int kThreads = 256;

template <int PPT>
__global__ void __launch_bounds__(kThreads) rasterize_dense_fwd_kernel(
    const float* __restrict__ gathered, const int* __restrict__ tile_indices,
    const int* __restrict__ counts, float* __restrict__ out, int cap, int P,
    int tile_h, int tile_w, int ntx, int tiles_per_view, int g,
    float alpha_clip, float alpha_threshold, float eps) {
  extern __shared__ float4 chunk_rows[];  // [g * 4] float4 = g payload rows

  const int i = blockIdx.x;
  const int count = min(counts[i], cap);
  const int tile = tile_indices[i] % tiles_per_view;
  const int ox = (tile % ntx) * tile_w;
  const int oy = (tile / ntx) * tile_h;
  const float4* list = reinterpret_cast<const float4*>(gathered) +
                       (size_t)i * cap * (kPayloadDim / 4);

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

  for (int s = 0; s < count; s += g) {
    // tile-wide vote; it is also the barrier that keeps the next staging
    // from overwriting rows still being read
    int live = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) live |= (active[j] && T[j] >= eps);
    if (!__syncthreads_or(live)) break;

    const int n = min(g, count - s);
    const float4* src = list + (size_t)s * (kPayloadDim / 4);
    for (int q = threadIdx.x; q < n * (kPayloadDim / 4); q += blockDim.x)
      chunk_rows[q] = src[q];
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      const float4 q0 = chunk_rows[4 * k + 0];  // mx, my, cxx, cxy
      const float4 q1 = chunk_rows[4 * k + 1];  // cyy, opa, r, g
      const float4 q2 = chunk_rows[4 * k + 2];  // b, one, -, -
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

  float* dst = out + (size_t)i * 4 * P;
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
cudaError_t launch(const float* gathered, const int* tile_indices,
                   const int* counts, float* out, int num_tiles, int threads,
                   int cap, int P, int tile_h, int tile_w, int ntx,
                   int tiles_per_view, int g, float alpha_clip,
                   float alpha_threshold, float eps, cudaStream_t cu_stream) {
  const size_t smem = (size_t)g * kPayloadDim * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_dense_fwd_kernel<PPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  rasterize_dense_fwd_kernel<PPT><<<num_tiles, threads, smem, cu_stream>>>(
      gathered, tile_indices, counts, out, cap, P, tile_h, tile_w, ntx,
      tiles_per_view, g, alpha_clip, alpha_threshold, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code:
// 0 on a successful launch.  Pixels per thread above 16 (P > 4096) are
// refused with cudaErrorInvalidValue; the launcher checks that first.
extern "C" int chs_rasterize_dense_fwd(
    const float* gathered, const int* tile_indices, const int* counts,
    float* out, int num_tiles, int cap, int P, int tile_h, int tile_w, int ntx,
    int tiles_per_view, int g, float alpha_clip, float alpha_threshold,
    float eps, void* cu_stream) {
  if (num_tiles == 0) return (int)cudaSuccess;
  const int threads = P >= kThreads ? kThreads : ((P + 31) / 32) * 32;
  const int ppt = (P + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
#define CHS_LAUNCH(N)                                                         \
  return (int)launch<N>(gathered, tile_indices, counts, out, num_tiles,       \
                        threads, cap, P, tile_h, tile_w, ntx, tiles_per_view, \
                        g, alpha_clip, alpha_threshold, eps, s)
  if (ppt <= 1) CHS_LAUNCH(1);
  if (ppt <= 2) CHS_LAUNCH(2);
  if (ppt <= 4) CHS_LAUNCH(4);
  if (ppt <= 8) CHS_LAUNCH(8);
  if (ppt <= 16) CHS_LAUNCH(16);
#undef CHS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
