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
// row's windows itself, T and the 4-channel sums of its pixels in
// registers; each window's payload rows are staged once in shared memory
// and read as broadcasts; the skip vote is __syncthreads_or.  The row is
// written once, at the end.
//
// - The slot box.  When a window is staged, each slot's pixel box goes
//   into shared memory beside its row (`slot_box`, tile_boxes.cuh,
//   shared with the backward): the bounding box of the ellipse where alpha
//   can reach the threshold, padded against float rounding and clipped to
//   the tile (empty when opa or the clip is under the threshold; the whole
//   tile when the conic is not positive definite or too close to singular
//   for the rounding bound, or a colour is not finite).  Outside it alpha
//   is 0 and the colour finite, so skipping those pairs changes no bit:
//   acc += c * 0, T *= 1.  rasterize_packed.slot_boxes is the same formula
//   in PyTorch.
// - The mapping.  The tile is cut into strips of SW columns (8 where the
//   tile is that wide); warp w owns groups w*PPT .. w*PPT+PPT-1 of 32
//   pixels each, a group being 32/SW consecutive rows of a strip.  On the
//   default 16x128 tile warp w owns columns 16w .. 16w+15 of all 16 rows,
//   and its group j is 4 rows of 8 columns.  So a warp holds a compact
//   block, the box test is warp-uniform twice (per warp, and per group j:
//   pixel j of every lane), and a row's stores are 32-byte runs.  Strips
//   of 8 beat strips of 16 (groups of 2 rows) by 7-15% on the card: a
//   slot's box, ~15 pixels across, meets fewer groups.
// - The skip.  Per 32 slots each lane tests one slot's box against its
//   warp's block and a ballot lists the slots the warp touches; per listed
//   slot, lanes 0..PPT-1 test their group's block and a second ballot
//   lists the groups.  Only those groups evaluate alpha.
// - The row order.  Block b takes row row_order[b]; the wrapper orders the
//   rows by segment length, longest first, so long rows start first and
//   short ones fill the tail.  A row still belongs to one CTA.
//
// What bounds it on an H100.  The function needs about 26 fp32 operations
// and one exp per (slot, pixel) pair the slot touches (alpha >= threshold),
// 64 bytes read per slot it composites and 16 bytes written per pixel of
// every tile; chip_smoke.py counts both.  On 16x128 tiles a slot touches
// 3-7% of the tile.  The kernel still evaluates alpha at the untouched
// pixels of the groups its boxes select, and a row's windows run in one
// CTA, so a row much longer than the rest sets the pace of a small grid.
// Plain SIMT code: no tensor cores, no TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_boxes.cuh"

namespace {

using namespace tile_boxes;

constexpr int kMaxWarps = 8;

template <int PPT>
__global__ void __launch_bounds__(kMaxWarps * 32) rasterize_packed_fwd_kernel(
    const float* __restrict__ stream, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const int* __restrict__ row_order,
    float* __restrict__ out, int P, int tile_h, int tile_w, int ntx,
    int tiles_per_view, int g, int sw_log2, float alpha_clip,
    float alpha_threshold, float eps) {
  extern __shared__ float4 smem[];
  float4* window = smem;                                     // g payload rows
  short4* boxes = reinterpret_cast<short4*>(smem + 4 * g);  // g slot boxes
  // the pixel block of each warp's group j, and at [PPT] the warp's whole block
  __shared__ short4 blocks[kMaxWarps][PPT + 1];

  const int row = row_order[blockIdx.x];
  const int lo = row_lo[row];
  const int hi = row_hi[row];
  const int tile = row % tiles_per_view;
  const int ox = (tile % ntx) * tile_w;
  const int oy = (tile / ntx) * tile_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // this lane's pixels; lane j < PPT keeps the block of the warp's group j
  float px[PPT], py[PPT], T[PPT], acc[4][PPT];
  int pix[PPT];
  int wx0 = kEmptyLo, wx1 = kEmptyHi, wy0 = kEmptyLo, wy1 = kEmptyHi;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    int x, y;
    const bool on = pixel_of<PPT>(warp, lane, j, sw_log2, tile_h, tile_w, &x, &y);
    pix[j] = on ? y * tile_w + x : -1;
    px[j] = (float)(x + ox) + 0.5f;
    py[j] = (float)(y + oy) + 0.5f;
    T[j] = 1.0f;
    acc[0][j] = acc[1][j] = acc[2][j] = acc[3][j] = 0.0f;
    const int bx0 = warp_min(on ? x : kEmptyLo), bx1 = warp_max(on ? x : kEmptyHi);
    const int by0 = warp_min(on ? y : kEmptyLo), by1 = warp_max(on ? y : kEmptyHi);
    if (lane == j) blocks[warp][j] = make_short4(bx0, bx1, by0, by1);
    wx0 = min(wx0, bx0), wx1 = max(wx1, bx1), wy0 = min(wy0, by0), wy1 = max(wy1, by1);
  }
  if (lane == 0) blocks[warp][PPT] = make_short4(wx0, wx1, wy0, wy1);
  // (read after the first window's vote, a barrier)

  if (hi > lo) {
    const int first_block = lo / g;
    const int last_block = (hi - 1) / g;
    for (int b = first_block; b <= last_block; ++b) {
      // tile-wide skip vote; it is also the barrier that keeps the next
      // staging from overwriting rows still being read
      int live = 0;
#pragma unroll
      for (int j = 0; j < PPT; ++j) live |= (pix[j] >= 0 && T[j] >= eps);
      if (!__syncthreads_or(live)) break;

      const int s = max(lo, b * g);
      const int e = min(hi, (b + 1) * g);
      const int n = e - s;
      const float4* src = reinterpret_cast<const float4*>(stream) +
                          (size_t)s * (kPayloadDim / 4);
      for (int i = threadIdx.x; i < n * (kPayloadDim / 4); i += blockDim.x)
        window[i] = src[i];
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        boxes[i] = slot_box(src[4 * i], src[4 * i + 1], src[4 * i + 2], ox, oy, tile_w,
                            tile_h, alpha_clip, alpha_threshold);
      __syncthreads();

      for (int k0 = 0; k0 < n; k0 += 32) {
        // the slots of these 32 whose box meets the warp's block, in order
        unsigned hits = __ballot_sync(
            kFull, k0 + lane < n && meets(boxes[k0 + lane], blocks[warp][PPT]));
        while (hits) {
          const int k = k0 + __ffs(hits) - 1;
          hits &= hits - 1;
          const short4 box = boxes[k];
          const unsigned groups =  // at one pixel a thread the group is the warp's block
              PPT == 1 ? 1u : __ballot_sync(kFull, lane < PPT && meets(box, blocks[warp][lane]));
          const float4 q0 = window[4 * k + 0];  // mx, my, cxx, cxy
          const float4 q1 = window[4 * k + 1];  // cyy, opa, r, g
          const float4 q2 = window[4 * k + 2];  // b, one, -, -
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            if (!((groups >> j) & 1u)) continue;  // alpha is 0 at all 32 pixels
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
  }

  float* dst = out + (size_t)row * 4 * P;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = pix[j];
    if (p >= 0) {
      dst[0 * P + p] = acc[0][j];
      dst[1 * P + p] = acc[1][j];
      dst[2 * P + p] = acc[2][j];
      dst[3 * P + p] = acc[3][j];
    }
  }
}

template <int PPT>
cudaError_t launch(const float* stream, const int* row_lo, const int* row_hi,
                   const int* row_order, float* out, int num_rows, int threads,
                   int P, int tile_h, int tile_w, int ntx, int tiles_per_view,
                   int g, int sw_log2, float alpha_clip, float alpha_threshold,
                   float eps, cudaStream_t cu_stream) {
  const size_t smem = (size_t)g * (kPayloadDim * sizeof(float) + sizeof(short4));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_packed_fwd_kernel<PPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  rasterize_packed_fwd_kernel<PPT><<<num_rows, threads, smem, cu_stream>>>(
      stream, row_lo, row_hi, row_order, out, P, tile_h, tile_w, ntx,
      tiles_per_view, g, sw_log2, alpha_clip, alpha_threshold, eps);
  return cudaGetLastError();
}

// The box of each of n slots on the tile at origin (ox[i], oy[i]), as the
// kernels stage it: slot_box, launched on its own so that tests can hold
// it against rasterize_packed.slot_boxes.
__global__ void slot_boxes_kernel(const float4* __restrict__ stream, const int* __restrict__ ox,
                                  const int* __restrict__ oy, short4* __restrict__ out, int n,
                                  int tile_h, int tile_w, float alpha_clip,
                                  float alpha_threshold) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4* row = stream + (size_t)i * (kPayloadDim / 4);
  out[i] = slot_box(row[0], row[1], row[2], ox[i], oy[i], tile_w, tile_h, alpha_clip,
                    alpha_threshold);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code:
// 0 on a successful launch.  The mapping fits 8 warps of at most 16
// pixels a thread (`plan`); a tile it cannot fit (more than 4096 pixels)
// is refused with cudaErrorInvalidValue, and the wrapper checks that
// first.  row_order is a permutation of the rows.
extern "C" int chs_rasterize_packed_fwd(
    const float* stream, const int* row_lo, const int* row_hi,
    const int* row_order, float* out, int num_rows, int P, int tile_h,
    int tile_w, int ntx, int tiles_per_view, int g, float alpha_clip,
    float alpha_threshold, float eps, void* cu_stream) {
  if (num_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
  int sw_log2, ppt, threads;
  if (!plan(tile_h, tile_w, kMaxWarps, 16, &sw_log2, &ppt, &threads))
    return (int)cudaErrorInvalidValue;
#define CHS_LAUNCH(N)                                                          \
  return (int)launch<N>(stream, row_lo, row_hi, row_order, out, num_rows,      \
                        threads, P, tile_h, tile_w, ntx, tiles_per_view, g,    \
                        sw_log2, alpha_clip, alpha_threshold, eps, s)
  if (ppt == 1) CHS_LAUNCH(1);
  if (ppt == 2) CHS_LAUNCH(2);
  if (ppt == 4) CHS_LAUNCH(4);
  if (ppt == 8) CHS_LAUNCH(8);
  CHS_LAUNCH(16);
#undef CHS_LAUNCH
}

// Plain C entry point of slot_boxes_kernel: out is [n] short4 (x0, x1, y0,
// y1).  Returns a cudaError_t code.
extern "C" int chs_packed_slot_boxes(const float* stream, const int* ox, const int* oy,
                                     void* out, int n, int tile_h, int tile_w,
                                     float alpha_clip, float alpha_threshold,
                                     void* cu_stream) {
  if (n == 0) return (int)cudaSuccess;
  slot_boxes_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(cu_stream)>>>(
      reinterpret_cast<const float4*>(stream), ox, oy, static_cast<short4*>(out), n, tile_h,
      tile_w, alpha_clip, alpha_threshold);
  return (int)cudaGetLastError();
}
