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
// stores: no atomics on device memory, no zeroing pass, the same bits on
// every run.  Each thread keeps T, r, out4 . g4 and the four g4 values of
// its pixels in registers.  A window is staged in shared memory in pieces
// of SUB slots.  The forward's design carries over:
// - the slot box (`slot_box` in tile_boxes.cuh, the forward's own) is
//   computed per staged slot; outside it alpha is 0, where the gradient
//   has no term;
// - the mapping gives each warp a compact block of the tile (strips of 8
//   columns; on 16x128 warp w owns columns 16w .. 16w+15), groups of 32
//   pixels (4 rows of 8 columns) per unrolled j, and two ballots list the
//   slots a warp's block meets and the groups a slot's box meets; only
//   those evaluate alpha;
// - the row order is the wrapper's, longest segment first.
// The reduction.  A warp that a listed slot touches (alpha > 0 at one of
// its pixels) reduces its nine sums by a recursive-halving reduce-scatter
// over the lanes (12 shuffles: 9 values split 5 + 4 at offset 16, 3 + 2 at
// 8, 2 + 1 at 4, 1 + 1 at 2, a sum at 1); the lanes that end with a column
// store it in the warp's partial row in shared memory and the warp sets
// its bit in the slot's mask.  After the piece each slot's columns are the
// partials of the warps in its mask, added in warp order, and written once.
// A warp that does not touch the slot does nothing.  Every order is fixed,
// so two launches give the same bits.
//
// What bounds it on an H100.  The function needs about 16 fp32 operations
// and one exp for alpha and 47 more and one division for the gradient at
// every (slot, pixel) pair the slot touches, 128 bytes per slot it visits
// (the payload row read, the gradient row written) and 32 bytes per pixel
// of every tile (out4 and g4 read); chip_smoke.py counts both.  The kernel
// still evaluates alpha at the untouched pixels of the groups its boxes
// select, and pays 12 shuffles per touching (slot, warp).  Plain SIMT code:
// no tensor cores, no TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_boxes.cuh"

namespace {

using namespace tile_boxes;

// gradient columns = payload columns 0..8: mx, my, cxx, cxy, cyy, opa, r, g, b
constexpr int kGradCols = 9;
// Column each lane ends the reduce-scatter with, by lane bits 4..1 (nibble
// (lane >> 1) & 15); 15 = none.
constexpr unsigned long long kLaneColumn = 0xFFF8F765FF43F210ull;

// One step of the reduce-scatter: the lane keeps `lo` (lower half of the
// pair of lanes `off` apart) or `hi` (upper half) and adds its partner's.
__device__ __forceinline__ float halve(float lo, float hi, bool upper, int off) {
  const float send = upper ? lo : hi;
  return (upper ? hi : lo) + __shfl_xor_sync(kFull, send, off);
}

template <int PPT, int THREADS, int SUB>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS / 4)
rasterize_packed_bwd_kernel(
    const float* __restrict__ stream, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const int* __restrict__ row_order,
    const float* __restrict__ out4, const float* __restrict__ g4,
    float* __restrict__ d_stream, int P, int tile_h, int tile_w, int ntx,
    int tiles_per_view, int g, int sw_log2, float alpha_clip,
    float alpha_threshold, float eps) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float4 window[SUB * (kPayloadDim / 4)];  // SUB payload rows
  __shared__ short4 boxes[SUB];
  __shared__ float partial[WARPS][SUB][kGradCols];
  __shared__ unsigned warps_of[SUB];  // bit w: warp w wrote partial[w][k]
  // the pixel block of each warp's group j, and at [PPT] the warp's whole block
  __shared__ short4 blocks[WARPS][PPT + 1];

  const int row = row_order[blockIdx.x];
  const int lo = row_lo[row];
  const int hi = row_hi[row];
  if (hi <= lo) return;  // the whole CTA: an empty row owns no slot
  const int tile = row % tiles_per_view;
  const int ox = (tile % ntx) * tile_w;
  const int oy = (tile / ntx) * tile_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int column = (int)((kLaneColumn >> (4 * ((lane >> 1) & 15))) & 15);

  const float* o_row = out4 + (size_t)row * 4 * P;
  const float* g_row = g4 + (size_t)row * 4 * P;
  float px[PPT], py[PPT], T[PPT], r[PPT], tot[PPT];
  float g0[PPT], g1[PPT], g2[PPT], g3[PPT];
  bool active[PPT];
  int wx0 = kEmptyLo, wx1 = kEmptyHi, wy0 = kEmptyLo, wy1 = kEmptyHi;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    int x, y;
    active[j] = pixel_of<PPT>(warp, lane, j, sw_log2, tile_h, tile_w, &x, &y);
    px[j] = (float)(x + ox) + 0.5f;
    py[j] = (float)(y + oy) + 0.5f;
    T[j] = 1.0f;
    r[j] = 0.0f;
    g0[j] = g1[j] = g2[j] = g3[j] = tot[j] = 0.0f;
    if (active[j]) {
      const int p = y * tile_w + x;
      g0[j] = g_row[0 * P + p];
      g1[j] = g_row[1 * P + p];
      g2[j] = g_row[2 * P + p];
      g3[j] = g_row[3 * P + p];
      tot[j] = o_row[0 * P + p] * g0[j] + o_row[1 * P + p] * g1[j] +
               o_row[2 * P + p] * g2[j] + o_row[3 * P + p] * g3[j];
    }
    const bool on = active[j];
    const int bx0 = warp_min(on ? x : kEmptyLo), bx1 = warp_max(on ? x : kEmptyHi);
    const int by0 = warp_min(on ? y : kEmptyLo), by1 = warp_max(on ? y : kEmptyHi);
    if (lane == j) blocks[warp][j] = make_short4(bx0, bx1, by0, by1);
    wx0 = min(wx0, bx0), wx1 = max(wx1, bx1), wy0 = min(wy0, by0), wy1 = max(wy1, by1);
  }
  if (lane == 0) blocks[warp][PPT] = make_short4(wx0, wx1, wy0, wy1);
  // (read after the first window's vote, a barrier)

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
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        boxes[i] = slot_box(src[4 * i], src[4 * i + 1], src[4 * i + 2], ox, oy, tile_w,
                            tile_h, alpha_clip, alpha_threshold);
        warps_of[i] = 0u;
      }
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
          float a[kGradCols] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          bool touched = false;
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            if (!((groups >> j) & 1u)) continue;  // alpha is 0 at all 32 pixels
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
              a[0] += g_pw * (q0.z * dx + q0.w * dy);
              a[1] += g_pw * (q1.x * dy + q0.w * dx);
              a[2] += g_pw * (-0.5f * dx * dx);
              a[3] += g_pw * (-dx * dy);
              a[4] += g_pw * (-0.5f * dy * dy);
              a[5] += g_a * ex;
              a[6] += w * g0[j];
              a[7] += w * g1[j];
              a[8] += w * g2[j];
              T[j] = t_k * one_minus;
            }
          }
          if (!__any_sync(kFull, touched)) continue;
          // reduce-scatter: 9 columns over 32 lanes in 12 shuffles
          bool up = lane & 16;
          float h5[5], h3[3], h2[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) h5[i] = halve(a[i], a[5 + i], up, 16);
          h5[4] = halve(a[4], 0.0f, up, 16);
          up = lane & 8;
          h3[0] = halve(h5[0], h5[3], up, 8);
          h3[1] = halve(h5[1], h5[4], up, 8);
          h3[2] = halve(h5[2], 0.0f, up, 8);
          up = lane & 4;
          h2[0] = halve(h3[0], h3[2], up, 4);
          h2[1] = halve(h3[1], 0.0f, up, 4);
          float z = halve(h2[0], h2[1], lane & 2, 2);
          z += __shfl_xor_sync(kFull, z, 1);
          if (!(lane & 1) && column < kGradCols) partial[warp][k][column] = z;
          if (lane == 0) atomicOr(&warps_of[k], 1u << warp);
        }
      }
      __syncthreads();

      // the touching warps' partial sums, added in warp order: one store per value
      for (int i = threadIdx.x; i < n * kGradCols; i += blockDim.x) {
        const int k = i / kGradCols;
        const int c = i - k * kGradCols;
        float sum = 0.0f;
        for (unsigned m = warps_of[k]; m; m &= m - 1) sum += partial[__ffs(m) - 1][k][c];
        d_stream[(size_t)(s0 + k) * kPayloadDim + c] = sum;
      }
      __syncthreads();  // before the next piece overwrites window and partial
    }
  }
}

template <int PPT, int THREADS, int SUB>
cudaError_t launch(const float* stream, const int* row_lo, const int* row_hi,
                   const int* row_order, const float* out4, const float* g4,
                   float* d_stream, int num_rows, int threads, int P, int tile_h,
                   int tile_w, int ntx, int tiles_per_view, int g, int sw_log2,
                   float alpha_clip, float alpha_threshold, float eps,
                   cudaStream_t cu_stream) {
  rasterize_packed_bwd_kernel<PPT, THREADS, SUB>
      <<<num_rows, threads, 0, cu_stream>>>(
          stream, row_lo, row_hi, row_order, out4, g4, d_stream, P, tile_h,
          tile_w, ntx, tiles_per_view, g, sw_log2, alpha_clip, alpha_threshold,
          eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code: 0
// on a successful launch.  d_stream must come zeroed; row_order is a
// permutation of the rows.  A thread holds at most 8 pixels (nine floats of
// state each): tiles whose padded strips fit 8 warps run the 256-thread
// variant, those that fit 16 the 512-thread one (every tile of up to 4096
// pixels fits one); more are refused with cudaErrorInvalidValue, and the
// wrapper checks that first.
extern "C" int chs_rasterize_packed_bwd(
    const float* stream, const int* row_lo, const int* row_hi,
    const int* row_order, const float* out4, const float* g4, float* d_stream,
    int num_rows, int P, int tile_h, int tile_w, int ntx, int tiles_per_view,
    int g, float alpha_clip, float alpha_threshold, float eps, void* cu_stream) {
  if (num_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
  int sw_log2, ppt, threads;
#define CHS_LAUNCH(N, THREADS, SUB)                                            \
  return (int)launch<N, THREADS, SUB>(                                         \
      stream, row_lo, row_hi, row_order, out4, g4, d_stream, num_rows,         \
      threads, P, tile_h, tile_w, ntx, tiles_per_view, g, sw_log2, alpha_clip, \
      alpha_threshold, eps, s)
  if (plan(tile_h, tile_w, 8, 8, &sw_log2, &ppt, &threads)) {
    if (ppt == 1) CHS_LAUNCH(1, 256, 128);
    if (ppt == 2) CHS_LAUNCH(2, 256, 128);
    if (ppt == 4) CHS_LAUNCH(4, 256, 128);
    CHS_LAUNCH(8, 256, 128);
  }
  if (plan(tile_h, tile_w, 16, 8, &sw_log2, &ppt, &threads) && ppt == 8)
    CHS_LAUNCH(8, 512, 64);
#undef CHS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
