// Dense per-tile front-to-back alpha compositor, backward (CUDA C++ for
// sm_90a).
//
// Replaces: casualhdrsplat_tpu/ops/rasterize_pallas.py::_bwd_kernel (the
// Pallas TPU kernel launched by `backward`).  Python launcher:
// casualhdrsplat_torch/ops/rasterize_dense.py; differentiable entry points
// and plain PyTorch versions: casualhdrsplat_torch/ops/composite.py.
//
// What it computes.  Inputs are the lists of the forward kernel
// (rasterize_dense_fwd.cu: the list form, payload rows through the id
// table, or the table form), the forward's output out4 [tiles, 4, P] and its
// upstream gradient g4 [tiles, 4, P].  For every slot k a tile reads and
// every pixel of the tile, with T_k rebuilt front to back as the forward
// built it, c4 = (r, g, b, one) of the slot and cg = c4 . g4:
//     w = alpha T_k;  r += w cg  (the scalar suffix carry, slot k included)
//     dL/dalpha = T_k cg - (out4 . g4 - r) / (1 - alpha)
// which is chained through alpha = min(opa exp(power), clip) (zero at the
// clip and under the threshold) and summed over the tile's pixels into
// d(mx, my, cxx, cxy, cyy, opa, r, g, b), which is added into columns 0..8
// of the slot's row of d_rows, laid out as rows.  The launcher zeroes
// d_rows: columns 9..15, rows no tile reads (the pad row among them), slots
// the early stop skipped and slots no pixel touched stay zero.  The early
// stop is the forward's: a vote at each chunk of G slots on the recomputed T.
//
// Design.  The TPU kernel forms a chunk's T and its suffix term as
// triangular matrix products and the nine sums as (G,P)@(P,k) products,
// and writes a gradient table that XLA scatters back to the payload rows.
// Here one CTA owns one tile, as in the forward kernel; T and the carry r
// are running values in registers beside out4 . g4 and the four g4 values
// of each of a thread's pixels.
// - Staging, the slot box, the warps' pixel blocks and the two ballots are
//   the forward's (rasterize_dense_fwd.cu, tile_boxes.cuh), in pieces of
//   SUB slots.
// - The sums are B2's (rasterize_packed_bwd.cu): a warp that a listed slot
//   touches (alpha > 0 at one of its pixels) reduces its nine sums by a
//   recursive-halving reduce-scatter over the lanes (12 shuffles), stores
//   them in its partial row in shared memory and sets its bit in the slot's
//   warp mask.  After the piece, one thread per slot adds the partials of
//   the warps in its mask, in warp order.
// - The gradient: that thread adds the nine sums into the slot's row of
//   d_rows with float atomics (two float4 and one float; vector atomicAdd
//   in global memory is sm_90's), once per (tile, slot).  So the gradient
//   goes straight to the payload rows, a few dozen MB: no [tiles, capacity,
//   16] gradient table is written and no scatter runs after the kernel.  A
//   payload row is read by at most max_tiles_per_gaussian tiles of its
//   view, so the atomics rarely meet.
// Determinism.  The table form adds once to each element of a zeroed
// destination, so two launches give the same bits.  In the list form a row
// that several tiles read sums their adds in the order the atomics land,
// which changes from run to run in the low bits, as the index_add_ it
// replaces did.
//
// What bounds it on an H100.  About 16 fp32 operations and one exp per
// (slot, pixel) pair the slot touches for alpha, and about 47 more and one
// division for the gradient, against the forward's reads (each visited
// slot's id, 40 bytes of each distinct payload row named), 32 bytes per
// pixel of every tile (out4 and g4) and the whole gradient [V (N + 1), 16]
// written once; chip_smoke.py counts them.  The kernel still
// evaluates alpha at the untouched pixels of the groups its boxes select,
// and pays 12 shuffles per touching (slot, warp).  Plain SIMT code: no
// tensor cores, no TMA.

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

// At one pixel a thread (the dense path's 16x16 tiles) four CTAs of 256
// threads share an SM, so at most 64 registers; more pixels a thread keep
// their state in registers at two.
template <int PPT, int THREADS, int SUB>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS / (PPT == 1 ? 2 : 4))
rasterize_dense_bwd_kernel(
    const float* __restrict__ rows, const int* __restrict__ ids,
    const int* __restrict__ tile_indices, const int* __restrict__ counts,
    const float* __restrict__ out4, const float* __restrict__ g4,
    float* __restrict__ d_rows, int cap, int view_rows, int views, int P, int tile_h,
    int tile_w, int ntx, int tiles_per_view, int g, int sw_log2, float alpha_clip,
    float alpha_threshold, float eps) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float4 staged[2][SUB * kStagedParts];  // two pieces of payload rows
  __shared__ int row_of[2][SUB];              // and their rows
  __shared__ short4 boxes[SUB];
  __shared__ float partial[WARPS][SUB][kGradCols];
  __shared__ unsigned warps_of[SUB];  // bit w: warp w wrote partial[w][k]
  // the pixel block of each warp's group j, and at [PPT] the warp's whole block
  __shared__ short4 blocks[WARPS][PPT + 1];

  const int i = blockIdx.x;
  const int index = tile_indices[i];
  // a list-form tile whose view lies outside the rows reads nothing
  const bool in_rows = !ids || (index >= 0 && index / tiles_per_view < views);
  const int count = in_rows ? min(counts[i], cap) : 0;
  if (count <= 0) return;  // the whole CTA: an empty list has no gradient
  const int tile = index % tiles_per_view;
  const int ox = (tile % ntx) * tile_w;
  const int oy = (tile / ntx) * tile_h;
  const size_t first_row =
      !ids ? (size_t)i * cap : in_rows ? (size_t)(index / tiles_per_view) * view_rows : 0;
  const int nrows = ids ? view_rows : cap;  // rows a slot may name
  const float4* base = reinterpret_cast<const float4*>(rows) + first_row * (kPayloadDim / 4);
  float* d_base = d_rows + first_row * kPayloadDim;
  const int* list = ids ? ids + (size_t)i * cap : nullptr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int column = (int)((kLaneColumn >> (4 * ((lane >> 1) & 15))) & 15);

  const float* o_row = out4 + (size_t)i * 4 * P;
  const float* g_row = g4 + (size_t)i * 4 * P;
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
  // (read after the first piece's vote, a barrier)

  // piece j holds slots [s0, s0 + n), inside one chunk
  stage_rows(staged[0], row_of[0], base, list, nrows, 0, min(SUB, min(g, count)));
  copy_async_commit();
  for (int j = 0, s0 = 0; s0 < count; ++j) {
    const int n = min(SUB, min(count, (s0 / g + 1) * g) - s0);
    const int s1 = s0 + n;
    if (s0 % g == 0) {
      // the forward's tile-wide vote, on the same recomputed T
      int live = 0;
#pragma unroll
      for (int k = 0; k < PPT; ++k) live |= (active[k] && T[k] >= eps);
      if (!__syncthreads_or(live)) break;
    } else {
      __syncthreads();
    }
    // every thread is done with piece j - 1, whose buffers piece j + 1 takes
    if (s1 < count)
      stage_rows(staged[(j + 1) & 1], row_of[(j + 1) & 1], base, list, nrows, s1,
                 min(SUB, min(count, (s1 / g + 1) * g) - s1));
    copy_async_commit();
    copy_async_wait<1>();  // this thread's copies of piece j have landed
    __syncthreads();
    const float4* piece = staged[j & 1];
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float4* q = piece + kStagedParts * k;
      boxes[k] = slot_box(q[0], q[1], q[2], ox, oy, tile_w, tile_h, alpha_clip, alpha_threshold);
      warps_of[k] = 0u;
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
        const float4* q = piece + kStagedParts * k;
        const float4 q0 = q[0];  // mx, my, cxx, cxy
        const float4 q1 = q[1];  // cyy, opa, r, g
        const float4 q2 = q[2];  // b, one, -, -
        float a[kGradCols] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        bool touched = false;
#pragma unroll
        for (int p = 0; p < PPT; ++p) {
          if (!((groups >> p) & 1u)) continue;  // alpha is 0 at all 32 pixels
          const float dx = px[p] - q0.x;
          const float dy = py[p] - q0.y;
          const float power = -(0.5f * (q0.z * dx * dx + q1.x * dy * dy) + q0.w * dx * dy);
          const float ex = expf(fminf(power, 0.0f));
          const float alpha_raw = q1.y * ex;
          float alpha = fminf(alpha_raw, alpha_clip);
          alpha = alpha >= alpha_threshold ? alpha : 0.0f;
          if (alpha > 0.0f && active[p]) {
            touched = true;
            const float t_k = T[p];
            const float w = alpha * t_k;
            const float cg = q1.z * g0[p] + q1.w * g1[p] + q2.x * g2[p] + q2.y * g3[p];
            r[p] += w * cg;  // inclusive: slot k itself before term2
            const float one_minus = 1.0f - alpha;  // >= 1 - clip > 0
            const float dl_da = t_k * cg - (tot[p] - r[p]) / one_minus;
            const float g_a = alpha_raw < alpha_clip ? dl_da : 0.0f;
            const float g_pw = g_a * alpha;
            a[0] += g_pw * (q0.z * dx + q0.w * dy);
            a[1] += g_pw * (q1.x * dy + q0.w * dx);
            a[2] += g_pw * (-0.5f * dx * dx);
            a[3] += g_pw * (-dx * dy);
            a[4] += g_pw * (-0.5f * dy * dy);
            a[5] += g_a * ex;
            a[6] += w * g0[p];
            a[7] += w * g1[p];
            a[8] += w * g2[p];
            T[p] = t_k * one_minus;
          }
        }
        if (!__any_sync(kFull, touched)) continue;
        // reduce-scatter: 9 columns over 32 lanes in 12 shuffles
        bool up = lane & 16;
        float h5[5], h3[3], h2[2];
#pragma unroll
        for (int c = 0; c < 4; ++c) h5[c] = halve(a[c], a[5 + c], up, 16);
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

    // each touched slot's sums, the warps' partials added in warp order,
    // into its gradient row
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const unsigned mask = warps_of[k];
      const int row = row_of[j & 1][k];
      // no pixel of the tile touched the slot (a row not read never does)
      if (!mask || row < 0) continue;
      float sum[kGradCols] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (unsigned m = mask; m; m &= m - 1) {
        const float* part = partial[__ffs(m) - 1][k];
#pragma unroll
        for (int c = 0; c < kGradCols; ++c) sum[c] += part[c];
      }
      float* d = d_base + (size_t)row * kPayloadDim;
      atomicAdd(reinterpret_cast<float4*>(d), make_float4(sum[0], sum[1], sum[2], sum[3]));
      atomicAdd(reinterpret_cast<float4*>(d + 4), make_float4(sum[4], sum[5], sum[6], sum[7]));
      atomicAdd(d + 8, sum[8]);
    }
    s0 = s1;
  }
  copy_async_wait<0>();  // a piece staged before the stop
}

template <int PPT, int THREADS, int SUB>
cudaError_t launch(const float* rows, const int* ids, const int* tile_indices,
                   const int* counts, const float* out4, const float* g4, float* d_rows,
                   int num_tiles, int threads, int cap, int view_rows, int views, int P,
                   int tile_h, int tile_w, int ntx, int tiles_per_view, int g, int sw_log2,
                   float alpha_clip, float alpha_threshold, float eps,
                   cudaStream_t cu_stream) {
  rasterize_dense_bwd_kernel<PPT, THREADS, SUB><<<num_tiles, threads, 0, cu_stream>>>(
      rows, ids, tile_indices, counts, out4, g4, d_rows, cap, view_rows, views, P, tile_h,
      tile_w, ntx, tiles_per_view, g, sw_log2, alpha_clip, alpha_threshold, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code: 0
// on a successful launch.  d_rows must come zeroed, laid out as rows;
// ids == nullptr selects the table form.  In the list form a slot whose id
// lies outside [0, view_rows), or a tile whose view lies outside
// [0, views), reads and adds nothing (as the forward kernel: no value of
// ids or tile_indices reaches outside rows or d_rows).  A thread holds at
// most 8 pixels (nine floats of state each): tiles whose padded strips fit
// 8 warps run the 256-thread variant, those that fit 16 the 512-thread one
// (every tile of up to 4096 pixels fits one); more are refused with
// cudaErrorInvalidValue, and the launcher checks that first.
extern "C" int chs_rasterize_dense_bwd(
    const float* rows, const int* ids, const int* tile_indices, const int* counts,
    const float* out4, const float* g4, float* d_rows, int num_tiles, int cap,
    int view_rows, int views, int P, int tile_h, int tile_w, int ntx, int tiles_per_view,
    int g, float alpha_clip, float alpha_threshold, float eps, void* cu_stream) {
  if (num_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
  int sw_log2, ppt, threads;
#define CHS_LAUNCH(N, THREADS, SUB)                                                    \
  return (int)launch<N, THREADS, SUB>(rows, ids, tile_indices, counts, out4, g4, d_rows, \
                                      num_tiles, threads, cap, view_rows, views, P,      \
                                      tile_h, tile_w, ntx, tiles_per_view, g, sw_log2,   \
                                      alpha_clip, alpha_threshold, eps, s)
  if (plan(tile_h, tile_w, 8, 8, &sw_log2, &ppt, &threads)) {
    if (ppt == 1) CHS_LAUNCH(1, 256, 64);
    if (ppt == 2) CHS_LAUNCH(2, 256, 64);
    if (ppt == 4) CHS_LAUNCH(4, 256, 64);
    CHS_LAUNCH(8, 256, 64);
  }
  if (plan(tile_h, tile_w, 16, 8, &sw_log2, &ppt, &threads) && ppt == 8)
    CHS_LAUNCH(8, 512, 64);
#undef CHS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
