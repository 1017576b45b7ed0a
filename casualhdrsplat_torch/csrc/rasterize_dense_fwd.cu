// Dense per-tile front-to-back alpha compositor, forward (CUDA C++ for
// sm_90a).
//
// Replaces: casualhdrsplat_tpu/ops/rasterize_pallas.py::_fwd_kernel (the
// Pallas TPU kernel launched by `forward`).  Python launcher:
// casualhdrsplat_torch/ops/rasterize_dense.py; differentiable entry points
// and plain PyTorch versions: casualhdrsplat_torch/ops/composite.py.
//
// What it computes.  Tile i of the launch owns a depth-ordered list of
// payload rows (binning.py layout: mx, my, cxx, cxy, cyy, opacity, r, g, b,
// one, 0...), of which it reads the first min(counts[i], capacity) slots,
// through an id table: rows [V (N + 1), 16] is the payload of V views and
// ids [tiles, capacity] int32 the id table of binning.assign_tiles_arrays;
// slot k of tile i is row view_rows * v + ids[i][k] with view
// v = tile_indices[i] / tiles_per_view and view_rows = N + 1.  No gathered
// table is made.  (A caller that holds a gathered table [tiles, capacity,
// 16] passes it as one view of tiles * capacity rows with ids i * capacity
// + k: ops/composite.py::table_as_lists.)
// For every pixel of the tile it composites the list front to back:
//     alpha = min(opa * exp(min(power, 0)), clip), 0 below threshold
//     out4 += [r, g, b, one] * alpha * T;   T *= 1 - alpha
// over chunks of G slots.  At the start of each chunk the tile votes: once
// no pixel has T >= eps the rest of the list is skipped.  This is the TPU
// kernel's chunk-granular early stop; a per-pixel stop would differ from it
// by up to eps.  The tile's pixel origin comes from tile_indices[i] %
// tiles_per_view, so a caller may composite a slice of the tiles with a
// padded stride.
//
// Design.  The TPU kernel turns a chunk's transmittance into a triangular
// matrix product over log(1 - alpha) and the blend into a (4,G)@(G,P)
// product for its matrix unit.  Here one CTA owns one tile, T and the four
// sums of each of a thread's pixels in registers, and the vote is
// __syncthreads_or.  The tile's output is written once, at the end.
// - Staging.  A list's slots pass through shared memory in pieces of kSub
//   (never across a chunk): the first 48 bytes of each row (the 12 columns
//   the kernel reads) by three 16-byte cp.async copies through the id
//   table, into two buffers, so that piece j + 1 is in flight while piece j
//   composites.  (The tensor-map copies of sm_90 have no row gather.)  A
//   view's payload (131,073 rows of 64 B at 131,072 Gaussians) fits the
//   50 MB L2, and CTAs start in tile order, view by view.
// - The skip is B1's (tile_boxes.cuh): each staged slot's pixel box, warps
//   that own compact blocks of 32-pixel groups, and two ballots (the slots
//   a warp's block meets, the groups a slot's box meets); only those groups
//   evaluate alpha.  Outside the box alpha is 0 and the colour finite, so
//   the output is bit for bit that of the unskipped loop.
//
// What bounds it on an H100.  The function needs about 26 fp32 operations
// and one exp per (slot, pixel) pair the slot touches (alpha >= threshold),
// the 4-byte id of each slot it composites, the ten columns it uses (40
// bytes) of each distinct payload row those slots name (a row is named by
// up to max_tiles_per_gaussian tiles, and needs reading once), and 16 bytes
// written per pixel of every tile; chip_smoke.py counts both.  On 16x16
// tiles a slot's padded box spans much of the tile, so the kernel still
// evaluates alpha at many untouched pixels, and a tile's chunks run in one
// CTA, so a full list sets the pace of the tail.  Plain SIMT code: no
// tensor cores, no TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_boxes.cuh"

namespace {

using namespace tile_boxes;

constexpr int kMaxWarps = 8;
// slots staged at once
constexpr int kSub = 128;

template <int PPT>
__global__ void __launch_bounds__(kMaxWarps * 32) rasterize_dense_fwd_kernel(
    const float* __restrict__ rows, const int* __restrict__ ids,
    const int* __restrict__ tile_indices, const int* __restrict__ counts,
    float* __restrict__ out, int cap, int view_rows, int views, int P, int tile_h,
    int tile_w, int ntx, int tiles_per_view, int g, int sw_log2, float alpha_clip,
    float alpha_threshold, float eps) {
  __shared__ float4 staged[2][kSub * kStagedParts];  // two pieces of payload rows
  __shared__ short4 boxes[kSub];
  // the pixel block of each warp's group j, and at [PPT] the warp's whole block
  __shared__ short4 blocks[kMaxWarps][PPT + 1];

  const int i = blockIdx.x;
  const int index = tile_indices[i];
  // a tile whose view lies outside the rows reads nothing
  const bool in_rows = index >= 0 && index / tiles_per_view < views;
  const int count = in_rows ? min(counts[i], cap) : 0;
  const int tile = index % tiles_per_view;
  const int ox = (tile % ntx) * tile_w;
  const int oy = (tile / ntx) * tile_h;
  const size_t first_row = in_rows ? (size_t)(index / tiles_per_view) * view_rows : 0;
  const float4* base = reinterpret_cast<const float4*>(rows) + first_row * (kPayloadDim / 4);
  const int* list = ids + (size_t)i * cap;
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
  // (read after the first piece's vote, a barrier)

  // piece j holds slots [s0, s0 + n), inside one chunk
  if (count > 0)
    stage_rows(staged[0], nullptr, base, list, view_rows, 0, min(kSub, min(g, count)));
  copy_async_commit();
  for (int j = 0, s0 = 0; s0 < count; ++j) {
    const int n = min(kSub, min(count, (s0 / g + 1) * g) - s0);
    const int s1 = s0 + n;
    if (s0 % g == 0) {
      // tile-wide vote at each chunk
      int live = 0;
#pragma unroll
      for (int k = 0; k < PPT; ++k) live |= (pix[k] >= 0 && T[k] >= eps);
      if (!__syncthreads_or(live)) break;
    } else {
      __syncthreads();
    }
    // every thread is done with piece j - 1, whose buffer piece j + 1 takes
    if (s1 < count)
      stage_rows(staged[(j + 1) & 1], nullptr, base, list, view_rows, s1,
                 min(kSub, min(count, (s1 / g + 1) * g) - s1));
    copy_async_commit();
    copy_async_wait<1>();  // this thread's copies of piece j have landed
    __syncthreads();
    const float4* piece = staged[j & 1];
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float4* q = piece + kStagedParts * k;
      boxes[k] = slot_box(q[0], q[1], q[2], ox, oy, tile_w, tile_h, alpha_clip, alpha_threshold);
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
#pragma unroll
        for (int p = 0; p < PPT; ++p) {
          if (!((groups >> p) & 1u)) continue;  // alpha is 0 at all 32 pixels
          const float dx = px[p] - q0.x;
          const float dy = py[p] - q0.y;
          const float power = -(0.5f * (q0.z * dx * dx + q1.x * dy * dy) + q0.w * dx * dy);
          float alpha = fminf(q1.y * expf(fminf(power, 0.0f)), alpha_clip);
          alpha = alpha >= alpha_threshold ? alpha : 0.0f;
          const float w = alpha * T[p];
          acc[0][p] += q1.z * w;
          acc[1][p] += q1.w * w;
          acc[2][p] += q2.x * w;
          acc[3][p] += q2.y * w;
          T[p] *= 1.0f - alpha;
        }
      }
    }
    s0 = s1;
  }
  copy_async_wait<0>();  // a piece staged before the stop

  float* dst = out + (size_t)i * 4 * P;
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
cudaError_t launch(const float* rows, const int* ids, const int* tile_indices,
                   const int* counts, float* out, int num_tiles, int threads, int cap,
                   int view_rows, int views, int P, int tile_h, int tile_w, int ntx,
                   int tiles_per_view, int g, int sw_log2, float alpha_clip,
                   float alpha_threshold, float eps, cudaStream_t cu_stream) {
  rasterize_dense_fwd_kernel<PPT><<<num_tiles, threads, 0, cu_stream>>>(
      rows, ids, tile_indices, counts, out, cap, view_rows, views, P, tile_h, tile_w, ntx,
      tiles_per_view, g, sw_log2, alpha_clip, alpha_threshold, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code:
// 0 on a successful launch.  rows holds `views` views of view_rows rows
// each; an id outside [0, view_rows) reads as an empty slot, and a tile
// whose view tile_indices[i] / tiles_per_view lies outside [0, views) as an
// empty list, so no value of ids or tile_indices reads outside rows.  The
// mapping fits 8 warps of at most 16 pixels a thread (`plan`); a tile it
// cannot fit (more than 4096 pixels) is refused with
// cudaErrorInvalidValue, and the launcher checks that first.
extern "C" int chs_rasterize_dense_fwd(
    const float* rows, const int* ids, const int* tile_indices, const int* counts,
    float* out, int num_tiles, int cap, int view_rows, int views, int P, int tile_h,
    int tile_w, int ntx, int tiles_per_view, int g, float alpha_clip, float alpha_threshold,
    float eps, void* cu_stream) {
  if (num_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
  int sw_log2, ppt, threads;
  if (!plan(tile_h, tile_w, kMaxWarps, 16, &sw_log2, &ppt, &threads))
    return (int)cudaErrorInvalidValue;
#define CHS_LAUNCH(N)                                                                   \
  return (int)launch<N>(rows, ids, tile_indices, counts, out, num_tiles, threads, cap, \
                        view_rows, views, P, tile_h, tile_w, ntx, tiles_per_view, g,    \
                        sw_log2, alpha_clip, alpha_threshold, eps, s)
  if (ppt == 1) CHS_LAUNCH(1);
  if (ppt == 2) CHS_LAUNCH(2);
  if (ppt == 4) CHS_LAUNCH(4);
  if (ppt == 8) CHS_LAUNCH(8);
  CHS_LAUNCH(16);
#undef CHS_LAUNCH
}
