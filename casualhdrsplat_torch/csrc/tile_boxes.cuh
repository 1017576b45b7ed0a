// Device and host code shared by the four compositor kernels: the packed
// ones, rasterize_packed_fwd.cu (B1) and rasterize_packed_bwd.cu (B2), and
// the dense ones, rasterize_dense_fwd.cu (B3) and rasterize_dense_bwd.cu
// (B4): the slot box, the pixel mapping and its plan, and the dense
// kernels' asynchronous row copies.  A forward kernel and its backward must
// skip exactly the same pixels, so they take them from this one header.
// rasterize_packed.slot_boxes is the box formula in PyTorch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tile_boxes {

constexpr int kPayloadDim = 16;
constexpr unsigned kFull = 0xffffffffu;
// a box no block meets
constexpr short kEmptyLo = 0x7fff, kEmptyHi = -1;

// Pixel box {x0, x1, y0, y1} (inclusive, tile-local) outside which the
// slot's alpha is below `thr` at every pixel of the tile at origin (ox, oy).
// q0 = (mx, my, cxx, cxy), q1 = (cyy, opa, r, g), q2 = (b, one, ...).
// Q = -power is 1/2 d^T C d; alpha >= thr needs Q <= L = ln(opa / thr), an
// ellipse of half-widths sqrt(2 L cyy / det) and sqrt(2 L cxx / det).
// Float32 evaluation of Q errs by at most a few roundings of
// cxx dx^2 + cyy dy^2 <= 2 Q / (1 - rho), rho = |cxy| / sqrt(cxx cyy), so
// L is raised by 64 of them (and the exp's and the product's roundings),
// and the box padded by a pixel; the box arithmetic runs in double.
// A slot with a colour that is not finite gets the whole tile, whatever
// its opacity: c * 0 is NaN, so even where its alpha is 0 the blend
// changes the pixel.
__device__ __forceinline__ short4 slot_box(float4 q0, float4 q1, float4 q2, int ox, int oy,
                                           int tile_w, int tile_h, float clip, float thr) {
  const short4 empty = make_short4(kEmptyLo, kEmptyHi, kEmptyLo, kEmptyHi);
  const short4 whole = make_short4(0, tile_w - 1, 0, tile_h - 1);
  if (!(isfinite(q1.z) && isfinite(q1.w) && isfinite(q2.x) && isfinite(q2.y))) return whole;
  const float opa = q1.y;
  if (opa < thr || clip < thr) return empty;
  const double cxx = q0.z, cxy = q0.w, cyy = q1.x;
  const double det = cxx * cyy - cxy * cxy;
  if (!(thr > 0.0f) || !(cxx > 0.0) || !(det > 0.0)) return whole;
  const double s = det / (cxx * cyy);  // 1 - rho^2
  const double slack = 64.0 * 0x1p-23 / (s / (1.0 + sqrt(1.0 - s)));
  if (!(slack <= 0.5)) return whole;
  const double L = (log((double)opa / (double)thr) * (1.0 + 1e-6) + 1e-6) / (1.0 - slack);
  const double ex = sqrt(2.0 * L * cyy / det), ey = sqrt(2.0 * L * cxx / det);
  // tile-local pixel x has its centre at ox + x + 0.5
  const double cx = (double)q0.x - ox - 0.5, cy = (double)q0.y - oy - 0.5;
  const double rx = ex + 1.0 + 1e-6 * (ex + fabs(cx));
  const double ry = ey + 1.0 + 1e-6 * (ey + fabs(cy));
  if (!(isfinite(cx) && isfinite(cy) && isfinite(rx) && isfinite(ry))) return whole;
  const double left = fmax(ceil(cx - rx), 0.0), right = fmin(floor(cx + rx), tile_w - 1.0);
  const double top = fmax(ceil(cy - ry), 0.0), bottom = fmin(floor(cy + ry), tile_h - 1.0);
  if (left > right || top > bottom) return empty;
  return make_short4((short)left, (short)right, (short)top, (short)bottom);
}

// Do boxes a and b (x0, x1, y0, y1) meet?
__device__ __forceinline__ bool meets(short4 a, short4 b) {
  return a.x <= b.y && b.x <= a.y && a.z <= b.w && b.z <= a.w;
}

// Tile-local pixel (x, y) of lane `lane`'s pixel j in warp `warp`; false
// where the slot of the mapping lies outside the tile.
template <int PPT>
__device__ __forceinline__ bool pixel_of(int warp, int lane, int j, int sw_log2,
                                         int tile_h, int tile_w, int* x, int* y) {
  const int u = ((warp * PPT + j) << 5) + lane;
  const int strip_row = u >> sw_log2;
  const int strip = strip_row / tile_h;
  *y = strip_row - strip * tile_h;
  *x = (strip << sw_log2) + (u & ((1 << sw_log2) - 1));
  return *x < tile_w;  // a strip past the tile starts at x >= tile_w
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The mapping for a tile_h x tile_w tile on at most `max_warps` warps of
// at most `max_ppt` pixels a thread: the strip width (log2), pixels a
// thread and threads.  The strip is the widest of 8, 4, 2, 1 columns no
// wider than the tile whose padded strips fit; false if none fits.
inline bool plan(int tile_h, int tile_w, int max_warps, int max_ppt, int* sw_log2, int* ppt,
                 int* threads) {
  for (int lg = 3; lg >= 0; --lg) {
    const int sw = 1 << lg;
    if (sw > tile_w && sw > 1) continue;
    const long padded = (long)((tile_w + sw - 1) / sw) * sw * tile_h;
    const long groups = (padded + 31) / 32;
    int p = 1;
    while (p * max_warps < groups) p *= 2;
    if (p > max_ppt) continue;
    *sw_log2 = lg;
    *ppt = p;
    *threads = (int)((groups + p - 1) / p) * 32;
    return true;
  }
  return false;
}

// 16-byte asynchronous copy from device to shared memory (cp.async, L2
// only: a payload row is read once per tile), and its group bookkeeping.
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16-byte parts of a payload row the dense kernels stage: columns
// 0..11, the ones they read.
constexpr int kStagedParts = 3;

// Stage slots [s0, s0 + n) of a dense list into `dst` (kStagedParts float4
// a slot) by asynchronous copies, and, where `row_of` is given, each slot's
// row into it: slot k is row list[k] of `base`.  A row outside [0, nrows) is
// not read: the slot is staged as a zero row (opacity 0, so it touches no
// pixel) and its row_of is -1.  The caller commits the group.
__device__ __forceinline__ void stage_rows(float4* dst, int* row_of, const float4* base,
                                           const int* list, int nrows, int s0, int n) {
  for (int q = threadIdx.x; q < n * kStagedParts; q += blockDim.x) {
    const int k = q / kStagedParts;
    const int part = q - k * kStagedParts;
    const int row = __ldg(list + s0 + k);
    const bool in = (unsigned)row < (unsigned)nrows;
    if (row_of && part == 0) row_of[k] = in ? row : -1;
    if (in)
      copy_async16(dst + q, base + (size_t)row * (kPayloadDim / 4) + part);
    else
      dst[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace tile_boxes
