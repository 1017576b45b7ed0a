// The transpose of the packed stream gather: kernel G1 (CUDA C++ for
// sm_90a).
//
// Replaces: XLA's transpose of the row gather `payload[stream_ids]` in
// casualhdrsplat_tpu/ops/rasterize.py (:192, per view; :310, shared
// binning under vmap) and of `padded[ids_one]` in
// casualhdrsplat_tpu/parallel/render.py:134: a scatter-add XLA emits, no
// pallas_call.  The reference's design reduces the per-slot gradients by
// that one deterministic transpose, with no atomics
// (casualhdrsplat_tpu/ops/composite.py).  Python wrapper, its plain version
// and a PyTorch emulation of this schedule:
// casualhdrsplat_torch/ops/stream_gather.py.
//
// What it computes.  The forward gathered stream[v, s] = payload[v, ids[s]]
// (shared binning: one id list for every view) or payload[v, ids[v, s]]
// (per-view binning).  Given d stream [V, S, 16], the gradient of the
// payload [V, R, 16] is
//     d payload[v, r, c] = sum over s with ids[s] = r of d stream[v, s, c]
// for r < R - 1; the pad row R - 1 (the pad id of the budget's unused
// tail) gets zeros.  The sum runs over each row's slots in increasing slot
// order, an fp32 add at a time, starting from 0.
//
// Design.  The wrapper builds the inverse of the ids once (integer work, no
// host read): CSR `offsets` and `slots`, each row's slots in increasing
// order.  Shared ids: offsets [R + 1], slots [S] hold s; per view: offsets
// [V R + 1] over keys v R + r, slots [V S] hold v S + s.
// - A group of 16 lanes owns one (view, row), a lane one column, so a
//   group reads each slot's 64-byte gradient row as one segment and writes
//   its row once, with a plain store.  The view varies fastest across
//   groups: with shared ids, the V groups of a row walk one slot list.
// - A group takes its row's slots 8 at a time: the 8 slot numbers, then
//   the 8 gradient rows, are loaded before any add, so a row costs two
//   round trips to memory per 8 slots rather than two per slot; the adds
//   then run in slot order (__fadd_rn: no contraction, no reassociation).
// - No float atomics and nothing that depends on scheduling: a row's sum
//   is one thread's chain in a fixed order, so two launches give the same
//   bits, equal to the emulation's and, on a CPU, to index_add_'s.
//
// What bounds it on an H100: bytes.  The function reads each slot's
// gradient row that names a real row (64 bytes, once per view), the ids,
// and writes the [V, R, 16] gradient once; it does one add per element
// read.  The inverse index (a sort of the ids) is the wrapper's.  Element
// offsets are 64-bit: V S 16 passes 2^31 at the quality run's streams.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;                    // payload columns, one lane each
constexpr int kThreads = 256;                // 16 groups of 16 lanes
constexpr int kGroups = kThreads / kCols;
constexpr int kBatch = 8;                    // slots loaded before their adds

__global__ void __launch_bounds__(kThreads) stream_gather_bwd_kernel(
    const float* __restrict__ d_stream, const int* __restrict__ offsets,
    const int* __restrict__ slots, float* __restrict__ d_payload, int views,
    int slots_per_view, int rows, int shared) {
  const int64_t group = (int64_t)blockIdx.x * kGroups + threadIdx.x / kCols;
  const int col = threadIdx.x % kCols;
  if (group >= (int64_t)views * rows) return;
  const int v = (int)(group % views);
  const int r = (int)(group / views);
  float acc = 0.0f;
  if (r < rows - 1) {  // the pad row is not walked
    const int64_t key = shared ? (int64_t)r : (int64_t)v * rows + r;
    const int lo = __ldg(offsets + key), hi = __ldg(offsets + key + 1);
    // shared ids name a slot of every view's stream; per-view ones are flat
    const int64_t base = shared ? (int64_t)v * slots_per_view : 0;
    for (int k0 = lo; k0 < hi; k0 += kBatch) {
      int s[kBatch];
      float x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s[u] = k0 + u < hi ? __ldg(slots + k0 + u) : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        x[u] = k0 + u < hi ? __ldg(d_stream + (base + s[u]) * kCols + col) : 0.0f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k0 + u < hi) acc = __fadd_rn(acc, x[u]);
    }
  }
  d_payload[((int64_t)v * rows + r) * kCols + col] = acc;
}

}  // namespace

// d_stream [views, slots_per_view, 16] float32; offsets and slots the
// inverse index (above); d_payload [views, rows, 16] float32, every element
// written.  Returns a cudaError_t: nonzero where the launch was refused.
extern "C" int chs_stream_gather_bwd(const float* d_stream, const int* offsets,
                                     const int* slots, float* d_payload, int views,
                                     int slots_per_view, int rows, int shared,
                                     void* cu_stream) {
  if (views < 0 || rows < 1 || slots_per_view < 0) return (int)cudaErrorInvalidValue;
  const int64_t groups = (int64_t)views * rows;
  if (groups == 0) return (int)cudaSuccess;
  const int64_t blocks = (groups + kGroups - 1) / kGroups;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  stream_gather_bwd_kernel<<<(unsigned)blocks, kThreads, 0,
                             static_cast<cudaStream_t>(cu_stream)>>>(
      d_stream, offsets, slots, d_payload, views, slots_per_view, rows, shared);
  return (int)cudaGetLastError();
}
