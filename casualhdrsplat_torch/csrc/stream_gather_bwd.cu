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
// Design.  The wrapper builds the inverse of the ids once
// (csrc/stream_gather_index.cu: a counting pass, integer work, no host
// read): CSR `offsets` and `slots`, each real row's slots in increasing
// order, the pad rows empty.  Shared ids: offsets [R + 1], slots [S] hold
// s; per view: offsets [V R + 1] over keys v R + r, slots [V S] hold v S + s.
// - Four lanes own one (view, row), a lane one float4 of its 64-byte
//   gradient row: a slot costs a lane one 16-byte load, and a quad reads
//   the slot's row as one 64-byte segment and writes its row once, with
//   plain stores.  A warp holds 8 (view, row) groups.
// - Shared ids: the view varies fastest across groups, so a warp's groups
//   are the views of one row (two rows at 4 views): they load the row's
//   offsets and slot numbers as the same words, one request for all views.
//   Per-view ids: the row varies fastest, so a warp's stores are
//   contiguous for its view.
// - A group takes its row's slots kBatch at a time: the slot numbers, then
//   all of their gradient rows, are loaded before any add (a row holds 4.2
//   real slots on average: one or two batches), and the adds then run in slot
//   order (__fadd_rn: no contraction, no reassociation).  The batch has no
//   branch: lanes past the row's end reload its last slot and add +0 (a
//   sum that starts from +0 never holds -0, so +0 leaves it unchanged).
//   A row with no slots costs its offsets and its store; the pad row only
//   its store.
// - No float atomics and nothing that depends on scheduling: a row's sum
//   is one thread's chain in a fixed order, so two launches give the same
//   bits, equal to the emulation's and, on a CPU, to index_add_'s.
//
// What bounds it on an H100: bytes.  The function reads each slot's
// gradient row that names a real row (64 bytes, once per view), the ids,
// and writes the [V, R, 16] gradient once; it does one add per element
// read.  The reads are 64-byte segments in the stream's order, not the
// rows': at random addresses.  Element offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuads = 4;      // float4s of a 64-byte payload row, one lane each
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kQuads;
// Slots loaded before their adds: 4 was the fastest of 2, 4, 8 and 16 on
// every input of the paths; at 8 and 16 the compiler issues only 1-3 of a
// batch's loads before its first add (PERF.md §6, G1).
constexpr int kBatch = 4;

__global__ void __launch_bounds__(kThreads) stream_gather_bwd_kernel(
    const float4* __restrict__ d_stream, const int* __restrict__ offsets,
    const int* __restrict__ slots, float4* __restrict__ d_payload, int views,
    int slots_per_view, int rows, int shared) {
  const int64_t group = (int64_t)blockIdx.x * kGroups + threadIdx.x / kQuads;
  const int q = threadIdx.x % kQuads;
  if (group >= (int64_t)views * rows) return;
  // shared ids: group = r V + v, the key r; per view: group = key = v R + r
  const int v = (int)(shared ? group % views : group / rows);
  const int64_t r = shared ? group / views : group % rows;
  const int64_t key = shared ? r : group;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (r < rows - 1) {  // the pad row is not walked
    const int lo = __ldg(offsets + key), hi = __ldg(offsets + key + 1);
    // shared ids name a slot of every view's stream; per-view ones are flat
    const int64_t base = shared ? (int64_t)v * slots_per_view : 0;
    for (int k0 = lo; k0 < hi; k0 += kBatch) {
      // straight-line code, so that every load is issued before the first
      // add: past the row's end a lane reloads its last slot (a cache hit)
      // and adds +0, which leaves a sum that starts from +0 unchanged
      int s[kBatch];
      float4 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s[u] = __ldg(slots + min(k0 + u, hi - 1));
#pragma unroll
      for (int u = 0; u < kBatch; ++u) x[u] = __ldg(d_stream + (base + s[u]) * kQuads + q);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool live = k0 + u < hi;
        acc.x = __fadd_rn(acc.x, live ? x[u].x : 0.0f);
        acc.y = __fadd_rn(acc.y, live ? x[u].y : 0.0f);
        acc.z = __fadd_rn(acc.z, live ? x[u].z : 0.0f);
        acc.w = __fadd_rn(acc.w, live ? x[u].w : 0.0f);
      }
    }
  }
  d_payload[((int64_t)v * rows + r) * kQuads + q] = acc;
}

}  // namespace

// d_stream [views, slots_per_view, 16] float32 and d_payload [views, rows,
// 16] float32, both 16-byte aligned; offsets and slots the inverse index
// (above); every element of d_payload written.  Returns a cudaError_t:
// nonzero where the launch was refused.
extern "C" int chs_stream_gather_bwd(const float* d_stream, const int* offsets,
                                     const int* slots, float* d_payload, int views,
                                     int slots_per_view, int rows, int shared,
                                     void* cu_stream) {
  if (views < 0 || rows < 1 || slots_per_view < 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)d_stream | (uintptr_t)d_payload) % 16) return (int)cudaErrorMisalignedAddress;
  if (views == 0) return (int)cudaSuccess;
  const int64_t blocks = ((int64_t)views * rows + kGroups - 1) / kGroups;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  stream_gather_bwd_kernel<<<(unsigned)blocks, kThreads, 0,
                             static_cast<cudaStream_t>(cu_stream)>>>(
      reinterpret_cast<const float4*>(d_stream), offsets, slots,
      reinterpret_cast<float4*>(d_payload), views, slots_per_view, rows, shared);
  return (int)cudaGetLastError();
}
