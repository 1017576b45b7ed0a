// The inverse of the packed stream's ids, built by counting: the index that
// kernel G1 reads (CUDA C++ for sm_90a).
//
// Part of G1, which replaces XLA's transpose of the row gather
// `payload[stream_ids]` in casualhdrsplat_tpu/ops/rasterize.py (:192, per
// view; :310, shared binning under vmap) and of `padded[ids_one]` in
// casualhdrsplat_tpu/parallel/render.py:134 (no pallas_call there).  The
// reduction itself: csrc/stream_gather_bwd.cu.  Python wrapper, its plain
// version (`inverse_index`, a stable sort and a searchsorted) and a PyTorch
// emulation of this schedule (`slot_index_emulation`):
// casualhdrsplat_torch/ops/stream_gather.py.
//
// What it computes.  For the ids of V views of S slots each (shared ids are
// one view) and R rows, the key of slot (v, s), flat number i = v S + s, is
// v R + ids[i].  Slots whose id is the pad id R - 1 (or lies
// outside [0, R)) name no row and are neither counted nor placed.  Output,
// CSR over the K = V R keys: offsets [K + 1] and slots [V S], row k's
// slots in slots[offsets[k]:offsets[k + 1]] in increasing order; the pad
// rows' ranges are empty and slots[offsets[K]:] is left unwritten.  For
// every real row that is the list the sort gives.
//
// Design: a counting sort, no comparison sort, all integer work with
// static shapes and no host read (a CUDA graph holds it).  Two C calls
// with the wrapper's exclusive scan between them:
// 1. Histogram (`chs_stream_gather_index_count`): the counts zeroed, then
//    one integer atomicAdd per slot that names a real row into counts[k].
//    Exact in any order; the pad id's run (30% of a training step's slots)
//    never touches a counter.  offsets[0] and offsets[1] are zeroed.
// 2. Exclusive scan, the wrapper's torch.cumsum: offsets[1 + k] = the sum
//    of counts[0 .. k), row k's first position.  The last key is a pad
//    row, so counts[K - 1] is never needed.
// 3. Bucketing (`chs_stream_gather_index_place`): each slot takes a
//    position in its row with atomicAdd on offsets[1 + k]; that leaves
//    offsets[1 + k] at row k's end, so the array is the CSR offsets.  The
//    bucket, scratch, holds (slot, key); the order of a row's slots in it
//    changes from run to run.
// 4. Placement, stable by construction: one thread per bucketed position
//    counts the slots of its row below its own (c reads of the row's
//    range, L1-resident) and writes its slot at the row's offset plus that
//    rank.  The output is therefore the same from launch to launch.  A
//    row of c slots costs c^2 compares in all; the paths' rows hold at
//    most max_tiles_per_gaussian slots a view (4.2 on average).
// The passes over the slots run on a grid of (a view's slots, views): no
// division finds a slot's view.
// What bounds it on an H100: bytes and latency.  It reads the ids twice
// and writes the offsets and the placed slots; the atomics, the bucket and
// the rank reads stay mostly in L2 and L1.  Five operations on the stream
// besides the scan (two memsets and three kernels); at these sizes each
// is a few us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The grid of the two passes over the slots: x over a view's slots, y over
// the views, so that slot (v, s) is flat v S + s with no division.
struct Slot {
  int64_t flat;  // v S + s, or -1 past the view's end
  int view;
};

__device__ __forceinline__ Slot slot_of(int slots_per_view) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= slots_per_view) return {-1, 0};
  return {(int64_t)blockIdx.y * slots_per_view + s, (int)blockIdx.y};
}

// The key of a slot, v R + its id, or -1 where the id names no row.
__device__ __forceinline__ int key_of(const int* __restrict__ ids, Slot slot, int rows) {
  const int id = __ldg(ids + slot.flat);
  return id < 0 || id >= rows - 1 ? -1 : slot.view * rows + id;
}

__global__ void __launch_bounds__(kThreads) count_kernel(const int* __restrict__ ids,
                                                         int slots_per_view, int rows,
                                                         int* __restrict__ counts) {
  const Slot slot = slot_of(slots_per_view);
  if (slot.flat < 0) return;
  const int k = key_of(ids, slot, rows);
  if (k >= 0) atomicAdd(counts + k, 1);
}

// Each slot of a real row takes a position in its row: firsts[k] (row k's
// next free position) moves on by one.  The bucket keeps (slot, key).
__global__ void __launch_bounds__(kThreads) bucket_kernel(const int* __restrict__ ids,
                                                          int slots_per_view, int rows,
                                                          int* __restrict__ firsts,
                                                          int2* __restrict__ bucket) {
  const Slot slot = slot_of(slots_per_view);
  if (slot.flat < 0) return;
  const int k = key_of(ids, slot, rows);
  if (k >= 0) bucket[atomicAdd(firsts + k, 1)] = make_int2((int)slot.flat, k);
}

// slots[lo + rank] = the slot at bucketed position p, rank its order among
// its row's slots
__global__ void __launch_bounds__(kThreads) place_kernel(int n, int keys,
                                                         const int* __restrict__ offsets,
                                                         const int2* __restrict__ bucket,
                                                         int* __restrict__ slots) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n || p >= __ldg(offsets + keys)) return;
  const int2 sk = __ldg(bucket + p);
  const int lo = __ldg(offsets + sk.y), hi = __ldg(offsets + sk.y + 1);
  int rank = 0;
  for (int q = lo; q < hi; ++q) rank += __ldg(&bucket[q].x) < sk.x;
  slots[lo + rank] = sk.x;
}

// The shapes both calls check: ids [views, slots_per_view] int32 (one view
// for shared ids), keys = views rows.
bool bad_shape(int views, int slots_per_view, int rows) {
  return views < 1 || views > 65535 || slots_per_view < 0 || rows < 1 ||
         (int64_t)views * rows >= 0x7fffffff || (int64_t)views * slots_per_view > 0x7fffffff;
}

}  // namespace

// Histogram: counts [views rows] int32 <- each key's real slots; offsets
// [views rows + 1] int32: its first two words zeroed (the scan writes the
// rest).  Returns a cudaError_t: nonzero where a launch was refused.
extern "C" int chs_stream_gather_index_count(const int* ids, int views, int slots_per_view,
                                             int rows, int* offsets, int* counts,
                                             void* cu_stream) {
  if (bad_shape(views, slots_per_view, rows)) return (int)cudaErrorInvalidValue;
  const int keys = views * rows;
  cudaStream_t st = static_cast<cudaStream_t>(cu_stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)keys * sizeof(int), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(offsets, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess || slots_per_view == 0) return (int)err;
  const dim3 per_slot((slots_per_view + kThreads - 1) / kThreads, views);
  count_kernel<<<per_slot, kThreads, 0, st>>>(ids, slots_per_view, rows, counts);
  return (int)cudaGetLastError();
}

// Bucketing and placement, after the scan: offsets [views rows + 1] with
// offsets[1 + k] row k's first position in, the CSR offsets out; slots
// [views slots_per_view] int32, its first offsets[keys] words written;
// bucket [views slots_per_view] int2, 8-byte aligned, scratch.  Returns a
// cudaError_t: nonzero where a launch was refused.
extern "C" int chs_stream_gather_index_place(const int* ids, int views, int slots_per_view,
                                             int rows, int* offsets, int* slots, void* bucket,
                                             void* cu_stream) {
  if (bad_shape(views, slots_per_view, rows) || (uintptr_t)bucket % 8)
    return (int)cudaErrorInvalidValue;
  const int keys = views * rows, n = views * slots_per_view;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(cu_stream);
  int2* pairs = static_cast<int2*>(bucket);
  const dim3 per_slot((slots_per_view + kThreads - 1) / kThreads, views);
  bucket_kernel<<<per_slot, kThreads, 0, st>>>(ids, slots_per_view, rows, offsets + 1, pairs);
  place_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(n, keys, offsets, pairs,
                                                                   slots);
  return (int)cudaGetLastError();
}
