// The projection layer's backward: kernel P1's second half (CUDA C++ for
// sm_90a), the gradient of csrc/projection_fwd.cu.
//
// Replaces: autograd's ~1,100 ATen kernels of the eager chain's backward at
// a training step's 8 views (ops/projection_fused.py lists the chain).
//
// What it computes: given d payload [V, n + 1, 16] (the pad row's and the
// constant columns' gradients are dropped, as the chain's `cat` drops them),
// the gradient of every input the caller asks for:
// - per Gaussian: means, quaternions, (log-)scales, opacity (logits), the
//   SH coefficients (dc and rest; zero above the active degree) or the
//   given colors, and the means2d offset (the sum over views of d means2d);
// - per view: the world-to-camera matrix (its 3 x 4 top) and the camera
//   centre of the SH directions.
// The depths, radii and valid flags carry no gradient (the binning sorts and
// clips with them).
//
// Design.  One thread a Gaussian, as the forward: it recomputes the
// forward's values for each view from the leaves (csrc/projection.cuh, the
// same code, so the same bits: the same clamp, cull and threshold
// decisions), reads the row's nine gradients, and chains them back in
// registers; each Gaussian's gradients are written once, no float atomics.
// The per-view pose gradients are summed over a block's threads by a fixed
// shuffle tree and the block's warps in order, into a partial row per
// block; a second small kernel sums the partial rows over blocks, a warp an
// output, lanes strided over the blocks then a fixed tree.  Both launches
// are one entry point; two runs give the same bits.
//
// Where it departs from autograd's arithmetic: products and sums run in
// another order (float32 rounding, ~1e-7 relative), and with `antialias`
// a compensation of exactly 0 passes no gradient where autograd's
// sqrt'(0) = inf makes NaN.
//
// What bounds it on an H100: bytes, as the forward: the leaves (237 bytes a
// Gaussian at SH degree 3) read once and their gradients (244 bytes)
// written once, and a view's 48 bytes of its row's gradient read: 131,072
// Gaussians at 8 views move ~113 MB, ~0.034 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "projection.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPoseVals = 12;  // a view's rotation (9) and translation (3)

// Sum K values over the block's threads in a fixed order; thread k < K
// writes the k-th sum to dst[k] (k < split) or dst2[k - split].
template <int K>
__device__ __forceinline__ void block_sum(float (&vals)[K], float* smem, float* dst,
                                          int split = K, float* dst2 = nullptr) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vals[k] += __shfl_down_sync(kFull, vals[k], o);
    if (lane == 0) smem[warp * K + k] = vals[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += smem[w * K + threadIdx.x];
    if (threadIdx.x < split)
      dst[threadIdx.x] = s;
    else
      dst2[threadIdx.x - split] = s;
  }
  __syncthreads();
}

template <int DEG>
__global__ void __launch_bounds__(kThreads) projection_bwd_kernel(
    p1::Inputs in, const float4* __restrict__ d_payload, p1::Outs out, float* part_all) {
  constexpr int kBases = DEG >= 0 ? (DEG + 1) * (DEG + 1) : 1;
  __shared__ float smem[kWarps * (kPoseVals + 3)];
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const bool live = g < in.n;
  const int64_t rows = (int64_t)in.n + 1;
  const int part_len = in.views * kPoseVals + in.color_views * 3;
  float* part = part_all ? part_all + (int64_t)blockIdx.x * part_len : nullptr;

  const p1::Cam cam = p1::camera(in);
  p1::Gauss a;
  p1::rf coef[kBases][3];
  if (live) {
    p1::activate(in, g, a);
    if constexpr (DEG >= 0) p1::load_coefs<DEG>(in, g, coef);
  }
  p1::Acc<DEG> acc;
  for (int v = 0; v < in.views; ++v) {
    // this thread's share of the view's pose gradient: rotation, translation
    // and (per-view colors) the SH centre
    float gW[3][3] = {}, gt[3] = {0.0f, 0.0f, 0.0f}, gc[3] = {0.0f, 0.0f, 0.0f};
    if (live) {
      const float4* row = d_payload + ((int64_t)v * rows + g) * 4;
      const float4 q0 = row[0], q1 = row[1], q2 = row[2];
      const float drow[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
      p1::view_vjp<DEG>(in, cam, a, coef, g, v, drow, out, acc, gW, gt, gc);
    }
    if (part) {
      float vals[kPoseVals + 3];
      for (int i = 0; i < 3; ++i) {
        for (int k = 0; k < 3; ++k) vals[3 * i + k] = gW[i][k];
        vals[9 + i] = gt[i];
        vals[12 + i] = gc[i];
      }
      if (DEG >= 0 && in.color_views > 1) {
        block_sum<kPoseVals + 3>(vals, smem, part + v * kPoseVals, kPoseVals,
                                 part + in.views * kPoseVals + 3 * v);
      } else {
        float pv[kPoseVals];
        for (int k = 0; k < kPoseVals; ++k) pv[k] = vals[k];
        block_sum<kPoseVals>(pv, smem, part + v * kPoseVals);
      }
    }
  }
  if (live) p1::shared_vjp<DEG>(in, a, coef, g, out, acc);
  if (part && in.color_views == 1) block_sum<3>(acc.gc, smem, part + in.views * kPoseVals);
  if (live) p1::write_grads<DEG>(in, a, g, acc, out);
}

// The partial rows' sum: output o of (views + color_views) * 16, the
// [views, 4, 4] matrices' gradients, then the [color_views, 4, 4]
// camera-to-world matrices' (their centres' column only), a warp each.
__global__ void __launch_bounds__(kThreads) pose_sum_kernel(
    const float* __restrict__ part, int blocks, int views, int color_views,
    float* __restrict__ g_viewmats, float* __restrict__ g_camtoworlds) {
  const int o = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part_len = views * kPoseVals + color_views * 3;
  if (o >= (views + color_views) * 16) return;
  const int m = o / 16, i = (o % 16) / 4, k = o % 4;
  int src = -1;  // the bottom row, and the rotation of a camera-to-world matrix: 0
  if (m < views) {
    if (i < 3) src = m * kPoseVals + (k < 3 ? 3 * i + k : 9 + i);
  } else if (i < 3 && k == 3) {
    src = views * kPoseVals + 3 * (m - views) + i;
  }
  float acc = 0.0f;
  if (src >= 0)
    for (int b = lane; b < blocks; b += 32) acc += part[(int64_t)b * part_len + src];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  if (lane == 0) {
    if (m < views) {
      if (g_viewmats) g_viewmats[o] = acc;
    } else if (g_camtoworlds) {
      g_camtoworlds[o - views * 16] = acc;
    }
  }
}

template <int DEG>
cudaError_t launch(const p1::Inputs& in, const float* d_payload, const p1::Outs& out,
                   float* part, float* g_viewmats, float* g_camtoworlds, cudaStream_t s) {
  const int blocks = (in.n + kThreads - 1) / kThreads;
  const bool pose = g_viewmats || g_camtoworlds;
  projection_bwd_kernel<DEG><<<blocks, kThreads, 0, s>>>(
      in, reinterpret_cast<const float4*>(d_payload), out, pose ? part : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !pose) return err;
  const int outputs = (in.views + in.color_views) * 16;
  pose_sum_kernel<<<(outputs + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      part, blocks, in.views, in.color_views, g_viewmats, g_camtoworlds);
  return cudaGetLastError();
}

}  // namespace

// The forward's inputs (chs_projection_fwd), d payload [views, n + 1, 16]
// (16-byte aligned), and the gradients asked for, each null where it is not:
// g_means [n, 3], g_quats [n, 4], g_scales [n, 3], g_opacity [n], g_sh_dc
// [n, 1, 3], g_sh_rest [n, rest, 3], g_colors (the colors' shape),
// g_offset [n, 2], g_viewmats [views, 4, 4], g_camtoworlds [color_views, 4,
// 4] (the centres' column, zeros elsewhere).  With g_viewmats or
// g_camtoworlds, `part` holds ceil(n / 128) x (views x 12 +
// color_views x 3) floats.  Returns a cudaError_t.
extern "C" int chs_projection_bwd(
    const float* means, const float* quats, const float* scales, const float* opacity,
    const float* sh_dc, const float* sh_rest, const float* colors, const float* viewmats,
    const float* camtoworlds, const float* offset, const uint8_t* alive, const float* fx,
    const float* fy, const float* cx, const float* cy,
    const float* d_payload, float* g_means, float* g_quats, float* g_scales,
    float* g_opacity, float* g_sh_dc, float* g_sh_rest, float* g_colors, float* g_viewmats,
    float* g_camtoworlds, float* g_offset, float* part, int n, int views, int color_views,
    int rest, int degree, int raw, int antialias, float near_plane, float width,
    float height, void* cu_stream) {
  if (n < 1 || views < 1 || (color_views != 1 && color_views != views))
    return (int)cudaErrorInvalidValue;
  if (degree < -1 || degree > 3 || (degree >= 0 && rest < (degree + 1) * (degree + 1) - 1))
    return (int)cudaErrorInvalidValue;
  if ((degree < 0 && !colors) || (degree >= 0 && (!sh_dc || !camtoworlds)) || (raw && !alive))
    return (int)cudaErrorInvalidValue;
  if ((g_viewmats || g_camtoworlds) && !part) return (int)cudaErrorInvalidValue;
  if (degree < 0 && g_camtoworlds) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)d_payload % 16) return (int)cudaErrorMisalignedAddress;
  const p1::Inputs in{means, quats, scales, opacity, sh_dc, sh_rest, colors, viewmats,
                      camtoworlds, offset, alive, fx, fy, cx, cy, n, views, color_views,
                      rest, raw, antialias, near_plane, width, height};
  const p1::Outs out{g_means, g_quats, g_scales, g_opacity, g_sh_dc, g_sh_rest, g_colors,
                     g_offset};
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
  switch (degree) {
    case -1: return (int)launch<-1>(in, d_payload, out, part, g_viewmats, g_camtoworlds, s);
    case 0: return (int)launch<0>(in, d_payload, out, part, g_viewmats, g_camtoworlds, s);
    case 1: return (int)launch<1>(in, d_payload, out, part, g_viewmats, g_camtoworlds, s);
    case 2: return (int)launch<2>(in, d_payload, out, part, g_viewmats, g_camtoworlds, s);
    default: return (int)launch<3>(in, d_payload, out, part, g_viewmats, g_camtoworlds, s);
  }
}
