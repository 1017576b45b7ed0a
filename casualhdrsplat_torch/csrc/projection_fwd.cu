// The projection layer's forward: kernel P1 (CUDA C++ for sm_90a).
//
// Replaces: the eager chain models/gaussians.py `activate` ->
// `colors_for_view` (ops/projection.py `view_directions`, ops/sh.py
// `eval_sh`) -> ops/projection.py `project_gaussians` -> the means2d offset
// -> `cull_invisible` -> ops/binning.py `build_payload`: ~400 ATen kernels
// of a training step's 8 views, each a pass over the [V, N] elements.  The
// reference (casualhdrsplat_tpu) leaves this chain to XLA's fusions, no
// pallas_call.  Python wrapper, its plain version (the chain itself) and
// the kernel's backward: casualhdrsplat_torch/ops/projection_fused.py,
// csrc/projection_bwd.cu.
//
// What it computes: for every Gaussian g and view v the payload row
// payload[v, g] = [mx, my, conic xx, xy, yy, opacity, r, g, b, 1, 0 x6],
// means2d[v, g] = (mx, my) again, depths[v, g] (camera-space z), radii[v, g]
// (0 where culled) and valid[v, g], and the zero pad row payload[v, n]; every output equals the
// chain's on the card bit for bit (csrc/projection.cuh says how).
//
// Design.  One thread a Gaussian: it reads the Gaussian's leaves once
// (means, quaternion, scales, opacity, alive, the SH coefficients up to the
// active degree, in registers), activates them, then loops over the views:
// the SH radiance (once when color_views is 1), the projection, and the
// row written as four 16-byte stores.  The SH degree is a template
// argument (-1: colors given), so the coefficients' loops unroll.
//
// What bounds it on an H100: bytes.  A Gaussian reads 237 bytes of leaves
// at SH degree 3 and writes, a view, a 64-byte row, means2d, a depth, a
// radius and a flag (81 bytes): 131,072 Gaussians at 8 views move ~116 MB,
// ~0.035 ms at 3.35 TB/s (one view: ~42 MB, ~0.012 ms).  Its ~400 float
// operations a view, none fused, are ~0.4 GFLOP, ~0.02 ms at the card's
// non-FMA rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "projection.cuh"

namespace {

constexpr int kThreads = 128;

template <int DEG>
__global__ void __launch_bounds__(kThreads) projection_fwd_kernel(
    p1::Inputs in, float4* __restrict__ payload, float2* __restrict__ means2d,
    float* __restrict__ depths, float* __restrict__ radii, uint8_t* __restrict__ valid) {
  using p1::rf;
  const int64_t rows = (int64_t)in.n + 1;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  // the zero pad row of every view
  for (int v = g; v < in.views; v += gridDim.x * kThreads) {
    float4* row = payload + ((int64_t)v * rows + in.n) * 4;
    for (int q = 0; q < 4; ++q) row[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (g >= in.n) return;
  const p1::Cam cam = p1::camera(in);
  p1::Gauss a;
  p1::activate(in, g, a);
  rf coef[(DEG >= 0 ? (DEG + 1) * (DEG + 1) : 1)][3];
  if constexpr (DEG >= 0) p1::load_coefs<DEG>(in, g, coef);
  rf rgb[3];
  for (int v = 0; v < in.views; ++v) {
    const int vc = in.color_views == 1 ? 0 : v;
    if (v == 0 || in.color_views > 1) {
      if constexpr (DEG >= 0) {
        p1::Shade s;
        p1::shade<DEG>(a, coef, in.camtoworlds + 16 * vc, s);
        for (int c = 0; c < 3; ++c) rgb[c] = s.rgb[c];
      } else {
        const float* col = in.colors + ((int64_t)vc * in.n + g) * 3;
        for (int c = 0; c < 3; ++c) rgb[c] = rf(col[c]);
      }
    }
    p1::Proj r;
    p1::project(in, cam, a, g, v, r);
    const int64_t e = (int64_t)v * in.n + g;
    float4* row = payload + ((int64_t)v * rows + g) * 4;
    row[0] = make_float4(r.mx.v, r.my.v, r.conic[0].v, r.conic[1].v);
    row[1] = make_float4(r.conic[2].v, r.opa.v, rgb[0].v, rgb[1].v);
    row[2] = make_float4(rgb[2].v, 1.0f, 0.0f, 0.0f);
    row[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    means2d[e] = make_float2(r.mx.v, r.my.v);
    depths[e] = r.t[2].v;
    radii[e] = r.radius.v;
    valid[e] = r.valid ? 1 : 0;
  }
}

template <int DEG>
cudaError_t launch(const p1::Inputs& in, float* payload, float* means2d, float* depths,
                   float* radii, uint8_t* valid, cudaStream_t s) {
  const int blocks = (in.n + 1 + kThreads - 1) / kThreads;
  projection_fwd_kernel<DEG><<<blocks, kThreads, 0, s>>>(
      in, reinterpret_cast<float4*>(payload), reinterpret_cast<float2*>(means2d), depths, radii,
      valid);
  return cudaGetLastError();
}

}  // namespace

// Inputs as p1::Inputs (csrc/projection.cuh) lists them, every float
// tensor contiguous float32; `degree` the SH degree 0-3, or -1 where colors
// are given.  Outputs: payload [views, n + 1, 16] (16-byte aligned),
// means2d [views, n, 2] (its first two columns, contiguous for the
// binning), depths, radii [views, n] float32, valid [views, n] bool; every
// element written.  Returns a cudaError_t: nonzero where the launch was refused.
extern "C" int chs_projection_fwd(
    const float* means, const float* quats, const float* scales, const float* opacity,
    const float* sh_dc, const float* sh_rest, const float* colors, const float* viewmats,
    const float* camtoworlds, const float* offset, const uint8_t* alive, const float* fx,
    const float* fy, const float* cx, const float* cy,
    float* payload, float* means2d, float* depths, float* radii, uint8_t* valid, int n,
    int views,
    int color_views, int rest, int degree, int raw, int antialias, float near_plane,
    float width, float height, void* cu_stream) {
  if (n < 1 || views < 1 || (color_views != 1 && color_views != views))
    return (int)cudaErrorInvalidValue;
  if (degree < -1 || degree > 3 || (degree >= 0 && rest < (degree + 1) * (degree + 1) - 1))
    return (int)cudaErrorInvalidValue;
  if ((degree < 0 && !colors) || (degree >= 0 && (!sh_dc || !camtoworlds)) || (raw && !alive))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)payload % 16 || (uintptr_t)means2d % 8) return (int)cudaErrorMisalignedAddress;
  const p1::Inputs in{means, quats, scales, opacity, sh_dc, sh_rest, colors, viewmats,
                      camtoworlds, offset, alive, fx, fy, cx, cy, n, views, color_views,
                      rest, raw, antialias, near_plane, width, height};
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
  switch (degree) {
    case -1: return (int)launch<-1>(in, payload, means2d, depths, radii, valid, s);
    case 0: return (int)launch<0>(in, payload, means2d, depths, radii, valid, s);
    case 1: return (int)launch<1>(in, payload, means2d, depths, radii, valid, s);
    case 2: return (int)launch<2>(in, payload, means2d, depths, radii, valid, s);
    default: return (int)launch<3>(in, payload, means2d, depths, radii, valid, s);
  }
}
