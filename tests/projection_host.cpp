// Kernel P1's arithmetic (casualhdrsplat_torch/csrc/projection.cuh) built
// for the host: the forward's and the backward's per-Gaussian chains in
// plain loops, the pose gradients summed in order.  Built by
// tests/test_torch_projection_fused.py with the system's C++ compiler under
// -ffp-contract=off and held to autograd of the plain chain on the CPU.

#include "projection.cuh"

using namespace p1;

namespace {

template <int DEG>
constexpr int bases() {
  return DEG >= 0 ? (DEG + 1) * (DEG + 1) : 1;
}

template <int DEG>
void forward(const Inputs& in, float* payload, float* means2d, float* depths, float* radii,
             uint8_t* valid) {
  const int64_t rows = (int64_t)in.n + 1;
  for (int v = 0; v < in.views; ++v)
    for (int q = 0; q < kPayloadDim; ++q) payload[(v * rows + in.n) * kPayloadDim + q] = 0.0f;
  const Cam cam = camera(in);
  for (int g = 0; g < in.n; ++g) {
    Gauss a;
    activate(in, g, a);
    rf coef[bases<DEG>()][3];
    if constexpr (DEG >= 0) load_coefs<DEG>(in, g, coef);
    rf rgb[3];
    for (int v = 0; v < in.views; ++v) {
      const int vc = in.color_views == 1 ? 0 : v;
      if (v == 0 || in.color_views > 1) {
        if constexpr (DEG >= 0) {
          Shade s;
          shade<DEG>(a, coef, in.camtoworlds + 16 * vc, s);
          for (int c = 0; c < 3; ++c) rgb[c] = s.rgb[c];
        } else {
          for (int c = 0; c < 3; ++c) rgb[c] = rf(in.colors[((int64_t)vc * in.n + g) * 3 + c]);
        }
      }
      Proj r;
      project(in, cam, a, g, v, r);
      const float row[kPayloadDim] = {r.mx.v, r.my.v, r.conic[0].v, r.conic[1].v,
                                      r.conic[2].v, r.opa.v, rgb[0].v, rgb[1].v,
                                      rgb[2].v, 1.0f};
      for (int q = 0; q < kPayloadDim; ++q) payload[(v * rows + g) * kPayloadDim + q] = row[q];
      means2d[2 * (v * in.n + g)] = r.mx.v;
      means2d[2 * (v * in.n + g) + 1] = r.my.v;
      depths[v * in.n + g] = r.t[2].v;
      radii[v * in.n + g] = r.radius.v;
      valid[v * in.n + g] = r.valid;
    }
  }
}

template <int DEG>
void backward(const Inputs& in, const float* d_payload, const Outs& out, float* g_viewmats,
              float* g_camtoworlds) {
  const int64_t rows = (int64_t)in.n + 1;
  for (int i = 0; i < in.views * 16; ++i) g_viewmats[i] = 0.0f;
  for (int i = 0; i < in.color_views * 16; ++i) g_camtoworlds[i] = 0.0f;
  const Cam cam = camera(in);
  for (int g = 0; g < in.n; ++g) {
    Gauss a;
    activate(in, g, a);
    rf coef[bases<DEG>()][3];
    if constexpr (DEG >= 0) load_coefs<DEG>(in, g, coef);
    Acc<DEG> acc;
    for (int v = 0; v < in.views; ++v) {
      float gW[3][3], gt[3], gc[3];
      view_vjp<DEG>(in, cam, a, coef, g, v, d_payload + (v * rows + g) * kPayloadDim, out, acc, gW,
                    gt, gc);
      for (int i = 0; i < 3; ++i) {
        for (int k = 0; k < 3; ++k) g_viewmats[v * 16 + 4 * i + k] += gW[i][k];
        g_viewmats[v * 16 + 4 * i + 3] += gt[i];
      }
      if (in.color_views > 1)
        for (int k = 0; k < 3; ++k) g_camtoworlds[16 * v + 4 * k + 3] += gc[k];
    }
    shared_vjp<DEG>(in, a, coef, g, out, acc);
    if (in.color_views == 1)
      for (int k = 0; k < 3; ++k) g_camtoworlds[4 * k + 3] += acc.gc[k];
    write_grads<DEG>(in, a, g, acc, out);
  }
}

}  // namespace

// The arguments of chs_projection_fwd, without the stream.
extern "C" void host_projection_fwd(
    const float* means, const float* quats, const float* scales, const float* opacity,
    const float* sh_dc, const float* sh_rest, const float* colors, const float* viewmats,
    const float* camtoworlds, const float* offset, const uint8_t* alive, const float* fx,
    const float* fy, const float* cx, const float* cy,
    float* payload, float* means2d, float* depths, float* radii, uint8_t* valid, int n, int views,
    int color_views, int rest, int degree, int raw, int antialias, float near_plane,
    float width, float height) {
  const Inputs in{means, quats, scales, opacity, sh_dc, sh_rest, colors, viewmats,
                  camtoworlds, offset, alive, fx, fy, cx, cy, n, views, color_views,
                  rest, raw, antialias, near_plane, width, height};
  switch (degree) {
    case -1: return forward<-1>(in, payload, means2d, depths, radii, valid);
    case 0: return forward<0>(in, payload, means2d, depths, radii, valid);
    case 1: return forward<1>(in, payload, means2d, depths, radii, valid);
    case 2: return forward<2>(in, payload, means2d, depths, radii, valid);
    default: return forward<3>(in, payload, means2d, depths, radii, valid);
  }
}

// The arguments of chs_projection_bwd, without the partial rows and the
// stream; every gradient pointer non-null except sh_dc, sh_rest (colors
// given) and colors, offset (absent).
extern "C" void host_projection_bwd(
    const float* means, const float* quats, const float* scales, const float* opacity,
    const float* sh_dc, const float* sh_rest, const float* colors, const float* viewmats,
    const float* camtoworlds, const float* offset, const uint8_t* alive, const float* fx,
    const float* fy, const float* cx, const float* cy,
    const float* d_payload, float* g_means, float* g_quats, float* g_scales,
    float* g_opacity, float* g_sh_dc, float* g_sh_rest, float* g_colors, float* g_viewmats,
    float* g_camtoworlds, float* g_offset, int n, int views, int color_views, int rest,
    int degree, int raw, int antialias, float near_plane, float width, float height) {
  const Inputs in{means, quats, scales, opacity, sh_dc, sh_rest, colors, viewmats,
                  camtoworlds, offset, alive, fx, fy, cx, cy, n, views, color_views,
                  rest, raw, antialias, near_plane, width, height};
  const Outs out{g_means, g_quats, g_scales, g_opacity, g_sh_dc, g_sh_rest, g_colors, g_offset};
  switch (degree) {
    case -1: return backward<-1>(in, d_payload, out, g_viewmats, g_camtoworlds);
    case 0: return backward<0>(in, d_payload, out, g_viewmats, g_camtoworlds);
    case 1: return backward<1>(in, d_payload, out, g_viewmats, g_camtoworlds);
    case 2: return backward<2>(in, d_payload, out, g_viewmats, g_camtoworlds);
    default: return backward<3>(in, d_payload, out, g_viewmats, g_camtoworlds);
  }
}
