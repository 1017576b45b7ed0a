// The CRF's monotone MLP, forward: kernel T1's forward (CUDA C++ for
// sm_90a).
//
// Replaces: XLA's fusion of casualhdrsplat_tpu/models/crf.py:132
// (`_monotone_mlp` on `_norm_log`; the reference has no Pallas kernel
// there), which the port first wrote as a Triton kernel.  Python launcher,
// plain PyTorch version and closed-form backward:
// casualhdrsplat_torch/ops/crf_fused.py; the backward kernel:
// csrc/crf_mlp_bwd.cu.
//
// What it computes, for every pixel p and channel ch of x [n, 3]:
//     u = (log(max(x, 0) + 1e-8) - log_min) / span
//     y = sum_j w_j sigmoid(k_j (u - c_j)) + g u + bias
//     out = clip(1.004 sigmoid(y) - 0.002, 0, 1)
// with the activated parameters k, c, w [3, H] and g, bias [3] read from
// device pointers (a CUDA graph replays the call with their values of the
// moment, never with values frozen at capture).
//
// What bounds it on an H100.  Per (pixel, channel) element: H units of
// about 8 fp32 operations, each with an exp and a reciprocal, and 12 bytes
// a pixel read and 12 written (a frame of 5.12 M pixels: 0.04 ms of bytes).
// exp and reciprocal run on the special-function units (MUFU): 16 results
// a clock per SM against 128 fp32 FMAs, an eighth of the rate.  Two MUFU
// operations a unit take a warp 16 clocks of that pipe against ~6 issue
// slots of everything else, so a plain design is bound by MUFU (2 H + 3
// operations an element: ~0.25 ms a frame at H = 32).
//
// Design.
// - One thread per pixel over its three channels, kPPT pixels a thread at
//   a time, on a persistent grid (kBlocksPerSM blocks per SM, fewer for a
//   small call) that strides over the pixels thread by thread: a warp
//   reads and writes 384 contiguous bytes, x is read once, and each
//   parameter load serves kPPT sigmoids whose chains interleave.
// - The parameters are staged once a block into shared memory, one
//   16-byte {-k log2(e), c, w} per unit, read at a warp-uniform address
//   (a broadcast).
// - Four units share one reciprocal.  With d_i = 1 + 2^z_i,
//   z_i = (u - c_i)(-k_i log2(e)),
//       sum_i w_i / d_i = N / D,  D = d_0 d_1 d_2 d_3,
//   N and D by nine multiplies and adds, then one rcp.approx: 5 MUFU
//   operations for four units in place of 8.  z_i is clamped at 30 so
//   that D <= (1 + 2^30)^4 < 2^121 stays finite: a unit past the clamp
//   adds w_i / (1 + 2^30) where it would add a smaller positive number,
//   an error under 1e-9 w_i.  z_i is taken as a subtraction and a
//   multiply, not one fma with a folded k c: the exponent then keeps an
//   ulp of relative error where u is near c_i.  A unit costs 1.25 MUFU
//   operations (10 clocks a warp) and ~7.75 issue slots: still MUFU-bound,
//   at 0.63 of the plain design's time.
// - log and the division by span run at full precision, once an element,
//   in issue slots MUFU leaves free; the output's sigmoid is ex2 and rcp.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
// blocks resident per SM (registers capped to fit) and the grid's multiple
// of the SM count; casualhdrsplat_torch/ops/crf_fused.py sizes the grid
constexpr int kBlocksPerSM = 4;
constexpr int kPPT = 2;
constexpr float kLog2e = 1.4426950408889634f;
// 2^30: past it a unit's sigmoid is below 1e-9
constexpr float kMaxExponent = 30.0f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 + 2^z for z = (u - c)(-k log2 e), clamped
__device__ __forceinline__ float denominator(float u, float4 unit) {
  return 1.0f + ex2(fminf((u - unit.y) * unit.x, kMaxExponent));
}

template <int HP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) crf_mlp_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ k, const float* __restrict__ c,
    const float* __restrict__ w, const float* __restrict__ g, const float* __restrict__ bias,
    float* __restrict__ out, int n, int hidden, float log_min, float span) {
  static_assert(HP % 4 == 0, "units go in fours");
  __shared__ float4 units[3 * HP];  // {-k log2 e, c, w, 0}; a padded unit is 0 (w = 0)
  __shared__ float2 affine[3];      // {g, bias}
  for (int t = threadIdx.x; t < 3 * HP; t += blockDim.x) {
    const int ch = t / HP, j = t % HP;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < hidden) {
      const int i = ch * hidden + j;
      v = make_float4(-k[i] * kLog2e, c[i], w[i], 0.0f);
    }
    units[t] = v;
  }
  if (threadIdx.x < 3) affine[threadIdx.x] = make_float2(g[threadIdx.x], bias[threadIdx.x]);
  __syncthreads();

  const int stride = gridDim.x * blockDim.x;
  for (int p0 = blockIdx.x * blockDim.x + threadIdx.x; p0 < n; p0 += kPPT * stride) {
    float xs[kPPT][3];
#pragma unroll
    for (int i = 0; i < kPPT; ++i) {
      const int p = p0 + i * stride;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) xs[i][ch] = p < n ? x[3 * p + ch] : 1.0f;
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float4* unit = units + ch * HP;
      float u[kPPT], y[kPPT];
#pragma unroll
      for (int i = 0; i < kPPT; ++i) {
        u[i] = (logf(fmaxf(xs[i][ch], 0.0f) + 1e-8f) - log_min) / span;
        y[i] = 0.0f;
      }
      // two fours a pass (one at 8 units, where two would unroll the whole
      // loop): unrolled further, the compiler hoists every unit's
      // parameters into registers and spills them
#pragma unroll(HP > 8 ? 2 : 1)
      for (int j = 0; j < HP; j += 4) {
        const float4 a = unit[j], b = unit[j + 1], e = unit[j + 2], f = unit[j + 3];
#pragma unroll
        for (int i = 0; i < kPPT; ++i) {
          const float da = denominator(u[i], a), db = denominator(u[i], b);
          const float de = denominator(u[i], e), df = denominator(u[i], f);
          const float dab = da * db, def = de * df;
          // w_a / d_a + w_b / d_b = nab / dab, and so on
          const float nab = fmaf(a.z, db, b.z * da), nef = fmaf(e.z, df, f.z * de);
          y[i] = fmaf(fmaf(nab, def, nef * dab), rcp(dab * def), y[i]);
        }
      }
      const float2 gb = affine[ch];
#pragma unroll
      for (int i = 0; i < kPPT; ++i) {
        const int p = p0 + i * stride;
        const float sy = rcp(1.0f + ex2(-(fmaf(gb.x, u[i], y[i]) + gb.y) * kLog2e));
        // sigmoid(y) 1.004 - 0.002, rounded as the plain version rounds it
        const float o = __fadd_rn(__fmul_rn(sy, 1.004f), -0.002f);
        if (p < n) out[3 * p + ch] = fminf(fmaxf(o, 0.0f), 1.0f);
      }
    }
  }
}

template <int HP>
cudaError_t launch(const float* x, const float* k, const float* c, const float* w,
                   const float* g, const float* bias, float* out, int n, int hidden,
                   int blocks, float log_min, float span, cudaStream_t s) {
  crf_mlp_fwd_kernel<HP><<<blocks, kThreads, 0, s>>>(x, k, c, w, g, bias, out, n, hidden,
                                                     log_min, span);
  return cudaGetLastError();
}

}  // namespace

// x, out [n, 3] and k, c, w [3, hidden], g, bias [3], float32, contiguous on
// the device; hp: hidden padded to 8, 16, 32 or 64; blocks: the grid (the
// launcher's choice, kBlocksPerSM per SM at most).  Returns a cudaError_t.
extern "C" int chs_crf_mlp_fwd(const float* x, const float* k, const float* c, const float* w,
                               const float* g, const float* bias, float* out, int n, int hidden,
                               int hp, int blocks, float log_min, float span, void* cu_stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (hidden < 1 || hidden > hp || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
  switch (hp) {
    case 8: return (int)launch<8>(x, k, c, w, g, bias, out, n, hidden, blocks, log_min, span, s);
    case 16: return (int)launch<16>(x, k, c, w, g, bias, out, n, hidden, blocks, log_min, span, s);
    case 32: return (int)launch<32>(x, k, c, w, g, bias, out, n, hidden, blocks, log_min, span, s);
    case 64: return (int)launch<64>(x, k, c, w, g, bias, out, n, hidden, blocks, log_min, span, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
