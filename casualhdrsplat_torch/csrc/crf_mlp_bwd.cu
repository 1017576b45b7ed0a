// The CRF's monotone MLP, backward: kernel T1's backward (CUDA C++ for
// sm_90a), and the fixed-order sum of its per-block partial rows.
//
// Replaces: the backward of XLA's fusion of
// casualhdrsplat_tpu/models/crf.py:132 (`_monotone_mlp` on `_norm_log`,
// differentiated by jax.grad; no Pallas kernel there), which the port first
// wrote as a Triton kernel.  Python launcher and the closed-form plain
// version it implements (`monotone_crf_backward_reference`):
// casualhdrsplat_torch/ops/crf_fused.py; the forward: csrc/crf_mlp_fwd.cu.
//
// What it computes.  For x, the upstream gradient go [n, 3] and the
// activated parameters k, c, w [3, H], g, bias [3] (device pointers), per
// element (pixel p, channel ch), recomputing the forward:
//     s_j = sigmoid(k_j (u - c_j)),  ws_j = w_j s_j (1 - s_j)
//     t = go dclip 1.004 sy (1 - sy)       (sy = sigmoid(y))
//     dx = t (sum_j ws_j k_j + g) / ((max(x, 0) + 1e-8) span) dmax
// and the parameter gradients summed over the pixels:
//     dk_j = sum t ws_j (u - c_j), dc_j = -k_j sum t ws_j, dw_j = sum t s_j,
//     dg = sum t u, dbias = sum t.
// dclip and dmax are jnp.clip's and jnp.maximum's subgradients: 1 strictly
// inside, 0.5 at the bound, 0 outside.  Nothing of the forward is saved:
// its [3, n, H] units would take 1.97 GB a frame.
//
// What bounds it on an H100.  Per (element, unit): the forward's exp and
// reciprocal on the special-function units (MUFU: 16 a clock per SM
// against 128 fp32 FMAs, an eighth of the rate), and 11 fp32 instructions
// and a shared load: 3 to recompute the unit, 3 for ws and ws (u - c), 2
// for the unit's share of y and dy/du, 3 fma into the parameter sums.  A
// warp spends ~14 issue slots against 16 MUFU clocks a unit: nearly
// balanced, so here units keep their own reciprocal (sharing one between
// two units, as the forward shares one between four, would trade 4 MUFU
// clocks for 2 more issue slots: no gain).  Bytes: 24 a pixel read, 12
// written.
//
// Design.
// - A block is three channel sets of kWarpsPerChannel warps; warp w serves
//   channel w / kWarpsPerChannel, so every lane keeps one channel's sums.
// - A group of G = HP / 16 neighbouring lanes (1 up to 16 units) shares an
//   element: lane q of the group takes units q, q + G, ... (16 units,
//   consecutive lanes on consecutive 16-byte parameter records: no bank
//   conflict) and keeps their 3 x 16 sums (t ws (u - c), t ws, t s) and the
//   element's t u and t in registers, with the unit's s, ws and ws (u - c)
//   between the two halves of a pass (~150 registers: 2 blocks, 12 warps
//   an SM, each with 16 independent unit chains).  The lanes of a group
//   each repeat the element's own work (x, u, y's sigmoid, t, dx: ~55
//   instructions); 16 units a lane keep that under a fifth of a pass, and
//   ran faster on an H100 than 8 units a lane at twice the warps.  y and dy/du are reduced over the group with log2 G
//   __shfl_xor_sync rounds (every lane ends with the same bits); the
//   group's first lane writes dx, with one rcp.approx for
//   1 / ((max(x, 0) + 1e-8) span).
// - The grid is persistent, a fixed kBlocksPerSM blocks per SM (fewer for a
//   small call), and strides over the pixels group by group: the pixels a
//   block sums, and so the bits of every sum, depend on the input and the
//   grid alone.
// - Deterministic reduction without atomics: each warp reduces its groups'
//   sums with shuffles in a fixed order, the block adds its warps through
//   shared memory in warp order and writes one partial row per channel;
//   the second kernel (crf_col_sum_kernel) adds the blocks' rows in block
//   order.  Two launches on the same input give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarpsPerChannel = 2;
constexpr int kThreads = 3 * kWarpsPerChannel * 32;
// blocks resident per SM (registers capped to fit) and the grid's multiple
// of the SM count; casualhdrsplat_torch/ops/crf_fused.py sizes the grid
// and the partial rows
constexpr int kBlocksPerSM = 2;
constexpr int kUnitsPerLane = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// jnp.maximum's and jnp.clip's subgradient: 1 inside, 0.5 at a bound
__device__ __forceinline__ float half_at_ties(bool inside, bool at_bound) {
  return inside ? 1.0f : (at_bound ? 0.5f : 0.0f);
}

template <int HP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) crf_mlp_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ go, const float* __restrict__ k,
    const float* __restrict__ c, const float* __restrict__ w, const float* __restrict__ g,
    const float* __restrict__ bias, float* __restrict__ dx, float* __restrict__ part, int n,
    int hidden, float u_scale, float u_shift, float span) {
  constexpr int U = HP < kUnitsPerLane ? HP : kUnitsPerLane;
  constexpr int G = HP / U, GROUPS = 32 / G, WIDTH = 3 * HP + 2;
  static_assert(HP % U == 0 && G <= 32, "a lane's units split HP evenly");
  __shared__ float4 units[3 * HP];  // {-k log2 e, c, w, k}; a padded unit is 0 (w = 0)
  __shared__ float2 affine[3];      // {g, bias}
  // each warp's sums: [dk | dc | dw | dg, dbias]
  __shared__ float rows[3 * kWarpsPerChannel][WIDTH];
  for (int t = threadIdx.x; t < 3 * HP; t += blockDim.x) {
    const int ch = t / HP, j = t % HP;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < hidden) {
      const int i = ch * hidden + j;
      v = make_float4(-k[i] * kLog2e, c[i], w[i], k[i]);
    }
    units[t] = v;
  }
  if (threadIdx.x < 3) affine[threadIdx.x] = make_float2(g[threadIdx.x], bias[threadIdx.x]);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch = warp / kWarpsPerChannel;
  const int q = lane % G, group = lane / G;
  const float4* unit = units + ch * HP + q;  // this lane's unit i is unit[i * G]
  const float2 gb = affine[ch];
  float acc_k[U], acc_c[U], acc_w[U], acc_g = 0.0f, acc_b = 0.0f;
#pragma unroll
  for (int i = 0; i < U; ++i) acc_k[i] = acc_c[i] = acc_w[i] = 0.0f;

  // a warp-uniform base: every lane runs every pass (the shuffles need it);
  // a group past the end reads x = 1, go = 0, so t = 0 adds nothing.  The
  // next pass's x and go are loaded a pass ahead.
  const int per_pass = gridDim.x * kWarpsPerChannel * GROUPS;
  int base = (blockIdx.x * kWarpsPerChannel + warp % kWarpsPerChannel) * GROUPS;
  float x_next = base + group < n ? x[3 * (base + group) + ch] : 1.0f;
  float go_next = base + group < n ? go[3 * (base + group) + ch] : 0.0f;
  for (; base < n; base += per_pass) {
    const int p = base + group;
    const bool valid = p < n;
    const float xv = x_next, gv = go_next;
    const int p_next = p + per_pass;
    x_next = p_next < n ? x[3 * p_next + ch] : 1.0f;
    go_next = p_next < n ? go[3 * p_next + ch] : 0.0f;
    const float ee = fmaxf(xv, 0.0f) + 1e-8f;
    // (log(ee) - log_min) / span, as log2(ee) ln2 / span - log_min / span
    const float u = fmaf(lg2(ee), u_scale, u_shift);
    float s[U], ws[U], wsd[U], y = 0.0f, dydu = 0.0f;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const float4 r = unit[i * G];
      const float d = u - r.y;
      const float si = rcp(1.0f + ex2(d * r.x));
      const float wsi = r.z * fmaf(-si, si, si);
      y = fmaf(r.z, si, y);
      dydu = fmaf(wsi, r.w, dydu);
      s[i] = si;
      ws[i] = wsi;
      wsd[i] = wsi * d;
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      y += __shfl_xor_sync(0xffffffffu, y, off);
      dydu += __shfl_xor_sync(0xffffffffu, dydu, off);
    }
    const float sy = rcp(1.0f + ex2(-(fmaf(gb.x, u, y) + gb.y) * kLog2e));
    const float o = __fadd_rn(__fmul_rn(sy, 1.004f), -0.002f);
    const float dq = half_at_ties(o > 0.0f && o < 1.0f, o == 0.0f || o == 1.0f);
    const float t = gv * dq * 1.004f * (sy * (1.0f - sy));
    const float dxv = t * (dydu + gb.x) * rcp(ee * span) * half_at_ties(xv > 0.0f, xv == 0.0f);
    if (valid && q == 0) dx[3 * p + ch] = dxv;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      acc_k[i] = fmaf(t, wsd[i], acc_k[i]);
      acc_c[i] = fmaf(t, ws[i], acc_c[i]);
      acc_w[i] = fmaf(t, s[i], acc_w[i]);
    }
    acc_g = fmaf(t, u, acc_g);
    acc_b += t;
  }

  // the warp's sums over its groups, in a fixed butterfly order
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      acc_k[i] += __shfl_xor_sync(0xffffffffu, acc_k[i], off);
      acc_c[i] += __shfl_xor_sync(0xffffffffu, acc_c[i], off);
      acc_w[i] += __shfl_xor_sync(0xffffffffu, acc_w[i], off);
    }
    acc_g += __shfl_xor_sync(0xffffffffu, acc_g, off);
    acc_b += __shfl_xor_sync(0xffffffffu, acc_b, off);
  }
  if (group == 0) {
    float* row = rows[warp];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int j = i * G + q;
      row[j] = acc_k[i];
      row[HP + j] = -unit[i * G].w * acc_c[i];
      row[2 * HP + j] = acc_w[i];
    }
    if (q == 0) {
      row[3 * HP] = acc_g;
      row[3 * HP + 1] = acc_b;
    }
  }
  __syncthreads();
  // the block's row per channel, its warps added in order
  for (int t = threadIdx.x; t < 3 * WIDTH; t += blockDim.x) {
    const int chan = t / WIDTH, col = t % WIDTH;
    float v = rows[chan * kWarpsPerChannel][col];
#pragma unroll
    for (int wi = 1; wi < kWarpsPerChannel; ++wi) v += rows[chan * kWarpsPerChannel + wi][col];
    part[(size_t)blockIdx.x * 3 * WIDTH + t] = v;
  }
}

// total[col] = sum over rows r = 0, 1, ... of part[r][col]: 32 strands a
// column, strand i taking rows i, i + 32, ..., then the strands in order
__global__ void __launch_bounds__(1024) crf_col_sum_kernel(const float* __restrict__ part,
                                                           float* __restrict__ total, int rows,
                                                           int cols) {
  __shared__ float sums[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float v = 0.0f;
  if (col < cols)
    for (int r = threadIdx.y; r < rows; r += 32) v += part[(size_t)r * cols + col];
  sums[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float acc = sums[0][threadIdx.x];
    for (int i = 1; i < 32; ++i) acc += sums[i][threadIdx.x];
    total[col] = acc;
  }
}

template <int HP>
cudaError_t launch(const float* x, const float* go, const float* k, const float* c,
                   const float* w, const float* g, const float* bias, float* dx, float* part,
                   float* total, int n, int hidden, int blocks, float log_min, float span,
                   cudaStream_t s) {
  const float u_scale = (float)(0.6931471805599453 / (double)span);
  const float u_shift = (float)(-(double)log_min / (double)span);
  crf_mlp_bwd_kernel<HP><<<blocks, kThreads, 0, s>>>(x, go, k, c, w, g, bias, dx, part, n,
                                                     hidden, u_scale, u_shift, span);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cols = 3 * (3 * HP + 2);
  crf_col_sum_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, s>>>(part, total, blocks, cols);
  return cudaGetLastError();
}

}  // namespace

// x, go, dx [n, 3], k, c, w [3, hidden], g, bias [3], float32, contiguous on
// the device; hp: hidden padded to 8, 16, 32 or 64; blocks: the grid;
// part: blocks x 3 x (3 hp + 2) floats of scratch; total [3, 3 hp + 2]:
// [dk | dc | dw | dg, dbias] per channel, the padded units' columns
// included.  Returns a cudaError_t.
extern "C" int chs_crf_mlp_bwd(const float* x, const float* go, const float* k, const float* c,
                               const float* w, const float* g, const float* bias, float* dx,
                               float* part, float* total, int n, int hidden, int hp, int blocks,
                               float log_min, float span, void* cu_stream) {
  if (n <= 0 || hidden < 1 || hidden > hp || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(cu_stream);
#define CHS_LAUNCH(HP)                                                                      \
  return (int)launch<HP>(x, go, k, c, w, g, bias, dx, part, total, n, hidden, blocks, log_min, \
                         span, s)
  switch (hp) {
    case 8: CHS_LAUNCH(8);
    case 16: CHS_LAUNCH(16);
    case 32: CHS_LAUNCH(32);
    case 64: CHS_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CHS_LAUNCH
}
