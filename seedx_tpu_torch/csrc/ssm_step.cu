// K7: one recurrence step of Mamba-2's selective state for every slot of a
// decode step, on Hopper (sm_90a), fp32 state, bf16 inputs.
//
// Replaces no Pallas kernel: the JAX package has no state-space layer.  A
// Nemotron-H decode step runs it once per Mamba block (23 of the 52 blocks)
// inside the captured step.  For slot b and head h (head h reads group
// g = h / (H / G) of B and C):
//   dt   = softplus(dt_raw[b, h] + dt_bias[h])              (fp32, no clamp)
//   dA   = exp(dt * -exp(A_log[h]))
//   S[p, n] = dA * S[p, n] + (dt * x[p]) * B[g, n]       (S [P, N], fp32)
//   y[p] = sum_n S[p, n] * C[g, n] + D[h] * x[p]         (fp32 out)
// x, B and C are the slot's row of the activated conv output
// xBC = [x (H * P) | B (G * N) | C (G * N)], bf16.
//
// What bounds it: bytes.  The state is 2 MiB a slot a block (64 heads x 64
// x 128 fp32): at 64 slots a step reads and writes 134 MB a block, against
// a few hundred kB of x, B, C, dt and y, and does 6 flops a state element
// (~0.3 flop a byte).  In plain torch the decay, the outer-product add and
// S . C are separate passes over the state (read, write, read, write,
// read); here each element is read once and written once.
//
// Design: one block of 128 threads (4 warps) per (head, slot), grid (H, B).
// Each lane owns N / 32 = 4 consecutive n (one 16-byte float4 of a state
// row, one 8-byte load each of B and C); each warp walks P / 4 state rows,
// four at a time so that four 16-byte loads a thread are in flight before
// any arithmetic.  A row's y is its lanes' partial sums reduced by
// butterfly shuffles in one fixed order: no atomics, and a rerun gives the
// same bits.  The state is updated in place; nothing else is written but y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kN = 128;           // state size: 4 floats a lane
constexpr int kUnroll = 4;        // state rows a warp has in flight

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));   // torch's threshold 20, beta 1
}

__device__ __forceinline__ float4 load_bf16x4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__global__ void __launch_bounds__(kThreads)
    ssm_step_kernel(float* __restrict__ state,
                    const __nv_bfloat16* __restrict__ xbc,
                    const __nv_bfloat16* __restrict__ dt_raw,
                    const float* __restrict__ dt_bias,
                    const float* __restrict__ a_log,
                    const float* __restrict__ d_skip, float* __restrict__ y,
                    int H, int P, int G, long xbc_stride, long dt_stride) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = h / (H / G);
  const __nv_bfloat16* row = xbc + b * xbc_stride;
  const __nv_bfloat16* xh = row + (long)h * P;
  const float4 bv = load_bf16x4(row + (long)H * P + (long)g * kN + lane * 4);
  const float4 cv =
      load_bf16x4(row + (long)H * P + (long)(G + g) * kN + lane * 4);
  const float dt =
      softplus(__bfloat162float(dt_raw[b * dt_stride + h]) + dt_bias[h]);
  const float da = expf(dt * -expf(a_log[h]));
  const float dskip = d_skip[h];
  float* sh = state + ((long)b * H + h) * P * kN;
  float* yh = y + ((long)b * H + h) * P;

  const int rows = P / kWarps;          // a warp's state rows
  const int p0 = warp * rows;
  for (int i = 0; i < rows; i += kUnroll) {
    float4 s[kUnroll];
    float xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + i + u;
      s[u] = reinterpret_cast<const float4*>(sh + (long)p * kN)[lane];
      xs[u] = __bfloat162float(xh[p]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + i + u;
      const float dx = dt * xs[u];
      s[u].x = da * s[u].x + dx * bv.x;
      s[u].y = da * s[u].y + dx * bv.y;
      s[u].z = da * s[u].z + dx * bv.z;
      s[u].w = da * s[u].w + dx * bv.w;
      reinterpret_cast<float4*>(sh + (long)p * kN)[lane] = s[u];
      float part = s[u].x * cv.x + s[u].y * cv.y + s[u].z * cv.z +
                   s[u].w * cv.w;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) yh[p] = part + dskip * xs[u];
    }
  }
}

}  // namespace

// state fp32 [B][H][P][128] (in place); xbc bf16 rows of xbc_stride
// elements, [x (H * P) | B (G * 128) | C (G * 128)] at the row's start; dt
// bf16 rows of dt_stride elements, [H] at the row's start; dt_bias, a_log,
// d_skip fp32 [H]; y fp32 [B][H][P].  P a multiple of 16, H of G; the
// state 16-byte and the xbc rows 8-byte aligned.
extern "C" int ssm_step_f32(void* state, const void* xbc, const void* dt,
                            const void* dt_bias, const void* a_log,
                            const void* d_skip, void* y, int B, int H, int P,
                            int G, int N, long xbc_stride, long dt_stride,
                            void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (N != kN || P % (kWarps * kUnroll) || G <= 0 || H % G || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ssm_step_kernel<<<dim3(H, B), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(state), static_cast<const __nv_bfloat16*>(xbc),
      static_cast<const __nv_bfloat16*>(dt),
      static_cast<const float*>(dt_bias), static_cast<const float*>(a_log),
      static_cast<const float*>(d_skip), static_cast<float*>(y), H, P, G,
      xbc_stride, dt_stride);
  return static_cast<int>(cudaGetLastError());
}
