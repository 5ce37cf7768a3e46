// W4A8 int4 weight matmul for Hopper (sm_90a): y = x @ dequant(packed, scale).
//
// Replaces: seedx_tpu/ops/int4_matmul.py `_kernel` (the Pallas TPU kernel
// reached through `int4_matmul`, and through `int4_matmul_stacked` on one
// layer of the stacked weights -- here simply the view `packed[li]`).
// Same contract and the same packed bytes, so one quantized tree feeds both
// packages:
//   * x [rows, in] bf16 is quantized per row to int8:
//     xa = max(absmax, 1e-8) / 127 (a true division, as JAX), x8 = rint(x/xa)
//     (round half to even, as jnp.round);
//   * packed uint8 [in/2, out]: byte [r, c] holds W[2r, c] in the lo nibble
//     and W[2r+1, c] in the hi nibble, two's-complement int4
//     (seedx_tpu/utils/quantize.py quantize_kernel_int4);
//   * scale fp32 [in/group, out];
//   * per group an exact int8 x int8 -> int32 dot, then
//     acc += float(dot) * scale[g]; finally y = acc * xa, cast to bf16.
//
// What bounds it on the H100: at decode (rows = 1, the 40-layer 13B GEMV)
// the int4 weight stream from HBM (~6.5 GB a token) -- 2 operations per
// byte, far below the ridge; at prefill (rows = 512) integer math.
// Design: the packed bytes are read once per row block, straight from HBM
// as 32-bit words (4 output columns, coalesced across the warp), and stay
// packed until registers.  Nibbles are sign-extended four at a time
// (__vsub4(((b & 0x0F0F0F0F) ^ 0x08080808), 0x08080808) for the lo nibbles,
// the same on b >> 4 for the hi ones, i.e. ((b & 0xF) ^ 8) - 8 and
// int8(b) >> 4), transposed with __byte_perm into 4-deep k vectors and
// fed to __dp4a; int32 dots are exact per group, and the fp32 group scale
// lands on the small per-thread accumulator.  A thread owns TM rows x 4
// columns, so each weight word serves TM rows.  When rows are few (decode)
// the group range is split across blocks (split-K) so the GEMV fills the
// 132 SMs; partial sums then reduce in a fixed order in a second pass (no
// atomics, deterministic).  Activation quantization is a one-block-per-row
// prologue.  No tensor-core (mma s8) path yet: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColsPerThread = 4;
constexpr int kColsPerBlock = kThreads * kColsPerThread;

__global__ void quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                     int8_t* __restrict__ x8,
                                     float* __restrict__ xa, int n_in) {
  __shared__ float warp_max[32];
  const int r = blockIdx.x;
  const __nv_bfloat16* xr = x + static_cast<long>(r) * n_in;
  float amax = 0.f;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int nw = blockDim.x >> 5;
    amax = threadIdx.x < nw ? warp_max[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (threadIdx.x == 0) warp_max[0] = amax;
  }
  __syncthreads();
  const float a = fmaxf(warp_max[0], 1e-8f) / 127.0f;
  if (threadIdx.x == 0) xa[r] = a;
  int8_t* qr = x8 + static_cast<long>(r) * n_in;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x)
    qr[i] = static_cast<int8_t>(rintf(__bfloat162float(xr[i]) / a));
}

__device__ __forceinline__ uint32_t sext_nibbles(uint32_t n) {
  // n holds four unsigned nibbles, one per byte -> four signed int8
  return __vsub4((n & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const int8_t* __restrict__ x8, const uint8_t* __restrict__ packed,
            const float* __restrict__ scale, const float* __restrict__ xa,
            __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
            int rows, int n_in, int n_out, int group, int groups_per_split,
            int n_groups) {
  const int c = (blockIdx.y * kThreads + threadIdx.x) * kColsPerThread;
  if (c >= n_out) return;
  const int r0 = blockIdx.x * TM;
  const int g0 = blockIdx.z * groups_per_split;
  const int g1 = min(n_groups, g0 + groups_per_split);

  const int8_t* xrow[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m)    // rows past the end re-read the last row
    xrow[m] = x8 + static_cast<long>(min(r0 + m, rows - 1)) * n_in;

  float facc[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m)
    facc[m][0] = facc[m][1] = facc[m][2] = facc[m][3] = 0.f;

  for (int gi = g0; gi < g1; ++gi) {
    int acc[TM][4];
#pragma unroll
    for (int m = 0; m < TM; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0;
    const int k0 = gi * group;
    for (int kq = k0; kq < k0 + group; kq += 4) {
      const uint8_t* pw = packed + static_cast<long>(kq >> 1) * n_out + c;
      const uint32_t u0 = *reinterpret_cast<const uint32_t*>(pw);
      const uint32_t u1 = *reinterpret_cast<const uint32_t*>(pw + n_out);
      // byte j of each word = column c + j
      const uint32_t w0 = sext_nibbles(u0);        // W[kq,   c..c+3]
      const uint32_t w1 = sext_nibbles(u0 >> 4);   // W[kq+1, c..c+3]
      const uint32_t w2 = sext_nibbles(u1);        // W[kq+2, c..c+3]
      const uint32_t w3 = sext_nibbles(u1 >> 4);   // W[kq+3, c..c+3]
      // transpose to one word per column: byte i = W[kq+i, column]
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
      const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
      const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
      const int col[4] = {static_cast<int>(__byte_perm(t0, t2, 0x5410)),
                          static_cast<int>(__byte_perm(t0, t2, 0x7632)),
                          static_cast<int>(__byte_perm(t1, t3, 0x5410)),
                          static_cast<int>(__byte_perm(t1, t3, 0x7632))};
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int xw = *reinterpret_cast<const int*>(xrow[m] + kq);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(xw, col[j], acc[m][j]);
      }
    }
    const float4 s = *reinterpret_cast<const float4*>(
        scale + static_cast<long>(gi) * n_out + c);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      facc[m][0] += static_cast<float>(acc[m][0]) * s.x;
      facc[m][1] += static_cast<float>(acc[m][1]) * s.y;
      facc[m][2] += static_cast<float>(acc[m][2]) * s.z;
      facc[m][3] += static_cast<float>(acc[m][3]) * s.w;
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + m;
    if (r >= rows) break;
    if (partial == nullptr) {
      const float a = xa[r];
      __nv_bfloat16* o = out + static_cast<long>(r) * n_out + c;
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __floats2bfloat162_rn(facc[m][0] * a, facc[m][1] * a);
      *reinterpret_cast<__nv_bfloat162*>(o + 2) =
          __floats2bfloat162_rn(facc[m][2] * a, facc[m][3] * a);
    } else {
      float* p = partial + (static_cast<long>(blockIdx.z) * rows + r) * n_out + c;
      *reinterpret_cast<float4*>(p) =
          make_float4(facc[m][0], facc[m][1], facc[m][2], facc[m][3]);
    }
  }
}

__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ xa,
                                     __nv_bfloat16* __restrict__ out, int rows,
                                     int n_out, int n_split) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long total = static_cast<long>(rows) * n_out;
  if (i >= total) return;
  float acc = 0.f;
  for (int s = 0; s < n_split; ++s) acc += partial[s * total + i];
  out[i] = __float2bfloat16_rn(acc * xa[i / n_out]);
}

}  // namespace

// x bf16 [rows, n_in]; packed uint8 [n_in/2, n_out]; scale f32
// [n_in/group, n_out]; out bf16 [rows, n_out].  Scratch from the caller:
// x8 int8 [rows, n_in], xa f32 [rows], partial f32 [n_split, rows, n_out]
// (unused when n_split == 1).  tm is 1 or 16 (rows per thread).
extern "C" int int4_w4a8_bf16(const void* x, const void* packed,
                              const void* scale, void* out, void* x8, void* xa,
                              void* partial, int rows, int n_in, int n_out,
                              int group, int groups_per_split, int n_split,
                              int tm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || n_out == 0) return 0;
  if (n_in % 4 || n_out % 4 || group % 4 || n_in % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = n_in / group;
  quantize_rows_kernel<<<rows, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x8),
      static_cast<float*>(xa), n_in);
  float* part = n_split > 1 ? static_cast<float*>(partial) : nullptr;
  dim3 grid((rows + tm - 1) / tm, (n_out + kColsPerBlock - 1) / kColsPerBlock,
            n_split);
  const int8_t* xq = static_cast<const int8_t*>(x8);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  const float* a = static_cast<const float*>(xa);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (tm == 1)
    w4a8_kernel<1><<<grid, kThreads, 0, s>>>(xq, pk, sc, a, o, part, rows,
                                             n_in, n_out, group,
                                             groups_per_split, n_groups);
  else if (tm == 16)
    w4a8_kernel<16><<<grid, kThreads, 0, s>>>(xq, pk, sc, a, o, part, rows,
                                              n_in, n_out, group,
                                              groups_per_split, n_groups);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (part != nullptr) {
    const long total = static_cast<long>(rows) * n_out;
    reduce_splits_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                           s>>>(part, a, o, rows, n_out, n_split);
  }
  return static_cast<int>(cudaGetLastError());
}
