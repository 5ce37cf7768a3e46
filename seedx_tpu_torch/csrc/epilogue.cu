// The SDXL UNet's Dense epilogues for Hopper: bias (with the int8 path's
// per-column scale) and residual in one pass, and bias + GEGLU gate in one
// pass, after the projection's GEMM (cuBLAS, as the JAX package leaves it
// to XLA).
//
// Replaces no Pallas kernel: XLA fuses these adds into the GEMM's
// neighbours.  The port's plain chain (ops/epilogue.py
// `bias_residual_plain`, `bias_geglu_plain`) runs each add, the GEGLU
// split, GELU and the gate's product as separate PyTorch elementwise
// kernels, a stride-0 bias and the chunk's strided halves sending most to
// the generic non-vectorized kernel: ~25% of a CFG UNet eval's device time
// on the H100 (the benchmark's breakdown of `sdxl_t2i_1024`).  These
// kernels compute the same contract, each operation in fp32 and rounded
// to the working type (bf16 or fp32) where the plain chain rounds:
//   * bias_residual: out = [residual +] (y [* scale] + bias), rounded after
//     the product, after the bias and after the residual: bit-equal to the
//     chain given the same y;
//   * bias_geglu over y [R, 2F]: h = y[:, :F] [* s] + b, g = y[:, F:] [* s]
//     + b (each rounded as above), out = h * gelu(g) with GELU's exact erf
//     form in fp32 as F.gelu writes it, rounded, and the product rounded.
//     GELU goes through the toolkit's erff, which may contract differently
//     from PyTorch's build: within one ULP of the chain.
//
// What bounds them on the H100: bytes, ~0.1 operation a byte against a
// ridge of ~295.  Each reads its inputs once and writes its output once
// (bias_residual 6 bytes an element in bf16 with a residual, bias_geglu 6
// bytes an output element), with 16-byte loads and stores, neighbouring
// threads on neighbouring vectors of a row.  A block owns a strip of
// `blockDim.x` vectors of the columns and walks rows `blockDim.y` at a
// time, grid-strided over `gridDim.y` row blocks, two rows' loads in
// flight a thread (four spill bias_geglu's registers at the 64 a thread
// that `kMinBlocks` allows); its bias (and scale) slice sits in registers, read
// once, packed.  y and the residual are read once, so they stream (`__ldcs`); the
// output is left to the cache, since the next kernel reads it.  The
// launch (ops/epilogue.py `ep_plan`) is one wave of a few blocks an SM,
// all resident at once (`kMinBlocks`).  No shared memory,
// no atomics: a replay gives the same bits.
// No backward here: ops/epilogue.py wraps each kernel in an autograd
// function whose backward is the closed-form gradient in plain torch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int kUnroll = 2;       // rows a thread loads at once
constexpr int kMaxThreads = 256;
// blocks an SM holds at once, at most 64 registers a thread: the grid
// (ep_plan's EP_FILL) is then one resident wave, with no tail of blocks
constexpr int kMinBlocks = 4;

// F.gelu (approximate="none") as PyTorch's CUDA kernel writes it, in fp32
__device__ __forceinline__ float gelu(float x) {
  constexpr float kAlpha = 0.70710678118654752440f;
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

// y [* scale] + bias, rounded after each step as the plain chain's
template <typename T, bool SCALE>
__device__ __forceinline__ float biased(float y, float s, float b) {
  if (SCALE) y = Vec<T>::round(__fmul_rn(y, s));
  return Vec<T>::round(__fadd_rn(y, b));
}

// vector v of a bias or scale, kept packed in registers (4 where 8 floats
// would take 8) and unpacked where used
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, long v) {
  return p ? __ldg(reinterpret_cast<const uint4*>(p) + v) : make_uint4(0, 0, 0, 0);
}

template <typename T, bool SCALE, bool RES>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    bias_residual_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                         const T* __restrict__ scale,
                         const T* __restrict__ res, T* __restrict__ out,
                         int rows, int nvec) {
  constexpr int N = Vec<T>::kN;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const uint4 b4 = load_vec(bias, v), s4 = load_vec(scale, v);
  const uint4* y4 = reinterpret_cast<const uint4*>(y);
  const uint4* r4 = reinterpret_cast<const uint4*>(res);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int stride = gridDim.y * blockDim.y;
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows;
       r += kUnroll * stride) {
    uint4 ry[kUnroll], rr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long at = static_cast<long>(r + u * stride) * nvec + v;
      if (r + u * stride < rows) {
        ry[u] = __ldcs(y4 + at);
        if (RES) rr[u] = __ldcs(r4 + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * stride >= rows) continue;
      float f[N], q[N], b[N], s[N];
      Vec<T>::unpack(ry[u], f);
      if (RES) Vec<T>::unpack(rr[u], q);
      Vec<T>::unpack(b4, b);
      Vec<T>::unpack(s4, s);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        f[k] = biased<T, SCALE>(f[k], s[k], b[k]);
        if (RES) f[k] = Vec<T>::round(__fadd_rn(q[k], f[k]));
      }
      o4[static_cast<long>(r + u * stride) * nvec + v] = Vec<T>::pack(f);
    }
  }
}

// y [rows][2 * nvec vectors]: the value half, then the gate half; out
// [rows][nvec vectors]
template <typename T, bool SCALE>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    bias_geglu_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                      const T* __restrict__ scale, T* __restrict__ out,
                      int rows, int nvec) {
  constexpr int N = Vec<T>::kN;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const uint4 bh4 = load_vec(bias, v), bg4 = load_vec(bias, nvec + v);
  const uint4 sh4 = load_vec(scale, v), sg4 = load_vec(scale, nvec + v);
  const uint4* y4 = reinterpret_cast<const uint4*>(y);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int stride = gridDim.y * blockDim.y;
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows;
       r += kUnroll * stride) {
    uint4 rh[kUnroll], rg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long at = static_cast<long>(r + u * stride) * 2 * nvec + v;
      if (r + u * stride < rows) {
        rh[u] = __ldcs(y4 + at);
        rg[u] = __ldcs(y4 + at + nvec);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * stride >= rows) continue;
      float h[N], g[N], bh[N], bg[N], sh[N], sg[N];
      Vec<T>::unpack(rh[u], h);
      Vec<T>::unpack(rg[u], g);
      Vec<T>::unpack(bh4, bh);
      Vec<T>::unpack(bg4, bg);
      Vec<T>::unpack(sh4, sh);
      Vec<T>::unpack(sg4, sg);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float hv = biased<T, SCALE>(h[k], sh[k], bh[k]);
        const float gv = Vec<T>::round(gelu(biased<T, SCALE>(g[k], sg[k],
                                                              bg[k])));
        h[k] = Vec<T>::round(__fmul_rn(hv, gv));
      }
      o4[static_cast<long>(r + u * stride) * nvec + v] = Vec<T>::pack(h);
    }
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

bool valid(int rows, int nvec, int tx, int ty, int row_blocks) {
  return rows > 0 && nvec > 0 && tx > 0 && ty > 0 && row_blocks > 0 &&
         row_blocks <= 65535 && tx * ty <= kMaxThreads;
}

}  // namespace

// dtype: 0 bf16, 1 fp32.  y, residual, out [rows][nvec 16-byte vectors]
// contiguous; bias, scale [nvec vectors]; every pointer 16-byte aligned;
// scale and residual may be null (not applied).  Block (tx, ty), grid
// (ceil(nvec / tx), row_blocks): ops/epilogue.py `ep_plan`.
extern "C" int bias_residual(const void* y, const void* bias,
                             const void* scale, const void* residual,
                             void* out, int rows, int nvec, int tx, int ty,
                             int row_blocks, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || !valid(rows, nvec, tx, ty, row_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nvec + tx - 1) / tx, row_blocks), block(tx, ty);
#define SEEDX_BR(T, S, R)                                                  \
  bias_residual_kernel<T, S, R><<<grid, block, 0, st>>>(                   \
      static_cast<const T*>(y), static_cast<const T*>(bias),               \
      static_cast<const T*>(scale), static_cast<const T*>(residual),       \
      static_cast<T*>(out), rows, nvec)
#define SEEDX_BR_T(T)                                                      \
  if (scale && residual) SEEDX_BR(T, true, true);                          \
  else if (scale) SEEDX_BR(T, true, false);                                \
  else if (residual) SEEDX_BR(T, false, true);                             \
  else SEEDX_BR(T, false, false)
  if (dtype == 0) {
    SEEDX_BR_T(__nv_bfloat16);
  } else {
    SEEDX_BR_T(float);
  }
#undef SEEDX_BR_T
#undef SEEDX_BR
  return status();
}

// y [rows][2 * nvec vectors] (value half, gate half), bias and scale [2 *
// nvec vectors] (scale may be null), out [rows][nvec vectors]; the rest as
// bias_residual.
extern "C" int bias_geglu(const void* y, const void* bias, const void* scale,
                          void* out, int rows, int nvec, int tx, int ty,
                          int row_blocks, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || !valid(rows, nvec, tx, ty, row_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nvec + tx - 1) / tx, row_blocks), block(tx, ty);
#define SEEDX_GG(T, S)                                                     \
  bias_geglu_kernel<T, S><<<grid, block, 0, st>>>(                         \
      static_cast<const T*>(y), static_cast<const T*>(bias),               \
      static_cast<const T*>(scale), static_cast<T*>(out), rows, nvec)
  if (dtype == 0) {
    if (scale) SEEDX_GG(__nv_bfloat16, true);
    else SEEDX_GG(__nv_bfloat16, false);
  } else {
    if (scale) SEEDX_GG(float, true);
    else SEEDX_GG(float, false);
  }
#undef SEEDX_GG
  return status();
}
