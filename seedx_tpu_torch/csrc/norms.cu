// GroupNorm (+ SiLU) and LayerNorm for Hopper: the SDXL UNet's and VAE's
// normalisations in one pass over the activations each.
//
// Replaces no Pallas kernel: the JAX package leaves these norms to XLA,
// which fuses them.  The port's plain versions (ops/norms.py
// `group_norm_fp32_stats`, `layer_norm_fp32_stats`) run as chains of
// separate fp32 elementwise kernels, about 60 bytes of traffic an element,
// and filled ~37% of a CFG UNet eval's device time on the H100 (the
// benchmark's breakdown of `sdxl_t2i_1024`).  These kernels compute the
// same contract:
//   * fp32 sums of x and of x * x (each product rounded to fp32), the mean
//     and E[x^2] as the sums times 1 / count, var = E[x^2] - mean^2;
//   * ((x - mean) * rsqrt(var + eps)) * scale + bias in fp32 (no fused
//     multiply-adds, as the plain chain's separate kernels), rounded once
//     to x's type (bf16 or fp32);
//   * GroupNorm's optional SiLU on the rounded value in fp32, z / (1 +
//     exp(-z)), rounded again: what F.silu does to the plain output.
// Only the order of the sums differs from the plain chain.
//
// What bounds them on the H100: bytes.  A few operations an element
// against ~295 a byte at the ridge.  The design moves each byte the fewest
// times and keeps no fp32 intermediate in device memory: LayerNorm reads a
// row once and writes it once (4 bytes an element in bf16); GroupNorm's
// statistics span a whole image, so it reads x twice and writes once (6).
//
// * LayerNorm (`ln_rows`): one warp a row, 16-byte loads, the row kept in
//   registers between its sums and its output; the sums by butterfly
//   shuffles (every lane ends with the same bits), one 16-byte store a
//   vector.  One launch.
// * GroupNorm over channels-last [B, P, C], G groups of C / G channels
//   (C / G need not be a multiple of the 8 channels a 16-byte vector
//   holds):
//   (a) `gn_stats`: a block takes a run of `chunk` positions of one batch
//       row.  Its threads tile [R positions x C channels] with 16-byte
//       vectors, each thread holding the same channels for every
//       position, so it sums per channel in registers, 4 positions' loads
//       in flight.  The block adds its threads' per-channel sums in
//       shared memory, then per group, in a fixed order, and writes one
//       fp32 partial (sum, sum of squares) per (batch, block, group).
//   (b) `gn_finalize`: one warp a (sum, batch, group) adds the partials of
//       every block, strided over the lanes then a butterfly: [2, B, G].
//       No float atomics anywhere: a replay gives the same bits.
//   Between (b) and (c) the caller may all-reduce the sums over ranks that
//   hold the other row blocks of a split image; the count then covers
//   them too.
//   (c) `gn_apply`: the same tiling; each thread turns its channels'
//       group sums into mean and rsqrt once, then normalises, applies the
//       affine, rounds, optionally applies SiLU and stores, 4 positions'
//       loads in flight.
// No backward here: ops/norms.py wraps each kernel in an autograd function
// that saves x (and GroupNorm's [2, B, G] sums) and takes the closed-form
// gradient in plain torch, so adapter training runs these forwards too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int kUnroll = 4;          // positions a GroupNorm thread loads at once
constexpr int kMaxThreads = 256;    // a GroupNorm block
constexpr int kLnWarps = 4;         // rows a LayerNorm block

// ((x - mean) * rstd) * scale + bias, each step rounded as the plain chain's
__device__ __forceinline__ float affine(float x, float mean, float rstd,
                                        float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), scale),
                   bias);
}

__device__ __forceinline__ float silu(float z) {
  return z / (1.0f + expf(-z));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// one GroupNorm launch's tiling (ops/norms.py `gn_plan`)
struct GnShape {
  int batch, positions, channels, groups;
  int tpr;     // threads across a position's channels (blockDim = R * tpr)
  int rows;    // R: positions a block covers at once
  int chunk;   // positions a block (a multiple of R)
  int splits;  // blocks a batch row
};

template <typename T, int S>
__global__ void __launch_bounds__(kMaxThreads)
    gn_stats(const T* __restrict__ x, float* __restrict__ part, GnShape sh) {
  constexpr int N = Vec<T>::kN;
  extern __shared__ float red[];    // [2][R][C]: per-channel sums, squares
  const int C = sh.channels, nvec = C / N, R = sh.rows;
  const int b = blockIdx.y, split = blockIdx.x;
  const int t = threadIdx.x, r = t / sh.tpr, lane = t % sh.tpr;
  const int p0 = split * sh.chunk;
  const int p1 = min(p0 + sh.chunk, sh.positions);
  const T* xb = x + static_cast<long>(b) * sh.positions * C;

  float s1[S][N], s2[S][N];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int k = 0; k < N; ++k) s1[s][k] = s2[s][k] = 0.f;

  for (int p = p0 + r; p < p1; p += R * kUnroll) {
    uint4 raw[kUnroll][S];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int pp = p + u * R, v = lane + s * sh.tpr;
        if (pp < p1 && v < nvec)
          raw[u][s] = *reinterpret_cast<const uint4*>(
              xb + static_cast<long>(pp) * C + v * N);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (p + u * R >= p1 || lane + s * sh.tpr >= nvec) continue;
        float f[N];
        Vec<T>::unpack(raw[u][s], f);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          s1[s][k] = __fadd_rn(s1[s][k], f[k]);
          s2[s][k] = __fadd_rn(s2[s][k], __fmul_rn(f[k], f[k]));
        }
      }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int v = lane + s * sh.tpr;
    if (v >= nvec) continue;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      red[r * C + v * N + k] = s1[s][k];
      red[(R + r) * C + v * N + k] = s2[s][k];
    }
  }
  __syncthreads();
  // each channel over the block's R position rows, into row 0
  for (int c = t; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      a += red[rr * C + c];
      q += red[(R + rr) * C + c];
    }
    red[c] = a;
    red[R * C + c] = q;
  }
  __syncthreads();
  const int cpg = C / sh.groups;
  for (int g = t; g < sh.groups; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int j = 0; j < cpg; ++j) {
      a += red[g * cpg + j];
      q += red[R * C + g * cpg + j];
    }
    float* o = part + ((static_cast<long>(b) * sh.splits + split) *
                           sh.groups + g) * 2;
    o[0] = a;
    o[1] = q;
  }
}

// sums [2][B][G] from part [B][splits][G][2], one warp a sum
__global__ void gn_finalize(const float* __restrict__ part,
                            float* __restrict__ sums, int batch, int groups,
                            int splits) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= 2 * batch * groups) return;
  const int j = w / (batch * groups), bg = w % (batch * groups);
  const int b = bg / groups, g = bg % groups;
  const float* src = part + (static_cast<long>(b) * splits * groups + g) * 2 + j;
  float a = 0.f;
#pragma unroll 4
  for (int k = lane; k < splits; k += 32) a += src[static_cast<long>(k) * groups * 2];
  a = warp_sum(a);
  if (lane == 0) sums[w] = a;
}

template <typename T, int S, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
    gn_apply(const T* __restrict__ x, T* __restrict__ y,
             const float* __restrict__ sums, const float* __restrict__ scale,
             const float* __restrict__ bias, GnShape sh, int count,
             float eps) {
  constexpr int N = Vec<T>::kN;
  const int C = sh.channels, nvec = C / N, R = sh.rows;
  const int b = blockIdx.y, split = blockIdx.x;
  const int t = threadIdx.x, r = t / sh.tpr, lane = t % sh.tpr;
  const int p0 = split * sh.chunk;
  const int p1 = min(p0 + sh.chunk, sh.positions);
  const long base = static_cast<long>(b) * sh.positions * C;
  const int cpg = C / sh.groups, bg = sh.batch * sh.groups;
  // 1 / count as the plain chain's division by a scalar computes it
  const float inv = 1.0f / static_cast<float>(count);

  float mean[S][N], rstd[S][N], sc[S][N], bi[S][N];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int v = lane + s * sh.tpr;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int c = v < nvec ? v * N + k : 0;
      const int g = c / cpg;
      const float m = __fmul_rn(sums[b * sh.groups + g], inv);
      const float e2 = __fmul_rn(sums[bg + b * sh.groups + g], inv);
      mean[s][k] = m;
      rstd[s][k] = rsqrtf(__fadd_rn(__fsub_rn(e2, __fmul_rn(m, m)), eps));
      sc[s][k] = scale[c];
      bi[s][k] = bias[c];
    }
  }

  for (int p = p0 + r; p < p1; p += R * kUnroll) {
    uint4 raw[kUnroll][S];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int pp = p + u * R, v = lane + s * sh.tpr;
        if (pp < p1 && v < nvec)
          raw[u][s] = *reinterpret_cast<const uint4*>(
              x + base + static_cast<long>(pp) * C + v * N);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int pp = p + u * R, v = lane + s * sh.tpr;
        if (pp >= p1 || v >= nvec) continue;
        float f[N];
        Vec<T>::unpack(raw[u][s], f);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float o = Vec<T>::round(
              affine(f[k], mean[s][k], rstd[s][k], sc[s][k], bi[s][k]));
          if (SILU) o = silu(o);
          f[k] = o;
        }
        *reinterpret_cast<uint4*>(y + base + static_cast<long>(pp) * C +
                                  v * N) = Vec<T>::pack(f);
      }
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_rows(const T* __restrict__ x, T* __restrict__ y,
            const float* __restrict__ scale, const float* __restrict__ bias,
            int rows, int C, float eps) {
  constexpr int N = Vec<T>::kN;
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, nvec = C / N;
  if (row >= rows) return;
  const T* xr = x + static_cast<long>(row) * C;
  uint4 raw[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int v = lane + 32 * l;
    if (v < nvec) raw[l] = *reinterpret_cast<const uint4*>(xr + v * N);
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (lane + 32 * l >= nvec) continue;
    float f[N];
    Vec<T>::unpack(raw[l], f);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s1 = __fadd_rn(s1, f[k]);
      s2 = __fadd_rn(s2, __fmul_rn(f[k], f[k]));
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  // torch.mean's factor: 1 / C in fp32
  const float inv = 1.0f / static_cast<float>(C);
  const float mean = __fmul_rn(s1, inv);
  const float var = __fsub_rn(__fmul_rn(s2, inv), __fmul_rn(mean, mean));
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  T* yr = y + static_cast<long>(row) * C;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int v = lane + 32 * l;
    if (v >= nvec) continue;
    float f[N], sc[N], bi[N];
    Vec<T>::unpack(raw[l], f);
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      *reinterpret_cast<float4*>(sc + k) =
          __ldg(reinterpret_cast<const float4*>(scale + v * N + k));
      *reinterpret_cast<float4*>(bi + k) =
          __ldg(reinterpret_cast<const float4*>(bias + v * N + k));
    }
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = affine(f[k], mean, rstd, sc[k], bi[k]);
    *reinterpret_cast<uint4*>(yr + v * N) = Vec<T>::pack(f);
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

template <typename T, int S>
int gn_stats_launch(const void* x, void* part, void* sums, const GnShape& sh,
                    cudaStream_t st) {
  const dim3 grid(sh.splits, sh.batch);
  const size_t smem = 2ul * sh.rows * sh.channels * sizeof(float);
  gn_stats<T, S><<<grid, sh.rows * sh.tpr, smem, st>>>(
      static_cast<const T*>(x), static_cast<float*>(part), sh);
  int e = status();
  if (e) return e;
  const int warps = 2 * sh.batch * sh.groups;
  gn_finalize<<<(warps + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(sums), sh.batch,
      sh.groups, sh.splits);
  return status();
}

template <typename T, int S>
int gn_apply_launch(const void* x, void* y, const void* sums,
                    const void* scale, const void* bias, const GnShape& sh,
                    int count, float eps, int silu_on, cudaStream_t st) {
  const dim3 grid(sh.splits, sh.batch);
  const int threads = sh.rows * sh.tpr;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float* su = static_cast<const float*>(sums);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (silu_on)
    gn_apply<T, S, true><<<grid, threads, 0, st>>>(xt, yt, su, sc, bi, sh,
                                                  count, eps);
  else
    gn_apply<T, S, false><<<grid, threads, 0, st>>>(xt, yt, su, sc, bi, sh,
                                                   count, eps);
  return status();
}

bool valid(const GnShape& sh, int slots, int itemsize) {
  const int n = 16 / itemsize;
  const int nvec = sh.channels / n;
  return sh.batch > 0 && sh.positions > 0 && sh.groups > 0 &&
         sh.channels % n == 0 && sh.channels % sh.groups == 0 &&
         sh.rows >= 1 && sh.tpr >= 1 && sh.rows * sh.tpr <= kMaxThreads &&
         sh.tpr * slots >= nvec && sh.chunk % sh.rows == 0 &&
         static_cast<long>(sh.chunk) * sh.splits >= sh.positions &&
         2l * sh.rows * sh.channels * 4 <= 48 * 1024;
}

GnShape gn_shape(int batch, int positions, int channels, int groups, int tpr,
                 int rows, int chunk, int splits) {
  GnShape sh;
  sh.batch = batch;
  sh.positions = positions;
  sh.channels = channels;
  sh.groups = groups;
  sh.tpr = tpr;
  sh.rows = rows;
  sh.chunk = chunk;
  sh.splits = splits;
  return sh;
}

}  // namespace

// dtype: 0 bf16, 1 fp32.  x [batch][positions][channels] contiguous, 16-byte
// aligned; part: fp32 scratch [batch][splits][groups][2]; sums: fp32
// [2][batch][groups] out (sums of x, of x * x).  slots: 16-byte vectors a
// thread covers along the channels (1, 2 or 4); tpr, rows, chunk, splits:
// ops/norms.py `gn_plan`.
extern "C" int group_norm_stats(const void* x, void* part, void* sums,
                                int batch, int positions, int channels,
                                int groups, int slots, int tpr, int rows,
                                int chunk, int splits, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GnShape sh = gn_shape(batch, positions, channels, groups, tpr, rows,
                              chunk, splits);
  const int item = dtype == 0 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || !valid(sh, slots, item))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (slots == 1) return gn_stats_launch<__nv_bfloat16, 1>(x, part, sums, sh, st);
    if (slots == 2) return gn_stats_launch<__nv_bfloat16, 2>(x, part, sums, sh, st);
    if (slots == 4) return gn_stats_launch<__nv_bfloat16, 4>(x, part, sums, sh, st);
  } else {
    if (slots == 1) return gn_stats_launch<float, 1>(x, part, sums, sh, st);
    if (slots == 2) return gn_stats_launch<float, 2>(x, part, sums, sh, st);
    if (slots == 4) return gn_stats_launch<float, 4>(x, part, sums, sh, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// y = GroupNorm(x) from sums [2][batch][groups] over `count` elements a
// group (positions * channels / groups, times the ranks of a split);
// scale, bias fp32 [channels]; silu: 1 applies SiLU to the rounded output.
extern "C" int group_norm_apply(const void* x, void* y, const void* sums,
                                const void* scale, const void* bias,
                                int batch, int positions, int channels,
                                int groups, int slots, int tpr, int rows,
                                int chunk, int splits, int count, float eps,
                                int silu, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GnShape sh = gn_shape(batch, positions, channels, groups, tpr, rows,
                              chunk, splits);
  const int item = dtype == 0 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || !valid(sh, slots, item) || count <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (slots == 1) return gn_apply_launch<__nv_bfloat16, 1>(x, y, sums, scale, bias, sh, count, eps, silu, st);
    if (slots == 2) return gn_apply_launch<__nv_bfloat16, 2>(x, y, sums, scale, bias, sh, count, eps, silu, st);
    if (slots == 4) return gn_apply_launch<__nv_bfloat16, 4>(x, y, sums, scale, bias, sh, count, eps, silu, st);
  } else {
    if (slots == 1) return gn_apply_launch<float, 1>(x, y, sums, scale, bias, sh, count, eps, silu, st);
    if (slots == 2) return gn_apply_launch<float, 2>(x, y, sums, scale, bias, sh, count, eps, silu, st);
    if (slots == 4) return gn_apply_launch<float, 4>(x, y, sums, scale, bias, sh, count, eps, silu, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// y = LayerNorm(x) over the last dim: x, y [rows][channels] contiguous,
// 16-byte aligned; scale, bias fp32 [channels], 16-byte aligned.  Up to 16
// vectors a lane: 4096 bf16 or 2048 fp32 channels.
extern "C" int layer_norm_rows(const void* x, void* y, const void* scale,
                               const void* bias, int rows, int channels,
                               float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = dtype == 0 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || channels % n || channels <= 0 ||
      rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = (channels / n + 31) / 32;
  const int grid = (rows + kLnWarps - 1) / kLnWarps;
  const int threads = kLnWarps * 32;
#define SEEDX_LN(T, L)                                                     \
  ln_rows<T, L><<<grid, threads, 0, st>>>(                                 \
      static_cast<const T*>(x), static_cast<T*>(y),                        \
      static_cast<const float*>(scale), static_cast<const float*>(bias),   \
      rows, channels, eps)
  if (dtype == 0) {
    if (lanes <= 1) SEEDX_LN(__nv_bfloat16, 1);
    else if (lanes <= 2) SEEDX_LN(__nv_bfloat16, 2);
    else if (lanes <= 4) SEEDX_LN(__nv_bfloat16, 4);
    else if (lanes <= 8) SEEDX_LN(__nv_bfloat16, 8);
    else if (lanes <= 16) SEEDX_LN(__nv_bfloat16, 16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (lanes <= 1) SEEDX_LN(float, 1);
    else if (lanes <= 2) SEEDX_LN(float, 2);
    else if (lanes <= 4) SEEDX_LN(float, 4);
    else if (lanes <= 8) SEEDX_LN(float, 8);
    else if (lanes <= 16) SEEDX_LN(float, 16);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SEEDX_LN
  return status();
}
