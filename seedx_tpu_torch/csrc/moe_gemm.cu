// K6: the sparse-expert layer's grouped GEMM for Hopper (sm_90a), bf16 in,
// fp32 accumulation on the tensor cores (mma.sync m16n8k16).
//
// Replaces no Pallas kernel: the JAX package has no sparse experts.  The
// expert layer (ops/moe.py) routes every token to its top-k experts, sorts
// the T * k (token, expert) rows by expert and hands this kernel the rows
// gathered in that order, x [R, K], with `offsets` [E + 1] (int32, on the
// device: expert e owns rows [offsets[e], offsets[e + 1])).  The kernel
// computes, for every row r of expert e,
//   plain:  y[r, :] = x[r, :] @ W[e]                    (fp32 out, [R, N])
//   gated:  y[r, :] = silu(x[r, :] @ G[e]) * (x[r, :] @ U[e])   (bf16 out)
//   relu2:  y[r, :] = relu(x[r, :] @ W[e])^2                    (bf16 out)
// with W, G, U [E, K, N] in the repo's [in, out] layout (N contiguous).
// The gated form is the experts' gate and up projections with the SwiGLU
// product as the epilogue, so the [R, 2N] pair never reaches memory; the
// relu2 form is the ungated up projection of Nemotron-H's experts with the
// squared ReLU as the epilogue.
//
// What bounds it: in decode, bytes.  At 32 slots a step routes 192 rows
// over ~61 of 64 experts, 1-8 rows each, so every active expert's weights
// are streamed once for a handful of rows (~17 MB an expert); in prefill
// hundreds of rows an expert make it tensor-core work.  So three tiles:
//   * small (decode): 16 rows x 64 columns, 4 warps side by side over the
//     columns, a 4-stage cp.async pipeline of 64-deep K slices: a block
//     streams one expert's [K, 64] weight slice once for up to 16 rows;
//   * medium / large (prefill): 64 or 128 rows x 128 columns, 8 warps
//     (2 x 4), 3 stages.
// Grid: (ceil(N / BN) column tiles, E experts, Z row-tile groups); block
// (n, e, z) takes its expert's row tiles z, z + Z, ...  N is a multiple of
// 64, not always of BN (Nemotron-H's 1856 = 14.5 x 128): the last column
// tile's missing columns are zero-filled and never stored.  A block whose expert has no
// rows returns before it reads any weight: an expert that no token chose
// costs one read of two offsets a block.  Rows past offsets[E] (a padded
// batch's pad tokens, which the caller routes to no expert) are neither
// read nor written.  Every other output element is written
// by one block, in one fixed order of products: no float atomics, and a
// rerun gives the same bits.  The one atomic is an integer count: with
// `active` given, block (0, e, 0) of an expert that has rows adds 1 to it
// (the engine's count of expert activations, read by the benchmark).
//
// Shared memory: each stage holds the A tile [BM][64] (128-byte rows) and
// one or two B tiles [64][BN], 16-byte chunks XOR-swizzled by the row's low
// three bits so that ldmatrix reads them without bank conflicts.  A
// fragments come by ldmatrix.x4, B fragments by ldmatrix.x4.trans (the
// weights are K x N with N contiguous: the transpose gives each thread the
// k pairs mma.sync's "col" operand wants).  Rows past the expert's end are
// zero-filled (cp.async with a source size of 0) and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;   // K a pipeline stage

enum Epilogue { kPlain = 0, kGated = 1, kRelu2 = 2 };

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int EPI_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int EPI = EPI_;
  static constexpr bool GATED = EPI == kGated;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int TM = BM / WM, TN = BN / WN;   // a warp's rows, cols
  static constexpr int MI = TM / 16, NI = TN / 8;    // its mma tiles
  static constexpr int NB = GATED ? 2 : 1;           // weight matrices
  static constexpr int A_BYTES = BM * kBK * 2;
  static constexpr int B_BYTES = kBK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(TM % 16 == 0 && TN % 16 == 0, "warp tile");
  static_assert((BM * 8) % THREADS == 0, "A chunks");
  static_assert((kBK * BN / 8) % THREADS == 0, "B chunks");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst; bytes = 0 zero-fills and reads nothing
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk c of row r in an A tile (8 chunks a row)
__device__ __forceinline__ uint32_t a_off(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// byte offset of chunk c of row k in a B tile of BN columns
template <int BN>
__device__ __forceinline__ uint32_t b_off(int k, int c) {
  return k * (BN * 2) + (((c & ~7) | ((c & 7) ^ (k & 7))) << 4);
}

template <class T>
__device__ __forceinline__ void load_stage(
    uint32_t stage, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ w2,
    int row0, int rows, int K, int N, int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < T::BM * 8 / T::THREADS; ++i) {
    const int ch = tid + i * T::THREADS;
    const int r = ch >> 3, c = ch & 7;
    const bool ok = r < rows;
    const __nv_bfloat16* src = x + (size_t)(row0 + (ok ? r : 0)) * K + k0 +
                               c * 8;
    cp16(stage + a_off(r, c), src, ok ? 16 : 0);
  }
  constexpr int CPR = T::BN / 8;   // chunks a B row
#pragma unroll
  for (int i = 0; i < kBK * CPR / T::THREADS; ++i) {
    const int ch = tid + i * T::THREADS;
    const int k = ch / CPR, c = ch % CPR;
    const bool in = n0 + c * 8 < N;    // the ragged last column tile
    const size_t g = (size_t)(k0 + k) * N + (in ? n0 + c * 8 : 0);
    cp16(stage + T::A_BYTES + b_off<T::BN>(k, c), w + g, in ? 16 : 0);
    if (T::GATED)
      cp16(stage + T::A_BYTES + T::B_BYTES + b_off<T::BN>(k, c), w2 + g,
           in ? 16 : 0);
  }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS)
    moe_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w_all,
                    const __nv_bfloat16* __restrict__ w2_all,
                    const int* __restrict__ offsets, void* __restrict__ out,
                    unsigned long long* __restrict__ active, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = blockIdx.y;
  const int start = offsets[e];
  const int count = offsets[e + 1] - start;
  if (count <= 0) return;                 // no rows: no weight read
  if (active != nullptr && blockIdx.x == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0)
    atomicAdd(active, 1ULL);
  const int m_tiles = (count + T::BM - 1) / T::BM;
  if ((int)blockIdx.z >= m_tiles) return;

  const size_t wstride = (size_t)K * N;
  const __nv_bfloat16* w = w_all + e * wstride;
  const __nv_bfloat16* w2 = T::GATED ? w2_all + e * wstride : nullptr;
  const int n0 = blockIdx.x * T::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const uint32_t base = smem_addr(smem);
  const int k_tiles = K / kBK;

  for (int mt = blockIdx.z; mt < m_tiles; mt += gridDim.z) {
    const int row0 = start + mt * T::BM;
    const int rows = min(T::BM, count - mt * T::BM);
    float acc[T::NB][T::MI][T::NI][4];
#pragma unroll
    for (int b = 0; b < T::NB; ++b)
#pragma unroll
      for (int i = 0; i < T::MI; ++i)
#pragma unroll
        for (int j = 0; j < T::NI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[b][i][j][q] = 0.f;

#pragma unroll
    for (int s = 0; s < T::STAGES - 1; ++s) {
      if (s < k_tiles)
        load_stage<T>(base + s * T::STAGE_BYTES, x, w, w2, row0, rows, K, N,
                      n0, s * kBK);
      cp_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      cp_wait<T::STAGES - 2>();
      __syncthreads();
      const int nk = kt + T::STAGES - 1;
      if (nk < k_tiles)
        load_stage<T>(base + (nk % T::STAGES) * T::STAGE_BYTES, x, w, w2,
                      row0, rows, K, N, n0, nk * kBK);
      cp_commit();
      const uint32_t sa = base + (kt % T::STAGES) * T::STAGE_BYTES;
      const uint32_t sb = sa + T::A_BYTES;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[T::MI][4];
#pragma unroll
        for (int i = 0; i < T::MI; ++i) {
          const int r = wm * T::TM + i * 16 + (lane & 15);
          ldsm_x4(a[i], sa + a_off(r, kk * 2 + (lane >> 4)));
        }
#pragma unroll
        for (int b = 0; b < T::NB; ++b) {
#pragma unroll
          for (int j = 0; j < T::NI; j += 2) {
            uint32_t f[4];
            const int k = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int c = (wn * T::TN + j * 8) / 8 + (lane >> 4);
            ldsm_x4_t(f, sb + b * T::B_BYTES + b_off<T::BN>(k, c));
#pragma unroll
            for (int i = 0; i < T::MI; ++i) {
              mma16816(acc[b][i][j], a[i], f[0], f[1]);
              mma16816(acc[b][i][j + 1], a[i], f[2], f[3]);
            }
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();   // the next row tile's loads overwrite every stage

#pragma unroll
    for (int i = 0; i < T::MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * T::TM + i * 16 + (lane >> 2) + h * 8;
        if (r >= rows) continue;
        const size_t orow = (size_t)(row0 + r) * N;
#pragma unroll
        for (int j = 0; j < T::NI; ++j) {
          const int col = n0 + wn * T::TN + j * 8 + (lane & 3) * 2;
          if (col >= N) continue;
          const float v0 = acc[0][i][j][h * 2], v1 = acc[0][i][j][h * 2 + 1];
          if (T::EPI == kRelu2) {
            const float r0 = fmaxf(v0, 0.f), r1 = fmaxf(v1, 0.f);
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(out) + orow + col) =
                __floats2bfloat162_rn(r0 * r0, r1 * r1);
          } else if (T::GATED) {
            const float u0 = acc[T::NB - 1][i][j][h * 2];
            const float u1 = acc[T::NB - 1][i][j][h * 2 + 1];
            const float s0 = v0 / (1.f + __expf(-v0));
            const float s1 = v1 / (1.f + __expf(-v1));
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(out) + orow + col) =
                __floats2bfloat162_rn(s0 * u0, s1 * u1);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + orow +
                                       col) = make_float2(v0, v1);
          }
        }
      }
    }
  }
}

template <class T>
int launch(const void* x, const void* w, const void* w2, const void* offsets,
           void* out, void* active, int K, int N, int E, int zsplit,
           cudaStream_t st) {
  if (N % 64 || K % kBK) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  dim3 grid((N + T::BN - 1) / T::BN, E, zsplit);
  moe_gemm_kernel<T><<<grid, T::THREADS, T::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const int*>(offsets), out,
      static_cast<unsigned long long*>(active), K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int dispatch(int tile, const void* x, const void* w, const void* w2,
             const void* offsets, void* out, void* active, int K, int N,
             int E, int zsplit, cudaStream_t st) {
  switch (tile) {
    case 16:
      return launch<Tile<16, 64, 1, 4, 4, G>>(x, w, w2, offsets, out, active,
                                              K, N, E, zsplit, st);
    case 64:
      return launch<Tile<64, 128, 2, 4, 3, G>>(x, w, w2, offsets, out,
                                               active, K, N, E, zsplit, st);
    case 128:
      return launch<Tile<128, 128, 2, 4, 3, G>>(x, w, w2, offsets, out,
                                                active, K, N, E, zsplit, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x bf16 [R][K] (rows sorted by expert), w (and, gated, w2) bf16 [E][K][N],
// offsets int32 [E + 1]; epi: the epilogue (0 plain: fp32 out [R][N]; 1
// gated: bf16 silu(x w) * (x w2), w2 given; 2 relu2: bf16 relu(x w)^2);
// active: an int64 count or null.  tile: the row tile (16, 64 or 128);
// zsplit: row-tile groups an expert.  Every pointer 16-byte aligned.
extern "C" int moe_gemm_bf16(const void* x, const void* w, const void* w2,
                             const void* offsets, void* out, void* active,
                             int R, int K, int N, int E, int epi, int tile,
                             int zsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || E <= 0 || zsplit <= 0 || zsplit > 65535 ||
      (epi == kGated) != (w2 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (epi) {
    case kPlain:
      return dispatch<kPlain>(tile, x, w, w2, offsets, out, active, K, N, E,
                              zsplit, st);
    case kGated:
      return dispatch<kGated>(tile, x, w, w2, offsets, out, active, K, N, E,
                              zsplit, st);
    case kRelu2:
      return dispatch<kRelu2>(tile, x, w, w2, offsets, out, active, K, N, E,
                              zsplit, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
