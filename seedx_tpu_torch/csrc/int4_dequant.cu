// The W4A16 branch's int4 -> bf16 weight dequantization for Hopper, one
// pass: w [in, out] bf16 = code(packed) * bf16(scale[group]).
//
// Replaces no Pallas kernel.  The TPU code it stands for is XLA's fused
// unpack in seedx_tpu/ops/int4_matmul.py `int4_matmul_xla` (:202-218),
// which the reference's `int4_matmul_auto` runs above 2048 rows: the nibble
// decode, the casts and the group scale fuse there into one pass before the
// dense dot.  The port spelled the same unpack out in eager PyTorch
// (ops/int4_matmul.py `dequant_int4_plain`): int16 casts, four bit
// operations a nibble, a stack, two casts and the broadcast scale product,
// ~11 passes over the weight, ~31.5 bytes moved a weight, in every
// prefill group past 2048 rows (7 projections x 30 layers on the 7B).
// Generic elementwise and copy kernels led the long-document cell's
// breakdown (~1.78 s of an 8 s traced window, three times the W4A16 dots);
// this unpack was ~0.6 s of them, 0.665 ms a 4096 x 11008 weight against
// 0.047 for this kernel.
//
// Contract (bit-equal to the plain chain on the same inputs):
//   * packed uint8 [in/2, out]: byte [r, c] holds W[2r, c] in its lo nibble
//     and W[2r+1, c] in its hi nibble, two's complement
//     (utils/quantize.py quantize_kernel_int4);
//   * scale fp32 [in/group, out], group even (a packed row's two weights
//     share one group);
//   * w[k, c] = bf16_rn(float(code) * float(bf16_rn(scale[k / group, c]))):
//     the code is exact in bf16, the scale rounds to bf16 as the chain's
//     `.to(torch.bfloat16)`, and the product (exact in fp32: 4 x 8
//     significant bits) rounds once to bf16, as PyTorch's bf16 `*` does.
//
// What bounds it on the H100: bytes.  It reads 0.5 byte a weight (plus 4
// bytes of scale a group column, 1/32 byte a weight at group 128) and
// writes 2: ~2.53 bytes a weight, no arithmetic to speak of.  Layout: a
// thread owns one 8-byte vector of a packed row, 8 columns of the row pair
// (2r, 2r+1), and writes them as two 16-byte bf16 stores, one a row, so a
// warp reads 256 contiguous bytes and each of its stores fills 512
// contiguous bytes, whole 32-byte sectors.  (16 columns a thread, two
// stores a row at a 32-byte stride, each filling half of every sector it
// touches, ran at 2.2x the bound against 1.37x.)  A block is `blockDim.x`
// vectors across by `blockDim.y` packed rows, each thread kRows rows of
// its column, their loads all issued before the first store: 64 bytes of
// reads in flight a thread.  A block's chunk of rows lies in one group for
// the usual group 128 (64 packed rows a group and a chunk at 8 x 8): its 8
// column scales a thread are read once into registers and reread only when
// a row enters another group.  The packed bytes are read once and the
// weight is written once, so both stream (`__ldcs`, `__stcs`); the scales
// go through the read-only cache, shared by the block's rows.  The nibble
// decode needs no int -> float conversion: with bit 3 of each nibble
// flipped, (code + 8) | 0x4B000000 is the float 2^23 + code + 8, and one
// exact subtraction leaves the code.  No shared memory, no atomics: a
// replay gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

using Bf16 = Vec<__nv_bfloat16>;

constexpr int kRows = 8;           // packed rows a thread loads at once
constexpr int kMaxThreads = 256;
constexpr float kBias = 8388616.0f;  // 2^23 + 8

// nibble k (0-7) of w, whose nibbles hold code + 8, as the float code
__device__ __forceinline__ float code(uint32_t w, int k) {
  return __uint_as_float(0x4B000000u | ((w >> (4 * k)) & 0xFu)) - kBias;
}

// the 8 columns of packed words (w0, w1) in the row whose nibbles start at
// bit 4 * lo (0: row 2r, 1: row 2r + 1): each code times its column's
// scale, exact in fp32, rounded to bf16
__device__ __forceinline__ uint4 row8(uint32_t w0, uint32_t w1, int lo,
                                      const float* s) {
  float f[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = code(w0, lo + 2 * k) * s[k];
    f[4 + k] = code(w1, lo + 2 * k) * s[4 + k];
  }
  return Bf16::pack(f);
}

// packed [half][nvec 8-byte vectors], scale [groups][8 * nvec] fp32, out
// [2 * half][nvec 16-byte vectors]; half_group packed rows a group
__global__ void __launch_bounds__(kMaxThreads)
    int4_dequant_kernel(const uint2* __restrict__ packed,
                        const float* __restrict__ scale,
                        uint4* __restrict__ out, int half, int nvec,
                        int half_group) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const int chunk = kRows * blockDim.y;
  int cur = -1;
  float s[8];
  for (int r0 = blockIdx.y * chunk; r0 < half; r0 += gridDim.y * chunk) {
    uint2 p[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + u * blockDim.y + threadIdx.y;
      if (r < half) p[u] = __ldcs(packed + static_cast<long>(r) * nvec + v);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + u * blockDim.y + threadIdx.y;
      if (r >= half) continue;
      const int g = r / half_group;
      if (g != cur) {
        const float4* s4 = reinterpret_cast<const float4*>(
            scale + static_cast<long>(g) * 8 * nvec + 8 * v);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 f = __ldg(s4 + j);
          s[4 * j] = Bf16::round(f.x);
          s[4 * j + 1] = Bf16::round(f.y);
          s[4 * j + 2] = Bf16::round(f.z);
          s[4 * j + 3] = Bf16::round(f.w);
        }
        cur = g;
      }
      // bit 3 of every nibble flipped: each nibble holds code + 8
      const uint32_t w0 = p[u].x ^ 0x88888888u, w1 = p[u].y ^ 0x88888888u;
      uint4* o = out + static_cast<long>(2 * r) * nvec + v;
      __stcs(o, row8(w0, w1, 0, s));
      __stcs(o + nvec, row8(w0, w1, 1, s));
    }
  }
}

}  // namespace

// packed uint8 [half][8 * nvec], scale fp32 [half / (group / 2)][8 * nvec],
// out bf16 [2 * half][8 * nvec], each contiguous, packed 8-byte and scale
// and out 16-byte aligned; group even and dividing 2 * half.  A block is
// tx = 32 vectors across (nvec below 32: nvec; the last strip may be
// ragged) by kMaxThreads / tx rows, each thread kRows rows of its column,
// one block a chunk of rows down each strip, grid-strided past 65535
// chunks.  (Blocks 64-256 vectors across, or of 512-1024 threads, measured
// within 3% of this on the H100.)
extern "C" int int4_dequant_bf16(const void* packed, const void* scale,
                                 void* out, int half, int nvec, int group,
                                 void* stream) {
  if (half <= 0 || nvec <= 0 || group <= 0 || group % 2 || (2 * half) % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tx = nvec < 32 ? nvec : 32, ty = kMaxThreads / tx;
  const int chunks = (half + kRows * ty - 1) / (kRows * ty);
  const dim3 grid((nvec + tx - 1) / tx, chunks < 65535 ? chunks : 65535),
      block(tx, ty);
  int4_dequant_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(packed), static_cast<const float*>(scale),
      static_cast<uint4*>(out), half, nvec, group / 2);
  return static_cast<int>(cudaGetLastError());
}
