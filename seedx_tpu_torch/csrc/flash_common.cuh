// Memory and wgmma building blocks shared by the flash-attention kernels
// (flash_fwd.cu: K1; flash_bwd.cu: K4 and K5), sm_90a.
//
// Tiles live in shared memory as 64-column atoms of rows x 128 B in the
// 128-byte swizzle (chunk c of row r at c ^ (r & 7)), the layout the
// wgmma matrix descriptors read; `cp.async` copies write it directly.
// Two products cover every flash product: `score_tile`, A and B both
// K-major in shared memory (S = Q K^T), and `pv_tile`, A from registers
// (an fp32 accumulator turned into bf16 fragments by `p_fragments`) and B
// MN-major in shared memory with the transpose bit (O += P V).
// tests/test_torch_cuda.py `test_wgmma_descriptor_tile` holds both to
// torch.matmul on the card through flash_fwd.cu's `flash_wgmma_tile_debug`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // ops/attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- memory

// the first 1024-byte boundary of the dynamic shared memory at `raw`:
// swizzle atoms must sit on one
__device__ __forceinline__ uint32_t aligned_base(unsigned char* raw) {
  return (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) + 1023) &
         ~1023u;
}

// byte offset of 16-byte chunk `ch` (8 values) of row r in a ROWS-row tile
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (ch >> 3) * (ROWS * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy of this thread landed, and visible to the async proxy
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ROWS rows of D values from src (row stride rs elements) into the swizzled
// tile at dst; rows >= valid are zero-filled
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, long rs,
                                          int valid, int tid) {
  constexpr int CPR = D / 8;
  static_assert((ROWS * CPR) % NT == 0, "tile copy must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CPR, ch = c % CPR;
    const bool ok = r < valid;
    cp_async16(dst + swz<ROWS>(r, ch), ok ? src + r * rs + ch * 8 : src, ok);
  }
}

// ----------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);                                   // 128-byte swizzle
}

// K-major operand (ROWS x D, D contiguous): k step kk of 16 values
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16,
                    1024);
}

// MN-major B operand (V: KEYS keys x D, D contiguous): key step kc of 16
template <int KEYS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kc) {
  return desc_sw128(tile + kc * 16 * 128, KEYS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads / writes of registers across a wgmma
// issue or wait
template <int N>
__device__ __forceinline__ void pin(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(a[j][i]) :: "memory");
}

#define F4(a, j) "+f"(a[j][0]), "+f"(a[j][1]), "+f"(a[j][2]), "+f"(a[j][3])
#define ACC64(a)                                                           \
  F4(a, 0), F4(a, 1), F4(a, 2), F4(a, 3), F4(a, 4), F4(a, 5), F4(a, 6),    \
      F4(a, 7)
#define ACC128(a)                                                          \
  ACC64(a), F4(a, 8), F4(a, 9), F4(a, 10), F4(a, 11), F4(a, 12),           \
      F4(a, 13), F4(a, 14), F4(a, 15)
#define REGS64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define REGS128                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// d[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS64
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS128
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC128(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] (registers) B[16 x N] (shared memory, MN-major:
// the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS64
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS128
      ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef REGS128
#undef REGS64
#undef ACC128
#undef ACC64
#undef F4

// S = Q K^T for the warpgroup's 64 rows over one BN-key tile: Q (the
// warpgroup's slice sq of the QROWS-row tile) and K (BN rows), both K-major
// in shared memory
template <int D, int QROWS, int BN>
__device__ __forceinline__ void score_tile(float (&s)[BN / 8][4], uint32_t sq,
                                           uint32_t sk) {
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc_kmajor<QROWS>(sq, kk), desc_kmajor<BN>(sk, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
}

// O += P V over one BN-key tile, V (BN keys x D) from shared memory
template <int D, int BN>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4],
                                        const uint32_t (&a)[BN / 16][4],
                                        uint32_t sv) {
  pin(o);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
    wgmma_rs(o, a[kc], desc_mnmajor<BN>(sv, kc));
  wgmma_commit();
  wgmma_wait<0>();
  pin(o);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// P (the S accumulator) as the A fragments of P V, 16 keys each
template <int NB>
__device__ __forceinline__ void p_fragments(const float (&s)[NB][4],
                                            uint32_t (&a)[NB / 2][4]) {
#pragma unroll
  for (int kc = 0; kc < NB / 2; ++kc) {
    a[kc][0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
    a[kc][1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
    a[kc][2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    a[kc][3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
  }
}

// ----------------------------------------------------------------- ex2

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
