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
// What bounds it on the H100: at rows <= ~64 (decode at B 1-8, the fused
// mixed step, the 65-row <img> chunk) the packed weight stream from HBM --
// 0.5 byte a weight, a few int8 operations a byte, far below the ridge; at
// rows 512-2048 (prefill) int8 tensor-core operations, 2 * rows per weight.
//
// Design (one kernel for every row count, two launches a call):
// * Prologue `quantize_rows`: one block a row reads it once into registers,
//   computes xa and writes the int8 row in the layout the matmul reads:
//   each group padded with zeros to a multiple of 32 k (so a group that is a
//   multiple of 4 but not of 32 needs no other path: the zero k tail adds
//   nothing), and the 4-byte words of each 32-k step in the order the B
//   fragments' k take (below).  It lets the matmul launch at once
//   (programmatic dependent launch): the matmul's blocks copy their first
//   weight tiles while the rows are quantized, and wait for them only
//   before their first x8 copy.
// * The matmul: a block owns BM = 16 * MT rows (MT 1, 2 or 4, picked on the
//   host by ops/int4_matmul.py `plan`) by BN = 128 columns, four warps side
//   by side, each 16 * MT x 32.  It walks its split's groups in k-tiles of
//   128 k through a 3-stage `cp.async` ring: per stage the x8 tile (BM x
//   128 bytes, rows past `rows` and k past the padded group zero-filled),
//   the packed tile (64 k-pair rows x 128 columns, k past the group
//   zero-filled) and, on the group's last tile, its scale row.  16-byte
//   chunks, neighbouring threads on neighbouring addresses; both tiles
//   swizzled so the fragment reads are free of bank conflicts.
// * Group dots on the tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32, four
//   k-steps a 128-wide group; A (x8) through ldmatrix.  B ("col": 4
//   consecutive k of one column a register) comes from the column-
//   contiguous packed bytes in registers: each thread reads four 4-byte
//   words (4 columns x 4 k-pair rows) and builds its 8 B registers with
//   byte permutes.  Its 4 columns are one column of each of its 4 n-tiles
//   (output column 32 w + 4 c + j is n-tile j's column c), so a thread's
//   outputs are 8 contiguous columns; the k order inside a 32-k step is
//   permuted the same way on both operands (x8 by the prologue).  The
//   nibbles are never sign-extended: `b & 0xF0` is 16 W_hi and
//   `(b << 4) & 0xF0` is 16 W_lo as int8, so the s32 dot is 16x the true
//   one, exact.  A group's s32 sums start at the bits of 1.5 * 2^23 (its
//   first product's C operand), so at the group's end one FADD makes each
//   an fp32 dot, exactly, which FMAs into the fp32 accumulators with the
//   group's column scales / 16 (exact).  (A second B route, ldmatrix.trans
//   over an unpacked b16 tile, was measured slower at every row count and
//   deleted.)
// * Split-K only where the row x column tiles leave the SMs short: every
//   split writes fp32 partials, takes a ticket, and the last block of the
//   tile sums the partials in split order, times xa, stores bf16 and resets
//   the ticket -- one launch, the same bits on every run.
// * ptxas (-Xptxas -v, nvcc 12.9, printed by chip_smoke.py's build phase):
//   168 / 116 / 82 registers for the 64 / 32 / 16-row tiles; three blocks
//   an SM cap the 64-row tile at 168, where it spills 16 bytes (at four
//   blocks it spilled 348 and ran 1.6x slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // 4 warps side by side along n
constexpr int kBN = 128;             // output columns a block
constexpr int kTileK = 128;          // k a ring stage (64 packed rows)
constexpr int kTileKP = kTileK / 2;
constexpr int kStages = 3;
constexpr int kMaxSplits = 64;
constexpr int kQThreads = 512;       // prologue threads a row
constexpr int kQVec = 8;             // 4-value vectors a prologue thread holds

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with C = kMagic in every lane: a group's first product
__device__ __forceinline__ void mma_s8_first(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1,
                                             int magic) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(magic));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 * the hi / lo nibbles of each byte, as int8
__device__ __forceinline__ uint32_t hi16(uint32_t u) { return u & 0xF0F0F0F0u; }
__device__ __forceinline__ uint32_t lo16(uint32_t u) {
  return (u << 4) & 0xF0F0F0F0u;
}

// packed words u0, u1 of two consecutive k-pair rows (byte j = column j) ->
// the B register of each column j: [lo(u0_j), hi(u0_j), lo(u1_j), hi(u1_j)],
// i.e. 4 consecutive k of column j
__device__ __forceinline__ void b_regs(uint32_t u0, uint32_t u1,
                                       uint32_t (&b)[4]) {
  const uint32_t p = __byte_perm(u0, u1, 0x5140);   // u0_0 u1_0 u0_1 u1_1
  const uint32_t q = __byte_perm(u0, u1, 0x7362);   // u0_2 u1_2 u0_3 u1_3
  const uint32_t ph = hi16(p), pl = lo16(p), qh = hi16(q), ql = lo16(q);
  b[0] = __byte_perm(pl, ph, 0x5140);
  b[1] = __byte_perm(pl, ph, 0x7362);
  b[2] = __byte_perm(ql, qh, 0x5140);
  b[3] = __byte_perm(ql, qh, 0x7362);
}

// A group's s32 sums start at the bits of 1.5 * 2^23 (the first product's
// C), so for |16 dot| < 2^22 the sum read as fp32 is 1.5 * 2^23 + 16 dot
// exactly, and one FADD yields the dot as fp32 (I2F runs at a quarter of
// the rate, and zeroing the sums would cost a move each)
constexpr int kMagic = 0x4B400000;
constexpr float kMagicF = 12582912.f;

// Shared-memory layouts.  x8 tile: BM rows x 8 chunks of 16 bytes, chunk c
// of row r at c ^ (r & 7) (ldmatrix reads 8 rows of one chunk).  Packed
// tile: 64 rows x 8 chunks, chunk c of row r at c ^ 2 ((r >> 2) & 3), so
// the four k-row quads a warp reads at once hit distinct banks.
__device__ __forceinline__ int b_chunk(int r, int c) {
  return c ^ (((r >> 2) & 3) << 1);
}

template <int MT>
struct Cfg {
  static constexpr int kBM = 16 * MT;
  static constexpr int kA = kBM * kTileK;            // x8 tile bytes
  static constexpr int kB = kTileKP * kBN;           // packed tile bytes
  static constexpr int kS = kBN * 4;                 // scale row bytes
  static constexpr int kStage = kA + kB + kS;
  static constexpr int kSmem = kStages * kStage;
  static_assert(kBM * 8 % kThreads == 0 && kStage % 16 == 0, "tile copy");
};

struct Params {
  const int8_t* x8;      // [rows][n_groups * gp], see quantize_rows
  const uint8_t* packed;
  const float* scale;
  const float* xa;
  __nv_bfloat16* out;
  float* part;           // [splits][rows][n_out]
  int* tickets;          // [row tiles * column tiles], zero between launches
  int rows, n_out, group, gp, n_groups, gps, splits, ktpg;
};

// the int8 codes of 4 bf16 values (8 bytes) at row scale a, one word
__device__ __forceinline__ uint32_t quantize4(uint2 v, float a) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float f[4] = {__low2float(lo), __high2float(lo), __low2float(hi),
                      __high2float(hi)};
  uint32_t q = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q |= static_cast<uint32_t>(static_cast<uint8_t>(
             static_cast<int8_t>(rintf(f[e] / a)))) << (8 * e);
  return q;
}

__device__ __forceinline__ float abs_max4(uint2 u, float m) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return fmaxf(m, fmaxf(fmaxf(fabsf(__low2float(a)), fabsf(__high2float(a))),
                        fmaxf(fabsf(__low2float(b)), fabsf(__high2float(b)))));
}

// word of the padded row holding the 4 values at k = kg of group g: its
// 32-k step, and within the step physical word pw at position
// [0 2 4 6 1 3 5 7].index(pw)
__device__ __forceinline__ int x8_word(int g, int kg, int gp) {
  const int pw = (kg >> 2) & 7;
  return (g * gp + (kg & ~31)) / 4 + ((pw & 1) ? 4 + (pw >> 1) : pw >> 1);
}

// one block a row: xa = max(absmax, 1e-8) / 127 and the int8 row (see the
// header).  A row of up to kQThreads * kQVec * 4 values is read once.
__global__ void __launch_bounds__(kQThreads)
quantize_rows(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ x8,
              float* __restrict__ xa, const float* __restrict__ row_amax,
              int n_in, int group, int gp, int n_groups) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float warp_max[kQThreads / 32];
  const int r = blockIdx.x, tid = threadIdx.x, n4 = n_in / 4;
  const uint2* xv = reinterpret_cast<const uint2*>(
      x + static_cast<long>(r) * n_in);
  uint32_t* qr = reinterpret_cast<uint32_t*>(
      x8 + static_cast<long>(r) * n_groups * gp);
  uint2 v[kQVec];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kQVec; ++i) {
    const int idx = tid + i * kQThreads;
    if (idx < n4) {
      v[i] = xv[idx];
      amax = abs_max4(v[i], amax);
    }
  }
  for (int idx = tid + kQVec * kQThreads; idx < n4; idx += kQThreads)
    amax = abs_max4(xv[idx], amax);
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kQThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  // a row-parallel shard takes the whole row's absmax from the caller
  if (row_amax != nullptr) amax = row_amax[r];
  const float a = fmaxf(amax, 1e-8f) / 127.0f;
  if (tid == 0) xa[r] = a;
#pragma unroll
  for (int i = 0; i < kQVec; ++i) {
    const int idx = tid + i * kQThreads;
    if (idx < n4) {
      const int g = 4 * idx / group;
      qr[x8_word(g, 4 * idx - g * group, gp)] = quantize4(v[i], a);
    }
  }
  for (int idx = tid + kQVec * kQThreads; idx < n4; idx += kQThreads) {
    const int g = 4 * idx / group;
    qr[x8_word(g, 4 * idx - g * group, gp)] = quantize4(xv[idx], a);
  }
  // the zero k tail of each group (gp > group)
  const int tail = (gp - group) / 4;
  for (int i = tid; i < n_groups * tail; i += kQThreads)
    qr[x8_word(i / tail, group + 4 * (i % tail), gp)] = 0u;
}

// The B registers of k-step s for a warp's 4 n-tiles: b[j][0] (k 0-15 of
// the step) and b[j][1] (k 16-31), from the stage's packed tile stB
__device__ __forceinline__ void load_b(const unsigned char* stB, int s,
                                       int warp, int lane,
                                       uint32_t (&b)[4][2]) {
  const int q = lane & 3, n = lane >> 2;
  const int coff = (((2 * warp + (n >> 2)) ^ (q << 1)) << 4) + (n & 3) * 4;
  const unsigned char* base = stB + (16 * s + 4 * q) * kBN + coff;
  const uint32_t u0 = *reinterpret_cast<const uint32_t*>(base);
  const uint32_t u1 = *reinterpret_cast<const uint32_t*>(base + kBN);
  const uint32_t u2 = *reinterpret_cast<const uint32_t*>(base + 2 * kBN);
  const uint32_t u3 = *reinterpret_cast<const uint32_t*>(base + 3 * kBN);
  uint32_t lo[4], hi[4];
  b_regs(u0, u1, lo);
  b_regs(u2, u3, hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j][0] = lo[j];
    b[j][1] = hi[j];
  }
}

// One k-tile's products into acc: `steps` k-steps (4 for a group of at
// least 128 k); on the group's first tile the first products take
// C = kMagic.  kCommon: the common tile (4 steps, the group's first),
// branch-free, so one k-step's fragment reads overlap the last one's
// products; any other tile takes the general body.
template <int MT, bool kCommon>
__device__ __forceinline__ void tile_mma(int (&acc)[MT][4][4], uint32_t sa,
                                         const unsigned char* stB, int warp,
                                         int lane, int steps, bool first) {
#pragma unroll
  for (int s = 0; s < kTileK / 32; ++s) {
    if (!kCommon && s >= steps) break;
    uint32_t b[4][2];
    load_b(stB, s, warp, lane, b);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int r = mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int ch = 2 * s + (lane >> 4);
      uint32_t a[4];
      ldmatrix_x4(a, sa + r * kTileK + ((ch ^ (r & 7)) << 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s == 0 && (kCommon || first))
          mma_s8_first(acc[mi][j], a, b[j][0], b[j][1], kMagic);
        else
          mma_s8(acc[mi][j], a, b[j][0], b[j][1]);
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 4 ? 3 : 4)
w4a8_mma(const Params p) {
  using C = Cfg<MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane & 3, gq = lane >> 2;
  const int row0 = blockIdx.x * C::kBM, col0 = blockIdx.y * kBN;
  const int g0 = blockIdx.z * p.gps;
  const int g1 = min(p.n_groups, g0 + p.gps);
  const int n_tiles = (g1 - g0) * p.ktpg;

  // ring stage `it`: the packed tile and (a group's last tile) its scale
  // row, then the x8 tile; the x8 copies wait for the prologue
  auto copy_b = [&](int it) {
    if (it >= n_tiles) return;
    const int g = g0 + it / p.ktpg, kt = it % p.ktpg;
    const uint32_t sb = smem_u32(smem + (it % kStages) * C::kStage) + C::kA;
#pragma unroll
    for (int i = 0; i < kTileKP * 8 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, ch = c & 7;
      const bool ok = kt * kTileK + 2 * r < p.group &&
                      col0 + ch * 16 < p.n_out;
      const uint8_t* src =
          ok ? p.packed +
                   (static_cast<long>(g) * (p.group >> 1) + kt * kTileKP + r) *
                       p.n_out + col0 + ch * 16
             : p.packed;
      cp_async16(sb + r * kBN + (b_chunk(r, ch) << 4), src, ok);
    }
    if (kt == p.ktpg - 1 && tid < kBN / 4) {
      const bool ok = col0 + 4 * tid < p.n_out;
      const float* src =
          ok ? p.scale + static_cast<long>(g) * p.n_out + col0 + 4 * tid
             : p.scale;
      cp_async16(sb + C::kB + 16 * tid, src, ok);
    }
  };
  auto copy_a = [&](int it) {
    if (it < n_tiles) {
      const int g = g0 + it / p.ktpg, kt = it % p.ktpg;
      const uint32_t sa = smem_u32(smem + (it % kStages) * C::kStage);
#pragma unroll
      for (int i = 0; i < C::kBM * 8 / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int r = c >> 3, ch = c & 7;
        const int kb = kt * kTileK + ch * 16;
        const bool ok = row0 + r < p.rows && kb < p.gp;
        // int offsets: the entry point bounds x8 below 2^31 bytes
        const int8_t* src =
            ok ? p.x8 + (row0 + r) * (p.n_groups * p.gp) + g * p.gp + kb
               : p.x8;
        cp_async16(sa + r * kTileK + ((ch ^ (r & 7)) << 4), src, ok);
      }
    }
    cp_async_commit();
  };

  int acc[MT][4][4];
  float facc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[mi][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) copy_b(i);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // x8 and xa ready
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) copy_a(i);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    copy_b(it + kStages - 1);
    copy_a(it + kStages - 1);
    const unsigned char* st = smem + (it % kStages) * C::kStage;
    const unsigned char* stB = st + C::kA;
    const float* stS = reinterpret_cast<const float*>(stB + C::kB);
    const int kt = it % p.ktpg;
    const int steps = min(kTileK / 32, (p.gp - kt * kTileK) >> 5);
    const uint32_t sa = smem_u32(st);
    if (steps == kTileK / 32 && kt == 0)
      tile_mma<MT, true>(acc, sa, stB, warp, lane, steps, true);
    else
      tile_mma<MT, false>(acc, sa, stB, warp, lane, steps, kt == 0);
    if (kt == p.ktpg - 1) {
      // the group's exact dots times its column scales: the dots are 16x,
      // so the scales are taken / 16 (exact); |16 dot| < 2^22 for groups
      // up to 256, read through kMagic, with I2F above.  This thread's
      // columns: 8 q + 4 e + j of the warp's 32
      const bool small = p.group <= 256;
      const float* sw = stS + 32 * warp + 8 * q;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sc[2] = {sw[j] * 0.0625f, sw[4 + j] * 0.0625f};
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = acc[mi][j][e];
            // (above 256: v - kMagic in unsigned arithmetic, exact while
            // |16 dot| < 2^31, i.e. groups below 2^17)
            const float d =
                small ? __int_as_float(v) - kMagicF
                      : __int2float_rn(static_cast<int>(
                            static_cast<uint32_t>(v) - uint32_t{kMagic}));
            facc[mi][j][e] = fmaf(d, sc[e & 1], facc[mi][j][e]);
          }
      }
    }
  }

  // epilogue: bf16 out (one split) or fp32 partials, 8 contiguous columns
  // a thread and row
  const bool split = p.splits > 1;
  const int c = col0 + 32 * warp + 8 * q;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mi * 16 + gq + 8 * h;
      if (r >= p.rows || c >= p.n_out) continue;
      const float a = split ? 1.f : p.xa[r];
      float v[8];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[4 * e + j] = facc[mi][j][2 * h + e] * a;
      if (split) {
        float* dst = p.part + (static_cast<long>(blockIdx.z) * p.rows + r) *
                                  p.n_out + c;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(p.out + static_cast<long>(r) * p.n_out + c) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      }
    }
  }
  if (!split) return;

  // the last split of this tile to finish merges, in split order
  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.tickets + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long plane = static_cast<long>(p.rows) * p.n_out;
  for (int i = tid; i < C::kBM * kBN / 4; i += kThreads) {
    const int r = row0 + i / (kBN / 4), cc = col0 + (i % (kBN / 4)) * 4;
    if (r >= p.rows || cc >= p.n_out) continue;
    const float* src = p.part + static_cast<long>(r) * p.n_out + cc;
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < p.splits; s0 += 8) {     // 8 loads in flight
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (s0 + k < p.splits)
          v[k] = __ldcg(reinterpret_cast<const float4*>(src +
                                                        (s0 + k) * plane));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (s0 + k < p.splits) {
          s4.x += v[k].x;
          s4.y += v[k].y;
          s4.z += v[k].z;
          s4.w += v[k].w;
        }
    }
    const float a = p.xa[r];
    *reinterpret_cast<uint2*>(p.out + static_cast<long>(r) * p.n_out + cc) =
        make_uint2(pack_bf16(s4.x * a, s4.y * a),
                   pack_bf16(s4.z * a, s4.w * a));
  }
  if (tid == 0) p.tickets[tile] = 0;
}

template <int MT>
int launch(const Params& p, cudaStream_t s) {
  constexpr int smem = Cfg<MT>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      w4a8_mma<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // launched while the prologue runs (programmatic dependent launch):
  // its blocks wait at griddepcontrol.wait before reading x8 and xa
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.rows + 16 * MT - 1) / (16 * MT),
                     (p.n_out + kBN - 1) / kBN, p.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  la[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w4a8_mma<MT>, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// one block: the B registers of one packed 64 x 128 tile for each k-step,
// as the matmul builds them -> regs [warp 0..3][s 0..3][lane][j][2]
__global__ void b_fragments_debug(const uint8_t* __restrict__ tile,
                                  uint32_t* __restrict__ regs) {
  __shared__ __align__(128) unsigned char st[kTileKP * kBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < kTileKP * 8; c += kThreads) {
    const int r = c >> 3, ch = c & 7;
    *reinterpret_cast<uint4*>(st + r * kBN + (b_chunk(r, ch) << 4)) =
        *reinterpret_cast<const uint4*>(tile + r * kBN + ch * 16);
  }
  __syncthreads();
  for (int s = 0; s < kTileK / 32; ++s) {
    uint32_t b[4][2];
    load_b(st, s, warp, lane, b);
    uint32_t* o = regs + ((warp * 4 + s) * 32 + lane) * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = b[j][0];
      o[2 * j + 1] = b[j][1];
    }
  }
}

}  // namespace

// x bf16 [rows, n_in]; packed uint8 [n_in/2, n_out]; scale f32
// [n_in/group, n_out]; out bf16 [rows, n_out].  work: the caller's scratch,
// x8 [rows][n_groups * gp] int8 (gp = group rounded up to 32), then xa f32
// [rows] at the next 16-byte boundary, then (splits > 1) the fp32 partials
// [splits][rows][n_out] at the next 16-byte boundary; tickets: row tiles *
// column tiles zeroed ints (read only when splits > 1).  row_amax: null, or
// f32 [rows], each row's absmax to quantize against in place of the
// absmax of the `n_in` values given (a rank holding a row-parallel shard
// of the in dimension passes the whole row's).  mt: m-tiles of 16
// rows a warp (1, 2 or 4); splits: the live split count of
// ops/int4_matmul.py `plan` (groups ceil(n_groups / splits) a split).
extern "C" int int4_w4a8_bf16(const void* x, const void* packed,
                              const void* scale, void* out, void* work,
                              void* tickets, int rows, int n_in, int n_out,
                              int group, int mt, int splits,
                              const void* row_amax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || n_out == 0) return 0;
  if (n_in % 4 || n_out % 16 || group % 4 || group <= 0 || n_in % group ||
      splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.rows = rows;
  p.n_out = n_out;
  p.group = group;
  p.gp = (group + 31) / 32 * 32;
  p.n_groups = n_in / group;
  p.gps = (p.n_groups + splits - 1) / splits;
  p.splits = splits;
  p.ktpg = (p.gp + kTileK - 1) / kTileK;
  if ((p.n_groups + p.gps - 1) / p.gps != splits ||
      (splits > 1 && tickets == nullptr) ||
      static_cast<long>(rows) * p.n_groups * p.gp >= (1L << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long x8_bytes = (static_cast<long>(rows) * p.n_groups * p.gp + 15) /
                        16 * 16;
  char* w = static_cast<char*>(work);
  p.x8 = reinterpret_cast<const int8_t*>(w);
  p.xa = reinterpret_cast<const float*>(w + x8_bytes);
  p.part = splits > 1 ? reinterpret_cast<float*>(
                            w + x8_bytes + (rows * 4L + 15) / 16 * 16)
                      : nullptr;
  p.packed = static_cast<const uint8_t*>(packed);
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.tickets = static_cast<int*>(tickets);
  quantize_rows<<<rows, kQThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), const_cast<int8_t*>(p.x8),
      const_cast<float*>(p.xa), static_cast<const float*>(row_amax), n_in,
      group, p.gp, p.n_groups);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (mt == 1) return launch<1>(p, s);
  if (mt == 2) return launch<2>(p, s);
  if (mt == 4) return launch<4>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// tests/test_torch_cuda.py: the B registers each lane builds from one
// packed [64, 128] tile (regs: 4 warps x 4 k-steps x 32 lanes x 8 words)
extern "C" int int4_w4a8_fragments_debug(const void* tile, void* regs,
                                         void* stream) {
  b_fragments_debug<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tile), static_cast<uint32_t*>(regs));
  return static_cast<int>(cudaGetLastError());
}
