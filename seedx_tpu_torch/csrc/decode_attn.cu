// Ragged decode attention for Hopper (sm_90a): one query token per batch
// row over the valid window of that row's KV cache, or a window of w query
// tokens per row over a causal "stair" (the fused prefill+decode step).
//
// Replaces: seedx_tpu/ops/decode_attention.py `_decode_kernel` (the
// Pallas TPU kernel reached through `ragged_decode_attention`), in both of
// its modes.  Same contract: q [B, w, Hq, D] bf16 (w = 1 for the
// one-query mode, whose q is [B, Hq, D]); a flat cache [B, S, Hkv*D] (or a
// paged pool [P*page, Hkv*D] where logical position p of row b lives at
// pool row tables[b, p / page] * page + p % page) of bf16 values or int8
// codes with bf16 per-(position, head) scales [.., Hkv]; query slot i of
// row b sits at position ends[b] - 1 + i and attends
// [starts[b], min(ends[b] + i, S)) only, S being the logical cache length;
// q head h reads kv head h / G; out [B, w, Hq, D] bf16, exactly zero for
// an empty window.
//
// What bounds it on the H100: HBM bytes.  A window position costs 2 * D
// bytes of int8 codes (4 * D of bf16 values) plus 4 bytes of scales per kv
// head, and 4 * D FLOP per query vector; even the 64-row stair does 64 *
// 4 * D FLOP per 2 * D + 4 bytes, ~130 FLOP a byte, below the bf16 ridge
// (~295).  So the design reads each window position from HBM once for all
// the query vectors of its (kv head, row), keeps bytes in flight at batch
// 1 by splitting the window, and keeps the arithmetic off the critical
// path.
//
// Design (flash-decoding with tensor-core scoring):
// * Grid (Hkv, B, groups * splits), 128 threads (4 warps) a block.  A
//   group is QL consecutive query slots of one row; its QL * G query
//   vectors (G q heads of the kv head per slot, row r = slot * G + head)
//   are the block's rows, at most 64, padded to MT m-tiles of 16 (MT 1, 2
//   or 4).  ops/decode_attention.py `plan` puts every slot of a row in one
//   group whenever QL * G <= 64 (the one-query GQA row, the w 8 / 16 MHA
//   stair, the w 8 GQA stair and w 64 at G 1 read each position once); w
//   64 at G 5 takes 6 groups of 11 slots, so there each position is read 6
//   times.  `plan` also picks the split count from the logical cache
//   length S and the SM count (never from the windows, which stay on the
//   device): enough blocks for every SM, and, for blocks of fewer than 8
//   query vectors, at most 10 tiles a split.
// * Splits: the group's window [start, e) (e = its last slot's stair
//   end) is cut on the device into `splits` chunks of whole 64-position
//   tiles, counted from start; the trailing chunks of a short window are
//   empty and their blocks return at once.  A block with the only live
//   chunk writes the output itself.  Otherwise each block writes its fp32
//   partial (m, l, acc) per query vector to the wrapper's scratch, takes a
//   ticket (one int per (row, kv head, group), zero between launches), and
//   the last of the live blocks merges the partials in split order (each
//   split's m and l in one round of loads, then acc as float4 loads all in
//   flight per split) and resets the ticket: one launch, and the same bits
//   on every run whatever block finishes last.
// * A 3-stage cp.async ring of 64-position k / v tiles in shared memory,
//   16-byte chunks with neighbouring threads on neighbouring addresses
//   (a position's D-element run of one kv head is contiguous), zero fill
//   past the chunk (src-size 0).  Paged, the block's slice of `tables`
//   (up to 64 pages) is read into shared memory first, and each tile row's
//   pool row is computed from it (a tile may cross pages).  The int8
//   scales are 2-byte values strided by Hkv: each of 128 threads copies
//   the aligned 4-byte word around one of the tile's 64 k and 64 v scales
//   in the same ring stage, and notes which half is its scale.
// * Scores S = Q K^T and P V with mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate); M is 1-64 rows, below wgmma's 64-row tile, and wgmma
//   would want int8 codes converted in shared memory.  The m-tile's KS =
//   4 / MT warps split each 64-position tile by keys (16, 32 or 64 each)
//   and run their own online softmax, merged through shared memory at the
//   end.  Fragments are read with plain 32 / 64-bit shared loads, not
//   ldmatrix: the head dim of Q and K is permuted inside each 16-wide
//   k-step (logical k 2t, 2t+1, 2t+8, 2t+9 <- physical 4t .. 4t+3, the
//   same for both operands, so the dot products are unchanged), and the
//   output columns of P V inside each 32-wide group (n-fragment j, column
//   g <- dim 4g + j), so a thread's B operand comes from 4 contiguous
//   bytes (int8) or 8 (bf16) of a row.  int8 codes become bf16 in
//   registers, exactly, with full-rate byte permutes and adds (`code_f32`;
//   with I2F, at a quarter of the rate, the int8 rows ran slower than the
//   bf16 ones, which read twice the bytes).  Row strides are padded so
//   that every such load is free of bank conflicts.
// * The TPU kernel's arithmetic: fp32 dots of bf16 q and k, the softmax
//   scale and then the k scale after the dot, fp32 online softmax,
//   P = round_bf16(p * v_scale) as the A operand of P V (the reference's
//   own rounding: decode_attention.py:316-320), acc / max(l, 1e-30).  The
//   masks (each slot's stair end, the chunk end) run only on a chunk's
//   edge tiles; start needs none, as chunks begin at it.  Masked scores
//   are NEG_INF and their p is set to 0, never exp(NEG_INF - NEG_INF).
// * Per position and kv head: 2 * D (int8) or 4 * D (bf16) bytes of k and
//   v and 4 of scales, read from HBM once for the whole group, into shared
//   memory once; each warp of the m-tile reads its keys' bytes from shared
//   memory once (at MT 4 every warp reads all 64 keys of a tile).
// * ptxas (-Xptxas -v, nvcc 12.9, printed by chip_smoke.py's build
//   phase): 84-253 registers (int8 D 128 at one m-tile: 165, so three
//   blocks of 57,216 bytes of ring share an SM; bf16 D 128: 164, two
//   blocks of 107,520 bytes), 0 bytes spilled, no stack frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // ops/attention.py NEG_INF
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;      // positions per ring stage
constexpr int kStages = 3;
constexpr int kMaxRows = 64;   // query vectors a block holds (4 m-tiles)
constexpr int kMaxSplits = 32; // the merge keeps m, l of each in shared memory
constexpr int kPages = 64;     // page-table entries a block keeps in shared

// Shared-memory layout of one (D, element type) instance.  K rows are
// padded to a stride of 4 mod 32 words (int8, 32-bit loads by 8 rows x 4
// threads) or 8 mod 32 (bf16, 64-bit loads by 4 rows x 4 threads per
// half-warp); V rows to 4 mod 16 words (4 keys 2t, 2t+1, .. x 8 columns).
template <int D, typename T>
struct Cfg {
  static constexpr bool kInt8 = sizeof(T) == 1;
  static constexpr int kRow = D * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRow / 16;
  static constexpr int kKStride = kRow + (kInt8 ? 16 : 32);
  static constexpr int kVStride = kRow + 16;
  static constexpr int kKBytes = kTile * kKStride;
  static constexpr int kVBytes = kTile * kVStride;
  // int8: the 4-byte words holding each position's k and v scale, and
  // which half of its word each scale is
  static constexpr int kScBytes = kInt8 ? 2 * kTile * 4 + 2 * kTile : 0;
  static constexpr int kStage = kKBytes + kVBytes + kScBytes;
  // the end-of-block merge reuses the ring: acc [4][16][D], m, l [4][16]
  static constexpr int kMerge = kWarps * 16 * (D + 2) * 4;
  static constexpr int kSmem =
      kStages * kStage > kMerge ? kStages * kStage : kMerge;
};

struct Params {
  const __nv_bfloat16* q;
  const unsigned char* k;
  const unsigned char* v;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int* starts;
  const int* ends;
  const int* tables;
  __nv_bfloat16* out;
  float* part;     // [splits][B][Hkv][groups][QL * G][D] acc, then m, l
  float* part_ml;  // [splits][B][Hkv][groups][QL * G][2]
  int* tickets;    // [B][Hkv][groups], zero between launches
  int B, W, Hq, Hkv, S, n_tiles, page, G, QL, groups, splits;
  float scale;
};

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// int8 codes -> bf16, exactly and at the full rate (I2F runs at a
// quarter): u = w ^ 0x80808080 holds code + 128 in each byte; placed as
// the low mantissa byte of 2^23 it reads 2^23 + code + 128, and one FADD
// leaves the code as an fp32 integer of at most 8 significant bits, whose
// upper half is its bf16
__device__ __forceinline__ float code_f32(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i))
         - 8388736.f;
}

__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// byte i of two flipped words of codes -> one bf16x2
__device__ __forceinline__ uint32_t codes_bf16(uint32_t lo, uint32_t hi,
                                               int i) {
  return pack_hi(code_f32(lo, i), code_f32(hi, i));
}

// bytes 2i, 2i + 1 of a flipped word of codes -> one bf16x2
__device__ __forceinline__ uint32_t codes_pair(uint32_t u, int i) {
  return pack_hi(code_f32(u, 2 * i), code_f32(u, 2 * i + 1));
}

constexpr uint32_t kFlip = 0x80808080u;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}

// a 4-byte word holding one 2-byte scale (zero fill past the window)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// int8 at one m-tile fits three blocks an SM (~57 KB of ring each and at
// most 170 registers); the others two
template <int D, int MT, typename T>
__global__ void __launch_bounds__(kThreads,
                                  MT == 1 && sizeof(T) == 1 ? 3 : 2)
decode_attn_kernel(const Params p) {
  using C = Cfg<D, T>;
  constexpr bool kInt8 = C::kInt8;
  constexpr int KS = kWarps / MT;      // warps sharing an m-tile
  constexpr int KW = kTile / KS;       // keys of a tile per warp
  constexpr int NF = KW / 8;           // score n-fragments per warp
  constexpr int NO = D / 8;            // output n-fragments
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  __shared__ int s_pages[kPages];

  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = p.G;
  const int qi0 = grp * p.QL;
  const int nslots = min(p.QL, p.W - qi0);
  const int nrows = nslots * G;                   // live query vectors
  const int start = max(p.starts[b], 0);
  const int end0 = p.ends[b];
  // the group's window ends at its last slot's stair end; its first
  // slot's end is the smallest of its rows'
  const int e_max = max(min(end0 + qi0 + nslots - 1, p.S), start);
  const int e_min = min(end0 + qi0, p.S);
  const int tiles_w = (e_max - start + kTile - 1) / kTile;
  const int chunk = (tiles_w + p.splits - 1) / p.splits;
  const int n_live = tiles_w ? (tiles_w + chunk - 1) / chunk : 0;
  if (split >= max(n_live, 1)) return;            // an empty chunk
  const int p0 = start + split * chunk * kTile;
  const int p1 = min(p0 + chunk * kTile, e_max);
  const int nt = (p1 - p0 + kTile - 1) / kTile;   // 0 for an empty window
  const int edge = min(p1, e_min);                // tiles ending past it mask
  const long F = static_cast<long>(p.Hkv) * D;

  const int mt = warp / KS, kw = warp % KS;
  // this thread's two rows (g, g + 8 of its m-tile) and their window ends
  int lim[2];
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = mt * 16 + g + 8 * hf;
    lim[hf] = p1;
    if (r < nrows) {
      const int slot = qi0 + r / G;
      lim[hf] = min(min(end0 + slot, p.S), p1);
      const __nv_bfloat16* src =
          p.q + ((static_cast<long>(b) * p.W + slot) * p.Hq + h * G + r % G)
                    * D + 4 * t;
#pragma unroll
      for (int s = 0; s < D / 16; ++s) {
        const uint2 w = *reinterpret_cast<const uint2*>(src + 16 * s);
        qa[s][hf] = w.x;
        qa[s][2 + hf] = w.y;
      }
    } else {
#pragma unroll
      for (int s = 0; s < D / 16; ++s) qa[s][hf] = qa[s][2 + hf] = 0u;
    }
  }

  // Paged: the block's slice of `tables` (the pages of [p0, p1)) in
  // shared memory, so a copy never waits for a lookup in device memory;
  // a slice longer than kPages pages reads the rest from `tables`.
  const int pg0 = p.tables ? p0 / p.page : 0;
  const int* row_pages =
      p.tables ? p.tables + static_cast<long>(b) * p.n_tiles + pg0 : nullptr;
  if (p.tables) {
    const int n_pg = nt ? (p1 - 1) / p.page - pg0 + 1 : 0;
    for (int i = tid; i < min(n_pg, kPages); i += kThreads)
      s_pages[i] = __ldg(row_pages + i);
  }
  auto pool_row = [&](int pos) -> long {
    if (!p.tables) return static_cast<long>(b) * p.S + pos;
    const int i = pos / p.page - pg0;
    return static_cast<long>(i < kPages ? s_pages[i] : __ldg(row_pages + i))
               * p.page + pos % p.page;
  };
  auto issue = [&](int it) {
    if (it < nt) {
      unsigned char* kt = smem + (it % kStages) * C::kStage;
      unsigned char* vt = kt + C::kKBytes;
      const int tp0 = p0 + it * kTile;
      for (int c = tid; c < kTile * C::kChunks; c += kThreads) {
        const int r = c / C::kChunks, col = c % C::kChunks;
        const int pos = tp0 + r;
        const bool ok = pos < p1;
        const long off = (ok ? (pool_row(pos) * F + h * D) * sizeof(T) : 0)
                         + col * 16;
        cp_async16(kt + r * C::kKStride + col * 16, p.k + off, ok);
        cp_async16(vt + r * C::kVStride + col * 16, p.v + off, ok);
      }
      if constexpr (kInt8) {
        // thread tid < 64: the k scale of position tid; else its v scale
        // (2-byte values strided by Hkv: the aligned word around each)
        const int pos = tp0 + (tid & (kTile - 1));
        const bool ok = pos < p1;
        const uintptr_t a = reinterpret_cast<uintptr_t>(
            (tid < kTile ? p.ks : p.vs) + (ok ? pool_row(pos) * p.Hkv + h
                                              : 0));
        unsigned char* sc = vt + C::kVBytes;
        cp_async4(sc + 4 * tid, reinterpret_cast<const void*>(a & ~3ull),
                  ok);
        sc[4 * kThreads + tid] = static_cast<unsigned char>((a >> 1) & 1);
      }
    }
    cp_async_commit();
  };
  // the scale of `key` (k: words 0-63, v: 64-127) of a landed tile
  auto scale_at = [](const unsigned char* sc, int key) -> float {
    const uint32_t w = reinterpret_cast<const uint32_t*>(sc)[key];
    return __uint_as_float(sc[4 * kThreads + key] ? (w & 0xffff0000u)
                                                  : (w << 16));
  };

  float o[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  if (p.tables) __syncthreads();   // s_pages
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(it + kStages - 1);

    const unsigned char* kt = smem + (it % kStages) * C::kStage;
    const unsigned char* vt = kt + C::kKBytes;
    const unsigned char* scs = vt + C::kVBytes;
    const int key0 = kw * KW;

    // S = Q K^T over this warp's KW keys
    float sc[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      sc[f][0] = sc[f][1] = sc[f][2] = sc[f][3] = 0.f;
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const unsigned char* row = kt + (key0 + f * 8 + g) * C::kKStride;
        if constexpr (kInt8) {
          const uint32_t u =
              *reinterpret_cast<const uint32_t*>(row + 16 * s + 4 * t)
              ^ kFlip;
          mma_16816(sc[f], qa[s], codes_pair(u, 0), codes_pair(u, 1));
        } else {
          const uint2 w =
              *reinterpret_cast<const uint2*>(row + 2 * (16 * s + 4 * t));
          mma_16816(sc[f], qa[s], w.x, w.y);
        }
      }
    }

    // scale, mask on edge tiles, online softmax per row
    const int tp0 = p0 + it * kTile;
    const bool is_edge = tp0 + kTile > edge;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + f * 8 + 2 * t + (e & 1);
        float x = sc[f][e] * p.scale;
        if constexpr (kInt8) x *= scale_at(scs, key);
        if (is_edge && tp0 + key >= lim[e >> 1]) x = kNegInf;
        sc[f][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      alpha[hf] = m[hf] == kNegInf ? 0.f : __expf(m[hf] - m_new);
      m[hf] = m_new;
      l[hf] *= alpha[hf];
    }
    uint32_t pa[NF / 2][4];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float pw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const float x = sc[f][e];
        const float pe = (is_edge && x == kNegInf) ? 0.f
                                                   : __expf(x - m[hf]);
        l[hf] += pe;
        pw[e] = kInt8 ? pe * scale_at(scs, kTile + key0 + f * 8 + 2 * t
                                               + (e & 1))
                      : pe;
      }
      // P's A fragment: keys 2t, 2t+1 of n-fragment 2j, then of 2j + 1
      pa[f / 2][(f & 1) * 2] = pack_f32(pw[0], pw[1]);
      pa[f / 2][(f & 1) * 2 + 1] = pack_f32(pw[2], pw[3]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: keys 2t, 2t+1, 2t+8, 2t+9 of each 16-key step, columns
    // 4g .. 4g+3 of each 32-wide group (n-fragment j <- column 4g + j)
#pragma unroll
    for (int j = 0; j < NF / 2; ++j) {
      const unsigned char* r0 = vt + (key0 + 16 * j + 2 * t) * C::kVStride;
      const unsigned char* r1 = r0 + C::kVStride;
      const unsigned char* r2 = r0 + 8 * C::kVStride;
      const unsigned char* r3 = r2 + C::kVStride;
#pragma unroll
      for (int dg = 0; dg < D / 32; ++dg) {
        const int col = (32 * dg + 4 * g) * static_cast<int>(sizeof(T));
        if constexpr (kInt8) {
          const uint32_t w0 =
              *reinterpret_cast<const uint32_t*>(r0 + col) ^ kFlip;
          const uint32_t w1 =
              *reinterpret_cast<const uint32_t*>(r1 + col) ^ kFlip;
          const uint32_t w2 =
              *reinterpret_cast<const uint32_t*>(r2 + col) ^ kFlip;
          const uint32_t w3 =
              *reinterpret_cast<const uint32_t*>(r3 + col) ^ kFlip;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_16816(o[4 * dg + i], pa[j], codes_bf16(w0, w1, i),
                      codes_bf16(w2, w3, i));
        } else {
          const uint2 w0 = *reinterpret_cast<const uint2*>(r0 + col);
          const uint2 w1 = *reinterpret_cast<const uint2*>(r1 + col);
          const uint2 w2 = *reinterpret_cast<const uint2*>(r2 + col);
          const uint2 w3 = *reinterpret_cast<const uint2*>(r3 + col);
          mma_16816(o[4 * dg], pa[j], __byte_perm(w0.x, w1.x, 0x5410),
                    __byte_perm(w2.x, w3.x, 0x5410));
          mma_16816(o[4 * dg + 1], pa[j], __byte_perm(w0.x, w1.x, 0x7632),
                    __byte_perm(w2.x, w3.x, 0x7632));
          mma_16816(o[4 * dg + 2], pa[j], __byte_perm(w0.y, w1.y, 0x5410),
                    __byte_perm(w2.y, w3.y, 0x5410));
          mma_16816(o[4 * dg + 3], pa[j], __byte_perm(w0.y, w1.y, 0x7632),
                    __byte_perm(w2.y, w3.y, 0x7632));
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // merge the KS warps of each m-tile through shared memory
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
  float* mo = reinterpret_cast<float*>(smem);       // [4][16][D]
  float* mm = mo + kWarps * 16 * D;                 // [4][16]
  float* ml = mm + kWarps * 16;                     // [4][16]
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = 32 * (n / 4) + 8 * t + n % 4;     // columns 2t, 2t + 1
    float* r0 = mo + (warp * 16 + g) * D;
    r0[d] = o[n][0];
    r0[d + 4] = o[n][1];
    r0[8 * D + d] = o[n][2];
    r0[8 * D + d + 4] = o[n][3];
  }
  if (t == 0) {
    mm[warp * 16 + g] = m[0];
    mm[warp * 16 + g + 8] = m[1];
    ml[warp * 16 + g] = l[0];
    ml[warp * 16 + g + 8] = l[1];
  }
  __syncthreads();

  const long gid = (static_cast<long>(b) * p.Hkv + h) * p.groups + grp;
  const int rows_g = p.QL * G;
  auto out_at = [&](int r, int d) -> __nv_bfloat16* {
    return p.out + ((static_cast<long>(b) * p.W + qi0 + r / G) * p.Hq
                    + h * G + r % G) * D + d;
  };
  auto part_row = [&](int s, int r) -> long {
    return ((static_cast<long>(s) * p.B * p.Hkv * p.groups) + gid) * rows_g
           + r;
  };
  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int w0 = (r / 16) * KS, rr = r % 16;
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < KS; ++k) mx = fmaxf(mx, mm[(w0 + k) * 16 + rr]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float mw = mm[(w0 + k) * 16 + rr];
      const float wt = mw == kNegInf ? 0.f : __expf(mw - mx);
      lsum = fmaf(ml[(w0 + k) * 16 + rr], wt, lsum);
      a = fmaf(mo[((w0 + k) * 16 + rr) * D + d], wt, a);
    }
    if (n_live <= 1) {
      *out_at(r, d) = __float2bfloat16_rn(a * (1.f / fmaxf(lsum, 1e-30f)));
    } else {
      const long pr = part_row(split, r);
      p.part[pr * D + d] = a;
      if (d == 0) {
        p.part_ml[pr * 2] = mx;
        p.part_ml[pr * 2 + 1] = lsum;
      }
    }
  }
  if (n_live <= 1) return;

  // the last live block of (row, kv head, group) merges in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.tickets + gid, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // each (split, row)'s m and l, loaded in one round
  float* wm = reinterpret_cast<float*>(smem);       // [n_live][64]
  float* wl = wm + n_live * kMaxRows;               // [n_live][64]
  float* inv = wl + n_live * kMaxRows;              // [64]
  for (int i = tid; i < n_live * nrows; i += kThreads) {
    const int s = i / nrows, r = i % nrows;
    const float2 x = __ldcg(reinterpret_cast<const float2*>(
        p.part_ml + part_row(s, r) * 2));
    wm[s * kMaxRows + r] = x.x;
    wl[s * kMaxRows + r] = x.y;
  }
  __syncthreads();
  // per row: the weight of each split and 1 / l
  if (tid < nrows) {
    float mx = kNegInf;
    for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, wm[s * kMaxRows + tid]);
    float lsum = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float ms = wm[s * kMaxRows + tid];
      const float wt = ms == kNegInf ? 0.f : __expf(ms - mx);
      lsum = fmaf(wl[s * kMaxRows + tid], wt, lsum);
      wm[s * kMaxRows + tid] = wt;
    }
    inv[tid] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  // acc in split order, 4 columns a load, every load of a split in flight
  // together (a split's rows are contiguous in the scratch)
  constexpr int kVec = MT * 16 * D / 4 / kThreads;
  const int n4 = nrows * D / 4;
  float4 acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int s = 0; s < n_live; ++s) {
    const float4* src =
        reinterpret_cast<const float4*>(p.part + part_row(s, 0) * D);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = tid + k * kThreads;
      if (i < n4) {
        const float4 x = __ldcg(src + i);
        const float wt = wm[s * kMaxRows + 4 * i / D];
        acc[k].x = fmaf(x.x, wt, acc[k].x);
        acc[k].y = fmaf(x.y, wt, acc[k].y);
        acc[k].z = fmaf(x.z, wt, acc[k].z);
        acc[k].w = fmaf(x.w, wt, acc[k].w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = tid + k * kThreads;
    if (i < n4) {
      const int r = 4 * i / D, d = 4 * i % D;
      const float f = inv[r];
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out_at(r, d));
      dst[0] = __floats2bfloat162_rn(acc[k].x * f, acc[k].y * f);
      dst[1] = __floats2bfloat162_rn(acc[k].z * f, acc[k].w * f);
    }
  }
  if (tid == 0) p.tickets[gid] = 0;
}

template <int D, int MT, typename T>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Cfg<D, T>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn_kernel<D, MT, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  decode_attn_kernel<D, MT, T>
      <<<dim3(p.Hkv, p.B, p.groups * p.splits), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_mt(const Params& p, cudaStream_t stream) {
  const int rows = p.QL * p.G;
  if (rows <= 16) return launch<D, 1, T>(p, stream);
  if (rows <= 32) return launch<D, 2, T>(p, stream);
  return launch<D, 4, T>(p, stream);
}

template <typename T>
int launch_d(int D, const Params& p, cudaStream_t stream) {
  if (D == 32) return launch_mt<32, T>(p, stream);
  if (D == 64) return launch_mt<64, T>(p, stream);
  if (D == 128) return launch_mt<128, T>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// part: (D + 2) * splits * B * Hkv * groups * QL * G floats of scratch and
// tickets: B * Hkv * groups zeroed ints, both only read when splits > 1.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs,
                           const void* starts, const void* ends,
                           const void* tables, void* out, void* part,
                           void* tickets, int B, int W, int Hq, int Hkv,
                           int D, int S, int n_tiles, int page, int int8,
                           int QL, int splits, float scale, void* stream) {
  if (B == 0 || W == 0 || Hkv == 0) return 0;
  const int G = Hkv ? Hq / Hkv : 0;
  const int groups = QL > 0 ? (W + QL - 1) / QL : 0;
  if (Hq % Hkv || QL <= 0 || QL * G > kMaxRows || splits <= 0 ||
      splits > kMaxSplits ||
      (tables && page <= 0) || (splits > 1 && (!part || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.ks = static_cast<const __nv_bfloat16*>(ks);
  p.vs = static_cast<const __nv_bfloat16*>(vs);
  p.starts = static_cast<const int*>(starts);
  p.ends = static_cast<const int*>(ends);
  p.tables = static_cast<const int*>(tables);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(part);
  p.part_ml = p.part ? p.part + static_cast<long>(splits) * B * Hkv * groups
                                    * QL * G * D
                     : nullptr;
  p.tickets = static_cast<int*>(tickets);
  p.B = B; p.W = W; p.Hq = Hq; p.Hkv = Hkv; p.S = S; p.n_tiles = n_tiles;
  p.page = page; p.G = G; p.QL = QL; p.groups = groups; p.splits = splits;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? launch_d<int8_t>(D, p, s) : launch_d<__nv_bfloat16>(D, p, s);
}
