// Flash-attention backward for Hopper (sm_90a): K4 (dq) and K5 (dk, dv).
//
// Replaces: seedx_tpu/ops/flash_attention.py `_flash_bwd_dq_kernel` (K4)
// and `_flash_bwd_dkv_kernel` (K5), the Pallas TPU kernels reached through
// `_flash_backward_local` from the custom VJP of `flash_attention`.  Same
// contract: q / dout [B, Sq, H, D], k / v [B, Skv, H, D] (contiguous,
// bf16, D 64 or 128); lse and delta = rowsum(dout * out) fp32 [B, H, Sq]
// (delta is computed by the caller, outside the kernels, as on the TPU);
// each batch row attends to the kv window [starts[b], ends[b]), with an
// optional causal mask where q row i sits at kv position q_offset + i.  The
// probabilities are recomputed as p = exp(s * scale - lse) under an
// EXPLICIT mask: a fully masked row carries lse = NEG_INF, and
// exp(NEG_INF - NEG_INF) would be 1.  ds = p * (dp - delta) * scale;
// dq = ds K (K4), dk = ds^T Q and dv = p^T dout (K5).  Outputs bf16.
//
// What bounds it on the H100: tensor-core math.  The training shapes (880
// or 260 tokens, 40 heads, D 128) are far above the bf16 ridge (~295 FLOP
// per HBM byte); like the forward, the kernels keep every [Sq, Skv] tile
// of scores and probabilities out of device memory.
//
// Design: K1's building blocks (flash_common.cuh): tiles in the 128-byte
// swizzle fed by a 2-stage `cp.async` ring with one barrier per tile, and
// every product a `wgmma` through `score_tile` (A and B K-major in shared
// memory) or `pv_tile` (A from registers, B MN-major in shared memory).
// Blocks run in parallel, so the TPU's sequential grid axis becomes a loop
// inside the block.  The block tile is a template; the wrapper picks it
// (ops/flash_attention.py `bwd_tile_shape`, `BWD_TILES`) and only those
// tiles are built: 64 x 64 for both kernels at D 64 and 128, one
// warpgroup a block at two blocks an SM.  Two warpgroups a block (128 q
// rows / keys) and 128-wide streamed tiles were no faster on the card at
// any main-path shape (flash_sweep.py --bwd, PERF.md).
//   K4: one block per (q tile of BM rows, head, batch row), one warpgroup
//   per 64 rows, Q and dO loaded once; K and V stream through the ring in
//   BN-key tiles, trimmed to the window and, when causal, to the last tile
//   each warpgroup can see.  S = Q K^T and dP = dO V^T are `score_tile`;
//   dS = P (dP - delta) is formed in registers with P = exp2(S c - lse
//   log2 e), c = scale log2 e; dQ += dS K is `pv_tile` with K as the
//   MN-major B operand, exactly as V is in the forward.  The scale of dS
//   is applied once to dQ.
//   K5: one block per (key tile of BN keys, head, batch row), one
//   warpgroup per 64 keys, K and V loaded once; Q, dO and their rows' lse
//   and delta stream through the ring in BM-row tiles (lse / delta in the
//   same stage as their Q / dO), from the first tile whose rows can see the
//   warpgroup's keys (causal).  S^T = K Q^T and dP^T = V dO^T are
//   `score_tile` with K and V as the A operands, so P^T and dS^T come out
//   of the accumulators with the keys as rows: the A fragments of dV +=
//   P^T dO and dK += dS^T Q (`pv_tile`, dO and Q MN-major).  lse / delta
//   are read along the accumulator's columns from shared memory.  Keys
//   outside the window, and blocks no q row sees, write zero grads (the
//   outputs are torch.empty).
//   Both: the mask runs only on tiles that straddle start, end, Sq, Skv or
//   the causal diagonal of the warpgroup's rows; a tile is interior only
//   if every (row, key) pair of the warpgroup is live, so interior tiles
//   hold no dead row and run one FFMA and one ex2 a score.  On edge tiles
//   masked pairs get p = 0 by select, so a dead row's NEG_INF lse (whose
//   scaled value overflows) never reaches an output.  Under a causal mask
//   the blocks with the most tiles start first: the tile index is the
//   grid's slowest axis, reversed for K4 (its last q tile sees the most
//   keys) and in order for K5 (key tile 0 is seen by the most rows).
// Each output tile has a single writer and there are no atomics, so two
// runs give the same bits.  Rounding: P and dS enter the tensor cores as
// bf16 (the TPU kernel and the plain version keep them fp32); outputs are
// rounded once to bf16.
//
// What was hard, and where it is handled:
//   - The roles of the tiles change between the two kernels (K and V as A
//     operands in K5; K, dO and Q as MN-major B operands); every product
//     is one of the two forms `flash_wgmma_tile_debug` checks on the card,
//     with the row count of each operand's tile as the atom stride.
//   - wgmma under a data-dependent branch is serialized by ptxas (C7520):
//     the products are issued the same way on every tile, and the edge
//     mask is a branch of the register pass between them.
//   - Registers: K5 holds dK and dV (D / 2 each a thread) beside S^T and
//     dP^T (BM / 2 each): 64 + 64 + 32 + 32 at D 128 and BM 64, which
//     ptxas fits in 248 registers with no spills (K4: 211; at D 64, 188
//     and 159).

#include "flash_common.cuh"

namespace {

// 4-byte copy (lse / delta); nothing read and zero written when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

// dq / dk / dv rows of this thread (`row`, `row + 8`) times `mul` in bf16;
// rows at or past `rows` are not written
template <int D>
__device__ __forceinline__ void store_grad(const float (&acc)[D / 8][4],
                                           float mul, int row, int t,
                                           int rows, long rs,
                                           __nv_bfloat16* __restrict__ out) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rw = row + 8 * r;
    if (rw >= rows) continue;
    __nv_bfloat16* orow = out + rw * rs;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[d][2 * r] * mul,
                                acc[d][2 * r + 1] * mul);
  }
}

// ---- K4: dq ---------------------------------------------------------------

template <int D, int BM, int BN>
constexpr int dq_smem_bytes() {
  // align slack, Q and dO, the 2-stage K / V ring
  return 1024 + 2 * BM * D * 2 + 4 * BN * D * 2;
}

// dS = P (dP - delta) for this thread's two rows (s[nb][2r + e] is row r,
// at kv position qp0 + 8 r), left in s: P = exp2(s c - lse2) where every
// pair of the tile is live, else under the window / causal / Sq mask
template <int NB>
__device__ __forceinline__ void ds_rows(float (&s)[NB][4],
                                        const float (&dp)[NB][4], bool mask,
                                        int n0, int t, int start, int end,
                                        int causal, int qp0, int row0,
                                        int Sq, const float (&lse2)[2],
                                        const float (&dl)[2], float c) {
  if (mask) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int kpos = n0 + nb * 8 + 2 * t + (i & 1);
        const bool ok = row0 + 8 * r < Sq && kpos >= start && kpos < end &&
                        (!causal || qp0 + 8 * r >= kpos);
        const float p = ok ? ex2(fmaf(s[nb][i], c, -lse2[r])) : 0.f;
        s[nb][i] = p * (dp[nb][i] - dl[r]);
      }
  } else {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        s[nb][i] = ex2(fmaf(s[nb][i], c, -lse2[r])) * (dp[nb][i] - dl[r]);
      }
  }
}

template <int D, int BM, int BN>
__global__ void __launch_bounds__(BM * 2, 1)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ starts,
                    const int* __restrict__ ends,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                    int q_offset, int causal, float scale_log2, float scale) {
  constexpr int NT = BM * 2;                  // BM / 64 warpgroups
  constexpr int TILE = BN * D * 2;            // bytes of one K or V tile
  constexpr int NB = BN / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = aligned_base(smem_raw);
  const uint32_t sdO = sQ + BM * D * 2;
  const uint32_t sK = sdO + BM * D * 2;       // stage st at sK + st * TILE
  const uint32_t sV = sK + 2 * TILE;

  // the q tile is the slowest grid axis, last tile first
  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup index, broadcast so the compiler knows it is uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = iq * BM;
  const long rs = static_cast<long>(H) * D;   // elements per sequence step
  const long qoff = static_cast<long>(b) * Sq * rs + h * D;
  const __nv_bfloat16* kb = k + static_cast<long>(b) * Skv * rs + h * D;
  const __nv_bfloat16* vb = v + static_cast<long>(b) * Skv * rs + h * D;
  const int start = max(starts[b], 0);
  const int end = min(ends[b], Skv);

  const int k_begin = start / BN;
  int k_end = (end + BN - 1) / BN;
  if (causal) {
    const int last = q_offset + min(m0 + BM, Sq);   // one past the last row
    k_end = min(k_end, last <= 0 ? 0 : (last + BN - 1) / BN);
  }
  const int wg_row0 = m0 + wg * 64;                 // warpgroup's first row
  // the tiles this warpgroup sees: up to the last whose first key is at or
  // before its last row (causal); none if its rows all lie past Sq
  int k_end_wg = k_end;
  if (causal) {
    const int x = q_offset + wg_row0 + 63;
    k_end_wg = x < 0 ? k_begin : min(k_end, x / BN + 1);
  }
  if (wg_row0 >= Sq) k_end_wg = k_begin;
  auto edge = [&](int n0) {
    return n0 < start || n0 + BN > end || wg_row0 + 64 > Sq ||
           (causal && n0 + BN - 1 > q_offset + wg_row0);
  };

  load_tile<BM, D, NT>(sQ, q + qoff + m0 * rs, rs, Sq - m0, tid);
  load_tile<BM, D, NT>(sdO, dout + qoff + m0 * rs, rs, Sq - m0, tid);
  if (k_begin < k_end) {
    const int n0 = k_begin * BN;
    load_tile<BN, D, NT>(sK, kb + n0 * rs, rs, Skv - n0, tid);
    load_tile<BN, D, NT>(sV, vb + n0 * rs, rs, Skv - n0, tid);
  }
  cp_async_commit();

  // this thread's rows row0 and row0 + 8 (kv positions qp0, qp0 + 8):
  // lse in log2 units and delta
  const int row0 = wg_row0 + warp * 16 + g;
  const int qp0 = q_offset + row0;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long at = (static_cast<long>(b) * H + h) * Sq + row;
    lse2[r] = row < Sq ? lse[at] * kLog2e : 0.f;
    dl[r] = row < Sq ? delta[at] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  const uint32_t sQw = sQ + wg * 64 * 128;          // its slice of each atom
  const uint32_t sdOw = sdO + wg * 64 * 128;
  cp_async_wait_all();
  __syncthreads();                                  // Q, dO and tile 0 landed

  // Iteration j: tile j+1 is copied into the other stage while tile j is
  // computed: S, dP, dS, dQ += dS K; the barrier at the end means tile j+1
  // landed and every warp is done with tile j.
  for (int j = k_begin; j < k_end; ++j) {
    const int st = (j - k_begin) & 1;
    if (j + 1 < k_end) {
      const int n1 = (j + 1) * BN;
      load_tile<BN, D, NT>(sK + (st ^ 1) * TILE, kb + n1 * rs, rs, Skv - n1,
                           tid);
      load_tile<BN, D, NT>(sV + (st ^ 1) * TILE, vb + n1 * rs, rs, Skv - n1,
                           tid);
    }
    cp_async_commit();
    if (j < k_end_wg) {
      const int n0 = j * BN;
      float s[NB][4], dp[NB][4];
      score_tile<D, BM, BN>(s, sQw, sK + st * TILE);
      score_tile<D, BM, BN>(dp, sdOw, sV + st * TILE);
      ds_rows(s, dp, edge(n0), n0, t, start, end, causal, qp0, row0, Sq,
              lse2, dl, scale_log2);
      uint32_t a[NB / 2][4];
      p_fragments(s, a);
      pv_tile<D, BN>(acc, a, sK + st * TILE);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  store_grad<D>(acc, scale, row0, t, Sq, rs, dq + qoff);
}

// ---- K5: dk, dv -------------------------------------------------------------

template <int D, int BN, int BM>
constexpr int dkv_smem_bytes() {
  // align slack, K and V, the 2-stage Q / dO ring, lse / delta per stage
  return 1024 + 2 * BN * D * 2 + 4 * BM * D * 2 + 4 * BM * 4;
}

// lse and delta of q rows [m0, m0 + BM) into one ring stage; rows at or
// past `valid` are zero
template <int BM, int NT>
__device__ __forceinline__ void load_rowstats(uint32_t sl, uint32_t sd,
                                              const float* l, const float* dl,
                                              int valid, int tid) {
#pragma unroll
  for (int c0 = 0; c0 < 2 * BM; c0 += NT) {
    const int c = c0 + tid;
    if (c >= 2 * BM) break;
    const int i = c % BM;
    const bool ok = i < valid;
    if (c < BM)
      cp_async4(sl + i * 4, ok ? l + i : l, ok);
    else
      cp_async4(sd + i * 4, ok ? dl + i : dl, ok);
  }
}

// P^T and dS^T = P^T (dP^T - delta) for this thread's two keys (st[nb][2r +
// e] is key r, q row nb * 8 + 2 t + e of the tile), P^T left in st and
// dS^T in dpt; lse / delta of the tile's rows from shared memory
template <int NB>
__device__ __forceinline__ void dst_cols(float (&st)[NB][4],
                                         float (&dpt)[NB][4], bool mask,
                                         const float* ls, const float* ds,
                                         int m0, int t, int key0, int start,
                                         int end, int causal, int q_offset,
                                         int Sq, float c) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int col = nb * 8 + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(ls + col);
    const float2 d = *reinterpret_cast<const float2*>(ds + col);
    const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
    const float dl[2] = {d.x, d.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = i & 1;
      float p;
      if (mask) {
        const int key = key0 + 8 * (i >> 1);
        const int row = m0 + col + e;
        const bool ok = key >= start && key < end && row < Sq &&
                        (!causal || q_offset + row >= key);
        p = ok ? ex2(fmaf(st[nb][i], c, -l2[e])) : 0.f;
      } else {
        p = ex2(fmaf(st[nb][i], c, -l2[e]));
      }
      st[nb][i] = p;
      dpt[nb][i] = p * (dpt[nb][i] - dl[e]);
    }
  }
}

template <int D, int BN, int BM>
__global__ void __launch_bounds__(BN * 2, 1)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                     int q_offset, int causal, float scale_log2,
                     float scale) {
  constexpr int NT = BN * 2;                  // BN / 64 warpgroups
  constexpr int TILE = BM * D * 2;            // bytes of one Q or dO tile
  constexpr int NB = BM / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = aligned_base(smem_raw);
  const uint32_t sV = sK + BN * D * 2;
  const uint32_t sQ = sV + BN * D * 2;        // stage st at sQ + st * TILE
  const uint32_t sdO = sQ + 2 * TILE;
  const uint32_t sL = sdO + 2 * TILE;         // stage st at sL + st * BM * 4
  const uint32_t sD = sL + 2 * BM * 4;
  // the same lse / delta through generic pointers, for the register pass
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const float* lsh = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const float* dsh = reinterpret_cast<const float*>(smem_raw + (sD - raw));

  // the key tile is the slowest grid axis, tile 0 first
  const int h = blockIdx.x, b = blockIdx.y, ik = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = ik * BN;
  const long rs = static_cast<long>(H) * D;
  const __nv_bfloat16* qb = q + static_cast<long>(b) * Sq * rs + h * D;
  const __nv_bfloat16* dob = dout + static_cast<long>(b) * Sq * rs + h * D;
  const long koff = static_cast<long>(b) * Skv * rs + h * D;
  const float* lrow = lse + (static_cast<long>(b) * H + h) * Sq;
  const float* drow = delta + (static_cast<long>(b) * H + h) * Sq;
  const int start = max(starts[b], 0);
  const int end = min(ends[b], Skv);

  const int n_q = (Sq + BM - 1) / BM;
  // first q tile whose rows can see a key of the block (causal); none if
  // no key of the block lies in the window
  int i_begin = causal ? max(n0 - q_offset, 0) / BM : 0;
  if (n0 >= end || n0 + BN <= start) i_begin = n_q;
  const int wg_key0 = n0 + wg * 64;                 // warpgroup's first key
  int i_begin_wg = max(i_begin, causal ? max(wg_key0 - q_offset, 0) / BM : 0);
  if (wg_key0 >= end || wg_key0 + 64 <= start) i_begin_wg = n_q;
  auto edge = [&](int m0) {
    return wg_key0 < start || wg_key0 + 64 > end || m0 + BM > Sq ||
           (causal && q_offset + m0 < wg_key0 + 63);
  };

  if (i_begin < n_q) {
    load_tile<BN, D, NT>(sK, k + koff + n0 * rs, rs, Skv - n0, tid);
    load_tile<BN, D, NT>(sV, v + koff + n0 * rs, rs, Skv - n0, tid);
    const int m0 = i_begin * BM;
    load_tile<BM, D, NT>(sQ, qb + m0 * rs, rs, Sq - m0, tid);
    load_tile<BM, D, NT>(sdO, dob + m0 * rs, rs, Sq - m0, tid);
    load_rowstats<BM, NT>(sL, sD, lrow + m0, drow + m0, Sq - m0, tid);
  }
  cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
    acc_k[d][0] = acc_k[d][1] = acc_k[d][2] = acc_k[d][3] = acc_v[d][0] =
        acc_v[d][1] = acc_v[d][2] = acc_v[d][3] = 0.f;
  const int key0 = wg_key0 + warp * 16 + g;         // this thread's keys
  const uint32_t sKw = sK + wg * 64 * 128;          // its slice of each atom
  const uint32_t sVw = sV + wg * 64 * 128;
  cp_async_wait_all();
  __syncthreads();                                  // K, V and tile 0 landed

  // Iteration i: q tile i+1 is copied into the other stage while tile i
  // is computed: S^T, dP^T, P^T and dS^T, dV += P^T dO, dK += dS^T Q
  for (int i = i_begin; i < n_q; ++i) {
    const int st = (i - i_begin) & 1;
    if (i + 1 < n_q) {
      const int m1 = (i + 1) * BM;
      load_tile<BM, D, NT>(sQ + (st ^ 1) * TILE, qb + m1 * rs, rs, Sq - m1,
                           tid);
      load_tile<BM, D, NT>(sdO + (st ^ 1) * TILE, dob + m1 * rs, rs,
                           Sq - m1, tid);
      load_rowstats<BM, NT>(sL + (st ^ 1) * BM * 4, sD + (st ^ 1) * BM * 4,
                            lrow + m1, drow + m1, Sq - m1, tid);
    }
    cp_async_commit();
    if (i >= i_begin_wg) {
      const int m0 = i * BM;
      float sT[NB][4], dpT[NB][4];
      score_tile<D, BN, BM>(sT, sKw, sQ + st * TILE);
      score_tile<D, BN, BM>(dpT, sVw, sdO + st * TILE);
      dst_cols(sT, dpT, edge(m0), lsh + st * BM, dsh + st * BM, m0, t, key0,
               start, end, causal, q_offset, Sq, scale_log2);
      uint32_t a[NB / 2][4];
      p_fragments(sT, a);
      pv_tile<D, BM>(acc_v, a, sdO + st * TILE);
      p_fragments(dpT, a);
      pv_tile<D, BM>(acc_k, a, sQ + st * TILE);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  store_grad<D>(acc_k, scale, key0, t, Skv, rs, dk + koff);
  store_grad<D>(acc_v, 1.f, key0, t, Skv, rs, dv + koff);
}

template <int D, int BM, int BN>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* starts,
              const int* ends, void* dq, int B, int Sq, int Skv, int H,
              int q_offset, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D, BM, BN>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B, (Sq + BM - 1) / BM);
  flash_bwd_dq_kernel<D, BM, BN><<<grid, BM * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, starts, ends,
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, q_offset, causal,
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BM, int BN>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* starts,
               const int* ends, void* dk, void* dv, int B, int Sq, int Skv,
               int H, int q_offset, int causal, float scale,
               cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D, BN, BM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, BN, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B, (Skv + BN - 1) / BN);
  flash_bwd_dkv_kernel<D, BN, BM><<<grid, BN * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, starts, ends,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Skv, H, q_offset, causal, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// block_m / block_n: the block tile (q rows, keys) of ops/flash_attention.py
// BWD_TILES, one table per kernel
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* starts,
                                 const void* ends, void* dq, int B, int Sq,
                                 int Skv, int H, int D, int q_offset,
                                 int causal, float scale, int block_m,
                                 int block_n, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* st = static_cast<const int*>(starts);
  const int* en = static_cast<const int*>(ends);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return 0;
#define DQ_LAUNCH(DD, BMM, BNN)                                             \
  if (D == DD && block_m == BMM && block_n == BNN)                          \
    return launch_dq<DD, BMM, BNN>(q, k, v, dout, l, dl, st, en, dq, B, Sq, \
                                   Skv, H, q_offset, causal, scale, s);
  DQ_LAUNCH(128, 64, 64)
  DQ_LAUNCH(64, 64, 64)
#undef DQ_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* starts,
                                  const void* ends, void* dk, void* dv, int B,
                                  int Sq, int Skv, int H, int D, int q_offset,
                                  int causal, float scale, int block_m,
                                  int block_n, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* st = static_cast<const int*>(starts);
  const int* en = static_cast<const int*>(ends);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Skv == 0 || H == 0) return 0;
#define DKV_LAUNCH(DD, BMM, BNN)                                            \
  if (D == DD && block_m == BMM && block_n == BNN)                          \
    return launch_dkv<DD, BMM, BNN>(q, k, v, dout, l, dl, st, en, dk, dv, B, \
                                    Sq, Skv, H, q_offset, causal, scale, s);
  DKV_LAUNCH(128, 64, 64)
  DKV_LAUNCH(64, 64, 64)
#undef DKV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
