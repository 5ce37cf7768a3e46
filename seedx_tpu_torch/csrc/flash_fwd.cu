// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 online softmax.
//
// Replaces: seedx_tpu/ops/flash_attention.py `_flash_fwd_kernel` (the
// Pallas TPU kernel reached through `_flash_forward_local` /
// `flash_attention`).  Same contract: q [B, Sq, H, D], k/v [B, Skv, H, D]
// (contiguous, bf16, D 64 or 128); each batch row attends to the kv window
// [starts[b], ends[b]); optional causal mask where q row i sits at kv
// position q_offset + i; out [B, Sq, H, D] bf16 and the row logsumexp
// lse [B, H, Sq] fp32 in natural-log units.  A fully masked row gives zero
// output and lse NEG_INF (the flash backward kernels read both).
//
// What bounds it on the H100: tensor-core math.  The ViT (1024 tokens, 16
// heads), the train step and the 512-token prefill are far above the bf16
// ridge (~295 FLOP per HBM byte), so the kernel keeps the [Sq, Skv] scores
// out of device memory and feeds the tensor cores from shared memory.
//
// Design: one block per (BM-row q tile, head, batch row), one warpgroup per
// 64 q rows, and a loop over BN-key tiles inside the block in place of the
// TPU's sequential grid axis, trimmed to the window and, when causal, to
// the last tile each warpgroup can see.  The wrapper picks the tile from
// the shape (ops/flash_attention.py `tile_shape`): BM 128 / BN 128 for the
// non-causal D 128 ViT, BM 64 / BN 128 for non-causal D 64 (and D 128 where
// 128 rows would leave SMs idle), BM 64 / BN 64 where a causal diagonal
// cuts the tiles.  Only those five (D, BM, BN) kernels are built.
//   - Copies: Q once, then K and V through a 2-stage ring of 16-byte
//     `cp.async` copies, one barrier per tile; rows past Sq / Skv are
//     zero-filled by the src-size operand, so nothing is read out of bounds.
//   - Shared layout: every tile is stored as 64-column atoms of rows x 128 B
//     in the 128-byte swizzle (chunk c of row r at c ^ (r & 7)), the layout
//     the wgmma matrix descriptors read; the cp.async destinations write it
//     directly.  These memory and wgmma helpers live in flash_common.cuh,
//     shared with the backward (flash_bwd.cu).
//   - Products: S = Q K^T is `wgmma m64n{BN}k16` with Q and K from shared
//     memory (both K-major, no transpose).  O += P V is `wgmma m64n{D}k16`
//     with P from registers -- the fp32 S accumulator converted to bf16 in
//     place has the A-fragment layout -- and V [keys, D] from shared memory
//     with the B-transpose bit.
//   - Softmax in log2 units, the running max kept in log2 units; an
//     interior tile costs one FFMA and one ex2 a score; lse = (m2 + log2 l)
//     * ln 2.  The window / causal mask runs only on tiles that straddle
//     start, end, Skv or the diagonal of the warpgroup's rows.
//
// What was hard, and where it is handled:
//   - Descriptors fail silently: a wrong base, LBO / SBO or swizzle mode
//     gives garbage, not an error.  `flash_wgmma_tile_debug` runs one S
//     tile and one P V product through the same helpers, and
//     tests/test_torch_cuda.py holds it to torch.matmul on the card.
//     K-major (Q, K): SBO 1024 B between 8-row groups, the k step moves the
//     start address 32 B inside the swizzled row, the next 64 columns are
//     the next atom.  MN-major (V): SBO 1024 B between 8-key groups, LBO
//     the atom stride between 64-column halves of D.
//   - NEG_INF * scale * log2(e) overflows to -inf, and -inf - -inf is NaN:
//     on an edge tile masked scores are set to the sentinel after scaling,
//     never scaled, and a row whose max is the sentinel is dead (p = 0, lse
//     NEG_INF).  Interior tiles hold no sentinel.
//   - Edge-only masking: a tile is interior only if it is interior for
//     every row of the warpgroup (causal: its last key at or before the
//     warpgroup's first row), so q_offset 512 with Sq 65 and a window start
//     of 300 still mask where they must.
//   - cp.async writes through the generic proxy and wgmma reads through the
//     async proxy: a `fence.proxy.async.shared::cta` after each wait,
//     before the barrier.  The accumulators are pinned around each wgmma
//     issue and wait so the compiler cannot touch them in between.
//   - What did not pay (PERF.md): issuing S of tile j+1 beside P V of
//     tile j so the softmax overlaps it (with the issue under a branch
//     ptxas serializes every wgmma, C7520; issued uniformly it ran
//     slower), Q in registers as the A operand of S, tree-shaped max / sum
//     reductions, three warpgroups a block.  The kernel is bound by issue
//     and latency, not the tensor cores: each tile's S, softmax and P V
//     run in sequence.

#include "flash_common.cuh"

namespace {

// --------------------------------------------------------------- softmax

// One tile of the online softmax for this thread's two rows (kv positions
// qp0 and qp0 + 8; s[nb][2r + e] is row r): update the running max m (log2
// units) and the per-thread partial sum l, leave p in s and return the
// rescale factors of O in alpha.  Interior tiles: p = ex2(s * c - m), one
// FFMA.  Edge tiles: scale, then set masked scores to the sentinel.
template <int NB>
__device__ __forceinline__ void softmax_tile(float (&s)[NB][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool mask, int n0, int t,
                                             int start, int end, int causal,
                                             int qp0, float c) {
  if (mask) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = n0 + nb * 8 + 2 * t + (i & 1);
        const int qp = qp0 + 8 * (i >> 1);
        const bool ok =
            kpos >= start && kpos < end && (!causal || qp >= kpos);
        s[nb][i] = ok ? s[nb][i] * c : kNegInf;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // an interior tile's max is a raw score, still to be scaled
    const float m_new = fmaxf(m[r], mask ? mx : mx * c);
    // sentinel - sentinel is 0 here (alpha 1 on a still-dead row, whose O
    // and l are 0); sentinel - finite underflows ex2 to 0
    alpha[r] = ex2(m[r] - m_new);
    float sum = 0.f;
    if (mask) {
      const bool dead = m_new == kNegInf;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nb][2 * r + e];
          x = dead ? 0.f : ex2(x - m_new);
          sum += x;
        }
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nb][2 * r + e];
          x = ex2(fmaf(x, c, -m_new));
          sum += x;
        }
    }
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 8][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    o[d][0] *= alpha[0];
    o[d][1] *= alpha[0];
    o[d][2] *= alpha[1];
    o[d][3] *= alpha[1];
  }
}

// ---------------------------------------------------------------- kernel

// O / l in bf16 and lse for this thread's rows `row` and `row + 8`
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4],
                                           const float (&m)[2],
                                           const float (&l_part)[2], int row,
                                           int t, int Sq, int H, int b, int h,
                                           __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ lse) {
  const long rs = static_cast<long>(H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int rw = row + 8 * r;
    if (rw >= Sq) continue;
    const float inv = l == 0.f ? 1.f : 1.f / l;
    __nv_bfloat16* orow = out + (static_cast<long>(b) * Sq + rw) * rs + h * D;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    if (t == 0)
      lse[(static_cast<long>(b) * H + h) * Sq + rw] =
          l == 0.f ? kNegInf : m[r] * kLn2 + logf(l);
  }
}

template <int D, int BM, int BN>
constexpr int smem_bytes() {
  // align slack, Q, the 2-stage K / V ring
  return 1024 + BM * D * 2 + 4 * BN * D * 2;
}

template <int D, int BM, int BN>
__global__ void __launch_bounds__(BM * 2, 1)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Skv, int H, int q_offset, int causal,
                 float scale_log2) {
  constexpr int NT = BM * 2;                  // BM / 64 warpgroups
  constexpr int TILE = BN * D * 2;            // bytes of one K or V tile
  constexpr int NB = BN / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = aligned_base(smem_raw);
  const uint32_t sK = sQ + BM * D * 2;        // stage st at sK + st * TILE
  const uint32_t sV = sK + 2 * TILE;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup index, broadcast so the compiler knows it is uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = iq * BM;
  const long rs = static_cast<long>(H) * D;   // elements per sequence step
  const __nv_bfloat16* qb = q + static_cast<long>(b) * Sq * rs + h * D;
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
    return n0 < start || n0 + BN > end ||
           (causal && n0 + BN - 1 > q_offset + wg_row0);
  };

  load_tile<BM, D, NT>(sQ, qb + m0 * rs, rs, Sq - m0, tid);
  if (k_begin < k_end) {
    const int n0 = k_begin * BN;
    load_tile<BN, D, NT>(sK, kb + n0 * rs, rs, Skv - n0, tid);
    load_tile<BN, D, NT>(sV, vb + n0 * rs, rs, Skv - n0, tid);
  }
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int qp0 = q_offset + wg_row0 + warp * 16 + g;
  const uint32_t sQw = sQ + wg * 64 * 128;          // its slice of each atom
  cp_async_wait_all();
  __syncthreads();                                  // Q and tile 0 landed

  // Iteration j: tile j+1 is copied into the other stage while tile j is
  // computed: S, softmax, O rescale, P V; the barrier at the end means
  // tile j+1 landed and every warp is done with tile j.
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
      float s[NB][4];
      score_tile<D, BM, BN>(s, sQw, sK + st * TILE);
      float alpha[2];
      softmax_tile(s, m_run, l_run, alpha, edge(n0), n0, t, start, end,
                   causal, qp0, scale_log2);
      rescale<D>(o, alpha);
      uint32_t p[NB / 2][4];
      p_fragments(s, p);
      pv_tile<D, BN>(o, p, sV + st * TILE);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  store_rows<D>(o, m_run, l_run, wg_row0 + warp * 16 + g, t, Sq, H, b, h,
                out, lse);
}

template <int D, int BM, int BN>
int launch(const void* q, const void* k, const void* v, const int* starts,
           const int* ends, void* out, float* lse, int B, int Sq, int Skv,
           int H, int q_offset, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, BM, BN>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_fwd_kernel<D, BM, BN><<<grid, BM * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), starts, ends,
      static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, q_offset, causal,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// One 64 x 64 S tile and one P V product through the kernel's descriptors
// and fragment layouts: s = q k^T (fp32), o = bf16(s) v (fp32).  q, k, v
// [64, D] bf16; s [64, 64], o [64, D] fp32.  A check of the wgmma
// descriptors; nothing on the path calls it.
template <int D>
__global__ void __launch_bounds__(128)
wgmma_tile_debug_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        float* __restrict__ s_out, float* __restrict__ o_out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = aligned_base(smem_raw), sK = sQ + 64 * D * 2,
                 sV = sK + 64 * D * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  load_tile<64, D, 128>(sQ, q, D, 64, tid);
  load_tile<64, D, 128>(sK, k, D, 64, tid);
  load_tile<64, D, 128>(sV, v, D, 64, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  float s[8][4];
  score_tile<D, 64, 64>(s, sQ, sK);
  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  uint32_t a[4][4];
  p_fragments(s, a);
  pv_tile<D, 64>(o, a, sV);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s_out[row * 64 + nb * 8 + 2 * t + e] = s[nb][2 * r + e];
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o_out[row * D + d * 8 + 2 * t + e] = o[d][2 * r + e];
  }
}

template <int D>
int launch_debug(const void* q, const void* k, const void* v, float* s,
                 float* o, cudaStream_t stream) {
  constexpr int smem = 1024 + 3 * 64 * D * 2;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_tile_debug_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_tile_debug_kernel<D><<<1, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), s, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* starts, const void* ends, void* out,
                              void* lse, int B, int Sq, int Skv, int H, int D,
                              int q_offset, int causal, float scale,
                              int block_m, int block_n, void* stream) {
  const int* st = static_cast<const int*>(starts);
  const int* en = static_cast<const int*>(ends);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return 0;
#define FLASH_LAUNCH(DD, BMM, BNN)                                          \
  if (D == DD && block_m == BMM && block_n == BNN)                          \
    return launch<DD, BMM, BNN>(q, k, v, st, en, out, l, B, Sq, Skv, H,     \
                                q_offset, causal, scale, s);
  // the tiles ops/flash_attention.py TILES lists
  FLASH_LAUNCH(128, 128, 128)
  FLASH_LAUNCH(128, 64, 128)
  FLASH_LAUNCH(128, 64, 64)
  FLASH_LAUNCH(64, 64, 128)
  FLASH_LAUNCH(64, 64, 64)
#undef FLASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_wgmma_tile_debug(const void* q, const void* k,
                                      const void* v, void* s, void* o, int D,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  float* of = static_cast<float*>(o);
  if (D == 64) return launch_debug<64>(q, k, v, sf, of, st);
  if (D == 128) return launch_debug<128>(q, k, v, sf, of, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
