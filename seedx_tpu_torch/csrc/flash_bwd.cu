// Flash-attention backward for Hopper (sm_90a): K4 (dq) and K5 (dk, dv).
//
// Replaces: seedx_tpu/ops/flash_attention.py `_flash_bwd_dq_kernel` (K4)
// and `_flash_bwd_dkv_kernel` (K5), the Pallas TPU kernels reached through
// `_flash_backward_local` from the custom VJP of `flash_attention`.  Same
// contract: q / dout [B, Sq, H, D], k / v [B, Skv, H, D] (contiguous,
// bf16); lse and delta = rowsum(dout * out) fp32 [B, H, Sq] (delta is
// computed by the caller, outside the kernels, as on the TPU); each batch
// row attends to the kv window [starts[b], ends[b]), with an optional
// causal mask where q row i sits at kv position q_offset + i.  The
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
// Design: 64-row tiles, 4 warps of 16 rows, `mma.sync.m16n8k16` bf16 in /
// fp32 accumulate with fragments loaded from shared memory by each thread,
// plain 16-byte global->shared copies with one barrier per tile (no TMA,
// wgmma or pipelining yet: later work).  Blocks run in parallel, so the
// TPU's sequential grid axis becomes a loop inside the block.
//   K4: one block per (64-row q tile, head, batch row); it loops over the
//   k tiles of the window, trimmed by the causal bound, recomputes S and
//   dP = dout V^T, forms dS in registers and accumulates dS K (dS taken
//   from the score accumulators as the A operand of the next mma.sync:
//   the m16n8 C fragment of two adjacent 8-key blocks is the m16k16 A
//   fragment).
//   K5: one block per (64-key tile, head, batch row); it loops over the q
//   tiles from the first one that can see the tile (causal), 32 q rows at
//   a time to bound registers.  It computes the TRANSPOSED scores
//   S^T = K Q^T and dP^T = V dout^T directly, so P^T and dS^T come out of
//   the accumulators with the keys as rows: exactly the A operand of
//   P^T dout and dS^T Q.  No staging of P or dS through shared memory is
//   needed.  Keys outside the window (or a tile no q row sees) get zero
//   grads.
// Each output tile has a single writer and there are no atomics, so two
// runs give the same bits.  Ragged Sq / Skv edges are masked in-kernel.
// Rounding: P and dS are fed to the tensor cores as bf16 (the TPU kernel
// and the plain version keep them fp32); outputs are rounded once to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // q rows (K4) / keys (K5) per block
constexpr int kThreads = 128;  // 4 warps of 16 rows

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [r0, r0 + 64) of a [S, H * D]-strided head slice -> shared [64][D+8];
// rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int S, long rs, int tid) {
  constexpr int LD = D + 8, CPR = D / 8;
  for (int c = tid; c < kTile * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// A operand (16 x 16, row-major) at (row0, col0) of a shared [rows][LD] tile.
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* s,
                                       int LD, int row0, int col0, int g,
                                       int t) {
  const __nv_bfloat16* p = s + (row0 + g) * LD + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B operand of X Y^T: Y row-major [n][k] in shared memory, n-block n0,
// k-chunk k0.
__device__ __forceinline__ void frag_b_t(uint32_t* b, const __nv_bfloat16* s,
                                         int LD, int n0, int k0, int g,
                                         int t) {
  const __nv_bfloat16* p = s + (n0 + g) * LD + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B operand of X Y: Y row-major [k][n] in shared memory, k-chunk k0,
// n-block n0.
__device__ __forceinline__ void frag_b_n(uint32_t* b, const __nv_bfloat16* s,
                                         int LD, int k0, int n0, int g,
                                         int t) {
  const __nv_bfloat16* p = s + (k0 + 2 * t) * LD + n0 + g;
  b[0] = pack_bf16(p[0], p[LD]);
  b[1] = pack_bf16(p[8 * LD], p[9 * LD]);
}

// ---- K4: dq ---------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ starts,
                    const int* __restrict__ ends,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                    int q_offset, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int NB = kTile / 8;              // 8-key n-blocks per k tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kTile * LD;
  __nv_bfloat16* sK = sdO + kTile * LD;
  __nv_bfloat16* sV = sK + kTile * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = iq * kTile;
  const long rs = static_cast<long>(H) * D;
  const long qoff = static_cast<long>(b) * Sq * rs + h * D;
  const long koff = static_cast<long>(b) * Skv * rs + h * D;
  const int start = max(starts[b], 0);
  const int end = min(ends[b], Skv);

  load_tile<D>(sQ, q + qoff, m0, Sq, rs, tid);
  load_tile<D>(sdO, dout + qoff, m0, Sq, rs, tid);

  // this thread's q rows: m0 + warp * 16 + g (+ 8)
  bool row_ok[2];
  int qpos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    row_ok[r] = row < Sq;
    qpos[r] = q_offset + row;
    const long at = (static_cast<long>(b) * H + h) * Sq + row;
    lse_r[r] = row_ok[r] ? lse[at] : 0.f;
    delta_r[r] = row_ok[r] ? delta[at] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int k_begin = start / kTile;
  int k_end = (end + kTile - 1) / kTile;
  if (causal) {
    const int last = q_offset + m0 + kTile;   // one past the tile's last row
    k_end = min(k_end, last <= 0 ? 0 : (last + kTile - 1) / kTile);
  }

  for (int j = k_begin; j < k_end; ++j) {
    const int n0 = j * kTile;
    __syncthreads();                          // previous tile fully consumed
    load_tile<D>(sK, k + koff, n0, Skv, rs, tid);
    load_tile<D>(sV, v + koff, n0, Skv, rs, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = dp[nb][0] = dp[nb][1] =
          dp[nb][2] = dp[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      frag_a(aq, sQ, LD, warp * 16, kk * 16, g, t);
      frag_a(ado, sdO, LD, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t bk[2], bv[2];
        frag_b_t(bk, sK, LD, nb * 8, kk * 16, g, t);
        frag_b_t(bv, sV, LD, nb * 8, kk * 16, g, t);
        mma_16816(s[nb], aq, bk);
        mma_16816(dp[nb], ado, bv);
      }
    }

    // dS = P (dP - delta) scale, P = exp(S scale - lse) under the mask
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int kpos = n0 + nb * 8 + 2 * t + (i & 1);
        const bool ok = row_ok[r] && kpos >= start && kpos < end &&
                        (!causal || qpos[r] >= kpos);
        const float p = ok ? expf(s[nb][i] * scale - lse_r[r]) : 0.f;
        s[nb][i] = p * (dp[nb][i] - delta_r[r]) * scale;
      }
    }

    // dQ += dS K: dS (16 x 64, from the accumulators) times K [64 keys][D]
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t a[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                       pack_f32(s[2 * kc][2], s[2 * kc][3]),
                       pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                       pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        uint32_t bk[2];
        frag_b_n(bk, sK, LD, kc * 16, d * 8, g, t);
        mma_16816(acc[d], a, bk);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    const int row = m0 + warp * 16 + g + 8 * r;
    __nv_bfloat16* orow = dq + qoff + row * rs;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

// ---- K5: dk, dv -------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
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
                     int q_offset, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int QH = 32;                     // q rows per inner step
  constexpr int NB = QH / 8;                 // 8-row n-blocks per step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile * LD;
  __nv_bfloat16* sQ = sV + kTile * LD;
  __nv_bfloat16* sdO = sQ + kTile * LD;
  float* sL = reinterpret_cast<float*>(sdO + kTile * LD);
  float* sD = sL + kTile;

  const int ik = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = ik * kTile;
  const long rs = static_cast<long>(H) * D;
  const long qoff = static_cast<long>(b) * Sq * rs + h * D;
  const long koff = static_cast<long>(b) * Skv * rs + h * D;
  const long roff = (static_cast<long>(b) * H + h) * Sq;
  const int start = max(starts[b], 0);
  const int end = min(ends[b], Skv);

  load_tile<D>(sK, k + koff, n0, Skv, rs, tid);
  load_tile<D>(sV, v + koff, n0, Skv, rs, tid);

  // this thread's keys: n0 + warp * 16 + g (+ 8)
  int kpos[2];
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = n0 + warp * 16 + g + 8 * r;
    key_ok[r] = kpos[r] >= start && kpos[r] < end;
  }

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
    acc_k[d][0] = acc_k[d][1] = acc_k[d][2] = acc_k[d][3] = acc_v[d][0] =
        acc_v[d][1] = acc_v[d][2] = acc_v[d][3] = 0.f;

  const int n_q = (Sq + kTile - 1) / kTile;
  // first q tile whose rows can see this key tile: q_offset + row >= n0
  int i_begin = causal ? max(n0 - q_offset, 0) / kTile : 0;
  if (n0 >= end || n0 + kTile <= start) i_begin = n_q;   // outside the window

  for (int i = i_begin; i < n_q; ++i) {
    const int m0 = i * kTile;
    __syncthreads();                          // previous q tile consumed
    load_tile<D>(sQ, q + qoff, m0, Sq, rs, tid);
    load_tile<D>(sdO, dout + qoff, m0, Sq, rs, tid);
    if (tid < kTile) {
      const bool in = m0 + tid < Sq;
      sL[tid] = in ? lse[roff + m0 + tid] : 0.f;
      sD[tid] = in ? delta[roff + m0 + tid] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int q0 = 0; q0 < kTile; q0 += QH) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 q rows
      float st[NB][4], dpt[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        st[nb][0] = st[nb][1] = st[nb][2] = st[nb][3] = dpt[nb][0] =
            dpt[nb][1] = dpt[nb][2] = dpt[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a(ak, sK, LD, warp * 16, kk * 16, g, t);
        frag_a(av, sV, LD, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t bq[2], bo[2];
          frag_b_t(bq, sQ, LD, q0 + nb * 8, kk * 16, g, t);
          frag_b_t(bo, sdO, LD, q0 + nb * 8, kk * 16, g, t);
          mma_16816(st[nb], ak, bq);
          mma_16816(dpt[nb], av, bo);
        }
      }

      // P^T and dS^T under the mask (rows: keys, columns: q rows)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = q0 + nb * 8 + 2 * t + (e & 1);
          const int row = m0 + col;
          const bool ok = key_ok[r] && row < Sq &&
                          (!causal || q_offset + row >= kpos[r]);
          const float p = ok ? expf(st[nb][e] * scale - sL[col]) : 0.f;
          st[nb][e] = p;
          dpt[nb][e] = p * (dpt[nb][e] - sD[col]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q over these 32 q rows
#pragma unroll
      for (int kc = 0; kc < QH / 16; ++kc) {
        uint32_t ap[4] = {pack_f32(st[2 * kc][0], st[2 * kc][1]),
                          pack_f32(st[2 * kc][2], st[2 * kc][3]),
                          pack_f32(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                          pack_f32(st[2 * kc + 1][2], st[2 * kc + 1][3])};
        uint32_t as[4] = {pack_f32(dpt[2 * kc][0], dpt[2 * kc][1]),
                          pack_f32(dpt[2 * kc][2], dpt[2 * kc][3]),
                          pack_f32(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
                          pack_f32(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          uint32_t bo[2], bq[2];
          frag_b_n(bo, sdO, LD, q0 + kc * 16, d * 8, g, t);
          frag_b_n(bq, sQ, LD, q0 + kc * 16, d * 8, g, t);
          mma_16816(acc_v[d], ap, bo);
          mma_16816(acc_k[d], as, bq);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Skv) continue;
    __nv_bfloat16* krow = dk + koff + kpos[r] * rs;
    __nv_bfloat16* vrow = dv + koff + kpos[r] * rs;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(krow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(acc_k[d][2 * r], acc_k[d][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(acc_v[d][2 * r], acc_v[d][2 * r + 1]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* starts,
              const int* ends, void* dq, int B, int Sq, int Skv, int H,
              int q_offset, int causal, float scale, cudaStream_t stream) {
  const int smem = 4 * kTile * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, starts, ends,
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* starts,
               const int* ends, void* dk, void* dv, int B, int Sq, int Skv,
               int H, int q_offset, int causal, float scale,
               cudaStream_t stream) {
  const int smem = 4 * kTile * (D + 8) * 2 + 2 * kTile * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Skv + kTile - 1) / kTile, H, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, starts, ends,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Skv, H, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* starts,
                                 const void* ends, void* dq, int B, int Sq,
                                 int Skv, int H, int D, int q_offset,
                                 int causal, float scale, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* st = static_cast<const int*>(starts);
  const int* en = static_cast<const int*>(ends);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, l, dl, st, en, dq, B, Sq, Skv, H,
                         q_offset, causal, scale, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, l, dl, st, en, dq, B, Sq, Skv, H,
                          q_offset, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* starts,
                                  const void* ends, void* dk, void* dv, int B,
                                  int Sq, int Skv, int H, int D, int q_offset,
                                  int causal, float scale, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* st = static_cast<const int*>(starts);
  const int* en = static_cast<const int*>(ends);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Skv == 0 || H == 0) return 0;
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, l, dl, st, en, dk, dv, B, Sq, Skv,
                          H, q_offset, causal, scale, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, l, dl, st, en, dk, dv, B, Sq, Skv,
                           H, q_offset, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
