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
// What bounds it on the H100: HBM bytes.  Each window position costs
// 2 * D bytes of codes (int8) per kv head and 4 * D FLOP per query head,
// so the kernel sits far below the ridge even with 8 queries per position;
// the only lever is to read the window once and nothing else.  (The
// dequantize-then-attend path it replaces read and rewrote the whole
// max_len cache every step.)
//
// Design: one block of 8 warps per (kv head, batch row, group of QL query
// slots).  A block holds NQ = QL * G <= 8 query vectors (G q heads of the
// kv head for each of its QL slots); lane l holds dims [l*E, (l+1)*E)
// (E = D / 32) of each in fp32 registers.  Each warp walks its own
// positions of the block's longest stair window, 4 at a time: it issues
// the 4 k and 4 v loads (one contiguous D-element run per position, so a
// warp reads 128 B of int8 codes per position at D 128, coalesced) before
// it uses any, scores each loaded position against every query of the
// block (so a position's bytes are read once for all NQ queries, not once
// per query), reduces the dot products across the warp with shuffles, and
// runs an fp32 online softmax per query vector under that query's own end
// mask p < e_i.  The 8 warps' partial (max, sum, acc) states are merged
// through shared memory at the end, as flash-decoding merges its splits.
// Arithmetic follows the TPU kernel: q and k are exact in fp32, the softmax
// scale and then the k scale apply after the dot, p * v_scale is rounded
// to bf16 before it weights v (decode_attention.py:316-320),
// acc / max(l, 1e-30) is the output.  Positions outside the window are
// never loaded.  The TPU kernel's scatter-matrix scoring, 128-lane scale
// padding and VMEM tile picking are Mosaic layout rules with no
// counterpart here; any page size works.
// Not yet done (later work): cp.async / TMA double-buffering, splitting a
// long window across blocks to fill the SMs at batch 1, and skipping the
// stair slots a row does not use (every row computes all w slots, as the
// TPU kernel does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // ops/attention.py NEG_INF
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;   // positions in flight per warp
constexpr int kMaxQueries = 8;   // query vectors a block holds (QL * G)

template <int E>
__device__ __forceinline__ void load_vals(const int8_t* p, float* f) {
  if constexpr (E == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
  } else if constexpr (E == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    f[0] = c.x; f[1] = c.y;
  } else {
    f[0] = *p;
  }
}

template <int E>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float* f) {
  if constexpr (E == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.y));
    f[0] = a.x; f[1] = a.y; f[2] = c.x; f[3] = c.y;
  } else if constexpr (E == 2) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = a.x; f[1] = a.y;
  } else {
    f[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// NQ: compile-time bound on the query vectors of a block (1 for one
// query of one head; kMaxQueries for grouped heads and / or a stair).
// Query vector j of a block is slot qi0 + j / G, head h * G + j % G.
template <int D, int NQ, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const __nv_bfloat16* __restrict__ ks,
                   const __nv_bfloat16* __restrict__ vs,
                   const int* __restrict__ starts,
                   const int* __restrict__ ends,
                   const int* __restrict__ tables,
                   __nv_bfloat16* __restrict__ out, int W, int Hq, int Hkv,
                   int S, int n_tiles, int page, float scale) {
  constexpr int E = D / 32;
  constexpr bool kInt8 = sizeof(T) == 1;
  __shared__ float sm_m[kWarps][NQ];
  __shared__ float sm_l[kWarps][NQ];
  __shared__ float sm_acc[kWarps][NQ][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int QL = NQ / G;                    // query slots per block
  const int qi0 = blockIdx.z * QL;
  const int nq = min(QL, W - qi0) * G;      // live query vectors
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long F = static_cast<long>(Hkv) * D;
  const int start = max(starts[b], 0);

  float qf[NQ][E], acc[NQ][E], m[NQ], l[NQ];
  int e[NQ];
  int e_max = start;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
    e[j] = start;
#pragma unroll
    for (int x = 0; x < E; ++x) { acc[j][x] = 0.f; qf[j][x] = 0.f; }
    if (j < nq) {
      const int qi = qi0 + j / G;
      // the stair: slot qi ends qi positions after slot 0, clamped to the
      // logical cache length so paged lookups stay inside the table
      e[j] = min(ends[b] + qi, S);
      e_max = max(e_max, e[j]);
      load_vals<E>(q + ((static_cast<long>(b) * W + qi) * Hq + h * G + j % G)
                           * D + lane * E, qf[j]);
    }
  }

  for (int base = start + warp * kUnroll; base < e_max;
       base += kWarps * kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E], ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u;
      ksc[u] = vsc[u] = 1.f;
#pragma unroll
      for (int x = 0; x < E; ++x) kf[u][x] = vf[u][x] = 0.f;
      if (p < e_max) {
        const long row =
            tables ? static_cast<long>(tables[b * n_tiles + p / page]) * page +
                         p % page
                   : static_cast<long>(b) * S + p;
        const long off = row * F + h * D + lane * E;
        load_vals<E>(kc + off, kf[u]);
        load_vals<E>(vc + off, vf[u]);
        if constexpr (kInt8) {
          ksc[u] = __bfloat162float(ks[row * Hkv + h]);
          vsc[u] = __bfloat162float(vs[row * Hkv + h]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (j >= nq) break;
      bool ok[kUnroll];
      float s[kUnroll];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ok[u] = base + u < e[j];
        any |= ok[u];
        float d = 0.f;
#pragma unroll
        for (int x = 0; x < E; ++x) d = fmaf(qf[j][x], kf[u][x], d);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        d *= scale;
        if constexpr (kInt8) d *= ksc[u];
        s[u] = ok[u] ? d : kNegInf;
      }
      if (!any) continue;   // warp-uniform: no position of this round
      float mx = m[j];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u]);
      const float alpha = m[j] == kNegInf ? 0.f : expf(m[j] - mx);
      l[j] *= alpha;
#pragma unroll
      for (int x = 0; x < E; ++x) acc[j][x] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        const float p = expf(s[u] - mx);
        l[j] += p;
        const float pw = round_bf16(p * vsc[u]);
#pragma unroll
        for (int x = 0; x < E; ++x) acc[j][x] = fmaf(pw, vf[u][x], acc[j][x]);
      }
      m[j] = mx;
    }
  }

#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (j >= nq) break;
#pragma unroll
    for (int x = 0; x < E; ++x) sm_acc[warp][j][lane * E + x] = acc[j][x];
    if (lane == 0) {
      sm_m[warp][j] = m[j];
      sm_l[warp][j] = l[j];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nq * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][j]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][j];
      const float wt = mw == kNegInf ? 0.f : expf(mw - mx);
      lsum = fmaf(sm_l[w][j], wt, lsum);
      a = fmaf(sm_acc[w][j][d], wt, a);
    }
    const long qi = qi0 + j / G;
    out[((static_cast<long>(b) * W + qi) * Hq + h * G + j % G) * D + d] =
        __float2bfloat16_rn(a * (1.f / fmaxf(lsum, 1e-30f)));
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const int* starts, const int* ends,
           const int* tables, void* out, int B, int W, int Hq, int Hkv, int S,
           int n_tiles, int page, float scale, cudaStream_t stream) {
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* kss = static_cast<const __nv_bfloat16*>(ks);
  const auto* vss = static_cast<const __nv_bfloat16*>(vs);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const int G = Hq / Hkv;
  if (G == 1 && W == 1) {
    // one query of one head per block: the smallest register footprint
    decode_attn_kernel<D, 1, T><<<dim3(Hkv, B, 1), kThreads, 0, stream>>>(
        qq, kk, vv, kss, vss, starts, ends, tables, o, W, Hq, Hkv, S,
        n_tiles, page, scale);
  } else {
    // Grouped heads and / or a stair.  The one-query GQA case (W 1, G 5)
    // pays for the stair: each query carries its own end mask and the
    // query loop sits outside the positions, which made it ~19% slower on
    // an H100 than a kernel with one shared mask (0.206 vs 0.174 ms at B 8,
    // S 1280, Hq 40 / Hkv 8).  No model of this repo serves GQA (LLaMA2-13B
    // is G 1); a W == 1 instance with one shared mask would win it back.
    const int ql = kMaxQueries / G;
    decode_attn_kernel<D, kMaxQueries, T>
        <<<dim3(Hkv, B, (W + ql - 1) / ql), kThreads, 0, stream>>>(
            qq, kk, vv, kss, vss, starts, ends, tables, o, W, Hq, Hkv, S,
            n_tiles, page, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const int* starts,
             const int* ends, const int* tables, void* out, int B, int W,
             int Hq, int Hkv, int S, int n_tiles, int page, float scale,
             cudaStream_t stream) {
  if (D == 32)
    return launch<32, T>(q, k, v, ks, vs, starts, ends, tables, out, B, W,
                         Hq, Hkv, S, n_tiles, page, scale, stream);
  if (D == 64)
    return launch<64, T>(q, k, v, ks, vs, starts, ends, tables, out, B, W,
                         Hq, Hkv, S, n_tiles, page, scale, stream);
  if (D == 128)
    return launch<128, T>(q, k, v, ks, vs, starts, ends, tables, out, B, W,
                          Hq, Hkv, S, n_tiles, page, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs,
                           const void* starts, const void* ends,
                           const void* tables, void* out, int B, int W,
                           int Hq, int Hkv, int D, int S, int n_tiles,
                           int page, int int8, float scale, void* stream) {
  if (B == 0 || W == 0 || Hkv == 0) return 0;
  if (Hq % Hkv || Hq / Hkv > kMaxQueries || (tables && page <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* st = static_cast<const int*>(starts);
  const int* en = static_cast<const int*>(ends);
  const int* tb = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8)
    return launch_d<int8_t>(D, q, k, v, ks, vs, st, en, tb, out, B, W, Hq,
                            Hkv, S, n_tiles, page, scale, s);
  return launch_d<__nv_bfloat16>(D, q, k, v, ks, vs, st, en, tb, out, B, W,
                                 Hq, Hkv, S, n_tiles, page, scale, s);
}
