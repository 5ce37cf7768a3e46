// Ragged decode attention for Hopper (sm_90a): one query token per batch
// row over the valid window of that row's KV cache.
//
// Replaces: seedx_tpu/ops/decode_attention.py `_decode_kernel` (the
// Pallas TPU kernel reached through `ragged_decode_attention`), in its
// one-query-per-row mode.  Same contract: q [B, Hq, D] bf16; a flat cache
// [B, S, Hkv*D] (or a paged pool [P*page, Hkv*D] where logical position p
// of row b lives at pool row tables[b, p / page] * page + p % page) of bf16
// values or int8 codes with bf16 per-(position, head) scales [.., Hkv];
// row b attends [starts[b], ends[b]) only; q head h reads kv head h / G;
// out [B, Hq, D] bf16, exactly zero for an empty window.
//
// What bounds it on the H100: HBM bytes.  Each window position costs
// 2 * D bytes of codes (int8) per kv head and 4 * D FLOP per q head, so
// the kernel sits far below the ridge; the only lever is to read the
// window once and nothing else.  (The dequantize-then-attend path it
// replaces read and rewrote the whole max_len cache every step.)
//
// Design: one block of 8 warps per (kv head, batch row).  Lane l holds
// dims [l*E, (l+1)*E) (E = D / 32) of the G q heads in fp32 registers.
// Each warp walks its own positions of the window, 4 at a time: it issues
// the 4 k and 4 v loads (one contiguous D-element run per position, so a
// warp reads 128 B of int8 codes per position at D 128, coalesced) before
// it uses any, reduces the G dot products across the warp with shuffles,
// and runs an fp32 online softmax per q head.  The 8 warps' partial
// (max, sum, acc) states are merged through shared memory at the end, as
// flash-decoding merges its splits.  Arithmetic follows the TPU kernel:
// q and k are exact in fp32, the softmax scale and then the k scale apply
// after the dot, p * v_scale is rounded to bf16 before it weights v
// (decode_attention.py:316-320), acc / max(l, 1e-30) is the output.
// Positions outside the window are never loaded.  The TPU kernel's
// scatter-matrix scoring, 128-lane scale padding and VMEM tile picking are
// Mosaic layout rules with no counterpart here; any page size works.
// Not yet done (later work): cp.async / TMA double-buffering and splitting
// a long window across blocks to fill the SMs at batch 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // ops/attention.py NEG_INF
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;   // positions in flight per warp

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

// GM: compile-time bound on G (1, or 8 for grouped-query heads).
template <int D, int GM, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const __nv_bfloat16* __restrict__ ks,
                   const __nv_bfloat16* __restrict__ vs,
                   const int* __restrict__ starts,
                   const int* __restrict__ ends,
                   const int* __restrict__ tables,
                   __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int S,
                   int n_tiles, int page, float scale) {
  constexpr int E = D / 32;
  constexpr bool kInt8 = sizeof(T) == 1;
  __shared__ float sm_m[kWarps][GM];
  __shared__ float sm_l[kWarps][GM];
  __shared__ float sm_acc[kWarps][GM][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long F = static_cast<long>(Hkv) * D;
  const int start = max(starts[b], 0);
  const int end = min(ends[b], S);

  float qf[GM][E], acc[GM][E], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) { acc[g][e] = 0.f; qf[g][e] = 0.f; }
    if (g < G)
      load_vals<E>(q + (static_cast<long>(b) * Hq + h * G + g) * D + lane * E,
                   qf[g]);
  }

  for (int base = start + warp * kUnroll; base < end;
       base += kWarps * kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E], ksc[kUnroll], vsc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u;
      ok[u] = p < end;
      ksc[u] = vsc[u] = 1.f;
#pragma unroll
      for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      if (ok[u]) {
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

    float s[kUnroll][GM];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[u][e], d);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        d *= scale;
        if constexpr (kInt8) d *= ksc[u];
        s[u][g] = ok[u] ? d : kNegInf;
      }
    }

#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float alpha = m[g] == kNegInf ? 0.f : expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        const float p = expf(s[u][g] - mx);
        l[g] += p;
        const float pw = round_bf16(p * vsc[u]);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pw, vf[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][g];
      const float wt = mw == kNegInf ? 0.f : expf(mw - mx);
      lsum = fmaf(sm_l[w][g], wt, lsum);
      a = fmaf(sm_acc[w][g][d], wt, a);
    }
    out[(static_cast<long>(b) * Hq + h * G + g) * D + d] =
        __float2bfloat16_rn(a * (1.f / fmaxf(lsum, 1e-30f)));
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const int* starts, const int* ends,
           const int* tables, void* out, int B, int Hq, int Hkv, int S,
           int n_tiles, int page, float scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* kss = static_cast<const __nv_bfloat16*>(ks);
  const auto* vss = static_cast<const __nv_bfloat16*>(vs);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (Hq == Hkv)
    decode_attn_kernel<D, 1, T><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, kss, vss, starts, ends, tables, o, Hq, Hkv, S, n_tiles,
        page, scale);
  else
    decode_attn_kernel<D, 8, T><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, kss, vss, starts, ends, tables, o, Hq, Hkv, S, n_tiles,
        page, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const int* starts,
             const int* ends, const int* tables, void* out, int B, int Hq,
             int Hkv, int S, int n_tiles, int page, float scale,
             cudaStream_t stream) {
  if (D == 32)
    return launch<32, T>(q, k, v, ks, vs, starts, ends, tables, out, B, Hq,
                         Hkv, S, n_tiles, page, scale, stream);
  if (D == 64)
    return launch<64, T>(q, k, v, ks, vs, starts, ends, tables, out, B, Hq,
                         Hkv, S, n_tiles, page, scale, stream);
  if (D == 128)
    return launch<128, T>(q, k, v, ks, vs, starts, ends, tables, out, B, Hq,
                          Hkv, S, n_tiles, page, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs,
                           const void* starts, const void* ends,
                           const void* tables, void* out, int B, int Hq,
                           int Hkv, int D, int S, int n_tiles, int page,
                           int int8, float scale, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (Hq % Hkv || Hq / Hkv > 8 || (tables && page <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* st = static_cast<const int*>(starts);
  const int* en = static_cast<const int*>(ends);
  const int* tb = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8)
    return launch_d<int8_t>(D, q, k, v, ks, vs, st, en, tb, out, B, Hq, Hkv,
                            S, n_tiles, page, scale, s);
  return launch_d<__nv_bfloat16>(D, q, k, v, ks, vs, st, en, tb, out, B, Hq,
                                 Hkv, S, n_tiles, page, scale, s);
}
