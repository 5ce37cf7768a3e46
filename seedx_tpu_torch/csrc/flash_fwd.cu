// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 online softmax.
//
// Replaces: seedx_tpu/ops/flash_attention.py `_flash_fwd_kernel` (the
// Pallas TPU kernel reached through `_flash_forward_local` /
// `flash_attention`).  Same contract: q [B, Sq, H, D], k/v [B, Skv, H, D]
// (contiguous, bf16); each batch row attends to the kv window
// [starts[b], ends[b]); optional causal mask where q row i sits at kv
// position q_offset + i; out [B, Sq, H, D] bf16 and the row logsumexp
// lse [B, H, Sq] fp32.  A fully masked row gives zero output and lse NEG_INF.
//
// What bounds it on the H100: tensor-core math.  The ViT (1024 tokens, 5
// tiles, 16 heads) and the 512-token agent prefill are far above the
// bf16 ridge (~295 FLOP per HBM byte), so the kernel must keep the
// [Sq, Skv] scores out of device memory and feed the tensor cores.
//
// Design: one block of 4 warps per (64-row q tile, head, batch row) --
// blocks run in parallel, and a loop over 64-key tiles inside the block
// replaces the TPU's sequential grid axis.  Each warp owns 16 q rows.
// Q K^T and P V run on `mma.sync.m16n8k16` (bf16 in, fp32 accumulate); the
// scores of a tile never leave registers, and P is re-used from the score
// accumulators as the A operand of P V (cast to bf16, as the TPU kernel
// casts p to the v dtype).  The k-tile loop is trimmed to the window and,
// when causal, to the last tile the q tile can see.  Ragged Sq/Skv edges
// are masked in the kernel, so callers need no 128-padding.  Loads are
// plain 16-byte global->shared copies with one barrier per tile: no TMA,
// wgmma or pipelining yet (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // ops/attention.py NEG_INF
constexpr int kBM = 64;       // q rows per block (16 per warp)
constexpr int kBN = 64;       // keys per k tile
constexpr int kThreads = 128;

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Skv, int H, int q_offset, int causal,
                 float scale) {
  constexpr int LD = D + 8;       // padded rows: conflict-free 32-bit reads
  constexpr int CPR = D / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBM * LD;
  __nv_bfloat16* sV = sK + kBN * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = iq * kBM;
  const long rs = static_cast<long>(H) * D;   // elements per sequence step
  const __nv_bfloat16* qb = q + static_cast<long>(b) * Sq * rs + h * D;
  const __nv_bfloat16* kb = k + static_cast<long>(b) * Skv * rs + h * D;
  const __nv_bfloat16* vb = v + static_cast<long>(b) * Skv * rs + h * D;
  const int start = max(starts[b], 0);
  const int end = min(ends[b], Skv);

  for (int c = tid; c < kBM * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qb + (m0 + r) * rs + col);
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = val;
  }
  __syncthreads();

  const int qr = warp * 16 + g;             // this thread's rows: qr, qr + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = sQ + qr * LD + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int qpos = q_offset + m0 + qr;

  const int k_begin = start / kBN;
  int k_end = (end + kBN - 1) / kBN;
  if (causal) {
    const int last = q_offset + m0 + kBM;     // one past the tile's last row
    k_end = min(k_end, last <= 0 ? 0 : (last + kBN - 1) / kBN);
  }

  for (int j = k_begin; j < k_end; ++j) {
    const int n0 = j * kBN;
    __syncthreads();                          // previous tile fully consumed
    for (int c = tid; c < kBN * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (n0 + r < Skv) {
        kv = *reinterpret_cast<const uint4*>(kb + (n0 + r) * rs + col);
        vv = *reinterpret_cast<const uint4*>(vb + (n0 + r) * rs + col);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + col) = kv;
      *reinterpret_cast<uint4*>(sV + r * LD + col) = vv;
    }
    __syncthreads();

    float s[kBN / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* p = sK + (nb * 8 + g) * LD + kk * 16 + 2 * t;
        uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(p),
                          *reinterpret_cast<const uint32_t*>(p + 8)};
        mma_16816(s[nb], qf[kk], bf);
      }
    }

#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = n0 + nb * 8 + 2 * t + (i & 1);
        const int qp = qpos + 8 * (i >> 1);
        const bool ok = kpos >= start && kpos < end && (!causal || qp >= kpos);
        s[nb][i] = ok ? s[nb][i] * scale : kNegInf;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_new);
      // rows fully masked so far (m_new == NEG_INF) get p = 0 explicitly
      const bool dead = m_new == kNegInf;
      float rowsum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = dead ? 0.f : expf(s[nb][2 * r + e] - m_new);
          s[nb][2 * r + e] = p;
          rowsum += p;
        }
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
      l_run[r] = l_run[r] * alpha + rowsum;
      m_run[r] = m_new;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        o[d][2 * r] *= alpha;
        o[d][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t a[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                       pack_f32(s[2 * kc][2], s[2 * kc][3]),
                       pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                       pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        const __nv_bfloat16* p = sV + (kc * 16 + 2 * t) * LD + d * 8 + g;
        uint32_t bf[2] = {pack_bf16(p[0], p[LD]),
                          pack_bf16(p[8 * LD], p[9 * LD])};
        mma_16816(o[d], a, bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + qr + 8 * r;
    if (row >= Sq) continue;
    const float l_safe = l_run[r] == 0.f ? 1.f : l_run[r];
    __nv_bfloat16* orow = out + (static_cast<long>(b) * Sq + row) * rs + h * D;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(o[d][2 * r] / l_safe, o[d][2 * r + 1] / l_safe);
    }
    if (t == 0)
      lse[(static_cast<long>(b) * H + h) * Sq + row] = m_run[r] + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* starts,
           const int* ends, void* out, float* lse, int B, int Sq, int Skv,
           int H, int q_offset, int causal, float scale, cudaStream_t stream) {
  const int smem = (kBM + 2 * kBN) * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), starts, ends,
      static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, q_offset, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* starts, const void* ends, void* out,
                              void* lse, int B, int Sq, int Skv, int H, int D,
                              int q_offset, int causal, float scale,
                              void* stream) {
  const int* st = static_cast<const int*>(starts);
  const int* en = static_cast<const int*>(ends);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (D == 64)
    return launch<64>(q, k, v, st, en, out, l, B, Sq, Skv, H, q_offset,
                      causal, scale, s);
  if (D == 128)
    return launch<128>(q, k, v, st, en, out, l, B, Sq, Skv, H, q_offset,
                       causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
