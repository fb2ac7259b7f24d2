// One-token GQA decode attention against a paged KV pool, for Hopper
// (sm_90a), bf16 in, bf16 out, fp32 softmax state. Kernel K4 of the port.
//
// Replaces: ray_tpu/ops/paged_attention.py `_paged_kernel` (launched by
// `_paged_pallas`). Same function: each sequence's query heads attend to the
// first `length` tokens of its pages, found through its page-table row, with
// an online softmax across pages; pages at or past `length` are skipped and
// a sequence of length 0 writes 0 (as the TPU kernel does).
//
// What bounds it on an H100: memory. Each valid K/V element is read once and
// used by `group` query heads (4 FLOPs per element per head), far below the
// card's ~295 FLOP/byte ridge; the bound is the K/V bytes over 3.35 TB/s.
// What this design does about it: one block per (sequence, kv head) handles
// all `group` query heads of that kv head together, so each page is read
// from device memory exactly once; pages are copied into shared memory with
// 16-byte coalesced loads. It is the simple version: one page at a time with
// no copy/compute overlap and one block per (sequence, kv head), so a small
// batch leaves SMs idle. A split-K (flash-decoding) pass and cp.async/TMA
// double-buffering come later.
//
// Layout at the interface: q/o [B, H, D]; k/v pools [KV, P_total, ps, D]
// (the engine's linear pool [KV, P_total * ps, D] viewed per page);
// lengths [B] int32 (valid tokens including the current one); page table
// [B, ppseq] int32 whose dead entries point at page 0. D % 8 == 0, D <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

template <int G>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ lens,
                    const int* __restrict__ table, __nv_bfloat16* __restrict__ o,
                    int H, int D, int P_total, int ps, int ppseq, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = D + 8;  // padded bf16 row stride: conflict-free 16-byte row reads
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ps, LD]
  __nv_bfloat16* vs = ks + (size_t)ps * LD;                           // [ps, LD]
  float* qs = reinterpret_cast<float*>(vs + (size_t)ps * LD);         // [G, D]
  float* acc = qs + G * D;                                            // [G, D]
  float* sc = acc + G * D;                                            // [G, ps] scores, then p
  float* m_s = sc + G * ps;                                           // [G]
  float* l_s = m_s + G;                                               // [G]
  float* alpha_s = l_s + G;                                           // [G]

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lens[b];
  const int n_pages = len > 0 ? min((len + ps - 1) / ps, ppseq) : 0;

  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) {
    qs[i] = __bfloat162float(qb[i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int cpr = D / 8;  // 16-byte chunks per token row
  for (int j = 0; j < n_pages; ++j) {
    const int page = table[(size_t)b * ppseq + j];
    const int n_tok = min(ps, len - j * ps);
    const size_t base = ((size_t)kvh * P_total + page) * ps * D;
    for (int c = tid; c < n_tok * cpr; c += NTHREADS) {
      const int r = c / cpr, part = c % cpr;
      *reinterpret_cast<uint4*>(ks + r * LD + part * 8) =
          *reinterpret_cast<const uint4*>(kp + base + (size_t)r * D + part * 8);
      *reinterpret_cast<uint4*>(vs + r * LD + part * 8) =
          *reinterpret_cast<const uint4*>(vp + base + (size_t)r * D + part * 8);
    }
    __syncthreads();

    // Scores: one token per thread, all G heads.
    for (int t = tid; t < n_tok; t += NTHREADS) {
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      for (int d = 0; d < D; d += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ks + t * LD + d);
        const __nv_bfloat16* k8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float kf = __bfloat162float(k8[i]);
#pragma unroll
          for (int g = 0; g < G; ++g) dot[g] += qs[g * D + d + i] * kf;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g * ps + t] = dot[g] * scale;
    }
    __syncthreads();

    // Per head: page max, rescale factor, probabilities and their sum.
    for (int g = warp; g < G; g += NWARPS) {
      float mx = -INFINITY;
      for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, sc[g * ps + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);  // n_tok >= 1: finite
      float sum = 0.f;
      for (int t = lane; t < n_tok; t += 32) {
        const float p = __expf(sc[g * ps + t] - m_new);
        sc[g * ps + t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float a = __expf(m_old - m_new);  // m_old = -inf -> 0
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha + sum_t p[g, t] * V[t, d]
    for (int i = tid; i < G * D; i += NTHREADS) {
      const int g = i / D, d = i % D;
      const float* pg = sc + g * ps;
      float a = acc[i] * alpha_s[g];
      for (int t = 0; t < n_tok; ++t) a += pg[t] * __bfloat162float(vs[t * LD + d]);
      acc[i] = a;
    }
    __syncthreads();  // the next page overwrites ks/vs/sc
  }

  __nv_bfloat16* ob = o + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) {
    const float l = l_s[i / D];
    ob[i] = __float2bfloat16(l > 0.f ? acc[i] / l : 0.f);
  }
}

template <int G>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* lens,
                   const void* table, void* o, int B, int H, int KV, int D, int P_total,
                   int ps, int ppseq, float scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)ps * (D + 8) * sizeof(__nv_bfloat16) +
                      (size_t)(2 * G * D + G * ps + 3 * G) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  paged_decode_kernel<G><<<dim3(B, KV), NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(lens),
      static_cast<const int*>(table), static_cast<__nv_bfloat16*>(o), H, D, P_total, ps, ppseq,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_decode_bf16(const void* q, const void* kp, const void* vp, const void* lens,
                                 const void* table, void* o, int B, int H, int KV, int D,
                                 int P_total, int ps, int ppseq, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || D % 8 != 0 || D > 256 || ps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / KV) {
    case 1: return static_cast<int>(launch<1>(q, kp, vp, lens, table, o, B, H, KV, D, P_total, ps, ppseq, scale, s));
    case 2: return static_cast<int>(launch<2>(q, kp, vp, lens, table, o, B, H, KV, D, P_total, ps, ppseq, scale, s));
    case 4: return static_cast<int>(launch<4>(q, kp, vp, lens, table, o, B, H, KV, D, P_total, ps, ppseq, scale, s));
    case 8: return static_cast<int>(launch<8>(q, kp, vp, lens, table, o, B, H, KV, D, P_total, ps, ppseq, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
