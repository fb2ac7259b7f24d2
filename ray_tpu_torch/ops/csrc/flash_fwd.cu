// Causal flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out,
// fp32 softmax state and accumulators. Kernel K1 of the port.
//
// Replaces: ray_tpu/ops/attention.py `_fwd_kernel` (launched by `_fwd_pallas`).
// Same function: O = softmax(scale * Q K^T + mask) V with the causal mask, an
// optional same-segment mask, native GQA (q head h reads kv head h / group,
// K/V never repeated), and the per-row LSE = m + log(l); a row that sees no
// valid key writes 0.
//
// What bounds it on an H100: causal attention does 2 * S^2 * D FLOPs per head
// against (2 * H + 2 * KV) * S * D * 2 bytes of q, o, k, v per sequence, about
// 200 FLOP/byte at S = 512 (H 16, KV 4, D 64) and 800 at S = 2048, against
// the card's ~295 FLOP/byte ridge: near the ridge at the serving bucket,
// bound by the bf16 tensor-core rate above it.
// What this design does about it: the two products (Q K^T and P V) run on the
// tensor cores through WMMA 16x16x16 bf16 fragments with fp32 accumulation;
// the score matrix never leaves shared memory; tiles wholly above the
// diagonal are skipped. It is the simple version: K/V tiles are loaded
// synchronously (no cp.async / TMA pipeline) and the softmax runs from shared
// memory, not from the accumulator registers. wgmma + TMA come later.
//
// Layout at the interface: q/o [B, S, H, D], k/v [B, S, KV, D] (row-major,
// contiguous), seg [B, S] int32 or null, lse [B*H, S] fp32. D must be 64.
// A ragged S (not a multiple of the tile) is masked here; the TPU wrapper
// fell back to its reference path for that case instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per K/V tile
constexpr int NWARPS = 4;    // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDH = D + 8;   // bf16 row stride of the Q/K/V tiles (pad: no bank conflicts)
constexpr int LDP = BK + 8;  // bf16 row stride of the P tile
constexpr int LDS = BK + 4;  // fp32 row stride of the score / PV tile
static_assert(BK == D, "the score tile is reused for the P*V product");

struct Smem {
  __nv_bfloat16 q[BQ * LDH];
  __nv_bfloat16 k[BK * LDH];
  __nv_bfloat16 v[BK * LDH];
  __nv_bfloat16 p[BQ * LDP];
  float s[BQ * LDS];
  int seg_q[BQ];
  int seg_k[BK];
};

// 64 rows of D bf16 from a [.., S, heads, D] tensor into shared memory;
// rows at or past S are zero (masked later, and zero V keeps P*V finite).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row_stride, int r0, int S, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR, part = c % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * row_stride + part * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + part * 8) = val;
  }
}

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int S, int H, int KV, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Heaviest causal tiles (last rows) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const size_t q_rs = (size_t)H * D, kv_rs = (size_t)KV * D;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * KV + kvh) * D;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;

  load_tile(sm.q, qb, q_rs, q0, S, tid);
  if (tid < BQ) sm.seg_q[tid] = (segb && q0 + tid < S) ? segb[q0 + tid] : 0;

  // Softmax ownership: two lanes per query row, 32 columns each.
  const int r_local = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int row = q0 + r_local;
  float m = -INFINITY, l = 0.f;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  __syncthreads();
  const int seg_r = sm.seg_q[r_local];

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], sm.q + warp * 16 * LDH + kk * 16, LDH);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    load_tile(sm.k, kb, kv_rs, k0, S, tid);
    load_tile(sm.v, vb, kv_rs, k0, S, tid);
    if (tid < BK) sm.seg_k[tid] = (segb && k0 + tid < S) ? segb[k0 + tid] : 0;
    __syncthreads();

    // Scores for this warp's 16 rows: S = Q K^T (K^T read as a col-major B).
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(c, qa[kk], kf, c);
      }
      wmma::store_matrix_sync(sm.s + warp * 16 * LDS + n * 16, c, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this tile (masked entries are -inf; a row with
    // nothing valid yet keeps m = -inf, p = 0 and its state unchanged).
    float sv[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int cl = half * 32 + j;
      const int col = k0 + cl;
      const bool ok = col < S && (!causal || col <= row) && (!segb || sm.seg_k[cl] == seg_r);
      const float x = ok ? sm.s[r_local * LDS + cl] * scale : -INFINITY;
      sv[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const bool none = (m_new == -INFINITY);
    const float alpha = none ? 1.f : __expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = none ? 0.f : __expf(sv[j] - m_new);
      psum += p;
      sm.p[r_local * LDP + half * 32 + j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] *= alpha;
    __syncwarp();

    // P V for this warp's rows, into the (now free) score tile.
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::load_matrix_sync(pa[kk], sm.p + warp * 16 * LDP + kk * 16, LDP);
      }
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, sm.v + kk * 16 * LDH + n * 16, LDH);
          wmma::mma_sync(c, pa[kk], vf, c);
        }
        wmma::store_matrix_sync(sm.s + warp * 16 * LDS + n * 16, c, LDS, wmma::mem_row_major);
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += sm.s[r_local * LDS + half * 32 + j];
    __syncthreads();  // every warp is done with K/V/seg_k before the next load
  }

  if (row < S) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* ob = o + (((size_t)b * S + row) * H + h) * D + half * 32;
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
      __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) tmp[i] = __float2bfloat16(acc[j + i] * inv);
      *reinterpret_cast<uint4*>(ob + j) = *reinterpret_cast<const uint4*>(tmp);
    }
    if (half == 0) lse[(size_t)bh * S + row] = l > 0.f ? m + logf(l) : -1e30f;
  }
}

}  // namespace

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, const void* seg,
                              void* o, void* lse, int B, int S, int H, int KV, int head_dim,
                              int causal, float scale, void* stream) {
  if (head_dim != D || H % KV != 0 || B <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
