// Flash-attention backward for Hopper (sm_90a): kernels K3 (dQ) and K2
// (dK, dV) of the port. bf16 in, bf16 out, fp32 recompute and accumulators.
//
// Replaces: ray_tpu/ops/attention.py `_bwd_dq_kernel` (K3) and
// `_bwd_dkv_kernel` (K2), both launched by `_bwd_pallas`. Same function:
// with P = exp(scale * Q K^T - LSE) recomputed from the forward's LSE under
// the causal mask, the optional same-segment mask and native GQA (q head h
// reads kv head h / group), and delta = rowsum(dO * O) computed beforehand,
//   dS = P * (dO V^T - delta) * scale,
//   K3: dQ = dS K,
//   K2: dV = sum over the group's q heads of P^T dO, dK = the same of dS^T Q.
// K2 owns that GQA sum inside one block: no atomics, and the result is
// deterministic.
//
// What bounds them on an H100: operations. At the training shape (B 16,
// S 2048, H 16, KV 4, D 64, causal) K3 does 6 * D FLOPs per valid (q, k)
// pair and head (Q K^T, dO V^T, dS K) and K2 8 * D (Q K^T, dO V^T, P^T dO,
// dS^T Q): 206 and 275 GFLOP against 0.24 and 0.21 GB of q, k, v, dO, LSE,
// delta and outputs, about 860 and 1340 FLOP per byte, 3-4.5x the card's
// ~295 FLOP/byte ridge. So the work is the tensor-core rate's.
// What this design does about it: every product runs on the tensor cores
// through WMMA 16x16x16 bf16 fragments with fp32 accumulation; the score,
// P and dS tiles never leave shared memory; tiles wholly above the diagonal
// are skipped. The inner loop of each block takes the place of the TPU
// kernel's sequential grid axis:
//   K3: one block per (64-row Q tile, b * H + h); the loop walks the K/V
//       tiles up to the diagonal. Each warp keeps its 16 rows of dQ in
//       accumulator fragments across the loop.
//   K2: one block per (64-row K tile, b * KV + kv); the loop walks the
//       group's q heads times the Q tiles that can see this K tile. Each warp
//       computes its 16 keys' rows of S^T = K Q^T and dP^T = V dO^T directly,
//       so P^T and dS^T come out row-major for the A operand, and keeps its
//       rows of dK and dV in accumulator fragments.
// It is the simple version: tiles are loaded synchronously (no cp.async /
// TMA pipeline) and the elementwise step runs from shared memory. wgmma and
// TMA come later.
//
// Layout at the interface: q, dO, dQ [B, S, H, D]; k, v, dK, dV [B, S, KV, D]
// (row-major, contiguous); LSE and delta [B*H, S] fp32; seg [B, S] int32 or
// null. D must be 64. A ragged S is masked here: rows and keys at or past S
// get P = 0 (they have no LSE), and are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;        // head dim
constexpr int BT = 64;       // rows per Q tile and per K tile
constexpr int NWARPS = 4;    // each warp owns 16 rows of the block's own tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDH = D + 8;   // bf16 row stride of the Q/K/V/dO tiles (pad: no bank conflicts)
constexpr int LDP = BT + 8;  // bf16 row stride of the P / dS tiles
constexpr int LDS = BT + 4;  // fp32 row stride of the score / dP tiles
static_assert(BT == D, "the score tile is reused to stage the D-wide outputs");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct SmemDq {
  __nv_bfloat16 q[BT * LDH];
  __nv_bfloat16 dout[BT * LDH];
  __nv_bfloat16 k[BT * LDH];
  __nv_bfloat16 v[BT * LDH];
  __nv_bfloat16 ds[BT * LDP];
  float s[BT * LDS];
  float dp[BT * LDS];
  float lse[BT];
  float delta[BT];
  int seg_q[BT];
  int seg_k[BT];
};

struct SmemDkv {
  __nv_bfloat16 k[BT * LDH];
  __nv_bfloat16 v[BT * LDH];
  __nv_bfloat16 q[BT * LDH];
  __nv_bfloat16 dout[BT * LDH];
  __nv_bfloat16 p[BT * LDP];
  __nv_bfloat16 ds[BT * LDP];
  float s[BT * LDS];
  float dp[BT * LDS];
  float lse[BT];
  float delta[BT];
  int seg_q[BT];
  int seg_k[BT];
};

// 64 rows of D bf16 from a [.., S, heads, D] tensor into shared memory;
// rows at or past S are zero (and masked later).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row_stride, int r0, int S, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < BT * CPR; c += NTHREADS) {
    const int r = c / CPR, part = c % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * row_stride + part * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + part * 8) = val;
  }
}

// The q-side row state of one Q tile: LSE, delta and segment id per row
// (zero past S; those rows are masked by their index).
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta, int* s_seg,
                                          const float* lse, const float* delta, const int* segb,
                                          int q0, int S, int tid) {
  if (tid < BT) {
    const int row = q0 + tid;
    const bool ok = row < S;
    s_lse[tid] = ok ? lse[row] : 0.f;
    s_delta[tid] = ok ? delta[row] : 0.f;
    s_seg[tid] = (segb && ok) ? segb[row] : 0;
  }
}

// One warp's 16 rows (x 64 columns) of A B^T, A's rows held as fragments and
// B's 64 rows read from shared memory, stored fp32 into out (row stride LDS).
__device__ __forceinline__ void rows_times_tile_t(const FragA (&a)[D / 16], const __nv_bfloat16* b,
                                                  float* out) {
#pragma unroll
  for (int n = 0; n < BT / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(c, a[kk], bf, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, LDS, wmma::mem_row_major);
  }
}

// acc[n] += A (16 x 64, row-major in shared memory, stride LDP) times the
// 64 x D tile b (row-major, stride LDH).
__device__ __forceinline__ void accumulate(FragC (&acc)[D / 16], const __nv_bfloat16* a,
                                           const __nv_bfloat16* b) {
  FragA af[BT / 16];
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) wmma::load_matrix_sync(af[kk], a + kk * 16, LDP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, b + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], af[kk], bf, acc[n]);
    }
  }
}

// Writes one warp's 16 rows of acc as bf16 rows of a [.., S, heads, D]
// tensor, staging them through this warp's rows of the fp32 tile stage.
__device__ __forceinline__ void store_rows(const FragC (&acc)[D / 16], float* stage, int r_local,
                                           int half, bool row_ok, __nv_bfloat16* dst) {
  const int warp_row0 = (r_local / 16) * 16;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(stage + warp_row0 * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  if (row_ok) {
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
      __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) tmp[i] = __float2bfloat16(stage[r_local * LDS + half * 32 + j + i]);
      *reinterpret_cast<uint4*>(dst + half * 32 + j) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
  __syncwarp();
}

// K3: dQ for one (Q tile, b * H + h).
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq,
                    int S, int H, int KV, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDq& sm = *reinterpret_cast<SmemDq*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Heaviest causal tiles (last rows) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const size_t q_rs = (size_t)H * D, kv_rs = (size_t)KV * D;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * D;
  const __nv_bfloat16* dob = dout + ((size_t)b * S * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * KV + kvh) * D;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;

  load_tile(sm.q, qb, q_rs, q0, S, tid);
  load_tile(sm.dout, dob, q_rs, q0, S, tid);
  load_rows(sm.lse, sm.delta, sm.seg_q, lse + (size_t)bh * S, delta + (size_t)bh * S, segb, q0, S, tid);

  // Elementwise ownership: two lanes per row, 32 columns each.
  const int r_local = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int row = q0 + r_local;
  const bool row_ok = row < S;

  int n_tiles = (S + BT - 1) / BT;
  if (causal) n_tiles = min(n_tiles, (q0 + BT - 1) / BT + 1);
  __syncthreads();
  const float row_lse = sm.lse[r_local], row_delta = sm.delta[r_local];
  const int seg_r = sm.seg_q[r_local];

  FragA qa[D / 16], doa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], sm.q + warp * 16 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(doa[kk], sm.dout + warp * 16 * LDH + kk * 16, LDH);
  }
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  float* s_rows = sm.s + warp * 16 * LDS;
  float* dp_rows = sm.dp + warp * 16 * LDS;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    load_tile(sm.k, kb, kv_rs, k0, S, tid);
    load_tile(sm.v, vb, kv_rs, k0, S, tid);
    if (tid < BT) sm.seg_k[tid] = (segb && k0 + tid < S) ? segb[k0 + tid] : 0;
    __syncthreads();

    rows_times_tile_t(qa, sm.k, s_rows);    // S  = Q K^T   (this warp's rows)
    rows_times_tile_t(doa, sm.v, dp_rows);  // dP = dO V^T
    __syncwarp();

#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int cl = half * 32 + j;
      const int col = k0 + cl;
      const bool ok = row_ok && col < S && (!causal || col <= row) && (!segb || sm.seg_k[cl] == seg_r);
      const float p = ok ? __expf(sm.s[r_local * LDS + cl] * scale - row_lse) : 0.f;
      const float ds = p * (sm.dp[r_local * LDS + cl] - row_delta) * scale;
      sm.ds[r_local * LDP + cl] = __float2bfloat16(ds);
    }
    __syncwarp();

    accumulate(acc, sm.ds + warp * 16 * LDP, sm.k);  // dQ += dS K
    __syncthreads();  // every warp is done with K/V/seg_k before the next load
  }

  store_rows(acc, sm.s, r_local, half, row_ok, dq + (((size_t)b * S + row) * H + h) * D);
}

// K2: dK and dV for one (K tile, b * KV + kv), summed over the group's q heads.
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int H, int KV, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDkv& sm = *reinterpret_cast<SmemDkv*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Under the causal mask the first K tiles see the most Q tiles: start them first.
  const int k0 = blockIdx.x * BT;
  const int bkv = blockIdx.y;  // b * KV + kv
  const int b = bkv / KV, kvh = bkv % KV;
  const int group = H / KV;
  const size_t q_rs = (size_t)H * D, kv_rs = (size_t)KV * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * KV + kvh) * D;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;

  load_tile(sm.k, kb, kv_rs, k0, S, tid);
  load_tile(sm.v, vb, kv_rs, k0, S, tid);
  if (tid < BT) sm.seg_k[tid] = (segb && k0 + tid < S) ? segb[k0 + tid] : 0;

  // Elementwise ownership: two lanes per key row, 32 query columns each.
  const int r_local = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int key = k0 + r_local;
  const bool key_ok = key < S;
  __syncthreads();
  const int seg_key = sm.seg_k[r_local];

  FragA ka[D / 16], va[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(ka[kk], sm.k + warp * 16 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(va[kk], sm.v + warp * 16 * LDH + kk * 16, LDH);
  }
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int n_q = (S + BT - 1) / BT;
  const int qi0 = causal ? k0 / BT : 0;  // Q tiles before the diagonal see no key of this tile
  float* s_rows = sm.s + warp * 16 * LDS;
  float* dp_rows = sm.dp + warp * 16 * LDS;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const int bh = b * H + h;
    const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * D;
    const __nv_bfloat16* dob = dout + ((size_t)b * S * H + h) * D;
    for (int qi = qi0; qi < n_q; ++qi) {
      const int q0 = qi * BT;
      load_tile(sm.q, qb, q_rs, q0, S, tid);
      load_tile(sm.dout, dob, q_rs, q0, S, tid);
      load_rows(sm.lse, sm.delta, sm.seg_q, lse + (size_t)bh * S, delta + (size_t)bh * S, segb, q0, S, tid);
      __syncthreads();

      rows_times_tile_t(ka, sm.q, s_rows);       // S^T  = K Q^T   (this warp's keys)
      rows_times_tile_t(va, sm.dout, dp_rows);   // dP^T = V dO^T
      __syncwarp();

#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int cl = half * 32 + j;
        const int row = q0 + cl;  // the query
        const bool ok = key_ok && row < S && (!causal || key <= row) && (!segb || sm.seg_q[cl] == seg_key);
        const float p = ok ? __expf(sm.s[r_local * LDS + cl] * scale - sm.lse[cl]) : 0.f;
        const float ds = p * (sm.dp[r_local * LDS + cl] - sm.delta[cl]) * scale;
        sm.p[r_local * LDP + cl] = __float2bfloat16(p);
        sm.ds[r_local * LDP + cl] = __float2bfloat16(ds);
      }
      __syncwarp();

      accumulate(dv_acc, sm.p + warp * 16 * LDP, sm.dout);  // dV += P^T dO
      accumulate(dk_acc, sm.ds + warp * 16 * LDP, sm.q);    // dK += dS^T Q
      __syncthreads();  // every warp is done with Q/dO/row state before the next load
    }
  }

  const size_t out = (((size_t)b * S + key) * KV + kvh) * D;
  store_rows(dk_acc, sm.s, r_local, half, key_ok, dk + out);
  store_rows(dv_acc, sm.s, r_local, half, key_ok, dv + out);
}

bool bad_args(int B, int S, int H, int KV, int head_dim) {
  return head_dim != D || B <= 0 || S <= 0 || KV <= 0 || H % KV != 0;
}

}  // namespace

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* seg, void* dq,
                                 int B, int S, int H, int KV, int head_dim, int causal, float scale,
                                 void* stream) {
  if (bad_args(B, S, H, KV, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(SmemDq));
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + BT - 1) / BT, B * H);
  flash_bwd_dq_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(dq), S, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// K2. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* seg, void* dk,
                                  void* dv, int B, int S, int H, int KV, int head_dim, int causal,
                                  float scale, void* stream) {
  if (bad_args(B, S, H, KV, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(SmemDkv));
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + BT - 1) / BT, B * KV);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
