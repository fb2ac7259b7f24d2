// Flash-attention forward for Hopper (sm_90a): kernel K1 of the port. bf16
// in, bf16 out, fp32 softmax state and accumulators.
//
// Replaces: ray_tpu/ops/attention.py `_fwd_kernel` (launched by `_fwd_pallas`).
// Same function: O = softmax(scale * Q K^T + mask) V with the causal mask
// (or none), an optional same-segment mask, native GQA (q head h reads kv
// head h / group, K/V never repeated), and the per-row LSE = m + log(l) in
// natural-log units; a row that sees no valid key writes O = 0 and LSE
// -1e30. A ragged S (not a multiple of the tile) is masked here; the TPU
// wrapper fell back to its reference path for that case instead.
//
// What bounds it on an H100: operations. Causal attention does 4 * D FLOPs
// per valid (q, k) pair and head (Q K^T and P V): at the training shape
// (B 16, S 2048, H 16, KV 4, D 64) 137 GFLOP against 0.02 GB of inputs and
// outputs, far above the card's ~295 FLOP/byte ridge. Next to the products
// it does one exp per pair, on the special-function unit, whose rate is
// about a quarter of the tensor cores' at D 64: the softmax must overlap the
// products of the other warpgroup to keep them busy.
//
// What this design does about it (the design of K3 in flash_bwd.cu, with
// one product fewer):
// - Both products are Hopper warpgroup MMAs (wgmma.mma_async m64n64k16, bf16
//   in, fp32 accumulators in registers). S = Q K^T reads both operands from
//   shared memory, K-major. The online softmax runs on S's accumulator in
//   registers (each thread owns two rows; row max and sum reduced over the
//   four lanes of a quad), in base 2 with scale * log2(e) folded in. P is
//   converted to bf16 in registers and fed as the register A operand of
//   O += P V, whose B operand V is read MN-major from its tile through the
//   transpose bit. No score or P tile is ever written to shared memory.
// - Tiles arrive by TMA (4-D maps over the [B, S, heads, D] tensors as they
//   are, box 64 x 1 x 64 x 1, 128-byte swizzle, zero fill past S). The
//   block's two Q tiles come once; K/V tiles of 64 keys, with their segment
//   ids and segment range, through a 3-stage ring of full/empty mbarriers
//   fed by one producer warp.
// - Three warpgroups per block: two consumers, each owning 64 of the
//   block's 128 Q rows and sharing every K/V tile, and the producer
//   warpgroup, which gives its registers to the consumers with setmaxnreg
//   (56 vs 224 per thread).
// - A one-tile software pipeline in each consumer: S of tile t is issued
//   together with O += P V of tile t - 1 (wgmma.wait_group 1 waits for S
//   alone), so tile t's softmax runs while the tensor cores finish P V; O
//   is rescaled once that product is in. 16 % faster at the training shape
//   than waiting for each product in turn (PERF.md).
// - Masks only where needed: the diagonal tile, the ragged tail and tiles
//   that cross a segment boundary take the MASKED instance of the softmax;
//   every other tile the unmasked one. Tiles wholly above the diagonal are
//   never loaded. A row that has seen no valid key keeps m = -inf and
//   p = 0 with no (-inf) - (-inf).
// - One block per (b * H + h, 128-row Q block); grid y runs the heaviest
//   causal blocks first. No atomics: O and LSE are the same bits launch
//   after launch.
//
// Layout at the interface: q/o [B, S, H, D], k/v [B, S, KV, D] (row-major,
// contiguous, 16-byte aligned), seg [B, S] int32 or null, lse [B*H, S] fp32.
// D must be 64. Helpers shared with K3/K2 live in sm90.cuh.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float LN2 = 0.6931471805599453f;

// Ring tiles first: every tile sits at a multiple of 8 KB from a 1024-byte
// aligned base, as the 128-byte swizzle needs.
struct SmemFwd {
  bf16 q[NCONS][TILE];
  bf16 k[NSTAGE][TILE];
  bf16 v[NSTAGE][TILE];
  int seg_k[NSTAGE][BT];
  int seg_lo[NSTAGE], seg_hi[NSTAGE];  // over the tile's keys inside S
  int own_lo[NCONS], own_hi[NCONS];    // over each consumer's rows inside S
  uint64_t full[NSTAGE], empty[NSTAGE], own;
};

// A consumer thread's two rows (accumulator elements with (i >> 1) & 1 = 0
// and 1): index, segment id, running max m of the scaled scores (base 2;
// -inf until the row sees a valid key) and this thread's share of the sum
// l (its 16 columns of the row; the quad's shares are added at the end).
struct RowState {
  int idx[2], seg[2];
  float m[2], l[2];
};

// The online-softmax step on one tile, in place: S -> P (fp32, to be
// rounded to bf16 for P V), m and l updated, and alpha = 2^(m_old - m_new),
// by which the O accumulator is to be rescaled. MASKED adds the per-element
// causal, ragged and segment tests (seg_k: the tile's key segments, or null).
template <bool MASKED>
__device__ __forceinline__ void softmax_step(float (&sc)[32], RowState& r, const int* seg_k, int k0, int S,
                                             int causal, int lane, float scale_log2, float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float x = sc[i] * scale_log2;
    if (MASKED) {
      const int cl = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1), col = k0 + cl;
      const bool ok = col < S && (!causal || col <= r.idx[h]) && (!seg_k || seg_k[cl] == r.seg[h]);
      x = ok ? x : -INFINITY;
    }
    sc[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(r.m[h], mx[h]);
    base[h] = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet: p = 2^-inf = 0
    alpha[h] = ex2(r.m[h] - base[h]);            // 0 when m_old = -inf
    r.m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const float p = ex2(sc[i] - base[h]);
    sc[i] = p;
    sum[h] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) r.l[h] = r.l[h] * alpha[h] + sum[h];
}

// The softmax step on ring tile t, through the MASKED instance where the
// tile holds the diagonal, the ragged tail or a segment boundary.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], RowState& r, const SmemFwd& sm, const int* segb, int t,
                                             int q0w, int own_lo, int own_hi, int S, int causal, int lane,
                                             float scale_log2, float (&alpha)[2]) {
  const int s = t % NSTAGE, k0 = t * BT;
  const bool masked = (causal && k0 + BT - 1 > q0w) || k0 + BT > S ||
                      (segb && !(sm.seg_lo[s] == sm.seg_hi[s] && sm.seg_lo[s] == own_lo && own_lo == own_hi));
  if (masked) {
    softmax_step<true>(sc, r, segb ? sm.seg_k[s] : nullptr, k0, S, causal, lane, scale_log2, alpha);
  } else {
    softmax_step<false>(sc, r, nullptr, k0, S, causal, lane, scale_log2, alpha);
  }
}

// Releases ring tile t's stage: one arrival per consumer warp.
__device__ __forceinline__ void release(uint64_t* empty, int t, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[t % NSTAGE]);
  __syncwarp();
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const int* __restrict__ seg, bf16* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KV, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  SmemFwd& sm = *reinterpret_cast<SmemFwd*>(align1024(smem_raw));
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * (NCONS * BT);  // heaviest causal blocks first
  int n_tiles = (S + BT - 1) / BT;
  if (causal) n_tiles = min(n_tiles, (q0 + NCONS * BT - 1) / BT + 1);
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  init_barriers(sm.full, sm.empty, &sm.own);

  if (wg == NCONS) {
    // Producer warpgroup: warp 0 drives the ring, the others only give back
    // their registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x / 32 % 4 == 0) {
      load_own(sm.q, nullptr, &map_q, nullptr, h, q0, b, segb, S, sm.own_lo, sm.own_hi, &sm.own, lane);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NSTAGE, k0 = t * BT;
        int sk0 = 0, sk1 = 0;
        if (segb) {
          sk0 = k0 + lane < S ? segb[k0 + lane] : 0;
          sk1 = k0 + lane + 32 < S ? segb[k0 + lane + 32] : 0;
        }
        mbar_wait(&sm.empty[s], ((t / NSTAGE) & 1) ^ 1);
        if (segb) {
          int lo, hi;
          warp_range(sk0, k0 + lane < S, sk1, k0 + lane + 32 < S, lo, hi);
          sm.seg_k[s][lane] = sk0;
          sm.seg_k[s][lane + 32] = sk1;
          if (lane == 0) {
            sm.seg_lo[s] = lo;
            sm.seg_hi[s] = hi;
          }
        }
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[s], 2 * TILE_BYTES);
          tma_load(sm.k[s], &map_k, &sm.full[s], kvh, k0, b);
          tma_load(sm.v[s], &map_v, &sm.full[s], kvh, k0, b);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4;
    const int q0w = q0 + wg * BT;  // this consumer's 64 rows
    const int row_a = q0w + warp * 16 + lane / 4;
    // Rows at or past S read zero-filled Q; their O and LSE are never stored.
    RowState rows;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row_a + 8 * h2;
      rows.idx[h2] = row;
      rows.seg[h2] = segb && row < S ? segb[row] : 0;
      rows.m[h2] = -INFINITY;
      rows.l[h2] = 0.f;
    }
    const float scale_log2 = scale * LOG2E;

    float acc_o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_o[i] = 0.f;

    mbar_wait(&sm.own, 0);
    const int own_lo = sm.own_lo[wg], own_hi = sm.own_hi[wg];
    const uint64_t dsc_q = desc_sw128(sm.q[wg]);

    // A one-tile software pipeline: S of tile t is issued together with
    // O += P V of tile t - 1, and tile t's softmax runs while that product
    // is in flight. Tiles from n_mine on lie wholly above this consumer's
    // rows (causal): they are only waited for and released.
    const int n_mine = causal ? min(n_tiles, (q0w + BT - 1) / BT + 1) : n_tiles;
    float acc_s[32], alpha[2];
    uint32_t a_p[4][4];
    mbar_wait(&sm.full[0], 0);
    {
      const uint64_t dsc_k = desc_sw128(sm.k[0]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc_s, dsc_q + kk * KMAJOR_STEP, dsc_k + kk * KMAJOR_STEP, kk);
      wg_commit();
      wg_wait_all();
      reg_fence(acc_s);
    }
    // O is still 0: tile 0 needs no rescale.
    softmax_tile(acc_s, rows, sm, segb, 0, q0w, own_lo, own_hi, S, causal, lane, scale_log2, alpha);
    acc_to_a(acc_s, a_p);
    for (int t = 1; t < n_mine; ++t) {
      mbar_wait(&sm.full[t % NSTAGE], (t / NSTAGE) & 1);
      const uint64_t dsc_k = desc_sw128(sm.k[t % NSTAGE]), dsc_v = desc_sw128(sm.v[(t - 1) % NSTAGE]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc_s, dsc_q + kk * KMAJOR_STEP, dsc_k + kk * KMAJOR_STEP, kk);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_o, a_p[kk], dsc_v + kk * MNMAJOR_STEP);  // O += P V, tile t - 1
      wg_commit();
      reg_fence(acc_o);
      wg_wait<1>();  // S of tile t is in; P V may still run
      reg_fence(acc_s);
      softmax_tile(acc_s, rows, sm, segb, t, q0w, own_lo, own_hi, S, causal, lane, scale_log2, alpha);
      wg_wait<0>();
      reg_fence(acc_o);
      reg_fence(a_p);
      release(sm.empty, t - 1, lane);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_o[i] *= alpha[(i >> 1) & 1];
      acc_to_a(acc_s, a_p);
    }
    {
      const uint64_t dsc_v = desc_sw128(sm.v[(n_mine - 1) % NSTAGE]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_o, a_p[kk], dsc_v + kk * MNMAJOR_STEP);
      wg_commit();
      wg_wait_all();
      reg_fence(acc_o);
      reg_fence(a_p);
    }
    release(sm.empty, n_mine - 1, lane);
    for (int t = n_mine; t < n_tiles; ++t) {
      mbar_wait(&sm.full[t % NSTAGE], (t / NSTAGE) & 1);
      release(sm.empty, t, lane);
    }

    // Epilogue: the quad's shares of l, O / l in bf16, LSE in natural log.
    float inv[2], lse_row[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float l = rows.l[h2];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[h2] = l > 0.f ? 1.f / l : 0.f;
      lse_row[h2] = l > 0.f ? (rows.m[h2] + log2f(l)) * LN2 : -1e30f;
    }
    store_rows(acc_o, o + ((size_t)b * S * H + h) * D, (size_t)H * D, row_a, S, lane, inv[0], inv[1]);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        if (rows.idx[h2] < S) lse[(size_t)bh * S + rows.idx[h2]] = lse_row[h2];
      }
    }
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
  if (bad_args(B, S, H, KV, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[3];
  if (!(make_map(&m[0], q, B, S, H) && make_map(&m[1], k, B, S, KV) && make_map(&m[2], v, B, S, KV))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(SmemFwd)) + 1024;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + NCONS * BT - 1) / (NCONS * BT));
  flash_fwd_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], static_cast<const int*>(seg), static_cast<bf16*>(o), static_cast<float*>(lse), S, H, KV,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}
