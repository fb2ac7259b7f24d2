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
// Masked pairs, and pairs whose row or key lies at or past S, get P = 0
// explicitly (a row that saw no key has LSE -1e30 from K1 and only masked
// pairs). K2 owns the GQA sum inside one block: no atomics, and dQ, dK and
// dV are deterministic, launch after launch.
//
// What bounds them on an H100: operations. At the training shape (B 16,
// S 2048, H 16, KV 4, D 64, causal) K3 does 6 * D FLOPs per valid (q, k)
// pair and head (Q K^T, dO V^T, dS K) and K2 8 * D (K Q^T, V dO^T, P^T dO,
// dS^T Q): 206 and 275 GFLOP against 0.24 and 0.21 GB of inputs and
// outputs, 3-4.5x the card's ~295 FLOP/byte ridge.
//
// What this design does about it:
// - Every product is a Hopper warpgroup MMA (wgmma.mma_async m64n64k16, bf16
//   in, fp32 accumulators in registers). The first two products of a tile
//   read both operands from shared memory (K-major); their accumulators hold
//   S and dP (K3) or S^T and dP^T (K2) in registers, where the exponent, the
//   masks and "- delta" run. P and dS are converted to bf16 in registers and
//   fed as the register A operand of the next products (dQ += dS K in K3;
//   dV += P^T dO and dK += dS^T Q in K2), whose B operand (K, dO, Q) is read
//   MN-major from the same shared-memory tile through the transpose bit. No
//   score, P or dS tile is ever written to shared memory.
// - Tiles arrive by TMA (cp.async.bulk.tensor, 4-D maps over the
//   [B, S, heads, D] tensors as they are, box 64 x 1 x 64 x 1, 128-byte
//   swizzle that one 64-wide bf16 row fills; the wgmma descriptors use the
//   same swizzle). One producer warp keeps a ring of NSTAGE stages in flight
//   with full/empty mbarriers: K/V tiles (and their segment ids) for K3,
//   Q/dO tiles (and their LSE, delta and segment rows) for K2. A block's own
//   tiles are loaded once. TMA zero-fills rows past S; masking stays by index.
// - Three warpgroups per block: two consumers, each owning one 64-row tile of
//   the block's own operand (128 Q rows in K3, 128 keys in K2) and sharing
//   every ring tile, and the producer warpgroup, which gives its registers
//   to the consumers with setmaxnreg (56 vs 224 per thread).
// - Masks only where needed: a tile wholly below the diagonal, inside S and
//   inside one segment takes the unmasked path; only the diagonal tile, the
//   ragged tail and tiles crossing a segment boundary test per element.
//   Tiles wholly above the diagonal are never loaded.
// - The loop in each block takes the place of the TPU kernel's sequential
//   grid axis. K3: one block per (b * H + h, 128-row Q block), walking the
//   K/V tiles up to the diagonal. K2: one block per (b * KV + kv, 128-key
//   block), walking the group's q heads times the Q tiles from the diagonal
//   on. Grid y runs heaviest blocks first under the causal mask.
//
// Layout at the interface: q, dO, dQ [B, S, H, D]; k, v, dK, dV [B, S, KV, D]
// (row-major, contiguous, 16-byte aligned); LSE and delta [B*H, S] fp32; seg
// [B, S] int32 or null. D must be 64. The PTX and host helpers shared with
// K1 (flash_fwd.cu) live in sm90.cuh.

#include "sm90.cuh"

namespace {

using namespace sm90;

// Ring tiles first: every tile sits at a multiple of 8 KB from a 1024-byte
// aligned base, as the 128-byte swizzle needs.
struct SmemDq {
  bf16 q[NCONS][TILE];
  bf16 dout[NCONS][TILE];
  bf16 k[NSTAGE][TILE];
  bf16 v[NSTAGE][TILE];
  int seg_k[NSTAGE][BT];
  int seg_lo[NSTAGE], seg_hi[NSTAGE];  // over the tile's keys inside S
  int own_lo[NCONS], own_hi[NCONS];    // over each consumer's rows inside S
  uint64_t full[NSTAGE], empty[NSTAGE], own;
};

struct SmemDkv {
  bf16 k[NCONS][TILE];
  bf16 v[NCONS][TILE];
  bf16 q[NSTAGE][TILE];
  bf16 dout[NSTAGE][TILE];
  float lse[NSTAGE][BT];  // times log2(e)
  float delta[NSTAGE][BT];
  int seg_q[NSTAGE][BT];
  int seg_lo[NSTAGE], seg_hi[NSTAGE];  // over the tile's queries inside S
  int own_lo[NCONS], own_hi[NCONS];    // over each consumer's keys inside S
  uint64_t full[NSTAGE], empty[NSTAGE], own;
};

// ------------------------------------------------------- elementwise steps

// A consumer thread's two rows (accumulator elements with (i >> 1) & 1 = 0
// and 1): index, segment id and, in K3, LSE * log2(e) and delta.
struct Rows {
  int idx[2], seg[2];
  float lse2[2], delta[2];
};

// K3's elementwise step, S -> dS in place: P = 2^(S scale log2(e) - LSE
// log2(e)), dS = P (dP - delta) scale. MASKED adds the per-element causal,
// ragged and segment tests (seg_k: the tile's key segments, or null); the
// two instances keep the tests off the tiles that need none.
template <bool MASKED>
__device__ __forceinline__ void scores_to_ds(float (&sc)[32], const float (&dp)[32], const Rows& r,
                                             const int* seg_k, int k0, int S, int causal, int lane,
                                             float scale_log2, float scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float p = ex2(fmaf(sc[i], scale_log2, -r.lse2[h]));
    if (MASKED) {
      const int cl = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1), col = k0 + cl;
      const bool ok = col < S && (!causal || col <= r.idx[h]) && (!seg_k || seg_k[cl] == r.seg[h]);
      p = ok ? p : 0.f;
    }
    sc[i] = p * (dp[i] - r.delta[h]) * scale;
  }
}

// K2's elementwise step on S^T and dP^T (rows are keys, columns queries):
// S^T -> P^T and dP^T -> dS^T in place, with each query column's LSE *
// log2(e) and delta read from the stage (lse2, delta) one column pair
// (8 j + 2 (lane & 3)) at a time. MASKED as in scores_to_ds (seg_q: the
// tile's query segments, or null).
template <bool MASKED>
__device__ __forceinline__ void scores_to_p_ds(float (&sc)[32], float (&dp)[32], const Rows& keys,
                                               const float* lse2, const float* delta, const int* seg_q, int q0,
                                               int S, int causal, int lane, float scale_log2, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c0 = 8 * j + 2 * (lane & 3);
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c0);
    const float2 dl = *reinterpret_cast<const float2*>(delta + c0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * j + r, h = r >> 1;
      float p = ex2(fmaf(sc[i], scale_log2, -((r & 1) ? l2.y : l2.x)));
      if (MASKED) {
        const int cl = c0 + (r & 1), col = q0 + cl, key = keys.idx[h];
        const bool ok = key < S && col < S && (!causal || key <= col) && (!seg_q || seg_q[cl] == keys.seg[h]);
        p = ok ? p : 0.f;
      }
      dp[i] = p * (dp[i] - ((r & 1) ? dl.y : dl.x)) * scale;
      sc[i] = p;
    }
  }
}

// ----------------------------------------------------------------- K3 (dQ)

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ seg, bf16* __restrict__ dq, int S, int H, int KV, int causal,
                    float scale) {
  extern __shared__ unsigned char smem_raw[];
  SmemDq& sm = *reinterpret_cast<SmemDq*>(align1024(smem_raw));
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
      load_own(sm.q, sm.dout, &map_q, &map_do, h, q0, b, segb, S, sm.own_lo, sm.own_hi, &sm.own, lane);
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
    // Rows at or past S: LSE and delta 0, Q and dO zero-filled, so dS = 0;
    // their dQ rows are never stored.
    Rows rows;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row_a + 8 * h2;
      rows.idx[h2] = row;
      rows.seg[h2] = segb && row < S ? segb[row] : 0;
      rows.lse2[h2] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
      rows.delta[h2] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    const float scale_log2 = scale * LOG2E;

    float acc_dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dq[i] = 0.f;

    mbar_wait(&sm.own, 0);
    const int own_lo = sm.own_lo[wg], own_hi = sm.own_hi[wg];
    const uint64_t dsc_q = desc_sw128(sm.q[wg]), dsc_do = desc_sw128(sm.dout[wg]);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NSTAGE, k0 = t * BT;
      mbar_wait(&sm.full[s], (t / NSTAGE) & 1);
      if (!(causal && k0 > q0w + BT - 1)) {  // else: every key of the tile is above this consumer's rows
        const uint64_t dsc_k = desc_sw128(sm.k[s]), dsc_v = desc_sw128(sm.v[s]);
        float acc_s[32], acc_dp[32];  // written whole by the first k16 step
        uint32_t a_ds[4][4];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc_s, dsc_q + kk * KMAJOR_STEP, dsc_k + kk * KMAJOR_STEP, kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc_dp, dsc_do + kk * KMAJOR_STEP, dsc_v + kk * KMAJOR_STEP, kk);
        wg_commit();
        wg_wait_all();
        reg_fence(acc_s);
        reg_fence(acc_dp);

        const bool masked = (causal && k0 + BT - 1 > q0w) || k0 + BT > S ||
                            (segb && !(sm.seg_lo[s] == sm.seg_hi[s] && sm.seg_lo[s] == own_lo && own_lo == own_hi));
        if (masked) {
          scores_to_ds<true>(acc_s, acc_dp, rows, segb ? sm.seg_k[s] : nullptr, k0, S, causal, lane, scale_log2, scale);
        } else {
          scores_to_ds<false>(acc_s, acc_dp, rows, nullptr, k0, S, causal, lane, scale_log2, scale);
        }
        acc_to_a(acc_s, a_ds);  // dS, bf16
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_dq, a_ds[kk], dsc_k + kk * MNMAJOR_STEP);  // dQ += dS K
        wg_commit();
        wg_wait_all();
        reg_fence(acc_dq);
        reg_fence(a_ds);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
      __syncwarp();
    }
    store_rows(acc_dq, dq + ((size_t)b * S * H + h) * D, (size_t)H * D, row_a, S, lane);
  }
}

// ------------------------------------------------------------- K2 (dK, dV)

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seg, bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                     int KV, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  SmemDkv& sm = *reinterpret_cast<SmemDkv*>(align1024(smem_raw));
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV, group = H / KV;
  const int k0 = blockIdx.y * (NCONS * BT);  // under the causal mask the first key blocks see the most
  const int n_q = (S + BT - 1) / BT;
  const int qi0 = causal ? k0 / BT : 0;  // Q tiles before the diagonal see none of these keys
  const int n_tiles = group * (n_q - qi0);
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  init_barriers(sm.full, sm.empty, &sm.own);

  if (wg == NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x / 32 % 4 == 0) {
      load_own(sm.k, sm.v, &map_k, &map_v, kvh, k0, b, segb, S, sm.own_lo, sm.own_hi, &sm.own, lane);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NSTAGE;
        const int g = t / (n_q - qi0), q0 = (qi0 + t % (n_q - qi0)) * BT;
        const int h = kvh * group + g;
        const float* lrow = lse + (size_t)(b * H + h) * S;
        const float* drow = delta + (size_t)(b * H + h) * S;
        const int r0 = q0 + lane, r1 = r0 + 32;
        // Row state first, so its load latency overlaps the wait.
        const float l0 = r0 < S ? lrow[r0] * LOG2E : 0.f, l1 = r1 < S ? lrow[r1] * LOG2E : 0.f;
        const float d0 = r0 < S ? drow[r0] : 0.f, d1 = r1 < S ? drow[r1] : 0.f;
        const int s0 = segb && r0 < S ? segb[r0] : 0, s1 = segb && r1 < S ? segb[r1] : 0;
        mbar_wait(&sm.empty[s], ((t / NSTAGE) & 1) ^ 1);
        sm.lse[s][lane] = l0;
        sm.lse[s][lane + 32] = l1;
        sm.delta[s][lane] = d0;
        sm.delta[s][lane + 32] = d1;
        if (segb) {
          int lo, hi;
          warp_range(s0, r0 < S, s1, r1 < S, lo, hi);
          sm.seg_q[s][lane] = s0;
          sm.seg_q[s][lane + 32] = s1;
          if (lane == 0) {
            sm.seg_lo[s] = lo;
            sm.seg_hi[s] = hi;
          }
        }
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[s], 2 * TILE_BYTES);
          tma_load(sm.q[s], &map_q, &sm.full[s], h, q0, b);
          tma_load(sm.dout[s], &map_do, &sm.full[s], h, q0, b);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4;
    const int k0w = k0 + wg * BT;  // this consumer's 64 keys
    const int key_a = k0w + warp * 16 + lane / 4;
    Rows keys = {};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      keys.idx[h2] = key_a + 8 * h2;
      keys.seg[h2] = segb && keys.idx[h2] < S ? segb[keys.idx[h2]] : 0;
    }
    const float scale_log2 = scale * LOG2E;

    float acc_dk[32], acc_dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    mbar_wait(&sm.own, 0);
    const int own_lo = sm.own_lo[wg], own_hi = sm.own_hi[wg];
    const uint64_t dsc_k = desc_sw128(sm.k[wg]), dsc_v = desc_sw128(sm.v[wg]);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NSTAGE, q0 = (qi0 + t % (n_q - qi0)) * BT;
      mbar_wait(&sm.full[s], (t / NSTAGE) & 1);
      // Skip when every query of the tile is before this consumer's keys, or
      // when its keys all lie past S.
      if (!((causal && q0 + BT - 1 < k0w) || k0w >= S)) {
        const uint64_t dsc_q = desc_sw128(sm.q[s]), dsc_do = desc_sw128(sm.dout[s]);
        float acc_s[32], acc_dp[32];  // written whole by the first k16 step
        uint32_t a_p[4][4], a_ds[4][4];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc_s, dsc_k + kk * KMAJOR_STEP, dsc_q + kk * KMAJOR_STEP, kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc_dp, dsc_v + kk * KMAJOR_STEP, dsc_do + kk * KMAJOR_STEP, kk);
        wg_commit();
        wg_wait_all();
        reg_fence(acc_s);
        reg_fence(acc_dp);

        const bool masked = (causal && q0 < k0w + BT - 1) || q0 + BT > S || k0w + BT > S ||
                            (segb && !(sm.seg_lo[s] == sm.seg_hi[s] && sm.seg_lo[s] == own_lo && own_lo == own_hi));
        if (masked) {
          scores_to_p_ds<true>(acc_s, acc_dp, keys, sm.lse[s], sm.delta[s], segb ? sm.seg_q[s] : nullptr, q0, S,
                               causal, lane, scale_log2, scale);
        } else {
          scores_to_p_ds<false>(acc_s, acc_dp, keys, sm.lse[s], sm.delta[s], nullptr, q0, S, causal, lane,
                                scale_log2, scale);
        }
        acc_to_a(acc_s, a_p);    // P^T, bf16
        acc_to_a(acc_dp, a_ds);  // dS^T, bf16
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_dv, a_p[kk], dsc_do + kk * MNMAJOR_STEP);  // dV += P^T dO
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_dk, a_ds[kk], dsc_q + kk * MNMAJOR_STEP);  // dK += dS^T Q
        wg_commit();
        wg_wait_all();
        reg_fence(acc_dv);
        reg_fence(acc_dk);
        reg_fence(a_p);
        reg_fence(a_ds);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
      __syncwarp();
    }
    const size_t out = ((size_t)b * S * KV + kvh) * D;
    store_rows(acc_dk, dk + out, (size_t)KV * D, key_a, S, lane);
    store_rows(acc_dv, dv + out, (size_t)KV * D, key_a, S, lane);
  }
}

// ------------------------------------------------------------------- host

// The four maps of one launch, or false.
bool make_maps(CUtensorMap (&m)[4], const void* q, const void* dout, const void* k, const void* v, int B, int S,
               int H, int KV) {
  return make_map(&m[0], q, B, S, H) && make_map(&m[1], dout, B, S, H) && make_map(&m[2], k, B, S, KV) &&
         make_map(&m[3], v, B, S, KV);
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
  CUtensorMap m[4];
  if (!make_maps(m, q, dout, k, v, B, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(SmemDq)) + 1024;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + NCONS * BT - 1) / (NCONS * BT));
  flash_bwd_dq_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dq), S, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// K2. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* seg, void* dk,
                                  void* dv, int B, int S, int H, int KV, int head_dim, int causal,
                                  float scale, void* stream) {
  if (bad_args(B, S, H, KV, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!make_maps(m, q, dout, k, v, B, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(SmemDkv)) + 1024;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * KV, (S + NCONS * BT - 1) / (NCONS * BT));
  flash_bwd_dkv_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
