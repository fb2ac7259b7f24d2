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
// What bounds them on an H100: operations. At the 250M model's training
// shape (B 16, S 2048, H 16, KV 4, D 64, causal) K3 does 6 * D FLOPs per
// valid (q, k) pair and head (Q K^T, dO V^T, dS K) and K2 8 * D (K Q^T,
// V dO^T, P^T dO, dS^T Q): 206 and 275 GFLOP against 0.24 and 0.21 GB of
// inputs and outputs, 3-4.5x the card's ~295 FLOP/byte ridge; at the 7B
// model's (B 8, S 4096, H 32, KV 8, D 128) 1.65 and 2.2 TFLOP, at the 2B
// model's (B 8, S 4096, H 8, KV 1, D 256) 0.82 and 1.1 TFLOP.
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
//   score, P or dS tile is written to shared memory, but in K2 at D 256
//   (below).
// - Tiles arrive by TMA (cp.async.bulk.tensor, 4-D maps over the
//   [B, S, heads, D] tensors as they are, box 64 x 1 x 64 x 1, 128-byte
//   swizzle that one 64-wide bf16 row fills; the wgmma descriptors use the
//   same swizzle). One producer warp keeps a ring of NSTAGE stages in flight
//   with full/empty mbarriers: K/V tiles (and their segment ids) for K3,
//   Q/dO tiles (and their LSE, delta and segment rows) for K2. A block's own
//   tiles are loaded once. TMA zero-fills rows past S; masking stays by index.
// - K3 at D 64 and 128: three warpgroups per block, two consumers, each
//   owning one 64-row tile of the block's 128 Q rows and sharing every ring
//   tile, and the producer warpgroup, which gives its registers to the
//   consumers with setmaxnreg (56 vs 224 per thread). K3 at D 256: one
//   consumer (64 Q rows) and the producer warpgroup, 256 threads (Dq).
// - K2's producer scheme, per head dim, each for a measured reason (Dkv,
//   dkv_produce; PERF.md section 6):
//   D 64: a producer warpgroup (384 threads, setmaxnreg): the 256-thread
//     block without it measured 1.33x slower (0.949 vs 0.712 ms at B 16 x
//     S 2048), its warp 0 stalling on the slowest warp before each refill.
//   D 128: no producer warpgroup; warp 0 of the first consumer feeds the
//     ring between its tiles (256 threads). Its consumers hold dK and dV,
//     64 x 128 fp32 each, 128 registers a thread, beside S^T and dP^T, 64
//     more: ptxas gives 12 warps 168 registers whatever setmaxnreg asks, and
//     every 12-warp variant spilled; 8 warps take 246, no spill.
//   D 256: the same 256-thread scheme. dK and dV of 64 keys are 256 fp32 a
//     thread in one warpgroup, which no block can hold, so the block owns
//     one key tile and its two consumers split D: each accumulates dK and
//     dV for 128 of the columns (128 fp32) and computes S^T and dP^T for 32
//     of the tile's 64 queries (m64n32k16, 32 fp32); P^T and dS^T go as
//     bf16 into two swizzled exchange panels, and after a named barrier
//     each consumer reads all 64 queries' P^T and dS^T from there as the
//     shared-memory A operand of its dV and dK products. 215 registers, no
//     spill: over 12 warps' 168. Each pair costs 8 D FLOPs; recomputing
//     all of S^T and dP^T in each consumer instead (12 D, no exchange, 244
//     registers) measured 3.43-3.45 ms against 2.74-2.88 ms at B 8 x S 4096.
// - Head dim D is a template parameter, instantiated at 64, 128 and 256. A tile
//   is D / 64 panels of 64 columns (8 KB each, one TMA box each: the
//   128-byte swizzle spans one 64-wide bf16 row). The products over D (S, dP,
//   S^T, dP^T) take D / 16 K-major k16 steps, four in each panel.
//   The products whose N is D (dQ += dS K; dV += P^T dO; dK += dS^T Q) are
//   issued as one m64n64k16 per panel per k16 step, each reading its panel
//   MN-major with the D-64 descriptor: the same descriptor arithmetic as
//   D 64, where one m64n128k16 would need a leading-byte offset across two
//   swizzle atoms that nothing else here uses. Their accumulators are D / 64
//   arrays of 32 fp32 per thread. At D 128 K3 holds Q and dO (2 tiles each,
//   64 KB) and a 3-stage K/V ring (96 KB); K2 K and V (64 KB) and a 3-stage
//   Q/dO ring (96 KB) with its LSE, delta and segment rows. At D 256 K3
//   holds one consumer's Q and dO (64 KB) and a 2-stage K/V ring (128 KB);
//   K2 one key tile of K and V (64 KB), a 2-stage Q/dO ring (128 KB) and
//   the exchange panels (32 KB).
// - Masks only where needed: a tile wholly below the diagonal, inside S and
//   inside one segment takes the unmasked path; only the diagonal tile, the
//   ragged tail and tiles crossing a segment boundary test per element.
//   Tiles wholly above the diagonal are never loaded.
// - The loop in each block takes the place of the TPU kernel's sequential
//   grid axis. K3: one block per (b * H + h, Q block of 64 rows per
//   consumer), walking the K/V tiles up to the diagonal. K2: one block per
//   (b * KV + kv, key block of 128 keys, 64 at D 256), walking the group's
//   q heads times the Q tiles from the diagonal on. Grid y runs heaviest
//   blocks first under the causal mask.
//
// Layout at the interface: q, dO, dQ [B, S, H, D]; k, v, dK, dV [B, S, KV, D]
// (row-major, contiguous, 16-byte aligned); LSE and delta [B*H, S] fp32; seg
// [B, S] int32 or null. D must be 64, 128 or 256. The PTX and host helpers shared
// with K1 (flash_fwd.cu) live in sm90.cuh.

#include "sm90.cuh"

namespace {

using namespace sm90;

// K3's tiling per head dim: NCONS consumer warpgroups, each owning 64 of
// the block's Q rows (its Q and dO tiles), and one producer warpgroup
// feeding a ring of NSTAGE K/V stages. D 64 and 128: two consumers, three
// stages, 384 threads (setmaxnreg 56 vs 224). D 256: one consumer, two
// stages, 256 threads, no setmaxnreg: its dQ (128 fp32 a thread) beside S
// and dP needs more than 12 warps' 168 registers, and Q and dO of two
// consumers (128 KB) beside two 64 KB stages pass the 227 KB a block may have.
template <int D>
struct Dq {
  static constexpr int NCONS = D == 256 ? 1 : 2;
  static constexpr int NSTAGE = D == 256 ? 2 : 3;
  static constexpr int NTHREADS = (NCONS + 1) * 128;
};

// K2's tiling per head dim (the producer schemes: see dkv_produce). NOWN
// own key tiles per block, NSTAGE Q/dO ring stages, two consumer
// warpgroups. D 64 and 128: each consumer owns one of the block's two key
// tiles. D 256 (SPLIT): the block owns one key tile; both consumers work on
// its 64 keys and split D, each holding dK and dV for half the columns.
template <int D>
struct Dkv {
  static constexpr int NOWN = D == 256 ? 1 : 2;
  static constexpr int NSTAGE = D == 256 ? 2 : 3;
  static constexpr bool SPLIT = D == 256;
  static constexpr int NTHREADS = D == 64 ? 384 : 256;
};

// Tiles first: every tile (BT x D bf16, 8 KB per panel) and so every panel
// sits at a multiple of 8 KB from a 1024-byte aligned base, as the 128-byte
// swizzle needs.
template <int D>
struct SmemDq {
  static constexpr int NCONS = Dq<D>::NCONS, NSTAGE = Dq<D>::NSTAGE;
  bf16 q[NCONS][BT * D];
  bf16 dout[NCONS][BT * D];
  bf16 k[NSTAGE][BT * D];
  bf16 v[NSTAGE][BT * D];
  int seg_k[NSTAGE][BT];
  int seg_lo[NSTAGE], seg_hi[NSTAGE];  // over the tile's keys inside S
  int own_lo[NCONS], own_hi[NCONS];    // over each consumer's rows inside S
  uint64_t full[NSTAGE], empty[NSTAGE], own;
};

template <int D>
struct SmemDkv {
  static constexpr int NOWN = Dkv<D>::NOWN, NSTAGE = Dkv<D>::NSTAGE;
  bf16 k[NOWN][BT * D];
  bf16 v[NOWN][BT * D];
  bf16 q[NSTAGE][BT * D];
  bf16 dout[NSTAGE][BT * D];
  float lse[NSTAGE][BT];  // times log2(e)
  float delta[NSTAGE][BT];
  int seg_q[NSTAGE][BT];
  int seg_lo[NSTAGE], seg_hi[NSTAGE];  // over the tile's queries inside S
  int own_lo[NOWN], own_hi[NOWN];      // over each own key tile inside S
  uint64_t full[NSTAGE], empty[NSTAGE], own;
};

// D 256 adds the panels through which the two consumers exchange P^T and
// dS^T (64 keys x 64 queries, bf16, each consumer writing its 32 queries),
// two of each so that tile t + 1's can be written while tile t's are read.
// A mirror of the general struct above, field for field and in its order,
// with xp and xds between dout and lse (there every panel stays 1024-byte
// aligned): an edit to either struct is made to both.
template <>
struct SmemDkv<256> {
  static constexpr int NOWN = 1, NSTAGE = 2;
  bf16 k[NOWN][BT * 256];
  bf16 v[NOWN][BT * 256];
  bf16 q[NSTAGE][BT * 256];
  bf16 dout[NSTAGE][BT * 256];
  bf16 xp[2][PANEL];   // P^T
  bf16 xds[2][PANEL];  // dS^T
  float lse[NSTAGE][BT];
  float delta[NSTAGE][BT];
  int seg_q[NSTAGE][BT];
  int seg_lo[NSTAGE], seg_hi[NSTAGE];
  int own_lo[NOWN], own_hi[NOWN];
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
// NE: 32 for an m64n64 accumulator, 16 for an m64n32 one (D 256: the
// consumer's 32 queries, lse2, delta, seg_q and q0 offset to them).
template <bool MASKED, int NE>
__device__ __forceinline__ void scores_to_p_ds(float (&sc)[NE], float (&dp)[NE], const Rows& keys,
                                               const float* lse2, const float* delta, const int* seg_q, int q0,
                                               int S, int causal, int lane, float scale_log2, float scale) {
#pragma unroll
  for (int j = 0; j < NE / 4; ++j) {
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

template <int D>
__global__ void __launch_bounds__(Dq<D>::NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ seg, bf16* __restrict__ dq, int S, int H, int KV, int causal,
                    float scale) {
  constexpr int NP = D / PANEL_COLS, KSTEPS = D / 16, NCONS = Dq<D>::NCONS, NSTAGE = Dq<D>::NSTAGE;
  extern __shared__ unsigned char smem_raw[];
  SmemDq<D>& sm = *reinterpret_cast<SmemDq<D>*>(align1024(smem_raw));
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * (NCONS * BT);  // heaviest causal blocks first
  int n_tiles = (S + BT - 1) / BT;
  if (causal) n_tiles = min(n_tiles, (q0 + NCONS * BT - 1) / BT + 1);
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  init_barriers<NSTAGE>(sm.full, sm.empty, &sm.own, NCONS * 4);

  if (wg == NCONS) {
    // Producer warpgroup: warp 0 drives the ring, the others only give back
    // their registers (D 64, 128).
    if constexpr (NCONS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x / 32 % 4 == 0) {
      load_own<D, NCONS>(sm.q, sm.dout, &map_q, &map_do, h, q0, b, segb, S, sm.own_lo, sm.own_hi, &sm.own, lane);
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
          mbar_arrive_tx(&sm.full[s], 2 * BT * D * 2);
          tma_tile<D>(sm.k[s], &map_k, &sm.full[s], kvh, k0, b);
          tma_tile<D>(sm.v[s], &map_v, &sm.full[s], kvh, k0, b);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    if constexpr (NCONS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
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

    float acc_dq[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dq[p][i] = 0.f;

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
        for (int kk = 0; kk < KSTEPS; ++kk) wgmma_ss(acc_s, dsc_q + kstep(kk), dsc_k + kstep(kk), kk);
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) wgmma_ss(acc_dp, dsc_do + kstep(kk), dsc_v + kstep(kk), kk);
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
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_panels(acc_dq, a_ds[kk], dsc_k, kk);  // dQ += dS K
        wg_commit();
        wg_wait_all();
        reg_fence(acc_dq);
        reg_fence(a_ds);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
      __syncwarp();
    }
    store_panels(acc_dq, dq + ((size_t)b * S * H + h) * D, (size_t)H * D, row_a, S, lane);
  }
}

// ------------------------------------------------------------- K2 (dK, dV)

// Who feeds K2's ring: a producer warpgroup at D 64, warp 0 of the first
// consumer at D 128 and 256 (the header says why, with the measurements).
//
// The producer's step for ring tile t: the tile's LSE (times log2(e)),
// delta and segment rows into the stage once it is free, then TMA of its Q
// and dO tiles. One warp, all lanes.
template <int D>
__device__ __forceinline__ void dkv_produce(SmemDkv<D>& sm, int t, const CUtensorMap* map_q,
                                            const CUtensorMap* map_do, const float* lse, const float* delta,
                                            const int* segb, int b, int kvh, int group, int H, int S, int n_q,
                                            int qi0, int lane) {
  constexpr int NSTAGE = Dkv<D>::NSTAGE;
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
    mbar_arrive_tx(&sm.full[s], 2 * BT * D * 2);
    tma_tile<D>(sm.q[s], map_q, &sm.full[s], h, q0, b);
    tma_tile<D>(sm.dout[s], map_do, &sm.full[s], h, q0, b);
  } else {
    mbar_arrive(&sm.full[s]);
  }
}

template <int D>
__global__ void __launch_bounds__(Dkv<D>::NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seg, bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                     int KV, int causal, float scale) {
  constexpr int KSTEPS = D / 16, NOWN = Dkv<D>::NOWN, NSTAGE = Dkv<D>::NSTAGE;
  constexpr bool SPLIT = Dkv<D>::SPLIT;
  constexpr int NP = D / PANEL_COLS / (SPLIT ? 2 : 1);  // panels of dK and dV a consumer holds
  extern __shared__ unsigned char smem_raw[];
  SmemDkv<D>& sm = *reinterpret_cast<SmemDkv<D>*>(align1024(smem_raw));
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV, group = H / KV;
  const int k0 = blockIdx.y * (NOWN * BT);  // under the causal mask the first key blocks see the most
  const int n_q = (S + BT - 1) / BT;
  const int qi0 = causal ? k0 / BT : 0;  // Q tiles before the diagonal see none of these keys
  const int n_tiles = group * (n_q - qi0);
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  init_barriers<NSTAGE>(sm.full, sm.empty, &sm.own, 8);

  if (wg == 2) {
    if constexpr (D == 64) {  // only D-64 blocks have a third warpgroup
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
      if (threadIdx.x / 32 % 4 == 0) {
        load_own<D, NOWN>(sm.k, sm.v, &map_k, &map_v, kvh, k0, b, segb, S, sm.own_lo, sm.own_hi, &sm.own, lane);
        for (int t = 0; t < n_tiles; ++t)
          dkv_produce(sm, t, &map_q, &map_do, lse, delta, segb, b, kvh, group, H, S, n_q, qi0, lane);
      }
    }
  } else {
    if constexpr (D == 64) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    } else if (threadIdx.x < 32) {  // warp 0 also produces: the own tiles and the first NSTAGE ring tiles
      load_own<D, NOWN>(sm.k, sm.v, &map_k, &map_v, kvh, k0, b, segb, S, sm.own_lo, sm.own_hi, &sm.own, lane);
      for (int t = 0; t < min(NSTAGE, n_tiles); ++t)
        dkv_produce(sm, t, &map_q, &map_do, lse, delta, segb, b, kvh, group, H, S, n_q, qi0, lane);
    }
    const int warp = (threadIdx.x / 32) % 4;
    const int own = SPLIT ? 0 : wg;  // this consumer's key tile
    const int k0w = k0 + own * BT;   // its 64 keys
    const int key_a = k0w + warp * 16 + lane / 4;
    Rows keys = {};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      keys.idx[h2] = key_a + 8 * h2;
      keys.seg[h2] = segb && keys.idx[h2] < S ? segb[keys.idx[h2]] : 0;
    }
    const float scale_log2 = scale * LOG2E;

    float acc_dk[NP][32], acc_dv[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dk[p][i] = acc_dv[p][i] = 0.f;

    mbar_wait(&sm.own, 0);
    const int own_lo = sm.own_lo[own], own_hi = sm.own_hi[own];
    const uint64_t dsc_k = desc_sw128(sm.k[own]), dsc_v = desc_sw128(sm.v[own]);
    int n_done = 0;  // tiles computed (D 256: picks the exchange buffer)

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NSTAGE, q0 = (qi0 + t % (n_q - qi0)) * BT;
      mbar_wait(&sm.full[s], (t / NSTAGE) & 1);
      // Skip when every query of the tile is before this consumer's keys, or
      // when its keys all lie past S (at D 256 never, and the same for both
      // consumers: they share their keys).
      if (!((causal && q0 + BT - 1 < k0w) || k0w >= S)) {
        const uint64_t dsc_q = desc_sw128(sm.q[s]), dsc_do = desc_sw128(sm.dout[s]);
        if constexpr (SPLIT) {
          // S^T and dP^T for this consumer's 32 of the tile's 64 queries
          // (rows 32 wg .. of the Q and dO tiles: 4 KB into each panel, a
          // whole number of swizzle atoms), then P^T and dS^T in bf16 into
          // the exchange panels, columns 32 wg ..; after the barrier each
          // consumer reads all 64 queries' P^T and dS^T from there.
          constexpr uint64_t HALF = (32 * 128) >> 4;  // descriptor units of 32 rows
          const int c0 = 32 * wg;
          float acc_s[16], acc_dp[16];  // written whole by the first k16 step
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) wgmma_ss_n32(acc_s, dsc_k + kstep(kk), dsc_q + wg * HALF + kstep(kk), kk);
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk)
            wgmma_ss_n32(acc_dp, dsc_v + kstep(kk), dsc_do + wg * HALF + kstep(kk), kk);
          wg_commit();
          wg_wait_all();
          reg_fence(acc_s);
          reg_fence(acc_dp);

          // The mask test and the dispatch are written out in both branches:
          // a shared __forceinline__ helper for them (and, before it, a
          // lambda) changed the D-64 and D-128 machine code (cuobjdump: 4161
          // -> 4705 and 5393 -> 5745 SASS lines), which stays as it was
          // before D 256 was added.
          const bool masked = (causal && q0 < k0w + BT - 1) || q0 + BT > S || k0w + BT > S ||
                              (segb && !(sm.seg_lo[s] == sm.seg_hi[s] && sm.seg_lo[s] == own_lo && own_lo == own_hi));
          if (masked) {
            scores_to_p_ds<true>(acc_s, acc_dp, keys, sm.lse[s] + c0, sm.delta[s] + c0,
                                 segb ? sm.seg_q[s] + c0 : nullptr, q0 + c0, S, causal, lane, scale_log2, scale);
          } else {
            scores_to_p_ds<false>(acc_s, acc_dp, keys, sm.lse[s] + c0, sm.delta[s] + c0, nullptr, q0 + c0, S,
                                  causal, lane, scale_log2, scale);
          }
          // Buffer n_done & 1 was last read two computed tiles ago, which
          // both consumers finished before the barrier of the last one.
          bf16* xp = sm.xp[n_done & 1];
          bf16* xds = sm.xds[n_done & 1];
          store_swizzled(acc_s, xp, c0, warp, lane);
          store_swizzled(acc_dp, xds, c0, warp, lane);
          fence_async_smem();
          named_sync(1, 256);
          const uint64_t dsc_p = desc_sw128(xp), dsc_ds = desc_sw128(xds);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int p = 0; p < NP; ++p)  // dV[:, half] += P^T dO[:, half]
              wgmma_ss_t(acc_dv[p], dsc_p + kk * KMAJOR_STEP, dsc_do + (NP * wg + p) * PANEL_STEP + kk * MNMAJOR_STEP);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int p = 0; p < NP; ++p)  // dK[:, half] += dS^T Q[:, half]
              wgmma_ss_t(acc_dk[p], dsc_ds + kk * KMAJOR_STEP, dsc_q + (NP * wg + p) * PANEL_STEP + kk * MNMAJOR_STEP);
          wg_commit();
          wg_wait_all();
          reg_fence(acc_dv);
          reg_fence(acc_dk);
          ++n_done;
        } else {
          float acc_s[32], acc_dp[32];  // written whole by the first k16 step
          uint32_t a_p[4][4], a_ds[4][4];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) wgmma_ss(acc_s, dsc_k + kstep(kk), dsc_q + kstep(kk), kk);
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) wgmma_ss(acc_dp, dsc_v + kstep(kk), dsc_do + kstep(kk), kk);
          wg_commit();
          wg_wait_all();
          reg_fence(acc_s);
          reg_fence(acc_dp);

          const bool masked = (causal && q0 < k0w + BT - 1) || q0 + BT > S || k0w + BT > S ||
                              (segb && !(sm.seg_lo[s] == sm.seg_hi[s] && sm.seg_lo[s] == own_lo && own_lo == own_hi));
          if (masked) {
            scores_to_p_ds<true>(acc_s, acc_dp, keys, sm.lse[s], sm.delta[s], segb ? sm.seg_q[s] : nullptr, q0,
                                 S, causal, lane, scale_log2, scale);
          } else {
            scores_to_p_ds<false>(acc_s, acc_dp, keys, sm.lse[s], sm.delta[s], nullptr, q0, S, causal, lane,
                                  scale_log2, scale);
          }
          acc_to_a(acc_s, a_p);    // P^T, bf16
          acc_to_a(acc_dp, a_ds);  // dS^T, bf16
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs_panels(acc_dv, a_p[kk], dsc_do, kk);  // dV += P^T dO
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs_panels(acc_dk, a_ds[kk], dsc_q, kk);  // dK += dS^T Q
          wg_commit();
          wg_wait_all();
          reg_fence(acc_dv);
          reg_fence(acc_dk);
          reg_fence(a_p);
          reg_fence(a_ds);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
      __syncwarp();
      // D 128, 256: warp 0 refills this stage with tile t + NSTAGE once
      // every consumer warp has released it.
      if (D != 64 && threadIdx.x < 32 && t + NSTAGE < n_tiles)
        dkv_produce(sm, t + NSTAGE, &map_q, &map_do, lse, delta, segb, b, kvh, group, H, S, n_q, qi0, lane);
    }
    // D 256: this consumer's columns NP * 64 * wg ..
    const size_t out = ((size_t)b * S * KV + kvh) * D + (SPLIT ? NP * PANEL_COLS * wg : 0);
    store_panels(acc_dk, dk + out, (size_t)KV * D, key_a, S, lane);
    store_panels(acc_dv, dv + out, (size_t)KV * D, key_a, S, lane);
  }
}


// ------------------------------------------------------------------- host

// The four maps of one launch, or false.
bool make_maps(CUtensorMap (&m)[4], const void* q, const void* dout, const void* k, const void* v, int B, int S,
               int H, int KV, int D) {
  return make_map(&m[0], q, B, S, H, D) && make_map(&m[1], dout, B, S, H, D) && make_map(&m[2], k, B, S, KV, D) &&
         make_map(&m[3], v, B, S, KV, D);
}

template <int D>
int launch_dq(const CUtensorMap (&m)[4], const void* lse, const void* delta, const void* seg, void* dq, int B, int S,
              int H, int KV, int causal, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(SmemDq<D>)) + 1024;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int rows = Dq<D>::NCONS * BT;
  const dim3 grid(B * H, (S + rows - 1) / rows);
  flash_bwd_dq_kernel<D><<<grid, Dq<D>::NTHREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dq), S, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const CUtensorMap (&m)[4], const void* lse, const void* delta, const void* seg, void* dk, void* dv,
               int B, int S, int H, int KV, int causal, float scale, cudaStream_t stream) {
  // 227 KB, the most a block may have; D 256 leaves 448 bytes of it.
  static_assert(sizeof(SmemDkv<D>) + 1024 <= 232448, "K2's shared memory passes a block's 227 KB");
  const int smem = static_cast<int>(sizeof(SmemDkv<D>)) + 1024;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int keys = Dkv<D>::NOWN * BT;
  const dim3 grid(B * KV, (S + keys - 1) / keys);
  flash_bwd_dkv_kernel<D><<<grid, Dkv<D>::NTHREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
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
  if (!make_maps(m, q, dout, k, v, B, S, H, KV, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_dq<64>(m, lse, delta, seg, dq, B, S, H, KV, causal, scale, st);
    case 128: return launch_dq<128>(m, lse, delta, seg, dq, B, S, H, KV, causal, scale, st);
    case 256: return launch_dq<256>(m, lse, delta, seg, dq, B, S, H, KV, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* seg, void* dk,
                                  void* dv, int B, int S, int H, int KV, int head_dim, int causal,
                                  float scale, void* stream) {
  if (bad_args(B, S, H, KV, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!make_maps(m, q, dout, k, v, B, S, H, KV, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_dkv<64>(m, lse, delta, seg, dk, dv, B, S, H, KV, causal, scale, st);
    case 128: return launch_dkv<128>(m, lse, delta, seg, dk, dv, B, S, H, KV, causal, scale, st);
    case 256: return launch_dkv<256>(m, lse, delta, seg, dk, dv, B, S, H, KV, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
