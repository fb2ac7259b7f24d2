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
// [B, S] int32 or null. D must be 64.

#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                  // head dim: one 128-byte bf16 row
constexpr int BT = 64;                 // rows per tile: the wgmma M
constexpr int NCONS = 2;               // consumer warpgroups per block
constexpr int NTHREADS = (NCONS + 1) * 128;
constexpr int NSTAGE = 3;              // ring depth
constexpr int TILE = BT * D;           // bf16 elements per tile
constexpr uint32_t TILE_BYTES = TILE * 2;
constexpr int CONS_WARPS = NCONS * 4;  // arrivals that release a ring stage
constexpr float LOG2E = 1.4426950408889634f;
typedef __nv_bfloat16 bf16;

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

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of the given parity. A
// wait that outlasts ~10 s of clock means a lost arrival: trap, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023u) == 1023u && clock64() - t0 > 20000000000LL) __trap();
  }
}

// One 64-row box of a [B, S, heads, D] tensor map into shared memory.
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap* map, uint64_t* bar, int head, int row,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(head), "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 64 x 64 bf16 tile written by TMA with
// the 128-byte swizzle: rows 128 B apart, 8-row groups 1024 B apart (SBO),
// LBO unused (1), layout type 1 = 128-byte swizzle. The same descriptor
// serves K-major reads (advance 32 B per k16 step along the row) and
// MN-major reads (advance 16 rows = 2048 B per k16 step).
__device__ __forceinline__ uint64_t desc_sw128(const bf16* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
constexpr uint64_t KMAJOR_STEP = 32 >> 4;    // descriptor units per k16 step, K-major
constexpr uint64_t MNMAJOR_STEP = 2048 >> 4;  // the same, MN-major

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keeps the compiler from moving register reads or writes across the
// asynchronous span of a wgmma (from the instruction to its wait).
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WG_ACC32                                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, " \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC_OPS(d)                                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),   \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),    \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),    \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64 fp32) = (accumulate ? d : 0) + A B^T for one k16 step; A
// (64 x 16) and B (64 x 16) both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for one k16 step: A (64 x 16 bf16) in registers, B (16 x 64)
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element i of a thread's 64 x 64 wgmma accumulator holds row (within the
// warpgroup's 64) warp * 16 + lane / 4 + 8 * ((i >> 1) & 1) and column
// 8 * (i >> 2) + 2 * (lane & 3) + (i & 1).
// The accumulator as the register A operand of the next wgmma: k16 step kk
// takes columns 16 kk .. 16 kk + 15, which this thread holds as
// d[8 kk .. 8 kk + 7] in the order the A fragment wants.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

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

// Writes a consumer's 64 rows of acc as bf16 into a [.., S, heads, D] tensor
// (row stride `rs` elements), rows at or past S skipped.
__device__ __forceinline__ void store_rows(const float (&acc)[32], bf16* base, size_t rs, int row_a, int S,
                                          int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row < S) {
      bf16* dst = base + (size_t)row * rs;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// Min and max of the warp's valid values (INT_MAX / INT_MIN when none).
__device__ __forceinline__ void warp_range(int v0, bool ok0, int v1, bool ok1, int& lo, int& hi) {
  lo = min(ok0 ? v0 : INT_MAX, ok1 ? v1 : INT_MAX);
  hi = max(ok0 ? v0 : INT_MIN, ok1 ? v1 : INT_MIN);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// The producer's own-tile step: segment ranges of each consumer's 64 rows
// (starting at r0), then TMA of two maps' tiles for both consumers, all on
// the `own` barrier (32 arrivals + the bytes).
__device__ __forceinline__ void load_own(bf16 (*a)[TILE], bf16 (*b)[TILE], const CUtensorMap* ma,
                                         const CUtensorMap* mb, int head, int r0, int bidx, const int* segb,
                                         int S, int* own_lo, int* own_hi, uint64_t* bar, int lane) {
  for (int w = 0; w < NCONS; ++w) {
    const int r = r0 + w * BT + lane;
    int lo = 0, hi = 0;
    if (segb) {
      warp_range(r < S ? segb[r] : 0, r < S, r + 32 < S ? segb[r + 32] : 0, r + 32 < S, lo, hi);
    }
    if (lane == 0) {
      own_lo[w] = lo;
      own_hi[w] = hi;
    }
  }
  if (lane == 0) {
    mbar_arrive_tx(bar, 2 * NCONS * TILE_BYTES);
    for (int w = 0; w < NCONS; ++w) {
      tma_load(a[w], ma, bar, head, r0 + w * BT, bidx);
      tma_load(b[w], mb, bar, head, r0 + w * BT, bidx);
    }
  } else {
    mbar_arrive(bar);
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* own) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 32);           // the producer warp's lanes (lane 0 with the bytes)
      mbar_init(&empty[s], CONS_WARPS);  // one per consumer warp
    }
    mbar_init(own, 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous [B, S, heads, D] bf16 tensor: box (D, 1 head,
// 64 rows, 1), 128-byte swizzle, zero fill past S.
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2, (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)BT, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool bad_args(int B, int S, int H, int KV, int head_dim) {
  return head_dim != D || B <= 0 || S <= 0 || KV <= 0 || H % KV != 0;
}

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
