// Hopper (sm_90a) building blocks shared by the port's kernels: the PTX
// wrappers for mbarriers, TMA loads and warpgroup MMAs (wgmma), the
// register-level helpers of the flash kernels (K1 in flash_fwd.cu, K3 and K2
// in flash_bwd.cu), and on the host the run-time lookup of
// cuTensorMapEncodeTiled with the 4-D tensor-map builder over a
// [B, S, heads, D] bf16 tensor.
//
// Everything is in namespace sm90; each kernel source is compiled on its own
// (one nvcc per .cu), so nothing here is shared at link time. The flash
// kernels use the constants below: D 64 (one 128-byte bf16 row), 64-row
// tiles (the wgmma M), two consumer warpgroups and one producer warpgroup per
// block, a ring of NSTAGE stages.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;                  // head dim: one 128-byte bf16 row
constexpr int BT = 64;                 // rows per tile: the wgmma M
constexpr int NCONS = 2;               // consumer warpgroups per block
constexpr int NTHREADS = (NCONS + 1) * 128;
constexpr int NSTAGE = 3;              // ring depth
constexpr int TILE = BT * D;           // bf16 elements per tile
constexpr uint32_t TILE_BYTES = TILE * 2;
constexpr int CONS_WARPS = NCONS * 4;  // arrivals that release a ring stage
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- mbarriers

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

// ---------------------------------------------------------------- TMA

// One 64-row box of a [B, S, heads, D] tensor map into shared memory.
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap* map, uint64_t* bar, int head, int row,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(head), "r"(row), "r"(b)
      : "memory");
}

// `bytes` contiguous bytes from device memory into shared memory (both
// 16-byte aligned, bytes a multiple of 16), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------- wgmma

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
// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

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

#define SM90_WG_ACC32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, " \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_WG_ACC_OPS(d)                                                                          \
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
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_WG_ACC32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_WG_ACC_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for one k16 step: A (64 x 16 bf16) in registers, B (16 x 64)
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_WG_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_WG_ACC_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- registers

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

// Writes a consumer's 64 rows of acc as bf16 into a [.., S, heads, D] tensor
// (row stride `rs` elements), rows at or past S skipped. s0 and s1 multiply
// the thread's two rows (row_a and row_a + 8).
__device__ __forceinline__ void store_rows(const float (&acc)[32], bf16* base, size_t rs, int row_a, int S,
                                          int lane, float s0 = 1.f, float s1 = 1.f) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    const float s = half ? s1 : s0;
    if (row < S) {
      bf16* dst = base + (size_t)row * rs;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half] * s, acc[4 * j + 2 * half + 1] * s);
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

// ---------------------------------------------------------------- the ring

// The producer's own-tile step: segment ranges of each consumer's 64 rows
// (starting at r0), then TMA of one or two maps' tiles (mb null: one) for
// both consumers, all on the `own` barrier (32 arrivals + the bytes).
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
    mbar_arrive_tx(bar, (mb ? 2 : 1) * NCONS * TILE_BYTES);
    for (int w = 0; w < NCONS; ++w) {
      tma_load(a[w], ma, bar, head, r0 + w * BT, bidx);
      if (mb) tma_load(b[w], mb, bar, head, r0 + w * BT, bidx);
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

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link against libcuda).
inline EncodeTiled encoder() {
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
inline bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads) {
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

// The flash kernels' shared argument check (D 64, H a multiple of KV).
inline bool bad_args(int B, int S, int H, int KV, int head_dim) {
  return head_dim != D || B <= 0 || S <= 0 || KV <= 0 || H % KV != 0;
}

}  // namespace sm90
