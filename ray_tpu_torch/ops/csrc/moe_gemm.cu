// Routed experts of a top-k MoE layer for Hopper (sm_90a): kernel K6 of the
// port. bf16 in, bf16 out, fp32 accumulators and combine.
//
// Replaces no TPU kernel: the JAX package runs its MoE as a dense dispatch
// (every expert on every token, `moe_ffn` in models/transformer.py), which
// at 64 experts and 8 per token does 8x the expert work and holds an
// [E, tokens, width] intermediate. It was added to serve a routed-expert
// model (Mellum2-12B-A2.5B) through the engine, decode graphs included: its
// schedule (which rows go to which expert) stays on the device, with no
// host read and no shape that depends on the routing.
//
// What bounds it on an H100: bytes at decode, operations at prefill. A
// decode step of 64 sequences routes 512 token-expert rows, ~8 to each of
// the 64 experts: every touched expert's gate, up and down matrices (12.4
// MB at hidden 2304, width 896) are streamed once for ~8 rows, 16 FLOPs a
// weight element at most, far under the card's ~295 FLOP/byte ridge. A
// prefill of a 4096-token prompt routes 32768 rows, ~512 an expert: 2 x 3 x
// 2304 x 896 FLOPs a row, far above it.
//
// What this design does about it:
// - `moe_align_kernel` (one block): counts the rows of each expert, its
//   offsets (exclusive prefix sum) and the flat (token, k) index of every
//   row in expert order, with per-warp histograms so the atomics of one
//   expert do not all meet on one address. The order of an expert's rows
//   among themselves follows the atomics; every row's result depends on its
//   own inputs only, so the outputs are the same bits launch after launch.
// - `moe_gemm_kernel` has a static grid, one block per (N tile, expert):
//   the block reads its expert's row range from the offsets and loops over
//   its 64-row M tiles; an expert with no rows exits before it reads a
//   weight, so a launch reads the weights of the touched experts only,
//   each N tile of them once per M tile. GATED (gate and up, N = width):
//   both products share the A tile (the token's row, gathered by index),
//   and the epilogue writes silu(gate) * up in bf16 from the fp32
//   accumulators. Down (N = hidden): A is that intermediate, in expert
//   order, and the epilogue writes each row back at its flat (token, k)
//   place.
// - Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate) on tiles that
//   cp.async brings through a 3-stage ring (A rows gathered 16 bytes a
//   thread, rows past the expert's end zero-filled; ldmatrix, .trans for
//   the [K, N] weights). wgmma would want 64-row M tiles filled from TMA,
//   but an expert's rows start anywhere in the gathered order and a decode
//   tile holds ~8 of them; the bytes-bound decode does not need it. The
//   prefill's operations run below wgmma's rate: the next step (PERF.md).
// - `moe_combine_kernel` sums each token's k rows in fp32, each times its
//   routing weight, and rounds once to bf16.
//
// Layout at the interface: x [T, Dm] bf16; ids [T * k] int32 (the experts of
// token t at t * k ..); w_gate / w_up [E, Dm, F], w_down [E, F, Dm] bf16;
// offsets [E + 1], sorted [T * k], counts [E] int32; h [T * k, F] bf16 in
// expert order; y2 [T * k, Dm] bf16 in (token, k) order; weights [T, k]
// fp32; y [T, Dm] bf16. Dm, F multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64, BN = 64, BK = 64, NSTAGE = 3, NTHREADS = 128;
constexpr int LDS = BK + 8;  // smem row stride of A tiles (bf16): 144 bytes, conflict-free ldmatrix
constexpr int LDB = BN + 8;  // of B tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------ routing

// One block of 1024 threads (32 warps). hist: [32][E] per-warp counts.
__global__ void __launch_bounds__(1024)
moe_align_kernel(const int* __restrict__ ids, int n, int E, int* __restrict__ offsets, int* __restrict__ sorted,
                 int* __restrict__ counts) {
  extern __shared__ int hist[];  // [32 * E], then base [E + 1]
  const int tid = threadIdx.x, warp = tid / 32, nw = blockDim.x / 32;
  int* base = hist + nw * E;
  for (int i = tid; i < nw * E; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) atomicAdd(&hist[warp * E + ids[i]], 1);
  __syncthreads();
  if (tid == 0) {
    int off = 0;
    for (int e = 0; e < E; ++e) {
      base[e] = off;
      for (int w = 0; w < nw; ++w) off += hist[w * E + e];
    }
    base[E] = off;
  }
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    offsets[e] = base[e];
    counts[e] = base[e + 1] - base[e];
    int cur = base[e];  // warp w's cursor: after the rows of warps before it
    for (int w = 0; w < nw; ++w) {
      const int c = hist[w * E + e];
      hist[w * E + e] = cur;
      cur += c;
    }
  }
  if (tid == 0) offsets[E] = base[E];
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) sorted[atomicAdd(&hist[warp * E + ids[i]], 1)] = i;
}

// -------------------------------------------------------------- grouped GEMM

template <bool GATED>
struct Smem {
  static constexpr int NB = GATED ? 2 : 1;
  bf16 a[NSTAGE][BM * LDS];
  bf16 b[NSTAGE][NB][BK * LDB];
};

// GATED: A row r of expert order is x[sorted[r] / topk], B0 = w_gate, B1 =
// w_up ([E, K, N]); out = h [rows, N] at r. Down: A row r is a[r], B0 =
// w_down; out = y2 [rows, N] at sorted[r].
template <bool GATED>
__global__ void __launch_bounds__(NTHREADS)
moe_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b0, const bf16* __restrict__ b1,
                const int* __restrict__ offsets, const int* __restrict__ sorted, bf16* __restrict__ out, int K, int N,
                int topk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<GATED>& sm = *reinterpret_cast<Smem<GATED>*>(smem_raw);
  constexpr int NB = Smem<GATED>::NB;
  const int e = blockIdx.y, n0 = blockIdx.x * BN;
  const int m_begin = offsets[e], m_end = offsets[e + 1];
  if (m_begin == m_end) return;  // an expert no row chose: none of its weights is read
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // the warp's 32 x 32 of the 64 x 64 tile
  const bf16* bw[2] = {b0 + (size_t)e * K * N, GATED ? b1 + (size_t)e * K * N : nullptr};
  const int KT = K / BK;
  // This thread's copies: A rows ra + 16 i, 16-byte chunk ca; B rows rb + 16 i, chunk cb.
  const int ra = tid / 8, ca = (tid % 8) * 8;

  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    const bf16* arow[4];
    int abytes[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ra + 16 * i;
      const bool ok = r < m_end;
      const int src = ok ? (GATED ? sorted[r] / topk : r) : 0;
      arow[i] = a + (size_t)src * K + ca;
      abytes[i] = ok ? 16 : 0;
    }
    auto load = [&](int kt, int s) {
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < 4; ++i) cp_async16(&sm.a[s][(ra + 16 * i) * LDS + ca], arow[i] + k0, abytes[i]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = ra + 16 * i;
          cp_async16(&sm.b[s][nb][kr * LDB + ca], bw[nb] + (size_t)(k0 + kr) * N + n0 + ca, 16);
        }
    };

    float acc[NB][2][4][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[nb][i][j][c] = 0.f;

#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < KT) load(s, s);
      cp_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_wait<NSTAGE - 2>();
      __syncthreads();  // tile kt is in; every warp is done with tile kt - 1's stage
      if (kt + NSTAGE - 1 < KT) load(kt + NSTAGE - 1, (kt + NSTAGE - 1) % NSTAGE);
      cp_commit();
      const int s = kt % NSTAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(af[i], &sm.a[s][(wm + 16 * i + (lane & 15)) * LDS + kk + (lane >> 4) * 8]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {  // two n8 tiles per ldmatrix
            uint32_t bf[4];
            ldmatrix_x4_t(bf, &sm.b[s][nb][(kk + (lane & 15)) * LDB + wn + 16 * jp + (lane >> 4) * 8]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[nb][i][2 * jp], af[i], bf[0], bf[1]);
              mma_bf16(acc[nb][i][2 * jp + 1], af[i], bf[2], bf[3]);
            }
          }
      }
    }
    cp_wait<0>();
    __syncthreads();  // the ring is free for the next M tile

    // Epilogue: accumulator c of (i, j) holds row wm + 16 i + lane / 4 (+ 8
    // for c >= 2), columns wn + 8 j + 2 (lane % 4) + (c & 1).
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + 16 * i + lane / 4 + 8 * h;
        if (r >= m_end) continue;
        bf16* orow = out + (size_t)(GATED ? r : sorted[r]) * N + n0 + wn + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v0 = acc[0][i][j][2 * h], v1 = acc[0][i][j][2 * h + 1];
          if constexpr (GATED) {
            const float u0 = acc[NB - 1][i][j][2 * h], u1 = acc[NB - 1][i][j][2 * h + 1];
            v0 = v0 / (1.f + __expf(-v0)) * u0;
            v1 = v1 / (1.f + __expf(-v1)) * u1;
          }
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(v0, v1);
        }
      }
  }
}

// y[t] = sum_k weights[t, k] * y2[t * topk + k], fp32, one block a token.
__global__ void moe_combine_kernel(const bf16* __restrict__ y2, const float* __restrict__ weights,
                                   bf16* __restrict__ y, int D, int topk) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x * 2; c < D; c += blockDim.x * 2) {
    float s0 = 0.f, s1 = 0.f;
    for (int k = 0; k < topk; ++k) {
      const float w = weights[(size_t)t * topk + k];
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y2 + ((size_t)t * topk + k) * D + c));
      s0 += w * v.x;
      s1 += w * v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(y + (size_t)t * D + c) = __floats2bfloat162_rn(s0, s1);
  }
}

template <bool GATED>
cudaError_t launch_gemm(const void* a, const void* b0, const void* b1, const void* offsets, const void* sorted,
                        void* out, int E, int K, int N, int topk, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<GATED>));
  static int raised[64];  // the attribute, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!raised[dev & 63]) {
    e = cudaFuncSetAttribute(moe_gemm_kernel<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised[dev & 63] = 1;
  }
  moe_gemm_kernel<GATED><<<dim3(N / BN, E), NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b0), static_cast<const bf16*>(b1),
      static_cast<const int*>(offsets), static_cast<const int*>(sorted), static_cast<bf16*>(out), K, N, topk);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* moe_gemm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The routed experts of T tokens, k each: align, gate-up, down, combine on
// `stream`. h [T * k, F] and y2 [T * k, Dm] are the caller's scratch.
// Returns cudaGetLastError() after the last launch (0 = launched).
extern "C" int moe_ffn_bf16(const void* x, const void* ids, const void* weights, const void* w_gate,
                            const void* w_up, const void* w_down, void* offsets, void* sorted, void* counts, void* h,
                            void* y2, void* y, int T, int Dm, int F, int E, int topk, void* stream) {
  if (T <= 0 || E <= 0 || E > 256 || topk <= 0 || Dm % BK || Dm % BN || F % BK || F % BN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = T * topk;
  const size_t align_smem = (size_t)(32 * E + E + 1) * sizeof(int);
  moe_align_kernel<<<1, 1024, align_smem, st>>>(static_cast<const int*>(ids), n, E, static_cast<int*>(offsets),
                                                static_cast<int*>(sorted), static_cast<int*>(counts));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<true>(x, w_gate, w_up, offsets, sorted, h, E, Dm, F, topk, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<false>(h, w_down, nullptr, offsets, sorted, y2, E, F, Dm, topk, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  moe_combine_kernel<<<T, 256, 0, st>>>(static_cast<const bf16*>(y2), static_cast<const float*>(weights),
                                        static_cast<bf16*>(y), Dm, topk);
  return static_cast<int>(cudaGetLastError());
}
