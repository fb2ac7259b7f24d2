// One-token GQA decode attention against a paged KV pool, for Hopper
// (sm_90a), bf16 in, bf16 out, fp32 softmax state. Kernel K4 of the port.
//
// Replaces: ray_tpu/ops/paged_attention.py `_paged_kernel` (launched by
// `_paged_pallas`). Same function: each sequence's query heads attend to the
// first `length` tokens of its pages, found through its page-table row, with
// an online softmax across pages; pages at or past `length` are skipped and
// a sequence of length 0 writes 0 (as the TPU kernel does).
//
// What bounds it on an H100: memory, and before that latency. Each valid
// K/V element is read once and used by `group` query heads (4 FLOPs per
// element per head), far below the card's ~295 FLOP/byte ridge: the bound is
// the K/V bytes over 3.35 TB/s, 5.3 us at the engine's decode shape (32
// sequences of ~545 tokens, 4 kv heads, D 64). A walk over a sequence's
// pages in one block per (sequence, kv head) keeps one page in flight per
// block and 128 blocks on 132 SMs: it waits on one copy after another.
//
// What this design does about it (split over pages, one launch):
// - One block per (sequence, kv head, run of pages). The wrapper picks the
//   pages per run (`pages_per_block` in paged_attention.py, a function of the
//   launch's shape only); at the engine's decode shape a run is one page, so
//   the ~5 valid pages of each (sequence, kv head) load at once in ~640
//   blocks, several resident per SM. Blocks whose run starts at or past the
//   sequence's length exit at once.
// - A run's pages arrive by 1-D bulk copies (cp.async.bulk onto an
//   mbarrier; one kv head's page is one contiguous ps x D x 2-byte run), in
//   tiles of up to 8192 elements, the next tile in flight while this one
//   computes when a run has more than one.
// - Scores, max, exp and P V run in fp32 for all `group` q heads of the kv
//   head, so each page is read from device memory once. Lanes split a token
//   row into its 16-byte chunks (lanes per token: D / 8 rounded up to a
//   power of two), so a warp reads whole rows of contiguous shared memory:
//   no bank conflicts and no padding. Each lane keeps its chunk of q (scale
//   and log2(e) folded in) and of the P V accumulator in registers.
// - Each block writes a partial (m, l, acc[G, D]) in fp32 to a scratch
//   buffer. The block that draws the last ticket of its (sequence, kv head)
//   from an int32 counter (one acq_rel atomic add per block after its
//   writes; the target is the sequence's number of valid runs) merges the partials in page order, so
//   the result is the same bits launch after launch, writes o and resets
//   the counter to 0. A sequence with one valid run writes o directly.
//
// Layout at the interface: q/o [B, H, D]; k/v pools [KV, P_total, ps, D]
// (the engine's linear pool [KV, P_total * ps, D] viewed per page);
// lengths [B] int32 (valid tokens including the current one); page table
// [B, ppseq] int32 whose dead entries point at page 0; partials fp32
// [B, KV, ceil(ppseq / ppb), G, D + 2]; counters int32 [B * KV], zero at
// rest. D % 8 == 0, D <= 256, any page size.

#include <math.h>

#include "sm90.cuh"

namespace {

using sm90::bf16;

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE_ELEMS = 8192;  // K (and V) elements per loaded tile: 16 KB each
constexpr int CH = 8;             // values per lane: one 16-byte chunk of a row

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Byte offsets into the block's dynamic shared memory. `tiles`: nbuf K/V
// tile pairs, reused at the end for the cross-warp sum of the accumulators.
struct Layout {
  size_t tiles, sc, stats, bars, flag, total;
  __host__ __device__ Layout(int G, int D, int tt, int nbuf) {
    const size_t t_bytes = (size_t)nbuf * 2 * tt * D * 2, red = (size_t)NWARPS * G * D * 4;
    tiles = 0;
    sc = align16(t_bytes > red ? t_bytes : red);  // scores, then p: [G, tt] fp32
    stats = sc + align16((size_t)G * tt * 4);     // m, l, alpha: [3, G] fp32
    bars = stats + align16((size_t)3 * G * 4);    // one mbarrier per buffer
    flag = bars + 16;
    total = flag + 16;
  }
};

// CH consecutive bf16 values (16 bytes) as fp32.
__device__ __forceinline__ void load_chunk(const bf16* p, float (&f)[CH]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

template <int G>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp, const bf16* __restrict__ vp,
                    const int* __restrict__ lens, const int* __restrict__ table, bf16* __restrict__ o,
                    float* __restrict__ part, int* __restrict__ cnt, int H, int D, int P_total, int ps,
                    int ppseq, int ppb, int tt, int nbuf, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // Grid (kv head, sequence, run): every sequence's first runs are
  // scheduled before any later run, so the blocks that exit at once come last.
  const int kvh = blockIdx.x, KV = gridDim.x, b = blockIdx.y, r = blockIdx.z, n_runs = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // The run's first page id is read beside the length, not after it.
  const int len = lens[b];
  const int first_page = tid == 0 ? table[(size_t)b * ppseq + (size_t)r * ppb] : 0;
  bf16* ob = o + ((size_t)b * H + (size_t)kvh * G) * D;
  if (len <= 0) {
    if (r == 0) {
      for (int i = tid; i < G * D; i += NTHREADS) ob[i] = __float2bfloat16(0.f);
    }
    return;
  }
  const int n_pages = min((len + ps - 1) / ps, ppseq);
  const int n_valid = (n_pages + ppb - 1) / ppb;  // runs holding a valid token
  if (r >= n_valid) return;

  // This run: pages j0 .. j1 - 1, each in tiles of up to tt tokens; only the
  // sequence's last page may be partial.
  const int j0 = r * ppb, j1 = min(j0 + ppb, n_pages);
  const int tpp = (ps + tt - 1) / tt;
  const int n_items = (j1 - j0 - 1) * tpp + (min(ps, len - (j1 - 1) * ps) + tt - 1) / tt;
  const int* trow = table + (size_t)b * ppseq;

  const Layout lay(G, D, tt, nbuf);
  const size_t tile = (size_t)tt * D;
  bf16* bufs = reinterpret_cast<bf16*>(smem_raw + lay.tiles);  // buffer i: K at 2 i tile, V after it
  float* sc = reinterpret_cast<float*>(smem_raw + lay.sc);
  float* m_s = reinterpret_cast<float*>(smem_raw + lay.stats);
  float *l_s = m_s + G, *alpha_s = l_s + G;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);
  int* last_s = reinterpret_cast<int*>(smem_raw + lay.flag);

  // Item it of the run: page j0 + it / tpp, tokens from (it % tpp) * tt.
  auto tokens = [&](int it, int& j, int& tok0) {
    j = j0 + it / tpp;
    tok0 = (it % tpp) * tt;
    return min(tt, min(ps, len - j * ps) - tok0);
  };
  auto issue = [&](int it) {
    int j, tok0;
    const int n_tok = tokens(it, j, tok0);
    const size_t src = (((size_t)kvh * P_total + (it == 0 ? first_page : trow[j])) * ps + tok0) * D;
    bf16* kd = bufs + (size_t)(it % nbuf) * 2 * tile;
    const uint32_t bytes = (uint32_t)n_tok * D * 2;
    sm90::mbar_arrive_tx(&bar[it % nbuf], 2 * bytes);
    sm90::bulk_load(kd, kp + src, bytes, &bar[it % nbuf]);
    sm90::bulk_load(kd + tile, vp + src, bytes, &bar[it % nbuf]);
  };
  // Thread 0 starts the first copies before the block's barrier: the
  // mbarriers are its own until then.
  if (tid == 0) {
    for (int i = 0; i < nbuf; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int it = 0; it < min(nbuf, n_items); ++it) issue(it);
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // Lane roles: lpt lanes per token row, one chunk of CH values each.
  const int cpr = D / CH;
  int lpt = 1;
  while (lpt < cpr) lpt <<= 1;
  const int tpw = 32 / lpt, gl = lane / lpt, cl = lane % lpt;
  const bool has_chunk = cl < cpr;

  float qr[G][CH], acc[G][CH];
  {
    const bf16* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float f[CH] = {};
      if (has_chunk) load_chunk(qb + g * D + cl * CH, f);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        qr[g][i] = f[i] * scale_log2;
        acc[g][i] = 0.f;
      }
    }
  }

  for (int it = 0; it < n_items; ++it) {
    int j, tok0;
    const int n_tok = tokens(it, j, tok0);
    const bf16* ks = bufs + (size_t)(it % nbuf) * 2 * tile;
    const bf16* vs = ks + tile;
    sm90::mbar_wait(&bar[it % nbuf], (it / nbuf) & 1);

    // Scores (base 2) of every token for the G heads; two token steps per
    // pass, so their shuffle reductions overlap.
    for (int t0 = warp * tpw; t0 < n_tok; t0 += 2 * NWARPS * tpw) {
      float dot[2][G];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = t0 + u * NWARPS * tpw + gl;
#pragma unroll
        for (int g = 0; g < G; ++g) dot[u][g] = 0.f;
        if (t < n_tok && has_chunk) {
          float kf[CH];
          load_chunk(ks + (size_t)t * D + cl * CH, kf);
#pragma unroll
          for (int i = 0; i < CH; ++i)
#pragma unroll
            for (int g = 0; g < G; ++g) dot[u][g] = fmaf(qr[g][i], kf[i], dot[u][g]);
        }
      }
      for (int off = lpt / 2; off; off >>= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g) dot[u][g] += __shfl_xor_sync(0xffffffffu, dot[u][g], off);
      if (cl == 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = t0 + u * NWARPS * tpw + gl;
          if (t < n_tok) {
#pragma unroll
            for (int g = 0; g < G; ++g) sc[g * tt + t] = dot[u][g];
          }
        }
      }
    }
    __syncthreads();

    // Per head: the tile's max, the rescale factor, p and its sum.
    for (int g = warp; g < G; g += NWARPS) {
      float mx = -INFINITY;
      for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, sc[g * tt + t]);
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g], m_new = fmaxf(m_old, mx);  // n_tok >= 1: finite
      float sum = 0.f;
      for (int t = lane; t < n_tok; t += 32) {
        const float p = sm90::ex2(sc[g * tt + t] - m_new);
        sc[g * tt + t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float a = sm90::ex2(m_old - m_new);  // m_old = -inf -> 0
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this lane's tokens and chunk.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int i = 0; i < CH; ++i) acc[g][i] *= a;
    }
    if (has_chunk) {
      for (int t = warp * tpw + gl; t < n_tok; t += NWARPS * tpw) {
        float vf[CH];
        load_chunk(vs + (size_t)t * D + cl * CH, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sc[g * tt + t];
#pragma unroll
          for (int i = 0; i < CH; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
        }
      }
    }
    __syncthreads();  // the buffer and the scores are free
    if (tid == 0 && it + nbuf < n_items) issue(it + nbuf);
  }

  // The block's sum of acc: over the lane groups of a warp, then over the
  // warps in a fixed order, into red[G, D] (the tile buffers, now free).
  for (int off = lpt; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < CH; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
  float* red = reinterpret_cast<float*>(smem_raw + lay.tiles);  // [NWARPS, G, D]
  if (gl == 0 && has_chunk) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < CH; ++i) red[((size_t)warp * G + g) * D + cl * CH + i] = acc[g][i];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NTHREADS) {
    float s = red[i];
    for (int w = 1; w < NWARPS; ++w) s += red[(size_t)w * G * D + i];
    red[i] = s;
  }
  __syncthreads();

  if (n_valid == 1) {
    for (int i = tid; i < G * D; i += NTHREADS) ob[i] = __float2bfloat16(red[i] / l_s[i / D]);
    return;
  }

  // Partial of this run, then the ticket.
  const int row = G * (D + 2);
  float* pb = part + ((size_t)b * KV + kvh) * n_runs * row;
  for (int i = tid; i < G * D; i += NTHREADS) pb[(size_t)r * row + (i / D) * (D + 2) + 2 + i % D] = red[i];
  if (tid < G) {
    pb[(size_t)r * row + tid * (D + 2)] = m_s[tid];
    pb[(size_t)r * row + tid * (D + 2) + 1] = l_s[tid];
  }
  // The block's writes, then one release-acquire ticket for the whole
  // block (the pattern of a split-K semaphore): the block that draws the
  // last one sees every run's partial.
  __syncthreads();
  if (tid == 0) *last_s = atomic_add_acq_rel(&cnt[b * KV + kvh], 1) == n_valid - 1;
  __syncthreads();
  if (!*last_s) return;

  // The last block merges the runs in page order, online: per output value
  // one pass over the runs' (m, l, acc), all loads independent of the sums.
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    const float* pr = pb + g * (D + 2);
    float mx = -INFINITY, num = 0.f, den = 0.f;
#pragma unroll 4
    for (int rr = 0; rr < n_valid; ++rr, pr += row) {
      const float m = __ldcg(pr), l = __ldcg(pr + 1), a = __ldcg(pr + 2 + d);
      const float m_new = fmaxf(mx, m);  // every valid run's m is finite
      const float c = sm90::ex2(mx - m_new), w = sm90::ex2(m - m_new);  // c = 0 on the first run
      num = num * c + w * a;
      den = den * c + w * l;
      mx = m_new;
    }
    ob[i] = __float2bfloat16(num / den);
  }
  if (tid == 0) cnt[b * KV + kvh] = 0;
}

template <int G>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* lens, const void* table, void* o,
                   void* part, void* cnt, int B, int H, int KV, int D, int P_total, int ps, int ppseq, int ppb,
                   float scale, cudaStream_t stream) {
  const int tt = min(ps, TILE_ELEMS / D);
  const int nbuf = ppb * ((ps + tt - 1) / tt) > 1 ? 2 : 1;
  const size_t smem = Layout(G, D, tt, nbuf).total;
  // The attribute is raised once per instance and device, as far as a
  // launch needs (48 KB needs none): no extra CUDA call on the decode path.
  static size_t smem_allowed[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  size_t& allowed = smem_allowed[dev & 63];
  if (smem > 48 * 1024 && smem > allowed) {
    e = cudaFuncSetAttribute(paged_decode_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  const dim3 grid(KV, B, (ppseq + ppb - 1) / ppb);
  paged_decode_kernel<G><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      static_cast<const int*>(lens), static_cast<const int*>(table), static_cast<bf16*>(o),
      static_cast<float*>(part), static_cast<int*>(cnt), H, D, P_total, ps, ppseq, ppb, tt, nbuf,
      scale * sm90::LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). `part` holds
// B * KV * ceil(ppseq / ppb) * (H / KV) * (D + 2) floats; `cnt` B * KV
// int32 counters, zero at rest (the kernel leaves them zero).
extern "C" int paged_decode_bf16(const void* q, const void* kp, const void* vp, const void* lens,
                                 const void* table, void* o, void* part, void* cnt, int B, int H, int KV,
                                 int D, int P_total, int ps, int ppseq, int ppb, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || D % 8 != 0 || D <= 0 || D > 256 || ps <= 0 || ppseq <= 0 ||
      ppb <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / KV) {
    case 1: return static_cast<int>(launch<1>(q, kp, vp, lens, table, o, part, cnt, B, H, KV, D, P_total, ps, ppseq, ppb, scale, s));
    case 2: return static_cast<int>(launch<2>(q, kp, vp, lens, table, o, part, cnt, B, H, KV, D, P_total, ps, ppseq, ppb, scale, s));
    case 4: return static_cast<int>(launch<4>(q, kp, vp, lens, table, o, part, cnt, B, H, KV, D, P_total, ps, ppseq, ppb, scale, s));
    case 8: return static_cast<int>(launch<8>(q, kp, vp, lens, table, o, part, cnt, B, H, KV, D, P_total, ps, ppseq, ppb, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
