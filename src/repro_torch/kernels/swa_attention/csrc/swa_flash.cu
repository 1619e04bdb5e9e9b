// Causal, optionally sliding-window, flash attention forward for Hopper.
//
// Replaces the Pallas TPU kernel `swa_flash`
// (src/repro/kernels/swa_attention/swa.py:89, `pl.pallas_call` at :104).
// It computes the same function: scores in f32, scaled by 1/sqrt(D); key j
// is seen by query i when j <= i and, for window > 0, j > i - window;
// masked scores are -1e30 (not -inf) and the softmax denominator is
// clamped at 1e-30; m, l and the output accumulator stay in f32.  Beside o
// it writes each query row's log-sum-exp of its scaled scores, m + log l in
// natural log, an f32 (B, H, S) from which the backward (`swa_flash_bwd.cu`)
// recomputes P; o does not depend on it.  Any head
// dim D <= 128 that is a multiple of 8 (the Pallas kernel takes any D; the
// reference serves 64, 80, 120 and 128).
//
// Design.  The TPU kernel walks kv blocks on a sequential grid axis and
// carries m/l/acc in VMEM scratch between grid steps.  Here blocks run in
// parallel in no order, so one thread block owns one (batch*head, query
// tile) pair and loops over the kv tiles itself: from the first tile that
// holds a key inside the window of the tile's first query, up to the tile
// on the diagonal.  Tiles outside that range are never loaded.  The bounds
// come from positions, not from the 128-block arithmetic of `_steps` and
// `_kv_index`.  Rows past the sequence load as zeros and are masked, so the
// wrapper pads nothing.  Heavy (late, long-causal) query tiles are
// launched first.
//
// bf16 (the serving and training path): `wgmma` fed by a TMA ring.  A
// block is two consumer warpgroups of 64 query rows each (128 rows) and
// one producer warpgroup, 384 threads; `setmaxnreg` moves registers from
// the producer (24) to the consumers (240), the block's own pool.  One
// producer thread loads the Q tile once, then keeps STAGES = 3 (K, V)
// tiles of 64 keys in flight with `cp.async.bulk.tensor` on `mbarrier`s;
// each consumer warp releases a stage when its products on it are done.
// TMA, not `cp.async`: it reads (B, S, H, D) in place through a 4-d tensor
// map (D, S, H, B) whose strides are the tensor's own, and its zero fill
// covers the ragged last tile and the pad of D (each tile is loaded as
// 64-column boxes in 128-byte swizzled atoms, so D = 80 or 120 fills the
// rest of the last box with zeros).  The wrapper copies a tensor whose
// strides or address TMA cannot take.  Per kv tile each consumer
// warpgroup runs S = Q K^T as D16 / 16 `wgmma` m64n64k16 from shared
// memory (Q and K are K-major in D; the depth D16 is D rounded up to 16,
// the zero columns adding nothing), the online softmax on the accumulator
// registers (a row's four owners are one quad: two shuffles for its max;
// l is kept per thread and summed once at the end), and O += P V as
// `wgmma` m64nD16k16 with P from registers (the accumulator layout is the
// A-fragment layout) and V from shared memory through the transposed-B
// form (V is MN-major).  P is f32 in the Pallas kernel, which multiplies
// it by V in f32; to keep that precision P is split as hi + lo, two bf16
// terms, and P V is the sum of both products: about 16 bits of P's
// mantissa.  The exponentials are exp2 of scores prescaled by log2(e).
// Q K^T of the next tile is issued before this tile's softmax, so the
// tensor cores work while the softmax runs; that tile's copy must then
// have started an iteration earlier, hence three stages (with two, the
// copy of the tile just released is waited for at once).  Masks are
// applied only to tiles where a (query, key) pair may be hidden.  A
// warpgroup skips the products of a tile that none of its rows sees
// (above the diagonal, or below the window) but still releases it.
//
// Registers (`-Xptxas -v`, nvcc 12.9): 168 at launch for every D, 240 in
// the consumers after `setmaxnreg`, no spills; shared memory 1 KB of
// alignment + Q 16 KB and 3 x (K + V) 16 KB per 64-column box: 129 KB at
// D 128, 65 KB at D <= 64.  One block per SM.
//
// f32: plain FMAs from shared memory, 256 threads as a 16 x 16 grid; thread
// (ty, tx) owns score rows ty + 16i and columns tx + 16j of the 64 x 64
// tile, and output columns tx + 16j (< D) of the same rows.
//
// Bound on this card (H100 SXM data sheet).  At the serving path's shape
// (B 4, S 512, H 16, D 128, bf16, causal) the function must move q, k, v
// and o once: 33.5 MB, 10.0 us at 3.35 TB/s; its causal products are
// 4.3 GFLOP, 4.4 us at 989 TFLOP/s.  So memory bounds it.  At the training
// shape (B 4, S 4096) the products bound it: 275 GFLOP, 0.278 ms; hi + lo
// makes P V count twice, a floor of 0.417 ms for this design.
// Measured by chip_smoke.py (phase 2) on an NVIDIA H100 80GB HBM3 at
// 700 W: 0.0286 ms of device time at the serving shape (0.056 ms back to
// back, where the wrapper's host work outlasts the kernel; 0.059 ms for
// the `mma.sync` kernel this replaces) and 0.967 ms at the training shape
// (2.44 ms before), 2.1x PyTorch's SDPA there (PERF.md).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
static_assert(BQ == BKV, "the f32 kernel loads 64-row tiles of q, k, v");
constexpr int F32_THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {  // element strides of the b, s and h axes; d is contiguous
  long long b, s, h;
};

__device__ __forceinline__ bool visible(int kj, int qi, int seq, int window) {
  return kj <= qi && kj < seq && (window <= 0 || kj > qi - window);
}

// ---------------------------------------------------------------------------
// f32: plain FMAs
// ---------------------------------------------------------------------------

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D16>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (BQ * (D16 + 1) + D16 * (BKV + 1) + BKV * D16 + BQ * (BKV + 1));
}

// D16: the head dim rounded up to 16; columns head_dim .. D16-1 are zeros.
template <int D16>
__global__ void __launch_bounds__(F32_THREADS)
    swa_flash_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int seq, int heads,
                         int head_dim, Strides sq,
                         Strides sk, Strides sv, Strides so, int window,
                         float scale) {
  static_assert(D16 % 16 == 0, "D16 is a multiple of 16");
  constexpr int QS = D16 + 1;  // row stride of Qs
  constexpr int KS = BKV + 1;  // row stride of Kt and Ps
  constexpr int DJ = D16 / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][D16+1]   q * scale
  float* Kt = Qs + BQ * QS;     // [D16][BKV+1]  k transposed
  float* Vs = Kt + D16 * KS;    // [BKV][D16]
  float* Ps = Vs + BKV * D16;   // [BQ][BKV+1]   probabilities

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int e = tid; e < BQ * D16; e += F32_THREADS) {
    const int r = e / D16, d = e % D16, qi = q0 + r;
    Qs[r * QS + d] =
        qi < seq && d < head_dim ? qb[qi * sq.s + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, seq) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = k_first / BKV; t <= q_last / BKV; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // Qs is written; the last tile's Kt/Vs/Ps are consumed
    for (int e = tid; e < BKV * D16; e += F32_THREADS) {
      const int c = e / D16, d = e % D16, kj = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kj < seq && d < head_dim) {
        kx = kb[kj * sk.s + d];
        vx = vb[kj * sv.s + d];
      }
      Kt[d * KS + c] = kx;
      Vs[c * D16 + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D16; ++kk) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Kt[kk * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(k0 + tx + 16 * j, qi, seq, window)) s[i][j] = NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        Ps[r * KS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * KS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D16 + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= seq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (tx + 16 * j < head_dim)
        ob[qi * so.s + tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0)
      lse[static_cast<long long>(bh) * seq + qi] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int BF16_BQ = 128;   // query rows of a block: 2 warpgroups x 64
constexpr int BF16_BKV = 64;   // keys of a tile
constexpr int STAGES = 3;      // (K, V) tiles in flight
constexpr int CONSUMER_WARPS = 8;
// + a producer warpgroup: its `setmaxnreg.dec` frees the registers that the
// consumers' `setmaxnreg.inc` takes (both come from the block's own pool)
constexpr int BF16_THREADS = 32 * (CONSUMER_WARPS + 4);
// bytes of one 64-column box (128-byte rows) of the Q tile, and of K or V
constexpr uint32_t Q_BOX = BF16_BQ * 128;
constexpr uint32_t KV_BOX = BF16_BKV * 128;

template <int D16>
__host__ __device__ constexpr int boxes() {  // 64-column boxes of D16 columns
  return (D16 + 63) / 64;
}

template <int D16>
constexpr size_t bf16_smem_bytes() {  // 1024 of slack to align the atoms
  return 1024 + boxes<D16>() * (Q_BOX + 2 * STAGES * KV_BOX) +
         8 * (2 * STAGES + 1);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D16>
__global__ void __launch_bounds__(BF16_THREADS, 1)
    swa_flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int seq, int heads, int head_dim, Strides so,
                          int window, float scale_log2) {
  constexpr int NB = boxes<D16>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sq = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + NB * Q_BOX;             // [stage][box]
  const uint32_t sv = sk + STAGES * NB * KV_BOX;   // [stage][box]
  const uint32_t bars = sv + STAGES * NB * KV_BOX;
  const uint32_t q_bar = bars + 16 * STAGES;
  auto full = [bars](int s) { return bars + 8 * s; };
  auto empty = [bars](int s) { return bars + 8 * (STAGES + s); };

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BF16_BQ;
  const int q_last = min(q0 + BF16_BQ, seq) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / BF16_BKV, t_end = q_last / BF16_BKV + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), CONSUMER_WARPS);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer: one thread issues all copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      hopper::mbar_expect_tx(q_bar, NB * Q_BOX);
      for (int c = 0; c < NB; ++c)
        hopper::tma_load_4d(sq + c * Q_BOX, &tq, q_bar, 64 * c, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        hopper::mbar_wait(empty(stage), phase ^ 1);
        hopper::mbar_expect_tx(full(stage), 2 * NB * KV_BOX);
        for (int c = 0; c < NB; ++c) {
          const uint32_t off = (stage * NB + c) * KV_BOX;
          hopper::tma_load_4d(sk + off, &tk, full(stage), 64 * c,
                              t * BF16_BKV, h, b);
          hopper::tma_load_4d(sv + off, &tv, full(stage), 64 * c,
                              t * BF16_BKV, h, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // The consumers.  Warpgroup wg owns query rows wq0 .. wq0 + 63; in the
    // wgmma accumulator layout this thread owns rows r0 and r0 + 8 of them,
    // and element i of an accumulator is row (i & 2 ? r1 : r0), column
    // 8 (i / 4) + 2 tc + (i & 1).
    const int wg = warp / 4, g = lane / 4, tc = lane % 4;
    const int wq0 = q0 + 64 * wg;
    const int r0 = wq0 + 16 * (warp % 4) + g, r1 = r0 + 8;
    const int w_last = min(wq0 + 63, seq - 1);
    // the tiles [ts, te) hold a key that some row of this warpgroup sees; the
    // others are waited for and released untouched
    int ts = t_begin, te = t_begin;
    if (wq0 <= w_last) {
      te = min(t_end, w_last / BF16_BKV + 1);
      ts = window > 0 ? max(t_begin, (wq0 - window + 1) / BF16_BKV) : t_begin;
    }

    float acc[D16 / 2];
#pragma unroll
    for (int i = 0; i < D16 / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float s[BF16_BKV / 2], s_next[BF16_BKV / 2];
#pragma unroll
    for (int i = 0; i < BF16_BKV / 2; ++i) s[i] = s_next[i] = 0.f;

    int stage = 0;
    uint32_t phase = 0;
    auto advance = [](int& st, uint32_t& ph) {
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(st));
    };
    // S = Q K^T of the tile in `st`, issued and committed, not waited for
    auto issue_qk = [&](float (&d)[BF16_BKV / 2], int st) {
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D16 / 16; ++kk) {
        const uint32_t a = sq + (kk / 4) * Q_BOX + wg * (Q_BOX / 2) +
                           (kk % 4) * 32;
        const uint32_t bk = sk + (st * NB + kk / 4) * KV_BOX + (kk % 4) * 32;
        hopper::wgmma_ss64<0, 0>(d, hopper::desc_sw128(a, 0, 1024),
                 hopper::desc_sw128(bk, 0, 1024), kk > 0);
      }
      hopper::wgmma_commit();
    };

    hopper::mbar_wait(q_bar, 0);
    for (int t = t_begin; t < ts; ++t) {
      hopper::mbar_wait(full(stage), phase);
      release(stage);
      advance(stage, phase);
    }
    if (ts < te) {
      hopper::mbar_wait(full(stage), phase);
      issue_qk(s, stage);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
    }
    for (int t = ts; t < te; ++t) {
      // Q K^T of the next tile runs while this tile's softmax does
      int next = stage;
      uint32_t next_phase = phase;
      advance(next, next_phase);
      if (t + 1 < te) {
        hopper::mbar_wait(full(next), next_phase);
        issue_qk(s_next, next);
      }

      // scale (in log2 units), mask where a pair may be hidden, and the
      // online softmax
      const int k0 = t * BF16_BKV;
      const bool mask = k0 + BF16_BKV - 1 > wq0 || k0 + BF16_BKV > seq ||
                        (window > 0 && k0 <= wq0 + 63 - window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BF16_BKV / 2; ++i) {
        const int kj = k0 + 8 * (i / 4) + 2 * tc + (i & 1);
        s[i] *= scale_log2;
        if (mask && !visible(kj, i & 2 ? r1 : r0, seq, window)) s[i] = NEG_INF;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < BF16_BKV / 2; ++i) {
        s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
      // P as the A fragments of 4 steps of 16 keys, hi + lo
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(h2);
          hi[kk][j] = as_u32(h2);
          lo[kk][j] = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
        }
#pragma unroll
      for (int i = 0; i < D16 / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P V
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = hopper::desc_sw128(
            sv + stage * NB * KV_BOX + kk * 2048, KV_BOX, 1024);
        hopper::wgmma_rs<D16>(acc, hi[kk], dv, 1);
        hopper::wgmma_rs<D16>(acc, lo[kk], dv, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(s_next);
      release(stage);
#pragma unroll
      for (int i = 0; i < BF16_BKV / 2; ++i) s[i] = s_next[i];
      stage = next;
      phase = next_phase;
    }
    for (int t = te; t < t_end; ++t) {
      hopper::mbar_wait(full(stage), phase);
      release(stage);
      advance(stage, phase);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
    bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int j = 0; j < D16 / 8; ++j) {
      const int col = 8 * j + 2 * tc;
      if (col >= head_dim) continue;
      if (r0 < seq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * so.s + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r1 < seq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * so.s + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    // the row's log-sum-exp of the scaled scores, m + log2 l in log2 units,
    // as natural log; its address from blockIdx.x and not bh, which would
    // then stay live through the loop (8% of the kernel's time at D 128)
    if (tc == 0) {
      float* lb = lse + static_cast<long long>(blockIdx.x) * seq;
      if (r0 < seq) lb[r0] = (m[0] - __log2f(inv0)) * LN2;
      if (r1 < seq) lb[r1] = (m[1] - __log2f(inv1)) * LN2;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D16>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int seq, int heads, int head_dim,
               const long long* st, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D16>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_flash_f32_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (seq + BQ - 1) / BQ);
  swa_flash_f32_kernel<D16><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), seq, heads, head_dim,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D16>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int batch, int seq, int heads, int head_dim,
                const long long* st, int window, float scale,
                cudaStream_t stream) {
  // tensor maps (D, S, H, B) of q, k and v: boxes of 64 columns by the
  // Q tile's or the kv tile's rows
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                                static_cast<cuuint64_t>(seq),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(2 * st[3 * i + 1]),
        static_cast<cuuint64_t>(2 * st[3 * i + 2]),
        static_cast<cuuint64_t>(2 * st[3 * i])};
    const cuuint32_t box[4] = {
        64, static_cast<cuuint32_t>(i == 0 ? BF16_BQ : BF16_BKV), 1, 1};
    if (!hopper::encode_bf16(&maps[i], ptrs[i], 4, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = bf16_smem_bytes<D16>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_flash_bf16_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (seq + BF16_BQ - 1) / BF16_BQ);
  swa_flash_bf16_kernel<D16><<<grid, BF16_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o),
      static_cast<float*>(lse), seq, heads, head_dim,
      Strides{st[9], st[10], st[11]}, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D16>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           void* lse, int batch, int seq, int heads, int head_dim,
           const long long* st, int window, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D16>(q, k, v, o, lse, batch, seq, heads, head_dim, st,
                           window, scale, stream);
  if (dtype == 1)
    return launch_bf16<D16>(q, k, v, o, lse, batch, seq, heads, head_dim,
                            st, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: (batch, seq, heads, head_dim) with a contiguous last axis;
// strides: 12 element strides, the (b, s, h) strides of q, k, v, o in turn.
// lse: a contiguous f32 (batch, heads, seq) that receives each query row's
// log-sum-exp of its scaled, masked scores (natural log).
// dtype: 0 float32, 1 bfloat16; head_dim a multiple of 8 in [8, 128].  For
// bf16 the q, k, v strides are multiples of 8 elements and the addresses of
// 16 bytes (TMA's rule).  `scale` multiplies the scores.  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int swa_flash_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, void* o,
                             void* lse, int batch, int seq, int heads,
                             const long long* strides, int window,
                             float scale, void* stream) {
  if (batch * heads == 0 || seq == 0) return 0;
  if (head_dim < 8 || head_dim > 128 || head_dim % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SWA_CASE(D16)                                                      \
  case D16:                                                                \
    return launch<D16>(dtype, q, k, v, o, lse, batch, seq, heads,         \
                       head_dim, strides, window, scale, s);
  switch ((head_dim + 15) / 16 * 16) {
    SWA_CASE(16)
    SWA_CASE(32)
    SWA_CASE(48)
    SWA_CASE(64)
    SWA_CASE(80)
    SWA_CASE(96)
    SWA_CASE(112)
    SWA_CASE(128)
  }
#undef SWA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
