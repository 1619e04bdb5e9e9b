// Causal, optionally sliding-window, flash attention backward for Hopper.
//
// Replaces no TPU kernel.  The JAX package has no backward kernel: JAX
// differentiates its jnp attention through XLA.  This kernel was added
// because the port's plain backward (`ref.py::swa_attention_bwd_ref`),
// which materialises the (H, S, S) f32 scores one batch row at a time and
// runs its five products as full-precision f32 GEMMs on the whole S x S
// square, took more than half of every training step's device time
// (PERF.md).
//
// Function.  From bf16 q, k, v, o, dO (B, S, H, D) and the forward's f32
// log-sum-exp lse (B, H, S) (`swa_flash.cu`), the bf16 gradients dq, dk,
// dv of `swa_flash`: with scale = 1/sqrt(D) and the causal (windowed) mask
// of the forward, P = exp(scale Q K^T - lse), dP = dO V^T, delta =
// rowsum(dO o O), dS = P (dP - delta), dV = P^T dO, dK = scale dS^T Q,
// dQ = scale dS K.  Head dims as the forward: multiples of 8 up to 128,
// padded to D16 (D rounded up to 16) by TMA's zero fill.
//
// Design.  Three kernels on the caller's stream.
// 1. prep: one warp a (b, h, query row): delta in f32 from the bf16 o and
//    dO, the pair (lse in log2 units, delta) into an f32 (B H, S_pad, 2)
//    buffer whose rows past S (up to whole 64-query tiles) are zeros, and
//    the row of the f32 (B, S, H, D) dQ workspace zeroed.
// 2. main: one block owns one (b h, 128-key tile); its K and V tiles stay
//    in shared memory.  One producer thread keeps STAGES = 2 query tiles
//    of 64 in flight with TMA on `mbarrier`s, each stage a tile's Q, dO
//    (4-d tensor maps, as the forward reads q, k, v) and its 64 pairs (a
//    bulk copy).  The ring starts at the tile on the diagonal and ends at
//    the last query tile that sees a key of the block: the window's edge,
//    or S.  Key tiles are launched in order, so the heavy early ones (seen
//    by the most queries under a causal mask) go first.  Two consumer
//    warpgroups own 64 keys each and run, on each query tile, with
//    `wgmma` (m64, f32 accumulators):
//      S^T = K Q^T and dP^T = V dO^T from shared memory (K-major);
//      P^T = exp2(S^T scale log2(e) - lse2), the masks applied only where
//      a pair of the tile may be hidden; dS^T = P^T (dP^T - delta);
//      dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers (the
//      accumulator layout is the A-fragment layout, the rows being keys)
//      and dO and Q MN-major: dK and dV stay in f32 registers across the
//      loop;
//      dQ^T = K^T dS^T with both operands MN-major in shared memory: dS^T
//      is stored there (128-byte swizzled, double-buffered, one named
//      barrier a tile between the two warpgroups).  At D16 > 64 warpgroup
//      w computes head-dim rows 64 w .. 64 w + 63 over all 128 keys; at
//      D16 <= 64 each computes all rows over its own 64 keys.  The result
//      goes through a shared-memory tile into one TMA reduction a tile
//      (`cp.reduce.async.bulk.tensor` .add, f32 at L2) into the workspace,
//      in an order that changes from run to run: f32 atomics from the
//      registers (`red.global.add`, 32 a thread and tile) took about a
//      quarter of the kernel's time.
//    At the end dK (times scale) and dV are written as bf16.
// 3. dq: the workspace times scale, cast to bf16.
// Precision.  P and dS enter their products as hi + lo, two bf16 terms,
// as the forward's P V does: about 16 bits of the f32 P and dS that the
// plain backward (and JAX's XLA gradient) use.  Every product accumulates
// in f32.  So P^T dO, dS^T Q and dS K each take two products.
//
// Registers and shared memory (`-Xptxas -v`): 168 at launch for every D16
// (the launch bound of 384 threads), 240 in the consumers after
// `setmaxnreg`; at D16 = 128 12 bytes spill (a 16-byte stack frame), at
// smaller D16 none.  Shared memory 1 KB of alignment + K and V 16 KB each
// per 64-column box, 2 x (Q + dO) 8 KB per box, 4 x 16 KB of dS^T (two
// buffers of hi and lo), 2 x 16 KB of dQ tiles and 1 KB of pairs: 226 KB
// at D 128, 162 KB at D <= 64.  One block per SM, 384 threads:
// `setmaxnreg` moves registers from the producer warpgroup (24) to the
// consumers (240).
//
// Bound on this card (H100 SXM data sheet, 989 TFLOP/s bf16).  The least
// work of the backward (`bench/costs.py::attention_bwd`: the four products
// dV, dP, dQ, dK over the causal pairs) at olmo-1b's training call (B 4,
// S 4096, H 16, D 128) is 550 GFLOP, 0.556 ms; at granite-moe-3b-a800m's
// (B 4, S 4096, H 24, D 64) 412 GFLOP, 0.417 ms.  Its bytes (q, k, v, o,
// dO read, dq, dk, dv written: 0.54 GB and 0.40 GB) take 0.16 and 0.12 ms,
// so the products bound it.  This design runs eight products' worth (S^T
// again, dP^T, and two each for dV, dK, dQ): its own floor is 2x that
// least time, 1.11 and 0.83 ms.  Measured by chip_smoke.py (phase 2e) on
// an NVIDIA H100 80GB HBM3 at 700 W: 2.79 ms at olmo's call (20% of the
// least time, 40% of the floor) and 2.76 ms at granite's (15%, 30%),
// against 53.5 and 62.7 ms for the plain backward.  Two designs measured
// slower: f32 atomics for dQ (3.29 and 3.51 ms) and, on top of them, the
// two warpgroups untied by a dQ^T over each one's own keys (4.13 ms at
// olmo's call: twice the atomics).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BKV = 128;  // keys of a block: 2 consumer warpgroups x 64
constexpr int BQ = 64;    // query rows of a ring stage
constexpr int STAGES = 2;
constexpr int CONSUMER_WARPS = 8;
// + a producer warpgroup, whose `setmaxnreg.dec` frees registers for the
// consumers' `setmaxnreg.inc`
constexpr int THREADS = 32 * (CONSUMER_WARPS + 4);
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr uint32_t KV_BOX = BKV * 128;      // a 64-column box of K or V
constexpr uint32_t Q_BOX = BQ * 128;        // a 64-column box of Q or dO
constexpr uint32_t DS_BYTES = BKV * BQ * 2;  // dS^T, keys x queries, bf16
constexpr uint32_t STATS_BYTES = BQ * 8;     // (lse2, delta) of a tile
// a warpgroup's dQ tile, f32 queries x 64 head dims, as two boxes of 32
// head dims (128-byte rows) for the tensor map's reduction
constexpr uint32_t DQ_BOX = BQ * 128;
constexpr uint32_t DQ_TILE = 2 * DQ_BOX;
constexpr int PREP_WARPS = 8;
constexpr int DQ_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // element strides of the b, s and h axes; d is contiguous
  long long b, s, h;
};

template <int D16>
__host__ __device__ constexpr int boxes() {  // 64-column boxes of D16
  return (D16 + 63) / 64;
}

// byte offsets of the main kernel's shared memory from its 1024-aligned
// base: K and V [box], Q and dO [stage][box], dS^T [buffer][hi, lo], the
// dQ tiles [warpgroup], the pairs [stage], then the barriers
template <int D16>
struct Layout {
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + boxes<D16>() * KV_BOX;
  static constexpr uint32_t Q = V + boxes<D16>() * KV_BOX;
  static constexpr uint32_t DO = Q + STAGES * boxes<D16>() * Q_BOX;
  static constexpr uint32_t DS = DO + STAGES * boxes<D16>() * Q_BOX;
  static constexpr uint32_t DQ = DS + 4 * DS_BYTES;
  static constexpr uint32_t STATS = DQ + 2 * DQ_TILE;
  static constexpr uint32_t BARS = STATS + STAGES * STATS_BYTES;
  static constexpr size_t bytes = 1024 + BARS + 8 * (2 * STAGES + 1);
};

using hopper::as_u32;
using hopper::split_bf16;

__device__ __forceinline__ bool visible(int kj, int qi, int seq, int window) {
  return kj <= qi && qi < seq && (window <= 0 || kj > qi - window);
}

// ---------------------------------------------------------------------------
// 1. prep
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * PREP_WARPS)
    bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float2* __restrict__ stats,
                    float* __restrict__ dq_ws, long long rows, int seq,
                    int heads, int head_dim, int s_pad, Strides so,
                    Strides sdo) {
  const long long row =
      static_cast<long long>(blockIdx.x) * PREP_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / s_pad;
  const int i = static_cast<int>(row % s_pad);
  if (i >= seq) {
    if (lane == 0) stats[row] = make_float2(0.f, 0.f);
    return;
  }
  const int b = static_cast<int>(bh / heads), h = static_cast<int>(bh % heads);
  const int d0 = 4 * lane;  // four columns a lane: head_dim <= 128
  float acc = 0.f;
  if (d0 < head_dim) {
    const uint2 ov = *reinterpret_cast<const uint2*>(
        o + b * so.b + i * so.s + h * so.h + d0);
    const uint2 gv = *reinterpret_cast<const uint2*>(
        dout + b * sdo.b + i * sdo.s + h * sdo.h + d0);
    const float2 o01 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.x));
    const float2 o23 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.y));
    const float2 g01 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv.x));
    const float2 g23 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv.y));
    acc = o01.x * g01.x + o01.y * g01.y + o23.x * g23.x + o23.y * g23.y;
    float* ws = dq_ws +
                ((static_cast<long long>(b) * seq + i) * heads + h) * head_dim;
    *reinterpret_cast<float4*>(ws + d0) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) stats[row] = make_float2(lse[bh * seq + i] * LOG2E, acc);
}

// ---------------------------------------------------------------------------
// 2. main
// ---------------------------------------------------------------------------

template <int D16>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_main_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdq,
                    const float2* __restrict__ stats, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int seq, int heads, int head_dim,
                    int s_pad, int window, float scale, float scale_log2) {
  constexpr int NB = boxes<D16>();
  using L = Layout<D16>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t sk = base + L::K, sv = base + L::V;
  const uint32_t bars = base + L::BARS;
  const uint32_t kv_bar = bars + 16 * STAGES;
  auto full = [bars](int s) { return bars + 8 * s; };
  auto empty = [bars](int s) { return bars + 8 * (STAGES + s); };

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * BKV;
  // the query tiles that see a key of [k0, k0 + BKV)
  const int q_end = window > 0 ? min(seq, k0 + BKV - 1 + window) : seq;
  const int t_begin = k0 / BQ, t_end = (q_end + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), CONSUMER_WARPS);
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer: one thread issues all copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      hopper::mbar_expect_tx(kv_bar, 2 * NB * KV_BOX);
      for (int c = 0; c < NB; ++c) {
        hopper::tma_load_4d(sk + c * KV_BOX, &tk, kv_bar, 64 * c, k0, h, b);
        hopper::tma_load_4d(sv + c * KV_BOX, &tv, kv_bar, 64 * c, k0, h, b);
      }
      const float2* st = stats + static_cast<long long>(bh) * s_pad;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        hopper::mbar_wait(empty(stage), phase ^ 1);
        hopper::mbar_expect_tx(full(stage), 2 * NB * Q_BOX + STATS_BYTES);
        for (int c = 0; c < NB; ++c) {
          const uint32_t off = (stage * NB + c) * Q_BOX;
          hopper::tma_load_4d(base + L::Q + off, &tq, full(stage), 64 * c,
                              t * BQ, h, b);
          hopper::tma_load_4d(base + L::DO + off, &tdo, full(stage), 64 * c,
                              t * BQ, h, b);
        }
        hopper::bulk_load(base + L::STATS + stage * STATS_BYTES, st + t * BQ,
                          STATS_BYTES, full(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers.  Warpgroup wg owns keys kw .. kw + 63.  In the wgmma
  // accumulator layout this thread owns rows lr0 and lr1 = lr0 + 8 of its
  // warpgroup's 64, and element i of an m64 accumulator is row (i & 2 ?
  // lr1 : lr0), column 8 (i / 4) + 2 tc + (i & 1).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4, g = lane / 4, tc = lane % 4;
  const int lr0 = 16 * (warp % 4) + g, lr1 = lr0 + 8;
  const int kw = k0 + 64 * wg;
  const int j0 = kw + lr0, j1 = kw + lr1;
  // dQ^T's rows (head dims 64 mb ..) and the keys it sums over
  constexpr bool SPLIT_D = D16 > 64;
  const int mb = SPLIT_D ? wg : 0;
  const int key0 = SPLIT_D ? 0 : 64 * wg;
  constexpr int DQ_STEPS = (SPLIT_D ? BKV : 64) / 16;
  // one thread of each warpgroup issues its dQ reductions
  const bool elect = warp % 4 == 0 && lane == 0;
  unsigned char* const dq_tile = gbase + L::DQ + wg * DQ_TILE;

  float dk_acc[D16 / 2], dv_acc[D16 / 2], s[32], dp[32], dqt[32];
#pragma unroll
  for (int i = 0; i < D16 / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dqt[i] = 0.f;

  hopper::mbar_wait(kv_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int qt = t * BQ;
    const uint32_t sq = base + L::Q + stage * NB * Q_BOX;
    const uint32_t sdo = base + L::DO + stage * NB * Q_BOX;
    const float2* st =
        reinterpret_cast<const float2*>(gbase + L::STATS + stage * STATS_BYTES);
    const uint32_t ds_off = L::DS + ((t - t_begin) & 1) * 2 * DS_BYTES;
    hopper::mbar_wait(full(stage), phase);

    // S^T = K Q^T and dP^T = V dO^T, two commit groups
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D16 / 16; ++kk) {
      const uint32_t a = (kk / 4) * KV_BOX + wg * (KV_BOX / 2) + (kk % 4) * 32;
      const uint32_t bq = (kk / 4) * Q_BOX + (kk % 4) * 32;
      hopper::wgmma_ss64<0, 0>(s, hopper::desc_sw128(sk + a, 0, 1024),
                               hopper::desc_sw128(sq + bq, 0, 1024), kk > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D16 / 16; ++kk) {
      const uint32_t a = (kk / 4) * KV_BOX + wg * (KV_BOX / 2) + (kk % 4) * 32;
      const uint32_t bq = (kk / 4) * Q_BOX + (kk % 4) * 32;
      hopper::wgmma_ss64<0, 0>(dp, hopper::desc_sw128(sv + a, 0, 1024),
                               hopper::desc_sw128(sdo + bq, 0, 1024), kk > 0);
    }
    hopper::wgmma_commit();

    // P^T while dP^T runs; masks only where a pair of the tile may be hidden
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    const bool mask = kw + 63 > qt || qt + BQ > seq ||
                      (window > 0 && kw <= qt + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * tc + (i & 1);
      float p = exp2f(s[i] * scale_log2 - st[col].x);
      if (mask && !visible(i & 2 ? j1 : j0, qt + col, seq, window)) p = 0.f;
      s[i] = p;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * tc + (i & 1);
      dp[i] = s[i] * (dp[i] - st[col].y);
    }

    // P^T and dS^T as the A fragments of 4 steps of 16 queries, hi + lo;
    // dS^T also into shared memory for dQ^T, 128-byte swizzled as TMA
    // would write a (keys, queries) tile
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
    unsigned char* ds_hi = gbase + ds_off;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], ph[kk][j],
                   pl[kk][j]);
        split_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1], sh[kk][j],
                   sl[kk][j]);
        const int row = 64 * wg + (j & 1 ? lr1 : lr0);
        const int col = 16 * kk + 8 * (j / 2) + 2 * tc;
        const uint32_t off =
            row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2));
        *reinterpret_cast<uint32_t*>(ds_hi + off) = sh[kk][j];
        *reinterpret_cast<uint32_t*>(ds_hi + DS_BYTES + off) = sl[kk][j];
      }
    hopper::fence_proxy_async();
    // after this barrier the warpgroup's dQ tile is free: its last
    // reduction has read it
    if (elect) hopper::bulk_wait_read<0>();
    hopper::bar_sync(1, CONSUMERS);

    // dV += P^T dO, dK += dS^T Q
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bdo = hopper::desc_sw128(sdo + kk * 2048, Q_BOX, 1024);
      hopper::wgmma_rs<D16>(dv_acc, ph[kk], bdo, 1);
      hopper::wgmma_rs<D16>(dv_acc, pl[kk], bdo, 1);
      const uint64_t bq = hopper::desc_sw128(sq + kk * 2048, Q_BOX, 1024);
      hopper::wgmma_rs<D16>(dk_acc, sh[kk], bq, 1);
      hopper::wgmma_rs<D16>(dk_acc, sl[kk], bq, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    // the stage's Q, dO and pairs are read: release it
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(stage));

    // dQ^T = K^T dS^T, both MN-major in shared memory
    hopper::fence_regs(dqt);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DQ_STEPS; ++ks) {
      const uint32_t krow = (key0 + 16 * ks) * 128;
      const uint64_t a = hopper::desc_sw128(sk + mb * KV_BOX + krow, KV_BOX,
                                            1024);
      hopper::wgmma_ss64<1, 1>(
          dqt, a, hopper::desc_sw128(base + ds_off + krow, DS_BYTES, 1024),
          ks > 0);
      hopper::wgmma_ss64<1, 1>(
          dqt, a,
          hopper::desc_sw128(base + ds_off + DS_BYTES + krow, DS_BYTES, 1024),
          1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dqt);
    // dQ^T into the warpgroup's tile as (query, head dim) rows, swizzled as
    // TMA reads it, then one reduction of its boxes into the workspace
    // (rows past S and head dims past D fall outside the tensor map)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = i & 2 ? lr1 : lr0, dd = d % 32;
      const int q = 8 * (i / 4) + 2 * tc + (i & 1);
      const uint32_t off = (d / 32) * DQ_BOX + q * 128 +
                           ((((dd >> 2) ^ (q & 7)) << 4) | ((dd & 3) * 4));
      *reinterpret_cast<float*>(dq_tile + off) = dqt[i];
    }
    hopper::fence_proxy_async();
    hopper::bar_sync(2 + wg, 128);
    if (elect) {
      for (int c = 0; c < 2; ++c)
        if (64 * mb + 32 * c < head_dim)
          hopper::tma_reduce_add_4d(&tdq, base + L::DQ + wg * DQ_TILE +
                                              c * DQ_BOX,
                                    64 * mb + 32 * c, qt, h, b);
      hopper::bulk_commit();
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (elect) hopper::bulk_wait<0>();

  // dK (times scale) and dV as bf16, (B, S, H, D) contiguous
#pragma unroll
  for (int j = 0; j < D16 / 8; ++j) {
    const int col = 8 * j + 2 * tc;
    if (col >= head_dim) continue;
    if (j0 < seq) {
      const long long at =
          ((static_cast<long long>(b) * seq + j0) * heads + h) * head_dim + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (j1 < seq) {
      const long long at =
          ((static_cast<long long>(b) * seq + j1) * heads + h) * head_dim + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(DQ_THREADS)
    bwd_dq_kernel(const float4* __restrict__ ws, uint2* __restrict__ dq,
                  long long n4, float scale) {
  const long long i =
      static_cast<long long>(blockIdx.x) * DQ_THREADS + threadIdx.x;
  if (i >= n4) return;
  const float4 x = ws[i];
  uint2 out;
  out.x = as_u32(__floats2bfloat162_rn(x.x * scale, x.y * scale));
  out.y = as_u32(__floats2bfloat162_rn(x.z * scale, x.w * scale));
  dq[i] = out;
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D16>
int launch(const void* const* in, const void* lse, void* stats, void* dq_ws,
           void* dq, void* dk, void* dv, int batch, int seq, int heads,
           int head_dim, const long long* st, int window, float scale,
           cudaStream_t stream) {
  const int s_pad = (seq + BQ - 1) / BQ * BQ;
  const long long rows = static_cast<long long>(batch) * heads * s_pad;
  bwd_prep_kernel<<<static_cast<unsigned>((rows + PREP_WARPS - 1) /
                                          PREP_WARPS),
                    32 * PREP_WARPS, 0, stream>>>(
      static_cast<const bf16*>(in[3]), static_cast<const bf16*>(in[4]),
      static_cast<const float*>(lse), static_cast<float2*>(stats),
      static_cast<float*>(dq_ws), rows, seq, heads, head_dim, s_pad,
      Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // tensor maps (D, S, H, B) of q, k, v and dO (in[0], in[1], in[2], in[4]):
  // boxes of 64 columns by the query tile's or the key tile's rows
  CUtensorMap maps[5];
  const int which[4] = {0, 1, 2, 4};
  for (int m = 0; m < 4; ++m) {
    const int i = which[m];
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                                static_cast<cuuint64_t>(seq),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(2 * st[3 * i + 1]),
        static_cast<cuuint64_t>(2 * st[3 * i + 2]),
        static_cast<cuuint64_t>(2 * st[3 * i])};
    const bool keys = i == 1 || i == 2;
    const cuuint32_t box[4] = {
        64, static_cast<cuuint32_t>(keys ? BKV : BQ), 1, 1};
    if (!hopper::encode_bf16(&maps[m], in[i], 4, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  {  // the f32 dQ workspace, contiguous (B, S, H, D): boxes of 32 head dims
     // by a query tile, for the reductions
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                                static_cast<cuuint64_t>(seq),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(4LL * heads * head_dim),
        static_cast<cuuint64_t>(4LL * head_dim),
        static_cast<cuuint64_t>(4LL * seq * heads * head_dim)};
    const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(BQ), 1, 1};
    if (!hopper::encode_sw128(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              dq_ws, 4, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = Layout<D16>::bytes;
  err = cudaFuncSetAttribute(bwd_main_kernel<D16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (seq + BKV - 1) / BKV);
  bwd_main_kernel<D16><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const float2*>(stats), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), seq, heads, head_dim, s_pad, window, scale,
      scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n4 = static_cast<long long>(batch) * seq * heads *
                       head_dim / 4;
  bwd_dq_kernel<<<static_cast<unsigned>((n4 + DQ_THREADS - 1) / DQ_THREADS),
                  DQ_THREADS, 0, stream>>>(static_cast<const float4*>(dq_ws),
                                           static_cast<uint2*>(dq), n4, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout: bf16 (batch, seq, heads, head_dim) with a contiguous
// last axis, strides a multiple of 8 elements and addresses of 16 bytes
// (TMA's rule; o and dout are read as 8-byte words); strides: 15 element
// strides, the (b, s, h) strides of q, k, v, o, dout in turn.  lse: the
// forward's contiguous f32 (batch, heads, seq).  stats: f32 scratch of
// batch * heads * S_pad * 2 elements, S_pad = seq rounded up to 64;
// dq_ws: f32 scratch of batch * seq * heads * head_dim elements; dq, dk,
// dv: contiguous bf16 (batch, seq, heads, head_dim), written.  head_dim a
// multiple of 8 in [8, 128]; `scale` multiplies the scores.  Launches
// three kernels on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments they do not take.
extern "C" int swa_flash_bwd(int head_dim, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const void* lse, void* stats, void* dq_ws,
                             void* dq, void* dk, void* dv, int batch, int seq,
                             int heads, const long long* strides, int window,
                             float scale, void* stream) {
  if (batch * heads == 0 || seq == 0) return 0;
  if (head_dim < 8 || head_dim > 128 || head_dim % 8 != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* in[5] = {q, k, v, o, dout};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SWA_BWD_CASE(D16)                                                  \
  case D16:                                                                \
    return launch<D16>(in, lse, stats, dq_ws, dq, dk, dv, batch, seq,      \
                       heads, head_dim, strides, window, scale, s);
  switch ((head_dim + 15) / 16 * 16) {
    SWA_BWD_CASE(16)
    SWA_BWD_CASE(32)
    SWA_BWD_CASE(48)
    SWA_BWD_CASE(64)
    SWA_BWD_CASE(80)
    SWA_BWD_CASE(96)
    SWA_BWD_CASE(112)
    SWA_BWD_CASE(128)
  }
#undef SWA_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
