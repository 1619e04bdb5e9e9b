// Streaming-vocab cross-entropy statistics for Hopper.
//
// Replaces the Pallas TPU kernel `fused_ce_stats`
// (src/repro/kernels/fused_ce/ce.py:67, `pl.pallas_call` at :84).  It
// computes the same function: for each token t, over the logits
// x[t, v] = sum_k hidden[t, k] * head[k, v] (products of the operands
// widened to f32, summed in f32), lse[t] = m + log(max(l, 1e-30)) with m the
// row max and l = sum_v exp(x - m), and pick[t] = x[t, label[t]], -1e30 for
// a label outside [0, V).  The (T, V) logits never reach device memory.
//
// Design.  The TPU kernel walks vocab tiles on a sequential grid axis and
// carries (m, l, pick) in VMEM scratch between grid steps.  Here blocks run
// in parallel in no order.  One block owns a tile of tokens and a range of
// vocab tiles and loops over that range itself; each thread keeps its own
// online (m, l, pick) for the rows and columns it holds, in registers, and
// the owners of a row merge theirs once, at the end.  At T = 8192 one block
// per token tile would be 64 blocks on 132 SMs, so the wrapper also splits
// V into `nsplit` ranges: each block writes its partial (m, l, pick) to a
// scratch buffer and a second, small kernel merges the ranges (m = max,
// l = sum l_s e^(m_s - m), pick = max) in a fixed order and writes lse and
// pick.  Columns >= V of the ragged last vocab tile load as zeros and are
// left out of the statistics, so the (d, V) head is never padded in memory.
//
// d: any multiple of 32; 2048 at olmo-1b, 256 at its smoke size; the
// wrapper raises on any other.  T and V are any positive sizes.
//
// bf16 (the training path): the shape of a Hopper GEMM whose epilogue
// never writes the logits.  The logits tile of `include/ce_logits.cuh`
// (a TMA ring of 4 stages of 128 tokens and 256 vocab columns by 64 of d,
// two consumer warpgroups on `wgmma` m64n256k16, one producer thread; the
// head read in place, K-major as `embed.T` or MN-major) gives each
// consumer thread 2 rows x 64 columns of f32 logits a vocab tile, which
// it folds into (m, l, pick) in registers; the four threads of a quad
// hold a row and merge at the end with shuffles.  The wrapper copies a
// head with neither stride 1 (or a stride or address TMA cannot take)
// into the K-major form.  bf16 x bf16 products are exact in f32, so only
// the order of the f32 sums differs from the Pallas kernel.  f32 (not on
// the main path): plain FMAs, 256 threads as a 16 x 16 grid over a 64 x 64
// tile, each thread 4 x 4 logits.
//
// Bound on this card (H100 SXM data sheet).  At the training path's shape
// (T 16384 = 4 x 4096 tokens, d 2048, V 50304, bf16) the function does
// 2 T d V = 3.38 TFLOP: 3.41 ms at 989 TFLOP/s.  It must read hidden (67 MB)
// and head (206 MB) once: 0.08 ms at 3.35 TB/s.  So the operations bound
// it.  The hidden tile is read again for every vocab tile and the head
// tile for every token tile (from L2): at 128 x 256 tiles a stage's 48 KB
// feeds 4.2 MFLOP, so the L2 streams about 40 GB per call.
//
// Registers (`-Xptxas -v`, nvcc 12.9): 168 at launch, 232 in the
// consumers after `setmaxnreg`, no spills; shared memory 193 KB (4 stages
// of 48 KB and 1 KB of alignment), one block per SM.  Measured by
// chip_smoke.py (phase 2c) on an NVIDIA H100 80GB HBM3 at 700 W: 6.20 ms
// at that shape (43.9 ms for the `mma.sync` kernel this replaces), 1.8x
// the bound; cuBLAS's bare h @ W takes 4.47 ms (PERF.md).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ce_logits.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 32;  // depth of one f32 step over d; d % BK == 0
constexpr int THREADS = 256;

constexpr int F32_BT = 64, F32_BV = 64;  // f32 tile: tokens x vocab

struct Args {
  const void* h;       // (T, d), row stride sh, last axis contiguous
  long long sh;
  const void* w;       // (d, V), strides sd, sv
  long long sd, sv;
  const int* lab;      // (T,)
  float* part;         // [3][nsplit][T]: partial m, l, pick
  int t, d, v, tiles_per_split, nsplit;
};

// Fold a new tile's largest valid logit into (m, l) before its terms are
// added: rescale l when the max moves.  Rows with no valid logit yet keep
// m = -1e30, l = 0.
__device__ __forceinline__ void raise_max(float& m, float& l, float mx) {
  if (mx > m) {
    l *= expf(m - mx);
    m = mx;
  }
}

__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void write_part(const Args& a, int row, float m,
                                           float l, float pick) {
  const long long plane = static_cast<long long>(a.nsplit) * a.t;
  const long long i = static_cast<long long>(blockIdx.y) * a.t + row;
  a.part[i] = m;
  a.part[plane + i] = l;
  a.part[2 * plane + i] = pick;
}

// ---------------------------------------------------------------------------
// f32: plain FMAs
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) ce_f32_kernel(Args a) {
  __shared__ float Hs[BK][F32_BT + 1];  // hidden tile, k-major
  __shared__ float Ws[BK][F32_BV + 1];  // head tile, k-major
  const float* h = static_cast<const float*>(a.h);
  const float* w = static_cast<const float*>(a.w);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * F32_BT;
  const int n_tiles = (a.v + F32_BV - 1) / F32_BV;
  const int tile_begin = blockIdx.y * a.tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + a.tiles_per_split);

  int lab[4];
  float m[4], l[4], pick[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    lab[i] = row < a.t ? a.lab[row] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
    pick[i] = NEG_INF;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int v0 = tile * F32_BV;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    for (int k0 = 0; k0 < a.d; k0 += BK) {
      __syncthreads();  // the last step's tiles are consumed
      for (int e = tid; e < F32_BT * BK; e += THREADS) {
        const int r = e / BK, k = e % BK, row = row0 + r;
        Hs[k][r] = row < a.t ? h[static_cast<long long>(row) * a.sh + k0 + k]
                             : 0.f;
      }
      for (int e = tid; e < F32_BV * BK; e += THREADS) {
        const int c = e / BK, k = e % BK, col = v0 + c;
        Ws[k][c] = col < a.v ? w[static_cast<long long>(k0 + k) * a.sd +
                                 static_cast<long long>(col) * a.sv]
                             : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = Hs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = Ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v0 + tx + 16 * j < a.v) mx = fmaxf(mx, s[i][j]);
      raise_max(m[i], l[i], mx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        if (col < a.v) {
          l[i] += expf(s[i][j] - m[i]);
          if (col == lab[i]) pick[i] = fmaxf(pick[i], s[i][j]);
        }
      }
    }
  }

  // a row's 16 owners are one half-warp (same ty)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float p2 = __shfl_xor_sync(0xffffffffu, pick[i], off);
      merge(m[i], l[i], m2, l2);
      pick[i] = fmaxf(pick[i], p2);
    }
    const int row = row0 + ty + 16 * i;
    if (tx == 0 && row < a.t) write_part(a, row, m[i], l[i], pick[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16: the logits tile of ce_logits.cuh, folded in registers
// ---------------------------------------------------------------------------

template <bool KMAJOR>
__global__ void __launch_bounds__(ce_logits::THREADS, 1)
    ce_bf16_kernel(const __grid_constant__ CUtensorMap th,
                   const __grid_constant__ CUtensorMap tw, Args a) {
  namespace cl = ce_logits;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const cl::Ring ring = cl::make_ring(smem_raw);
  const int row0 = blockIdx.x * cl::BT;
  const int n_tiles = (a.v + cl::BV - 1) / cl::BV;
  const int tile_begin = blockIdx.y * a.tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + a.tiles_per_split);
  const int k_steps = (a.d + cl::BK - 1) / cl::BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= cl::CONSUMER_WARPS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == cl::CONSUMER_WARPS && lane == 0)
      cl::produce<KMAJOR>(&th, &tw, ring, row0, tile_begin * cl::BV,
                          tile_end - tile_begin, k_steps);
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // warpgroup wg owns tokens row0 + 64 wg .. + 63; this thread rows r0
    // and r0 + 8 (the element layout of `Consumer::tile`)
    const int wg = warp / 4, g = lane / 4, tc = lane % 4;
    const int r0 = row0 + 64 * wg + 16 * (warp % 4) + g;
    const int rows[2] = {r0, r0 + 8};
    int lab[2];
    float m[2], l[2], pick[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lab[r] = rows[r] < a.t ? a.lab[rows[r]] : -1;
      m[r] = NEG_INF;
      l[r] = 0.f;
      pick[r] = NEG_INF;
    }
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    cl::Consumer pipe;
    for (int tile = tile_begin; tile < tile_end; ++tile) {
      const int v0 = tile * cl::BV;
      pipe.tile<KMAJOR>(acc, ring, wg, lane, k_steps);

      // fold the tile into (m, l, pick); columns >= V are left out
      const bool whole = v0 + cl::BV <= a.v;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 128; ++i) {
        const int col = v0 + 8 * (i / 4) + 2 * tc + (i & 1);
        if (whole || col < a.v)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) raise_max(m[r], l[r], mx[r]);
#pragma unroll
      for (int i = 0; i < 128; ++i) {
        const int r = (i >> 1) & 1;
        const int col = v0 + 8 * (i / 4) + 2 * tc + (i & 1);
        if (whole || col < a.v) {
          l[r] += exp2f((acc[i] - m[r]) * cl::LOG2E);
          if (col == lab[r]) pick[r] = fmaxf(pick[r], acc[i]);
        }
      }
    }

    // a row's owners are the four threads of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float p2 = __shfl_xor_sync(0xffffffffu, pick[r], off);
        merge(m[r], l[r], m2, l2);
        pick[r] = fmaxf(pick[r], p2);
      }
      if (tc == 0 && rows[r] < a.t) write_part(a, rows[r], m[r], l[r], pick[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Merge of the vocab ranges
// ---------------------------------------------------------------------------

__global__ void ce_merge_kernel(const float* __restrict__ part, int t,
                                int nsplit, float* __restrict__ lse,
                                float* __restrict__ pick) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= t) return;
  const long long plane = static_cast<long long>(nsplit) * t;
  float m = NEG_INF, l = 0.f, p = NEG_INF;
  for (int s = 0; s < nsplit; ++s) {
    const long long i = static_cast<long long>(s) * t + r;
    merge(m, l, part[i], part[plane + i]);
    p = fmaxf(p, part[2 * plane + i]);
  }
  lse[r] = m + logf(fmaxf(l, 1e-30f));
  pick[r] = p;
}

// The bf16 launch.  The head is K-major ((V, d) rows of stride sv;
// sd == 1) or MN-major ((d, V) rows of stride sd; sv == 1).
int launch_bf16(const Args& args, dim3 grid, cudaStream_t stream) {
  CUtensorMap th, tw;
  const int err_maps = ce_logits::encode_maps(&th, &tw, args.h, args.sh,
                                              args.w, args.sd, args.sv,
                                              args.t, args.d, args.v);
  if (err_maps != 0) return err_maps;
  auto kernel = args.sd == 1 ? ce_bf16_kernel<true> : ce_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ce_logits::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, ce_logits::THREADS, ce_logits::SMEM, stream>>>(th, tw, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One block's tile for `dtype` (0 float32, 1 bfloat16): its tokens when
// `axis` is 0, its vocab columns when 1; 0 for any other argument.  The
// wrapper sizes the vocab split from these, so the tiles live here alone.
extern "C" int fused_ce_stats_tile(int dtype, int axis) {
  if (dtype == 0) return axis == 0 ? F32_BT : axis == 1 ? F32_BV : 0;
  if (dtype == 1)
    return axis == 0 ? ce_logits::BT : axis == 1 ? ce_logits::BV : 0;
  return 0;
}

// hidden (t, d): row stride sh, last axis contiguous; head (d, v): strides
// sd, sv; labels (t,) int32; lse, pick (t,) f32; part: scratch of at least
// 3 * nsplit * t f32.  dtype: 0 float32, 1 bfloat16 (hidden and head
// alike); d a multiple of 32.  For bf16 (TMA's rule): hidden and head
// 16-byte aligned, sh a multiple of 8, and sd == 1 with sv a multiple of 8
// or sv == 1 with sd a multiple of 8.  The vocab tiles are split into at most
// `nsplit` ranges of equal length.  Launches the two kernels on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int fused_ce_stats_fwd(int dtype, const void* hidden, long long sh,
                                  const void* head, long long sd, long long sv,
                                  const int* labels, float* lse, float* pick,
                                  float* part, int t, int d, int v, int nsplit,
                                  void* stream) {
  if (t <= 0) return 0;
  if (d <= 0 || d % BK != 0 || v <= 0 || nsplit <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bt = dtype == 0 ? F32_BT : ce_logits::BT;
  const int bv = dtype == 0 ? F32_BV : ce_logits::BV;
  const int n_tiles = (v + bv - 1) / bv;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int splits = (n_tiles + per - 1) / per;
  const Args args{hidden, sh, head, sd, sv, labels, part, t, d, v, per, splits};
  const dim3 grid((t + bt - 1) / bt, splits);
  if (dtype == 0) {
    ce_f32_kernel<<<grid, THREADS, 0, s>>>(args);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const int err = launch_bf16(args, grid, s);
    if (err != 0) return err;
  }
  ce_merge_kernel<<<(t + 255) / 256, 256, 0, s>>>(part, t, splits, lse, pick);
  return static_cast<int>(cudaGetLastError());
}
