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
// online (m, l, pick) for the rows and columns it computes, in registers,
// and the block merges its threads' statistics once, at the end (shuffles,
// then shared memory).  At T = 8192 one block per token tile would be 64
// blocks on 132 SMs, so the wrapper also splits V into `nsplit` ranges:
// each block writes its partial (m, l, pick) to a scratch buffer and a
// second, small kernel merges the ranges (m = max, l = sum l_s e^(m_s - m),
// pick = max) and writes lse and pick.  A ragged last vocab tile is masked
// here (olmo-1b's V = 50304 = 393 * 128 leaves none at this tile width; the
// Pallas kernel's 512-wide tiles leave one of 128): columns >= V load as
// zeros and are left out of the statistics, so the (d, V) head is never
// padded in memory.  The head is read through its two strides: with tied
// embeddings it is `embed.T`, a (d, V) view with strides (1, d), and its
// columns are then contiguous 16-byte loads; any other strides take scalar
// loads.  The hidden rows must have a contiguous last axis.
//
// d: any multiple of 32 (BK, the depth of one shared-memory step); 2048 at
// olmo-1b, 256 at its smoke size; the wrapper raises on any other.  T and V
// are any positive sizes.
//
// bf16: tensor cores, `mma.sync` m16n8k16 with f32 accumulation, as
// `swa_flash.cu` does.  bf16 x bf16 products are exact in f32, so only the
// order of the f32 sums differs from the Pallas kernel.  A block is 8 warps
// over a 128-token x 128-vocab tile, each warp 32 x 64; tiles of hidden and
// head sit in shared memory as [row][k] bf16, rows padded by 8 elements
// against bank conflicts.  f32: plain FMAs, 256 threads as a 16 x 16 grid
// over a 64 x 64 tile, each thread 4 x 4 logits.
//
// Bound on this card (H100 SXM data sheet).  At the training path's shape
// (T 16384 = 4 x 4096 tokens, d 2048, V 50304, bf16) the function does
// 2 T d V = 3.38 TFLOP: 3.41 ms at 989 TFLOP/s.  It must read hidden (67 MB)
// and head (206 MB) once: 0.08 ms at 3.35 TB/s.  So the operations bound
// it.  This kernel loads its tiles with plain loads and no overlap of loads
// and products (no cp.async/TMA pipeline), rereads the hidden tile for
// every vocab tile (from L2), and uses `mma.sync`, not `wgmma`: it is a
// simple kernel that is right, and its speed is later work.  Measured by
// chip_smoke.py (phase 2c) on an NVIDIA H100 80GB HBM3 at 700 W: 43.9 ms at
// that shape, 12.9x the bound (PERF.md).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 32;  // depth of one step over d; d % BK == 0
constexpr int THREADS = 256;

constexpr int F32_BT = 64, F32_BV = 64;     // f32 tile: tokens x vocab
constexpr int BF16_BT = 128, BF16_BV = 128;  // bf16 tile: tokens x vocab

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
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int LD = BK + 8;  // shared-memory row stride, elements (80 bytes)

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one m16n8k16 tile; a: 4 regs of 2 bf16, b: 2 regs.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 values, element i at src[i * step]; zeros when !inside.
// 16-byte load when step == 1 and `vec`.
__device__ __forceinline__ uint4 load8(const bf16* src, long long step,
                                       bool inside, bool vec) {
  uint4 val = make_uint4(0, 0, 0, 0);
  if (!inside) return val;
  if (vec) return *reinterpret_cast<const uint4*>(src);
  __align__(16) bf16 tmp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) tmp[i] = src[i * step];
  return *reinterpret_cast<const uint4*>(tmp);
}

__global__ void __launch_bounds__(THREADS, 2) ce_bf16_kernel(Args a) {
  __shared__ __align__(16) bf16 Hs[BF16_BT * LD];  // [token][k]
  __shared__ __align__(16) bf16 Ws[BF16_BV * LD];  // [vocab][k]
  __shared__ float stat[3][2][BF16_BT];            // per column half
  const bf16* h = static_cast<const bf16*>(a.h);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row and column pair
  const int wr = warp & 3, wc = warp >> 2;  // warp's 32 rows, 64 columns
  const int row0 = blockIdx.x * BF16_BT;
  const int n_tiles = (a.v + BF16_BV - 1) / BF16_BV;
  const int tile_begin = blockIdx.y * a.tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + a.tiles_per_split);
  const bool h_vec =
      ((reinterpret_cast<uintptr_t>(h) | static_cast<uintptr_t>(a.sh * 2)) &
       15) == 0;
  const bool w_vec =
      a.sd == 1 &&
      ((reinterpret_cast<uintptr_t>(w) | static_cast<uintptr_t>(a.sv * 2)) &
       15) == 0;

  // this thread's rows: index ri = 2 * mi + half, row
  // wr * 32 + mi * 16 + g + 8 * half of the tile
  int lab[4];
  float m[4], l[4], pick[4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int row = row0 + wr * 32 + (ri >> 1) * 16 + g + 8 * (ri & 1);
    lab[ri] = row < a.t ? a.lab[row] : -1;
    m[ri] = NEG_INF;
    l[ri] = 0.f;
    pick[ri] = NEG_INF;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int v0 = tile * BF16_BV;
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

    for (int k0 = 0; k0 < a.d; k0 += BK) {
      __syncthreads();  // the last step's tiles are consumed
      for (int e = tid; e < BF16_BT * (BK / 8); e += THREADS) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8, row = row0 + r;
        *reinterpret_cast<uint4*>(Hs + r * LD + c) =
            load8(h + static_cast<long long>(row) * a.sh + k0 + c, 1,
                  row < a.t, h_vec);
      }
      for (int e = tid; e < BF16_BV * (BK / 8); e += THREADS) {
        const int n = e / (BK / 8), c = (e % (BK / 8)) * 8, col = v0 + n;
        const bf16* src = w + static_cast<long long>(k0 + c) * a.sd +
                          static_cast<long long>(col) * a.sv;
        *reinterpret_cast<uint4*>(Ws + n * LD + c) =
            load8(src, a.sd, col < a.v, w_vec);
      }
      __syncthreads();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const bf16* p = Hs + (wr * 32 + mi * 16 + g) * LD + kt * 16 + tig * 2;
          af[mi][0] = lds32(p);
          af[mi][1] = lds32(p + 8 * LD);
          af[mi][2] = lds32(p + 8);
          af[mi][3] = lds32(p + 8 * LD + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const bf16* p = Ws + (wc * 64 + nt * 8 + g) * LD + kt * 16 + tig * 2;
          const uint32_t b0 = lds32(p), b1 = lds32(p + 8);
          mma_bf16(acc[0][nt], af[0], b0, b1);
          mma_bf16(acc[1][nt], af[1], b0, b1);
        }
      }
    }

    // element e of acc[mi][nt] is row (e < 2 ? g : g + 8) of m-tile mi,
    // column wc * 64 + nt * 8 + tig * 2 + (e & 1) of the vocab tile
    const int cbase = v0 + wc * 64 + tig * 2;
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int mi = ri >> 1, e0 = 2 * (ri & 1);
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (cbase + nt * 8 + c < a.v) mx = fmaxf(mx, acc[mi][nt][e0 + c]);
      raise_max(m[ri], l[ri], mx);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = cbase + nt * 8 + c;
          const float x = acc[mi][nt][e0 + c];
          if (col < a.v) {
            l[ri] += expf(x - m[ri]);
            if (col == lab[ri]) pick[ri] = fmaxf(pick[ri], x);
          }
        }
    }
  }

  // a row's owners: the 4 threads of a quad in each of the two column warps
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[ri], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[ri], off);
      const float p2 = __shfl_xor_sync(0xffffffffu, pick[ri], off);
      merge(m[ri], l[ri], m2, l2);
      pick[ri] = fmaxf(pick[ri], p2);
    }
    if (tig == 0) {
      const int r = wr * 32 + (ri >> 1) * 16 + g + 8 * (ri & 1);
      stat[0][wc][r] = m[ri];
      stat[1][wc][r] = l[ri];
      stat[2][wc][r] = pick[ri];
    }
  }
  __syncthreads();
  if (tid < BF16_BT && row0 + tid < a.t) {
    float mm = stat[0][0][tid], ll = stat[1][0][tid];
    merge(mm, ll, stat[0][1][tid], stat[1][1][tid]);
    write_part(a, row0 + tid, mm, ll,
               fmaxf(stat[2][0][tid], stat[2][1][tid]));
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

}  // namespace

// One block's tile for `dtype` (0 float32, 1 bfloat16): its tokens when
// `axis` is 0, its vocab columns when 1; 0 for any other argument.  The
// wrapper sizes the vocab split from these, so the tiles live here alone.
extern "C" int fused_ce_stats_tile(int dtype, int axis) {
  if (dtype == 0) return axis == 0 ? F32_BT : axis == 1 ? F32_BV : 0;
  if (dtype == 1) return axis == 0 ? BF16_BT : axis == 1 ? BF16_BV : 0;
  return 0;
}

// hidden (t, d): row stride sh, last axis contiguous; head (d, v): strides
// sd, sv; labels (t,) int32; lse, pick (t,) f32; part: scratch of at least
// 3 * nsplit * t f32.  dtype: 0 float32, 1 bfloat16 (hidden and head
// alike); d a multiple of 32.  The vocab tiles are split into at most
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
  const int bt = dtype == 0 ? F32_BT : BF16_BT;
  const int bv = dtype == 0 ? F32_BV : BF16_BV;
  const int n_tiles = (v + bv - 1) / bv;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int splits = (n_tiles + per - 1) / per;
  const Args args{hidden, sh, head, sd, sv, labels, part, t, d, v, per, splits};
  const dim3 grid((t + bt - 1) / bt, splits);
  if (dtype == 0)
    ce_f32_kernel<<<grid, THREADS, 0, s>>>(args);
  else
    ce_bf16_kernel<<<grid, THREADS, 0, s>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_merge_kernel<<<(t + 255) / 256, 256, 0, s>>>(part, t, splits, lse, pick);
  return static_cast<int>(cudaGetLastError());
}
