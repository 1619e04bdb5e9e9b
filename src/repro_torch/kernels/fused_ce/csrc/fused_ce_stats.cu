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
// never writes the logits.  A block is two consumer warpgroups and one
// producer warpgroup (384 threads; `setmaxnreg` gives the consumers 232
// registers and the producer 40).  One producer thread keeps a ring of
// STAGES = 4 stages of (hidden tile 128 tokens x 64 of d, head tile 256
// vocab x 64 of d), 48 KB a stage, in flight with `cp.async.bulk.tensor` on
// `mbarrier`s, in 128-byte swizzled atoms.  Each consumer warpgroup owns 64
// tokens and runs `wgmma` m64n256k16 with f32 accumulation, four per stage,
// keeping one stage's products in flight while it releases the stage
// before.  After each vocab tile it folds its 2 rows x 64 columns of
// logits per thread into (m, l, pick) in registers; the four threads of a
// quad hold a row and merge at the end with shuffles.  The head is read in
// place: with tied embeddings it is `embed.T`, a (d, V) view of the (V, d)
// `embed`, K-major for the B operand, and its tensor map is built on
// `embed` itself; an untied (d, V) head with V contiguous is MN-major and
// takes the transposed-B form.  The wrapper copies a head with neither
// stride 1 (or a stride or address TMA cannot take) into the K-major form.
// bf16 x bf16 products are exact in f32, so only the order of the f32
// sums differs from the Pallas kernel.  f32 (not on the main path): plain
// FMAs, 256 threads as a 16 x 16 grid over a 64 x 64 tile, each thread
// 4 x 4 logits.
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

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 32;  // depth of one f32 step over d; d % BK == 0
constexpr int THREADS = 256;

constexpr int F32_BT = 64, F32_BV = 64;      // f32 tile: tokens x vocab
constexpr int BF16_BT = 128, BF16_BV = 256;  // bf16 tile: tokens x vocab

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
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int BF16_BK = 64;  // depth of a stage: one 128-byte swizzle atom
constexpr int STAGES = 4;
constexpr int CONSUMER_WARPS = 8;
constexpr int BF16_THREADS = 384;  // two consumer warpgroups, one producer
constexpr uint32_t H_BYTES = BF16_BT * BF16_BK * 2;  // hidden tile, 16 KB
constexpr uint32_t W_BYTES = BF16_BV * BF16_BK * 2;  // head tile, 32 KB
constexpr size_t BF16_SMEM = 1024 + STAGES * (H_BYTES + W_BYTES) +
                             16 * STAGES;  // 1024 of slack aligns the atoms
constexpr float LOG2E = 1.4426950408889634f;

// acc (+)= hidden x head for one 16-deep step: m64n256k16, A K-major and B
// K-major (TRANS_B 0) or MN-major (TRANS_B 1) in shared memory; scale_d = 0
// overwrites acc.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_hw(float (&d)[128], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
      "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, "
      "%129, p, 1, 1, 0, %131; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <bool KMAJOR>
__global__ void __launch_bounds__(BF16_THREADS, 1)
    ce_bf16_kernel(const __grid_constant__ CUtensorMap th,
                   const __grid_constant__ CUtensorMap tw, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sh = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sw = sh + STAGES * H_BYTES;
  const uint32_t bars = sw + STAGES * W_BYTES;
  auto full = [bars](int s) { return bars + 8 * s; };
  auto empty = [bars](int s) { return bars + 8 * (STAGES + s); };
  const int row0 = blockIdx.x * BF16_BT;
  const int n_tiles = (a.v + BF16_BV - 1) / BF16_BV;
  const int tile_begin = blockIdx.y * a.tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + a.tiles_per_split);
  const int k_steps = (a.d + BF16_BK - 1) / BF16_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = tile_begin; tile < tile_end; ++tile) {
        const int v0 = tile * BF16_BV;
        for (int ks = 0; ks < k_steps; ++ks) {
          const int k0 = ks * BF16_BK;
          hopper::mbar_wait(empty(stage), phase ^ 1);
          hopper::mbar_expect_tx(full(stage), H_BYTES + W_BYTES);
          hopper::tma_load_2d(sh + stage * H_BYTES, &th, full(stage), k0,
                              row0);
          if (KMAJOR) {  // (V, d) rows: one box of 256 rows x 64 of d
            hopper::tma_load_2d(sw + stage * W_BYTES, &tw, full(stage), k0,
                                v0);
          } else {  // (d, V) rows: four boxes of 64 rows of d x 64 vocab
            for (int j = 0; j < BF16_BV / 64; ++j)
              hopper::tma_load_2d(sw + stage * W_BYTES + j * 8192, &tw,
                                  full(stage), v0 + 64 * j, k0);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // warpgroup wg owns tokens row0 + 64 wg .. + 63; this thread rows r0
    // and r0 + 8; element i of acc is row (i & 2 ? r1 : r0), column
    // v0 + 8 (i / 4) + 2 tc + (i & 1)
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

    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = tile_begin; tile < tile_end; ++tile) {
      const int v0 = tile * BF16_BV;
      for (int ks = 0; ks < k_steps; ++ks) {
        hopper::mbar_wait(full(stage), phase);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BF16_BK / 16; ++kk) {
          const uint64_t da = hopper::desc_sw128(
              sh + stage * H_BYTES + wg * (H_BYTES / 2) + kk * 32, 0, 1024);
          const uint64_t db =
              KMAJOR ? hopper::desc_sw128(sw + stage * W_BYTES + kk * 32, 0,
                                          1024)
                     : hopper::desc_sw128(sw + stage * W_BYTES + kk * 2048,
                                          8192, 1024);
          wgmma_hw<KMAJOR ? 0 : 1>(acc, da, db, ks > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        if (ks > 0) {  // the last stage's products are done: release it
          hopper::wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(empty(prev));
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(prev));
      hopper::fence_regs(acc);

      // fold the tile into (m, l, pick); columns >= V are left out
      const bool whole = v0 + BF16_BV <= a.v;
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
          l[r] += exp2f((acc[i] - m[r]) * LOG2E);
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

// Tensor maps of hidden (T, d) and the head, and the bf16 launch.  The
// head is K-major ((V, d) rows of stride sv; sd == 1) or MN-major ((d, V)
// rows of stride sd; sv == 1).
int launch_bf16(const Args& args, dim3 grid, cudaStream_t stream) {
  CUtensorMap th, tw;
  const cuuint64_t h_dims[2] = {static_cast<cuuint64_t>(args.d),
                                static_cast<cuuint64_t>(args.t)};
  const cuuint64_t h_stride[1] = {static_cast<cuuint64_t>(2 * args.sh)};
  const cuuint32_t h_box[2] = {BF16_BK, BF16_BT};
  if (!hopper::encode_bf16(&th, args.h, 2, h_dims, h_stride, h_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool kmajor = args.sd == 1;
  if (!kmajor && args.sv != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t w_dims[2] = {
      static_cast<cuuint64_t>(kmajor ? args.d : args.v),
      static_cast<cuuint64_t>(kmajor ? args.v : args.d)};
  const cuuint64_t w_stride[1] = {
      static_cast<cuuint64_t>(2 * (kmajor ? args.sv : args.sd))};
  const cuuint32_t w_box[2] = {
      BF16_BK, static_cast<cuuint32_t>(kmajor ? BF16_BV : BF16_BK)};
  if (!hopper::encode_bf16(&tw, args.w, 2, w_dims, w_stride, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = kmajor ? ce_bf16_kernel<true> : ce_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(BF16_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, BF16_THREADS, BF16_SMEM, stream>>>(th, tw, args);
  return static_cast<int>(cudaGetLastError());
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
  const int bt = dtype == 0 ? F32_BT : BF16_BT;
  const int bv = dtype == 0 ? F32_BV : BF16_BV;
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
