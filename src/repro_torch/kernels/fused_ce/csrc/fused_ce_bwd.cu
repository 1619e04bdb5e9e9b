// The fused cross-entropy's backward for Hopper: the gradient's
// coefficients p, in place of the logits, for one block of vocab columns.
//
// Replaces no TPU kernel.  The Pallas kernel `fused_ce_stats` has no
// backward: JAX differentiates `chunked_cross_entropy` through XLA.  This
// kernel was added because the port's plain backward, which recomputed the
// logits in f32 row block by row block and ran its three products as f32
// SIMT GEMMs, took about a quarter of an olmo-1b training step (PERF.md).
//
// Function.  From bf16 hidden (T, d) and head (d, V), int32 labels, the
// forward's f32 lse (T,) and the per-row f32 coefficients g_lse and g_pick
// (either may be absent, as zeros), for the vocab columns [v0, v0 + ldc):
//   p[t, v] = exp(x[t, v] - lse[t]) g_lse[t] + [v == label[t]] g_pick[t],
//   x = hidden head (products exact in f32, summed in f32),
// and 0 for columns >= V.  p is written as two bf16 terms, hi and lo (the
// split of `hopper::split_bf16`): about 16 bits of the f32 p.  The output
// is (T, 2, ldc) bf16, row t holding hi of its ldc columns, then lo.  The
// wrapper (`ce.py::fused_ce_bwd`) runs the gradient's two products on
// bf16 tensor cores with `torch.addmm` (cuBLAS), each taking hi and lo,
// strided (T, ldc) views of the output, into one f32 output:
//   dh (T, d) f32 += p_hi W_blk^T + p_lo W_blk^T,
//   dW_blk (d, ldc) f32 = hidden^T p_hi + hidden^T p_lo;
// dW's columns are finished over all T and rounded once to bf16; dh is
// carried in f32 across the blocks and rounded once at the end.
// The plain f32 backward (`ref.py::fused_ce_bwd_ref`) computes the same
// function; they differ by p's 2^-16 and the order of f32 sums.
//
// Design.  The logits tile of `include/ce_logits.cuh`, the forward's
// mainloop: a TMA ring of 4 stages of (128 tokens x 64 of d, 256 vocab x 64
// of d), two consumer warpgroups on `wgmma` m64n256k16 with f32
// accumulation, one producer thread, the head read in place (K-major as
// `embed.T`, or MN-major).  One block owns a tile of tokens and a range of
// the block's vocab tiles, as the forward's blocks do (the wrapper's
// `vocab_splits`).  The epilogue turns each thread's 2 rows x 64 columns
// of f32 logits into p in registers and stores hi and lo as bf16 pairs;
// the f32 logits never reach device memory.  The wrapper picks the
// block's width so that p's scratch (4 T ldc bytes) is no larger than 2048
// rows of f32 logits over all of V.
//
// Bound on this card (H100 SXM data sheet, 989 TFLOP/s bf16).  The least
// work of the backward is three products of 2 T d V flops each: the
// recomputed logits, dh and dW; at olmo-1b's training call (T 16384, d
// 2048, V 50304) 10.1 TFLOP, 10.2 ms.  Its bytes (hidden and head read,
// dh and dW written: 0.55 GB) take 0.16 ms, so the products bound it.
// This design runs five products' worth (the logits once, dh and dW twice
// each, for hi and lo) and writes and reads p (3.3 GB at olmo-1b): its own
// floor is 17.1 ms there.
//
// Registers (`-Xptxas -v`): 168 at launch, 232 in the consumers after
// `setmaxnreg`, no spills; shared memory 193 KB, one block per SM, as the
// forward.  Measured by chip_smoke.py (phase 2f) on an
// NVIDIA H100 80GB HBM3 at 700 W: the whole backward 29.4 ms at olmo-1b's
// call, 35% of the least work's time and 58% of this design's floor (this
// kernel 8.6 ms of it, the two products 8.3 and 8.6 ms); the plain f32
// backward 201 ms (PERF.md).  The kernel's epilogue does not overlap the
// tensor cores: the forward computes the same logits in 5.8 ms.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ce_logits.cuh"
#include "hopper.cuh"

namespace {

constexpr int D_MULTIPLE = 32;  // the wrapper takes d a multiple of this

struct Args {
  const int* lab;        // (T,)
  const float* lse;      // (T,)
  const float* g_lse;    // (T,) or null: zeros
  const float* g_pick;   // (T,) or null: zeros
  __nv_bfloat16* p;      // (T, 2, ldc): hi, then lo
  int t, d, v, v0, ldc, tiles_per_split;
};

template <bool KMAJOR>
__global__ void __launch_bounds__(ce_logits::THREADS, 1)
    ce_bwd_p_kernel(const __grid_constant__ CUtensorMap th,
                    const __grid_constant__ CUtensorMap tw, Args a) {
  namespace cl = ce_logits;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const cl::Ring ring = cl::make_ring(smem_raw);
  const int row0 = blockIdx.x * cl::BT;
  const int n_tiles = (a.ldc + cl::BV - 1) / cl::BV;
  const int tile_begin = blockIdx.y * a.tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + a.tiles_per_split);
  const int k_steps = (a.d + cl::BK - 1) / cl::BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= cl::CONSUMER_WARPS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == cl::CONSUMER_WARPS && lane == 0)
      cl::produce<KMAJOR>(&th, &tw, ring, row0, a.v0 + tile_begin * cl::BV,
                          tile_end - tile_begin, k_steps);
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // this thread's rows r0 and r0 + 8 (the element layout of
    // `Consumer::tile`), with each row's label, lse in log2 units and
    // coefficients
    const int wg = warp / 4, g = lane / 4, tc = lane % 4;
    const int r0 = row0 + 64 * wg + 16 * (warp % 4) + g;
    const int rows[2] = {r0, r0 + 8};
    int lab[2];
    float lse2[2], gl[2], gp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < a.t;
      lab[r] = in ? a.lab[rows[r]] : -1;
      lse2[r] = in ? a.lse[rows[r]] * cl::LOG2E : 0.f;
      gl[r] = in && a.g_lse != nullptr ? a.g_lse[rows[r]] : 0.f;
      gp[r] = in && a.g_pick != nullptr ? a.g_pick[rows[r]] : 0.f;
    }
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    cl::Consumer pipe;
    for (int tile = tile_begin; tile < tile_end; ++tile) {
      pipe.tile<KMAJOR>(acc, ring, wg, lane, k_steps);

      // p of the tile's pairs of columns, as hi and lo; columns >= V are
      // zeros, columns >= ldc and rows >= T are not written
#pragma unroll
      for (int q = 0; q < 32; ++q) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = tile * cl::BV + 8 * q + 2 * tc;  // column of p
          if (rows[r] >= a.t || c >= a.ldc) continue;
          const int col = a.v0 + c;  // column of the vocabulary
          float pp[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = acc[4 * q + 2 * r + e];
            pp[e] = col + e < a.v
                        ? exp2f(fmaf(x, cl::LOG2E, -lse2[r])) * gl[r] +
                              (col + e == lab[r] ? gp[r] : 0.f)
                        : 0.f;
          }
          uint32_t hi, lo;
          hopper::split_bf16(pp[0], pp[1], hi, lo);
          uint32_t* row_p = reinterpret_cast<uint32_t*>(
              a.p + static_cast<long long>(rows[r]) * 2 * a.ldc);
          row_p[c / 2] = hi;
          row_p[(a.ldc + c) / 2] = lo;
        }
      }
    }
  }
}

}  // namespace

// hidden (t, d): row stride sh, last axis contiguous; head (d, v): strides
// sd, sv; both bf16, 16-byte aligned, sh a multiple of 8, and sd == 1 with
// sv a multiple of 8 or sv == 1 with sd a multiple of 8 (TMA's rule); d a
// multiple of 32.  labels (t,) int32; lse (t,) f32; g_lse, g_pick (t,) f32
// or null.  p: (t, 2, ldc) bf16 for the vocab columns [v0, v0 + ldc), ldc
// a multiple of 8, 0 <= v0 < v.  The block's vocab tiles are split into at
// most `nsplit` ranges of equal length.  Launches the kernel on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int fused_ce_bwd_p(const void* hidden, long long sh,
                              const void* head, long long sd, long long sv,
                              const int* labels, const float* lse,
                              const float* g_lse, const float* g_pick,
                              void* p, int t, int d, int v, int v0, int ldc,
                              int nsplit, void* stream) {
  if (t <= 0) return 0;
  if (d <= 0 || d % D_MULTIPLE != 0 || v <= 0 || v0 < 0 || v0 >= v ||
      ldc <= 0 || ldc % 8 != 0 || nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap th, tw;
  const int err_maps =
      ce_logits::encode_maps(&th, &tw, hidden, sh, head, sd, sv, t, d, v);
  if (err_maps != 0) return err_maps;
  const int n_tiles = (ldc + ce_logits::BV - 1) / ce_logits::BV;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int splits = (n_tiles + per - 1) / per;
  const Args args{labels, lse, g_lse, g_pick,
                  static_cast<__nv_bfloat16*>(p), t, d, v, v0, ldc, per};
  auto kernel = sd == 1 ? ce_bwd_p_kernel<true> : ce_bwd_p_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ce_logits::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + ce_logits::BT - 1) / ce_logits::BT, splits);
  kernel<<<grid, ce_logits::THREADS, ce_logits::SMEM,
           static_cast<cudaStream_t>(stream)>>>(th, tw, args);
  return static_cast<int>(cudaGetLastError());
}
