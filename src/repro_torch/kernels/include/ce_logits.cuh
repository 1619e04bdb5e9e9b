// The logits tile of the fused cross-entropy, shared by its forward
// (`fused_ce_stats.cu`) and its backward (`fused_ce_bwd.cu`): the TMA ring
// that feeds bf16 tiles of hidden (T, d) and of the head (d, V) to `wgmma`,
// and the products of one tile of 128 tokens x 256 vocab columns of the
// logits x = hidden head over all of d, left in f32 registers for each
// kernel's own epilogue.  The (T, V) logits never reach device memory.
//
// A block is two consumer warpgroups and one producer warpgroup (384
// threads; the kernel's `setmaxnreg` gives the consumers 232 registers and
// the producer 40).  One producer thread keeps a ring of STAGES = 4 stages
// of (hidden tile 128 tokens x 64 of d, head tile 256 vocab x 64 of d), 48
// KB a stage, in flight with `cp.async.bulk.tensor` on `mbarrier`s, in
// 128-byte swizzled atoms.  Each consumer warpgroup owns 64 tokens and runs
// `wgmma` m64n256k16 with f32 accumulation, four per stage, keeping one
// stage's products in flight while it releases the stage before.  The head
// is read in place: with tied embeddings it is `embed.T`, a (d, V) view of
// the (V, d) `embed`, K-major for the B operand, and its tensor map is
// built on `embed` itself; an untied (d, V) head with V contiguous is
// MN-major and takes the transposed-B form.  Columns >= V of a ragged last
// vocab tile, and tokens >= T, load as zeros, so nothing is padded in
// memory.  bf16 x bf16 products are exact in f32.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace ce_logits {

constexpr int BT = 128;  // tokens of a block's tile
constexpr int BV = 256;  // vocab columns of a tile
constexpr int BK = 64;   // depth of a stage: one 128-byte swizzle atom
constexpr int STAGES = 4;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 384;  // two consumer warpgroups, one producer
constexpr uint32_t H_BYTES = BT * BK * 2;  // hidden tile, 16 KB
constexpr uint32_t W_BYTES = BV * BK * 2;  // head tile, 32 KB
constexpr size_t SMEM = 1024 + STAGES * (H_BYTES + W_BYTES) +
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

// The ring in the block's dynamic shared memory: STAGES hidden tiles,
// STAGES head tiles, then the full and the empty barrier of each stage.
struct Ring {
  uint32_t h, w, bars;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (STAGES + s); }
};

// Lays the ring out in `smem_raw` and initialises its barriers; every
// thread of the block calls it.
__device__ __forceinline__ Ring make_ring(unsigned char* smem_raw) {
  Ring r;
  r.h = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  r.w = r.h + STAGES * H_BYTES;
  r.bars = r.w + STAGES * W_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(r.full(s), 1);
      hopper::mbar_init(r.empty(s), CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  return r;
}

// The producer thread: the stages of `n_tiles` vocab tiles, the first at
// vocab column `col0`, each over all `k_steps` steps of d, for the tokens
// from `row0`.
template <bool KMAJOR>
__device__ __forceinline__ void produce(const CUtensorMap* th,
                                        const CUtensorMap* tw, const Ring& r,
                                        int row0, int col0, int n_tiles,
                                        int k_steps) {
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int v0 = col0 + i * BV;
    for (int ks = 0; ks < k_steps; ++ks) {
      const int k0 = ks * BK;
      hopper::mbar_wait(r.empty(stage), phase ^ 1);
      hopper::mbar_expect_tx(r.full(stage), H_BYTES + W_BYTES);
      hopper::tma_load_2d(r.h + stage * H_BYTES, th, r.full(stage), k0, row0);
      if (KMAJOR) {  // (V, d) rows: one box of 256 rows x 64 of d
        hopper::tma_load_2d(r.w + stage * W_BYTES, tw, r.full(stage), k0, v0);
      } else {  // (d, V) rows: four boxes of 64 rows of d x 64 vocab
        for (int j = 0; j < BV / 64; ++j)
          hopper::tma_load_2d(r.w + stage * W_BYTES + j * 8192, tw,
                              r.full(stage), v0 + 64 * j, k0);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup's place in the ring, carried from tile to tile.
struct Consumer {
  int stage = 0, prev = 0;
  uint32_t phase = 0;

  // acc = this warpgroup's 64 tokens x 256 columns of the next tile's
  // logits, the stages released as they are consumed.  Element i of acc
  // is row (i & 2 ? r + 8 : r), column v0 + 8 (i / 4) + 2 tc + (i & 1) of
  // the tile, where r = 64 wg + 16 (warp % 4) + lane / 4 and tc = lane % 4.
  template <bool KMAJOR>
  __device__ __forceinline__ void tile(float (&acc)[128], const Ring& r,
                                       int wg, int lane, int k_steps) {
    for (int ks = 0; ks < k_steps; ++ks) {
      hopper::mbar_wait(r.full(stage), phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(
            r.h + stage * H_BYTES + wg * (H_BYTES / 2) + kk * 32, 0, 1024);
        const uint64_t db =
            KMAJOR ? hopper::desc_sw128(r.w + stage * W_BYTES + kk * 32, 0,
                                        1024)
                   : hopper::desc_sw128(r.w + stage * W_BYTES + kk * 2048,
                                        8192, 1024);
        wgmma_hw<KMAJOR ? 0 : 1>(acc, da, db, ks > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      if (ks > 0) {  // the last stage's products are done: release it
        hopper::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(r.empty(prev));
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(r.empty(prev));
    hopper::fence_regs(acc);
  }
};

// Tensor maps of hidden (t, d), row stride sh, and of the head (d, v),
// strides sd, sv: K-major ((V, d) rows of stride sv; sd == 1) or MN-major
// ((d, V) rows of stride sd; sv == 1).  Returns 0, or
// cudaErrorInvalidValue where TMA cannot read them (see `encode_sw128`).
inline int encode_maps(CUtensorMap* th, CUtensorMap* tw, const void* h,
                       long long sh, const void* w, long long sd,
                       long long sv, int t, int d, int v) {
  const cuuint64_t h_dims[2] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(t)};
  const cuuint64_t h_stride[1] = {static_cast<cuuint64_t>(2 * sh)};
  const cuuint32_t h_box[2] = {BK, BT};
  if (!hopper::encode_bf16(th, h, 2, h_dims, h_stride, h_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool kmajor = sd == 1;
  if (!kmajor && sv != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(kmajor ? d : v),
                                static_cast<cuuint64_t>(kmajor ? v : d)};
  const cuuint64_t w_stride[1] = {
      static_cast<cuuint64_t>(2 * (kmajor ? sv : sd))};
  const cuuint32_t w_box[2] = {BK, static_cast<cuuint32_t>(kmajor ? BV : BK)};
  if (!hopper::encode_bf16(tw, w, 2, w_dims, w_stride, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace ce_logits
