// Mamba2 SSD intra-chunk step for Hopper.
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk`
// (src/repro/kernels/ssd_scan/ssd.py:58, `pl.pallas_call` at :67).  It
// computes the same function, per chunk of Q positions and per head h:
//
//   cum[t]     = sum_{s <= t} dt[s] * a                      (f32 scan)
//   y[t, p]    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x[s, p]
//   state[p,n] = sum_s exp(cum_{Q-1} - cum_s) dt_s x[s, p] B[s, n]
//
// with every sum in f32 and f32 outputs, as the Pallas body does.  For
// s > t the exponent is replaced by 0 before the exp and the product by 0
// after it (ssd.py:43): cum_t - cum_s is then positive and may overflow,
// and inf * 0 would be NaN.  Chunks up to Q 128, states up to N 128, head
// dims P in {16, 32, 64, 128}, any BC and H.  Inputs are read through
// strides (last axis contiguous), so the wrapper passes views of the
// model's conv output without a copy.
//
// Bound on this card (H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s bf16).
// The function reads x, dt, b, c once and writes y, states and cum in f32
// once.  mamba2-130m serving (B 4, L 512 -> BC 16, Q 128, H 24, P 64,
// N 128, bf16 x/b/c): 32.9 MB, 9.82 us.  zamba2-1.2b (BC 16, Q 128, H 64,
// P 64, N 64): 68.7 MB, 20.5 us.  Its products (C B^T once per chunk and
// M x over the causal pairs, x^T (w B) in full) are 1.24 GFLOP at the
// mamba2 shape, 1.3 us at the bf16 rate: memory bounds the function.
//
// f32 inputs: `ssd_f32_kernel`, one block of 256 threads (a 16 x 16 grid)
// per (chunk, head), every product on FMAs: it loads x and dt, scans cum,
// forms C B^T in 32-wide slices of N and the masked M in shared memory,
// then y = M x and state = x^T (w B).
//
// bf16 inputs (the serving paths): `ssd_bf16_kernel`, one block of 8
// warps per chunk and group of G heads, every product on tensor cores
// (`mma.sync.m16n8k16`, bf16 in, f32 accumulate).  G is ssd.py's
// `head_group`: the fewest heads that keep BC ceil(H / G) blocks within
// one wave of the card's 132 SMs at one block per SM, at most 8; G 3 at
// the mamba2 shape and G 8 at the zamba2 one (128 blocks each).
//   1. cp.async (16 bytes a thread) brings C and B of the chunk and dt of
//      the G heads (4 bytes a thread) as one group, then x of the first
//      two heads, a group each.  Q and N are padded to 16 with zeros, and
//      rows by 8 bf16, so that ldmatrix meets no bank conflict.  Rows that
//      do not start on 16 bytes (an odd N, an odd offset) are read element
//      by element.
//   2. Thread g scans cum of head g in sequence (below), and w_s.
//   3. C B^T once for the group (exact products, summed in another order
//      than the plain version's): warp w owns row tile rt (w below 4,
//      11 - w above, so that the two warps on one scheduler share 9 of
//      the 36 causal k16 steps) and the columns up to the diagonal.  The
//      tiles go to shared memory (36 KB) in the order each lane reads them
//      back.
//   4. Per head, while the next head's x is in flight (two x buffers):
//      y = M x, M = CB decay dt formed in f32 in registers without branches
//      (the accumulator layout of two n8 tiles is the A layout of a k16
//      step); tiles past the diagonal are skipped.
//   5. state = x^T (w B): x^T by a transposing ldmatrix, w_s B formed in
//      registers; each warp owns one n tile and every wpn-th p tile.
// M and w_s B are f32 and must keep about f32 precision, while x and B are
// exact in bf16.  Each is split into hi = bf16(v), mid = bf16(v - hi) and
// lo = bf16(v - hi - mid) (each difference exact in f32) and the three
// products, lo first, add into one f32 accumulator.  Emulated on the CPU
// (tests/test_torch_ssd_split.py, BC 2, Q 128, H 4, P 64, N 128), the
// largest |error| on y as a share of SSD_TOL's bound is 599 for one bf16
// pass, 0.81 for hi + lo and 0.037 for three parts (0.055 for tf32 hi +
// lo, which costs four bf16 products).  On the card, max |kernel - plain|
// is 7.63e-5 (y_intra) and 3.81e-6 (states) at the mamba2 shape and
// 6.10e-5 and 3.81e-6 at the zamba2 shape, within rtol = atol = 1e-4 at
// all ten cases of chip_smoke.py's SSD_CASES.
// ptxas -v: 124, 145, 187 and 205 registers at P 16, 32, 64 and 128, no
// spills.  Shared memory 4 QMAX (pad16(N) + 8) + 12 KB + 36 KB + 4 QMAX
// (P + 8) bytes: 152 KB at the mamba2 shape, 120 KB at the zamba2 one.
//
// Times on an NVIDIA H100 80GB HBM3, 700.00 W (device time by the
// profiler; beside it, on the same card, the bf16 kernel this design
// replaced, one block per (chunk, head) on FMAs like the f32 one):
// 0.0281 ms at the mamba2 shape (2.9x its bound; before 0.1396-0.1398)
// and 0.0536-0.0541 ms at the zamba2 shape (2.6x; before 0.2597-0.2619).
// Back to back, a call reads 0.05-0.10 ms: the wrapper's host work
// outlasts the kernel.
//
// The scan is sequential on purpose.  cum falls to about -90 over a chunk
// of 128 at dt ~ 0.7, and each decay factor exp(cum_t - cum_s) carries the
// rounding of two such prefix sums (an ulp of 90 is 7.6e-6) into every
// term of y.  A tree scan, adding in another order than torch.cumsum and
// jnp.cumsum (sequential, each product rounded first), moved y by 2.6e-4
// from the plain version at the mamba2 shape on the card.  The sequential
// scan costs one thread Q dependent adds, a few hundred cycles a block.
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: a block per (chunk, head), FMAs
// ---------------------------------------------------------------------------

constexpr int QMAX = 128;      // longest chunk
constexpr int NMAX = 128;      // largest state dim
constexpr int THREADS = 256;   // f32: a 16 x 16 grid; bf16: 8 warps
constexpr int KT = 32;         // N-slice of the C B^T product
constexpr int KS = KT + 1;     // row stride of the C and B slices
constexpr int MS = QMAX + 1;   // row stride of M
static_assert(2 * QMAX * KS <= QMAX * MS, "C and B slices fit in M's space");
static_assert(QMAX * NMAX <= QMAX * MS, "w-scaled B fits in M's space");

struct Strides {  // element strides; the last axis of each is contiguous
  long long x_bc, x_q, x_h, dt_bc, dt_q, b_bc, b_q, c_bc, c_q;
};

template <int P>
constexpr size_t f32_smem_bytes() {
  // M (also the C/B slices and w-scaled B), x tile, cum, dt, w
  return sizeof(float) * (QMAX * MS + QMAX * P + 3 * QMAX);
}

template <int P>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c, float* __restrict__ y,
                   float* __restrict__ states, float* __restrict__ cum, int Q,
                   int H, int N, Strides st) {
  static_assert(P % 16 == 0 && P <= 128, "head dim in {16, 32, 64, 128}");
  constexpr int JP = P / 16;

  extern __shared__ float smem[];
  float* Ms = smem;                 // [QMAX][MS]
  float* Xs = Ms + QMAX * MS;       // [QMAX][P]
  float* cum_s = Xs + QMAX * P;     // [QMAX]
  float* dt_s = cum_s + QMAX;       // [QMAX]
  float* w_s = dt_s + QMAX;         // [QMAX]

  const int h = blockIdx.x % H;
  const long long bc = blockIdx.x / H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* xb = x + bc * st.x_bc + h * st.x_h;
  const float* dtb = dt + bc * st.dt_bc + h;
  const float* bb = b + bc * st.b_bc;
  const float* cb = c + bc * st.c_bc;

  // 1. cum = cumsum(dt * a) by one thread, in sequence and with the
  //    product rounded before the sum: the order of torch.cumsum and
  //    jnp.cumsum, so cum agrees with them to the bit (see the header)
  for (int t = tid; t < QMAX; t += THREADS)
    dt_s[t] = t < Q ? dtb[t * st.dt_q] : 0.f;
  for (int i = tid; i < QMAX * P; i += THREADS) {
    const int t = i / P, p = i % P;
    Xs[i] = t < Q ? xb[t * st.x_q + p] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    const float ah = a[h];
    float v = 0.f;
    for (int t = 0; t < QMAX; ++t) {
      v = __fadd_rn(v, __fmul_rn(dt_s[t], ah));
      cum_s[t] = v;
    }
  }
  __syncthreads();
  if (tid < Q) {
    w_s[tid] = expf(cum_s[Q - 1] - cum_s[tid]) * dt_s[tid];
    cum[(bc * Q + tid) * H + h] = cum_s[tid];
  }

  // 2. CB = C B^T over N-slices; then M = CB * decay * dt, masked
  float* Cs = Ms;               // [QMAX][KS]
  float* Bs = Ms + QMAX * KS;   // [QMAX][KS]
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < N; k0 += KT) {
    for (int i = tid; i < QMAX * KT; i += THREADS) {
      const int r = i / KT, k = i % KT;
      const bool ok = r < Q && k0 + k < N;
      Cs[r * KS + k] = ok ? cb[r * st.c_q + k0 + k] : 0.f;
      Bs[r * KS + k] = ok ? bb[r * st.b_q + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      float cr[8], br[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) cr[i] = Cs[(ty * 8 + i) * KS + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) br[j] = Bs[(tx + 16 * j) * KS + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = tx + 16 * j;
      const bool keep = s <= t && t < Q;
      const float decay = expf(keep ? cum_s[t] - cum_s[s] : 0.f);
      Ms[t * MS + s] = keep ? acc[i][j] * decay * dt_s[s] : 0.f;
    }
  }
  __syncthreads();

  // 3. y = M x; M is 0 past each row's diagonal
  {
    float yacc[8][JP];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < JP; ++j) yacc[i][j] = 0.f;
    const int smax = min(Q, ty * 8 + 8);
    for (int s = 0; s < smax; ++s) {
      float xr[JP];
#pragma unroll
      for (int j = 0; j < JP; ++j) xr[j] = Xs[s * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float m = Ms[(ty * 8 + i) * MS + s];
#pragma unroll
        for (int j = 0; j < JP; ++j) yacc[i][j] = fmaf(m, xr[j], yacc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty * 8 + i;
      if (t < Q) {
        float* yr = y + ((bc * Q + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < JP; ++j) yr[tx + 16 * j] = yacc[i][j];
      }
    }
  }
  __syncthreads();

  // 4. state = x^T (w B): B scaled by w_s into M's space
  float* Bw = Ms;  // [QMAX][NMAX]
  for (int i = tid; i < Q * NMAX; i += THREADS) {
    const int s = i / NMAX, n = i % NMAX;
    Bw[i] = n < N ? w_s[s] * bb[s * st.b_q + n] : 0.f;
  }
  __syncthreads();
  float sacc[JP][8];
#pragma unroll
  for (int i = 0; i < JP; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
  for (int s = 0; s < Q; ++s) {
    float xr[JP], br[8];
#pragma unroll
    for (int i = 0; i < JP; ++i) xr[i] = Xs[s * P + ty * JP + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) br[j] = Bw[s * NMAX + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < JP; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[i][j] = fmaf(xr[i], br[j], sacc[i][j]);
  }
  float* sb = states + (bc * H + h) * (long long)P * N;
#pragma unroll
  for (int i = 0; i < JP; ++i) {
    const int p = ty * JP + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (n < N) sb[p * N + n] = sacc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: a block per chunk and group of heads, tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;  // most heads in a group (ssd.py's MAX_GROUP)

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

// n8 accumulator tiles of the causal part of CB: row tile r holds
// 2 (r + 1), from tile r (r + 1) on
constexpr int CB_TILES = (QMAX / 16) * (QMAX / 16 + 1);

template <int P>
size_t bf16_smem_bytes(int n) {
  // C and B, dt, cum and w of each head, CB, two x tiles (rows padded by 8)
  const int ldn = pad16(n) + 8;
  return 2 * QMAX * ldn * sizeof(bf16) + 3 * GMAX * QMAX * sizeof(float) +
         CB_TILES * 128 * sizeof(float) + 2 * QMAX * (P + 8) * sizeof(bf16);
}

// Rows [0, rows) of a (Q x W) bf16 operand whose rows are `stride` apart
// into shared memory rows `ld` apart, zero in rows past Q and columns past
// W up to WP (a multiple of 8).  With `vec` (a 16-byte aligned operand,
// W and the stride multiples of 8) by 16-byte `cp.async`, in flight until
// the caller waits for its group; otherwise element by element.  The
// zeros are plain stores, visible after the next __syncthreads.
__device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          long long stride, int rows, int Q,
                                          int W, int WP, bool vec, int tid) {
  const bf16 zero = __float2bfloat16(0.f);
  if (vec) {
    const int chunks = WP / 8;
    for (int i = tid; i < rows * chunks; i += THREADS) {
      const int r = i / chunks, k = (i % chunks) * 8;
      if (r < Q && k < W)
        hopper::cp_async_16(dst + r * ld + k, src + r * stride + k);
      else
        *reinterpret_cast<uint4*>(dst + r * ld + k) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = tid; i < rows * WP; i += THREADS) {
      const int r = i / WP, k = i % WP;
      dst[r * ld + k] = r < Q && k < W ? src[r * stride + k] : zero;
    }
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// v0 and v1 (f32) as three bf16 pairs whose sum is v0 and v1 to about f32
// precision: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid);
// each difference is exact in f32.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const bf16* __restrict__ b,
                    const bf16* __restrict__ c, float* __restrict__ y,
                    float* __restrict__ states, float* __restrict__ cum,
                    int Q, int H, int N, int G, Strides st, bool vec_x,
                    bool vec_bc) {
  static_assert(P % 16 == 0 && P <= 128, "head dim in {16, 32, 64, 128}");
  constexpr int JP = P / 16, LDX = P + 8;
  const int NP = pad16(N), LDN = NP + 8, QP = pad16(Q), QT = QP / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);            // [QMAX][LDN]
  bf16* Bs = Cs + QMAX * LDN;                               // [QMAX][LDN]
  float* dts = reinterpret_cast<float*>(Bs + QMAX * LDN);  // [GMAX][QMAX]
  float* cums = dts + GMAX * QMAX;                          // [GMAX][QMAX]
  float* ws = cums + GMAX * QMAX;                           // [GMAX][QMAX]
  float* CBs = ws + GMAX * QMAX;  // [CB_TILES][4][32]: fragments by lane
  bf16* Xbuf = reinterpret_cast<bf16*>(CBs + CB_TILES * 128);  // [2][QMAX][LDX]

  const int ngroups = (H + G - 1) / G;
  const long long bc = blockIdx.x / ngroups;
  const int h0 = (blockIdx.x % ngroups) * G;
  const int gh = min(G, H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // the warp's row tile of CB and y: warps w and w + 4 share a scheduler,
  // and tiles w and 7 - w together cover 9 of the 36 causal k16 steps
  const int rt = warp < 4 ? warp : 11 - warp;

  const float* dtb = dt + bc * st.dt_bc + h0;
  // x of head h0 + g into buffer g % 2, as one cp.async group (empty past
  // the last head, so that every thread commits the same groups)
  auto load_x = [&](int g) {
    if (g < gh)
      load_rows(Xbuf + (g & 1) * QMAX * LDX, LDX,
                x + bc * st.x_bc + (h0 + g) * st.x_h, st.x_q, QP, Q, P, P,
                vec_x, tid);
    hopper::cp_async_commit();
  };

  // 1. In flight together: C and B of the chunk (zero past Q and N) and dt
  //    of the group's heads, then x of the first two heads
  load_rows(Cs, LDN, c + bc * st.c_bc, st.c_q, QP, Q, N, NP, vec_bc, tid);
  load_rows(Bs, LDN, b + bc * st.b_bc, st.b_q, QP, Q, N, NP, vec_bc, tid);
  for (int i = tid; i < gh * QMAX; i += THREADS) {
    const int g = i / QMAX, t = i % QMAX;
    if (t < Q)
      hopper::cp_async_4(dts + i, dtb + t * st.dt_q + g);
    else
      dts[i] = 0.f;
  }
  hopper::cp_async_commit();
  load_x(0);
  load_x(1);
  hopper::cp_async_wait<2>();
  __syncthreads();

  // 2. cum = cumsum(dt * a) for each head, thread g scanning head g in
  //    sequence with the product rounded first (see the header); w_s
  if (tid < gh) {
    const float ah = a[h0 + tid];
    float v = 0.f;
    for (int t = 0; t < QMAX; ++t) {
      v = __fadd_rn(v, __fmul_rn(dts[tid * QMAX + t], ah));
      cums[tid * QMAX + t] = v;
    }
  }
  __syncthreads();
  for (int i = tid; i < gh * QMAX; i += THREADS) {
    const int g = i / QMAX, t = i % QMAX;
    const float* cg = cums + g * QMAX;
    ws[i] = t < Q ? expf(cg[Q - 1] - cg[t]) * dts[i] : 0.f;
    if (t < Q) cum[(bc * Q + t) * H + h0 + g] = cg[t];
  }

  // 3. CB = C B^T once for the group: the warp owns rows 16 rt .. 16 rt +
  //    15 and the columns s < 16 (rt + 1) that the causal mask keeps, as
  //    2 (rt + 1) n8 accumulator tiles (cbr[j]: rows gid and gid + 8,
  //    columns 8j + 2 tig and + 1), kept in shared memory in the order
  //    each lane reads them back
  float* cbw = CBs + rt * (rt + 1) * 128 + lane;  // the warp's tiles
  if (rt < QT) {
    float cbr[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cbr[j][e] = 0.f;
    for (int k0 = 0; k0 < NP; k0 += 16) {
      uint32_t af[4];
      hopper::ldsm_x4(af, Cs + (rt * 16 + (lane & 15)) * LDN + k0 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j <= rt) {
          uint32_t bfr[4];
          hopper::ldsm_x4(bfr, Bs + (16 * j + (lane & 7) + (lane >> 4) * 8) *
                                        LDN +
                                   k0 + ((lane >> 3) & 1) * 8);
          hopper::mma_bf16_16816(cbr[2 * j], af, bfr[0], bfr[1]);
          hopper::mma_bf16_16816(cbr[2 * j + 1], af, bfr[2], bfr[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < 2 * (rt + 1))
#pragma unroll
        for (int e = 0; e < 4; ++e) cbw[(j * 4 + e) * 32] = cbr[j][e];
  }

  // the warp's n tile of the state, and its first p tile: wpn warps share
  // an n tile and take every wpn-th p tile (warps past nt16 wpn idle)
  const int nt16 = NP / 16, wpn = WARPS / nt16;
  const int nt = warp % nt16, slot = warp / nt16;
  for (int g = 0; g < gh; ++g) {
    const int h = h0 + g;
    const float* cg = cums + g * QMAX;
    const float* dg = dts + g * QMAX;
    const float* wg = ws + g * QMAX;
    const bf16* Xs = Xbuf + (g & 1) * QMAX * LDX;
    hopper::cp_async_wait<1>();  // this head's x; the next one's in flight
    __syncthreads();

    // 4. y = M x: M = CB * decay * dt formed in registers from the warp's
    //    CB tiles (the accumulator layout of two n8 tiles is the A layout
    //    of one k16 step) and split in three bf16 parts; the k16 steps past
    //    the diagonal are skipped
    if (rt < QT) {
      const int t0 = rt * 16 + gid;
      const float ct[2] = {cg[t0], cg[t0 + 8]};
      float yacc[P / 8][4];
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
      for (int kk = 0; kk <= rt; ++kk) {
        float m[2][4];  // [n8 tile][e]
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t0 + (e >> 1) * 8;
            const int s = kk * 16 + half * 8 + 2 * tig + (e & 1);
            // the masked exponent, then the masked product, as the
            // plain version has them; all unconditional, so that the
            // lanes of the warp do not diverge over s <= t
            const bool keep = s <= t;
            const float decay = expf(keep ? ct[e >> 1] - cg[s] : 0.f);
            const float v =
                cbw[((2 * kk + half) * 4 + e) * 32] * decay * dg[s];
            m[half][e] = keep ? v : 0.f;
          }
        uint32_t am[3][4];  // [hi, mid, lo][a0..a3]
        split3(m[0][0], m[0][1], am[0][0], am[1][0], am[2][0]);
        split3(m[0][2], m[0][3], am[0][1], am[1][1], am[2][1]);
        split3(m[1][0], m[1][1], am[0][2], am[1][2], am[2][2]);
        split3(m[1][2], m[1][3], am[0][3], am[1][3], am[2][3]);
        uint32_t bx[JP][4];  // x: (b0, b1) of n8 tiles 2 np and 2 np + 1
#pragma unroll
        for (int np = 0; np < JP; ++np)
          hopper::ldsm_x4_t(bx[np], Xs + (kk * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * LDX +
                                        np * 16 + (lane >> 4) * 8);
        // lo, then mid, then hi: JP x 2 independent products between
        // two that add into one accumulator
#pragma unroll
        for (int part = 2; part >= 0; --part)
#pragma unroll
          for (int np = 0; np < JP; ++np) {
            hopper::mma_bf16_16816(yacc[2 * np], am[part], bx[np][0],
                                   bx[np][1]);
            hopper::mma_bf16_16816(yacc[2 * np + 1], am[part], bx[np][2],
                                   bx[np][3]);
          }
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int t = t0 + e2 * 8;
        if (t < Q) {
          float* yr = y + ((bc * Q + t) * H + h) * P + 2 * tig;
#pragma unroll
          for (int j = 0; j < P / 8; ++j)
            *reinterpret_cast<float2*>(yr + 8 * j) =
                make_float2(yacc[j][2 * e2], yacc[j][2 * e2 + 1]);
        }
      }
    }

    // 5. state = x^T (w B): x^T exact from a transposing ldmatrix; w_s B
    //    formed in registers and split in three bf16 parts once a k16 step,
    //    for the warp's n tile, and reused over its p tiles
    if (slot < wpn) {
      float sacc[JP][2][4];
#pragma unroll
      for (int i = 0; i < JP; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) sacc[i][e >> 2][e & 3] = 0.f;
      for (int kk = 0; kk < QT; ++kk) {
        const int s0 = kk * 16 + 2 * tig;
        const float wv[4] = {wg[s0], wg[s0 + 1], wg[s0 + 8], wg[s0 + 9]};
        uint32_t bt[4], bw[3][4];  // bw: [hi, mid, lo][b0, b1 of 2 n8 tiles]
        hopper::ldsm_x4_t(bt, Bs + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LDN +
                                  nt * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          __nv_bfloat162 v;
          memcpy(&v, &bt[r], sizeof(v));
          const float2 f = __bfloat1622float2(v);
          const int ks = (r & 1) * 2;  // b0: s0, s0 + 1; b1: s0 + 8, + 9
          split3(f.x * wv[ks], f.y * wv[ks + 1], bw[0][r], bw[1][r],
                 bw[2][r]);
        }
        uint32_t ax[JP][4];  // x^T: A of p tile slot + i wpn
#pragma unroll
        for (int i = 0; i < JP; ++i)
          if (slot + i * wpn < JP)
            hopper::ldsm_x4_t(ax[i], Xs + (kk * 16 + (lane & 7) +
                                           (lane >> 4) * 8) * LDX +
                                         (slot + i * wpn) * 16 +
                                         ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int part = 2; part >= 0; --part)
#pragma unroll
          for (int i = 0; i < JP; ++i)
            if (slot + i * wpn < JP) {
              hopper::mma_bf16_16816(sacc[i][0], ax[i], bw[part][0],
                                     bw[part][1]);
              hopper::mma_bf16_16816(sacc[i][1], ax[i], bw[part][2],
                                     bw[part][3]);
            }
      }
      float* sb = states + (bc * H + h) * (long long)P * N;
#pragma unroll
      for (int i = 0; i < JP; ++i) {
        const int pt = slot + i * wpn;
        if (pt < JP) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int p = pt * 16 + gid + ((e >> 1) & 1) * 8;
            const int n = nt * 16 + (e >> 2) * 8 + 2 * tig + (e & 1);
            if (n < N) sb[p * N + n] = sacc[i][e >> 2][e & 3];
          }
        }
      }
    }
    __syncthreads();
    load_x(g + 2);  // into the buffer this head has finished with
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  float* y;
  float* states;
  float* cum;
  int bc, q, h, n, g;
  Strides st;
};

template <int P>
int launch(int dtype, const Args& r, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr size_t smem = f32_smem_bytes<P>();
    auto kernel = ssd_f32_kernel<P>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)((long long)r.bc * r.h), THREADS, smem, stream>>>(
        static_cast<const float*>(r.x), r.dt, r.a,
        static_cast<const float*>(r.b), static_cast<const float*>(r.c), r.y,
        r.states, r.cum, r.q, r.h, r.n, r.st);
  } else {
    const size_t smem = bf16_smem_bytes<P>(r.n);
    auto kernel = ssd_bf16_kernel<P>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long groups = (r.h + r.g - 1) / r.g;
    // cp.async takes 16-byte aligned rows of whole 16-byte chunks
    auto vec = [](const void* p, long long s0, long long s1) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0 &&
             s1 % 8 == 0;
    };
    const bool vec_x = vec(r.x, r.st.x_bc, r.st.x_q) && r.st.x_h % 8 == 0;
    const bool vec_bc = r.n % 8 == 0 && vec(r.b, r.st.b_bc, r.st.b_q) &&
                        vec(r.c, r.st.c_bc, r.st.c_q);
    kernel<<<(unsigned)(r.bc * groups), THREADS, smem, stream>>>(
        static_cast<const bf16*>(r.x), r.dt, r.a,
        static_cast<const bf16*>(r.b), static_cast<const bf16*>(r.c), r.y,
        r.states, r.cum, r.q, r.h, r.n, r.g, r.st, vec_x, vec_bc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b and c).  dt and a are float32.
// strides: x (bc, q, h), dt (bc, q), b (bc, q), c (bc, q) in elements.
// g: heads a block of the bf16 kernel owns (1..8; ssd.py's head_group);
// the f32 kernel takes one head a block and ignores it.  y (BC, Q, H, P),
// states (BC, H, P, N) and cum (BC, Q, H) are contiguous f32.  Returns 0
// or the CUDA error of the launch.
extern "C" int ssd_intra_chunk_fwd(int dtype, int p, const void* x,
                                   const void* dt, const void* a,
                                   const void* b, const void* c, void* y,
                                   void* states, void* cum, int bc, int q,
                                   int h, int n, int g,
                                   const long long* strides, void* stream) {
  if (q < 1 || q > QMAX || n < 1 || n > NMAX || bc < 1 || h < 1 ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && (g < 1 || g > GMAX)))
    return (int)cudaErrorInvalidValue;
  const Args r{x, static_cast<const float*>(dt), static_cast<const float*>(a),
               b, c, static_cast<float*>(y), static_cast<float*>(states),
               static_cast<float*>(cum), bc, q, h, n, g,
               Strides{strides[0], strides[1], strides[2], strides[3],
                       strides[4], strides[5], strides[6], strides[7],
                       strides[8]}};
  auto s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 16: return launch<16>(dtype, r, s);
    case 32: return launch<32>(dtype, r, s);
    case 64: return launch<64>(dtype, r, s);
    case 128: return launch<128>(dtype, r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
