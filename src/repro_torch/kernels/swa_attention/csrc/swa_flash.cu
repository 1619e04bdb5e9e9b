// Causal, optionally sliding-window, flash attention forward for Hopper.
//
// Replaces the Pallas TPU kernel `swa_flash`
// (src/repro/kernels/swa_attention/swa.py:89, `pl.pallas_call` at :104).
// It computes the same function: scores in f32, scaled by 1/sqrt(D); key j
// is seen by query i when j <= i and, for window > 0, j > i - window;
// masked scores are -1e30 (not -inf) and the softmax denominator is
// clamped at 1e-30, so a row with no key would come out as 0 and never as
// NaN; m, l and the output accumulator stay in f32.
//
// Design.  The TPU kernel walks kv blocks on a sequential grid axis and
// carries m/l/acc in VMEM scratch between grid steps.  Here blocks run in
// parallel in no order, so one thread block owns one (batch*head, 64-query
// tile) pair and loops over the kv tiles itself: from the first tile that
// holds a key inside the window of the tile's first query, up to the tile
// on the diagonal.  Tiles outside that range are never loaded.  The bounds
// come from positions, not from the 128-block arithmetic of `_steps` and
// `_kv_index`.  The kernel reads (B, S, H, D) through strides, so the
// wrapper makes no (BH, S, D) copy and no pad: the ragged last tile is
// masked here (rows past the sequence are loaded as zeros).  Heavy (late,
// long-causal) query tiles are launched first.
//
// bf16 (the serving path): tensor cores, `mma.sync` m16n8k16 with f32
// accumulation.  Four warps, each owning 16 query rows of the tile.  Q, K
// and V tiles sit in shared memory as bf16, rows padded by 8 elements
// against bank conflicts.  S = Q K^T: bf16 products are exact in f32, so
// only the order of the f32 sums differs from the Pallas kernel, which
// scales q in f32 first and here the f32 score is scaled.  The online
// softmax runs on the accumulator fragments in registers; a row's four
// owners sit in one quad, so row max and sum are two shuffles.  P feeds
// P V straight from registers (the S fragment layout is the A layout).  P
// is f32 and Pallas multiplies it by V in f32; to keep that precision on
// bf16 tensor cores P is split as hi + lo, two bf16 terms, and P V is the
// sum of both products: about 16 bits of P's mantissa (relative error
// below 2^-17).  V's B fragments come from `ldmatrix .trans`.
//
// f32: plain FMAs from shared memory, 256 threads as a 16 x 16 grid; thread
// (ty, tx) owns score rows ty + 16i and columns tx + 16j of the 64 x 64
// tile, and output columns tx + 16j of the same rows.
//
// Bound on this card (H100 SXM data sheet).  At the serving path's shape
// (B 4, S 512, H 16, D 128, bf16, causal) the function must move q, k, v
// and o once: 33.5 MB, 10.0 us at 3.35 TB/s.  Its causal products are
// 4.3 GFLOP, 4.4 us at 989 TFLOP/s (bf16 tensor cores).  So memory bounds
// it.  This kernel loads each K/V tile once per 64-query tile (8x the
// minimal K/V traffic at S 512, mostly from L2), issues its loads and
// products in turn with no overlap (no cp.async/TMA pipeline), and pays
// twice for P V (hi + lo); wgmma, TMA and a pipeline are later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
static_assert(BQ == BKV, "load_tile loads 64-row tiles of q, k and v alike");
constexpr int F32_THREADS = 256;
constexpr int BF16_THREADS = 128;  // 4 warps x 16 query rows
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + D * (BKV + 1) + BKV * D + BQ * (BKV + 1));
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    swa_flash_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int seq, int heads, Strides sq, Strides sk,
                         Strides sv, Strides so, int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int QS = D + 1;    // row stride of Qs
  constexpr int KS = BKV + 1;  // row stride of Kt and Ps
  constexpr int DJ = D / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][D+1]   q * scale
  float* Kt = Qs + BQ * QS;     // [D][BKV+1]  k transposed
  float* Vs = Kt + D * KS;      // [BKV][D]
  float* Ps = Vs + BKV * D;     // [BQ][BKV+1] probabilities

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int e = tid; e < BQ * D; e += F32_THREADS) {
    const int r = e / D, d = e % D, qi = q0 + r;
    Qs[r * QS + d] = qi < seq ? qb[qi * sq.s + d] * scale : 0.f;
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
    for (int e = tid; e < BKV * D; e += F32_THREADS) {
      const int c = e / D, d = e % D, kj = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kj < seq) {
        kx = kb[kj * sk.s + d];
        vx = vb[kj * sv.s + d];
      }
      Kt[d * KS + c] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
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
        const float vv = Vs[c * D + tx + 16 * j];
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
      ob[qi * so.s + tx + 16 * j] = acc[i][j] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * (BQ + 2 * BKV) * (D + 8);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
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

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// row address of matrix l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Rows row0 .. row0+63 of one (b, h) slice into smem [64][D+8]; rows at or
// past `seq` are zeros.  16-byte loads where the rows are 16-byte aligned.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int seq) {
  constexpr int LD = D + 8, CHUNKS = D / 8;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(stride * 2)) &
       15) == 0;
  for (int e = threadIdx.x; e < BKV * CHUNKS; e += BF16_THREADS) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8, row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < seq) {
      const bf16* g = src + row * stride + c;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(g);
      } else {
        __align__(16) bf16 tmp[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) tmp[i] = g[i];
        val = *reinterpret_cast<const uint4*>(tmp);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS)
    swa_flash_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int seq, int heads, Strides sq, Strides sk,
                          Strides sv, Strides so, int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 8;     // smem row stride, elements
  constexpr int KT = D / 16;    // k-steps of Q K^T
  constexpr int NT = BKV / 8;   // n-tiles of S
  constexpr int DT = D / 8;     // n-tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                        // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;                       // [BKV][LD]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row and column pair
  const int r0 = warp * 16;                 // this warp's rows in the tile
  const int qi0 = q0 + r0 + g, qi1 = qi0 + 8;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  bf16* ob = o + b * so.b + h * so.h;

  load_tile<D>(Qs, qb, sq.s, q0, seq);
  __syncthreads();
  uint32_t qf[KT][4];  // A fragments of this warp's 16 query rows
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const bf16* p = Qs + (r0 + g) * LD + kt * 16 + tig * 2;
    qf[kt][0] = lds32(p);
    qf[kt][1] = lds32(p + 8 * LD);
    qf[kt][2] = lds32(p + 8);
    qf[kt][3] = lds32(p + 8 * LD + 8);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int q_last = min(q0 + BQ, seq) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = k_first / BKV; t <= q_last / BKV; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the last tile's Ks/Vs are consumed
    load_tile<D>(Ks, kb, sk.s, k0, seq);
    load_tile<D>(Vs, vb, sv.s, k0, seq);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: element e of s[nt] is row
    // (e < 2 ? g : g + 8), key nt * 8 + tig * 2 + (e & 1)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const bf16* p = Ks + (nt * 8 + g) * LD + kt * 16 + tig * 2;
        mma_bf16(s[nt], qf[kt], lds32(p), lds32(p + 8));
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + nt * 8 + tig * 2 + (e & 1);
        const float x = s[nt][e] * scale;
        s[nt][e] = visible(kj, e < 2 ? qi0 : qi1, seq, window) ? x : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V, 16 keys per step; P = hi + lo in bf16
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A regs: (g, keys 0-7), (g+8, keys 0-7), (g, keys 8-15), (g+8, 8-15)
        const float x0 = s[2 * kk + (i >> 1)][2 * (i & 1)];
        const float x1 = s[2 * kk + (i >> 1)][2 * (i & 1) + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h2);
        hi[i] = as_u32(h2);
        lo[i] = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }
      const int lrow = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int lcol = (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + lrow * LD + dp * 16 + lcol);
        mma_bf16(acc[2 * dp], hi, vf[0], vf[1]);
        mma_bf16(acc[2 * dp], lo, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], hi, vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], lo, vf[2], vf[3]);
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + tig * 2;
    if (qi0 < seq) {
      ob[qi0 * so.s + d] = __float2bfloat16(acc[dt][0] * inv0);
      ob[qi0 * so.s + d + 1] = __float2bfloat16(acc[dt][1] * inv0);
    }
    if (qi1 < seq) {
      ob[qi1 * so.s + d] = __float2bfloat16(acc[dt][2] * inv1);
      ob[qi1 * so.s + d + 1] = __float2bfloat16(acc[dt][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K, typename T>
int launch_kernel(K kernel, int threads, size_t smem, const void* q,
                  const void* k, const void* v, void* o, int batch, int seq,
                  int heads, const long long* st, int window, float scale,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (seq + BQ - 1) / BQ);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, heads,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int batch, int seq, int heads, const long long* st, int window,
           float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_kernel<decltype(&swa_flash_f32_kernel<D>), float>(
        swa_flash_f32_kernel<D>, F32_THREADS, f32_smem_bytes<D>(), q, k, v, o,
        batch, seq, heads, st, window, scale, stream);
  if (dtype == 1)
    return launch_kernel<decltype(&swa_flash_bf16_kernel<D>), bf16>(
        swa_flash_bf16_kernel<D>, BF16_THREADS, bf16_smem_bytes<D>(), q, k, v,
        o, batch, seq, heads, st, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: (batch, seq, heads, head_dim) with a contiguous last axis;
// strides: 12 element strides, the (b, s, h) strides of q, k, v, o in turn.
// dtype: 0 float32, 1 bfloat16; head_dim 32, 64 or 128.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int swa_flash_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, void* o,
                             int batch, int seq, int heads,
                             const long long* strides, int window,
                             float scale, void* stream) {
  if (batch * heads == 0 || seq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(dtype, q, k, v, o, batch, seq, heads, strides, window,
                        scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, batch, seq, heads, strides, window,
                        scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, batch, seq, heads, strides,
                         window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
