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
// with every operand widened to f32 and every sum in f32, as the Pallas
// body does.  For s > t the exponent is replaced by 0 before the exp and
// the product by 0 after it (ssd.py:43): cum_t - cum_s is then positive
// and may overflow, and inf * 0 would be NaN.
//
// Design.  The Pallas kernel holds one chunk per grid step and forms the
// (Q, Q, H) decay tensor in VMEM (1.5 MB at Q 128, H 24), which fits no
// shared memory here.  So one thread block owns one (chunk, head) pair, and
// the grid, BC * H blocks, runs in parallel with no order.  A block of 256
// threads (a 16 x 16 grid; thread (ty, tx)):
//   1. loads the head's x tile (Q x P) as f32 and dt; one thread scans
//      dt * a over the chunk (cum), and dt, cum and w_s = exp(cum_{Q-1} -
//      cum_s) dt_s stay in shared memory;
//   2. forms CB = C B^T (Q x Q) with FMAs, streaming C and B through shared
//      memory in 32-wide slices of N; thread (ty, tx) owns rows ty*8 + i and
//      columns tx + 16j, so the decay mask and dt_s are applied in
//      registers, row by row, and only the masked M = CB * decay * dt goes
//      to shared memory;
//   3. y = M x, each thread 8 rows by P/16 columns; the loop over s stops at
//      the thread's last row, since M is 0 above the diagonal;
//   4. reloads B scaled by w_s into the space M held and forms
//      state = x^T (w B), each thread P/16 rows of P by 8 columns of N.
// Chunks up to Q 128, states up to N 128, head dims P in {16, 32, 64, 128};
// rows past Q and columns past N are zeros in shared memory.  Inputs are
// read through strides (last axis contiguous), so the wrapper passes views
// of the model's conv output without a copy.
//
// The scan is sequential on purpose.  cum falls to about -90 over a chunk
// of 128 at dt ~ 0.7, and each decay factor exp(cum_t - cum_s) carries the
// rounding of two such prefix sums (an ulp of 90 is 7.6e-6) into every
// term of y.  A tree scan, adding in another order than torch.cumsum and
// jnp.cumsum (sequential, each product rounded first), moved y by 2.6e-4
// from the plain version at the mamba2 shape on the card.  The sequential
// scan costs one thread Q dependent adds, a few hundred cycles a block.
//
// Bound on this card (H100 SXM data sheet).  At the mamba2-130m serving
// shape (B 4, L 512 -> BC 16, Q 128, H 24, P 64, N 128, bf16 x/b/c) the
// function must read x, dt, b, c and write y, states and cum in f32: 32.9
// MB, 9.8 us at 3.35 TB/s.  Its products (C B^T once per chunk and M x
// over the causal pairs, x^T (w B) in full) are 1.24 GFLOP: 1.3 us at the
// bf16 tensor-core rate, 19 us as f32 FMAs at 67 TFLOP/s.  So memory bounds
// the function, and f32 FMAs bound this kernel: it recomputes C B^T for
// every head (1.6 GFLOP of its 2.8) and runs every product on the FMA
// units.  Tensor cores for C B^T (exact from bf16 operands) and a block per
// chunk that shares C B^T over its heads are later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QMAX = 128;      // longest chunk
constexpr int NMAX = 128;      // largest state dim
constexpr int THREADS = 256;   // a 16 x 16 grid
constexpr int KT = 32;         // N-slice of the C B^T product
constexpr int KS = KT + 1;     // row stride of the C and B slices
constexpr int MS = QMAX + 1;   // row stride of M
static_assert(2 * QMAX * KS <= QMAX * MS, "C and B slices fit in M's space");
static_assert(QMAX * NMAX <= QMAX * MS, "w-scaled B fits in M's space");

struct Strides {  // element strides; the last axis of each is contiguous
  long long x_bc, x_q, x_h, dt_bc, dt_q, b_bc, b_q, c_bc, c_q;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int P>
constexpr size_t smem_bytes() {
  // M (also the C/B slices and w-scaled B), x tile, cum, dt, w
  return sizeof(float) * (QMAX * MS + QMAX * P + 3 * QMAX);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_intra_chunk_kernel(const T* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const T* __restrict__ b, const T* __restrict__ c,
                           float* __restrict__ y, float* __restrict__ states,
                           float* __restrict__ cum, int Q, int H, int N,
                           Strides st) {
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

  const T* xb = x + bc * st.x_bc + h * st.x_h;
  const float* dtb = dt + bc * st.dt_bc + h;
  const T* bb = b + bc * st.b_bc;
  const T* cb = c + bc * st.c_bc;

  // 1. cum = cumsum(dt * a) by one thread, in sequence and with the
  //    product rounded before the sum: the order of torch.cumsum and
  //    jnp.cumsum, so cum agrees with them to the bit (see the header)
  for (int t = tid; t < QMAX; t += THREADS)
    dt_s[t] = t < Q ? dtb[t * st.dt_q] : 0.f;
  for (int i = tid; i < QMAX * P; i += THREADS) {
    const int t = i / P, p = i % P;
    Xs[i] = t < Q ? to_f32(xb[t * st.x_q + p]) : 0.f;
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
      Cs[r * KS + k] = ok ? to_f32(cb[r * st.c_q + k0 + k]) : 0.f;
      Bs[r * KS + k] = ok ? to_f32(bb[r * st.b_q + k0 + k]) : 0.f;
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
    Bw[i] = n < N ? w_s[s] * to_f32(bb[s * st.b_q + n]) : 0.f;
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

template <typename T, int P>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, float* y, float* states, float* cum, int bc, int q,
           int h, int n, const Strides& st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P>();
  auto kernel = ssd_intra_chunk_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)bc * h), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), y, states, cum, q, h, n, st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int p, const void* x, const float* dt, const float* a,
             const void* b, const void* c, float* y, float* states,
             float* cum, int bc, int q, int h, int n, const Strides& st,
             cudaStream_t stream) {
  switch (p) {
    case 16:
      return launch<T, 16>(x, dt, a, b, c, y, states, cum, bc, q, h, n, st,
                           stream);
    case 32:
      return launch<T, 32>(x, dt, a, b, c, y, states, cum, bc, q, h, n, st,
                           stream);
    case 64:
      return launch<T, 64>(x, dt, a, b, c, y, states, cum, bc, q, h, n, st,
                           stream);
    case 128:
      return launch<T, 128>(x, dt, a, b, c, y, states, cum, bc, q, h, n, st,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b and c).  dt and a are float32.
// strides: x (bc, q, h), dt (bc, q), b (bc, q), c (bc, q) in elements.
// y (BC, Q, H, P), states (BC, H, P, N) and cum (BC, Q, H) are contiguous
// f32.  Returns 0 or the CUDA error of the launch.
extern "C" int ssd_intra_chunk_fwd(int dtype, int p, const void* x,
                                   const void* dt, const void* a,
                                   const void* b, const void* c, void* y,
                                   void* states, void* cum, int bc, int q,
                                   int h, int n, const long long* strides,
                                   void* stream) {
  if (q < 1 || q > QMAX || n < 1 || n > NMAX || bc < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  auto s = static_cast<cudaStream_t>(stream);
  auto dtf = static_cast<const float*>(dt);
  auto af = static_cast<const float*>(a);
  auto yf = static_cast<float*>(y);
  auto sf = static_cast<float*>(states);
  auto cf = static_cast<float*>(cum);
  if (dtype == 0)
    return dispatch<float>(p, x, dtf, af, b, c, yf, sf, cf, bc, q, h, n, st,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(p, x, dtf, af, b, c, yf, sf, cf, bc, q, h,
                                   n, st, s);
  return (int)cudaErrorInvalidValue;
}
