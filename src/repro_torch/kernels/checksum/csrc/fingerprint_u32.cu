// Content fingerprint of a buffer of 32-bit words, for Hopper.
//
// Replaces the Pallas TPU kernel `fingerprint_u32`
// (src/repro/kernels/checksum/fingerprint.py:55, `pl.pallas_call` at :60).
// It computes the same function: over the words x[i] of the buffer, padded
// with zero words to a multiple of 256 x 128, with pos = i mod 2^32 and
// w = pos * P1 + P2, the four lanes
//   l0 = sum x * w
//   l1 = sum (x ^ P3) * (w ^ P4)
//   l2 = sum (x * x + P4) * w
//   l3 = sum (x + pos) * (pos * P3 + P1)
// all in uint32 arithmetic that wraps (fingerprint.py:34-51).  Addition
// mod 2^32 is associative and commutative, so any order of the sums, the
// atomics' included, gives the same bits: the kernel equals the plain
// version (ref.py) bit for bit.
//
// Design.  The TPU kernel gives each 256 x 128 block one grid step that
// writes a partial digest, and sums the partials outside.  Here each
// thread walks the buffer with a grid-stride loop over groups of four
// words, one 16-byte load per group (scalar loads where the buffer is not
// 16-byte aligned, and at the ragged end), and keeps the four lane sums in
// registers.  The block sums its threads' lanes with warp shuffles and
// shared memory, and one thread adds them to the four output words with
// `atomicAdd`.  The padding is not free: a zero word still adds to l1, l2
// and l3.  The loop runs to the padded length and takes x = 0 past the
// end, so the buffer is read in place, never copied to a padded one.
//
// Bound on this card (H100 SXM).  The function reads 4 bytes per word: at
// olmo-1b's largest leaf, 1 GiB of f32, 0.32 ms at 3.35 TB/s.  Per word
// it issues about ten 32-bit integer instructions (five multiply-adds for
// w, l0, l1, l2 and l3's product, one more for pos * P3 + P1, one for x * x
// + P4, two xors and one add); 32-bit integer multiply-add runs at 64 per
// clock per SM, 16.7 T/s over 132 SMs at 1.98 GHz, so ten instructions per
// word cost 0.16 ms per GiB: the bytes bound it, with about half the
// integer rate to spare, if enough loads are in flight.  With 256 threads
// a block and up to 8 blocks an SM, each thread holds one 16-byte load in
// flight, 32 KB an SM.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned P1 = 2654435761u;  // Knuth multiplicative
constexpr unsigned P2 = 0x9E3779B9u;  // golden ratio
constexpr unsigned P3 = 0x85EBCA6Bu;  // murmur3 c1
constexpr unsigned P4 = 0xC2B2AE35u;  // murmur3 c2
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

struct Lanes {
  unsigned l0, l1, l2, l3;
};

__device__ __forceinline__ void add_word(Lanes& s, unsigned x, unsigned pos) {
  const unsigned w = pos * P1 + P2;
  s.l0 += x * w;
  s.l1 += (x ^ P3) * (w ^ P4);
  s.l2 += (x * x + P4) * w;
  s.l3 += (x + pos) * (pos * P3 + P1);
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// words: n valid words; the digest covers n_pad >= n words (a multiple of
// 4), the last n_pad - n of them zero.  aligned: words is 16-byte aligned.
// out: four words, zeroed before the launch.
__global__ void __launch_bounds__(THREADS)
    fingerprint_u32_kernel(const unsigned* __restrict__ words, long long n,
                           long long n_pad, int aligned,
                           unsigned* __restrict__ out) {
  Lanes s{0u, 0u, 0u, 0u};
  const long long groups = n_pad / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
       g < groups; g += stride) {
    const long long i = 4 * g;
    unsigned x[4];
    if (aligned && i + 4 <= n) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(words) + g);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = i + k < n ? __ldg(words + i + k) : 0u;
    }
    const unsigned pos = (unsigned)i;  // the global word index mod 2^32
#pragma unroll
    for (int k = 0; k < 4; ++k) add_word(s, x[k], pos + (unsigned)k);
  }

  __shared__ unsigned part[THREADS / 32][4];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  s.l0 = warp_sum(s.l0);
  s.l1 = warp_sum(s.l1);
  s.l2 = warp_sum(s.l2);
  s.l3 = warp_sum(s.l3);
  if (lane == 0) {
    part[warp][0] = s.l0;
    part[warp][1] = s.l1;
    part[warp][2] = s.l2;
    part[warp][3] = s.l3;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned t = 0u;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) t += part[k][threadIdx.x];
    atomicAdd(out + threadIdx.x, t);
  }
}

}  // namespace

// words: n 32-bit words on the card; n_pad: the padded length the digest
// covers, a multiple of 4, n <= n_pad.  out: four 32-bit words on the card,
// zeroed here on the stream before the launch.  sms: the card's SM count.
// Returns 0 or the CUDA error of the memset or the launch.
extern "C" int fingerprint_u32_fwd(const void* words, long long n,
                                   long long n_pad, void* out, int sms,
                                   void* stream) {
  if (n < 0 || n_pad < n || n_pad % 4 || n_pad == 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, 4 * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const long long groups = n_pad / 4;
  const long long want = (groups + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  const int aligned = (reinterpret_cast<uintptr_t>(words) % 16) == 0;
  fingerprint_u32_kernel<<<blocks, THREADS, 0, st>>>(
      static_cast<const unsigned*>(words), n, n_pad, aligned,
      static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}
