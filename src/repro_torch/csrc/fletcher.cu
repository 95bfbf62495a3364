// fletcher: the wide Fletcher checksum of the storage engine's extents,
// over the N = ceil(n_bytes / 4) little-endian u32 words of a byte stream
// (the last word zero-padded),
//
//   s1 = sum_i w_i              mod 2^32
//   s2 = sum_i (N - i) * w_i    mod 2^32          out += [s1, s2]
//
// so a u32 stream, a u8 stream and any dtype's bytes in memory order are
// all one call, without the reference wrapper's padded copy. Bit-exact
// with ref.fletcher_torch, ref.fletcher_ref and the engine's
// core/media.py fletcher64.
//
// Replaces the TPU kernel repro/kernels/fletcher/kernel.py:56
// fletcher_tiles. That kernel walked (1, 2048) tiles along a sequential
// ("arbitrary") grid axis, carrying [s1, s2] in VMEM scratch. Blocks here
// run in parallel and in no order, so nothing is carried: each thread
// sums its own words of a grid-stride loop (16 bytes, one uint4 load, at
// a time, UNROLL loads issued together) into uint32_t s1 and s2 with the
// weight (uint32_t)(N - i) of a 64-bit i; a warp folds by shuffles, warp 0
// folds the CTA's warps, and one thread a CTA adds the CTA's two sums into
// out with atomicAdd. Addition mod 2^32 is associative and commutative,
// so the result is exact whatever order the folds and atomics take.
//
// Bound on an H100 SXM: memory. Each byte is read once and 8 bytes are
// written, n_bytes + 8 over 3.35 TB/s: 0.320 ms for 1 GiB, 0.313 us for
// 1 MiB. Its work is an add, a subtract and a multiply-add a word, far
// below the card's integer rate.
//
// The engine checksums 1 MiB extents, where a call is a launch's floor
// plus one round trip to HBM, not bandwidth, and each device operation
// counts. So a call is one kernel and nothing else: out must hold zeros
// when the kernel starts, and the caller hands it a zeroed pair (the
// wrapper takes each call's pair from a pool it zeroes once for many
// calls) instead of a memset a call. The grid spreads a 1 MiB extent over
// 128 SMs, two uint4 loads a thread issued together, and is at most 8 CTAs
// of 256 threads an SM (grid-stride beyond), where a 1 GiB stream streams
// at HBM rate. An
// atomic-free fold was slower at 1 MiB on an H100: one thread-block
// cluster folding in distributed shared memory loads from 16 SMs at most,
// and a cooperative launch pays a grid-wide sync
// (scripts/integrity_ablation.py times both).
//
// When the start is 16-byte aligned the body is uint4 loads and the
// n_bytes % 16 tail one word a thread; otherwise (a u8 view that starts
// inside a word) each word is put together from its bytes. CUDA rather
// than Triton, as for stream_cipher.cu: one toolchain for all kernels.
//
// It launches on the caller's stream, allocates nothing and synchronises
// nothing; fletcher returns cudaGetLastError() after the launch.
#include <cstdint>
#include <cuda_runtime.h>

#define FLETCHER_THREADS 256  // threads a CTA
#define FLETCHER_UNROLL 4     // uint4 loads in flight a thread

// word i of the stream from its bytes, the bytes past the end read as 0
__device__ __forceinline__ uint32_t word_at(const uint8_t* in, int64_t i,
                                            int64_t n_bytes) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int64_t p = 4 * i + b;
    if (p < n_bytes) w |= (uint32_t)in[p] << (8 * b);
  }
  return w;
}

// this thread's s1, s2 over its words of a grid-stride loop of `step`
// threads: chunks tid + (k * UNROLL + u) * step, then the tail's words
template <bool VEC, int UNROLL>
__device__ __forceinline__ void thread_sums(const uint8_t* __restrict__ in,
                                            int64_t n_bytes, int64_t tid,
                                            int64_t step, uint32_t& s1,
                                            uint32_t& s2) {
  const int64_t n_words = (n_bytes + 3) / 4;
  const uint32_t n32 = (uint32_t)n_words;
  int64_t first_tail = 0;  // words from here on are read one at a time
  if (VEC) {
    const int64_t nchunk = n_bytes / 16;
    const uint4* src = reinterpret_cast<const uint4*>(in);
    for (int64_t c0 = tid; c0 < nchunk; c0 += UNROLL * step) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t c = c0 + u * step;
        v[u] = c < nchunk ? src[c] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uint32_t wt = n32 - (uint32_t)((c0 + u * step) * 4);
        s1 += v[u].x + v[u].y + v[u].z + v[u].w;
        s2 += v[u].x * wt + v[u].y * (wt - 1u) + v[u].z * (wt - 2u) +
              v[u].w * (wt - 3u);
      }
    }
    first_tail = nchunk * 4;
  }
  for (int64_t i = first_tail + tid; i < n_words; i += step) {
    const uint32_t w = word_at(in, i, n_bytes);
    s1 += w;
    s2 += w * (n32 - (uint32_t)i);
  }
}

__device__ __forceinline__ void warp_sums(uint32_t& s1, uint32_t& s2) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s1 += __shfl_down_sync(0xFFFFFFFFu, s1, d);
    s2 += __shfl_down_sync(0xFFFFFFFFu, s2, d);
  }
}

// the CTA's s1, s2 in thread 0: each warp by shuffles, then warp 0 over
// the warps' sums in shared memory
template <int THREADS>
__device__ __forceinline__ void cta_sums(uint32_t& s1, uint32_t& s2) {
  __shared__ uint32_t part[2][THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_sums(s1, s2);
  if (lane == 0) {
    part[0][warp] = s1;
    part[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < THREADS / 32 ? part[0][lane] : 0u;
    s2 = lane < THREADS / 32 ? part[1][lane] : 0u;
    warp_sums(s1, s2);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(FLETCHER_THREADS)
fletcher_kernel(const uint8_t* __restrict__ in, int64_t n_bytes,
                uint32_t* __restrict__ out) {
  uint32_t s1 = 0, s2 = 0;
  thread_sums<VEC, FLETCHER_UNROLL>(
      in, n_bytes, (int64_t)blockIdx.x * FLETCHER_THREADS + threadIdx.x,
      (int64_t)gridDim.x * FLETCHER_THREADS, s1, s2);
  cta_sums<FLETCHER_THREADS>(s1, s2);
  if (threadIdx.x == 0) {
    atomicAdd(out, s1);
    atomicAdd(out + 1, s2);
  }
}

// out += [s1, s2] of the n_bytes at in: out holds zeros for the checksum
extern "C" int fletcher(const void* in, int64_t n_bytes, void* out,
                        void* stream) {
  if (n_bytes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = (uintptr_t)in % 16 == 0;
  const int64_t items = vec ? (n_bytes + 15) / 16 : (n_bytes + 3) / 4;
  // two items a thread (128 CTAs at 1 MiB): faster there on an H100 than
  // one over 256 CTAs or four over 64 (scripts/integrity_ablation.py)
  const int64_t per_cta = 2 * FLETCHER_THREADS;
  int64_t blocks = (items + per_cta - 1) / per_cta;
  if (blocks > 132 * 8) blocks = 132 * 8;  // grid-stride beyond 8 per SM
  if (vec)
    fletcher_kernel<true><<<(unsigned)blocks, FLETCHER_THREADS, 0, st>>>(
        (const uint8_t*)in, n_bytes, (uint32_t*)out);
  else
    fletcher_kernel<false><<<(unsigned)blocks, FLETCHER_THREADS, 0, st>>>(
        (const uint8_t*)in, n_bytes, (uint32_t*)out);
  return (int)cudaGetLastError();
}
