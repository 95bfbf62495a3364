// stream_cipher: the counter-mode XOR cipher of the storage path's inline
// crypto, over the bytes of a u32 word stream,
//
//   out[i] = in[i] ^ byte (i % 4) of ks(i / 4),   i < n_bytes
//   ks(j)  = fmix32((j + nonce) * 0x9E3779B9 + key)       all mod 2^32
//   fmix32: x ^= x >> 16; x *= 0x85EBCA6B; x ^= x >> 13;
//           x *= 0xC2B2AE35; x ^= x >> 16
//
// Word j is bytes 4j..4j+3, little-endian, so a u32 stream of N words is
// n_bytes = 4N and a u8 stream whose length is not a multiple of 4 reads
// as if zero-padded, with the padding cut off the output: the reference
// wrapper's semantics without its padded copy. Applying it twice restores
// the input. Bit-exact with ref.cipher_torch, ref.cipher_ref and the
// storage path's core/smartnic.py InlineCrypto keystream.
//
// Replaces the TPU kernel repro/kernels/stream_cipher/kernel.py:54
// cipher_tiles, which streamed (1, 2048) u32 tiles through VMEM on a
// parallel grid. Only its meaning carries over: here every thread takes
// 16 bytes (four words, one uint4 load and store) of a grid-stride loop
// with 64-bit indices, UNROLL chunks issued together so that enough loads
// are in flight, and the math is native uint32_t wraparound.
//
// Bound on an H100 SXM: memory. Each byte is read once and written once,
// 2 * n_bytes over 3.35 TB/s: 0.641 ms for 1 GiB, 0.626 us for 1 MiB. The
// keystream is some 12 integer operations a word, 3.2 G for 1 GiB, about
// a fifth of that time at the card's integer rate. On an H100 the 1 GiB
// pass runs at the rate of its loads and stores alone, and a 1 MiB extent
// at a launch's floor plus one load-and-store round trip; a grid of one
// wave with 8 loads in flight a thread and streaming stores was no faster
// (scripts/integrity_ablation.py).
//
// When both pointers are 16-byte aligned the body is uint4 loads and
// stores and the n_bytes % 16 tail one byte a thread; otherwise (a u8 view
// that starts inside a word) every byte is loaded and stored alone. CUDA
// rather than Triton: the port's other kernels build and load through
// kernels/_build.py, and this elementwise pass, which Triton would serve
// as well, does not need a second toolchain.
//
// It launches on the caller's stream, allocates nothing and synchronises
// nothing; stream_cipher returns cudaGetLastError() after the launch.
#include <cstdint>
#include <cuda_runtime.h>

#define CIPHER_THREADS 256
#define CIPHER_UNROLL 4

__device__ __forceinline__ uint32_t keystream(uint64_t j, uint32_t key,
                                              uint32_t nonce) {
  uint32_t x = ((uint32_t)j + nonce) * 0x9E3779B9u + key;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint8_t cipher_byte(uint8_t v, int64_t i,
                                               uint32_t key, uint32_t nonce) {
  return v ^ (uint8_t)(keystream((uint64_t)i >> 2, key, nonce) >>
                       (8 * (i & 3)));
}

template <bool VEC>
__global__ void __launch_bounds__(CIPHER_THREADS)
stream_cipher_kernel(const uint8_t* __restrict__ in,
                     uint8_t* __restrict__ out, int64_t n_bytes,
                     uint32_t key, uint32_t nonce) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  if (!VEC) {
    for (int64_t i = tid; i < n_bytes; i += step)
      out[i] = cipher_byte(in[i], i, key, nonce);
    return;
  }
  const int64_t nchunk = n_bytes / 16;
  const uint4* src = reinterpret_cast<const uint4*>(in);
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (int64_t c0 = tid; c0 < nchunk; c0 += CIPHER_UNROLL * step) {
    uint4 v[CIPHER_UNROLL];
#pragma unroll
    for (int u = 0; u < CIPHER_UNROLL; ++u) {
      const int64_t c = c0 + u * step;
      if (c < nchunk) v[u] = src[c];
    }
#pragma unroll
    for (int u = 0; u < CIPHER_UNROLL; ++u) {
      const int64_t c = c0 + u * step;
      if (c < nchunk) {
        const uint64_t j = (uint64_t)c * 4;
        v[u].x ^= keystream(j, key, nonce);
        v[u].y ^= keystream(j + 1, key, nonce);
        v[u].z ^= keystream(j + 2, key, nonce);
        v[u].w ^= keystream(j + 3, key, nonce);
        dst[c] = v[u];
      }
    }
  }
  const int64_t i = nchunk * 16 + tid;  // the ragged tail, < 16 bytes
  if (i < n_bytes) out[i] = cipher_byte(in[i], i, key, nonce);
}

extern "C" int stream_cipher(const void* in, void* out, int64_t n_bytes,
                             uint32_t key, uint32_t nonce, void* stream) {
  if (n_bytes < 1) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int64_t items = vec ? (n_bytes + 15) / 16 : n_bytes;
  int64_t blocks = (items + CIPHER_THREADS - 1) / CIPHER_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    stream_cipher_kernel<true><<<(unsigned)blocks, CIPHER_THREADS, 0, st>>>(
        (const uint8_t*)in, (uint8_t*)out, n_bytes, key, nonce);
  else
    stream_cipher_kernel<false><<<(unsigned)blocks, CIPHER_THREADS, 0, st>>>(
        (const uint8_t*)in, (uint8_t*)out, n_bytes, key, nonce);
  return (int)cudaGetLastError();
}
