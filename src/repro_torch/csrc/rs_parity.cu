// rs_matmul: GF(2^8) matrix product for ec(k,p) Reed-Solomon parity.
//
//   out[m, L] = mat[m, s] (x) cells[s, L]   over GF(2^8), polynomial 0x11D
//
// One primitive serves every EC leg: encode (the p x k Cauchy rows),
// delta-parity RMW (Cauchy columns of the touched cells times old^new)
// and decode (inverted survivor rows). m, s <= 11 covers any ec(k,p) up
// to ec(8,3). Bit-exact with ref.gf_matmul_np and ref.gf_matmul_torch.
//
// Replaces the TPU kernel repro/kernels/rs_parity/kernel.py:53
// rs_matmul_tiles. That kernel widened every byte to an i32 lane and
// expanded each coefficient into the 8-step shift/xor form because byte
// tables do not gather on the VPU. Here bytes stay bytes (u8 in, u8 out:
// a quarter of the traffic of the i32 form), and each coefficient becomes
// a 256-byte product table in shared memory, so one byte times one
// coefficient is one shared-memory lookup.
//
// Bound on an H100 SXM: memory. The product reads s rows and writes m
// rows of L bytes, (s+m)*L bytes over 3.35 TB/s; its work is m*s*L table
// lookups and XORs, far below the integer rate. One 1 MiB ec(4,2) stripe
// encode (s=4, m=2, L=256 KiB) moves 1.5 MiB: about 0.47 us. That is far
// below the launch and the host<->device copies each 1 MiB block pays on
// the storage path today; batching stripes per launch is later work.
//
// Design (simple and right first):
//  * the coefficients ride by value in the kernel-argument struct (<= 121
//    bytes), so a call costs no host-to-device copy for them;
//  * each block builds the m*s product tables (<= 31 KiB) in dynamic
//    shared memory, then walks 16-byte column chunks with a grid-stride
//    loop: a thread loads 16 bytes of each of the s rows at one column and
//    XORs looked-up products into m 16-byte accumulators held in registers;
//  * when both pointers are 16-byte aligned and L is a multiple of 16 the
//    loads and stores are uint4; otherwise (the delta path's sub-cell
//    windows, a view into the middle of a buffer) every byte is loaded and
//    stored alone, with the ragged tail masked.
// It launches on the caller's stream, allocates nothing and synchronises
// nothing; rs_matmul returns cudaGetLastError() after the launch.
#include <cstdint>
#include <cuda_runtime.h>

#define RS_MAX 11

struct RsArgs {
  uint8_t mat[RS_MAX * RS_MAX];  // row-major (m, s)
  int m;
  int s;
};

__device__ __forceinline__ uint32_t gf_mul_byte(uint32_t c, uint32_t v) {
  uint32_t prod = 0;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    prod ^= ((c >> bit) & 1u) * v;
    v = ((v << 1) & 0xFFu) ^ (((v >> 7) & 1u) * 0x1Du);
  }
  return prod;
}

__device__ __forceinline__ uint32_t lookup4(const uint8_t* t, uint32_t x) {
  return (uint32_t)t[x & 0xFFu] | ((uint32_t)t[(x >> 8) & 0xFFu] << 8) |
         ((uint32_t)t[(x >> 16) & 0xFFu] << 16) |
         ((uint32_t)t[x >> 24] << 24);
}

template <bool VEC>
__global__ void __launch_bounds__(256)
rs_matmul_kernel(RsArgs a, const uint8_t* __restrict__ in,
                 uint8_t* __restrict__ out, int64_t L) {
  extern __shared__ uint8_t tab[];  // (m*s, 256): tab[(j*s+i)*256 + v]
  const int m = a.m, s = a.s;
  for (int e = threadIdx.x; e < m * s * 256; e += blockDim.x)
    tab[e] = (uint8_t)gf_mul_byte(a.mat[e >> 8], (uint32_t)(e & 0xFF));
  __syncthreads();

  const int64_t nchunk = (L + 15) / 16;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       c < nchunk; c += step) {
    const int64_t col = c * 16;
    uint32_t acc[RS_MAX][4];
#pragma unroll
    for (int j = 0; j < RS_MAX; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0u;

    for (int i = 0; i < s; ++i) {
      const uint8_t* row = in + (int64_t)i * L + col;
      uint32_t w[4];
      if (VEC) {
        const uint4 v = *reinterpret_cast<const uint4*>(row);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = 0u;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (col + b < L) w[b >> 2] |= (uint32_t)row[b] << (8 * (b & 3));
      }
#pragma unroll
      for (int j = 0; j < RS_MAX; ++j) {
        if (j < m) {
          const uint8_t* t = tab + (j * s + i) * 256;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] ^= lookup4(t, w[q]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < RS_MAX; ++j) {
      if (j < m) {
        uint8_t* dst = out + (int64_t)j * L + col;
        if (VEC) {
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        } else {
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (col + b < L)
              dst[b] = (uint8_t)(acc[j][b >> 2] >> (8 * (b & 3)));
        }
      }
    }
  }
}

extern "C" int rs_matmul(const uint8_t* mat, int m, int s, const void* in,
                         void* out, int64_t L, void* stream) {
  if (m < 1 || s < 1 || m > RS_MAX || s > RS_MAX || L < 1)
    return (int)cudaErrorInvalidValue;
  RsArgs a;
  for (int e = 0; e < RS_MAX * RS_MAX; ++e) a.mat[e] = e < m * s ? mat[e] : 0;
  a.m = m;
  a.s = s;
  const int threads = 256;
  const int64_t nchunk = (L + 15) / 16;
  int64_t blocks = (nchunk + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;  // grid-stride beyond 8 per SM
  const size_t smem = (size_t)m * s * 256;
  const bool vec = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   (L % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    rs_matmul_kernel<true><<<(unsigned)blocks, threads, smem, st>>>(
        a, (const uint8_t*)in, (uint8_t*)out, L);
  else
    rs_matmul_kernel<false><<<(unsigned)blocks, threads, smem, st>>>(
        a, (const uint8_t*)in, (uint8_t*)out, L);
  return (int)cudaGetLastError();
}
