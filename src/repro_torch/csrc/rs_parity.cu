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
// tables do not gather on the VPU. Here bytes stay bytes (u8 in, u8 out).
//
// Bound on an H100 SXM: memory. The product reads s rows and writes m
// rows of L bytes, (s+m)*L bytes over 3.35 TB/s. One 1 MiB ec(4,2) stripe
// encode (s=4, m=2, L=256 KiB) moves 1.5 MiB: about 0.47 us, far below
// the floor of one launch (PERF.md has both). So at the path's shape the
// kernel is bound by its launch and by how fast one wave of CTAs reaches
// the data; the design gets out of the way of both:
//  * No table build, no barrier. Multiplication by a constant c is linear
//    over GF(2), so c*v = lo_c[v & 15] ^ hi_c[v >> 4]: two 16-entry tables
//    a coefficient, 8 words (32 B), at most 121 x 32 = 3,872 B for an
//    11 x 11 matrix. The wrapper computes them on the host
//    (kernel.py nibble_tables) and they ride by value in the argument
//    struct, that is in the constant bank: every lane of a warp reads the
//    same word, and the fully unrolled loops make each offset a constant.
//  * A lookup touches no memory: a 16-entry table is two 8-byte halves,
//    and PTX prmt picks one byte of eight for each of a word's four bytes
//    (selector = the nibble's low 3 bits), so one prmt looks up four bytes
//    in one half; the nibble's bit 3 picks the half (a byte mask that prmt
//    makes in its sign-replicating mode). A word times a coefficient is 4
//    prmt and 3 logic ops. (The old design's byte tables in shared memory
//    took a barrier and colliding byte-wide lookups.)
//  * Each thread owns one 4-byte column of every row, neighbouring threads
//    neighbouring words, so a 1 MiB stripe's 65,536 columns are 256 CTAs:
//    every SM of the 132 takes one or two, and each thread has its s loads
//    in flight at once. It loads the s words, splits each into selectors
//    and masks, then walks the m output rows with them held in registers.
//  * The kernel is a template on s (1..11, picked at launch), so an output
//    row's lookups hold no branch and its 8*s table words are fetched
//    from the constant bank together. A CTA's first touch of each word
//    misses the constant cache; with a branch around every coefficient
//    those misses came one after another: about 0.7 us of a one-CTA call
//    on an H100 (scripts/rs_rglru_ablation.py, rs_branchy). m (at most 3
//    on every EC leg up to ec(8,3)) stays a runtime loop.
//  * When both pointers are 4-byte aligned and L is a multiple of 4 the
//    loads and stores are words; otherwise (the delta path's sub-cell
//    windows, a view into the middle of a buffer) every byte is loaded and
//    stored alone, with the ragged tail masked.
// No global or static device state: concurrent launches from the storage
// threads share nothing. It launches on the caller's stream, allocates
// nothing and synchronises nothing; rs_matmul returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#define RS_MAX 11
#define RS_WORDS 8     // a coefficient's tables: lo[0..15], hi[0..15] bytes
#define RS_THREADS 256

struct RsArgs {
  uint32_t tab[RS_MAX][RS_MAX][RS_WORDS];  // [j][i]: entry e in byte e % 4
  int m;                                   // of word e / 4; hi from word 4
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// One input word's four bytes split for the lookups: prmt selectors of the
// low and high nibbles' low 3 bits (one nibble a byte, in c[15:0]) and
// byte masks of their bit 3.
struct Split {
  uint32_t sel_lo, sel_hi, mask_lo, mask_hi;
};

__device__ __forceinline__ Split split(uint32_t x) {
  // byte 0 of lo3 holds the low 3 bits of bytes 0 and 1's low nibbles,
  // byte 2 those of bytes 2 and 3; prmt(.., 0x4420) packs bytes 0 and 2.
  const uint32_t lo3 = (x & 0x07070707u) | ((x >> 4) & 0x70707070u);
  const uint32_t hi3 = ((x >> 4) & 0x07070707u) | ((x >> 8) & 0x70707070u);
  Split p;
  p.sel_lo = prmt(lo3, 0u, 0x4420u);
  p.sel_hi = prmt(hi3, 0u, 0x4420u);
  // selector 8+k replicates the top bit of byte k over the result byte
  p.mask_lo = prmt(x << 4, 0u, 0xBA98u);
  p.mask_hi = prmt(x, 0u, 0xBA98u);
  return p;
}

// Four nibbles looked up in one 16-entry table t0..t3 (entries 0-7 in t0,
// t1; 8-15 in t2, t3). The words come by value so that no address of the
// argument struct is taken (which would copy it to local memory).
__device__ __forceinline__ uint32_t nib16(uint32_t t0, uint32_t t1,
                                          uint32_t t2, uint32_t t3,
                                          uint32_t sel, uint32_t mask) {
  return (prmt(t0, t1, sel) & ~mask) | (prmt(t2, t3, sel) & mask);
}

template <bool VEC, int S>
__global__ void __launch_bounds__(RS_THREADS)
rs_matmul_prmt_kernel(RsArgs a, const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out, int64_t L) {
  const int m = a.m;
  const int64_t nword = (L + 3) / 4;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       w < nword; w += step) {
    const int64_t col = w * 4;
    uint32_t x[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const uint8_t* row = in + (int64_t)i * L + col;
      if (VEC) {
        x[i] = __ldg(reinterpret_cast<const uint32_t*>(row));
      } else {
        x[i] = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (col + b < L) x[i] |= (uint32_t)row[b] << (8 * b);
      }
    }
    Split p[S];
#pragma unroll
    for (int i = 0; i < S; ++i) p[i] = split(x[i]);

#pragma unroll
    for (int j = 0; j < RS_MAX; ++j) {
      if (j < m) {
        uint32_t acc = 0u;
#pragma unroll
        for (int i = 0; i < S; ++i)
          acc ^= nib16(a.tab[j][i][0], a.tab[j][i][1], a.tab[j][i][2],
                       a.tab[j][i][3], p[i].sel_lo, p[i].mask_lo) ^
                 nib16(a.tab[j][i][4], a.tab[j][i][5], a.tab[j][i][6],
                       a.tab[j][i][7], p[i].sel_hi, p[i].mask_hi);
        uint8_t* dst = out + (int64_t)j * L + col;
        if (VEC) {
          *reinterpret_cast<uint32_t*>(dst) = acc;
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (col + b < L) dst[b] = (uint8_t)(acc >> (8 * b));
        }
      }
    }
  }
}

// The kernel for s = S input rows, or the next S up.
template <int S>
int launch(int s, bool vec, unsigned blocks, cudaStream_t st,
           const RsArgs& a, const uint8_t* in, uint8_t* out, int64_t L) {
  if constexpr (S > RS_MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (s != S) return launch<S + 1>(s, vec, blocks, st, a, in, out, L);
    if (vec)
      rs_matmul_prmt_kernel<true, S><<<blocks, RS_THREADS, 0, st>>>(
          a, in, out, L);
    else
      rs_matmul_prmt_kernel<false, S><<<blocks, RS_THREADS, 0, st>>>(
          a, in, out, L);
    return (int)cudaGetLastError();
  }
}

// tabs: (m, s, RS_WORDS) u32 on the host, row-major, from nibble_tables.
extern "C" int rs_matmul(const uint32_t* tabs, int m, int s, const void* in,
                         void* out, int64_t L, void* stream) {
  if (m < 1 || s < 1 || m > RS_MAX || s > RS_MAX || L < 1)
    return (int)cudaErrorInvalidValue;
  RsArgs a;
  for (int j = 0; j < RS_MAX; ++j)
    for (int i = 0; i < RS_MAX; ++i)
      for (int e = 0; e < RS_WORDS; ++e)
        a.tab[j][i][e] =
            (j < m && i < s) ? tabs[(j * s + i) * RS_WORDS + e] : 0u;
  a.m = m;
  const int64_t nword = (L + 3) / 4;
  int64_t blocks = (nword + RS_THREADS - 1) / RS_THREADS;
  if (blocks > 132 * 8) blocks = 132 * 8;  // grid-stride beyond 8 per SM
  const bool vec = ((uintptr_t)in % 4 == 0) && ((uintptr_t)out % 4 == 0) &&
                   (L % 4 == 0);
  return launch<1>(s, vec, (unsigned)blocks, (cudaStream_t)stream, a,
                   (const uint8_t*)in, (uint8_t*)out, L);
}
