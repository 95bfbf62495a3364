// flash_decode: split-KV flash decoding for grouped-query attention, one
// new token a sequence against its bf16 KV cache.
//
//   out[b,0,h,:] = softmax_s(scale * q[b,0,h,:] . k[b,s,kh,:]) @ v[b,:,kh,:]
//                  over s < kv_len[b],   kh = h / G,   G = H / KH
//
// q (B,1,H,D), k and v (B,S,KH,D) bf16, read in place through their strides
// (last dimension contiguous, rows 16-byte aligned); kv_len (B,) int32 on
// the card; out (B,1,H,D) bf16, contiguous. D is 64 or 128, G at most 16.
//
// Replaces no TPU kernel: the reference decodes on its plain jnp path
// (repro/kernels/flash_attention/ops.py:116 sends decode-style offsets
// there, and models/transformer.py's decode passes no impl), and so did the
// port, whose plain path casts the whole reserved cache to float32 and
// copies it through einsum layouts, some 36 bytes moved for each cached
// bf16 element. This kernel reads each live element once.
//
// Bound on an H100 SXM: bytes. A cached position costs 4 D bytes of k and
// v for 4 D G FLOPs, G = 4 to 6 FLOP a byte against the card's ridge of
// about 295, so the design is about keeping bytes in flight:
//  * grid (splits, KH, B): one CTA a (b, kv head, split of the sequence);
//    the wrapper picks the split count from B, KH, S and the SM count, so
//    that few long sequences (B x KH small) fill the card as well as many
//    short ones. 4 warps a CTA; all G query heads of a group share each
//    k and v tile, which is read once for them all.
//  * tiles of 64 positions stream through a ring of NS stages (4 at D =
//    64, 3 at D = 128; 72 and 102 KB, three and two CTAs an SM) by
//    16-byte cp.async, NS - 1 tiles ahead of the one computed. Tiles at or
//    past kv_len[b] are never read, and rows past it within the last tile
//    are zero-filled, not read.
//  * each warp takes 16 positions of a tile. s = q.k^T is mma.sync
//    m16n8k16 (bf16 in, float32 sums of exact products), the G heads as
//    the 16 rows (rows >= G are zero), k from shared memory by ldmatrix;
//    o += p.v the same with v by ldmatrix.trans. Rows of 16 + 2 D bytes
//    keep both conflict-free. Each warp keeps its own running max, sum
//    and accumulator in registers; the CTA merges its four warps in shared
//    memory and writes one float32 partial (m, l, unnormalised o) a head.
//  * flash_decode_combine_kernel merges a (b, kv head)'s splits and writes
//    out in bf16. All scratch comes from the wrapper (torch.empty), so the
//    two launches capture into a CUDA graph.
//
// The arithmetic is the plain path's (models/layers.py attention): q times
// the scale rounded to bf16 (the scale itself rounded to bf16 first), the
// scores and the softmax in float32, masked positions at -1e30 (their
// exp(-1e30 - m) is 0), l summed from the float32 p, p rounded to bf16 for
// p.v only, o / max(l, 1e-30) rounded to bf16. One difference: p is
// rounded at each 16-position slice's running max, not the row's final max,
// and the sums run in another order.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;           // positions a tile
constexpr int NW = 4;            // warps a CTA, 16 positions of a tile each
constexpr int NT = NW * 32;      // threads a CTA
constexpr int GMAX = 16;         // query heads a group: the mma's 16 rows
constexpr int MAX_SPLITS = 32;
constexpr float MASKV = -1e30f;

template <int D>
struct Cfg {
  static constexpr int ROW = 2 * D + 16;   // bytes a staged row
  static constexpr int TILE = BN * ROW;    // one k or v tile
  static constexpr int NS = D == 64 ? 4 : 3;
  static constexpr int SMEM = NS * 2 * TILE;
  // the warps' merge reuses the ring: m, l and o of 16 rows a warp
  static_assert(NW * GMAX * (D + 2) * 4 <= SMEM, "merge scratch");
};

struct DecodeArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* kv_len;
  __nv_bfloat16* out;
  float* part_o;      // (B, KH, splits, G, D)
  float* part_ml;     // (B, KH, splits, G, 2): m, l
  int64_t sqb, sqh, skb, sks, skh, svb, svs, svh;
  int S, H, KH, G, splits, tiles_per_split;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; bytes = 0 fills zeros, reads none
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_decode_split_kernel(const DecodeArgs a) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = lane >> 2;                 // this lane's rows: r0, r0 + 8
  const int G = a.G;
  const int n_valid = min(max(a.kv_len[b], 0), a.S);
  const int t_begin = split * a.tiles_per_split;
  const int n_tiles = min(t_begin + a.tiles_per_split,
                          (n_valid + BN - 1) / BN) - t_begin;

  // q's A fragments: rows r0, r0 + 8, columns 16 kk + 2 (lane % 4) (+ 8),
  // each bf16(q * bf16(scale)); rows >= G are zero
  const float sc = __bfloat162float(__float2bfloat16_rn(a.scale));
  const __nv_bfloat16* qb = a.q + b * a.sqb + (int64_t)kh * G * a.sqh;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1);
      const int col = 16 * kk + 2 * (lane & 3) + 8 * (i >> 1);
      float x0 = 0.f, x1 = 0.f;
      if (row < G) {
        const __nv_bfloat16* p = qb + row * a.sqh + col;
        x0 = __bfloat162float(p[0]) * sc;
        x1 = __bfloat162float(p[1]) * sc;
      }
      qa[kk][i] = pack_bf16(x0, x1);
    }
  }

  const __nv_bfloat16* kb = a.k + b * a.skb + kh * a.skh;
  const __nv_bfloat16* vb = a.v + b * a.svb + kh * a.svh;
  auto load_tile = [&](int tile, int stage) {
    unsigned char* ks = smem + stage * 2 * C::TILE;
    unsigned char* vs = ks + C::TILE;
    constexpr int CPR = D / 8;              // 16-byte chunks a row
#pragma unroll
    for (int j = 0; j < BN * CPR / NT; ++j) {
      const int i = threadIdx.x + j * NT;
      const int r = i / CPR, c = i % CPR;
      const int pos = tile * BN + r;
      const bool live = pos < n_valid;
      const int64_t p = live ? pos : 0;
      cp_async16(smem_addr(ks + r * C::ROW + 16 * c), kb + p * a.sks + 8 * c,
                 live ? 16 : 0);
      cp_async16(smem_addr(vs + r * C::ROW + 16 * c), vb + p * a.svs + 8 * c,
                 live ? 16 : 0);
    }
  };

  float m[2] = {MASKV, MASKV}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

#pragma unroll
  for (int i = 0; i < C::NS - 1; ++i) {
    if (i < n_tiles) load_tile(t_begin + i, i);
    cp_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_wait<C::NS - 2>();
    __syncthreads();       // tile i landed; every warp is done with i - 1
    if (i + C::NS - 1 < n_tiles)
      load_tile(t_begin + i + C::NS - 1, (i + C::NS - 1) % C::NS);
    cp_commit();
    const int base = (t_begin + i) * BN + 16 * warp;
    if (base >= n_valid) continue;
    const uint32_t ks = smem_addr(smem + (i % C::NS) * 2 * C::TILE);
    const uint32_t vs = ks + C::TILE;

    // s (16 heads x 16 positions) as two n-tiles of 8 positions
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int krow = 16 * warp + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, ks + krow * C::ROW + 2 * (16 * kk + 8 * ((lane >> 3) & 1)));
      mma16816(s[0], qa[kk], kf[0], kf[1]);
      mma16816(s[1], qa[kk], kf[2], kf[3]);
    }
    if (base + 16 > n_valid) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (base + 8 * t + 2 * (lane & 3) + (e & 1) >= n_valid)
            s[t][e] = MASKV;
    }
    const float mn0 = fmaxf(m[0], quad_max(fmaxf(fmaxf(s[0][0], s[0][1]),
                                                 fmaxf(s[1][0], s[1][1]))));
    const float mn1 = fmaxf(m[1], quad_max(fmaxf(fmaxf(s[0][2], s[0][3]),
                                                 fmaxf(s[1][2], s[1][3]))));
    const float c0 = expf(m[0] - mn0), c1 = expf(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      s[t][0] = expf(s[t][0] - mn0);
      s[t][1] = expf(s[t][1] - mn0);
      s[t][2] = expf(s[t][2] - mn1);
      s[t][3] = expf(s[t][3] - mn1);
    }
    l[0] = l[0] * c0 + ((s[0][0] + s[0][1]) + (s[1][0] + s[1][1]));
    l[1] = l[1] * c1 + ((s[0][2] + s[0][3]) + (s[1][2] + s[1][3]));
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    const int vrow = 16 * warp + (lane & 15);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, vs + vrow * C::ROW + 2 * (16 * dp + 8 * (lane >> 4)));
      mma16816(o[2 * dp], pa, vf[0], vf[1]);
      mma16816(o[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }
  cp_wait<0>();
  __syncthreads();         // the ring is free: merge the warps through it

  float* s_m = reinterpret_cast<float*>(smem);    // (NW, 16)
  float* s_l = s_m + NW * GMAX;                   // (NW, 16)
  float* s_o = s_l + NW * GMAX;                   // (NW, 16, D)
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  if ((lane & 3) == 0) {
    s_m[warp * GMAX + r0] = m[0];
    s_m[warp * GMAX + r0 + 8] = m[1];
    s_l[warp * GMAX + r0] = l0;
    s_l[warp * GMAX + r0 + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float* row0 = s_o + (warp * GMAX + r0) * D + 8 * n + 2 * (lane & 3);
    row0[0] = o[n][0];
    row0[1] = o[n][1];
    row0[8 * D] = o[n][2];
    row0[8 * D + 1] = o[n][3];
  }
  __syncthreads();
  const int64_t part =
      ((int64_t)(b * a.KH + kh) * a.splits + split) * G;
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float mx = s_m[g];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, s_m[w * GMAX + g]);
    float acc = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(s_m[w * GMAX + g] - mx);
      acc += e * s_o[(w * GMAX + g) * D + d];
      sum += e * s_l[w * GMAX + g];
    }
    a.part_o[(part + g) * D + d] = acc;
    if (d == 0) {
      a.part_ml[2 * (part + g)] = mx;
      a.part_ml[2 * (part + g) + 1] = sum;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_decode_combine_kernel(const DecodeArgs a) {
  __shared__ float w[MAX_SPLITS * GMAX];    // exp(m_split - m), by split
  __shared__ float den[GMAX];               // max(l, 1e-30)
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = a.G, n = a.splits;
  const int64_t part = (int64_t)(b * a.KH + kh) * n * G;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = a.part_ml[2 * (part + g)];
    for (int s = 1; s < n; ++s)
      mx = fmaxf(mx, a.part_ml[2 * (part + s * G + g)]);
    float sum = 0.f;
    for (int s = 0; s < n; ++s) {
      const float e = expf(a.part_ml[2 * (part + s * G + g)] - mx);
      w[s * GMAX + g] = e;
      sum += e * a.part_ml[2 * (part + s * G + g) + 1];
    }
    den[g] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  __nv_bfloat16* ob = a.out + ((int64_t)b * a.H + (int64_t)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float acc = 0.f;
    for (int s = 0; s < n; ++s)
      acc += w[s * GMAX + g] * a.part_o[(part + s * G + g) * D + d];
    ob[i] = __float2bfloat16_rn(acc / den[g]);
  }
}

template <int D>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_decode_split_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<D>::SMEM);
}

template <int D>
int launch(const DecodeArgs& a, int B, cudaStream_t st) {
  cudaError_t e = allow_smem<D>();
  if (e != cudaSuccess) return (int)e;
  flash_decode_split_kernel<D>
      <<<dim3((unsigned)a.splits, (unsigned)a.KH, (unsigned)B), NT,
         Cfg<D>::SMEM, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_combine_kernel<D>
      <<<dim3((unsigned)a.KH, (unsigned)B), NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int ctas_per_sm() {
  int n = 0;
  if (allow_smem<D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, flash_decode_split_kernel<D>, NT, Cfg<D>::SMEM) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// The dynamic shared memory a split CTA takes at head dim D (0: not served).
extern "C" int flash_decode_smem(int D) {
  return D == 64 ? Cfg<64>::SMEM : D == 128 ? Cfg<128>::SMEM : 0;
}

// Split CTAs an SM of the current card holds at head dim D (the wrapper's
// split count reads it); -1 on an error or a D the kernel does not serve.
extern "C" int flash_decode_ctas_per_sm(int D) {
  return D == 64 ? ctas_per_sm<64>() : D == 128 ? ctas_per_sm<128>() : -1;
}

// strides: 8 element strides, (b, h) of q, (b, s, h) of k and of v. out is
// (B,1,H,D) contiguous; part_o holds B KH splits G D floats, part_ml twice
// B KH splits G. Synchronises nothing; returns cudaGetLastError().
extern "C" int flash_decode(int B, int S, int H, int KH, int D,
                            const void* q, const void* k, const void* v,
                            const int* kv_len, void* out, float* part_o,
                            float* part_ml, const int64_t* strides,
                            float scale, int splits, int tiles_per_split,
                            void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0 || H / KH > GMAX ||
      splits < 1 || splits > MAX_SPLITS || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split * BN < S)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.kv_len = kv_len;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_o = part_o;
  a.part_ml = part_ml;
  a.sqb = strides[0]; a.sqh = strides[1];
  a.skb = strides[2]; a.sks = strides[3]; a.skh = strides[4];
  a.svb = strides[5]; a.svs = strides[6]; a.svh = strides[7];
  a.S = S; a.H = H; a.KH = KH; a.G = H / KH;
  a.splits = splits; a.tiles_per_split = tiles_per_split;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, B, st);
  if (D == 128) return launch<128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
