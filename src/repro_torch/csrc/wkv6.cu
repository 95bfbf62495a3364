// wkv6: the RWKV6 ("Finch") WKV recurrence in its chunk-parallel form, on
// Hopper's tensor cores in 3xTF32.
//
// Per (batch, head), over a (hd x hd) matrix state S with data-dependent
// per-channel decay w_t in (0, 1) and bonus u:
//
//   y_t     = r_t @ (diag(u) k_t v_t^T + S_t)
//   S_{t+1} = diag(w_t) S_t + k_t v_t^T
//
// r, k, v, w and y are (B, T, H, hd) float32, u (H, hd), s0 and the final
// state (B, H, hd, hd), all float32; s0 may be null (zeros).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/kernel.py:88
// wkv_chunked_tiles, which walked a (B, H, T/C) grid with the chunk axis
// sequential and S in VMEM scratch. On Hopper one CTA a (b, h) walking its
// chunks in order fills 128 of 132 SMs with 8 warps each and leaves every
// stage latency-bound. So the work is split into two kernels, launched one
// after the other on the caller's stream, over chunks of C = 32 steps.
// With lw = log2(clip(w, 1e-12, 1)), cum its inclusive cumulative sum over
// a chunk, cum_prev its exclusive one (cum of the row before, 0 at the
// first row) and tot = cum at the chunk's last row, in log2 units:
//
//   1. wkv6_kernel_state runs the inter-chunk recurrence and nothing else.
//      A CTA of hd / 16 warps owns one (b, h) and a 16-row strip of S, each
//      warp a 16 x 16 tile (512 CTAs of 128 threads at (4, 1024, 32, 64)),
//      and walks the chunks in order: it writes the state S_c entering
//      every chunk to a float32 workspace (B, H, n_chunks, hd, hd), then
//      S_{c+1} = diag(2^tot) S_c + kt^T @ v with kt = k * 2^(tot - cum)
//      for its 16 channels. k, w and v come in by cp.async two chunks ahead
//      (three stages), each thread's sources and places worked out once.
//      The cumulative sum is a warp-shuffle scan, one lane a row; kt is
//      split once, into k's and w's places. The last state goes to s_out.
//      16-row strips beat 32 and 64 rows (fewer CTAs) on the H100, though
//      the strips of a head read its v from L2 hd / 16 times.
//   2. wkv6_kernel_out computes every chunk's output on its own: one CTA of
//      256 threads a (b, h, chunk), 4,096 CTAs at that shape.
//        y = (r * 2^cum_prev) @ S_c + att @ v
//      att (C x C, lower triangular) is built by blocks. The four diagonal
//      8 x 8 blocks keep the pairwise exponent cum_prev_t - cum_s <= 0 on
//      the CUDA cores, one strictly causal (t, s) pair a thread, with the
//      bonus sum_i r_t,i u_i k_t,i on the diagonal. The blocks below them
//      are products on the tensor cores, each factored at its boundary,
//      ref = cum at the row before its first row: rh = r * 2^(cum_prev -
//      ref), kh = k * 2^(ref - cum), both exponents <= 0, so nothing
//      overflows however strong the decay, and where a factor underflows
//      the true product is smaller still. They are the 16 x 16 block t in
//      16..31, s in 0..15, and the 8 x 8 blocks t in 8..15, s in 0..7 and
//      t in 24..31, s in 16..23 (one warp each, beside the pairs). Pairwise
//      8 x 8 blocks take 112 pairs x hd exponentials a chunk where 16 x 16
//      ones took 240: the MUFU unit set the pair scores' time.
//
// cum_prev is the row before's cum, not cum - lw as the reference writes
// it: then the exponents of an adjacent pair and of the boundary factors
// (cum_prev_r0 - ref, ref - cum_r0-1, tot - cum_31) are exactly 0. Under
// strong decay |cum| grows by 40 a step (log2 1e-12), and cum - lw leaves
// an ulp of cum (1.2e-4 at row 31) in exponents of terms that do not decay:
// on the rwkv6-1.6b serve path's decays (down to 1e-21) the reference's
// chunked form is up to 1.8e-3 off a float64 recurrence, this kernel
// 7.1e-5 (scripts/wkv6_serve_accuracy_witness.py, on an H100).
//
// Every product (rh @ kh^T, (r * 2^cum_prev) @ S_c, att @ v and kt^T @ v)
// runs as mma.sync.m16n8k8 tf32 in 3xTF32: each operand x is split into
// hi, x rounded to TF32 to nearest (ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x, here by an integer add and mask),
// and lo = x - hi, handed over as float32 bits that the tensor core reads
// truncated to TF32; a.b is issued as lo.hi + hi.lo + hi.hi into three
// accumulators, summed in float32. TF32 rounded once misses the 3e-4
// tolerance by 50-90x (0.014-0.028 on y); the split matches float32
// (tests/test_torch_wkv6_tc_rounding.py emulates this decomposition on the
// CPU). mma.sync, not wgmma: its fragments load from any shared-memory
// layout with plain loads, so kt^T @ v, which contracts over time, reads
// the (time, channel) tiles as they land, where tf32 wgmma takes only
// K-major operands from shared memory; and the tiles here (16 or 32 rows)
// are smaller than wgmma's 64. The per-term factors 2^x are ex2.approx
// (about 2 ulp). The state kernel takes log2f and its carried decay 2^tot
// by exp2f, accurate, since their errors compound from chunk to chunk; the
// out kernel takes lg2.approx (about 2^-22 absolute), whose error stays
// inside one chunk.
//
// A ragged last chunk is padded in shared memory with r = k = v = 0 (the
// copies' zero fill) and lw = 0 (w = 1), which leaves y and S as they are;
// rows past T are not written.
//
// Bound on an H100 SXM: bytes. r, k, v, w read and y written once, S
// written once and s0 read once where one is given: 169,877,504 B at the
// prefill shape (4, 1024, 32, 64) with no s0, 0.0507 ms over 3.35 TB/s
// (chip_smoke.py's wkv_bound; its float32 operation count, 3.2 GFLOP, is
// 0.0475 ms on the CUDA cores and less on the tensor cores). This design
// moves more: the state pass reads k, w and v (100.7 MB) and the out pass
// r, k, v and w (134.2 MB) and writes y (33.6 MB), and the workspace is
// written and read once (67.1 MB each way at C = 32): about 403 MB, 0.12 ms
// at 3.35 TB/s. That round trip of every chunk's entering state, and the
// second read of k, w and v, are what it gives up for parallelism.
//
// hd is a template parameter: 16, 32, 64 (rwkv6-1.6b) and 128; others are
// refused. At hd = 64 a state CTA takes 46,144 B of shared memory and an
// out CTA 54,288 B (att reuses the cumulative sums' rows once they are
// spent), four of each an SM. Row starts must be 16-byte aligned
// (cp.async); the wrapper copies a tensor that is not. The two kernels
// launch on the caller's stream, allocate nothing (the wrapper passes the
// workspace) and synchronise nothing; wkv6 returns the first launch error.
#include <cstdint>
#include <cuda_runtime.h>

#define WKV_CHUNK 32
#define WKV_SUB 16         // the off-diagonal 16 x 16 block of att
#define WKV_PAIR 8         // att's diagonal blocks, scored pairwise
#define OUT_THREADS 256
#define FULL_MASK 0xffffffffu

struct WkvArgs {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;  // may be null
  float* y;
  float* s_out;
  float* ws;        // (B, H, n_chunks, hd, hd): S entering every chunk
  int T;
  int H;
};

// -- cp.async, TF32 and mma.sync ---------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats to an 8-byte aligned address in one store
__device__ __forceinline__ void st2(float* p, float x, float y) {
  asm volatile("st.global.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(x),
               "f"(y)
               : "memory");
}

// x rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives for finite x, in two integer operations where
// ptxas expands the cvt into a compare-and-select sequence)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi rounded to TF32 (to nearest), lo = x - hi exactly, fed
// to the mma as float32 bits, whose low 13 bits the tensor core ignores:
// lo loses at most 2^-21 of x, the order of the lo.lo term 3xTF32 drops
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a.b in 3xTF32, each product into its own accumulator so that three
// chains of mma run side by side: d[0] += lo.hi, d[1] += hi.lo, d[2] +=
// hi.hi; sum3 adds them, the two small cross terms first
__device__ __forceinline__ void mma3(float (&d)[3][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d[0], al, bh);
  mma_tf32(d[1], ah, bl);
  mma_tf32(d[2], ah, bh);
}

__device__ __forceinline__ float sum3(const float (&d)[3][4], int e) {
  return (d[0][e] + d[1][e]) + d[2][e];
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][3][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][p][e] = 0.f;
}

// Fragments of m16n8k8 (PTX ISA: g = lane / 4, q = lane % 4; A (16 x 8)
// a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); B (8 x 8) b0
// (q, g), b1 (q + 4, g); C (16 x 8) c0, c1 (g, 2q, 2q + 1), c2, c3 (g + 8,
// 2q, 2q + 1)), loaded from shared memory M with row stride ld and split.
// A[m][k] = M[m][k0 + k]
__device__ __forceinline__ void load_a(const float* M, int ld, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  split(M[g * ld + k0 + q], hi[0], lo[0]);
  split(M[(g + 8) * ld + k0 + q], hi[1], lo[1]);
  split(M[g * ld + k0 + q + 4], hi[2], lo[2]);
  split(M[(g + 8) * ld + k0 + q + 4], hi[3], lo[3]);
}

// A[m][k] = M[k0 + k][m], M stored with the contraction along rows and
// already split: its hi parts in Mh, its lo parts in Ml
__device__ __forceinline__ void load_a_t(const float* Mh, const float* Ml,
                                         int ld, int k0, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int o[4] = {(k0 + q) * ld + g, (k0 + q) * ld + g + 8,
                    (k0 + q + 4) * ld + g, (k0 + q + 4) * ld + g + 8};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = __float_as_uint(Mh[o[e]]);
    lo[e] = __float_as_uint(Ml[o[e]]);
  }
}

// B[k][n] = M[k0 + k][n0 + n]
__device__ __forceinline__ void load_b(const float* M, int ld, int k0, int n0,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  split(M[(k0 + q) * ld + n0 + g], hi[0], lo[0]);
  split(M[(k0 + q + 4) * ld + n0 + g], hi[1], lo[1]);
}

// B[k][n] = M[n0 + n][k0 + k]
__device__ __forceinline__ void load_b_t(const float* M, int ld, int n0,
                                         int k0, uint32_t (&hi)[2],
                                         uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  split(M[(n0 + g) * ld + k0 + q], hi[0], lo[0]);
  split(M[(n0 + g) * ld + k0 + q + 4], hi[1], lo[1]);
}

// N consecutive floats of shared memory (8- or 16-byte aligned) to x
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  static_assert(N % 2 == 0, "pairs");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + e);
      x[e] = f.x; x[e + 1] = f.y; x[e + 2] = f.z; x[e + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; e += 2) {
      const float2 f = *reinterpret_cast<const float2*>(p + e);
      x[e] = f.x; x[e + 1] = f.y;
    }
  }
}

// 2^x by the MUFU unit (ex2.approx.ftz: about 2 ulp; 0 for x < -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// log2(x) by the MUFU unit (lg2.approx.ftz: about 2^-22 absolute)
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// per lane t of a warp and each of N channels: log2(clip(w, 1e-12, 1)) at
// row t (0 at and past row n), then the inclusive sum over rows 0..t.
// ACCURATE takes log2f, for sums whose error is carried from chunk to
// chunk; otherwise lg2.approx, whose error stays inside one chunk.
template <bool ACCURATE, int N>
__device__ __forceinline__ void log_cumsum(float (&x)[N], int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float c = fminf(fmaxf(x[e], 1e-12f), 1.f);
    x[e] = lane < n ? (ACCURATE ? log2f(c) : lg2(c)) : 0.f;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float p = __shfl_up_sync(FULL_MASK, x[e], o);
      if (lane >= o) x[e] += p;
    }
  }
}

// -- 1. the inter-chunk recurrence -------------------------------------------
template <int HD>
struct StateCfg {
  static constexpr int C = WKV_CHUNK;
  static constexpr int TILE = 16;                 // i-rows of S a CTA
  static constexpr int NB = HD / TILE;            // CTAs a (b, h)
  static constexpr int WARPS = HD / 16;           // 16 x 16 of S a warp
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int CPW = TILE / WARPS;        // channels a warp scans
  static constexpr int PK = TILE + 8;             // k rows: A fragments
  static constexpr int PW = TILE + 8;             // w rows, then kt's lo
  static constexpr int PV = HD + 8;               // v rows: B fragments
  static constexpr int NSTAGE = 3;
  static constexpr int stage = C * (PK + PW + PV);
  static constexpr int ROWQ = (2 * TILE + HD) / 4;  // 16-byte pieces a row
  static constexpr int PIECES = C * ROWQ / THREADS;  // a thread a chunk
  static constexpr int floats = NSTAGE * stage + TILE;
  static constexpr int bytes = floats * (int)sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(StateCfg<HD>::THREADS)
wkv6_kernel_state(WkvArgs a) {
  using L = StateCfg<HD>;
  constexpr int C = L::C, TILE = L::TILE, NB = L::NB, PK = L::PK,
                PW = L::PW, PV = L::PV, CPW = L::CPW, NS = L::NSTAGE;
  static_assert(C == 32 && PW == PK, "one lane a row; kt's lo over w");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* etot = sm + NS * L::stage;               // 2^tot, (TILE)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int ib = blockIdx.x % NB, bh = blockIdx.x / NB;
  const int hh = bh % a.H;
  const int b = bh / a.H;
  const int T = a.T, nc = (T + C - 1) / C;
  const int i0 = ib * TILE;
  const int64_t row = (int64_t)a.H * HD;
  const int64_t head0 = (int64_t)b * T * row + (int64_t)hh * HD;
  const int nj = warp * 16;      // this warp's columns: two 16 x 8 tiles

  float acc[2][4];
  const float* s0 = a.s0 ? a.s0 + (int64_t)bh * HD * HD : nullptr;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8, j = nj + nt * 8 + 2 * q + (e & 1);
      acc[nt][e] = s0 ? s0[(int64_t)i * HD + j] : 0.f;
    }

  // this thread's 16-byte pieces of a chunk: k and w of the TILE
  // channels, v of all columns; their sources at chunk 0, places in a
  // stage and rows
  static_assert(C * L::ROWQ % L::THREADS == 0, "pieces");
  const float* src[L::PIECES];
  int dst[L::PIECES], prow[L::PIECES];
#pragma unroll
  for (int m = 0; m < L::PIECES; ++m) {
    const int e = tid + m * L::THREADS;
    const int t = e / L::ROWQ, p = (e % L::ROWQ) * 4;
    const int64_t g0 = head0 + (int64_t)t * row;
    prow[m] = t;
    if (p < TILE) {
      src[m] = a.k + g0 + i0 + p;
      dst[m] = t * PK + p;
    } else if (p < 2 * TILE) {
      src[m] = a.w + g0 + i0 + p - TILE;
      dst[m] = C * PK + t * PW + p - TILE;
    } else {
      src[m] = a.v + g0 + p - 2 * TILE;
      dst[m] = C * (PK + PW) + t * PV + p - 2 * TILE;
    }
  }
  // chunk c, rows past T zero, into stage c % NS; one cp.async group a
  // chunk (empty past nc)
  auto load = [&](int c) {
    if (c < nc) {
      float* st = sm + (c % NS) * L::stage;
      const int64_t off = (int64_t)c * C * row;
#pragma unroll
      for (int m = 0; m < L::PIECES; ++m) {
        const bool ok = c * C + prow[m] < T;
        cp_async16(st + dst[m], ok ? src[m] + off : src[m], ok);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int c = 0; c < NS - 1; ++c) load(c);
  float* ws = a.ws + (int64_t)bh * nc * HD * HD;
  for (int c = 0; c < nc; ++c) {
    load(c + NS - 1);
    // S_c, the state entering chunk c, to the workspace
    float* wsc = ws + (int64_t)c * HD * HD;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st2(wsc + (i0 + g + h * 8) * HD + nj + nt * 8 + 2 * q,
            acc[nt][2 * h], acc[nt][2 * h + 1]);
    cp_async_wait<NS - 1>();
    __syncthreads();                              // chunk c has landed
    float* kst = sm + (c % NS) * L::stage;
    float* wst = kst + C * PK;
    float* vst = wst + C * PW;
    // cum (log2 units) by a shuffle scan, lane t = row t, CPW channels a
    // warp; kt = k * 2^(tot - cum), split once: hi over k, lo over w
    {
      const int ch = warp * CPW;
      float x[CPW], kk[CPW];
      lds(x, wst + lane * PW + ch);
      log_cumsum<true>(x, T - c * C);
      lds(kk, kst + lane * PK + ch);
#pragma unroll
      for (int e = 0; e < CPW; ++e) {
        const float tot = __shfl_sync(FULL_MASK, x[e], 31);
        uint32_t hi, lo;
        split(kk[e] * ex2(tot - x[e]), hi, lo);
        kst[lane * PK + ch + e] = __uint_as_float(hi);
        wst[lane * PW + ch + e] = __uint_as_float(lo);
        if (lane == 31) etot[ch + e] = exp2f(tot);
      }
    }
    __syncthreads();
    // S_{c+1} = diag(2^tot) S_c + kt^T @ v
    float kv[2][3][4];
    zero(kv);
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 8) {
      uint32_t ah[4], al[4];
      load_a_t(kst, wst, PK, k0, ah, al);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bhi[2], blo[2];
        load_b(vst, PV, k0, nj + nt * 8, bhi, blo);
        mma3(kv[nt], ah, al, bhi, blo);
      }
    }
    const float e0 = etot[g], e1 = etot[g + 8];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e] = fmaf(e < 2 ? e0 : e1, acc[nt][e], sum3(kv[nt], e));
    __syncthreads();                              // this stage is refilled
  }
  float* so = a.s_out + (int64_t)bh * HD * HD;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st2(so + (i0 + g + h * 8) * HD + nj + nt * 8 + 2 * q, acc[nt][2 * h],
          acc[nt][2 * h + 1]);
}

// -- 2. every chunk's output -------------------------------------------------
template <int HD>
struct OutCfg {
  static constexpr int C = WKV_CHUNK;
  static constexpr int PA = HD + 4;     // r, k, cum rows: A fragments
  static constexpr int PB = HD + 8;     // v and S rows: B fragments
  static constexpr int PT = C + 4;      // att rows
  static constexpr int r = 0;
  static constexpr int k = r + C * PA;
  static constexpr int cm = k + C * PA;           // (C + 1) rows: 0, cum
  static constexpr int att = cm;                  // att once cum is spent
  static constexpr int cm_floats =
      (C + 1) * PA > C * PT ? (C + 1) * PA : C * PT;
  static constexpr int v = cm + cm_floats;
  static constexpr int S = v + C * PB;
  static constexpr int u = S + HD * PB;
  static constexpr int floats = u + HD;
  static constexpr int bytes = floats * (int)sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(OUT_THREADS) wkv6_kernel_out(WkvArgs a) {
  using L = OutCfg<HD>;
  constexpr int C = L::C, PA = L::PA, PB = L::PB, PT = L::PT;
  constexpr int NWARPS = OUT_THREADS / 32;
  constexpr int NN = HD / 8;                      // n-tiles of y
  constexpr int NTW = (NN + 3) / 4;               // n-tiles a warp
  constexpr int CPW = HD / NWARPS;                // channels a warp scans
  constexpr int SUB = WKV_SUB;
  static_assert(C == 32 && 2 * SUB == C && OUT_THREADS == 256, "layout");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* rs = sm + L::r;
  float* ks = sm + L::k;
  float* cm = sm + L::cm;      // row 0 zeros, row t + 1 cum_t: cum_prev_t row t
  float* vs = sm + L::v;
  float* S = sm + L::S;
  float* att = sm + L::att;    // over cm, from the in-place pass on
  float* us = sm + L::u;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int nc = (a.T + C - 1) / C;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int hh = bh % a.H;
  const int b = bh / a.H;
  const int c0 = c * C, n = min(C, a.T - c0);
  const int64_t row = (int64_t)a.H * HD;
  const int64_t base = ((int64_t)b * a.T + c0) * row + (int64_t)hh * HD;
  const float* Sg = a.ws + ((int64_t)bh * nc + c) * HD * HD;

  // r, k, v, w of the chunk (rows past T zero), then S_c in a second
  // group that lands while the scan and the pair scores run
  constexpr int V = HD / 4;
  for (int e = tid; e < C * V; e += OUT_THREADS) {
    const int t = e / V, p = (e % V) * 4;
    const bool ok = t < n;
    const int64_t g0 = base + (int64_t)(ok ? t : 0) * row + p;
    cp_async16(rs + t * PA + p, a.r + g0, ok);
    cp_async16(ks + t * PA + p, a.k + g0, ok);
    cp_async16(vs + t * PB + p, a.v + g0, ok);
    cp_async16(cm + (t + 1) * PA + p, a.w + g0, ok);
  }
  cp_async_commit();
  for (int e = tid; e < HD * V; e += OUT_THREADS) {
    const int i = e / V, p = (e % V) * 4;
    cp_async16(S + i * PB + p, Sg + (int64_t)i * HD + p, true);
  }
  cp_async_commit();
  for (int i = tid; i < HD; i += OUT_THREADS) {
    us[i] = a.u[hh * HD + i];
    cm[i] = 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();

  // cum (log2 units) by a shuffle scan, lane t = row t, CPW channels a warp
  {
    const int ch = warp * CPW;
    float x[CPW];
    lds(x, cm + (lane + 1) * PA + ch);
    log_cumsum<false>(x, n);
#pragma unroll
    for (int e = 0; e < CPW; ++e) cm[(lane + 1) * PA + ch + e] = x[e];
  }
  __syncthreads();

  // att's diagonal 8 x 8 blocks: 4 x 28 strictly causal pairs, one a
  // thread of warps 0-3, with the pairwise exponent, and the bonus on the
  // diagonal; warps 4 and 5: the 8 x 8 blocks below them (t in 8..15, s in
  // 0..7; t in 24..31, s in 16..23) as products factored at ref = cum at
  // the row before their first row. All held in registers until cum is
  // spent.
  constexpr int PAIR = WKV_PAIR, NPAIR = PAIR * (PAIR - 1) / 2;
  static_assert(C / PAIR * NPAIR + SUB == 128, "warps 0-3: pairs, bonus");
  int at0 = -1, at1 = -1;                         // att offsets, x0, x1
  float x0 = 0.f, x1 = 0.f;
  if (tid < C / PAIR * NPAIR) {
    const int blk = tid / NPAIR, p = tid % NPAIR;
    const int tl = (int)((1.f + sqrtf(1.f + 8.f * p)) * 0.5f);
    const int t = blk * PAIR + tl, s = blk * PAIR + p - tl * (tl - 1) / 2;
    const float4* rt = reinterpret_cast<const float4*>(rs + t * PA);
    const float4* ct = reinterpret_cast<const float4*>(cm + t * PA);
    const float4* kk = reinterpret_cast<const float4*>(ks + s * PA);
    const float4* cs = reinterpret_cast<const float4*>(cm + (s + 1) * PA);
    float x = 0.f;                                // ct: cum_prev_t; cs: cum_s
#pragma unroll 4
    for (int i = 0; i < HD / 4; ++i) {
      const float4 r4 = rt[i], c4 = ct[i], k4 = kk[i], s4 = cs[i];
      x = fmaf(r4.x * k4.x, ex2(c4.x - s4.x), x);
      x = fmaf(r4.y * k4.y, ex2(c4.y - s4.y), x);
      x = fmaf(r4.z * k4.z, ex2(c4.z - s4.z), x);
      x = fmaf(r4.w * k4.w, ex2(c4.w - s4.w), x);
    }
    at0 = t * PT + s;
    x0 = x;
  } else if (tid < 128) {
    const int t = tid - C / PAIR * NPAIR;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* rt = rs + (t + h * SUB) * PA;
      const float* kk = ks + (t + h * SUB) * PA;
      float x = 0.f;
#pragma unroll 8
      for (int i = 0; i < HD; ++i) x = fmaf(rt[i] * us[i], kk[i], x);
      (h ? x1 : x0) = x;
    }
    at0 = t * (PT + 1);
    at1 = (t + SUB) * (PT + 1);
  } else if (warp < 6) {
    // rows 0..7 of the m16n8 product are the block's, rows 8..15 zero
    const int r0 = warp == 4 ? PAIR : SUB + PAIR, c0 = r0 - PAIR;
    const float* ref = cm + r0 * PA;              // cum at row r0 - 1
    const float* rt = rs + (r0 + g) * PA;
    const float* ct = cm + (r0 + g) * PA;         // cum_prev of row r0 + g
    const float* kk = ks + (c0 + g) * PA;
    const float* cs = cm + (c0 + g + 1) * PA;     // cum of row c0 + g
    float o[1][3][4];
    zero(o);
#pragma unroll 4
    for (int k0 = 0; k0 < HD; k0 += 8) {
      uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
      uint32_t bhi[2], blo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = k0 + q + 4 * h;
        split(rt[i] * ex2(ct[i] - ref[i]), ah[2 * h], al[2 * h]);
        split(kk[i] * ex2(ref[i] - cs[i]), bhi[h], blo[h]);
      }
      mma3(o[0], ah, al, bhi, blo);
    }
    at0 = (r0 + g) * PT + c0 + 2 * q;
    at1 = at0 + 1;
    x0 = sum3(o[0], 0);
    x1 = sum3(o[0], 1);
  }
  __syncthreads();

  // in place: r -> r * 2^cum_prev; k rows < 16 -> kh = k * 2^(ref - cum),
  // rows >= 16 -> rh = r * 2^(cum_prev - ref), ref = cum_15
  for (int e = tid; e < C * HD; e += OUT_THREADS) {
    const int t = e / HD, i = e % HD;
    const float r = rs[t * PA + i], cp = cm[t * PA + i];
    const float ref = cm[SUB * PA + i];
    rs[t * PA + i] = r * ex2(cp);
    if (t < SUB)
      ks[t * PA + i] *= ex2(ref - cm[(t + 1) * PA + i]);
    else
      ks[t * PA + i] = r * ex2(cp - ref);
  }
  cp_async_wait<0>();                             // S_c
  __syncthreads();

  // att over cm: the diagonal blocks and the 8 x 8 ones below them, zeros
  // above the diagonal
  if (at0 >= 0) att[at0] = x0;
  if (at1 >= 0) att[at1] = x1;
  for (int e = tid; e < C * C; e += OUT_THREADS) {
    const int t = e / C, s = e % C;
    if (s > t) att[t * PT + s] = 0.f;
  }

  // the 16 x 16 block att[16..31][0..15] = rh @ kh^T (warps 0, 1)
  if (warp < 2) {
    float o[1][3][4];
    zero(o);
    const int n0 = warp * 8;
#pragma unroll 4
    for (int k0 = 0; k0 < HD; k0 += 8) {
      uint32_t ah[4], al[4], bhi[2], blo[2];
      load_a(ks + SUB * PA, PA, k0, ah, al);
      load_b_t(ks, PA, n0, k0, bhi, blo);
      mma3(o[0], ah, al, bhi, blo);
    }
    att[(SUB + g) * PT + n0 + 2 * q] = sum3(o[0], 0);
    att[(SUB + g) * PT + n0 + 2 * q + 1] = sum3(o[0], 1);
    att[(SUB + g + 8) * PT + n0 + 2 * q] = sum3(o[0], 2);
    att[(SUB + g + 8) * PT + n0 + 2 * q + 1] = sum3(o[0], 3);
  }

  // y = (r * 2^cum_prev) @ S_c + att @ v: warp w owns rows 16 (w % 2)
  // and n-tiles w / 2, w / 2 + 4, ...
  const int m0 = (warp & 1) * 16, nq = warp >> 1;
  float acc[NTW][3][4];
  zero(acc);
#pragma unroll 2
  for (int k0 = 0; k0 < HD; k0 += 8) {
    uint32_t ah[4], al[4];
    load_a(rs + m0 * PA, PA, k0, ah, al);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int nt = nq + 4 * j;
      if (nt < NN) {
        uint32_t bhi[2], blo[2];
        load_b(S, PB, k0, nt * 8, bhi, blo);
        mma3(acc[j], ah, al, bhi, blo);
      }
    }
  }
  __syncthreads();                                // att is complete
  const int kend = m0 + 16;                       // att is lower triangular
  for (int k0 = 0; k0 < kend; k0 += 8) {
    uint32_t ah[4], al[4];
    load_a(att + m0 * PT, PT, k0, ah, al);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int nt = nq + 4 * j;
      if (nt < NN) {
        uint32_t bhi[2], blo[2];
        load_b(vs, PB, k0, nt * 8, bhi, blo);
        mma3(acc[j], ah, al, bhi, blo);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = nq + 4 * j;
    if (nt >= NN) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + g + h * 8;
      if (t < n)
        st2(a.y + base + (int64_t)t * row + nt * 8 + 2 * q,
            sum3(acc[j], 2 * h), sum3(acc[j], 2 * h + 1));
    }
  }
}

template <int HD>
static int launch(const WkvArgs& a, int B, cudaStream_t st) {
  using LS = StateCfg<HD>;
  using LO = OutCfg<HD>;
  const int nc = (a.T + WKV_CHUNK - 1) / WKV_CHUNK;
  auto ks = wkv6_kernel_state<HD>;
  auto ko = wkv6_kernel_out<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      ks, cudaFuncAttributeMaxDynamicSharedMemorySize, LS::bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ko, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           LO::bytes);
  if (e != cudaSuccess) return (int)e;
  ks<<<(unsigned)(B * a.H * LS::NB), LS::THREADS, LS::bytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ko<<<(unsigned)(B * a.H * nc), OUT_THREADS, LO::bytes, st>>>(a);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Dynamic shared memory a CTA of the state (which = 0) or out (which = 1)
// kernel at head dim hd, in bytes; -1 for a head dim it does not take.
extern "C" int wkv6_smem(int hd, int which) {
  switch (hd) {
    case 16: return which ? OutCfg<16>::bytes : StateCfg<16>::bytes;
    case 32: return which ? OutCfg<32>::bytes : StateCfg<32>::bytes;
    case 64: return which ? OutCfg<64>::bytes : StateCfg<64>::bytes;
    case 128: return which ? OutCfg<128>::bytes : StateCfg<128>::bytes;
    default: return -1;
  }
}

// r, k, v, w, y: contiguous (B, T, H, hd) float32; u: contiguous (H, hd);
// s0 (null for zeros) and s_out: contiguous (B, H, hd, hd) float32; ws:
// contiguous (B, H, ceil(T / 32), hd, hd) float32 scratch. Every pointer but
// u 16-byte aligned.
extern "C" int wkv6(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* s0,
                    float* y, float* s_out, float* ws, int B, int T, int H,
                    int hd, void* stream) {
  if (B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(w) ||
      !aligned16(y) || !aligned16(s_out) || !aligned16(ws) ||
      (s0 && !aligned16(s0)))
    return (int)cudaErrorMisalignedAddress;
  WkvArgs a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.u = u; a.s0 = s0;
  a.y = y; a.s_out = s_out; a.ws = ws; a.T = T; a.H = H;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(a, B, st);
    case 32: return launch<32>(a, B, st);
    case 64: return launch<64>(a, B, st);
    case 128: return launch<128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
