// wkv6: the RWKV6 ("Finch") WKV recurrence in its chunk-parallel form.
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
// wkv_chunked_tiles. That kernel walked a (B, H, T/C) grid with the chunk
// axis sequential and S in VMEM scratch, and materialised the pairwise
// decay exponent as a (C, C, hd) VMEM tensor for the MXU. Here one CTA owns
// one (b, h) and loops over the chunks of C = 32 steps in order, so S never
// leaves shared memory between chunks (16 KB at hd = 64). Within a chunk,
// with lw = log(clip(w, 1e-12, 1)), cum its inclusive cumulative sum over
// the chunk and cum_prev = cum - lw:
//   1. y_t  = (r_t * exp(cum_prev_t)) @ S                     (inter-chunk)
//   2. att[t, s] = sum_i r_t,i k_s,i exp(cum_prev_t,i - cum_s,i), s < t,
//      one (t, s) pair a thread, summed over hd on the fly: the (C, C, hd)
//      tensor (256 KB at hd = 64) is never formed. The pairwise exponent
//      is <= 0, so strong decay cannot overflow, as the factored
//      exp(-cum) form would;
//   3. att[t, t] = sum_i r_t,i u_i k_t,i (the bonus), then y_t += att[t] @ v;
//   4. S = diag(exp(cum_C-1)) S + (k * exp(cum_C-1 - cum))^T @ v.
// A ragged last chunk is padded in shared memory with w = 1 and r = k = v
// = 0, which leaves y and S as they are; rows past T are not written.
//
// Bound on an H100 SXM: about even. Bytes: r, k, v, w read and y written
// once, S written once and s0 read once where one is given: 169,877,504 B
// at the prefill shape (4, 1024, 32, 64) with no s0, as prefill calls it,
// 0.0507 ms over 3.35 TB/s. Operations (C = 32, hd =
// 64, counted as in chip_smoke.py's wkv_bound): about 3.2 GFLOP at that
// shape, 0.047 ms on the 67 TFLOP/s float32 FMA path. This kernel does the
// work as float32 FMAs on the CUDA cores, one CTA of 256 threads per
// (b, h): 128 CTAs at the prefill shape, one on each of 128 of the 132 SMs,
// each walking its 32 chunks in order with a barrier between the four
// stages, so no more than 8 warps an SM hide the latency. Shared-memory
// rows are padded to hd + 1 floats so that the 32 pairs of a warp (one t,
// 32 s) read 32 banks. Tensor cores (the two C x hd x hd products are
// wgmma-sized) and splitting T across CTAs are later work.
//
// hd is a template parameter: 16, 32, 64 (rwkv6-1.6b) and 128 (186 KB of
// shared memory a CTA); others are refused. It launches on the caller's
// stream, allocates nothing and synchronises nothing; wkv6 returns
// cudaGetLastError() after the launch.
#include <cstdint>
#include <cuda_runtime.h>

#define WKV_THREADS 256
#define WKV_CHUNK 32

struct WkvArgs {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;  // may be null
  float* y;
  float* s_out;
  int T;
  int H;
};

template <int HD>
struct WkvSmem {
  static constexpr int P = HD + 1;      // padded row of a chunk buffer
  static constexpr int C = WKV_CHUNK;
  static constexpr int floats = HD * HD + 7 * C * P + C * (C + 1) + 2 * HD;
  static constexpr int bytes = floats * (int)sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(WKV_THREADS)
wkv6_kernel(WkvArgs a) {
  constexpr int C = WKV_CHUNK;
  constexpr int P = WkvSmem<HD>::P;
  constexpr int NT = WKV_THREADS;
  constexpr int TS = NT / HD;           // threads sharing one column j
  constexpr int ROWS = C / TS;          // output rows t per thread
  constexpr int SROWS = HD / TS;        // state rows i per thread
  static_assert(NT % HD == 0 && C % TS == 0 && HD % TS == 0, "shape");

  extern __shared__ float sm[];
  float* S = sm;                        // (HD, HD)
  float* rs = S + HD * HD;              // (C, P) each
  float* ks = rs + C * P;
  float* vs = ks + C * P;
  float* cum = vs + C * P;
  float* cp = cum + C * P;
  float* rdec = cp + C * P;
  float* kdec = rdec + C * P;
  float* att = kdec + C * P;            // (C, C + 1)
  float* tot = att + C * (C + 1);       // (HD)
  float* us = tot + HD;                 // (HD)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int hh = bh - b * a.H;
  const int T = a.T;
  const int64_t row = (int64_t)a.H * HD;           // stride of t in r, k, ...
  const int64_t head0 = (int64_t)b * T * row + (int64_t)hh * HD;
  const int64_t sbase = (int64_t)bh * HD * HD;

  for (int e = tid; e < HD * HD; e += NT)
    S[e] = a.s0 ? a.s0[sbase + e] : 0.f;
  for (int i = tid; i < HD; i += NT) us[i] = a.u[hh * HD + i];

  const int j = tid % HD;
  const int g0 = tid / HD;
  for (int c0 = 0; c0 < T; c0 += C) {
    const int n = min(C, T - c0);
    __syncthreads();                    // the last chunk's readers are done
    for (int e = tid; e < C * HD; e += NT) {
      const int t = e / HD, i = e - (e / HD) * HD;
      const int o = t * P + i;
      if (t < n) {
        const int64_t g = head0 + (int64_t)(c0 + t) * row + i;
        rs[o] = a.r[g];
        ks[o] = a.k[g];
        vs[o] = a.v[g];
        cum[o] = logf(fminf(fmaxf(a.w[g], 1e-12f), 1.f));
      } else {
        rs[o] = 0.f; ks[o] = 0.f; vs[o] = 0.f; cum[o] = 0.f;
      }
    }
    __syncthreads();
    // inclusive and exclusive cumulative log-decay, one channel a thread
    for (int i = tid; i < HD; i += NT) {
      float c = 0.f;
      for (int t = 0; t < C; ++t) {
        const float l = cum[t * P + i];
        c += l;
        cum[t * P + i] = c;
        cp[t * P + i] = c - l;
      }
      tot[i] = c;
    }
    __syncthreads();
    for (int e = tid; e < C * HD; e += NT) {
      const int t = e / HD, i = e - (e / HD) * HD;
      const int o = t * P + i;
      rdec[o] = rs[o] * expf(cp[o]);
      kdec[o] = ks[o] * expf(tot[i] - cum[o]);
    }
    // pair scores, strictly causal, with the bonus on the diagonal
    for (int p = tid; p < C * C; p += NT) {
      const int t = p / C, s = p - (p / C) * C;
      float x = 0.f;
      if (s < t) {
        const float* rt = rs + t * P;
        const float* ct = cp + t * P;
        const float* kk = ks + s * P;
        const float* cs = cum + s * P;
#pragma unroll 8
        for (int i = 0; i < HD; ++i)
          x = fmaf(rt[i] * kk[i], expf(ct[i] - cs[i]), x);
      } else if (s == t) {
        const float* rt = rs + t * P;
        const float* kk = ks + t * P;
#pragma unroll 8
        for (int i = 0; i < HD; ++i) x = fmaf(rt[i] * us[i], kk[i], x);
      }
      att[t * (C + 1) + s] = x;
    }
    __syncthreads();
    // y = (r * exp(cum_prev)) @ S + att @ v
    float acc[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) acc[q] = 0.f;
    for (int i = 0; i < HD; ++i) {
      const float sij = S[i * HD + j];
#pragma unroll
      for (int q = 0; q < ROWS; ++q)
        acc[q] = fmaf(rdec[(g0 + q * TS) * P + i], sij, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int t = g0 + q * TS;
      const float* at = att + t * (C + 1);
      float x = acc[q];
      for (int s = 0; s <= t; ++s) x = fmaf(at[s], vs[s * P + j], x);
      if (t < n) a.y[head0 + (int64_t)(c0 + t) * row + j] = x;
    }
    __syncthreads();                    // every read of S is done
    // S = diag(exp(total)) S + (k * exp(total - cum))^T @ v
#pragma unroll
    for (int q = 0; q < SROWS; ++q) {
      const int i = g0 + q * TS;
      float x = expf(tot[i]) * S[i * HD + j];
      for (int s = 0; s < C; ++s) x = fmaf(kdec[s * P + i], vs[s * P + j], x);
      S[i * HD + j] = x;
    }
  }
  __syncthreads();
  for (int e = tid; e < HD * HD; e += NT) a.s_out[sbase + e] = S[e];
}

template <int HD>
static int launch(const WkvArgs& a, int B, cudaStream_t st) {
  constexpr int smem = WkvSmem<HD>::bytes;
  auto kern = wkv6_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)(B * a.H), WKV_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// r, k, v, w, y: contiguous (B, T, H, hd) float32; u: contiguous (H, hd);
// s0 (null for zeros) and s_out: contiguous (B, H, hd, hd) float32.
extern "C" int wkv6(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* s0,
                    float* y, float* s_out, int B, int T, int H, int hd,
                    void* stream) {
  if (B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  WkvArgs a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.u = u; a.s0 = s0;
  a.y = y; a.s_out = s_out; a.T = T; a.H = H;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(a, B, st);
    case 32: return launch<32>(a, B, st);
    case 64: return launch<64>(a, B, st);
    case 128: return launch<128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
