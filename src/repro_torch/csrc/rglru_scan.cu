// rglru_scan: the RG-LRU linear recurrence over time,
//
//   h_t = a_t * h_{t-1} + b_t        (forward,  t = 0 .. T-1, h_{-1} = h0)
//   h_t = a_t * h_{t+1} + b_t        (reverse,  t = T-1 .. 0, h_T = h0)
//
// for a, b, h (B, T, R) float32 and h0 (B, R) float32 or null (zeros).
// The reverse form is the adjoint scan of the backward pass: given a_next
// (a shifted one step left) and the upstream gradient as b, it yields
// g_t = dout_t + a_{t+1} g_{t+1} without flipping any tensor.
//
// Replaces the TPU kernel repro/kernels/rglru_scan/kernel.py:51
// rglru_scan_tiles. That kernel tiled R into (block_t, block_r) VMEM panels
// and carried h in VMEM scratch across a sequential T-block grid axis.
// Here blocks run in no order, so nothing is carried between them: one
// thread owns one (b, r) channel for the whole sequence and keeps h in a
// register. Neighbouring threads take neighbouring r, so every load of a
// time step is one coalesced row segment. T = 1, ragged R and a missing h0
// need no padding.
//
// Bound on an H100 SXM: memory. The scan reads a and b and writes h once,
// 3*B*T*R*4 bytes, plus h0, B*R*4, where one is given: 125,829,120 B, about
// 0.0376 ms, at the prefill shape (4, 1024, 2560, no h0) over 3.35 TB/s.
// Its work is one FMA per element, far below the FMA rate. At that shape
// only B*R = 10,240 channels exist, so at most 10,240 threads stream the
// data; each thread's loads of the next steps are issued together (UNROLL
// steps at a time) so that several are in flight, but that many threads
// cannot keep the memory system busy, and the kernel stays above its bound
// at this width (PERF.md has the times). Splitting T across threads (a
// two-pass chunked scan) is later work.
//
// It launches on the caller's stream, allocates nothing and synchronises
// nothing; rglru_scan returns cudaGetLastError() after the launch.
#include <cstdint>
#include <cuda_runtime.h>

#define RGLRU_THREADS 64
#define RGLRU_UNROLL 8

__global__ void __launch_bounds__(RGLRU_THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int T, int R, int64_t channels, int reverse) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  const int64_t bi = c / R;
  const int64_t r = c - bi * R;
  const int64_t base = bi * (int64_t)T * R + r;
  const int64_t step = reverse ? -(int64_t)R : (int64_t)R;
  int64_t off = base + (reverse ? (int64_t)(T - 1) * R : 0);
  float acc = h0 ? h0[c] : 0.f;
  int t = 0;
  for (; t + RGLRU_UNROLL <= T; t += RGLRU_UNROLL) {
    float av[RGLRU_UNROLL], bv[RGLRU_UNROLL];
#pragma unroll
    for (int u = 0; u < RGLRU_UNROLL; ++u) {
      av[u] = a[off + u * step];
      bv[u] = b[off + u * step];
    }
#pragma unroll
    for (int u = 0; u < RGLRU_UNROLL; ++u) {
      acc = fmaf(av[u], acc, bv[u]);
      h[off + u * step] = acc;
    }
    off += RGLRU_UNROLL * step;
  }
  for (; t < T; ++t) {
    acc = fmaf(a[off], acc, b[off]);
    h[off] = acc;
    off += step;
  }
}

// a, b, h: contiguous (B, T, R) float32; h0: contiguous (B, R) float32 or
// null. reverse != 0 scans from t = T-1 down to 0.
extern "C" int rglru_scan(const float* a, const float* b, const float* h0,
                          float* h, int B, int T, int R, int reverse,
                          void* stream) {
  if (B < 1 || T < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int64_t channels = (int64_t)B * R;
  const int64_t blocks = (channels + RGLRU_THREADS - 1) / RGLRU_THREADS;
  rglru_scan_kernel<<<(unsigned)blocks, RGLRU_THREADS, 0,
                      (cudaStream_t)stream>>>(a, b, h0, h, T, R, channels,
                                              reverse);
  return (int)cudaGetLastError();
}
