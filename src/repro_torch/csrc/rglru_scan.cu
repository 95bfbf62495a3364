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
//
// Bound on an H100 SXM: memory. The scan reads a and b and writes h once,
// 3*B*T*R*4 bytes, plus h0, B*R*4, where one is given: 125,829,120 B, about
// 0.0376 ms, at the prefill shape (4, 1024, 2560, no h0) over 3.35 TB/s.
// Its work is about two FMAs an element, far below the FMA rate. To reach
// the bytes the card needs many loads in flight on every SM. The first
// port gave one thread a whole channel, so the prefill shape had only
// B*R = 10,240 threads (2.4 warps an SM) with 8 steps in flight each, and
// sat at 2.6x the bound. This design splits T across the warps of a CTA:
//  * a CTA owns 32 neighbouring channels (one coalesced 128-byte row
//    segment a step) and up to RGLRU_WARPS warps along T; T is walked in
//    windows of warps * RGLRU_SEG steps, each warp taking RGLRU_SEG steps
//    of a window. At the prefill shape: 320 CTAs of 8 warps, about 19 warps
//    an SM, every thread with the next window's 16 loads in flight while
//    it works on this one;
//  * in a window each warp scans its steps from zero to (A = prod a,
//    H = local h), the CTA shares them through shared memory, each warp
//    takes its carry-in by folding the window's carry with the (A, H) of
//    the warps before it, then runs the exact recurrence over its steps
//    again from that carry and writes h once; the last warp's final h is
//    the next window's carry. a and b are read once, h written once; no
//    workspace and nothing between CTAs, so the kernel is one launch.
//    Its loads and stores alone take as long as the whole kernel
//    (scripts/rs_rglru_ablation.py): the scan hides behind them, and what
//    is left of the gap to the bound is the rate this access pattern
//    streams at.
// Folding (A, H) reassociates the recurrence at warp boundaries only (the
// plain version reassociates at every doubling step); inside a warp's
// steps the recurrence runs in order, one fmaf a step.
// Cross-CTA look-back (CTAs along T) would add a flag workspace to zero or
// tag every call for no byte saved: at the path's shapes the channels
// alone fill the card once T is split inside a CTA.
// T <= RGLRU_SEG (decode: T = 1) is one segment: rglru_scan_short_kernel,
// a thread a channel in CTAs of RGLRU_SHORT, runs the recurrence from h0
// with no shared memory and no barrier, as the first port did (through
// the windowed kernel, with its barriers and the carry's round trip
// through shared memory, T = 1 was slower than the first port). Ragged R,
// any T and a missing h0 need no padding: steps
// past T are the identity (a = 1, b = 0) and are not stored. One launch a
// call either way.
//
// It launches on the caller's stream, allocates nothing and synchronises
// nothing; rglru_scan returns cudaGetLastError() after the launch.
#include <cstdint>
#include <cuda_runtime.h>

#define RGLRU_SEG 8      // steps a warp takes of each window
#define RGLRU_WARPS 8    // most warps of a CTA along T
#define RGLRU_LANES 32   // channels of a CTA
#define RGLRU_SHORT 64   // channels of a CTA where T <= RGLRU_SEG

__global__ void __launch_bounds__(RGLRU_SHORT)
rglru_scan_short_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ h0, float* __restrict__ h,
                        int T, int R, int64_t channels, int reverse) {
  const int64_t c = (int64_t)blockIdx.x * RGLRU_SHORT + threadIdx.x;
  if (c >= channels) return;
  const int64_t bi = c / R;
  const int64_t base = bi * (int64_t)T * R + (c - bi * R);
  const int64_t stride = reverse ? -(int64_t)R : (int64_t)R;
  const int64_t first = reverse ? (int64_t)(T - 1) * R : 0;
  float x = h0 ? h0[c] : 0.f;
#pragma unroll
  for (int t = 0; t < RGLRU_SEG; ++t) {
    if (t < T) {
      const int64_t off = base + first + t * stride;
      x = fmaf(a[off], x, b[off]);
      h[off] = x;
    }
  }
}

__global__ void __launch_bounds__(RGLRU_LANES * RGLRU_WARPS)
rglru_scan_chunk_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ h0, float* __restrict__ h,
                        int T, int R, int64_t channels, int reverse) {
  __shared__ float sA[RGLRU_WARPS][RGLRU_LANES];
  __shared__ float sH[RGLRU_WARPS][RGLRU_LANES];
  __shared__ float carry[RGLRU_LANES];
  const int lane = threadIdx.x, k = threadIdx.y, warps = blockDim.y;
  const int64_t c = (int64_t)blockIdx.x * RGLRU_LANES + lane;
  const bool live = c < channels;
  const int64_t bi = live ? c / R : 0;
  const int64_t base = bi * (int64_t)T * R + (live ? c - bi * R : 0);
  // logical step t lies at base + first + t * stride
  const int64_t stride = reverse ? -(int64_t)R : (int64_t)R;
  const int64_t first = reverse ? (int64_t)(T - 1) * R : 0;
  if (k == 0) carry[lane] = (live && h0) ? h0[c] : 0.f;

  const int window = warps * RGLRU_SEG;
  float an[RGLRU_SEG], bn[RGLRU_SEG];
  auto load = [&](int t0) {  // this warp's steps of the window at t0
#pragma unroll
    for (int u = 0; u < RGLRU_SEG; ++u) {
      const int t = t0 + k * RGLRU_SEG + u;
      const bool ok = live && t < T;
      const int64_t off = base + first + t * stride;
      an[u] = ok ? a[off] : 1.f;
      bn[u] = ok ? b[off] : 0.f;
    }
  };
  load(0);
  for (int t0 = 0; t0 < T; t0 += window) {
    float av[RGLRU_SEG], bv[RGLRU_SEG];
#pragma unroll
    for (int u = 0; u < RGLRU_SEG; ++u) {
      av[u] = an[u];
      bv[u] = bn[u];
    }
    if (t0 + window < T) load(t0 + window);

    float A = 1.f, H = 0.f;
#pragma unroll
    for (int u = 0; u < RGLRU_SEG; ++u) {
      H = fmaf(av[u], H, bv[u]);
      A *= av[u];
    }
    sA[k][lane] = A;
    sH[k][lane] = H;
    __syncthreads();
    float x = carry[lane];
    for (int j = 0; j < k; ++j) x = fmaf(sA[j][lane], x, sH[j][lane]);
#pragma unroll
    for (int u = 0; u < RGLRU_SEG; ++u) {
      x = fmaf(av[u], x, bv[u]);
      const int t = t0 + k * RGLRU_SEG + u;
      if (live && t < T) h[base + first + t * stride] = x;
    }
    __syncthreads();  // every warp has read carry, sA and sH
    if (k == warps - 1) carry[lane] = x;  // read after the next barrier
  }
}

// a, b, h: contiguous (B, T, R) float32; h0: contiguous (B, R) float32 or
// null. reverse != 0 scans from t = T-1 down to 0.
extern "C" int rglru_scan(const float* a, const float* b, const float* h0,
                          float* h, int B, int T, int R, int reverse,
                          void* stream) {
  if (B < 1 || T < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int64_t channels = (int64_t)B * R;
  int warps = 1;  // the fewest warps whose segments cover T, up to the most
  while (warps < RGLRU_WARPS && warps * RGLRU_SEG < T) warps *= 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (warps == 1)
    rglru_scan_short_kernel<<<(unsigned)((channels + RGLRU_SHORT - 1) /
                                         RGLRU_SHORT),
                              RGLRU_SHORT, 0, st>>>(a, b, h0, h, T, R,
                                                    channels, reverse);
  else
    rglru_scan_chunk_kernel<<<(unsigned)((channels + RGLRU_LANES - 1) /
                                         RGLRU_LANES),
                              dim3(RGLRU_LANES, warps), 0, st>>>(
        a, b, h0, h, T, R, channels, reverse);
  return (int)cudaGetLastError();
}
