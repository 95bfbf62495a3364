// flash_attention_bwd: the backward of GQA flash attention, recomputed
// from the forward's log-sum-exp (no (T, S) residuals kept).
//
//   s     = scale * q . k            masked to MASK_VALUE as in the forward
//   p     = exp(s - lse)
//   dp    = dout . v
//   ds    = p * (dp - delta) * scale,     delta = rowsum(dout * out)
//   dq    = ds . k
//   dk    = ds^T . q     summed over the G query heads of each kv head
//   dv    = p^T . dout   likewise
//
// q, dout, dq (B,T,H,D); k, v, dk, dv (B,S,KH,D), all of one type (float32
// or bf16); lse and delta (B,H,T) float32, delta computed by the caller.
// Masks: causal (kpos <= qpos), local window (kpos > qpos - window) and
// padding (kpos < seq_k), with the finite MASK_VALUE -1e30, so a masked
// score gives p = exp(-1e30 - lse) = 0 exactly. No softcap: its tanh
// derivative stays out of the kernel, as in the reference, and the caller
// takes the plain version's autograd for it.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel_bwd.py:130
// flash_attention_bwd (_dq_kernel, _dkv_kernel, _tile_p_ds). There each
// kernel's last grid axis ran in order on one core and carried dq, or dk
// and dv, in VMEM scratch; dk and dv came out per query head, (B,S,H,D),
// and the caller summed each GQA group. Here blocks run in no order, so
// each CTA owns its output tile and loops itself:
//  * flash_bwd_dq_kernel, grid (T/BQ, H, B): one CTA per (b, h, q-tile)
//    stages q (scaled) and dout, holds its rows' lse and delta in
//    registers and walks the kv tiles, accumulating dq in registers;
//  * flash_bwd_dkv_kernel, grid (S/BK, KH, B): one CTA per (b, kv-head,
//    k-tile) stages k and v once and walks the G query heads of its group
//    and, for each, the q tiles that can see the tile, accumulating dk and
//    dv in registers. They are written once, already summed over the
//    group: deterministic, no atomics, and no (B,S,H,D) intermediate G
//    times larger than the result.
// Tiles wholly above the diagonal, below the window or in the padding are
// skipped, as in the TPU kernel. Ragged T and S are taken as they are:
// rows past T or S are staged as zeros, masked, and never written.
//
// Bound on an H100 SXM: at the serve shape (B=4, T=S=1024, H=32, KH=8,
// D=64, bf16, causal) the five products need 10*D FLOP per unmasked
// (q, k) pair, 43 GFLOP, about 43 us at 989 TFLOP/s on the tensor cores,
// against about 85 MB (q, k, v, out, dout, dq, dk, dv, lse, delta once),
// about 25 us at 3.35 TB/s: operations. At the train shape (B=4, T=256,
// H=12, KH=4) it is bytes, about 2.5 us. This first design does not reach
// the bound: the two kernels recompute s and dp each (14*D FLOP a pair)
// as float32 FMAs on the CUDA cores (67 TFLOP/s at most), which the
// float32 tolerance (2e-4) asks for, and read their operands from shared
// memory. wgmma, TMA and warp specialisation come later.
//
// Design, as in flash_attention_fwd.cu: 128 threads as 16 x 8 (ty, tx);
// thread (ty, tx) owns rows ty + 16*i and columns tx + 8*j of the score
// tile, and output columns 4*tx + 32*g. Operand tiles live in float32
// dynamic shared memory with rows padded by 4 floats for conflict-free
// 16-byte reads; p and ds go through shared memory to the products that
// contract over the score tile. D is a template parameter in {64, 128,
// 256}, with tiles that keep registers and shared memory in bounds (32
// and 16 rows at D = 256), the element type float or bf16.
// Both kernels launch on the caller's stream, allocate nothing and
// synchronise nothing; flash_attention_bwd returns cudaGetLastError().
#include "flash_common.cuh"

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  // (b, t, h) element strides of q, k, v, dout, dq, dk, dv
  int64_t s[7][3];
  int T, S, H, group, seq_k, window;
  int causal, has_window;
  float scale;
};

enum { IQ = 0, IK = 1, IV = 2, IDO = 3, IDQ = 4, IDK = 5, IDV = 6 };

template <typename T>
__device__ __forceinline__ const T* at(const BwdArgs& a, const void* base,
                                       int which, int b, int t, int h) {
  return static_cast<const T*>(base) + b * a.s[which][0] +
         t * a.s[which][1] + h * a.s[which][2];
}

template <typename T>
__device__ __forceinline__ T* at_out(const BwdArgs& a, void* base, int which,
                                     int b, int t, int h) {
  return static_cast<T*>(base) + b * a.s[which][0] + t * a.s[which][1] +
         h * a.s[which][2];
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int qpos,
                                        int kpos) {
  bool ok = kpos < a.seq_k && qpos < a.T;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.has_window) ok = ok && kpos > qpos - a.window;
  return ok;
}

// whether a (q-tile, k-tile) pair holds any visible score: the reference's
// whole-tile skips (kernel_bwd.py:60-65)
__device__ __forceinline__ bool tile_runs(const BwdArgs& a, int q0, int bq,
                                          int k0, int bk) {
  bool run = k0 < a.seq_k;
  if (a.causal) run = run && k0 <= q0 + bq - 1;
  if (a.has_window) run = run && k0 + bk - 1 > q0 - a.window;
  return run;
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int NT = 128, TX = 8, TY = 16;
  constexpr int RM = BQ / TY;   // query rows per thread
  constexpr int RN = BK / TX;   // key columns per thread
  constexpr int OG = D / 32;    // groups of 4 output columns per thread
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x LD, times scale
  float* DOs = Qs + BQ * LD;                     // BQ x LD
  float* Ks = DOs + BQ * LD;                     // BK x LD
  float* Vs = Ks + BK * LD;                      // BK x LD
  float* DSs = Vs + BK * LD;                     // BQ x LDP

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.group;
  const int qvalid = min(BQ, a.T - q0);

  stage<T, D, NT>(Qs, LD, at<T>(a, a.q, IQ, b, q0, h), a.s[IQ][1], BQ, qvalid,
                  a.scale);
  stage<T, D, NT>(DOs, LD, at<T>(a, a.dout, IDO, b, q0, h), a.s[IDO][1], BQ,
                  qvalid, 1.f);
  float lse[RM], dlt[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = q0 + ty + TY * i;
    const int64_t r = ((int64_t)b * a.H + h) * a.T + t;
    lse[i] = t < a.T ? a.lse[r] : 0.f;
    dlt[i] = t < a.T ? a.delta[r] : 0.f;
  }
  float acc[RM][4 * OG];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * OG; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < a.S; k0 += BK) {
    if (!tile_runs(a, q0, BQ, k0, BK)) continue;  // uniform over the CTA
    const int kvalid = min(BK, a.S - k0);
    __syncthreads();  // the previous tile's reads of Ks, Vs, DSs are done
    stage<T, D, NT>(Ks, LD, at<T>(a, a.k, IK, b, k0, kh), a.s[IK][1], BK,
                    kvalid, 1.f);
    stage<T, D, NT>(Vs, LD, at<T>(a, a.v, IV, b, k0, kh), a.s[IV][1], BK,
                    kvalid, 1.f);
    __syncthreads();

    float s[RM][RN], dp[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], kv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * LD + d);
#pragma unroll
      for (int j = 0; j < RN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + TX * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 ov[RM], vv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        ov[i] = *reinterpret_cast<const float4*>(DOs + (ty + TY * i) * LD + d);
#pragma unroll
      for (int j = 0; j < RN; ++j)
        vv[j] = *reinterpret_cast<const float4*>(Vs + (tx + TX * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) dp[i][j] = dot4(ov[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int kpos = k0 + tx + TX * j;
        const float x = visible(a, qpos, kpos) ? s[i][j] : MASK_VALUE;
        const float p = expf(x - lse[i]);
        DSs[(ty + TY * i) * LDP + tx + TX * j] =
            p * (dp[i][j] - dlt[i]) * a.scale;
      }
    }
    __syncthreads();  // ds is complete

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 ds4[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        ds4[i] = *reinterpret_cast<const float4*>(DSs + (ty + TY * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* krow = Ks + (j + jj) * LD + 4 * tx;
#pragma unroll
        for (int g = 0; g < OG; ++g) {
          const float4 kk = *reinterpret_cast<const float4*>(krow + 32 * g);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float ds = comp(ds4[i], jj);
            acc[i][4 * g + 0] = fmaf(ds, kk.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(ds, kk.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(ds, kk.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(ds, kk.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = q0 + ty + TY * i;
    if (t >= a.T) continue;
    T* row = at_out<T>(a, a.dq, IDQ, b, t, h);
#pragma unroll
    for (int g = 0; g < OG; ++g)
      Elem<T>::store4(row + 4 * tx + 32 * g, acc[i][4 * g],
                      acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
  }
}

template <typename T, int D, int BK, int BQ>
__global__ void __launch_bounds__(128)
    flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int NT = 128, TX = 8, TY = 16;
  constexpr int RM = BK / TY;   // key rows per thread
  constexpr int RN = BQ / TX;   // query columns per thread
  constexpr int OG = D / 32;
  constexpr int LD = D + 4;
  constexpr int LDP = BQ + 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // BK x LD
  float* Vs = Ks + BK * LD;                      // BK x LD
  float* Qs = Vs + BK * LD;                      // BQ x LD, unscaled
  float* DOs = Qs + BQ * LD;                     // BQ x LD
  float* Ps = DOs + BQ * LD;                     // BK x LDP
  float* DSs = Ps + BK * LDP;                    // BK x LDP
  float* Ls = DSs + BK * LDP;                    // BQ
  float* Dl = Ls + BQ;                           // BQ

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK;   // early k tiles see the most q tiles
  const int kh = blockIdx.y, b = blockIdx.z;
  const int kvalid = min(BK, a.S - k0);

  stage<T, D, NT>(Ks, LD, at<T>(a, a.k, IK, b, k0, kh), a.s[IK][1], BK, kvalid,
                  1.f);
  stage<T, D, NT>(Vs, LD, at<T>(a, a.v, IV, b, k0, kh), a.s[IV][1], BK, kvalid,
                  1.f);
  float dk[RM][4 * OG], dv[RM][4 * OG];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * OG; ++c) dk[i][c] = dv[i][c] = 0.f;

  // under a causal mask no q tile before the one holding k0 sees the tile
  const int qstart = a.causal ? (k0 / BQ) * BQ : 0;
  for (int g = 0; g < a.group; ++g) {
    const int h = kh * a.group + g;
    for (int q0 = qstart; q0 < a.T; q0 += BQ) {
      if (!tile_runs(a, q0, BQ, k0, BK)) continue;  // uniform over the CTA
      const int qvalid = min(BQ, a.T - q0);
      __syncthreads();  // the previous q tile's reads are done
      stage<T, D, NT>(Qs, LD, at<T>(a, a.q, IQ, b, q0, h), a.s[IQ][1], BQ,
                      qvalid, 1.f);
      stage<T, D, NT>(DOs, LD, at<T>(a, a.dout, IDO, b, q0, h), a.s[IDO][1],
                      BQ, qvalid, 1.f);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const int64_t idx = ((int64_t)b * a.H + h) * a.T + q0 + r;
        Ls[r] = r < qvalid ? a.lse[idx] : 0.f;
        Dl[r] = r < qvalid ? a.delta[idx] : 0.f;
      }
      __syncthreads();

      float s[RM][RN], dp[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 kv[RM], qv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          kv[i] = *reinterpret_cast<const float4*>(Ks + (ty + TY * i) * LD + d);
#pragma unroll
        for (int j = 0; j < RN; ++j)
          qv[j] = *reinterpret_cast<const float4*>(Qs + (tx + TX * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) s[i][j] = dot4(kv[i], qv[j], s[i][j]);
      }
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 vv[RM], ov[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          vv[i] = *reinterpret_cast<const float4*>(Vs + (ty + TY * i) * LD + d);
#pragma unroll
        for (int j = 0; j < RN; ++j)
          ov[j] = *reinterpret_cast<const float4*>(DOs + (tx + TX * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) dp[i][j] = dot4(vv[i], ov[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int kpos = k0 + ty + TY * i;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int c = tx + TX * j;
          const float x =
              visible(a, q0 + c, kpos) ? s[i][j] * a.scale : MASK_VALUE;
          const float p = expf(x - Ls[c]);
          Ps[(ty + TY * i) * LDP + c] = p;
          DSs[(ty + TY * i) * LDP + c] = p * (dp[i][j] - Dl[c]) * a.scale;
        }
      }
      __syncthreads();  // p and ds are complete

#pragma unroll 2
      for (int j = 0; j < BQ; j += 4) {
        float4 p4[RM], d4[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + TY * i) * LDP + j);
          d4[i] = *reinterpret_cast<const float4*>(DSs + (ty + TY * i) * LDP + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* qrow = Qs + (j + jj) * LD + 4 * tx;
          const float* orow = DOs + (j + jj) * LD + 4 * tx;
#pragma unroll
          for (int gg = 0; gg < OG; ++gg) {
            const float4 qq = *reinterpret_cast<const float4*>(qrow + 32 * gg);
            const float4 oo = *reinterpret_cast<const float4*>(orow + 32 * gg);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              const float p = comp(p4[i], jj), ds = comp(d4[i], jj);
              dv[i][4 * gg + 0] = fmaf(p, oo.x, dv[i][4 * gg + 0]);
              dv[i][4 * gg + 1] = fmaf(p, oo.y, dv[i][4 * gg + 1]);
              dv[i][4 * gg + 2] = fmaf(p, oo.z, dv[i][4 * gg + 2]);
              dv[i][4 * gg + 3] = fmaf(p, oo.w, dv[i][4 * gg + 3]);
              dk[i][4 * gg + 0] = fmaf(ds, qq.x, dk[i][4 * gg + 0]);
              dk[i][4 * gg + 1] = fmaf(ds, qq.y, dk[i][4 * gg + 1]);
              dk[i][4 * gg + 2] = fmaf(ds, qq.z, dk[i][4 * gg + 2]);
              dk[i][4 * gg + 3] = fmaf(ds, qq.w, dk[i][4 * gg + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = k0 + ty + TY * i;
    if (t >= a.S) continue;
    T* krow = at_out<T>(a, a.dk, IDK, b, t, kh);
    T* vrow = at_out<T>(a, a.dv, IDV, b, t, kh);
#pragma unroll
    for (int g = 0; g < OG; ++g) {
      Elem<T>::store4(krow + 4 * tx + 32 * g, dk[i][4 * g], dk[i][4 * g + 1],
                      dk[i][4 * g + 2], dk[i][4 * g + 3]);
      Elem<T>::store4(vrow + 4 * tx + 32 * g, dv[i][4 * g], dv[i][4 * g + 1],
                      dv[i][4 * g + 2], dv[i][4 * g + 3]);
    }
  }
}

// BQ x BK: the dq kernel's tiles; KBK x KBQ: the dkv kernel's
template <typename T, int D, int BQ, int BK, int KBK, int KBQ>
static int launch(const BwdArgs& a, int B, int KH, cudaStream_t st) {
  constexpr int ld = D + 4;
  constexpr int smem_dq = (int)sizeof(float) * (2 * (BQ + BK) * ld +
                                                BQ * (BK + 8));
  constexpr int smem_dkv = (int)sizeof(float) * (2 * (KBK + KBQ) * ld +
                                                 2 * KBK * (KBQ + 8) + 2 * KBQ);
  auto dq_kern = flash_bwd_dq_kernel<T, D, BQ, BK>;
  auto dkv_kern = flash_bwd_dkv_kernel<T, D, KBK, KBQ>;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (e != cudaSuccess) return (int)e;
  dim3 gq((unsigned)((a.T + BQ - 1) / BQ), (unsigned)a.H, (unsigned)B);
  dq_kern<<<gq, 128, smem_dq, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gk((unsigned)((a.S + KBK - 1) / KBK), (unsigned)KH, (unsigned)B);
  dkv_kern<<<gk, 128, smem_dkv, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const BwdArgs& a, int B, int KH, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64, 64, 64, 64, 64>(a, B, KH, st);
    case 128: return launch<T, 128, 64, 64, 32, 64>(a, B, KH, st);
    case 256: return launch<T, 256, 32, 32, 16, 32>(a, B, KH, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16. strides: 21 element strides, (b, t, h) of
// q, k, v, dout, dq, dk, dv. window <= 0 means none.
extern "C" int flash_attention_bwd(int dtype, int B, int T, int S, int H,
                                   int KH, int D, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, void* dk, void* dv,
                                   const int64_t* strides, float scale,
                                   int causal, int window, int seq_k,
                                   void* stream) {
  if (B < 1 || T < 1 || S < 1 || KH < 1 || H % KH != 0 || seq_k > S)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) a.s[i][j] = strides[3 * i + j];
  a.T = T; a.S = S; a.H = H; a.group = H / KH; a.seq_k = seq_k;
  a.causal = causal != 0;
  a.has_window = window > 0;
  a.window = window;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(a, B, KH, D, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, KH, D, st);
  return (int)cudaErrorInvalidValue;
}
