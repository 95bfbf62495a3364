// flash_attention_fwd: online-softmax GQA attention, forward only.
//
//   out[b,t,h,:] = softmax_s(mask(softcap(scale * q[b,t,h,:] . k[b,s,kh,:])))
//                  @ v[b,:,kh,:],      kh = h / (H / KH)
//   lse[b,h,t]   = m + log(l)          (float32)
//
// q (B,T,H,D), k and v (B,S,KH,D), out (B,T,H,D) in q's type, lse (B,H,T).
// Masks: causal (kpos <= qpos), local window (kpos > qpos - window), tanh
// logit softcap, and padding (kpos < seq_k). The running max starts at the
// finite MASK_VALUE -1e30, not -inf, and masked scores take that value: a
// row whose first visited tile is fully masked accumulates exp(0) terms
// that the next rescaling by exp(-1e30 - m) erases exactly, where -inf
// would give NaN from (-inf) - (-inf). Results are the reference's.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:101
// flash_attention_fwd (_fwd_kernel). There the kv grid axis ran in order
// on one core and carried m, l and the accumulator in VMEM scratch from
// one grid step to the next. Here one CTA owns one (b, h, q-tile) and
// walks the kv tiles in a loop; m and l live in registers, replicated over
// the 8 threads that share a query row, and the accumulator in registers.
//
// Bound on an H100 SXM: operations. At the serve shape (B=4, T=S=1024,
// H=32, KH=8, D=64, bf16, causal) the two products need 17.2 GFLOP, about
// 17 us at 989 TFLOP/s on the tensor cores, against about 42 MB of q, k,
// v, out and lse, about 13 us at 3.35 TB/s. This first design does not
// reach that bound: it runs both products as float32 FMAs on the CUDA
// cores (67 TFLOP/s at most), so it is bound by the FMA rate and by
// shared-memory reads, some forty times the tensor-core bound. It is
// simple and right first; wgmma, TMA and warp specialisation come later.
//
// Design:
//  * grid (T/BQ, H, B), 128 threads. q tiles run heaviest-first (the
//    causal diagonal makes late tiles longer). Tensors are read in place
//    through their strides (last dimension contiguous, rows 16-byte
//    aligned), with no transposes: the kv head of query head h is h/G.
//  * the CTA stages its q tile once (scaled, as float32) and then each kv
//    tile, first k and then v into the same buffer, all float32 in dynamic
//    shared memory (above 48 KB, so cudaFuncSetAttribute raises the cap).
//    Rows are padded by 4 or 8 floats so that the 16-byte reads below hit
//    distinct banks.
//  * thread (ty, tx), ty in 0..15, tx in 0..7, owns query rows ty + 16*i
//    and key columns tx + 8*j of the score tile, and output columns
//    4*tx + 32*g; row max and row sum reduce over the 8 tx lanes with
//    shuffles. p goes through shared memory to the p.v product.
//  * kv tiles wholly above the diagonal, below the window or in the
//    padding are skipped, as in the TPU kernel.
//  * D is a template parameter in {64, 128, 256} (BQ = BK = 64, and 32 at
//    D = 256 to bound registers and shared memory), the element type
//    float or bf16; arithmetic is float32 throughout.
// It launches on the caller's stream, allocates nothing and synchronises
// nothing; flash_attention_fwd returns cudaGetLastError() after the launch.
#include "flash_common.cuh"

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int64_t sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh;
  int T, S, H, group, seq_k, window;
  int causal, has_window, has_softcap;
  float scale, softcap;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(128)
    flash_fwd_kernel(const FlashArgs a) {
  constexpr int NT = 128, TX = 8, TY = 16;
  constexpr int RM = BQ / TY;   // query rows per thread
  constexpr int RN = BK / TX;   // key columns per thread
  constexpr int OG = D / 32;    // groups of 4 output columns per thread
  constexpr int LDQ = D + 4;
  constexpr int LDP = BK + 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + BQ * LDQ;
  float* Ps = KVs + BK * LDQ;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.group;
  const T* qb = static_cast<const T*>(a.q) + b * a.sqb + q0 * a.sqt + h * a.sqh;
  const T* kb = static_cast<const T*>(a.k) + b * a.skb + kh * a.skh;
  const T* vb = static_cast<const T*>(a.v) + b * a.svb + kh * a.svh;

  stage<T, D, NT>(Qs, LDQ, qb, a.sqt, BQ, min(BQ, a.T - q0), a.scale);

  float m[RM], l[RM], o[RM][4 * OG];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * OG; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < a.S; k0 += BK) {
    // whole-tile skips: padding, above the diagonal, below the window
    bool run = k0 < a.seq_k;
    if (a.causal) run = run && k0 <= q0 + BQ - 1;
    if (a.has_window) run = run && k0 + BK - 1 > q0 - a.window;
    if (!run) continue;  // uniform over the CTA

    __syncthreads();  // the previous tile's p.v reads are done
    stage<T, D, NT>(KVs, LDQ, kb + k0 * a.skt, a.skt, BK, min(BK, a.S - k0),
                    1.f);
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], kv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < RN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + TX * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + TY * i;
      float mc = MASK_VALUE;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int kpos = k0 + tx + TX * j;
        float x = s[i][j];
        if (a.has_softcap) x = tanhf(x / a.softcap) * a.softcap;
        bool ok = kpos < a.seq_k;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.has_window) ok = ok && kpos > qpos - a.window;
        x = ok ? x : MASK_VALUE;
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 4));
      const float mn = fmaxf(m[i], mc);
      const float corr = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        Ps[(ty + TY * i) * LDP + tx + TX * j] = p;
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4 * OG; ++c) o[i][c] *= corr;
    }

    __syncthreads();  // p is complete and the k reads are done
    stage<T, D, NT>(KVs, LDQ, vb + k0 * a.svt, a.svt, BK, min(BK, a.S - k0),
                    1.f);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + TY * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = KVs + (j + jj) * LDQ + 4 * tx;
#pragma unroll
        for (int g = 0; g < OG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 32 * g);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = comp(pv[i], jj);
            o[i][4 * g + 0] = fmaf(p, vv.x, o[i][4 * g + 0]);
            o[i][4 * g + 1] = fmaf(p, vv.y, o[i][4 * g + 1]);
            o[i][4 * g + 2] = fmaf(p, vv.z, o[i][4 * g + 2]);
            o[i][4 * g + 3] = fmaf(p, vv.w, o[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = q0 + ty + TY * i;
    if (t >= a.T) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* orow = static_cast<T*>(a.out) + b * a.sob + t * a.sot + h * a.soh;
#pragma unroll
    for (int g = 0; g < OG; ++g)
      Elem<T>::store4(orow + 4 * tx + 32 * g, o[i][4 * g] / ll,
                      o[i][4 * g + 1] / ll, o[i][4 * g + 2] / ll,
                      o[i][4 * g + 3] / ll);
    if (tx == 0)
      a.lse[((int64_t)b * a.H + h) * a.T + t] = m[i] + logf(ll);
  }
}

template <typename T, int D, int BQ, int BK>
static int launch(const FlashArgs& a, int B, cudaStream_t st) {
  constexpr int smem = (int)sizeof(float) * ((BQ + BK) * (D + 4) + BQ * (BK + 8));
  auto kern = flash_fwd_kernel<T, D, BQ, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((a.T + BQ - 1) / BQ), (unsigned)a.H, (unsigned)B);
  kern<<<grid, 128, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const FlashArgs& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64, 64, 64>(a, B, st);
    case 128: return launch<T, 128, 64, 64>(a, B, st);
    case 256: return launch<T, 256, 32, 32>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16. strides: 12 element strides, (b, t, h) of
// q, k, v and out. window <= 0 and softcap <= 0 mean none.
extern "C" int flash_attention_fwd(int dtype, int B, int T, int S, int H,
                                   int KH, int D, const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   const int64_t* strides, float scale,
                                   int causal, int window, float softcap,
                                   int seq_k, void* stream) {
  if (B < 1 || T < 1 || S < 1 || KH < 1 || H % KH != 0 || seq_k > S)
    return (int)cudaErrorInvalidValue;
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse = lse;
  a.sqb = strides[0]; a.sqt = strides[1]; a.sqh = strides[2];
  a.skb = strides[3]; a.skt = strides[4]; a.skh = strides[5];
  a.svb = strides[6]; a.svt = strides[7]; a.svh = strides[8];
  a.sob = strides[9]; a.sot = strides[10]; a.soh = strides[11];
  a.T = T; a.S = S; a.H = H; a.group = H / KH; a.seq_k = seq_k;
  a.causal = causal != 0;
  a.has_window = window > 0;
  a.window = window;
  a.has_softcap = softcap > 0.f;
  a.softcap = softcap;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(a, B, D, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}
