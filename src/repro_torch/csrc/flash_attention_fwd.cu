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
// walks the kv tiles in a loop with m, l and the accumulator in registers.
// Both kernels below do that; the element type picks one of them.
//
// Bound on an H100 SXM: operations. At the serve shape (B=4, T=S=1024,
// H=32, KH=8, D=64, bf16, causal) the two products need 17.2 GFLOP, about
// 17 us at 989 TFLOP/s on the tensor cores, against about 42 MB of q, k,
// v, out and lse, about 13 us at 3.35 TB/s.
//
// bfloat16, flash_fwd_kernel_tc: both products on the tensor cores.
//  * grid (T/BQ, H, B), q tiles heaviest first (the causal diagonal makes
//    late tiles longer). NC = BQ/64 consumer warpgroups, each owning 64
//    query rows, and one producer warp. BQ x BK = 64 x 64 at D = 64, with
//    three CTAs an SM (128 registers a thread at most), so that one CTA's
//    softmax, prologue and epilogue overlap another's products; 128 x 64
//    at D = 128 and 64 x 64 at D = 256, one CTA an SM, the output
//    accumulator (D/2 floats a thread) in registers.
//  * the producer's one thread loads q once and then the k and v tiles by
//    TMA into a ring of NS = 3 stages, each tile signalled by its own
//    mbarrier (k and v apart, so q.k starts before v lands), and waits
//    for the consumers to release a stage before it reloads it. The
//    tensor maps describe the strided (B, T, H, D) views in place, as 4-d
//    tensors (D, T, H, B) in boxes of 64 columns: TMA zero-fills rows
//    past T or S and writes tiles in the 128-byte swizzle that the wgmma
//    descriptors name.
//  * s = q.k^T is one wgmma chain (m64n64k16) with q and k from shared
//    memory, in bf16 with float32 accumulation; the scale (in log2 units,
//    folded into the exponent's FMA where a tile needs no mask), the
//    softcap and the masks apply to the float32 scores. The row max and
//    row sum stay float32, and l is summed from the float32 p.
//  * o += p.v takes p from registers as the A operand and v MN-major from
//    the same swizzled tile through the descriptor's transpose bit
//    (m64n64k16 per 64 output columns). p goes in as two bf16 parts, its
//    rounding and the rounding of the rest, two chains on one descriptor:
//    p rounded once to bf16 (as scaled_dot_product_attention does) is
//    off the reference's float32 p.v by more than its 2e-2 on the serve
//    path's activations (|v| near 80 in granite-3-2b's layers;
//    scripts/flash_p_rounding_witness.py), and two parts carry about 16
//    bits.
//  * branches on the softcap and the masks are taken once a tile, never
//    once an element, so that the element loops stay straight-line code.
//  * kv tiles wholly above the diagonal, below the window or in the
//    padding are never loaded: the tiles run over [n_lo, n_hi).
//  * the epilogue writes each warpgroup's rows of out through its own
//    rows of the q tile in shared memory (16-byte chunks swizzled by row
//    against bank conflicts), so that rows reach memory as 16-byte
//    stores; no row past T is written.
//
// float32, flash_fwd_kernel: float32 FMAs on the CUDA cores (67 TFLOP/s
// at most), which the float32 tolerance (2e-5) asks for.
//  * grid (T/BQ, H, B), 128 threads, q tiles heaviest first. Tensors are
//    read in place through their strides (last dimension contiguous, rows
//    16-byte aligned), with no transposes: the kv head of query head h
//    is h/G.
//  * the CTA stages its q tile once (scaled) and then each kv tile, first
//    k and then v into the same buffer, in dynamic shared memory (above
//    48 KB, so cudaFuncSetAttribute raises the cap). Rows are padded by 4
//    or 8 floats so that the 16-byte reads below hit distinct banks.
//  * thread (ty, tx), ty in 0..15, tx in 0..7, owns query rows ty + 16*i
//    and key columns tx + 8*j of the score tile, and output columns
//    4*tx + 32*g; row max and row sum reduce over the 8 tx lanes with
//    shuffles. p goes through shared memory to the p.v product.
//  * kv tiles wholly above the diagonal, below the window or in the
//    padding are skipped, as in the TPU kernel.
//  * D is a template parameter in {64, 128, 256} (BQ = BK = 64, and 32 at
//    D = 256 to bound registers and shared memory).
// Both launch on the caller's stream, allocate nothing and synchronise
// nothing; flash_attention_fwd returns cudaGetLastError() after the launch.
#include "flash_common.cuh"
#include "hopper_tc.cuh"

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


// -- bfloat16: wgmma and TMA -------------------------------------------------
constexpr int NS = 3;  // stages of the k/v ring

template <int D, int BQ, int BK>
struct FwdTc {
  static_assert(BK == 64, "one m64n64k16 wgmma chain a score tile");
  static constexpr int NC = BQ / 64;        // consumer warpgroups
  static constexpr int NT = NC * 128 + 32;  // and one producer warp
  // three CTAs an SM at D = 64 (128 registers a thread at most)
  static constexpr int MINB = (NC == 1 && D == 64) ? 3 : 1;
  static constexpr int DB = D / 64;         // 64-column blocks of a tile
  static constexpr int Q_ELEMS = BQ * D;
  static constexpr int KV_ELEMS = BK * D;
  // q, NS stages of k and of v, and 1024 bytes to align the swizzle atoms
  static constexpr int SMEM = 2 * (Q_ELEMS + 2 * NS * KV_ELEMS) + 1024;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(FwdTc<D, BQ, BK>::NT, FwdTc<D, BQ, BK>::MINB)
    flash_fwd_kernel_tc(const FlashArgs a,
                        const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap) {
  using C = FwdTc<D, BQ, BK>;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * NS];
  uint64_t* qfull = bars;
  uint64_t* kfull = bars + 1;
  uint64_t* vfull = bars + 1 + NS;
  uint64_t* empty = bars + 1 + 2 * NS;
  bf16* Qs = align1024(smem_raw);
  bf16* Ks = Qs + C::Q_ELEMS;          // NS stages of BK x D
  bf16* Vs = Ks + NS * C::KV_ELEMS;    // likewise

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.group;
  // the kv tiles that hold a visible score: [n_lo, n_hi)
  int n_hi = (a.seq_k + BK - 1) / BK;
  if (a.causal) n_hi = min(n_hi, (q0 + BQ - 1) / BK + 1);
  int n_lo = 0;
  if (a.has_window && q0 - a.window + 1 > 0) n_lo = (q0 - a.window + 1) / BK;
  const int n_tiles = n_hi - n_lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], C::NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::NC * 128) {  // the producer warp: one thread issues
    if (tid == C::NC * 128) {
      mbar_expect_tx(qfull, C::Q_ELEMS * 2);
      for (int c = 0; c < C::DB; ++c)
        tma_load_4d(Qs + c * BQ * 64, &qmap, qfull, c * 64, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS;
        const int k0 = (n_lo + it) * BK;
        mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
        mbar_expect_tx(&kfull[s], C::KV_ELEMS * 2);
        for (int c = 0; c < C::DB; ++c)
          tma_load_4d(Ks + s * C::KV_ELEMS + c * BK * 64, &kmap, &kfull[s],
                      c * 64, k0, kh, b);
        mbar_expect_tx(&vfull[s], C::KV_ELEMS * 2);
        for (int c = 0; c < C::DB; ++c)
          tma_load_4d(Vs + s * C::KV_ELEMS + c * BK * 64, &vmap, &vfull[s],
                      c * 64, k0, kh, b);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg*64 + 16*w + g and + 8 of the q tile;
  // its thread holds columns 8*j + 2*c4 (+1) of each 8-column chunk j
  const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int row0 = q0 + wg * 64 + w * 16 + g;
  float m[2] = {MASK_VALUE, MASK_VALUE};   // running max, log2 units
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums
  float o[C::DB][32];
#pragma unroll
  for (int c = 0; c < C::DB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  // scores in log2 units: scale * log2(e), or with a softcap
  // tanh(x * scale / cap) * cap * log2(e)
  const float scale_log2 = a.scale * LOG2E;
  const float cap_in = a.has_softcap ? a.scale / a.softcap : 0.f;
  const float cap_out = a.softcap * LOG2E;
  // the keys row r of this thread sees: lo[r] < kpos <= hi[r]
  int hi[2], lo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    hi[r] = a.causal ? min(a.seq_k - 1, qpos) : a.seq_k - 1;
    lo[r] = a.has_window ? qpos - a.window : -1;
  }

  // s = q . k^T of the tile in stage `st` into sc, issued and committed
  auto issue_s = [&](float* sc, int st) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    fence_regs<BK / 2>(sc);
    wgmma_fence();
    const bf16* Kt = Ks + st * C::KV_ELEMS;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = gmma_desc(
          Qs + (kk / 4) * BQ * 64 + wg * 64 * 64 + (kk % 4) * 16, 16, 1024);
      const uint64_t db =
          gmma_desc(Kt + (kk / 4) * BK * 64 + (kk % 4) * 16, 16, 1024);
      wgmma_ss_n64(sc, da, db);
    }
    wgmma_commit();
  };
  // o += p . v of the tile in stage `st`, issued and committed: p as its
  // bf16 part ph plus the bf16 rounding of the rest, pl, two wgmma chains
  // on one descriptor, so that p . v keeps about 16 bits of p
  auto issue_pv = [&](uint32_t (*ph)[4], uint32_t (*pl)[4], int st) {
#pragma unroll
    for (int c = 0; c < C::DB; ++c) fence_regs<32>(o[c]);
    wgmma_fence();
    const bf16* Vt = Vs + st * C::KV_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::DB; ++c) {
        const uint64_t db =
            gmma_desc(Vt + c * BK * 64 + kk * 16 * 64, BK * 128, 1024);
        wgmma_rs_n64(o[c], ph[kk], db);
        wgmma_rs_n64(o[c], pl[kk], db);
      }
    wgmma_commit();
  };
  // scale, softcap and masks on the float32 scores of the tile at k0, the
  // new row max (log2 units) and its correction of earlier sums, p in
  // float32 into l, and p as the A operands of p.v: its bf16 rounding ph
  // and the bf16 rounding of the rest, pl
  auto softmax = [&](float* sc, int k0, uint32_t (*ph)[4],
                     uint32_t (*pl)[4], float* corr) {
    // the branches are uniform over the CTA and taken once a tile, not
    // once an element, so that the element loops stay straight-line code
    // scores into log2 units. A tile that needs no mask folds the scale
    // into the exponent's FMA (its max taken over the raw scores, scale >
    // 0); one that needs a mask is scaled first, so that a masked score is
    // exactly MASK_VALUE and a row with nothing visible yet takes exp(0)
    // terms that the next correction erases, as the reference does
    float mul = scale_log2;
    if (a.has_softcap) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] = tanhf(sc[i] * cap_in) * cap_out;
      mul = 1.f;
    }
    const bool whole = k0 + BK <= a.seq_k &&
                       (!a.causal || k0 + BK - 1 <= q0) &&
                       (!a.has_window || k0 > q0 + BQ - 1 - a.window);
    if (!whole) {   // visible: lo[r] < kpos <= hi[r]
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * c4 + (e & 1);
          const bool ok = kpos <= hi[e >> 1] && kpos > lo[e >> 1];
          sc[4 * j + e] = ok ? sc[4 * j + e] * mul : MASK_VALUE;
        }
      mul = 1.f;
    }
    float mx[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float mn[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mn[r] = fmaxf(m[r], mx[r] * mul);
      corr[r] = exp2_approx(m[r] - mn[r]);
      m[r] = mn[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(sc[4 * j + e], mul, -m[e >> 1]));
        l[e >> 1] += p;
        sc[4 * j + e] = p;
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                   pl[kk][r]);
  };
  auto rescale = [&](const float* corr) {
#pragma unroll
    for (int c = 0; c < C::DB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
  };

  // a tile: s = q.k^T, the softmax, then o += p.v. The warpgroup waits for
  // each chain; the producer's loads and the other CTAs of the SM (at D =
  // 64) or the other warpgroup (at D = 128) fill the tensor cores meanwhile
  mbar_wait(qfull, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % NS;
    const uint32_t phase = (it / NS) & 1;
    float sc[BK / 2], corr[2];
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
    mbar_wait(&kfull[s], phase);
    issue_s(sc, s);
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);
    softmax(sc, (n_lo + it) * BK, ph, pl, corr);
    rescale(corr);
    mbar_wait(&vfull[s], phase);
    issue_pv(ph, pl, s);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::DB; ++c) fence_regs<32>(o[c]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {   // p stays live until p.v is done
      fence_u32<4>(ph[kk]);
      fence_u32<4>(pl[kk]);
    }
    mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float ll = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / ll;
    const int t = row0 + 8 * r;
    // m is in log2 units; a row that saw no visible key keeps MASK_VALUE
    if (c4 == 0 && t < a.T)
      a.lse[((int64_t)b * a.H + h) * a.T + t] =
          (m[r] == MASK_VALUE ? MASK_VALUE : m[r] * 0.6931471805599453f) +
          logf(ll);
  }
  // out through this warpgroup's rows of the q tile: row r's 16-byte chunk
  // ch of a 64-column block sits at chunk ch ^ (r % 8)
  bf16* Os = Qs + wg * 64 * 64;
#pragma unroll
  for (int c = 0; c < C::DB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w * 16 + g + 8 * r;
        *reinterpret_cast<uint32_t*>(Os + c * BQ * 64 + row * 64 +
                                     ((j ^ (row & 7)) * 8) + 2 * c4) =
            pack_bf16(o[c][4 * j + 2 * r] * inv[r],
                      o[c][4 * j + 2 * r + 1] * inv[r]);
      }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  bf16* ob = static_cast<bf16*>(a.out) + b * a.sob + h * a.soh;
  for (int idx = tid % 128; idx < 64 * (D / 8); idx += 128) {
    const int row = idx / (D / 8), cc = idx % (D / 8);
    const int t = q0 + wg * 64 + row;
    if (t >= a.T) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        Os + (cc / 8) * BQ * 64 + row * 64 + (((cc % 8) ^ (row & 7)) * 8));
    *reinterpret_cast<uint4*>(ob + t * a.sot + cc * 8) = val;
  }
}

template <int D, int BQ, int BK>
static int launch_tc(const FlashArgs& a, int B, int KH, cudaStream_t st) {
  using C = FwdTc<D, BQ, BK>;
  CUtensorMap qm, km, vm;
  int e = tensor_map(&qm, a.q, B, a.T, a.H, D, a.sqb, a.sqt, a.sqh, BQ);
  if (e == 0) e = tensor_map(&km, a.k, B, a.S, KH, D, a.skb, a.skt, a.skh, BK);
  if (e == 0) e = tensor_map(&vm, a.v, B, a.S, KH, D, a.svb, a.svt, a.svh, BK);
  if (e != 0) return e;
  auto kern = flash_fwd_kernel_tc<D, BQ, BK>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((unsigned)((a.T + BQ - 1) / BQ), (unsigned)a.H, (unsigned)B);
  kern<<<grid, C::NT, C::SMEM, st>>>(a, qm, km, vm);
  return (int)cudaGetLastError();
}

// the bf16 kernel's tiles BQ x BK at each head dim (and in the query below)
static int dispatch_tc(const FlashArgs& a, int B, int KH, int D,
                       cudaStream_t st) {
  switch (D) {
    case 64: return launch_tc<64, 64, 64>(a, B, KH, st);
    case 128: return launch_tc<128, 128, 64>(a, B, KH, st);
    case 256: return launch_tc<256, 64, 64>(a, B, KH, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory a CTA of the bf16 kernel takes at head dim D
extern "C" int flash_attention_fwd_smem(int D) {
  switch (D) {
    case 64: return FwdTc<64, 64, 64>::SMEM;
    case 128: return FwdTc<128, 128, 64>::SMEM;
    case 256: return FwdTc<256, 64, 64>::SMEM;
    default: return -1;
  }
}

// -- float32: FMAs on the CUDA cores -----------------------------------------
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
  if (dtype == 1) return dispatch_tc(a, B, KH, D, st);
  return (int)cudaErrorInvalidValue;
}
