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
// each CTA owns its output tile and loops itself, in two kernels a call:
//  * the dq kernel, grid (T/BQ, H, B): one CTA per (b, h, q-tile) holds q
//    and dout and its rows' lse and delta and walks the kv tiles,
//    accumulating dq in registers;
//  * the dkv kernel, grid (S/BK, KH, B): one CTA per (b, kv-head, k-tile)
//    holds k and v and walks the G query heads of its group and, for
//    each, the q tiles that can see the tile, accumulating dk and dv in
//    registers. They are written once, already summed over the group:
//    deterministic, no atomics, and no (B,S,H,D) intermediate G times
//    larger than the result.
// Tiles wholly above the diagonal, below the window or in the padding are
// skipped, as in the TPU kernel. Ragged T and S are taken as they are:
// rows past T or S are loaded as zeros, masked, and never written.
//
// Bound on an H100 SXM: at the serve shape (B=4, T=S=1024, H=32, KH=8,
// D=64, bf16, causal) the five products need 10*D FLOP per unmasked
// (q, k) pair, 43 GFLOP, about 43 us at 989 TFLOP/s on the tensor cores,
// against about 85 MB (q, k, v, out, dout, dq, dk, dv, lse, delta once),
// about 25 us at 3.35 TB/s: operations. At the train shape (B=4, T=256,
// H=12, KH=4) it is bytes, about 2.5 us. Both kernels recompute s and dp
// (so 14*D FLOP a pair are done, not 10*D).
//
// bfloat16, flash_bwd_dq_kernel_tc and flash_bwd_dkv_kernel_tc: every
// product on the tensor cores by wgmma (bf16 operands, float32
// accumulation), built as the forward's bf16 kernel: one producer warp
// loads the streamed tiles by TMA into a ring of mbarrier-signalled
// stages, and each consumer warpgroup owns 64 rows. s and dp take both
// operands from shared memory; dq += ds.k, dv += p^T.dout and dk +=
// ds^T.q take p or ds from registers (the accumulators turned into A
// fragments) and k, dout or q MN-major through the descriptor's
// transpose bit. p and ds are rounded to bf16 only there; lse, delta,
// the exponent (ex2 in log2 units) and the masks stay float32, and the
// masks are applied only to tiles that need them. Tiles: dq 64 queries x
// 64 keys; dkv 64 keys x 64 queries at D = 64, x 32 at D = 128 and 256,
// where two warpgroups each accumulate half of dk and dv's columns (and
// each computes the whole s and dp) so that the accumulators fit in
// registers. lse and delta of a q tile reach the dkv kernel's shared
// memory through the producer warp (TMA would need 16-byte row strides).
//
// float32, flash_bwd_dq_kernel and flash_bwd_dkv_kernel: float32 FMAs on
// the CUDA cores (67 TFLOP/s at most), which the float32 tolerance (2e-4)
// asks for. 128 threads as 16 x 8 (ty, tx); thread (ty, tx) owns rows
// ty + 16*i and columns tx + 8*j of the score tile, and output columns
// 4*tx + 32*g. Operand tiles live in float32 dynamic shared memory with
// rows padded by 4 floats for conflict-free 16-byte reads; p and ds go
// through shared memory to the products that contract over the score
// tile. D is a template parameter in {64, 128, 256}, with tiles that keep
// registers and shared memory in bounds (32 and 16 rows at D = 256).
// All kernels launch on the caller's stream, allocate nothing and
// synchronise nothing; flash_attention_bwd returns cudaGetLastError().
#include "flash_common.cuh"
#include "hopper_tc.cuh"

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


// -- bfloat16: wgmma and TMA -------------------------------------------------
// Both kernels are built as flash_attention_fwd.cu's bf16 kernel: consumer
// warpgroups of 64 rows and one producer warp that loads tiles by TMA into
// a ring of NS stages, each signalled by an mbarrier. s and dp are wgmma
// chains with both operands in shared memory (K-major); the products that
// contract over the score tile take p or ds as the register A operand and
// a tile in shared memory as the MN-major B operand (the descriptor's
// transpose bit), so no tile is ever transposed.
// acc (64 x N) += X (64 rows) . Y^T (N rows): one wgmma chain over the D/16
// k-steps; X and Y lie in 64-column blocks of xrows and N rows
template <int D, int N>
__device__ __forceinline__ void issue_xy(float* acc, const __nv_bfloat16* X,
                                         int xrows,
                                         const __nv_bfloat16* Y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        gmma_desc(X + (kk / 4) * xrows * 64 + (kk % 4) * 16, 16, 1024);
    const uint64_t db =
        gmma_desc(Y + (kk / 4) * N * 64 + (kk % 4) * 16, 16, 1024);
    if constexpr (N == 64)
      wgmma_ss_n64(acc, da, db);
    else
      wgmma_ss_n32(acc, da, db);
  }
}

// acc (64 x 64) += P (64 x K, A fragments pa) . Y (K x 64): Y is one
// 64-column block of a tile of K rows
template <int K>
__device__ __forceinline__ void issue_py(float* acc, uint32_t (*pa)[4],
                                         const __nv_bfloat16* Y) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs_n64(acc, pa[kk], gmma_desc(Y + kk * 16 * 64, K * 128, 1024));
}

// the accumulator of 64 x N in C layout as the A fragments of N/16 k-steps
template <int N>
__device__ __forceinline__ void to_a(uint32_t (*pa)[4], const float* acc) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// this thread's rows (row0, row0 + 8) of DB 64-column accumulator blocks
// as bf16 pairs at column col0 + 64*c + 8*j + 2*c4; rows >= limit are not
// written
template <int DB>
__device__ __forceinline__ void store_acc(float (*acc)[32],
                                          __nv_bfloat16* base,
                                          int64_t stride, int row0,
                                          int limit, int col0, int c4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= limit) continue;
    __nv_bfloat16* row = base + t * stride + col0 + 2 * c4;
#pragma unroll
    for (int c = 0; c < DB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 64 * c + 8 * j) =
            pack_bf16(acc[c][4 * j + 2 * r], acc[c][4 * j + 2 * r + 1]);
  }
}

// the dq kernel: 64 query rows, kv tiles of BC rows in NS stages
template <int D, int BC, int NS>
struct DqTc {
  static constexpr int NT = 128 + 32;
  static constexpr int MINB = D <= 128 ? 2 : 1;
  static constexpr int X = 64 * D;   // q, dout
  static constexpr int Y = BC * D;   // a stage of k, of v
  static constexpr int SMEM = 2 * (2 * X + 2 * NS * Y) + 1024;
};

template <int D, int BC, int NS>
__global__ void __launch_bounds__(DqTc<D, BC, NS>::NT, DqTc<D, BC, NS>::MINB)
    flash_bwd_dq_kernel_tc(const BwdArgs a,
                           const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap omap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap) {
  using C = DqTc<D, BC, NS>;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * NS];
  uint64_t* xfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;
  bf16* Qs = align1024(smem_raw);
  bf16* DOs = Qs + C::X;
  bf16* Ks = DOs + C::X;          // NS stages
  bf16* Vs = Ks + NS * C::Y;      // NS stages

  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.group;
  // the kv tiles that hold a visible score: [n_lo, n_hi)
  int n_hi = (a.seq_k + BC - 1) / BC;
  if (a.causal) n_hi = min(n_hi, (q0 + 63) / BC + 1);
  int n_lo = 0;
  if (a.has_window && q0 - a.window + 1 > 0) n_lo = (q0 - a.window + 1) / BC;
  const int n_tiles = n_hi - n_lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(xfull, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: one thread issues
    if (tid == 128) {
      mbar_expect_tx(xfull, 2 * C::X * 2);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(Qs + c * 64 * 64, &qmap, xfull, c * 64, q0, h, b);
        tma_load_4d(DOs + c * 64 * 64, &omap, xfull, c * 64, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS;
        const int k0 = (n_lo + it) * BC;
        mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::Y * 2);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(Ks + s * C::Y + c * BC * 64, &kmap, &full[s], c * 64,
                      k0, kh, b);
          tma_load_4d(Vs + s * C::Y + c * BC * 64, &vmap, &full[s], c * 64,
                      k0, kh, b);
        }
      }
    }
    return;
  }

  // the warpgroup: rows 16*w + g and + 8 of the q tile
  const int w = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int row0 = q0 + 16 * w + g;
  // per row r: lse in log2 units, delta, and the keys the row sees,
  // lo[r] < kpos <= hi[r] (none for a row past T)
  const float scale_log2 = a.scale * LOG2E;
  float lse2[2], dlt[2];
  int hi[2], lo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    const int64_t i = ((int64_t)b * a.H + h) * a.T + t;
    lse2[r] = t < a.T ? a.lse[i] * LOG2E : 0.f;
    dlt[r] = t < a.T ? a.delta[i] : 0.f;
    hi[r] = t >= a.T ? -1 : a.causal ? min(a.seq_k - 1, t) : a.seq_k - 1;
    lo[r] = a.has_window ? t - a.window : -1;
  }
  float dq[D / 64][32];
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  mbar_wait(xfull, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % NS;
    const int k0 = (n_lo + it) * BC;
    const bf16* Kt = Ks + s * C::Y;
    float sc[BC / 2], dp[BC / 2];
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) sc[i] = dp[i] = 0.f;
    mbar_wait(&full[s], (it / NS) & 1);
    fence_regs<BC / 2>(sc);
    fence_regs<BC / 2>(dp);
    wgmma_fence();
    issue_xy<D, BC>(sc, Qs, 64, Kt);
    issue_xy<D, BC>(dp, DOs, 64, Vs + s * C::Y);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BC / 2>(sc);
    fence_regs<BC / 2>(dp);

    // p = exp(s * scale - lse), ds = p * (dp - delta) * scale, into sc;
    // the mask only where the tile needs it (uniform over the CTA)
    const bool whole = q0 + 64 <= a.T && k0 + BC <= a.seq_k &&
                       (!a.causal || k0 + BC - 1 <= q0) &&
                       (!a.has_window || k0 > q0 + 63 - a.window);
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = fmaf(sc[4 * j + e], scale_log2, -lse2[r]);
        if (!whole) {
          const int kpos = k0 + 8 * j + 2 * c4 + (e & 1);
          x = kpos <= hi[r] && kpos > lo[r] ? x : MASK_VALUE;
        }
        sc[4 * j + e] = exp2_approx(x) * (dp[4 * j + e] - dlt[r]) * a.scale;
      }
    uint32_t da[BC / 16][4];
    to_a<BC>(da, sc);

#pragma unroll
    for (int c = 0; c < D / 64; ++c) fence_regs<32>(dq[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) issue_py<BC>(dq[c], da, Kt + c * BC * 64);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) fence_regs<32>(dq[c]);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) fence_u32<4>(da[kk]);
    mbar_arrive(&empty[s]);
  }
  store_acc<D / 64>(dq, static_cast<bf16*>(a.dq) + b * a.s[IDQ][0] +
                            h * a.s[IDQ][2],
                    a.s[IDQ][1], row0, a.T, 0, c4);
}

// the dkv kernel: 64 key rows, q tiles of BC rows in NS stages; NCW
// warpgroups, each accumulating D/NCW columns of dk and dv (and each
// computing the whole s and dp)
template <int D, int BC, int NCW, int NS>
struct DkvTc {
  static constexpr int NT = NCW * 128 + 32;
  static constexpr int MINB = D == 64 ? 2 : 1;
  static constexpr int DBW = D / 64 / NCW;   // column blocks a warpgroup
  static constexpr int X = 64 * D;           // k, v
  static constexpr int Y = BC * D;           // a stage of q, of dout
  // and NS stages of lse (log2 units) and delta, BC floats each
  static constexpr int SMEM = 2 * (2 * X + 2 * NS * Y) + 4 * 2 * NS * BC +
                              1024;
};

template <int D, int BC, int NCW, int NS>
__global__ void __launch_bounds__(DkvTc<D, BC, NCW, NS>::NT,
                                  DkvTc<D, BC, NCW, NS>::MINB)
    flash_bwd_dkv_kernel_tc(const BwdArgs a,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap omap) {
  using C = DkvTc<D, BC, NCW, NS>;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * NS];
  uint64_t* xfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;
  bf16* Ks = align1024(smem_raw);
  bf16* Vs = Ks + C::X;
  bf16* Qs = Vs + C::X;           // NS stages
  bf16* DOs = Qs + NS * C::Y;     // NS stages
  float* Ls = reinterpret_cast<float*>(DOs + NS * C::Y);   // NS x BC
  float* Dl = Ls + NS * BC;                                // NS x BC

  const int k0 = blockIdx.x * 64;   // early k tiles see the most q tiles
  const int kh = blockIdx.y, b = blockIdx.z;
  // the (query head, q tile) items of the group: under a causal mask no q
  // tile before the one holding k0 sees the tile
  const int qstart = a.causal ? (k0 / BC) * BC : 0;
  const int nqt = (a.T - qstart + BC - 1) / BC;
  const int n_items = a.group * nqt;
  auto next_item = [&](int i) {
    for (; i < n_items; ++i)
      if (tile_runs(a, qstart + (i % nqt) * BC, BC, k0, 64)) return i;
    return -1;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(xfull, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);   // the producer warp's lanes
      mbar_init(&empty[s], NCW * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCW * 128) {  // the producer warp
    const int lane = tid % 32;
    if (lane == 0) {
      mbar_expect_tx(xfull, 2 * C::X * 2);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(Ks + c * 64 * 64, &kmap, xfull, c * 64, k0, kh, b);
        tma_load_4d(Vs + c * 64 * 64, &vmap, xfull, c * 64, k0, kh, b);
      }
    }
    int it = 0;
    for (int i = next_item(0); i >= 0; i = next_item(i + 1), ++it) {
      const int s = it % NS;
      const int h = kh * a.group + i / nqt, q0 = qstart + (i % nqt) * BC;
      mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
      // the lanes stage lse and delta of the tile, then arrive; lane 0's
      // arrival also expects the bytes of q and dout
      const int64_t row = ((int64_t)b * a.H + h) * a.T + q0;
      for (int c = lane; c < BC; c += 32) {
        const bool ok = q0 + c < a.T;
        Ls[s * BC + c] = ok ? a.lse[row + c] * LOG2E : 0.f;
        Dl[s * BC + c] = ok ? a.delta[row + c] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::Y * 2);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(Qs + s * C::Y + c * BC * 64, &qmap, &full[s], c * 64,
                      q0, h, b);
          tma_load_4d(DOs + s * C::Y + c * BC * 64, &omap, &full[s], c * 64,
                      q0, h, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // warpgroup wg: key rows 16*w + g and + 8 of the tile, columns
  // wg*DBW*64 .. of dk and dv
  const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int row0 = k0 + 16 * w + g;
  // per key row r: the queries that see it, qlo[r] <= qpos <= qhi[r]
  // (none for a key at or past seq_k)
  const float scale_log2 = a.scale * LOG2E;
  int qlo[2], qhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = row0 + 8 * r;
    qlo[r] = a.causal ? kpos : 0;
    qhi[r] = kpos >= a.seq_k ? -1
             : a.has_window  ? min(a.T - 1, kpos + a.window - 1)
                             : a.T - 1;
  }
  float dk[C::DBW][32], dv[C::DBW][32];
#pragma unroll
  for (int c = 0; c < C::DBW; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

  mbar_wait(xfull, 0);
  int it = 0;
  for (int i = next_item(0); i >= 0; i = next_item(i + 1), ++it) {
    const int s = it % NS;
    const int q0 = qstart + (i % nqt) * BC;
    const bf16* Qt = Qs + s * C::Y;
    const bf16* DOt = DOs + s * C::Y;
    float sc[BC / 2], dp[BC / 2];
#pragma unroll
    for (int j = 0; j < BC / 2; ++j) sc[j] = dp[j] = 0.f;
    mbar_wait(&full[s], (it / NS) & 1);
    fence_regs<BC / 2>(sc);
    fence_regs<BC / 2>(dp);
    wgmma_fence();
    issue_xy<D, BC>(sc, Ks, 64, Qt);
    issue_xy<D, BC>(dp, Vs, 64, DOt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BC / 2>(sc);
    fence_regs<BC / 2>(dp);

    // p^T = exp(s^T * scale - lse) into sc, ds^T = p^T * (dp^T - delta) *
    // scale into dp; the mask only where the tile needs it
    const bool whole = q0 + BC <= a.T && k0 + 64 <= a.seq_k &&
                       (!a.causal || k0 + 63 <= q0) &&
                       (!a.has_window || k0 > q0 + BC - 1 - a.window);
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + 2 * c4 + (e & 1);
        float x = fmaf(sc[4 * j + e], scale_log2, -Ls[s * BC + col]);
        if (!whole) {
          const int qpos = q0 + col;
          x = qpos >= qlo[r] && qpos <= qhi[r] ? x : MASK_VALUE;
        }
        const float p = exp2_approx(x);
        sc[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - Dl[s * BC + col]) * a.scale;
      }
    uint32_t pa[BC / 16][4], da[BC / 16][4];
    to_a<BC>(pa, sc);
    to_a<BC>(da, dp);

#pragma unroll
    for (int c = 0; c < C::DBW; ++c) {
      fence_regs<32>(dk[c]);
      fence_regs<32>(dv[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::DBW; ++c) {
      const int blk = (wg * C::DBW + c) * BC * 64;
      issue_py<BC>(dv[c], pa, DOt + blk);
      issue_py<BC>(dk[c], da, Qt + blk);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::DBW; ++c) {
      fence_regs<32>(dk[c]);
      fence_regs<32>(dv[c]);
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      fence_u32<4>(pa[kk]);
      fence_u32<4>(da[kk]);
    }
    mbar_arrive(&empty[s]);
  }
  const int col0 = wg * C::DBW * 64;
  store_acc<C::DBW>(dk, static_cast<bf16*>(a.dk) + b * a.s[IDK][0] +
                            kh * a.s[IDK][2],
                    a.s[IDK][1], row0, a.S, col0, c4);
  store_acc<C::DBW>(dv, static_cast<bf16*>(a.dv) + b * a.s[IDV][0] +
                            kh * a.s[IDV][2],
                    a.s[IDV][1], row0, a.S, col0, c4);
}

// the dq kernel's kv tiles (BCQ rows, NSQ stages) and the dkv kernel's q
// tiles (BCK rows, NCW warpgroups, NSK stages) at head dim D
template <int D, int BCQ, int NSQ, int BCK, int NCW, int NSK>
struct BwdTiles {
  using CQ = DqTc<D, BCQ, NSQ>;
  using CK = DkvTc<D, BCK, NCW, NSK>;

  static int launch(const BwdArgs& a, int B, int KH, cudaStream_t st) {
    const void* p[4] = {a.q, a.dout, a.k, a.v};
    const int which[4] = {IQ, IDO, IK, IV};
    // q, dout, k, v as 4-d maps for the dq kernel (64-row boxes of q and
    // dout, BCQ-row boxes of k and v) and for the dkv kernel (64-row boxes
    // of k and v, BCK-row boxes of q and dout)
    CUtensorMap mq[4], mk[4];
    for (int i = 0; i < 4; ++i) {
      const bool isq = i < 2;
      const int rows = isq ? a.T : a.S, heads = isq ? a.H : KH;
      const int64_t* sx = a.s[which[i]];
      int e = tensor_map(&mq[i], p[i], B, rows, heads, D, sx[0], sx[1], sx[2],
                         isq ? 64 : BCQ);
      if (e == 0)
        e = tensor_map(&mk[i], p[i], B, rows, heads, D, sx[0], sx[1], sx[2],
                       isq ? BCK : 64);
      if (e != 0) return e;
    }
    auto dq_kern = flash_bwd_dq_kernel_tc<D, BCQ, NSQ>;
    auto dkv_kern = flash_bwd_dkv_kernel_tc<D, BCK, NCW, NSK>;
    cudaError_t e = cudaFuncSetAttribute(
        dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, CQ::SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, CK::SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 gq((unsigned)((a.T + 63) / 64), (unsigned)a.H, (unsigned)B);
    dq_kern<<<gq, CQ::NT, CQ::SMEM, st>>>(a, mq[0], mq[1], mq[2], mq[3]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 gk((unsigned)((a.S + 63) / 64), (unsigned)KH, (unsigned)B);
    dkv_kern<<<gk, CK::NT, CK::SMEM, st>>>(a, mk[2], mk[3], mk[0], mk[1]);
    return (int)cudaGetLastError();
  }
};

using Bwd64 = BwdTiles<64, 64, 3, 64, 1, 3>;
using Bwd128 = BwdTiles<128, 64, 3, 32, 1, 3>;
using Bwd256 = BwdTiles<256, 64, 2, 32, 2, 3>;

static int dispatch_tc(const BwdArgs& a, int B, int KH, int D,
                       cudaStream_t st) {
  switch (D) {
    case 64: return Bwd64::launch(a, B, KH, st);
    case 128: return Bwd128::launch(a, B, KH, st);
    case 256: return Bwd256::launch(a, B, KH, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory a CTA of the bf16 dq (which 0) or dkv (which 1)
// kernel takes at head dim D
extern "C" int flash_attention_bwd_smem(int D, int which) {
  switch (D) {
    case 64: return which ? Bwd64::CK::SMEM : Bwd64::CQ::SMEM;
    case 128: return which ? Bwd128::CK::SMEM : Bwd128::CQ::SMEM;
    case 256: return which ? Bwd256::CK::SMEM : Bwd256::CQ::SMEM;
    default: return -1;
  }
}

// -- float32: FMAs on the CUDA cores -----------------------------------------
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
  if (dtype == 1) return dispatch_tc(a, B, KH, D, st);
  return (int)cudaErrorInvalidValue;
}
