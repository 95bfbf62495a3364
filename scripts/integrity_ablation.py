#!/usr/bin/env python3
"""Where the time of the fletcher and stream_cipher kernels goes at the
engine's 1 MiB extent, by switching parts off, and how other designs of
them compare.

    python3 scripts/integrity_ablation.py [VARIANT,...]
    python3 scripts/integrity_ablation.py --calls parent,change,change,parent

From the root of a checkout, on a CUDA card with nvcc. It builds copies of
`src/repro_torch/csrc/fletcher.cu` and `stream_cipher.cu` with one part
removed or one design changed into `build/integrity_ablation/`, in
parallel, and prints each variant's device time (torch.profiler, as
chip_smoke.py times kernels) of every device operation of a call, apart
and together (a memset and a kernel where the variant has a memset), at a
1 MiB block taken from 128 blocks in turn (HBM-cold, as on the main
path), at its floor (16 bytes, one CTA) and at 1 GiB; the variants of
SWEEPS also at 4 KiB, 64 KiB, 256 KiB, 1 MiB, 4 MiB and 16 MiB. fletcher's
C entry adds into an output it does not zero, so each timed call adds
into the last one's sums; only the exactness checks zero it first. The
variants (outputs of the ones marked * are wrong; only their times
count):

  fl_base        fletcher as it is: one grid-stride kernel, atomics into
                 a pair of zeros;
  fl_empty*      the same grid, every thread returning at once;
  fl_loadonly*   loads alone: each thread XORs its words and stores only
                 if the result is a value it never is (no weights, no CTA
                 sum, no atomics);
  fl_noatomic*   all but the atomics (each CTA's thread 0 stores its pair);
  fl_memset      a memset of the output before the kernel, as a call was
                 made before the pool of zeroed pairs: two operations;
  fl_ctas256, fl_ctas64
                 a grid of twice, half as many CTAs (1, 4 chunks a thread
                 at 1 MiB, 2 in the source);
  fl_cluster     one thread-block cluster of up to 16 CTAs of 1024 threads,
                 4 loads in flight a thread, its CTAs' pairs folded by CTA
                 0 in distributed shared memory: no atomic, no memset;
  fl_cluster_nofold*
                 the cluster without its barriers and fold (each CTA's
                 thread 0 stores its pair);
  fl_cl8         the cluster at the portable size, 8 CTAs of 1024 threads
                 with 8 loads in flight a thread;
  fl_coop        a cooperative launch of one CTA of 256 threads an SM, 2
                 loads in flight a thread: each CTA writes its pair into
                 scratch after out, a grid-wide sync, and CTA 0 folds;
  sc_base        stream_cipher as it is;
  sc_empty*      the same grid, every thread returning at once;
  sc_loadonly*   loads and stores, no keystream;
  sc_wave        a grid of one wave (the kernel's occupancy times the SMs)
                 with 8 loads in flight a thread and streaming stores;
  fl_parent, fl_parent_nomemset*, sc_parent
                 the kernels of the parent commit (fletcher's without its
                 memset too), where its tree is unpacked into build/parent
                 (`git archive`): time parent, change, change, parent in
                 one call, as `fl_parent,fl_base,fl_base,fl_parent`.

Names may repeat; each is built once and timed where it stands. A variant
whose text no longer matches the source stops the script; one that does
not build is reported and skipped.

`--calls` times the wrappers' whole call instead (`fletcher_checksum` and
`stream_cipher` at a 1 MiB block, 128 blocks in turn, CUDA events over
1,000 calls back to back, launch overhead included), of this tree
(`change`) or of the parent's (`parent`, from build/parent/src), each in a
process of its own, in the order given.
"""
import ctypes
import itertools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT_DIR = ROOT / "build" / "integrity_ablation"
PARENT = ROOT / "build" / "parent"
CSRC = ROOT / "src" / "repro_torch" / "csrc"
MiB = 1 << 20
SWEEP = (4 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)

FL_BODY = ("  uint32_t s1 = 0, s2 = 0;\n"
           "  thread_sums<VEC, FLETCHER_UNROLL>(")
FL_WEIGHTS = ("""        const uint32_t wt = n32 - (uint32_t)((c0 + u * step) * 4);
        s1 += v[u].x + v[u].y + v[u].z + v[u].w;
        s2 += v[u].x * wt + v[u].y * (wt - 1u) + v[u].z * (wt - 2u) +
              v[u].w * (wt - 3u);
""", "        s1 ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;\n")
FL_STORE_IF = "  if (s1 == 0x9E3779B9u) out[0] = s1;\n  return;\n"
FL_ATOMICS = ("    atomicAdd(out, s1);\n    atomicAdd(out + 1, s2);\n",
              "    out[0] = s1;\n    out[1] = s2;\n")
FL_ENTRY = "  cudaStream_t st = (cudaStream_t)stream;\n  const bool vec"
FL_MEMSET = (FL_ENTRY, FL_ENTRY.replace(
    "  const bool vec", "  cudaError_t err = cudaMemsetAsync(out, 0, 2 * "
    "sizeof(uint32_t), st);\n  if (err != cudaSuccess) return (int)err;\n"
    "  const bool vec"))
PARENT_MEMSET = ("  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof("
                 "uint32_t), st);\n  if (err != cudaSuccess) return (int)err;"
                 "\n", "")
FL_GRID = "  const int64_t per_cta = 2 * FLETCHER_THREADS;"
FL_KERNEL = "template <bool VEC>\n__global__ void __launch_bounds__(" \
            "FLETCHER_THREADS)\nfletcher_kernel("
FL_END = "  return (int)cudaGetLastError();\n}\n"
FL_CLUSTER = r"""#include <atomic>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

#define FLETCHER_CLUSTER_THREADS 1024  // threads a CTA, one CTA an SM
#define FLETCHER_CLUSTER_MAX 16        // most CTAs of the cluster
#define FLETCHER_CLUSTER_UNROLL 4      // uint4 loads in flight a thread

// one cluster: the CTAs' pairs folded by CTA 0 in distributed shared
// memory, no atomic, no memset
template <bool VEC>
__global__ void __launch_bounds__(FLETCHER_CLUSTER_THREADS, 1)
fletcher_cluster_kernel(const uint8_t* __restrict__ in, int64_t n_bytes,
                        uint32_t* __restrict__ out) {
  __shared__ uint32_t cta[2];
  cg::cluster_group cluster = cg::this_cluster();
  uint32_t s1 = 0, s2 = 0;  // the grid is the cluster
  thread_sums<VEC, FLETCHER_CLUSTER_UNROLL>(
      in, n_bytes, (int64_t)blockIdx.x * FLETCHER_CLUSTER_THREADS +
      threadIdx.x, (int64_t)gridDim.x * FLETCHER_CLUSTER_THREADS, s1, s2);
  cta_sums<FLETCHER_CLUSTER_THREADS>(s1, s2);
  if (threadIdx.x == 0) {
    cta[0] = s1;
    cta[1] = s2;
  }
  cluster.sync();  // every CTA's pair is in its shared memory
  if (cluster.block_rank() == 0 && threadIdx.x < 32) {
    uint32_t c1 = 0, c2 = 0;
    if (threadIdx.x < cluster.num_blocks()) {
      const uint32_t* pair = cluster.map_shared_rank(cta, threadIdx.x);
      c1 = pair[0];
      c2 = pair[1];
    }
    warp_sums(c1, c2);
    if (threadIdx.x == 0) {
      out[0] = c1;
      out[1] = c2;
    }
  }
  cluster.sync();  // no CTA leaves while CTA 0 may still read its pair
}

// clusters of more than 8 CTAs are allowed once a kernel asks, on each
// device: one bit a device and kernel
static std::atomic<uint64_t> cluster_wide[2];

template <bool VEC>
static cudaError_t launch_cluster(const void* in, int64_t n_bytes,
                                  void* out, cudaStream_t st) {
  const int64_t items = VEC ? n_bytes / 16 : (n_bytes + 3) / 4;
  const int64_t per_cta =
      (int64_t)FLETCHER_CLUSTER_THREADS * (VEC ? FLETCHER_CLUSTER_UNROLL : 1);
  int64_t ctas = (items + per_cta - 1) / per_cta;
  if (ctas < 1) ctas = 1;
  if (ctas > FLETCHER_CLUSTER_MAX) ctas = FLETCHER_CLUSTER_MAX;
  if (ctas > 8) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = 1ull << (dev & 63);
    if (!(cluster_wide[VEC].load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(fletcher_cluster_kernel<VEC>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
      if (err != cudaSuccess) return err;
      cluster_wide[VEC].fetch_or(bit);
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(FLETCHER_CLUSTER_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fletcher_cluster_kernel<VEC>,
                            (const uint8_t*)in, n_bytes, (uint32_t*)out);
}

extern "C" int fletcher(const void* in, int64_t n_bytes, void* out,
                        void* stream) {
  if (n_bytes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      (uintptr_t)in % 16 == 0 ? launch_cluster<true>(in, n_bytes, out, st)
                              : launch_cluster<false>(in, n_bytes, out, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""
FL_CLUSTER_FOLD = ("  cluster.sync();  // every CTA's pair is in its shared "
                   "memory\n",
                   "  cluster.sync();  // no CTA leaves while CTA 0 may still "
                   "read its pair\n",
                   "  if (threadIdx.x == 0) {\n    out[0] = cta[0];\n"
                   "    out[1] = cta[1];\n  }\n")
FL_COOP = r"""#include <cooperative_groups.h>
namespace cg = cooperative_groups;

#define FLETCHER_COOP_THREADS 256  // threads a CTA, one CTA an SM
#define FLETCHER_COOP_UNROLL 2     // uint4 loads in flight a thread

// a cooperative launch: out[2 + 2b] is CTA b's pair; after a grid-wide
// sync CTA 0 folds them into out[0..1]
template <bool VEC>
__global__ void __launch_bounds__(FLETCHER_COOP_THREADS)
fletcher_coop_kernel(const uint8_t* __restrict__ in, int64_t n_bytes,
                     uint32_t* out) {
  uint32_t s1 = 0, s2 = 0;
  thread_sums<VEC, FLETCHER_COOP_UNROLL>(
      in, n_bytes, (int64_t)blockIdx.x * FLETCHER_COOP_THREADS + threadIdx.x,
      (int64_t)gridDim.x * FLETCHER_COOP_THREADS, s1, s2);
  cta_sums<FLETCHER_COOP_THREADS>(s1, s2);
  if (threadIdx.x == 0) {
    out[2 + 2 * blockIdx.x] = s1;
    out[3 + 2 * blockIdx.x] = s2;
  }
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;
  s1 = s2 = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += FLETCHER_COOP_THREADS) {
    s1 += __ldcg(out + 2 + 2 * b);
    s2 += __ldcg(out + 3 + 2 * b);
  }
  cta_sums<FLETCHER_COOP_THREADS>(s1, s2);
  if (threadIdx.x == 0) {
    out[0] = s1;
    out[1] = s2;
  }
}

extern "C" int fletcher(const void* in, int64_t n_bytes, void* out,
                        void* stream) {
  if (n_bytes < 1) return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)in % 16 == 0;
  const int64_t items = vec ? n_bytes / 16 : (n_bytes + 3) / 4;
  const int64_t per_cta =
      (int64_t)FLETCHER_COOP_THREADS * (vec ? FLETCHER_COOP_UNROLL : 1);
  int64_t ctas = (items + per_cta - 1) / per_cta;
  if (ctas < 1) ctas = 1;
  if (ctas > 132) ctas = 132;
  const uint8_t* p = (const uint8_t*)in;
  uint32_t* o = (uint32_t*)out;
  void* args[] = {(void*)&p, (void*)&n_bytes, (void*)&o};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      vec ? (const void*)fletcher_coop_kernel<true>
          : (const void*)fletcher_coop_kernel<false>,
      dim3((unsigned)ctas), dim3(FLETCHER_COOP_THREADS), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""
SC_BODY = ("                     uint32_t key, uint32_t nonce) {\n"
           "  const int64_t tid")
SC_KEYSTREAM = ("""        const uint64_t j = (uint64_t)c * 4;
        v[u].x ^= keystream(j, key, nonce);
        v[u].y ^= keystream(j + 1, key, nonce);
        v[u].z ^= keystream(j + 2, key, nonce);
        v[u].w ^= keystream(j + 3, key, nonce);
""", "")
SC_WAVE = r"""#include <atomic>

// CTAs of one wave of the kernel on the current device: its occupancy
// times the SMs, asked once a device
template <bool VEC>
static cudaError_t one_wave(int64_t* ctas) {
  static std::atomic<int> known[64];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int wave = known[dev & 63].load(std::memory_order_relaxed);
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stream_cipher_kernel<VEC>, CIPHER_THREADS, 0);
    if (err != cudaSuccess) return err;
    wave = sms * (per_sm > 0 ? per_sm : 1);
    known[dev & 63].store(wave, std::memory_order_relaxed);
  }
  *ctas = wave;
  return cudaSuccess;
}

template <bool VEC>
static cudaError_t launch(const void* in, void* out, int64_t n_bytes,
                          uint32_t key, uint32_t nonce, cudaStream_t st) {
  const int64_t items = VEC ? (n_bytes + 15) / 16 : n_bytes;
  int64_t blocks = (items + CIPHER_THREADS - 1) / CIPHER_THREADS, wave = 0;
  const cudaError_t err = one_wave<VEC>(&wave);
  if (err != cudaSuccess) return err;
  if (blocks > wave) blocks = wave;  // grid-stride beyond one wave
  stream_cipher_kernel<VEC><<<(unsigned)blocks, CIPHER_THREADS, 0, st>>>(
      (const uint8_t*)in, (uint8_t*)out, n_bytes, key, nonce);
  return cudaGetLastError();
}

extern "C" int stream_cipher(const void* in, void* out, int64_t n_bytes,
                             uint32_t key, uint32_t nonce, void* stream) {
  if (n_bytes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  return (int)(vec ? launch<true>(in, out, n_bytes, key, nonce, st)
                   : launch<false>(in, out, n_bytes, key, nonce, st));
}
"""

# name -> (source, edits, exact): an edit is (old, new), or (start, end,
# new) replacing the text from `start` up to and including the first
# `end` after it
VARIANTS = {
    "fl_base": ("fletcher.cu", [], True),
    "fl_empty": ("fletcher.cu", [(FL_BODY, "  return;\n" + FL_BODY)], False),
    "fl_loadonly": ("fletcher.cu", [
        FL_WEIGHTS, ("  cta_sums<FLETCHER_THREADS>(s1, s2);\n", FL_STORE_IF)],
        False),
    "fl_noatomic": ("fletcher.cu", [FL_ATOMICS], False),
    "fl_memset": ("fletcher.cu", [FL_MEMSET], True),
    "fl_ctas256": ("fletcher.cu", [(FL_GRID, FL_GRID.replace("2 *", "1 *"))],
                   True),
    "fl_ctas64": ("fletcher.cu", [(FL_GRID, FL_GRID.replace("2 *", "4 *"))],
                  True),
    "fl_cluster": ("fletcher.cu", [(FL_KERNEL, FL_END,
                                    FL_CLUSTER)], True),
    "fl_cluster_nofold": ("fletcher.cu", [
        (FL_KERNEL, FL_END, FL_CLUSTER),
        FL_CLUSTER_FOLD], False),
    "fl_cl8": ("fletcher.cu", [
        (FL_KERNEL, FL_END, FL_CLUSTER),
        ("#define FLETCHER_CLUSTER_MAX 16 ", "#define FLETCHER_CLUSTER_MAX 8 "),
        ("#define FLETCHER_CLUSTER_UNROLL 4 ",
         "#define FLETCHER_CLUSTER_UNROLL 8 ")], True),
    "fl_coop": ("fletcher.cu", [(FL_KERNEL, FL_END,
                                 FL_COOP)], True),
    "fl_parent": ("parent:fletcher.cu", [], True),
    "fl_parent_nomemset": ("parent:fletcher.cu", [PARENT_MEMSET], False),
    "sc_base": ("stream_cipher.cu", [], True),
    "sc_empty": ("stream_cipher.cu", [
        (SC_BODY, SC_BODY.replace("  const", "  return;\n  const"))], False),
    "sc_loadonly": ("stream_cipher.cu", [SC_KEYSTREAM], False),
    "sc_wave": ("stream_cipher.cu", [
        ("#define CIPHER_UNROLL 4", "#define CIPHER_UNROLL 8"),
        ("        dst[c] = v[u];", "        __stcs(dst + c, v[u]);"),
        ('extern "C" int stream_cipher(', FL_END, SC_WAVE)], True),
    "sc_parent": ("parent:stream_cipher.cu", [], True),
}
SWEEPS = ("fl_base", "fl_memset", "fl_cluster", "fl_coop", "fl_ctas256",
          "fl_ctas64", "fl_parent")


def edit(name: str, source: str, change: tuple) -> str:
    if len(change) == 2:
        old, new = change
        if source.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not in the source "
                             "once")
        return source.replace(old, new)
    start, end, new = change
    i = source.find(start)
    j = source.find(end, i)
    if i < 0 or j < 0:
        raise SystemExit(f"variant {name}: {start!r} ... {end!r} is not in "
                         "the source")
    return source[:i] + new + source[j + len(end):]


def build(name: str):
    """The variant's library, or None where nvcc refuses it."""
    from repro_torch.kernels import _build
    src, edits, _ = VARIANTS[name]
    source = ((PARENT / "src" / "repro_torch" / "csrc" / src[7:])
              if src.startswith("parent:") else CSRC / src).read_text()
    for change in edits:
        source = edit(name, source, change)
    cu = OUT_DIR / f"{name}.cu"
    cu.write_text(source)
    so = OUT_DIR / f"lib{name}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        print(f"variant {name}: nvcc failed\n{res.stderr[-3000:]}")
        return None
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip()}")
    return str(so)


def bind(lib, fletcher: bool):
    """The variant's C entry, fletcher or stream_cipher."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    if fletcher:
        lib.fletcher.argtypes = [p, i64, p, p]
        lib.fletcher.restype = ctypes.c_int
        return lib.fletcher
    lib.stream_cipher.argtypes = [p, p, i64, ctypes.c_uint32,
                                  ctypes.c_uint32, p]
    lib.stream_cipher.restype = ctypes.c_int
    return lib.stream_cipher


def time_variant(name: str, lib, big, stream) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.fletcher import ref as flref
    from repro_torch.kernels.stream_cipher import ref as scref
    fletcher = name.startswith("fl_")
    entry = bind(lib, fletcher)
    out = torch.zeros(1024, dtype=torch.int32, device="cuda").view(
        torch.uint32)                          # coop: its pairs after out
    key, nonce = 0xC0FFEE, 42
    names = ("fletcher_", cs.MEMSET) if fletcher else ("stream_cipher_",)

    def runner(x, dst):
        def call() -> None:
            if fletcher:
                err = entry(x.data_ptr(), x.numel(), dst.data_ptr(), stream)
            else:
                err = entry(x.data_ptr(), dst.data_ptr(), x.numel(), key,
                            nonce, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call

    def held(x) -> None:
        dst = out if fletcher else torch.empty_like(x)
        dst.view(torch.uint8).zero_()
        runner(x, dst)()
        got = dst[:2] if fletcher else dst
        want = (flref.fletcher_checksum_torch(x) if fletcher
                else scref.stream_cipher_torch(x, key, nonce))
        torch.cuda.synchronize()
        cs.check(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
                 f"{name} differs from the plain version at {x.numel()} B, "
                 f"start {x.data_ptr() % 16}")

    if VARIANTS[name][2]:
        for x in (big[:16], big[:MiB], big[1:MiB + 1], big[:(4 << 20) + 4],
                  big):
            held(x)
    blocks = [big[i * MiB:(i + 1) * MiB] for i in range(128)]
    legs = {}
    for leg, xs, iters in (("1MiB", blocks, 100), ("floor", [big[:16]], 100),
                           ("1GiB", [big], 10)):
        turn = itertools.cycle(xs)
        dst = out if fletcher else torch.empty_like(xs[0])
        ms, by_op, ops = cs.device_ops_ms(
            lambda: runner(next(turn), dst)(), iters, names)
        legs[leg] = {"ms": ms, "ops": ops, "by_op": by_op}
    print(f"{name:20s} " + "  ".join(
        f"{leg} {v['ms']:.6f} ms ({v['ops']} op: " + ", ".join(
            f"{k} {t:.6f}" for k, t in v["by_op"].items()) + ")"
        for leg, v in legs.items()), flush=True)
    if name in SWEEPS:
        row = []
        for n in SWEEP:
            xs = [big[i * n:(i + 1) * n]
                  for i in range(min(128, big.numel() // n))]
            turn = itertools.cycle(xs)
            ms, _, ops = cs.device_ops_ms(lambda: runner(next(turn), out)(),
                                          100, names)
            row.append(f"{n} B {ms:.6f} ms ({ops} op)")
        print(f"  {name} sweep: " + ", ".join(row), flush=True)


def calls(order: list) -> int:
    """Each tree's wrappers timed in a process of its own, in turn."""
    for which in order:
        src = ROOT / "src" if which == "change" else PARENT / "src"
        res = subprocess.run(
            [sys.executable, __file__, "--call-of", str(src)],
            capture_output=True, text=True, cwd=ROOT)
        if res.returncode:
            print(res.stdout, res.stderr)
            return res.returncode
        print(f"{which:7s} {res.stdout.strip()}", flush=True)
    return 0


def call_of(src: str) -> int:
    """The whole wrappers' call at 1 MiB of the package under `src`."""
    sys.path.insert(0, src)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.fletcher import ops as flops
    from repro_torch.kernels.stream_cipher import ops as scops
    big = torch.randint(0, 256, (128 * MiB,), dtype=torch.uint8,
                        device="cuda")
    blocks = [big[i * MiB:(i + 1) * MiB] for i in range(128)]
    res = {}
    for name, fn in (("fletcher_checksum", flops.fletcher_checksum),
                     ("stream_cipher", lambda x: scops.stream_cipher(x, 1, 2))):
        turn = itertools.cycle(blocks)
        res[name] = cs.cuda_ms(lambda: fn(next(turn)), 1000)
    print(json.dumps({"call_ms": res, "package": flops.__file__}))
    return 0


def main() -> int:
    sys.path.insert(0, str(ROOT))
    if len(sys.argv) > 2 and sys.argv[1] == "--call-of":
        return call_of(sys.argv[2])
    if len(sys.argv) > 2 and sys.argv[1] == "--calls":
        return calls(sys.argv[2].split(","))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke as cs
    names = (sys.argv[1].split(",") if len(sys.argv) > 1
             else [v for v in VARIANTS if "parent" not in v])
    print(cs.card_line())
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    unique = list(dict.fromkeys(names))
    with ThreadPoolExecutor(len(unique)) as ex:
        libs = dict(zip(unique, ex.map(build, unique)))
    stream = torch.cuda.current_stream().cuda_stream
    big = torch.randint(0, 256, (1 << 30,), dtype=torch.uint8, device="cuda")
    for name in names:
        if libs[name] is not None:
            time_variant(name, ctypes.CDLL(libs[name]), big, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
