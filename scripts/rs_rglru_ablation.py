#!/usr/bin/env python3
"""Where the time of the rs_matmul and rglru_scan kernels goes, by
switching parts off, and how rglru_scan's window sizes compare.

    python3 scripts/rs_rglru_ablation.py [VARIANT,...]

From the root of a checkout, on a CUDA card with nvcc. It builds copies of
`src/repro_torch/csrc/rs_parity.cu` and `rglru_scan.cu` with one part
removed or one size changed into `build/rs_rglru_ablation/`, in parallel,
and prints each kernel's device time (torch.profiler, as chip_smoke.py
times kernels) at the main paths' shapes: rs_matmul's encode (2, 4,
262144), decode (1, 4, 262144) and delta (2, 1, 262144) and its launch
floor at L = 16; rglru_scan's prefill (4, 1024, 2560, no h0) and decode
(4, 1, 2560, h0). The variants (outputs of all but base and the rg_seg* /
rg_warps* sizes are wrong; only their times count):

  rs_base        rs_matmul as it is;
  rs_nolookup    its loads and stores, each output word the XOR of the
                 input words (no split, no lookup);
  rs_noload      its lookups and stores, the input words made from the
                 column index (no load);
  rs_branchy     a branch around every coefficient's lookup (a guard that
                 is always true: lo[0] = 0), as before the kernel became a
                 template on s;
  rs_empty       the same grid, every thread returning at once;
  rg_base        rglru_scan as it is;
  rg_nocarry     no fold of the warps' (A, H) into carries;
  rg_nosync      no fold and no barrier (nothing shared between warps);
  rg_loadonly    loads and stores alone: h = a + b, no scan, no barrier;
  rg_empty       the same grid, no load, no store;
  rg_seg4, rg_seg16, rg_warps4, rg_warps16
                 RGLRU_SEG or RGLRU_WARPS at 4, 16 (8 in the source);
  rs_parent, rg_parent
                 the kernels of the parent commit, where its tree is
                 unpacked into build/parent (`git archive`): time parent,
                 change, change, parent in one call, as
                 `rs_parent,rs_base,rs_base,rs_parent`.

Names may repeat; each is built once and timed where it stands. A variant
whose text no longer matches the source stops the script.
"""
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as RGK  # noqa: E402
from repro_torch.kernels.rs_parity import kernel as RSK  # noqa: E402
from repro_torch.kernels.rs_parity import ref  # noqa: E402

RS_LOOKUP = ("""          acc ^= nib16(a.tab[j][i][0], a.tab[j][i][1], a.tab[j][i][2],
                       a.tab[j][i][3], p[i].sel_lo, p[i].mask_lo) ^
                 nib16(a.tab[j][i][4], a.tab[j][i][5], a.tab[j][i][6],
                       a.tab[j][i][7], p[i].sel_hi, p[i].mask_hi);""",
             "          acc ^= x[i] + (uint32_t)j;")
RS_LOAD = ("x[i] = __ldg(reinterpret_cast<const uint32_t*>(row));",
           "x[i] = (uint32_t)w * 2654435761u + (uint32_t)i;")
RG_FOLD = ("    for (int j = 0; j < k; ++j) x = fmaf(sA[j][lane], x, "
           "sH[j][lane]);\n", "")
RG_SYNC1 = ("    sH[k][lane] = H;\n    __syncthreads();\n",
            "    sH[k][lane] = H;\n")
RG_SYNC2 = ("    __syncthreads();  // every warp has read carry, sA and sH\n",
            "")
RG_LOCAL = ("      H = fmaf(av[u], H, bv[u]);\n      A *= av[u];\n", "")
RG_FIX = ("      x = fmaf(av[u], x, bv[u]);\n", "      x = av[u] + bv[u];\n")
VARIANTS = {
    "rs_base": ("rs_parity.cu", []),
    "rs_nolookup": ("rs_parity.cu", [RS_LOOKUP]),
    "rs_noload": ("rs_parity.cu", [RS_LOAD]),
    "rs_branchy": ("rs_parity.cu", [
        (RS_LOOKUP[0], "          if (a.tab[j][i][0] != 0xFFFFFFFFu)\n"
         + RS_LOOKUP[0])]),
    "rs_empty": ("rs_parity.cu", [("w < nword; w += step)",
                                   "w < 0; w += step)")]),
    "rg_base": ("rglru_scan.cu", []),
    "rg_nocarry": ("rglru_scan.cu", [RG_FOLD]),
    "rg_nosync": ("rglru_scan.cu", [RG_FOLD, RG_SYNC1, RG_SYNC2]),
    "rg_loadonly": ("rglru_scan.cu", [RG_FOLD, RG_SYNC1, RG_SYNC2, RG_LOCAL,
                                      RG_FIX]),
    "rg_empty": ("rglru_scan.cu", [
        ("  if (c >= channels) return;\n", "  return;\n"),
        ("  load(0);\n", ""),
                                   ("t0 < T; t0 += window)",
                                    "t0 < 0; t0 += window)")]),
    "rg_seg4": ("rglru_scan.cu", [("#define RGLRU_SEG 8 ",
                                   "#define RGLRU_SEG 4 ")]),
    "rg_seg16": ("rglru_scan.cu", [("#define RGLRU_SEG 8 ",
                                    "#define RGLRU_SEG 16 ")]),
    "rg_warps4": ("rglru_scan.cu", [("#define RGLRU_WARPS 8 ",
                                     "#define RGLRU_WARPS 4 ")]),
    "rg_warps16": ("rglru_scan.cu", [("#define RGLRU_WARPS 8 ",
                                      "#define RGLRU_WARPS 16 ")]),
    "rs_parent": ("parent:rs_parity.cu", []),
    "rg_parent": ("parent:rglru_scan.cu", []),
}
OUT_DIR = ROOT / "build" / "rs_rglru_ablation"
PARENT = ROOT / "build" / "parent" / "src" / "repro_torch" / "csrc"
RS_LEGS = {"encode": ref.cauchy_matrix(4, 2),
           "decode": ref.decode_matrix(4, 2, [0, 1, 3, 4], [2]),
           "delta": np.ascontiguousarray(ref.cauchy_matrix(4, 2)[:, [1]])}


def build(name: str) -> str:
    src, edits = VARIANTS[name]
    source = (PARENT / src[len("parent:"):] if src.startswith("parent:")
              else _build.CSRC / src).read_text()
    for old, new in edits:
        if source.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not in the source "
                             "once")
        source = source.replace(old, new)
    cu = OUT_DIR / f"{name}.cu"
    cu.write_text(source)
    so = OUT_DIR / f"lib{name}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip()}")
    return str(so)


def time_rs(lib, stream, parent: bool, exact: bool) -> dict:
    """Times at the three legs and the floor; where the variant is
    `exact`, its output is first held against the plain version."""
    gen = np.random.default_rng(1)
    times = {}
    for leg, L in (("encode", 262144), ("decode", 262144), ("delta", 262144),
                   ("floor", 16)):
        mat = RS_LEGS["encode" if leg == "floor" else leg]
        m, s = mat.shape
        # the parent's kernel takes the coefficients, this one their tables
        tabs = (mat.tobytes() if parent
                else RSK._tables(mat.tobytes(), m, s))
        x = torch.from_numpy(gen.integers(0, 256, (s, L), np.uint8)).cuda()
        out = torch.empty((m, L), dtype=torch.uint8, device="cuda")

        def call() -> None:
            err = lib.rs_matmul(tabs, m, s, x.data_ptr(), out.data_ptr(), L,
                                stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        if exact:
            call()
            cs.check(torch.equal(out, ref.gf_matmul_torch(mat, x)),
                     f"{leg}: differs from the plain version")
        times[leg] = cs.kernel_device_ms(call, 100, "rs_matmul")
    return times


def time_rg(lib, stream, exact: bool) -> dict:
    """Times at both legs; where the variant is `exact`, its h is first
    held against the plain version to 1e-5."""
    from repro_torch.kernels.rglru_scan import ref as rref
    gen = torch.Generator(device="cuda").manual_seed(2)
    times = {}
    for leg, (B, T, R), with_h0 in (("prefill", cs.RGLRU_PREFILL, False),
                                    ("decode", cs.RGLRU_DECODE, True)):
        a = torch.sigmoid(2 * torch.randn(B, T, R, generator=gen,
                                          device="cuda"))
        b = torch.randn(B, T, R, generator=gen, device="cuda")
        h0 = torch.randn(B, R, generator=gen, device="cuda")
        h = torch.empty_like(a)

        def call() -> None:
            err = lib.rglru_scan(a.data_ptr(), b.data_ptr(),
                                 h0.data_ptr() if with_h0 else None,
                                 h.data_ptr(), B, T, R, 0, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        if exact:
            call()
            want = rref.rglru_scan_ref(a, b, h0 if with_h0 else None)
            err, ok = cs.in_tolerance(h, want, 1e-5)
            cs.check(ok, f"{leg}: off the plain version by {err}")
        times[leg] = cs.kernel_device_ms(call, 50, "rglru_scan")
    return times


def main() -> int:
    names = (sys.argv[1].split(",") if len(sys.argv) > 1
             else [v for v in VARIANTS if "parent" not in v])
    print(cs.card_line())
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    unique = list(dict.fromkeys(names))
    with ThreadPoolExecutor(len(unique)) as ex:
        libs = dict(zip(unique, ex.map(build, unique)))
    stream = torch.cuda.current_stream().cuda_stream
    for name in names:
        lib = ctypes.CDLL(libs[name])
        if name.startswith("rs_"):
            RSK._bind(lib)
            times = time_rs(lib, stream, parent=name == "rs_parent",
                            exact=name in ("rs_base", "rs_parent", "rs_branchy"))
        else:
            RGK._bind(lib)
            times = time_rg(lib, stream, exact=name in (
                "rg_base", "rg_parent", "rg_seg4", "rg_seg16", "rg_warps4",
                "rg_warps16"))
        print(f"{name:12s} " + "  ".join(f"{leg} {t:.6f} ms"
                                         for leg, t in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
