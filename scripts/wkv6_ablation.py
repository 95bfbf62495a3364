#!/usr/bin/env python3
"""Where the time of the two wkv6 kernels goes, by switching parts off.

    python3 scripts/wkv6_ablation.py [VARIANT,...]

From the root of a checkout, on a CUDA card with nvcc. It builds copies of
`src/repro_torch/csrc/wkv6.cu` with one part of a kernel removed (their
outputs are wrong; only their times count) into `build/wkv6_ablation/`,
in parallel, and prints each kernel's device time (torch.profiler, as
chip_smoke.py times kernels) at rwkv6-1.6b's prefill shape (4, 1024, 32,
64), with no initial state. The variants:

  base           the kernels as they are;
  out_noload     the out kernel copies nothing in: its compute alone;
  out_nocompute  the out kernel computes nothing but loads, the log scan
                 and stores: its memory traffic alone;
  out_nopair     no pair scores on the diagonal blocks;
  out_nomma      no products in the out kernel;
  state_loadonly the state kernel's copies alone (no scan, product or
                 workspace store);
  state_storeonly the state kernel's workspace stores alone;
  state_nomma    no product in the state kernel.

A variant whose text no longer matches the source stops the script.
"""
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as WK  # noqa: E402

PAIRS = ("for (int i = 0; i < HD / 4; ++i) {\n      const float4 r4",
         "for (int i = 0; i < 0; ++i) {\n      const float4 r4")
OUT_PRODUCTS = [
    ("#pragma unroll 2\n  for (int k0 = 0; k0 < HD; k0 += 8) {",
     "#pragma unroll 2\n  for (int k0 = 0; k0 < 0; k0 += 8) {"),
    ("for (int k0 = 0; k0 < kend; k0 += 8)",
     "for (int k0 = 0; k0 < 0; k0 += 8)"),
    ("      load_a(ks + SUB * PA, PA, k0, ah, al);",
     "      if (k0 < 0) load_a(ks + SUB * PA, PA, k0, ah, al);"),
    ("  } else if (warp < 6) {", "  } else if (warp < 0) {")]
STATE_PRODUCT = ("for (int k0 = 0; k0 < C; k0 += 8) {\n      uint32_t ah[4]",
                 "for (int k0 = 0; k0 < 0; k0 += 8) {\n      uint32_t ah[4]")
STATE_SCAN = ("      log_cumsum<true>(x, T - c * C);\n",
              "      for (int e = 0; e < CPW; ++e) x[e] = 0.f;\n")
STATE_STORE = ("        st2(wsc + (i0", "        if (c < 0) st2(wsc + (i0")
STATE_LOAD = ("      for (int m = 0; m < L::PIECES; ++m) {\n        const bool ok",
              "      for (int m = 0; m < 0; ++m) {\n        const bool ok")
VARIANTS = {
    "base": [],
    "out_noload": [("    cp_async16(rs + t * PA + p, a.r + g0, ok);\n", ""),
                   ("    cp_async16(ks + t * PA + p, a.k + g0, ok);\n", ""),
                   ("    cp_async16(vs + t * PB + p, a.v + g0, ok);\n", ""),
                   ("    cp_async16(cm + (t + 1) * PA + p, a.w + g0, ok);\n",
                    ""),
                   ("    cp_async16(S + i * PB + p, Sg + (int64_t)i * HD + p, "
                    "true);\n", "")],
    "out_nocompute": [PAIRS, *OUT_PRODUCTS,
                      ("for (int e = tid; e < C * HD; e += OUT_THREADS) {\n"
                       "    const int t = e / HD, i = e % HD;",
                       "for (int e = tid; e < 0; e += OUT_THREADS) {\n"
                       "    const int t = e / HD, i = e % HD;"),
                      ("      for (int i = 0; i < HD; ++i) x = fmaf(rt[i] * "
                       "us[i], kk[i], x);\n", "")],
    "out_nopair": [PAIRS],
    "out_nomma": OUT_PRODUCTS,
    "state_loadonly": [STATE_SCAN, STATE_PRODUCT, STATE_STORE],
    "state_storeonly": [STATE_LOAD, STATE_SCAN, STATE_PRODUCT],
    "state_nomma": [STATE_PRODUCT],
}
OUT_DIR = ROOT / "build" / "wkv6_ablation"


def build(name: str, source: str) -> str:
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not in the source "
                             "once")
        source = source.replace(old, new)
    cu = OUT_DIR / f"{name}.cu"
    cu.write_text(source)
    so = OUT_DIR / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    return str(so)


def main() -> int:
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    print(cs.card_line())
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "wkv6.cu").read_text()
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(lambda n: build(n, source), names)))
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, T, H, hd = cs.WKV_PREFILL

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    r, k, v = randn(B, T, H, hd), 0.5 * randn(B, T, H, hd), randn(B, T, H, hd)
    w = torch.exp(-torch.exp(randn(B, T, H, hd)))
    u = 0.5 * randn(H, hd)
    y = torch.empty_like(r)
    s = torch.empty(B, H, hd, hd, device="cuda")
    ws = torch.empty(B, H, -(-T // WK.CHUNK), hd, hd, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        WK._bind(lib)

        def call() -> None:
            err = lib.wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           w.data_ptr(), u.data_ptr(), None, y.data_ptr(),
                           s.data_ptr(), ws.data_ptr(), B, T, H, hd, stream)
            if err:
                raise RuntimeError(f"variant {name}: CUDA error {err}")
        times = {kn: cs.kernel_device_ms(call, 20, kn) for kn in WK.KERNELS}
        print(f"{name:16s} " + "  ".join(
            f"{kn} {t:.6f} ms" for kn, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
