#!/usr/bin/env python3
"""The host call of the five kernel wrappers that launch through
`kernels/_launch.py` `call_on` (rs_matmul, flash_attention_fwd,
flash_attention_bwd, rglru_scan, wkv6), in two trees of the repo.

    git archive PARENT | tar -x -C build/parent    # the tree to compare
    python3 scripts/wrapper_call_ab.py parent,change,change,parent

From the root of a checkout, on a CUDA card with nvcc. Each tree's
wrappers are timed in a process of their own, in the order given
("change" is this checkout, "parent" the tree under build/parent; each
builds its kernels into its own build/kernels): the mean time a call over
1,000 back-to-back calls of the wrapper in `kernel.py` (CUDA events, as
chip_smoke.py's `cuda_ms`), at each kernel's one-CTA floor shape, where a
call takes as long as its host part, and for rglru_scan also at the
decode shape of recurrentgemma-2b, which the serve path calls 18 times a
step. The four model kernels are also timed through the public functions
of their `ops.py` ("(ops)" below), which the models call: since the
dry-run slice these dispatch through each kernel's `torch.library`
custom op, so the pair of trees shows what the dispatcher adds to an
eager call. Prints one JSON line a process.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PARENT = ROOT / "build" / "parent"
CALLS = 1000


def calls_of(src: str) -> int:
    """The wrappers' call times of the package under `src`."""
    sys.path.insert(0, src)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import kernel_bwd as FKB
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rglru_scan import kernel as RK
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.rs_parity import kernel as K
    from repro_torch.kernels.rs_parity import ref
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan import ops as wops

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    mat = ref.cauchy_matrix(4, 2)
    cells = torch.randint(0, 256, (4, 16), dtype=torch.uint8, device="cuda")
    q, k, v, dout = (randn(1, 16, 1, 64).bfloat16() for _ in range(4))
    out, lse = FK.flash_attention_fwd(q, k, v, scale=0.125, causal=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    a, b, h0 = (torch.sigmoid(randn(1, 1, 32)), randn(1, 1, 32),
                randn(1, 32))
    da, db, dh0 = (torch.sigmoid(randn(4, 1, 2560)), randn(4, 1, 2560),
                   randn(4, 2560))
    w = (randn(1, 1, 1, 16), randn(1, 1, 1, 16), randn(1, 1, 1, 16),
         torch.exp(-torch.exp(randn(1, 1, 1, 16))), randn(1, 16))
    wrappers = {
        "rs_matmul (2, 4, 16)": lambda: K.rs_matmul(mat, cells),
        "flash_attention_fwd (1, 16, 1, 1, 64)":
            lambda: FK.flash_attention_fwd(q, k, v, scale=0.125,
                                           causal=True),
        "flash_attention_bwd (1, 16, 1, 1, 64)":
            lambda: FKB.flash_attention_bwd(q, k, v, dout, lse, delta,
                                            scale=0.125),
        "rglru_scan (1, 1, 32)": lambda: RK.rglru_scan(a, b, h0),
        "rglru_scan (4, 1, 2560)": lambda: RK.rglru_scan(da, db, dh0),
        "wkv6 (1, 1, 1, 16)": lambda: WK.wkv6(*w),
        "flash_attention (ops) (1, 16, 1, 1, 64)":
            lambda: fops.flash_attention(q, k, v, scale=0.125),
        "flash_attention_backward (ops) (1, 16, 1, 1, 64)":
            lambda: fops.flash_attention_backward(q, k, v, out, lse, dout,
                                                  scale=0.125),
        "rglru_scan (ops) (1, 1, 32)": lambda: rops.rglru_scan(a, b, h0),
        "rglru_scan (ops) (4, 1, 2560)": lambda: rops.rglru_scan(da, db,
                                                                 dh0),
        "wkv6 (ops) (1, 1, 1, 16)": lambda: wops.wkv6(*w),
    }
    res = {name: cs.cuda_ms(fn, CALLS) for name, fn in wrappers.items()}
    print(json.dumps({"call_ms": res, "card": cs.card_line(),
                      "package": str(Path(K.__file__).parents[2])}))
    return 0


def main() -> int:
    sys.path.insert(0, str(ROOT))
    if len(sys.argv) > 2 and sys.argv[1] == "--calls-of":
        return calls_of(sys.argv[2])
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    for which in sys.argv[1].split(","):
        src = ROOT / "src" if which == "change" else PARENT / "src"
        res = subprocess.run(
            [sys.executable, __file__, "--calls-of", str(src)],
            capture_output=True, text=True, cwd=ROOT)
        if res.returncode:
            print(res.stdout, res.stderr)
            return res.returncode
        print(f"{which:7s} {res.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
