#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card: for each
seed, one short run of the cell (its own batch, prompts and output
lengths; a window of `--seconds`, at least one wave), the program's
numbers as a run compares them, and the control's: the reference put in
the program's place in float8 (e4m3, scaled a tensor or a row; the step
below the bfloat16 the configurations compute in), read at the same
positions by the same gap.

    python3 portbench/control.py --workload granite-3-2b.chat \
        --seeds 1,2,3 --seconds 1

One JSON line a seed. The benchmark's own runs do not run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.fp8 import mm_fp8
    from portbench.run import run_cell
    from portbench.spec import load_cell
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        rec = run_cell(cell, seed, args.seconds, False, "cuda", t,
                       control=mm_fp8)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": rec["correct"], **rec["values"],
                          "waves": len(rec["window"]["waves"]),
                          "requests": len(rec["window"]["requests"]),
                          "s": time.perf_counter() - t}), flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
