#!/usr/bin/env python3
"""The dry-run's records (`results/dryrun_torch/`, written by
`python -m repro_torch.launch.dryrun --all`) as one markdown table: a
row per arch and mesh (16 x 16, 2 x 16 x 16), a column per shape holding
the per-rank peak GB, FLOPs, collective bytes and trace seconds, then
every failed cell with its error.

    PYTHONPATH=src python3 scripts/dryrun_table.py [--variant V]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MESHES = ("16x16", "2x16x16")


def cell(rec) -> str:
    if rec is None:
        return "not run"
    if "skipped" in rec:
        return "skipped"
    if not rec.get("ok"):
        return "FAILED"
    return (f"{rec['memory']['peak_memory_in_bytes'] / 1e9:,.1f}, "
            f"{rec['flops_per_device']:.3e}, "
            f"{rec['collective_bytes_per_device']:.3e}, "
            f"{rec['trace_s']}")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.common.config import SHAPES
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import cell_path

    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="")
    args = ap.parse_args()
    print("| arch | mesh | " + " | ".join(
        f"{s.name}: peak GB, FLOP, collective B, trace s" for s in SHAPES)
        + " |")
    print("| --- | --- | " + " | ".join("---" for _ in SHAPES) + " |")
    failed = []
    for arch in ARCHS:
        for mp, mesh in zip((False, True), MESHES):
            recs = []
            for shape in SHAPES:
                path = cell_path(arch, shape.name, mp, args.variant)
                rec = json.loads(path.read_text()) if path.exists() else None
                recs.append(rec)
                if rec is not None and rec.get("ok") is False:
                    failed.append(rec)
            print(f"| {arch} | {mesh} | "
                  + " | ".join(cell(r) for r in recs) + " |")
    for rec in failed:
        print(f"\nFAILED {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
              f"{rec['error'].strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
