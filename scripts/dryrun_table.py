#!/usr/bin/env python3
"""The dry-run's records (`results/dryrun_torch/`, written by
`python -m repro_torch.launch.dryrun --all`) as one markdown table: a
row per arch and mesh (16 x 16, 2 x 16 x 16), a column per shape holding
the per-rank peak GB, FLOPs, collective bytes and trace seconds, then
every failed cell with its error. With `--before DIR` (another tree's
`results/dryrun_torch/`, e.g. a parent commit unpacked by `git archive`
and run the same way), one row per arch on 16 x 16 instead: the peak GB
and FLOPs at train_4k, prefill_32k and decode_32k, before -> after.
With `--variant V` alone (a perf variant of `launch/dryrun.py`, traced
with `--variant V`), one row per cell the variant has a record of: its
all-reduces, all-gathers, FLOPs and peak GB a rank, the baseline's (the
same cell without the variant) -> the variant's.

    PYTHONPATH=src python3 scripts/dryrun_table.py [--variant V] [--before DIR]
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


COMPARED = ("train_4k", "prefill_32k", "decode_32k")


def _peak_flops(rec) -> str:
    if rec is None or not rec.get("ok") or "skipped" in rec:
        return "not run" if rec is None else ("FAILED" if not rec.get("ok")
                                               else "skipped")
    return (f"{rec['memory']['peak_memory_in_bytes'] / 1e9:,.1f} GB, "
            f"{rec['flops_per_device']:.3e}")


def before_after(before: Path, archs, cell_path, variant: str) -> int:
    """Each arch's 16 x 16 cells of COMPARED: peak GB and FLOPs a rank in
    `before`'s records -> in this tree's."""
    print("| arch | " + " | ".join(
        f"{s}: peak, FLOP a rank, before -> after" for s in COMPARED) + " |")
    print("| --- | " + " | ".join("---" for _ in COMPARED) + " |")
    for arch in archs:
        row = []
        for shape in COMPARED:
            path = cell_path(arch, shape, False, variant)
            old = before / path.name
            recs = [json.loads(p.read_text()) if p.exists() else None
                    for p in (old, path)]
            row.append(" -> ".join(_peak_flops(r) for r in recs))
        print(f"| {arch} | " + " | ".join(row) + " |")
    return 0


def _counts(rec) -> tuple:
    c = rec["collective_counts"]
    return (c.get("all-reduce", 0), c.get("all-gather", 0),
            f"{rec['flops_per_device']:.6e}",
            f"{rec['memory']['peak_memory_in_bytes'] / 1e9:.3f}")


def variant_vs_base(archs, shapes, cell_path, variant: str) -> int:
    """Every cell with a record of `variant`: the baseline's counts ->
    the variant's."""
    print("| arch | shape | mesh | all-reduce | all-gather | FLOP a rank | "
          "peak GB a rank |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for arch in archs:
        for shape in shapes:
            for mp, mesh in zip((False, True), MESHES):
                path = cell_path(arch, shape, mp, variant)
                if not path.exists():
                    continue
                base = cell_path(arch, shape, mp, "")
                recs = [json.loads(q.read_text()) if q.exists() else None
                        for q in (base, path)]
                if not all(r and r.get("ok") and "skipped" not in r
                           for r in recs):
                    print(f"| {arch} | {shape} | {mesh} | "
                          + " | ".join(["not run or failed"] * 4) + " |")
                    continue
                cols = zip(*(_counts(r) for r in recs))
                print(f"| {arch} | {shape} | {mesh} | "
                      + " | ".join(f"{a} -> {b}" for a, b in cols) + " |")
    return 0


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.common.config import SHAPES
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import cell_path

    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="")
    ap.add_argument("--before", type=Path, default=None)
    args = ap.parse_args()
    if args.before is not None:
        return before_after(args.before, ARCHS, cell_path, args.variant)
    if args.variant:
        return variant_vs_base(ARCHS, [s.name for s in SHAPES], cell_path,
                               args.variant)
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
