"""A cell as `BENCHMARK.json` names it, and the files it is made of.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric is a file of its own, found by its name:

    portbench/configs/<config>.json     the model as it is run
    portbench/mixes/<traffic>.json      the traffic mix's parameters
    portbench/cells/<cell>.json         the engine batch, the sample the
                                        reference checks, the limits
    portbench/metrics/<metric>/reader.py

A later cell, mix or metric is added as files and entries, editing none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict          # portbench/configs/<config>.json
    mix: dict             # portbench/mixes/<traffic>.json
    cell: dict            # portbench/cells/<name>.json
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports in a run: with trace off its
        end-to-end metrics, with trace on its per-layer ones (those whose
        `workloads` name it, or that have no `workloads`)."""
        group = self.per_layer if trace else self.end_to_end
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench: Path = ROOT / "BENCHMARK.json") -> Cell:
    b = load_json(bench)
    w = next((w for w in b["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in {bench}")
    conf = next(c for c in b["configs"] if c["name"] == w["config"])
    return Cell(name=name, config=load_json(ROOT / conf["file"]),
                mix=load_json(HERE / "mixes" / f"{w['traffic']}.json"),
                cell=load_json(HERE / "cells" / f"{name}.json"),
                chips=w["chips"], end_to_end=b["end_to_end"],
                per_layer=b["per_layer"])


def reader(metric: str) -> Callable[[Dict[str, Any]], Any]:
    """The `read(record)` function of portbench/metrics/<metric>/reader.py."""
    path = HERE / "metrics" / metric / "reader.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

