#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload granite-3-2b.rag --seed 7 \
        --seconds 50 --trace 0

From the root of a checkout, on a machine with the CUDA cards the cell
asks for (`BENCHMARK.json`): without them it prints no result and exits
with 2. It serves the cell's traffic through the program
(`repro_torch`'s engine fed by its store) for `--seconds`, then checks
what the window served against the plain reference and prints, as the
last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` a `breakdown`, and last
`checks`, each compared number beside its limit; the same numbers end
standard error. Every input and weight is made from `--seed`.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names
T_LOADED = time.perf_counter()


def process_start() -> float:
    """This process's start on the perf_counter clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf(
            "SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_LOADED


def forbidden_modules(names=None) -> list:
    """The FORBIDDEN top-level names among `names` (sys.modules' by
    default), compared whole: `repro_torch` is not `repro`."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def port_config(config: dict):
    """The program's ModelConfig for a configuration file, checked against
    the file's sizes as the reference reads them."""
    from repro_torch.configs import get_config

    from portbench.check import reference
    port = config["port"]
    cfg = get_config(port["arch"]).replace(**port.get("replace", {}))
    s, _ = reference(config)
    want = {"n_layers": s.layers, "d_model": s.d_model, "n_heads": s.heads,
            "n_kv_heads": s.kv_heads, "head_dim": s.head_dim,
            "vocab": s.vocab, "rms_eps": s.eps, "rope_theta": s.rope_theta,
            "tie_embeddings": s.tied, "param_dtype": config["dtypes"]["params"],
            "compute_dtype": config["dtypes"]["compute"],
            "kv_cache_dtype": config["dtypes"]["kv_cache"],
            "attn_impl": config["attn_impl"]}
    got = {k: getattr(cfg, k) for k in want}
    if getattr(s, "experts", 0):
        want.update(experts=s.experts, top_k=s.top_k, d_expert=s.d_expert)
        got.update(experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                   d_expert=cfg.moe.d_ff_expert)
    else:
        want["d_ff"], got["d_ff"] = s.d_ff, cfg.d_ff
    if abs(s.attention_scale - cfg.head_dim ** -0.5) > 1e-12:
        want["attention_scale"], got["attention_scale"] = (
            s.attention_scale, cfg.head_dim ** -0.5)
    if got != want:
        raise ValueError(f"the program's config {got} is not the file's "
                         f"{want}")
    return cfg


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control=None, warm_s: float = None) -> dict:
    """The cell served once on `device`: the window's record, the traced
    wave's summary, the checks. With `control` (a lower-precision
    matmul), the reference's control reading as well. The warm-up runs
    `warm_s` seconds of waves (`serve.WARM_S` unless given)."""
    import torch

    from portbench import check, serve, store as store_mod
    from portbench.traffic import Traffic
    from portbench.weights import make_weights, shapes_of
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models.api import ModelAPI

    seed &= (1 << 63) - 1
    cfg = port_config(cell.config)
    batch = cell.cell["engine_batch"]
    api = ModelAPI(cfg, device=device)
    mctx = make_host_mesh_ctx(cfg, device=device)
    traffic = Traffic(cell.mix, cfg.vocab, batch, seed)
    # the warm-up's waves: the window's traffic, drawn apart
    warm = Traffic(cell.mix, cfg.vocab, batch, seed ^ 0x5EED)
    rec = {"cell": cell.name, "seed": seed, "config": cell.config,
           "mix": cell.mix, "batch": batch}
    times = rec["setup"] = {}
    t = time.perf_counter()
    weights = make_weights(shapes_of(api.param_defs()), seed, device)
    if device != "cpu":
        torch.cuda.synchronize()
    times["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = traffic.pool()
    store = store_mod.Store(cell.mix, device)
    try:
        store.fill(pool)
        times["store_fill_s"] = time.perf_counter() - t
        max_seq = traffic.prompt_len + traffic.max_new + 8
        eng = serve.timed_engine(api, weights, mctx, batch,
                                 traffic.prompt_len, max_seq)
        t = time.perf_counter()
        times["store_warm_reads"] = store.warm(warm.draw)
        times["warm_up_waves"] = serve.warm_up(
            eng, store, warm, serve.WARM_S if warm_s is None else warm_s)
        times["warm_up_s"] = time.perf_counter() - t
        times["capture_s"] = {"prefill": eng.prefill_step.capture_s,
                              "decode": eng.decode_step.capture_s}
        before = serve.replays(eng)
        # what set-up left lives to the end: no collection walks it in the
        # window
        gc.collect()
        gc.freeze()
        counted = store.counters()
        window = serve.serve_window(eng, store, traffic, seconds)
        # the store's counters over the window and the wave in flight
        rec["store_window"] = store_mod.delta(store.counters(), counted)
        rec["setup_s"] = window.pop("t0") - t_start
        rec["window"] = window
        rec["forbidden_modules"] = forbidden_modules()
        rec["replays"] = {k: v - before[k]
                          for k, v in serve.replays(eng).items()}
        if device != "cpu":
            rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        if trace:
            from portbench.trace import traced_wave
            rec["trace"] = traced_wave(eng, store, traffic)
        rec["store_counters"] = store.counters()
    finally:
        store.close()
    reqs = window["requests"]
    # the program's state goes before the reference runs
    del eng
    gc.unfreeze()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    picked = check.sample(reqs, cell.cell["sample_requests"], seed)
    values = {"store_mismatches": check.store_mismatches(reqs, traffic, pool)}
    values.update(check.served_gap(picked, traffic, pool, weights,
                                   cell.config, device, control))
    values["reference_s"] = time.perf_counter() - t
    rec["values"] = values
    rec["correct"], rec["checks"] = check.judge(values, cell.cell["limits"])
    return rec


def device_info(count: int) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def result(cell, rec: dict, trace: bool) -> dict:
    """The result line's object (the `device` key left to the caller)."""
    from portbench.spec import reader
    from portbench.trace import breakdown
    metrics = {}
    for m in cell.metrics(trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    reqs = rec["window"]["requests"]
    out = {"correct": rec["correct"], "attempted": len(reqs),
           "failed": sum("error" in r for r in reqs), "metrics": metrics}
    if trace:
        out["breakdown"] = breakdown(rec["trace"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    # the program builds its kernels with nvcc into build/kernels/ of the
    # checkout; torch's and triton's caches, should anything use them,
    # stay at fixed paths inside it too
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.spec import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start)
    found = sorted(set(rec["forbidden_modules"]) | set(forbidden_modules()))
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    out = result(cell, rec, bool(args.trace))
    dev = device_info(cell.chips)
    dev["memory_peak_bytes"] = rec["memory_peak_bytes"]
    if args.trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    out["device"] = dev
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in rec["checks"]}
    detail = {k: rec[k] for k in ("setup", "setup_s", "replays",
                                  "values", "store_window",
                                  "store_counters")}
    # a row a wave: start, reads, prefill, decode seconds, steps, end
    detail["waves"] = [[w["start"], w["start"] - w["reads_start"],
                        w["prefill_s"], w["decode_s"], w["steps"], w["end"]]
                       for w in rec["window"]["waves"]]
    if args.trace:
        from portbench.trace import top_ops
        tr = rec["trace"]
        detail["trace"] = {k: v for k, v in tr.items()
                           if k not in ("ops_by_name", "ops_by_phase")}
        detail["trace"]["top_ops_by_phase"] = {
            p: top_ops(ops) for p, ops in tr["ops_by_phase"].items()}
    print("portbench detail: " + json.dumps(detail, default=str))
    for n, v, lim in rec["checks"]:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
