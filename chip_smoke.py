#!/usr/bin/env python3
"""Drives the PyTorch port (`src/repro_torch`) end to end on one CUDA card.

    python3 chip_smoke.py [--seed N] [--stream-mib MiB]

Phases, each of which must pass (any failure exits non-zero and prints no
result):

  1. card      the card's name and power limit, as nvidia-smi reports them;
  2. kernels   builds rs_matmul from csrc/ and holds it bit-exact against
               its plain PyTorch version on the card (encode, decode, delta,
               ragged and unaligned shapes), then times both at the shapes
               the main path gives the kernel;
  3. ec        the erasure-coded storage path: a 1 GiB stream written to an
               ec(4,2) container on 8 targets in four fault domains with
               inline encryption, read back, one cell overwritten (delta
               parity), a target failed and read degraded, 64 MiB written
               during the outage, the target recovered (rebuild) and the
               stripes parity-scrubbed — every read bit-exact; the card's
               idle share is traced over a 64 MiB window of the degraded
               read and of full-stripe writes;
  4. direct    the same stream placed into GPU memory by DeviceDirectSink
               as 256 float32 tensors of 4 MiB plus odd-sized tensors at
               misaligned offsets, compared byte for byte on the card;
  5. dpu       the paper's offload configuration (dpu mode, rdma,
               replicated): 64 MiB written, read and placed on the card.

The kernel's launch counts are zeroed just before the ec phase and read
just after it. The line before the last is a JSON object of the kernels
(launches, error, times, bound); the last line is the result object.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MiB = 1 << 20
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
DOMAINS = ["a", "a", "b", "b", "c", "c", "d", "d"]


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, iters: int, kernel: str) -> float:
    """Mean device time of the CUDA kernel named `kernel` per launch, from
    torch.profiler's trace of `iters` calls of `fn`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            us += ev.device_time_total
            n += ev.count
    check(n == iters, f"profiler saw {n} launches of {kernel}, not {iters}")
    return us / 1e3 / n


def busy_share(fn) -> dict:
    """Host wall time of `fn` and the card's busy time in it: the device
    time of every kernel and copy in a torch.profiler trace (one stream,
    so they do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 2: the kernel against its plain version ----------------------------
def kernel_phase(seed: int) -> dict:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rs_parity import kernel as K
    from repro_torch.kernels.rs_parity import ref

    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0
    print(f"rs_matmul built in {build_s:.3f} s")
    for line in _build.build_logs.get("rs_parity", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    worst = 0
    n_checks = 0

    def rows(s: int, n: int) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, 256, (s, n), np.uint8)).to(dev)

    def hold(mat: np.ndarray, x: torch.Tensor, what: str,
             oracle: bool = False) -> torch.Tensor:
        nonlocal worst, n_checks
        got = K.rs_matmul(mat, x)
        want = ref.gf_matmul_torch(mat, x)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        worst = max(worst, err)
        n_checks += 1
        check(torch.equal(got, want), f"rs_matmul != plain version: {what}")
        if oracle:
            check(np.array_equal(got.cpu().numpy(), ref.gf_matmul_np(
                mat, x.cpu().numpy())), f"rs_matmul != numpy oracle: {what}")
        return got

    L = 262144                               # ec(4,2) cell of a 1 MiB stripe
    data = rows(4, L)
    parity = hold(ref.cauchy_matrix(4, 2), data, "ec(4,2) encode",
                  oracle=True)
    hold(ref.cauchy_matrix(8, 3), rows(8, 131072), "ec(8,3) encode",
         oracle=True)
    stripe = torch.cat([data, parity])
    for lost in itertools.combinations(range(6), 2):
        present = [i for i in range(6) if i not in lost][:4]
        missing = [i for i in lost if i < 4]
        if not missing:
            continue
        mat = ref.decode_matrix(4, 2, present, missing)
        dec = hold(mat, stripe[present].contiguous(), f"decode lost {lost}")
        check(torch.equal(dec, data[missing]), f"decode of {lost} is wrong")
    for idx in ([1], [0, 2], [1, 2, 3]):
        mat = np.ascontiguousarray(ref.cauchy_matrix(4, 2)[:, idx])
        hold(mat, rows(len(idx), L), f"delta over cells {idx}")
    for n in (1, 15, 4097):
        hold(ref.cauchy_matrix(4, 2), rows(4, n), f"ragged L={n}", oracle=True)
    flat = torch.empty(1 + 4 * 4097, dtype=torch.uint8, device=dev)
    flat.copy_(torch.from_numpy(rng.integers(0, 256, flat.numel(), np.uint8)))
    unaligned = flat[1:].view(4, 4097)
    check(unaligned.data_ptr() % 16 != 0, "unaligned view is aligned")
    hold(ref.cauchy_matrix(4, 2), unaligned, "unaligned start, L=4097",
         oracle=True)
    print(f"rs_matmul bit-exact with its plain version in {n_checks} checks")

    # times at the main path's shapes: a 1 MiB stripe's encode (4 -> 2
    # rows), a one-cell overwrite's delta (1 -> 2), a degraded read's
    # decode of one lost data cell (4 -> 1); L2-warm, as on the path.
    # `ms` is the kernel's device time (profiler); `call_ms` the wrapper's
    # time per call back to back (CUDA events), launch overhead included
    legs = {}
    for leg, mat in (("encode", ref.cauchy_matrix(4, 2)),
                     ("delta", np.ascontiguousarray(
                         ref.cauchy_matrix(4, 2)[:, [1]])),
                     ("decode", ref.decode_matrix(4, 2, [0, 1, 3, 4], [2]))):
        m, s = mat.shape
        x = rows(s, L)
        ms = kernel_device_ms(lambda: K.rs_matmul(mat, x), 100,
                              "rs_matmul_kernel")
        call_ms = cuda_ms(lambda: K.rs_matmul(mat, x), 200)
        plain_ms = cuda_ms(lambda: ref.gf_matmul_torch(mat, x), 10)
        bound_ms = (s + m) * L / HBM_BYTES_PER_S * 1e3
        legs[leg] = {"m": m, "s": s, "L": L, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms}
        print(f"rs_matmul {leg} (m={m}, s={s}, L={L}): kernel {ms:.6f} ms "
              f"on the device, {call_ms:.6f} ms a call, plain "
              f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms")
    return {"max_abs_err": worst, "legs": legs, "build_s": build_s}


# -- phase 3: the erasure-coded storage path ---------------------------------
def _dirty_cells(client, n_cells: int) -> int:
    """Cells marked in the fleet's dirty-cell ledgers (their union)."""
    from repro_torch.core.object_store import EC_DIRTY_AKEY
    union = {}
    for cont in client.ccontainer._per_target.values():
        for oid, obj in list(cont._objects.items()):
            for dk in obj.dkeys(EC_DIRTY_AKEY):
                marks = obj.fetch(dk, EC_DIRTY_AKEY, 0, n_cells)
                union.setdefault((oid, dk), set()).update(
                    i for i, b in enumerate(marks) if b)
    return sum(len(v) for v in union.values())


def _read_equal(client, fd: int, expect, chunk: int = 64 * MiB) -> bool:
    for off in range(0, len(expect), chunk):
        n = min(chunk, len(expect) - off)
        if client.pread(fd, n, off) != expect[off:off + n]:
            return False
    return True


def ec_phase(client, size: int, seed: int, times: dict) -> bytearray:
    k, p, cs = client.io._ec
    expect = bytearray(np.random.default_rng(seed).bytes(size))
    fd = client.open("/stream", create=True)
    t0 = time.perf_counter()
    for off in range(0, size, 16 * MiB):
        client.pwrite(fd, bytes(expect[off:off + 16 * MiB]), off)
    client.io.data_path_counters()              # joins parity stragglers
    times["ec_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(_read_equal(client, fd, expect), "readback differs")
    times["ec_read_s"] = time.perf_counter() - t0

    off = 5 * MiB + cs                           # data cell 1 of block 5
    new = np.random.default_rng(seed + 1).bytes(cs)
    client.pwrite(fd, new, off)
    expect[off:off + cs] = new
    ec = client.io.data_path_counters()["ec"]
    check(ec["delta_writes"] >= 1, f"no delta write: {ec}")

    client.cluster.fail_target(2)
    t0 = time.perf_counter()
    check(_read_equal(client, fd, expect), "degraded read differs")
    times["ec_degraded_read_s"] = time.perf_counter() - t0
    ec = client.io.data_path_counters()["ec"]
    check(ec["reconstructions"] > 0, f"no reconstruction: {ec}")
    # the card's idle share over a 64 MiB window of the degraded read
    window = bytes(expect[:64 * MiB])
    trace = busy_share(lambda: check(client.pread(fd, len(window), 0)
                                     == window, "traced read differs"))
    times["trace_degraded_read_64MiB"] = trace
    print("degraded read, 64 MiB traced:", trace)

    t0 = time.perf_counter()
    outage = 64 * MiB
    out = np.random.default_rng(seed + 2).bytes(outage)
    base = size // 2
    for o in range(0, outage, 16 * MiB):
        client.pwrite(fd, out[o:o + 16 * MiB], base + o)
    expect[base:base + outage] = out
    client.io.data_path_counters()
    marked = _dirty_cells(client, k + p)
    times["ec_outage_write_s"] = time.perf_counter() - t0
    rebuilt0 = client.io.data_path_counters()["ec"]["rebuilt_cells"]
    t0 = time.perf_counter()
    client.cluster.recover_target(2)
    times["ec_rebuild_s"] = time.perf_counter() - t0
    rebuilt = client.io.data_path_counters()["ec"]["rebuilt_cells"] - rebuilt0
    print(f"outage write marked {marked} cells, rebuild regenerated {rebuilt}")
    check(marked > 0 and rebuilt == marked, "rebuilt != marked cells")
    check(_dirty_cells(client, k + p) == 0, "ledger not clean after rebuild")
    t0 = time.perf_counter()
    check(_read_equal(client, fd, expect), "post-rebuild read differs")
    times["ec_post_rebuild_read_s"] = time.perf_counter() - t0
    # and over a 64 MiB window of full-stripe writes (the same bytes again)
    window = bytes(expect[:64 * MiB])

    def rewrite() -> None:
        for o in range(0, len(window), 16 * MiB):
            client.pwrite(fd, window[o:o + 16 * MiB], o)
        client.io.data_path_counters()          # joins parity stragglers

    trace = busy_share(rewrite)
    times["trace_write_64MiB"] = trace
    print("write, 64 MiB traced:", trace)

    t0 = time.perf_counter()
    scrub = client.scrubber.scrub_parity((k + p) * cs * (size // MiB))
    times["ec_scrub_s"] = time.perf_counter() - t0
    print("scrub_parity:", scrub)
    check(scrub["parity_checks"] == size // MiB, f"scrub missed: {scrub}")
    check(scrub["parity_mismatches"] == 0, f"scrub mismatches: {scrub}")
    print("ec counters:", client.io.data_path_counters()["ec"])
    client.close_fd(fd)
    return expect


# -- phase 4/5: device-direct placement ----------------------------------------
def direct_phase(client, path: str, expect, slot_bytes: int,
                 n_slots: int, tensor_bytes: int) -> dict:
    import torch
    from repro_torch.core.device_direct import DeviceDirectSink
    dev = client.device
    src = torch.frombuffer(expect, dtype=torch.uint8).to(dev)
    fd = client.open(path)
    reqs = [(fd, i * tensor_bytes, (tensor_bytes // 4,), np.float32)
            for i in range(len(expect) // tensor_bytes)]
    # odd sizes packed back to back into the last slot: the float32 and
    # int16 starts land at byte offsets (7, 67) that are not multiples of
    # their element size
    reqs += [(fd, 7, (7,), np.uint8), (fd, 3 * MiB + 1, (5, 3), np.float32),
             (fd, 11, (1000,), np.int16), (fd, 4093, (4093,), np.uint8)]
    with DeviceDirectSink(client, slot_bytes=slot_bytes,
                          n_slots=n_slots) as sink:
        t0 = time.perf_counter()
        got = sink.read_tensors(reqs)
        wall = time.perf_counter() - t0
        stats = sink.stats
    for (_fd, off, shape, dt), t in zip(reqs, got):
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        check(t.device.type == dev.type, f"tensor on {t.device}")
        check(tuple(t.shape) == tuple(shape), f"shape {t.shape} != {shape}")
        check(torch.equal(t.reshape(-1).view(torch.uint8),
                          src[off:off + nbytes]),
              f"placed tensor at {off} differs")
    client.close_fd(fd)
    print(f"device-direct {path}: {len(reqs)} tensors, {stats}, "
          f"{stats.bytes / wall / 1e9:.3f} GB/s")
    return {"stats": stats.__dict__, "wall_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream-mib", type=int, default=1024,
                    help="size of the ec phase's stream (at least 256)")
    args = ap.parse_args(argv)
    if args.stream_mib < 256 or args.stream_mib % 64:
        print("--stream-mib must be a multiple of 64, at least 256",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repo "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ROS2Client
    from repro_torch.kernels.rs_parity import kernel as K
    from repro_torch.kernels.rs_parity import ops

    size = args.stream_mib * MiB
    if args.stream_mib != 1024:
        print(f"stream cut to {args.stream_mib} MiB from 1024 MiB")
    times: dict = {}
    try:
        t0 = time.perf_counter()
        card = card_line()
        print(card)
        times["card_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        kern = kernel_phase(args.seed)
        times["kernels_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        client = ROS2Client(mode="host", transport="rdma", n_targets=8,
                            domains=DOMAINS, ec=(4, 2),
                            inline_encryption=True, scrub_interval_s=None)
        try:
            ops.reset_launches()
            expect = ec_phase(client, size, args.seed, times)
            launches = ops.launches()
            times["ec_s"] = time.perf_counter() - t0
            print("rs_matmul launches by leg:", launches)
            for leg in ("encode", "delta", "decode"):
                check(launches[leg] > 0, f"no {leg} launch on the main path")

            t0 = time.perf_counter()
            direct = direct_phase(client, "/stream", expect, 64 * MiB, 4,
                                  4 * MiB)
            times["direct_s"] = time.perf_counter() - t0
        finally:
            client.close()

        t0 = time.perf_counter()
        dpu = ROS2Client(mode="dpu", transport="rdma", scrub_interval_s=None)
        try:
            small = bytearray(np.random.default_rng(args.seed + 3).bytes(
                64 * MiB))
            fd = dpu.open("/dpu", create=True)
            for off in range(0, len(small), 16 * MiB):
                dpu.pwrite(fd, bytes(small[off:off + 16 * MiB]), off)
            check(_read_equal(dpu, fd, small), "dpu readback differs")
            dpu.close_fd(fd)
            direct_phase(dpu, "/dpu", small, 16 * MiB, 4, 1 * MiB)
        finally:
            dpu.close()
        times["dpu_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    enc = kern["legs"]["encode"]
    total = sum(launches[leg] for leg in ("encode", "delta", "decode"))
    print("phase wall times (s):", json.dumps(times))
    print("direct placement:", json.dumps(direct))
    print(json.dumps({"kernels": [{
        "name": "rs_matmul", "route": "cuda", "source": K.SOURCE,
        "replaces": K.REPLACES, "launches": total,
        "max_abs_err": kern["max_abs_err"], "ms": enc["ms"],
        "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "launches_by_leg": launches, "legs": kern["legs"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
