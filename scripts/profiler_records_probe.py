#!/usr/bin/env python3
"""How many flash_attention_fwd launches torch.profiler records in a
20-launch window on the card, as chip_smoke.py's process goes on.

    python3 scripts/profiler_records_probe.py

From the root of a checkout, on a CUDA card. It builds the kernels, then
traces windows of 20 back-to-back launches at the serve shape with 0, 0.1
and 1 s of idle time on either side, in a fresh process and again after
each of chip_smoke.py's kernel, ec (stream cut to 256 MiB), direct and
flash phases. For each window it prints how many launches were recorded
and where the first and last recorded launch start in the trace, then
whether records spill into an empty window traced next.
"""
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.core import ROS2Client  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402

MiB = 1 << 20
q = torch.randn(4, 1024, 32, 64, device="cuda").bfloat16()
k = torch.randn(4, 1024, 8, 64, device="cuda").bfloat16()
v = torch.randn(4, 1024, 8, 64, device="cuda").bfloat16()


def flash():
    FK.flash_attention_fwd(q, k, v, scale=0.125, causal=True)


def window(pad, n, detail=False):
    flash()
    torch.cuda.synchronize()
    t_host0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        t1 = time.perf_counter()
        for _ in range(n):
            flash()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        time.sleep(pad)
    cnt = sum(ev.count for ev in prof.key_averages()
              if FK.KERNEL_NAME in ev.key)
    out = f"pad {pad} n {n}: {cnt} recorded"
    if detail:
        starts = sorted(ev.time_range.start for ev in prof.events()
                        if FK.KERNEL_NAME in ev.name)
        if starts:
            out += (f"; first start {starts[0]:.0f} us, last {starts[-1]:.0f}"
                    f" us; host launch window {1e6 * (t1 - t_host0):.0f}.."
                    f"{1e6 * (t2 - t_host0):.0f} us after entering")
    return out


def report(tag):
    print(f"== {tag}", flush=True)
    for pad in (0.0, 0.1, 1.0):
        for _ in range(2):
            print(window(pad, 20, detail=True), flush=True)
    # spill: an empty window right after a full one
    print(window(0.0, 20), "| then empty:", window(0.0, 0), flush=True)


cs.build_phase()
report("fresh process")
try:
    cs.kernel_phase(0)
    report("after kernel phase")
    times = {}
    client = ROS2Client(mode="host", transport="rdma", n_targets=8,
                        domains=cs.DOMAINS, ec=(4, 2),
                        inline_encryption=True, scrub_interval_s=None)
    try:
        expect = cs.ec_phase(client, 256 * MiB, 0, times)
        report("after ec phase")
        cs.direct_phase(client, "/stream", expect, 64 * MiB, 4, 4 * MiB)
    finally:
        client.close()
    report("after direct phase")
    try:
        cs.flash_phase(0)
    except AssertionError:
        traceback.print_exc()
    report("after flash phase")
except Exception:
    traceback.print_exc()
