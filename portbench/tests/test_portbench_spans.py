"""The program's spans as the benchmark reads them (`portbench/spans.py`):
the idle-gap rule on a hand-made trace, the three readers on a canned
record, and a tiny cell run on the CPU with the program's wave after the
traced one."""
import sys
import time

import pytest

from portbench import spans as sp
from portbench.run import result, run_cell
from portbench.spec import reader
from portbench.tests.tiny import DENSE, tiny_cell
from portbench.trace import summarize
from repro_torch.common.tracing import Span

BASE = 1_000_000.0             # us: the traced span's start
ENGINE, ARM0, ARM1 = 1, 2, 3

HOST = [("store_read", BASE + 0, BASE + 100),
        ("wave_form", BASE + 100, BASE + 110),
        ("prefill_host", BASE + 110, BASE + 200),
        ("decode_host", BASE + 200, BASE + 300)]
DEVICE = [("gemm", BASE + 105, BASE + 150), ("gemm", BASE + 160,
                                               BASE + 290)]


def _spans():
    """(name, thread, start us, end us, parent index, cpu us) after BASE;
    the clock's offset is 0, so a span's ns are its us x 1,000."""
    rows = [("dpu.wait", ENGINE, 10, 95, None, None),
            ("dpu.complete", ENGINE, 5, 95, 0, None),
            ("engine.wave", ENGINE, 106, 310, None, None),
            ("engine.prefill", ENGINE, 108, 195, 2, None),
            ("prefill.replay", ENGINE, 112, 190, 3, None),
            ("prefill.token_read", ENGINE, 190, 195, 3, None),
            ("decode.step", ENGINE, 198, 299, 2, None),
            ("decode.token_read", ENGINE, 250, 299, 6, None),
            ("dpu.queue", ARM0, 1, 40, None, None),
            ("dpu.op", ARM0, 40, 60, None, 5),
            ("crypto.page", ARM0, 50, 55, 9, None),
            ("dpu.op", ARM1, 0, 30, None, 15)]
    out = []
    for i, (name, tid, a, b, parent, cpu) in enumerate(rows):
        attrs = ({"rids": [7, 8], "new": [1, 2]} if name == "engine.wave"
                 else {})
        out.append(Span(name, i + 1, 0 if parent is None else parent + 1,
                        9, tid, int((BASE + a) * 1e3), int((BASE + b) * 1e3),
                        None if cpu is None else cpu * 1000,
                        name in ("dpu.queue", "dpu.complete"), attrs))
    return out


def test_idle_gaps_go_to_the_innermost_span():
    summary = sp.summarize_spans(_spans(), {"offset_ns": 0, "drift_ns": 40},
                                 DEVICE, HOST, n_arm=4)
    # gaps: 0-105 (dpu.wait 10-95, none open around it), 150-160
    # (prefill.replay), 290-300 (decode.token_read to 299, then the wave);
    # the interval dpu.complete is no span a thread is in
    assert summary["idle_by_span"] == pytest.approx(
        {"no_span": 20e-6, "dpu.wait": 85e-6, "prefill.replay": 10e-6,
         "decode.token_read": 9e-6, "engine.wave": 1e-6})
    idle = summarize(DEVICE, HOST)["idle_by_phase"]
    assert sum(summary["idle_by_span"].values()) == pytest.approx(
        sum(idle.values()))
    # over dpu.wait's 85 us, a quarter each: ARM0 in dpu.op 40-50 and
    # 55-60, crypto.page 50-55; ARM1 in dpu.op to 30; two cores recorded
    # none
    assert summary["idle_in_dpu_wait"] == pytest.approx(
        {"dpu.op": 35e-6 / 4, "crypto.page": 5e-6 / 4,
         "arm_idle": (65 + 65 + 2 * 85) * 1e-6 / 4})
    assert summary["clock_drift_us"] == 0.04
    inside = summary["inside"]
    assert inside["dpu.wait in store_read"] == {
        "checked": 1, "outside": 0, "max_overhang_us": 0.0}
    assert inside["decode.step in decode_host"]["outside"] == 1
    assert inside["decode.step in decode_host"]["max_overhang_us"] == \
        pytest.approx(2.0)
    assert inside["decode.token_read in decode_host"]["outside"] == 0
    # engine.wave ends after the traced span: in no table
    table = summary["spans"]
    assert "engine.wave" not in table
    assert table["dpu.op"]["count"] == 2
    assert table["dpu.op"]["cpu_share"] == pytest.approx(20 / 50)
    assert table["dpu.op"]["self_s"] == pytest.approx(45e-6)
    # the completion began before its wait: only its part inside counts
    assert table["dpu.wait"]["self_s"] == pytest.approx(0.0)
    assert table["engine.prefill"]["self_s"] == pytest.approx(4e-6)
    # rid 7 asks one token (the prefill's), rid 8 two (the step's too)
    (r7, *t7), (r8, *t8) = summary["requests"]
    assert (r7, r8) == (7, 8)
    assert t7 == pytest.approx([89e-6, 89e-6])
    assert t8 == pytest.approx([89e-6, 193e-6])


def test_segments_follow_nesting():
    seg = sp.segments([("a", 0, 10), ("b", 2, 5), ("c", 5, 8),
                       ("z", 10, 10), ("d", 12, 14)])
    assert list(sp.pieces(seg, -1, 15)) == [
        ("", 1), ("a", 2), ("b", 3), ("c", 3), ("a", 2), ("", 2), ("d", 2),
        ("", 1)]
    assert list(sp.pieces(seg, 3, 4)) == [("b", 1)]
    assert list(sp.pieces(sp.segments([]), 0, 5)) == [("", 5)]


TABLE = {
        "dpu.queue": {"count": 3, "total_s": 0.006, "self_s": 0.006,
                      "mean_ms": 2.0, "p95_ms": 2.9},
        "dpu.op": {"count": 3, "total_s": 0.003, "self_s": 0.001,
                   "mean_ms": 1.0, "p95_ms": 1.4, "cpu_share": 0.5},
        "decode.step": {"count": 4, "total_s": 0.4, "self_s": 0.0,
                        "mean_ms": 100.0, "p95_ms": 101.0},
        "decode.token_read": {"count": 4, "total_s": 0.36,
                              "self_s": 0.36, "mean_ms": 90.0,
                              "p95_ms": 91.0}}


def test_program_readers():
    """They read the wave without the profiler, not the profiled one."""
    rec = {"trace": {"program": {"spans": {}}, sp.BARE: {"spans": TABLE}}}
    assert reader("dpu_queue_ms.p95")(rec) == 2.9
    assert reader("dpu_op_ms")(rec) == 1.0
    assert reader("decode_host_ms")(rec) == pytest.approx(10.0)
    assert sp.read_metrics(rec["trace"]) == pytest.approx(
        {"dpu_queue_ms.p95": 2.9, "dpu_op_ms": 1.0, "decode_host_ms": 10.0})


@pytest.mark.parametrize("rec", [{}, {"trace": {"busy_s": 1.0}},
                                 {"trace": {sp.BARE: None}},
                                 {"trace": {sp.BARE: {"spans": {}}}},
                                 {"trace": {"program": {"spans": TABLE}}}],
                         ids=["untraced", "no_program", "no_tracer",
                              "no_spans", "profiled_only"])
def test_program_readers_read_nothing_without_spans(rec):
    for name in sp.PROGRAM_METRICS:
        assert reader(name)(rec) is None


@pytest.mark.parametrize("mix", ["rag", "chat"])
def test_program_wave_after_the_traced_one(mix):
    cell = tiny_cell(DENSE, mix)
    with sp.second_wave() as kept:
        rec = run_cell(cell, 2**31 + 17, 0.3, True, "cpu",
                       time.perf_counter(), warm_s=0)
    first, program = rec["trace"], kept["program"]
    assert first["program"] is program
    assert "ops_by_name" in first and "ops_by_name" not in program
    # the first wave's readers and breakdown read as before
    assert set(result(cell, rec, True)["breakdown"]) == {"device_ops",
                                                         "idle_gaps"}
    idle = sum(program["idle_by_phase"].values())
    assert sum(program["idle_by_span"].values()) == pytest.approx(idle,
                                                                  rel=0.01)
    checks = program["inside"]
    assert checks["dpu.wait in store_read"]["checked"] >= 1
    assert checks["dpu.wait in store_read"]["outside"] == 0
    assert checks["decode.token_read in decode_host"]["outside"] == 0
    assert isinstance(program["clock_drift_us"], float)
    table = program["spans"]
    assert table["dpu.queue"]["count"] == table["dpu.op"]["count"] >= 1
    assert {"session.fetch", "decode.step", "prefill.replay"} <= set(table)
    if mix == "rag":
        assert {"ec.gather", "crypto.apply"} <= set(table)
    assert len(program["requests"]) == rec["batch"]
    assert all(0 < a <= b for _, a, b in program["requests"])
    bare = kept[sp.BARE]
    assert first[sp.BARE] is bare
    assert bare["spans"]["dpu.op"]["count"] >= 1
    assert 0 < bare["reads_s"] < bare["host_s"]
    assert len(bare["requests"]) == rec["batch"]
    got = sp.read_metrics(first)
    assert got == sp.read_metrics(kept)
    assert all(v is not None and v >= 0 for v in got.values()), got


def test_program_wave_without_the_tracer(monkeypatch):
    """A program that has no tracer gives no program summary."""
    import repro_torch.common
    monkeypatch.setitem(sys.modules, "repro_torch.common.tracing", None)
    monkeypatch.delattr(repro_torch.common, "tracing")
    assert sp.program_wave(None, None, None) is None
    assert sp.bare_wave(None, None, None) is None
