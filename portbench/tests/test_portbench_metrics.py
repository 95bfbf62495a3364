"""Each metric's reader on a canned run record; a reader with nothing to
read returns None."""
import pytest

from portbench import flops
from portbench.check import reference
from portbench.spec import Cell, load_cell, reader
from portbench.tests.tiny import DENSE


def _record():
    # two waves of two requests (max_new 3 and 2) at prompt length 4; the
    # window is 10 s, the second wave ends past it
    waves = [
        {"start": 1.0, "end": 3.0, "prompt_len": 4, "batch": 2,
         "token_times": [1.5, 2.0, 3.0], "active": [2, 2, 1],
         "prefill_s": 0.5, "decode_s": 1.5, "steps": 2, "slot_steps": 4,
         "active_slot_steps": 3},
        {"start": 9.0, "end": 11.0, "prompt_len": 4, "batch": 2,
         "token_times": [9.5, 10.0, 11.0], "active": [2, 2, 1],
         "prefill_s": 0.3, "decode_s": 1.7, "steps": 2, "slot_steps": 4,
         "active_slot_steps": 3},
    ]
    reqs = [
        {"send": 0.0, "read_done": 0.8, "first_token": 1.5, "reply": 3.0},
        {"send": 0.2, "read_done": 0.9, "first_token": 1.5, "reply": 3.0},
        {"send": 8.0, "read_done": 8.5, "first_token": 9.5, "reply": 11.0},
        {"send": 8.0, "read_done": 8.9, "first_token": 9.5, "reply": 11.0},
    ]
    return {"window": {"seconds": 10.0, "waves": waves, "requests": reqs},
            "setup_s": 12.5, "config": DENSE, "batch": 2}


def test_end_to_end_readers():
    rec = _record()
    # tokens at 1.5, 2.0, 3.0, 9.5, 10.0 (not the one at 11.0)
    assert reader("tokens_per_s")(rec) == pytest.approx(9 / 10)
    # first tokens: 1.5, 1.3, 1.5, 1.5 s after their sends
    assert reader("ttft_p95_ms")(rec) == pytest.approx(1500.0)
    # replies in the window: the first wave's, 3.0 and 2.8 s
    assert reader("latency_p95_ms")(rec) == pytest.approx(
        2800 + 0.95 * 200)
    assert reader("setup_s")(rec) == 12.5


def test_per_layer_readers():
    rec = _record()
    assert reader("prompt_read_ms.p95")(rec) == pytest.approx(
        sorted([800, 700, 500, 900])[2] + 0.85 * 100)
    assert reader("prefill_wave_ms")(rec) == pytest.approx(400.0)
    assert reader("decode_step_ms")(rec) == pytest.approx(800.0)
    assert reader("slot_occupancy")(rec) == pytest.approx(75.0)
    s, _ = reference(DENSE)
    work = (2 * flops.prefill_flops(s, 2, 4)
            + 2 * flops.decode_flops(s, 4) + flops.decode_flops(s, 5)
            + 2 * flops.decode_flops(s, 4))
    assert reader("mfu")(rec) == pytest.approx(
        100 * work / (10 * flops.PEAKS["bf16_flops"]))
    # the prefills of the two waves that started in the window
    assert reader("mfu.prefill")(rec) == pytest.approx(
        100 * 2 * flops.prefill_flops(s, 2, 4)
        / (0.8 * flops.PEAKS["bf16_flops"]))


def test_trace_readers():
    rec = _record()
    for name in ("attn_prefill_roofline", "device_idle_share"):
        assert reader(name)(rec) is None
    rec["trace"] = {"window_s": 2.0, "busy_s": 1.5, "ops_by_phase": {
        "prefill_host": {"void flash_fwd_kernel_tc<64, 128, 128>(Args)":
                         [2, 0.004], "gemm": [5, 1.0]},
        "decode_host": {"flash_fwd_kernel_tc": [9, 9.0]}}}
    assert reader("device_idle_share")(rec) == pytest.approx(25.0)
    b = flops.attention_bound_s(2, 4, 4, 2, 16)
    assert reader("attn_prefill_roofline")(rec) == pytest.approx(
        100 * 2 * b["bound_s"] / 0.004)


def test_flop_counts():
    s, _ = reference(DENSE)
    d, H, KH, hd, f, V, L = 64, 4, 2, 16, 128, 512, 2
    per_token = L * (d * H * hd + 2 * d * KH * hd + H * hd * d + 3 * d * f)
    assert flops.weight_macs_per_token(s) == per_token
    # 3 tokens from position 0: 1 + 2 + 3 pairs, one head's logits
    assert flops.forward_flops(s, 0, 3, 1) == (
        2 * 3 * per_token + 2 * d * V + 4 * hd * H * L * 6)
    assert flops.causal_pairs(10, 1) == 11


def test_cells_report_what_benchmark_json_lists():
    rag, chat = load_cell("granite-3-2b.rag"), load_cell("granite-3-2b.chat")
    assert [m["name"] for m in chat.metrics(False)] == [
        "tokens_per_s", "ttft_p95_ms", "latency_p95_ms", "setup_s"]
    # rag's tokens/s swings with where the window closes in a wave
    assert [m["name"] for m in rag.metrics(False)] == [
        "ttft_p95_ms", "latency_p95_ms", "setup_s"]
    for cell in (rag, chat):
        per_layer = {m["name"] for m in cell.metrics(True)}
        reported = {m["name"] for m in cell.metrics(False)}
        assert {"prompt_read_ms.p95", "attn_prefill_roofline",
                "mfu.prefill", "decode_step_ms"} <= per_layer
        # each per-layer metric moves an end-to-end metric the cell reports
        assert all(m["moves"] in reported for m in cell.metrics(True))
    assert {"mfu", "device_idle_share"} <= {m["name"]
                                            for m in chat.metrics(True)}
    # a cell that a metric's `workloads` does not name does not report it
    other = Cell(**{**vars(chat), "name": "another.cell"})
    assert [m["name"] for m in other.metrics(False)] == ["setup_s"]
    assert other.metrics(True) == []


def test_sample_is_seeded_and_holds_the_longest():
    from portbench.check import sample
    reqs = [{"rid": i, "out": [0] * (i % 7 + 1)} for i in range(40)]
    reqs.append({"rid": 99, "error": "read failed"})
    a, b = sample(reqs, 5, 123), sample(reqs, 5, 123)
    assert [r["rid"] for r in a] == [r["rid"] for r in b]
    assert len(a) == 5 and a[0]["rid"] == 6          # the first of length 7
    assert all("out" in r for r in a)
    assert [r["rid"] for r in sample(reqs, 5, 124)] != [r["rid"] for r in a]
