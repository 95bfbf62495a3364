"""The port's examples (`examples/torch_*.py`) against the reference's, each
pair run on the CPU in this process (`--device cpu` for the port's).

* smartnic offload demo: sections 1-2 (the modelled Fig. 5 numbers and
  the transport counters) print the same lines; sections 3-6 reach the
  same outcomes: each denial, no plaintext at rest, the rebuilt extent
  count and the placed bytes. The rebuilt count depends on the device
  placement of `Container.placement`, a `hash()` of a str that Python
  salts per process: it varies from process to process in both packages,
  and is the same for both in one process.
* quickstart: the same storage outcomes (DPU ops, data-plane bytes and
  copies, RPCs, the committed step); the port's loss falls.
* batched serving and the 100M trainer (cut to a tiny config): the same
  requests, new tokens, waves, slot occupancy, corpus and DPU ops.
"""
import re
import sys

import numpy as np
import pytest

ROOT_EXAMPLES = "examples"


def _load(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / ROOT_EXAMPLES / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sections(text):
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"=== (\d)\. ", line)
        if m:
            cur = int(m.group(1))
            out[cur] = []
        elif cur is not None and line.strip():
            out[cur].append(line.rstrip())
    return out


def _outcome(line):
    """A line's outcome: a denial without its message, a count kept."""
    return re.sub(r": denied \(.*\)$", ": denied", line)


def test_smartnic_demo_matches_reference(capsys):
    _load("smartnic_offload_demo.py").main()
    want = _sections(capsys.readouterr().out)
    _load("torch_smartnic_offload_demo.py").main(["--device", "cpu"])
    got = _sections(capsys.readouterr().out)
    assert got[1] == want[1] and got[2] == want[2]
    for s in (3, 4, 5):
        assert [_outcome(x) for x in got[s]] == \
            [_outcome(x) for x in want[s]], s
    assert got[6][0] == want[6][0]           # shape, dtype, bytes spliced
    assert got[6][1] == "  placed on cpu"
    assert any("denied" in x for x in got[3])
    assert "  plaintext at rest on any SSD: False" in got[4]


def _storage_lines(text):
    keep = ("DPU ops processed", "data plane:", "control plane:",
            "restore works:")
    return [x for x in text.splitlines() if x.startswith(keep)]


def test_quickstart_storage_matches_reference_and_loss_falls(capsys):
    _load("quickstart.py").main()
    want = _storage_lines(capsys.readouterr().out)
    losses = _load("torch_quickstart.py").main(["--device", "cpu"])
    got = _storage_lines(capsys.readouterr().out)
    assert len(want) == 4 and got == want
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def _serve_line(text):
    line = next(x for x in text.splitlines() if x.startswith("[serve] 8"))
    return re.sub(r"[\d,.]+ tok/s", "", line)


def test_serve_batched_matches_reference(capsys):
    _load("serve_batched.py").main()
    want = capsys.readouterr().out
    _load("torch_serve_batched.py").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert _serve_line(got) == _serve_line(want)
    dpu = [x for x in want.splitlines() if "DPU ops" in x]
    assert dpu and dpu == [x for x in got.splitlines() if "DPU ops" in x]


TRAIN_ARGS = ["--arch", "tiny-granite-3-2b", "--steps", "3",
              "--global-batch", "2", "--seq", "32", "--ckpt-every", "2"]


def test_train_example_matches_reference(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train_100m_ros2.py"] + TRAIN_ARGS)
    ref_loss = _load("train_100m_ros2.py").main()
    want = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["torch_train_100m_ros2.py"])
    loss = _load("torch_train_100m_ros2.py").main(TRAIN_ARGS
                                                  + ["--device", "cpu"])
    got = capsys.readouterr().out

    def lines(text):
        return [x for x in text.splitlines()
                if x.startswith(("[train] arch=", "[train] DPU ops"))]
    assert len(lines(want)) == 2 and lines(got) == lines(want)
    assert ref_loss is None or np.isfinite(ref_loss)
    assert np.isfinite(loss)
