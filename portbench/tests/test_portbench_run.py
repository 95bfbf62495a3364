"""A run end to end on the CPU at the tiny size, past run.py's look for a
card: sound, it comes out correct; with the timed path broken
underneath, not. And run.py itself prints no result without a card."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import store as store_mod
from portbench.run import result, run_cell
from portbench.tests.tiny import DENSE, MOE, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 17


def _run(cell, seconds=0.3, trace=False):
    return run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                    warm_s=0)


def test_run_py_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "granite-3-2b.chat", "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.parametrize("config,mix", [(DENSE, "rag"), (DENSE, "chat"),
                                        (MOE, "chat")],
                         ids=["dense-rag", "dense-chat", "moe-chat"])
def test_sound_run_is_correct_and_reports_its_metrics(config, mix):
    cell = tiny_cell(config, mix)
    rec = _run(cell, seconds=1.0, trace=True)
    assert rec["correct"], rec["checks"]
    assert rec["values"]["store_mismatches"] == 0
    assert rec["values"]["sampled_tokens"] >= 3
    assert rec["replays"]["prefill"] == len(rec["window"]["waves"])
    e2e = result(cell, rec, False)
    listed = {m["name"] for m in cell.metrics(False)}
    # a tail is left out of a window that no reply came in
    assert ({"tokens_per_s", "setup_s"} & listed) <= set(e2e["metrics"]) \
        <= listed
    assert e2e["attempted"] == len(rec["window"]["requests"]) > 0
    assert e2e["failed"] == 0
    traced = result(cell, rec, True)
    assert {"decode_step_ms", "mfu.prefill", "prefill_wave_ms"} <= set(
        traced["metrics"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def _frozen_decode(self, params):
    """A decode step that returns its state unchanged: the logits, but no
    new token, position or cache."""
    logits, _ = self.api.decode(params, {"token": self.token.clone(),
                                         "pos": self.pos.clone()},
                                {k: v.clone() for k, v in self.cache.items()},
                                self.mctx)
    return logits


def _half_batch(self, padded, toks):
    """Half of the wave left out: its second half prefills the first
    half's prompts."""
    h = toks.shape[0] // 2
    toks = toks.clone()
    toks[h:2 * h] = toks[:h]
    return {"tokens": toks}


def _altered_token(orig):
    """Every request's token of the first decode step altered."""
    def decode(self, params):
        logits = orig(self, params)
        if int(self.pos[0]) == self.prompt_len + 1:
            self.token.add_(1).remainder_(self.api.cfg.vocab)
        return logits
    return decode


def _altered_read(orig):
    def read(self, reqs):
        out = orig(self, reqs)
        for g in out:
            if "prompt" in g:
                g["prompt"] = g["prompt"].copy()
                g["prompt"][0] ^= 1
        return out
    return read


FAULTS = {
    "state_unchanged": ("BatchedEngine", "_decode", lambda o: _frozen_decode),
    "half_batch": ("BatchedEngine", "wave_inputs", lambda o: _half_batch),
    "token_altered": ("BatchedEngine", "_decode", _altered_token),
    "read_altered": ("Store", "read", _altered_read),
}


CELLS = {"granite-3-2b.rag": (DENSE, "rag"),
         "granite-3-2b.chat": (DENSE, "chat")}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault, cell, monkeypatch):
    """Each fault a cell can have, under that cell's own limits. (It runs
    on one chip: no exchange between chips to leave out.)"""
    from repro_torch.launch import serve as engine_mod
    owner, name, make = FAULTS[fault]
    cls = (engine_mod.BatchedEngine if owner == "BatchedEngine"
           else store_mod.Store)
    monkeypatch.setattr(cls, name, make(getattr(cls, name)))
    rec = _run(tiny_cell(*CELLS[cell]))
    assert not rec["correct"], (fault, rec["checks"])


def test_run_record_survives_json():
    rec = _run(tiny_cell(MOE, "chat"))
    json.dumps(result(tiny_cell(MOE, "chat"), rec, False))
    assert all(np.asarray(r["prompt"]).dtype == np.int32
               for r in rec["window"]["requests"])
