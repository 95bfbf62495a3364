"""Cells of the benchmark cut to a size that runs in seconds on the CPU:
the tiny configurations of the program's registry (float32) written as
the configuration files write the real ones, and each mix with a small
pool, short prompts and few new tokens."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.spec import Cell, HERE, load_json  # noqa: E402

DTYPES = {"params": "float32", "compute": "float32", "kv_cache": "bfloat16"}

DENSE = {
    "name": "tiny-granite-3-2b", "num_hidden_layers": 2, "hidden_size": 64,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "intermediate_size": 128, "vocab_size": 512, "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0, "tie_word_embeddings": True,
    "attention_multiplier": 0.25, "dtypes": DTYPES, "attn_impl": "flash",
    "reference": "dense",
    "port": {"arch": "tiny-granite-3-2b", "replace": {"attn_impl": "flash"}},
}

MOE = {
    "name": "tiny-dbrx-132b", "n_layers": 2, "d_model": 64, "n_heads": 4,
    "vocab_size": 512, "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
    "attn_config": {"kv_n_heads": 4, "rope_theta": 500000.0},
    "ffn_config": {"ffn_hidden_size": 64, "moe_num_experts": 4,
                   "moe_top_k": 2},
    "dtypes": DTYPES, "attn_impl": "flash", "reference": "moe",
    "port": {"arch": "tiny-dbrx-132b", "replace": {"attn_impl": "flash"}},
}


def tiny_mix(name: str) -> dict:
    mix = copy.deepcopy(load_json(HERE / "mixes" / f"{name}.json"))
    mix["prompt"]["item_tokens"] = 8 if name == "rag" else 32
    mix["prompt"]["items"] = 4 if name == "rag" else 1
    mix["pool"]["items"] = 256
    mix["new_tokens"] = {"dist": "log_uniform", "min": 2, "max": 8}
    mix["store"]["warm_reads"] = min(mix["store"].get("warm_reads", 0), 16)
    return mix


# the MoE configuration has no cell of its own yet: it is served under
# the dense chat cell's metrics, so that the harness and the MoE
# reference stay held together, and held to the mean gap, as the widest
# gap is set by routing flips under bfloat16 (PERF.md, dbrx-132b-l4)
CELL_OF = {("dense", "rag"): "granite-3-2b.rag",
           ("dense", "chat"): "granite-3-2b.chat",
           ("moe", "chat"): "granite-3-2b.chat"}
MOE_LIMITS = {"store_mismatches": 0, "served_gap_mean_sigma": 0.06}


def tiny_cell(config: dict, mix: str, batch: int = 4) -> Cell:
    """The cell of `BENCHMARK.json` that serves `config`'s family under
    `mix` (for the MoE, the dense cell's), at the tiny size."""
    b = load_json(ROOT / "BENCHMARK.json")
    name = CELL_OF[config["reference"], mix]
    limits = (MOE_LIMITS if config["reference"] == "moe" else
              load_json(HERE / "cells" / f"{name}.json")["limits"])
    return Cell(name=name, config=config, mix=tiny_mix(mix),
                # every served request checked, so that a fault that
                # touches some requests is seen whichever they are
                cell={"engine_batch": batch, "sample_requests": 10**6,
                      "limits": limits},
                chips=1, end_to_end=b["end_to_end"], per_layer=b["per_layer"])
