"""The control, at a size a test run holds: the reference put in the
program's place in float8 (`portbench/fp8.py`), read at the positions of
a greedy continuation by the same gaps as a run, fails each cell's
limits; the reference's own tokens pass them. (On the card, at each
cell's own size: `portbench/control.py`.)"""
import pytest
import torch

from portbench.check import judge
from portbench.fp8 import mm_fp8
from portbench.reference import dense
from portbench.spec import HERE, load_json
from portbench.weights import make_weights

L, D, H, KH, HD, V, T = 4, 512, 8, 2, 64, 8192, 256


def _blocks(mlp: dict, layers: int) -> dict:
    return {"ln_attn": (layers, D), "ln_mlp": (layers, D),
            "attn": {"w_q": (layers, D, H, HD), "w_k": (layers, D, KH, HD),
                     "w_v": (layers, D, KH, HD), "w_o": (layers, H, HD, D)},
            "mlp": mlp}


def _dense():
    f = 4 * D
    shapes = {"embed": (V, D), "ln_f": (D,), "blocks": _blocks(
        {"w_gate": (L, D, f), "w_up": (L, D, f), "w_down": (L, f, D)}, L)}
    s = dense.DenseShape(L, D, H, KH, HD, f, V, 1e-6, 1e4, True, HD ** -0.5)
    return shapes, s, dense.forward


CELLS = {"granite-3-2b.rag": _dense, "granite-3-2b.chat": _dense}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_the_cell_and_the_reference_passes(cell):
    limits = load_json(HERE / "cells" / f"{cell}.json")["limits"]
    shapes, s, forward = CELLS[cell]()
    w = make_weights(shapes, 3, "cpu")
    gaps, own = [], []
    with torch.inference_mode():
        for seed in range(2):
            toks = torch.randint(0, V, (T,),
                                 generator=torch.Generator().manual_seed(seed))
            ref = forward(w, s, toks, T // 2)
            low = forward(w, s, toks, T // 2, mm=mm_fp8)
            gaps.append(dense.served_gaps(ref, ref.argmax(-1),
                                          low.argmax(-1)))
            own.append(dense.served_gaps(ref, ref.argmax(-1)))
    g, o = torch.cat(gaps).double(), torch.cat(own).double()

    def values(x):
        return {"store_mismatches": 0, "served_gap_sigma": float(x.max()),
                "served_gap_mean_sigma": float(x.mean())}
    assert not judge(values(g), limits)[0], values(g)
    assert judge(values(o), limits)[0]
