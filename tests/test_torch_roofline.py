"""The port's roofline (`roofline/analytic.py`, `roofline/collectives.py`)
against the reference's (`repro/roofline/analytic.py`, `hlo.py`).

The analytic terms must equal the reference's exactly, for every arch,
shape, mesh plan and dry-run variant, with each config carried across
field by field: the formulas are the same and so is their order of
operations. `Terms.seconds()` divides by the H100's peaks instead of the
v5e's. The recorder's wire bytes use `hlo.py`'s formulas, and on a fake
group of four ranks it gives `tests/test_roofline.py`'s byte counts for
the same collectives.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.common.config import SHAPE_BY_NAME as REF_SHAPES
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.roofline import analytic as ref_analytic
from repro.roofline.hlo import COLLECTIVES as REF_COLLECTIVES
from repro.roofline.hlo import _wire_bytes as ref_wire_bytes
from repro_torch.common import config as port_config
from repro_torch.common.config import SHAPE_BY_NAME, SHAPES
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh
from repro_torch.launch.dryrun import TRAIN_MICROBATCHES, VARIANTS
from repro_torch.roofline import analytic
from repro_torch.roofline.collectives import COLLECTIVES, _wire_bytes

ROOT = Path(__file__).resolve().parent.parent
PLANS = [(16, 16), (32, 16), (1, 1)]


def carried(ref_cfg):
    """The reference's config as the port's, field by field (sub-configs
    into the port's dataclasses of the same names)."""
    kw = {}
    for f in dataclasses.fields(ref_cfg):
        v = getattr(ref_cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(port_config, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return port_config.ModelConfig(**kw)


def test_configs_and_shapes_carry_across():
    assert ARCHS == REF_ARCHS
    assert [s.name for s in SHAPES] == list(REF_SHAPES)
    for arch in ARCHS:
        assert carried(ref_get_config(arch)) == get_config(arch), arch


def test_h100_constants():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert (analytic.PEAK_FLOPS, analytic.HBM_BW, analytic.ICI_BW) == (
        mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW)


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_terms_equal_reference(arch, shape):
    """detail, flops_dev, hbm_dev and coll_dev equal the reference's for
    every plan and variant; seconds() is the reference's terms over the
    H100's peaks; model_flops_per_step equals the reference's."""
    base = ref_get_config(arch)
    nmb = TRAIN_MICROBATCHES[arch]
    for variant in ("", *VARIANTS):
        if variant == "fp8-dispatch" and base.moe is None:
            continue
        ref_cfg = VARIANTS[variant](base) if variant else base
        cfg = carried(ref_cfg)
        assert cfg == (VARIANTS[variant](get_config(arch)) if variant
                       else get_config(arch))
        assert analytic.model_flops_per_step(cfg, SHAPE_BY_NAME[shape]) == \
            ref_analytic.model_flops_per_step(ref_cfg, REF_SHAPES[shape])
        for dp, tp in PLANS:
            want = ref_analytic.terms_for(ref_cfg, REF_SHAPES[shape],
                                          ref_analytic.MeshPlan(dp, tp), nmb)
            got = analytic.terms_for(cfg, SHAPE_BY_NAME[shape],
                                     analytic.MeshPlan(dp, tp), nmb)
            where = (arch, shape, variant, dp, tp)
            assert got.detail == want.detail, where
            assert (got.flops_dev, got.hbm_dev, got.coll_dev) == (
                want.flops_dev, want.hbm_dev, want.coll_dev), where
            comp = want.flops_dev / 989e12
            mem = want.hbm_dev / 3.35e12
            coll = want.coll_dev / 450e9
            bound = max(comp, mem, coll)
            assert got.seconds() == {
                "compute_s": comp, "memory_s": mem, "collective_s": coll,
                "dominant": max(("compute", comp), ("memory", mem),
                                ("collective", coll),
                                key=lambda kv: kv[1])[0],
                "roofline_frac": comp / bound if bound > 0 else 1.0}, where


def test_wire_bytes_equal_reference():
    assert COLLECTIVES == REF_COLLECTIVES
    for kind in COLLECTIVES:
        for n in range(1, 513):
            for nbytes in (0, 1, 4096, 3 * 1024 ** 3 + 7):
                assert _wire_bytes(kind, nbytes, n) == ref_wire_bytes(
                    kind, nbytes, n), (kind, nbytes, n)


# the collectives of tests/test_roofline.py's HLO sample, dispatched on a
# fake group of four ranks (own process: the group is global), through
# c10d and through the functional collectives DTensor uses
RECORDER = """
import json, torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.roofline.collectives import StepRecorder, collective_stats
dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
pair = dist.new_group([0, 1])
out = {}
with FakeTensorMode():
    with StepRecorder() as rec:
        dist.all_gather_into_tensor(torch.empty(64, 128),
                                    torch.empty(16, 128))
        dist.all_reduce(torch.empty(32, 32, dtype=torch.bfloat16))
        dist.reduce_scatter_tensor(torch.empty(8, 128),
                                   torch.empty(16, 128), group=pair)
        dist.send(torch.empty(16), dst=1)
    out["c10d"] = collective_stats(rec.collectives)
    with StepRecorder() as rec:
        funcol.all_gather_tensor(torch.empty(16, 128), 0, dist.group.WORLD)
        funcol.all_reduce(torch.empty(32, 32, dtype=torch.bfloat16), "sum",
                          dist.group.WORLD)
        funcol.reduce_scatter_tensor(torch.empty(16, 128), "sum", 0, pair)
    out["functional"] = collective_stats(rec.collectives)
print(json.dumps(out))
"""


def test_recorder_byte_counts_on_a_fake_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-W", "ignore", "-c", RECORDER],
                         capture_output=True, text=True, env=env,
                         timeout=240, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    want = {"all-gather": int(64 * 128 * 4 * 3 / 4),
            "all-reduce": int(2 * 32 * 32 * 2 * 3 / 4),
            "reduce-scatter": 8 * 128 * 4 * 1}
    counts, bts = out["c10d"]
    assert counts == {"all-gather": 1, "all-reduce": 1,
                      "reduce-scatter": 1, "collective-permute": 1}
    assert bts == dict(want, **{"collective-permute": 16 * 4})
    counts, bts = out["functional"]
    assert counts == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1}
    assert bts == want
