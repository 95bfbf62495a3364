"""The port's dry-run (`launch/dryrun.py`): its config logic, against the
reference's (`tests/test_dryrun_unit.py`); its trace, held against the
same steps run on real CPU tensors; its mesh records, held against the
collectives of the reference's compiled step; and the model kernels
passing through their ops' fake implementations, never their launches.

Every trace on a mesh runs in a process of its own (the process group is
global): a fake group for the dry-run, gloo for the real run it is held
against, and the reference's compiled step on four host devices
(`--xla_force_host_platform_device_count=4`).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.common.config import SHAPES, ShapeConfig, cell_is_runnable
from repro_torch.configs import ARCHS, get_config, tiny_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import kernel_bwd as FKB
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.rglru_scan import kernel as RK
from repro_torch.kernels.rglru_scan import ops as rops
from repro_torch.kernels.rwkv6_scan import kernel as WK
from repro_torch.kernels.rwkv6_scan import ops as wops
from repro_torch.launch import dryrun
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import init_adam
from repro_torch.train.trainer import map_tree, same_memory

ROOT = Path(__file__).resolve().parent.parent
SHAPES_OF = {"train": ShapeConfig("tiny_train", 16, 4, "train"),
             "prefill": ShapeConfig("tiny_prefill", 32, 4, "prefill"),
             "decode": ShapeConfig("tiny_decode", 48, 4, "decode")}
NMB = 2


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _run(code: str, env=None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-W", "ignore", "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env or _env(), cwd=ROOT)


def _result(proc: subprocess.Popen, timeout: int = 240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# config logic (tests/test_dryrun_unit.py's, on the port's module)

def test_cell_skip_matrix():
    runnable = {(a, s.name) for a in ARCHS for s in SHAPES
                if cell_is_runnable(a, s.name)}
    assert len(runnable) == 10 * 3 + 2
    assert ("rwkv6-1.6b", "long_500k") in runnable
    assert ("recurrentgemma-2b", "long_500k") in runnable
    assert ("gemma-7b", "long_500k") not in runnable
    assert ("deepseek-v2-236b", "long_500k") not in runnable


def test_apply_variant_composition():
    cfg = get_config("dbrx-132b")
    out, nmb = dryrun.apply_variant(cfg, "fp8-dispatch+nmb16+save-coll")
    assert out.moe.dispatch_dtype == "float8_e4m3fn"
    assert out.remat_policy == "save_collectives"
    assert nmb == 16
    base, nmb0 = dryrun.apply_variant(cfg, "")
    assert base == cfg and nmb0 is None


def test_apply_variant_unknown_raises():
    with pytest.raises(KeyError):
        dryrun.apply_variant(get_config("gemma-7b"), "warp-speed")


# ---------------------------------------------------------------------------
# the trace against the same step on real CPU tensors (no mesh)

def _real_args(api: ModelAPI, shape: ShapeConfig, seed: int = 0) -> tuple:
    """The step's arguments as real CPU tensors made from a seed."""
    cfg = api.cfg
    rng = np.random.default_rng(seed)
    params = init_params(api.param_defs(), torch.Generator().manual_seed(seed),
                         getattr(torch, cfg.param_dtype), device="cpu")

    def one(c):
        if c.dtype in (torch.int32, torch.int64):
            hi = shape.seq_len if shape.kind == "decode" else cfg.vocab
            return torch.from_numpy(rng.integers(0, min(hi, cfg.vocab),
                                                 c.shape)).to(c.dtype)
        if shape.kind == "decode":
            return torch.zeros(c.shape, dtype=c.dtype)
        return torch.from_numpy(rng.standard_normal(c.shape)).to(c.dtype)
    inputs = map_tree(one, api.input_specs(shape))
    opt = init_adam(params) if shape.kind == "train" else None
    return dryrun.step_args(shape.kind, params, opt, inputs)


FAMILIES = ("granite-3-2b", "dbrx-132b", "deepseek-v2-236b",
            "recurrentgemma-2b", "rwkv6-1.6b", "llama-3.2-vision-90b",
            "whisper-tiny")
# whisper's prefill runs 448 decoder tokens on the CPU: its decode stands
# for the encdec family
CASES = ([(a, k) for a in FAMILIES for k in ("prefill", "decode")
          if (a, k) != ("whisper-tiny", "prefill")]
         + [(a, "train") for a in ("granite-3-2b", "dbrx-132b")])


@pytest.mark.parametrize("arch,kind", CASES)
def test_trace_counts_equal_real_cpu_run(arch, kind):
    """FLOPs, collectives, bytes and memory of the fake trace equal those
    of the same step run on real CPU tensors (the plain paths: the tiny
    configs' own attn_impl). The FLOPs are held in total: how `matmul`
    splits a batched product between mm and bmm depends on the device
    ("meta" here), and with it, in a decode step's attention of one
    query, the bytes its reshapes copy (decode's bytes are not held)."""
    cfg = tiny_config(arch)
    shape = SHAPES_OF[kind]
    fake = dryrun.trace_cell(cfg, shape, nmb=NMB)
    api = ModelAPI(cfg, "cpu")
    mctx = single_device_ctx(cfg, "cpu")
    step = dryrun.make_step(api, mctx, shape, NMB)
    real = dryrun.record_step(step, _real_args(api, shape))
    assert fake["trace_device"] in ("cuda:0", "meta")
    for key in ("flops_per_device", "collective_counts",
                "collective_bytes_per_device", "memory",
                *(("bytes_per_device",) if kind != "decode" else ())):
        assert fake[key] == real[key], key
    assert fake["flops_per_device"] > 0
    assert fake["memory"]["peak_memory_in_bytes"] >= \
        fake["memory"]["argument_size_in_bytes"] > 0


# ---------------------------------------------------------------------------
# the kernels under a trace: fake implementations only

FLASH = {  # arch -> (cfg transform, the kernel ops its trace must reach)
    "granite-3-2b": (dict(head_dim=64), {"flash_attention_fwd",
                                         "flash_attention_bwd"}),
    # the hybrid's local attention stays on the plain path
    "recurrentgemma-2b": ({}, {"rglru_scan"}),
    "rwkv6-1.6b": ({}, {"wkv6"}),
}


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", list(FLASH))
def test_trace_reaches_no_kernel(arch, kind):
    """A trace of the flash path loads no library and counts no launch;
    its FLOPs include the kernels' registered formulas."""
    over, kernels = FLASH[arch]
    cfg = tiny_config(arch).replace(attn_impl="flash", **over)
    if arch == "rwkv6-1.6b" and kind == "train":
        # the backward: autograd through the sequential recurrence, one op
        kernels = {"wkv6", "wkv6_backward"}
    libs = dict(_build._libs)
    before = (fops.launches(), rops.launches(), wops.launches())
    rec = dryrun.trace_cell(cfg, SHAPES_OF[kind], nmb=NMB)
    assert _build._libs == libs
    assert (fops.launches(), rops.launches(), wops.launches()) == before
    reached = {op.split(".")[1] for op in rec["flops_by_op"]
               if op.startswith("repro_torch.")}
    want = kernels if kind == "train" else {k for k in kernels
                                            if k != "flash_attention_bwd"}
    assert reached == want
    assert all(rec["flops_by_op"][f"repro_torch.{k}"] > 0 for k in want)


def test_wrappers_refuse_fake_tensors():
    """A wrapper handed a fake tensor outside its op raises: its
    data_ptr() reads 0."""
    with FakeTensorMode():
        dev = torch.device("meta")
        q = torch.empty(1, 16, 1, 64, dtype=torch.bfloat16, device=dev)
        lse = torch.empty(1, 1, 16, device=dev)
        a = torch.empty(1, 4, 32, device=dev)
        r = torch.empty(1, 4, 1, 16, device=dev)
        calls = [lambda: FK.flash_attention_fwd(q, q, q, scale=1.0),
                 lambda: FKB.flash_attention_bwd(q, q, q, q, lse, lse,
                                                 scale=1.0),
                 lambda: RK.rglru_scan(a, a),
                 lambda: WK.wkv6(r, r, r, r, r[0, 0])]
        for call in calls:
            with pytest.raises(RuntimeError, match="FakeTensor"):
                call()
    assert _build._libs == {}


def test_fake_kernel_checks_what_the_kernel_takes():
    """A trace refuses what the kernel refuses (head_dim 16 here)."""
    cfg = tiny_config("granite-3-2b").replace(attn_impl="flash")
    with pytest.raises(ValueError, match="head_dim"):
        dryrun.trace_cell(cfg, SHAPES_OF["prefill"])


def test_same_memory_on_real_and_fake_tensors():
    """The decode step's in-place check: equal data_ptr()s on real
    tensors, the same storage and offset on fake ones (whose data_ptr()
    reads 0)."""
    for mode in (None, FakeTensorMode()):
        with mode or torch.no_grad():
            x = torch.empty(4, 8)
            assert same_memory(x, x.view(32).view(4, 8))
            assert not same_memory(x, x.clone())
            assert not same_memory(x, x[1:])
            assert same_memory(x[1:], x[1:].view(-1))


# ---------------------------------------------------------------------------
# on meshes: fake groups, gloo and the reference's compiled step

PORT_MESH = """
import json
from repro_torch.common.config import ShapeConfig
from repro_torch.configs import tiny_config
from repro_torch.launch import dryrun
from repro_torch.models.params import MeshShape
train = ShapeConfig("tiny_train", 32, 8, "train")
# the process's first trace: the models import the kernels' ops inside
# the step, and their FLOP formulas must be counted all the same
flash = tiny_config("granite-3-2b").replace(attn_impl="flash", head_dim=64)
first = dryrun.trace_cell(flash, ShapeConfig("t", 16, 4, "train"), nmb=2)
out = {"first_trace_kernels": sorted(k for k in first["flops_by_op"]
                                     if k.startswith("repro_torch."))}
for arch in ("granite-3-2b", "dbrx-132b"):
    out[arch] = dryrun.trace_cell(tiny_config(arch), train,
                                  MeshShape(("data", "model"), (2, 2)), 2)
# 2 microbatches over 4 data ways: the batch is gathered before the split
out["granite (4, 1)"] = dryrun.trace_cell(
    tiny_config("granite-3-2b"), ShapeConfig("t", 32, 16, "train"),
    MeshShape(("data", "model"), (4, 1)), 2)
print(json.dumps(out))
"""

REF_MESH = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax.numpy as jnp
from repro.common.config import ShapeConfig, TrainConfig
from repro.configs import tiny_config
from repro.launch.mesh import make_host_mesh_ctx
from repro.models.api import ModelAPI
from repro.models.params import abstract_params
from repro.roofline.hlo import collective_count
from repro.train.optimizer import abstract_adam
from repro.train.trainer import jit_train_step
shape = ShapeConfig("tiny_train", 32, 8, "train")
out = {}
for arch in ("granite-3-2b", "dbrx-132b"):
    cfg = tiny_config(arch)
    api, mctx = ModelAPI(cfg), make_host_mesh_ctx(cfg, 2, 2)
    with mctx.mesh:
        step = jit_train_step(api, TrainConfig(num_microbatches=2), mctx,
                              shape, donate=True)
        a_p = abstract_params(api.param_defs(), jnp.dtype(cfg.param_dtype))
        hlo = step.lower(a_p, abstract_adam(a_p),
                         api.input_specs(shape)).compile().as_text()
    out[arch] = collective_count(hlo)
print(json.dumps(out))
"""


def test_mesh_records_against_reference_compiled_step():
    """On a fake (2, 2) mesh the tiny dense and moe train steps trace to
    ok records with the structure `tests/test_roofline.py` asks of the
    reference's compiled HLO: all-reduces in a train step, at least two
    all-to-alls (dispatch and return) in a moe step; the reference's
    compiled step of the same configs on four host devices shows the
    same. The subprocess's first trace, of the flash path, counts the
    kernels' FLOP formulas, which the models' lazy imports register."""
    port = _run(PORT_MESH)
    ref = _run(REF_MESH, dict(_env(), JAX_PLATFORMS="cpu"))
    port, ref = _result(port), _result(ref)
    assert port["first_trace_kernels"] == [
        "repro_torch.flash_attention_bwd", "repro_torch.flash_attention_fwd"]
    for arch in ("granite-3-2b", "dbrx-132b"):
        for counts in (port[arch]["collective_counts"], ref[arch]):
            assert counts.get("all-reduce", 0) >= 2, (arch, counts)
            assert counts.get("all-gather", 0) >= 1, (arch, counts)
        assert port[arch]["n_devices"] == 4
        assert port[arch]["collective_bytes_per_device"] > 0
    for counts in (port["dbrx-132b"]["collective_counts"], ref["dbrx-132b"]):
        assert counts.get("all-to-all", 0) >= 2, counts
    gathered = port["granite (4, 1)"]
    assert gathered["num_microbatches"] == 2
    assert gathered["collective_counts"]["all-gather"] >= 1


TP_MESH = """
import json
from repro_torch.common.config import ShapeConfig
from repro_torch.configs import tiny_config
from repro_torch.launch import dryrun
from repro_torch.models.params import MeshShape
train = ShapeConfig("tiny_train", 32, 8, "train")
out = {}
for name, arch, over, mesh in (
        ("granite (2, 2)", "granite-3-2b", {}, (2, 2)),
        ("granite (4, 1)", "granite-3-2b", {}, (4, 1)),
        ("dbrx (2, 2)", "dbrx-132b", {}, (2, 2)),
        ("dbrx fsdp (2, 2)", "dbrx-132b", {"fsdp": True}, (2, 2))):
    rec = dryrun.trace_cell(tiny_config(arch).replace(**over), train,
                            MeshShape(("data", "model"), mesh), 2)
    out[name] = {k: rec[k] for k in ("flops_per_device", "collective_counts")}
print(json.dumps(out))
"""


def test_tensor_parallel_trace():
    """At the same global batch, a (2, 2) rank computes on half the heads,
    mlp columns and vocab of a (4, 1) rank for twice its batch: tiny
    granite's per-rank product FLOPs within 10% of each other (with the
    params gathered whole, a (2, 2) rank's were twice). The trace counts
    the collectives of the autograd Functions, the backward's too: model
    ranks add all-reduces (row-parallel outputs, the vocab-parallel loss,
    the gradients of column-parallel inputs); fsdp adds all-gathers of
    each layer's leaves (forward and remat's recompute) and their
    gradients' reduce-scatters."""
    out = _result(_run(TP_MESH))
    tp, dp = out["granite (2, 2)"], out["granite (4, 1)"]
    assert abs(tp["flops_per_device"] / dp["flops_per_device"] - 1) < 0.1
    assert (tp["collective_counts"]["all-reduce"]
            >= dp["collective_counts"]["all-reduce"] + 2 * 2 * 2)
    plain, fsdp = (out[k]["collective_counts"]
                   for k in ("dbrx (2, 2)", "dbrx fsdp (2, 2)"))
    # a microbatch (of 2) gathers each of 2 layers' 4 attention and 3 expert
    # leaves twice (remat) and the embedding and unembedding once, and
    # reduce-scatters the gradient of each gather
    assert fsdp["all-gather"] >= 2 * (2 * 2 * 7 + 2) > plain["all-gather"]
    assert fsdp["reduce-scatter"] >= 2 * (2 * 7 + 2)


SAVE_COLL = """
import json
from repro_torch.common.config import ShapeConfig
from repro_torch.configs import tiny_config
from repro_torch.launch import dryrun
from repro_torch.models.params import MeshShape
train = ShapeConfig("tiny_train", 32, 8, "train")
out = {}
for arch in ("gemma-7b", "deepseek-v2-236b", "recurrentgemma-2b",
             "rwkv6-1.6b", "llama-3.2-vision-90b", "whisper-tiny"):
    out[arch] = {v or "base": dryrun.trace_cell(
        dryrun.apply_variant(tiny_config(arch), v)[0], train,
        MeshShape(("data", "model"), (2, 2)), 2) for v in ("", "save-coll")}
print(json.dumps(out))
"""


def test_save_collectives_trace():
    """The variant "save-coll" (remat_policy="save_collectives") on a fake
    (2, 2) mesh, 2 microbatches of 2 rows a rank. The dense and moe
    steps: a layer's recompute, in each microbatch, no longer runs the
    all-reduce after w_o (nor, for deepseek's moe layer with shared
    experts, the all-gather of the routed output), and no longer makes
    w_o's product, which only the collective read (torch's checkpoint
    stops a recompute once it has made what the backward keeps: the
    inputs of a piece's last product); every other count stays. The
    hybrid, ssm, vlm and encdec families keep no collective, as the
    reference's use nothing_saveable whatever the policy: their records
    are the baseline's."""
    out = _result(_run(SAVE_COLL), timeout=300)
    for arch in ("gemma-7b", "deepseek-v2-236b"):
        cfg = tiny_config(arch)
        base, save = out[arch]["base"], out[arch]["save-coll"]
        per = cfg.n_layers * NMB                    # layer-microbatches
        hv = cfg.mla.v_head_dim if cfg.mla else cfg.head_dim
        rows = 8 // 2 // NMB
        w_o = 2 * rows * 32 * (cfg.n_heads // 2) * hv * cfg.d_model
        assert base["flops_per_device"] - save["flops_per_device"] == \
            per * w_o, arch
        fewer = {k: n - save["collective_counts"].get(k, 0)
                 for k, n in base["collective_counts"].items()}
        assert fewer == {k: per if k == "all-reduce"
                         or (k == "all-gather" and cfg.moe) else 0
                         for k in fewer}, (arch, fewer)
    for arch in ("recurrentgemma-2b", "rwkv6-1.6b", "llama-3.2-vision-90b",
                 "whisper-tiny"):
        base, save = out[arch]["base"], out[arch]["save-coll"]
        for key in ("flops_per_device", "flops_by_op", "bytes_per_device",
                    "collective_counts", "collective_bytes_per_device",
                    "memory"):
            assert base[key] == save[key], (arch, key)


GLOO_VS_FAKE = """
import json, tempfile, os
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.common.config import ShapeConfig
from repro_torch.configs import tiny_config
from repro_torch.launch import dryrun
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import mesh_ctx
from repro_torch.models.params import MeshShape, init_params
from repro_torch.train.optimizer import init_adam
torch.manual_seed(0)
out = {}
shapes = {"train": ShapeConfig("tiny_train", 16, 8, "train"),
          "prefill": ShapeConfig("tiny_prefill", 32, 4, "prefill")}
store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
dist.init_process_group("gloo", rank=0, world_size=1, store=store)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
for arch, kind in (("granite-3-2b", "train"), ("dbrx-132b", "prefill")):
    cfg, shape = tiny_config(arch), shapes[kind]
    api, mctx = ModelAPI(cfg, "cpu"), mesh_ctx(cfg, mesh)
    step = dryrun.make_step(api, mctx, shape, 2)
    params = init_params(api.param_defs(), torch.Generator().manual_seed(0),
                         device="cpu")
    toks = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len),
                         dtype=torch.int32)
    inputs = {"tokens": toks, **({"labels": toks} if kind == "train" else {})}
    opt = init_adam(params) if kind == "train" else None
    out[arch] = {"real": dryrun.record_step(
        step, dryrun.step_args(kind, params, opt, inputs))}
dist.destroy_process_group()
for arch, kind in (("granite-3-2b", "train"), ("dbrx-132b", "prefill")):
    out[arch]["fake"] = dryrun.trace_cell(
        tiny_config(arch), shapes[kind],
        MeshShape(("data", "model"), (1, 1)), 2)
print(json.dumps(out))
"""


def test_mesh_trace_counts_equal_gloo_run():
    """On a one-rank mesh the fake trace's FLOPs and collectives equal
    those of the same step run on real CPU tensors over gloo: the dense
    train step's grad-norm all-reduce (its loss is summed over the data
    axes, and a one-rank mesh has one data rank, so that sum, like the
    model-parallel collectives, moves nothing), the moe prefill's
    exchanges."""
    out = _result(_run(GLOO_VS_FAKE))
    for arch, rec in out.items():
        real, fake = rec["real"], rec["fake"]
        for key in ("flops_per_device", "collective_counts",
                    "collective_bytes_per_device"):
            assert fake[key] == real[key], (arch, key)
    assert out["granite-3-2b"]["fake"]["collective_counts"] == {
        "all-reduce": 1}
    assert out["dbrx-132b"]["fake"]["collective_counts"]["all-to-all"] >= 2


CLI = """
import json, sys
from pathlib import Path
from repro_torch.launch import dryrun
dryrun.RESULTS = Path(sys.argv[1])
for argv in (["--arch", "tiny-granite-3-2b", "--shape", "decode_32k"],
             ["--arch", "tiny-granite-3-2b", "--shape", "long_500k"]):
    sys.argv = ["dryrun", *argv]
    try:
        dryrun.main()
    except SystemExit as e:
        assert e.code == 0, e.code
print(json.dumps(sorted(p.name for p in dryrun.RESULTS.iterdir())))
"""


def test_cli_writes_its_records(tmp_path):
    """`main`'s flags: a cell on the 16 x 16 fake mesh of 256 ranks, and a
    skipped one, each written as its record."""
    proc = subprocess.Popen(
        [sys.executable, "-W", "ignore", "-c", CLI, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT)
    names = _result(proc)
    assert names == ["tiny-granite-3-2b__decode_32k__16x16.json",
                     "tiny-granite-3-2b__long_500k__16x16.json"]
    rec = json.loads((tmp_path / names[0]).read_text())
    assert rec["ok"] and rec["n_devices"] == 256 and "trace_s" in rec
    assert rec["attn_impl"] == "flash"
    assert "lower_s" not in rec and "compile_s" not in rec
    skipped = json.loads((tmp_path / names[1]).read_text())
    assert "skipped" in skipped


# ---------------------------------------------------------------------------
# on the card: the dry-run against the eager step (chip_smoke.py 13(a))

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_matches_eager_step_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tiny_config("granite-3-2b").replace(
        attn_impl="flash", head_dim=64, compute_dtype="bfloat16")
    shape = SHAPES_OF[kind]
    fake = dryrun.trace_cell(cfg, shape, nmb=NMB)
    api = ModelAPI(cfg)
    mctx = single_device_ctx(cfg)
    step = dryrun.make_step(api, mctx, shape, NMB)
    args = map_tree(lambda t: t.cuda() if isinstance(t, torch.Tensor) else t,
                    _real_args(ModelAPI(cfg, "cpu"), shape))
    real = dryrun.record_step(step, args)
    for key in ("flops_per_device", "collective_counts"):
        assert fake[key] == real[key], key
    kernels = {k: v for k, v in real["flops_by_op"].items()
               if k.startswith("repro_torch.")}
    assert kernels == {k: v for k, v in fake["flops_by_op"].items()
                       if k.startswith("repro_torch.")}
    names = {k.split(".")[1] for k in kernels}
    if kind == "decode":        # the decode kernel, prefill and train flash
        assert names == {"flash_decode"}
    else:
        assert names and "flash_decode" not in names
