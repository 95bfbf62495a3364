"""The port's sharding rules against the reference's, exactly.

`spec_for`, `param_pspecs`, `zero1_pspecs`, `make_rules`, and
`ModelAPI.cache_pspecs` / `input_pspecs` / `shardings_for` for every
architecture on the production meshes and on small ones, in one process
and with no process group: the reference's functions read only a mesh's
axis names and `devices.shape`, so they run on a stand-in mesh, and the
port's run on a `MeshShape`.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.common.config import SHAPES as REF_SHAPES
from repro.configs import ARCHS, get_config as ref_get_config
from repro.models.api import ModelAPI as RefAPI
from repro.models.api import shardings_for as ref_shardings_for
from repro.models.context import MeshCtx as RefCtx
from repro.models.context import make_rules as ref_make_rules
from repro.models.params import DEFAULT_RULES as REF_RULES
from repro.models.params import param_pspecs as ref_param_pspecs
from repro.models.params import spec_for as ref_spec_for
from repro.models.params import zero1_pspecs as ref_zero1_pspecs
from repro_torch.common.config import SHAPES
from repro_torch.configs import get_config
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.api import ModelAPI, shardings_for
from repro_torch.models.context import MeshCtx, make_rules
from repro_torch.models.params import (DEFAULT_RULES, MeshShape,
                                       param_pspecs, placements, spec_for,
                                       zero1_pspecs)

MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x2": (("data", "model"), (2, 2)),
    "4x1": (("data", "model"), (4, 1)),
    "1x4": (("data", "model"), (1, 4)),
}


def _meshes(name):
    names, shape = MESHES[name]
    ref = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    return ref, MeshShape(names, shape)


def _ref_tree(tree, is_leaf=None):
    """A reference spec tree as nested dicts of plain tuples."""
    return jax.tree.map(lambda p: None if p is None else tuple(p), tree,
                        is_leaf=is_leaf or (lambda x: x is None
                                            or type(x).__name__
                                            == "PartitionSpec"))


def _configs(arch, seq_shard=False):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    if seq_shard:
        ref_cfg = ref_cfg.replace(cache_seq_shard=True)
        cfg = cfg.replace(cache_seq_shard=True)
    return ref_cfg, cfg


def test_default_rules_and_production_meshes():
    assert DEFAULT_RULES == REF_RULES
    assert production_mesh_shape() == MeshShape(*MESHES["16x16"])
    assert production_mesh_shape(multi_pod=True) == MeshShape(
        *MESHES["2x16x16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules(arch):
    ref_cfg, cfg = _configs(arch)
    assert make_rules(cfg) == ref_make_rules(ref_cfg)


SPEC_CASES = [  # logical axes, shape: divisible, non-divisible, missing "pod"
    (("batch", None), (32, 7)),
    (("batch", "embed"), (6, 64)),
    (("vocab", "embed"), (51865, 384)),
    (("heads", "kv_heads", None), (32, 1, 128)),
    (("experts", "mlp", "fsdp"), (16, 10752, 6144)),
    (("zero", "rnn", "sp_seq"), (2, 2560, 4096)),
]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("axes,shape", SPEC_CASES)
def test_spec_for(mesh, axes, shape):
    ref_mesh, port_mesh = _meshes(mesh)
    rules = dict(DEFAULT_RULES, fsdp=("data",))
    assert spec_for(port_mesh, axes, shape, rules) == tuple(
        ref_spec_for(ref_mesh, axes, shape, dict(REF_RULES, fsdp=("data",))))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_pspecs(arch, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    ref_cfg, cfg = _configs(arch)
    ref_defs, defs = RefAPI(ref_cfg).param_defs(), ModelAPI(
        cfg, device="cpu").param_defs()
    ref_rules, rules = ref_make_rules(ref_cfg), make_rules(cfg)
    assert param_pspecs(defs, port_mesh, rules) == _ref_tree(
        ref_param_pspecs(ref_defs, ref_mesh, ref_rules))
    assert zero1_pspecs(defs, port_mesh, rules) == _ref_tree(
        ref_zero1_pspecs(ref_defs, ref_mesh, ref_rules))


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs(arch, mesh, seq_shard):
    ref_mesh, port_mesh = _meshes(mesh)
    ref_cfg, cfg = _configs(arch, seq_shard)
    ref = RefAPI(ref_cfg).cache_pspecs(
        RefCtx(mesh=ref_mesh, rules=ref_make_rules(ref_cfg)))
    got = ModelAPI(cfg, device="cpu").cache_pspecs(
        MeshCtx(device=None, mesh=port_mesh, rules=make_rules(cfg)))
    assert got == _ref_tree(ref)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_pspecs_and_shardings(arch, mesh, kind):
    """`input_pspecs`, and `shardings_for` fitting them to the inputs'
    shapes, at the assigned shape of that kind."""
    ref_mesh, port_mesh = _meshes(mesh)
    ref_cfg, cfg = _configs(arch)
    ref_shape = next(s for s in REF_SHAPES if s.kind == kind)
    shape = next(s for s in SHAPES if s.kind == kind)
    ref_api, api = RefAPI(ref_cfg), ModelAPI(cfg, device="cpu")
    ref_ctx = RefCtx(mesh=ref_mesh, rules=ref_make_rules(ref_cfg))
    ctx = MeshCtx(device=None, mesh=port_mesh, rules=make_rules(cfg))
    ref = ref_api.input_pspecs(ref_ctx, ref_shape)
    got = api.input_pspecs(ctx, shape)
    assert got == _ref_tree(ref)

    # the reference's NamedSharding needs a real mesh: compare its fitting
    # through the specs alone, with NamedSharding stood in by its spec
    import repro.models.api as ref_api_mod
    real = ref_api_mod.NamedSharding
    ref_api_mod.NamedSharding = lambda mesh, p: p
    try:
        ref_fit = ref_shardings_for(ref_mesh, ref_api.input_specs(ref_shape),
                                    ref)
    finally:
        ref_api_mod.NamedSharding = real
    assert shardings_for(port_mesh, api.input_specs(shape), got) == \
        _ref_tree(ref_fit)


@pytest.mark.parametrize("arch", ARCHS)
def test_meshless_context_reads_as_one_by_one(arch):
    """The meshless context's specs are the reference's on its 1 x 1
    single-device mesh."""
    ref_mesh, _ = _meshes("2x2")
    ref_mesh.devices = np.empty((1, 1))
    ref_cfg, cfg = _configs(arch)
    ref = RefAPI(ref_cfg).cache_pspecs(
        RefCtx(mesh=ref_mesh, rules=ref_make_rules(ref_cfg)))
    ctx = MeshCtx(device=None, rules=make_rules(cfg))
    assert ModelAPI(cfg, device="cpu").cache_pspecs(ctx) == _ref_tree(ref)
    assert (ctx.dp_size(), ctx.tp_size(), ctx.batch_axes) == (1, 1, ("data",))


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    ms = MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert placements((("pod", "data"), None, "model"), ms) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements((None, "data"), ms) == [Replicate(), Shard(1),
                                              Replicate()]
    with pytest.raises(ValueError):
        placements((("data", "pod"),), ms)
