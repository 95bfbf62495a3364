"""The port's checkpoint manager against the reference on the CPU.

Leaf names, file names and bytes must be the reference's exactly, so a
checkpoint written by either package restores bit for bit in the other.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import tiny_config as ref_tiny_config
from repro.core.client import ROS2Client as RefClient
from repro.distributed import checkpoint as rckpt
from repro.models.api import ModelAPI as RefAPI
from repro.models.params import init_params as ref_init_params
from repro.train.optimizer import AdamState as RefAdamState
from repro_torch.core import ROS2Client
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models.params import params_from_numpy
from repro_torch.train.optimizer import AdamState


@pytest.fixture
def clients():
    ref = RefClient(mode="host", transport="rdma")
    port = ROS2Client(mode="host", transport="rdma", device="cpu")
    yield ref, port
    ref.close()
    port.close()


def _train_state():
    """{"params", "opt"} of the tiny granite model in both packages, the
    moments filled so that every leaf's bytes differ."""
    api = RefAPI(ref_tiny_config("granite-3-2b"))
    rp = ref_init_params(api.param_defs(), jax.random.PRNGKey(0))
    ro = RefAdamState(jnp.int32(30), jax.tree.map(lambda x: x * 0.5, rp),
                      jax.tree.map(lambda x: x * x, rp))
    ref_tree = {"params": rp, "opt": ro}
    host = jax.tree.map(np.asarray, ref_tree)
    port_tree = {"params": params_from_numpy(host["params"], device="cpu"),
                 "opt": AdamState(torch.tensor(30, dtype=torch.int32),
                                  params_from_numpy(host["opt"].m,
                                                    device="cpu"),
                                  params_from_numpy(host["opt"].v,
                                                    device="cpu"))}
    return ref_tree, port_tree


def _odd_tree(lib):
    """Lists, tuples, None, 0-d leaves and bf16, in either package."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal(7).astype(ml_dtypes.bfloat16)
    if lib == "ref":
        return {"layers": [{"w": jnp.asarray(w)}, None,
                           (jnp.asarray(b), jnp.int32(4))],
                "z": RefAdamState(jnp.int32(1), {"a b": jnp.asarray(w)},
                                  [jnp.asarray(w)])}
    bt = torch.from_numpy(b.view(np.uint16).copy()).view(torch.bfloat16)
    return {"layers": [{"w": torch.from_numpy(w)}, None,
                       (bt, torch.tensor(4, dtype=torch.int32))],
            "z": AdamState(torch.tensor(1, dtype=torch.int32),
                           {"a b": torch.from_numpy(w)},
                           [torch.from_numpy(w)])}


def _files(client, d):
    names = sorted(client.dfs.readdir(d))
    out = {}
    for name in names:
        size = client.dfs.stat(f"{d}/{name}")["size"]
        out[name] = client.pread(client.open(f"{d}/{name}"), size, 0)
    return out


def test_leaf_names_are_the_references():
    ref_tree, port_tree = _train_state()
    want = [n for n, _ in rckpt._flatten_named(ref_tree)]
    got = [n for n, _ in ckpt._flatten_named(port_tree)]
    assert got == want
    assert got[0] == "opt_.step"
    assert "opt_.m_blocks_attn_w_q" in got
    assert "params_blocks_attn_w_q" in got
    assert ([n for n, _ in ckpt._flatten_named(_odd_tree("port"))]
            == [n for n, _ in rckpt._flatten_named(_odd_tree("ref"))])


@pytest.mark.parametrize("which", ["train", "odd"])
def test_same_state_gives_the_same_files(clients, which):
    """The same state saved by both managers: the same file names and the
    same bytes, manifest included."""
    ref, port = clients
    if which == "train":
        ref_tree, port_tree = _train_state()
    else:
        ref_tree, port_tree = _odd_tree("ref"), _odd_tree("port")
    rm = rckpt.ROS2CheckpointManager(ref, "/ckpt", keep=2)
    pm = ckpt.ROS2CheckpointManager(port, "/ckpt", keep=2)
    rm.save(30, ref_tree)
    pm.save(30, port_tree)
    rm.wait()
    pm.wait()
    got, want = _files(port, "/ckpt/step-30"), _files(ref, "/ckpt/step-30")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert pm.bytes_written == rm.bytes_written


def _copy_step(src, dst, d):
    dst.mkdir(d.rsplit("/", 1)[0])
    dst.mkdir(d)
    files = _files(src, d)
    for name in sorted(files, key=lambda n: n == "COMMIT"):   # COMMIT last
        dst.pwrite(dst.open(f"{d}/{name}", create=True), files[name], 0)


def _assert_bits(got_tree, want_tree):
    got, want = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        assert g.shape == w.shape and g.tobytes() == w.tobytes()


def test_reference_checkpoint_restores_in_the_port_and_back(clients):
    """A step written by the reference, copied file by file into the
    port's store, restores bit for bit in the port; and the reverse."""
    ref, port = clients
    ref_tree, port_tree = _train_state()
    rm = rckpt.ROS2CheckpointManager(ref, "/ckpt")
    rm.save(20, ref_tree)
    rm.wait()
    _copy_step(ref, port, "/ckpt/step-20")
    pm = ckpt.ROS2CheckpointManager(port, "/ckpt")
    step, got = pm.restore(port_tree)
    assert step == 20 and isinstance(got["opt"], AdamState)
    _assert_bits(got, ref_tree)

    pm.save(40, port_tree)
    pm.wait()
    _copy_step(port, ref, "/ckpt/step-40")
    step, back = rm.restore(ref_tree)
    assert step == 40
    _assert_bits(back, ref_tree)
    odd = ckpt.ROS2CheckpointManager(port, "/odd", asynchronous=False)
    odd.save(1, _odd_tree("port"))
    _, got = odd.restore(_odd_tree("port"))
    _assert_bits(got, _odd_tree("ref"))
    assert got["layers"][1] is None and isinstance(got["layers"][2], tuple)


def test_gc_and_uncommitted_steps(clients):
    _, port = clients
    _, tree = _train_state()
    mgr = ckpt.ROS2CheckpointManager(port, "/ckpt", keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.committed_steps() == [3, 4] and mgr.saves == 4
    port.mkdir("/ckpt/step-5")               # a writer died before COMMIT
    port.pwrite(port.open("/ckpt/step-5/manifest.json", create=True),
                b'{"step": 5, "leaves": []}', 0)
    step, got = mgr.restore(tree)
    assert step == 4
    _assert_bits(got["params"], jax.tree.map(
        lambda t: t.numpy(), tree["params"]))


def test_save_snapshots_the_state_before_it_returns(clients):
    """The train step updates params and moments in place (on the CPU
    too) while the writer thread streams the last snapshot: what lands is
    the state at save(), not the state the writer reads later."""
    _, port = clients
    _, tree = _train_state()
    want = jax.tree.map(lambda t: t.numpy().copy(), tree)
    mgr = ckpt.ROS2CheckpointManager(port, "/ckpt", keep=2)
    mgr.save(1, tree)
    for leaf in jax.tree.leaves(tree):
        leaf.add_(1)
    step, got = mgr.restore(tree)
    assert step == 1
    _assert_bits(got["params"], want["params"])
    _assert_bits(got["opt"].m, want["opt"].m)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_save_in_flight_when_a_device_fails_is_lost(clients, package):
    """A reference-side fault the port keeps (ROADMAP Queue 3): when a
    device fails while a checkpoint's write to it is in flight, the
    replicated write misses its quorum, the manager raises at the next
    wait and retries nothing, so that step's checkpoint is lost. A save
    after the failure lands on the live devices."""
    ref, port = clients
    ref_tree, port_tree = _train_state()
    client, mod, tree = ((ref, rckpt, ref_tree) if package == "reference"
                         else (port, ckpt, port_tree))
    victim = client.devices[0]
    write = victim.write

    def dies_mid_write(key, data, **kw):
        client.store.fail_device(victim.name)
        return write(key, data, **kw)

    victim.write = dies_mid_write
    mgr = mod.ROS2CheckpointManager(client, "/ckpt", keep=2)
    mgr.save(10, tree)
    with pytest.raises(Exception, match="replica commit quorum failed"):
        mgr.wait()
    assert mgr.committed_steps() == []
    mgr.save(20, tree)
    mgr.wait()
    assert mgr.committed_steps() == [20]
    _, got = mgr.restore(tree)
    _assert_bits(got, ref_tree)
