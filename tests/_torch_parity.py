"""Helpers the port's parity tests share: one tiny config built in both
packages on the same weights, seeded inputs, and tree comparisons; and
the storage system in both packages (`StoragePkg`, `same`), for the
storage parity tests.

Params are made by the reference's `init_params` and carried across with
`params_from_numpy`, so both packages run the same weights.
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import jax

from repro.configs import tiny_config as ref_tiny_config
from repro.models.api import ModelAPI as RefAPI
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import tiny_config
from repro_torch.launch.serve import SEQ_AXIS
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import params_from_numpy


def pair(name, impl, tree_fn=None, moe=None, **over):
    """((ref api, ref params, ref ctx), (api, params, ctx)) of the tiny
    config `name` with `attn_impl=impl` and `over` replaced (and the fields
    of its MoE config in `moe`), on the CPU. `tree_fn` may edit the
    reference's params (numpy) before both packages take them."""
    ref_cfg = ref_tiny_config(name).replace(attn_impl=impl, **over)
    cfg = tiny_config(name).replace(attn_impl=impl, **over)
    if moe:
        ref_cfg = ref_cfg.replace(moe=dataclasses.replace(ref_cfg.moe, **moe))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    ref_api, api = RefAPI(ref_cfg), ModelAPI(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, ref_init_params(ref_api.param_defs(),
                                                    jax.random.PRNGKey(0)))
    if tree_fn is not None:
        tree_fn(tree)
    params = params_from_numpy(tree, device="cpu")
    ref_params = jax.tree.map(jax.numpy.asarray, tree)
    return (ref_api, ref_params, ref_ctx(ref_cfg)), (
        api, params, single_device_ctx(cfg, device="cpu"))


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_tree_close(got, want, **tol):
    """Same keys, shapes and dtypes; values within tol."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            assert_tree_close(got[key], want[key], **tol)
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def ref_grow_cache(cache, family, grow):
    """The reference's prefill cache grown as the port's `grow_cache` grows
    the port's: `grow` zero positions on each self-attention cache's
    sequence axis (`SEQ_AXIS`)."""
    def pad(x):
        widths = [(0, 0)] * x.ndim
        widths[SEQ_AXIS[family]] = (0, grow)
        return jax.numpy.pad(x, widths)
    if family in ("vlm", "encdec"):
        return dict(cache, self=jax.tree.map(pad, cache["self"]))
    return jax.tree.map(pad, cache)


class RefJit:
    """The reference API's loss, prefill, decode and loss gradient, each
    under jax.jit (eager shard_map, which the MoE FFN uses, is slow)."""

    def __init__(self, rapi, rctx):
        self.loss = jax.jit(lambda p, b: rapi.loss(p, b, rctx))
        self.prefill = jax.jit(lambda p, b: rapi.prefill(p, b, rctx))
        self.decode = jax.jit(lambda p, b, c: rapi.decode(p, b, c, rctx))
        self.grad = jax.jit(jax.grad(lambda p, b: rapi.loss(p, b, rctx)))


# ---------------------------------------------------------------------------
# The storage system in both packages.
#
# A scenario is a function `scenario(pkg, ...)` that builds what it needs
# through `pkg` (the reference's `repro.core` or the port's
# `repro_torch.core` on the CPU), drives it, and returns what it observed.
# `same(scenario, ...)` replays it through both and holds the two
# observations equal; a scenario draws all its data from numpy seeds, so
# both packages see the same bytes.

STORAGE_MODULES = ("client", "control_plane", "counters_registry",
                   "data_plane", "device_direct", "dfs", "faults", "fio",
                   "media", "metadata_cache", "object_store", "sim",
                   "smartnic", "transport_model")

# Counters left out of a comparison, and why: control.rpc_bytes sums the
# printed length of every RPC payload, which carries memory-region ids drawn
# from one process-wide counter (data_plane._region_ids): two clients in one
# process register different ids, and their decimal width differs.
NONDETERMINISTIC = {"control.rpc_bytes"}
MiB = 1 << 20
DOMAINS4 = ["a", "a", "b", "b"]
DOMAINS8 = ["a", "a", "b", "b", "c", "c", "d", "d"]


class StoragePkg:
    """One package's storage modules under common names. `Client`,
    `Cluster` and `Scrubber` build the package's objects, on the CPU where
    the package takes a device."""

    def __init__(self, root, device=None):
        import importlib
        self.root = root
        self.kw = {} if device is None else {"device": device}
        for mod in STORAGE_MODULES:
            setattr(self, mod, importlib.import_module(f"{root}.core.{mod}"))
        self.fault = importlib.import_module(f"{root}.distributed.fault")

    def __repr__(self):
        return self.root

    def Client(self, **kw):
        kw.setdefault("scrub_interval_s", None)
        return self.client.ROS2Client(**kw, **self.kw)

    def Cluster(self, **kw):
        return self.object_store.StorageCluster(**kw, **self.kw)

    def Scrubber(self, store, **kw):
        return self.object_store.MediaScrubber(store, **kw, **self.kw)


REF = StoragePkg("repro")
PORT = StoragePkg("repro_torch", device="cpu")


@pytest.fixture(autouse=True, scope="module")
def storage_env():
    """What a storage parity module runs under; import it into the module.

    * One torch thread: the port's plain parity version runs on small
      tensors from several router threads at once, and torch's intra-op
      pool under each of them oversubscribes the cores the suite's other
      workers share.
    * The reference's parity legs take its plain numpy version
      (`repro.kernels.rs_parity.ref.gf_matmul_np`, which its own tests
      hold bit-exact against its Pallas kernel) in place of the kernel in
      interpret mode, which jit-compiles anew for every cell length and
      costs a soak a minute."""
    from repro.kernels.rs_parity import ops as rs_ops, ref as rs_ref

    def plain(mat, cells, **_kw):
        return rs_ref.gf_matmul_np(np.asarray(mat, np.uint8),
                                   np.asarray(cells, np.uint8))

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rs_ops, "gf_matmul", plain)
        yield
    torch.set_num_threads(n)


def payload(n, seed=0):
    return bytes(np.random.default_rng(seed).integers(0, 256, n,
                                                      dtype=np.uint8))


def flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}."))
        else:
            out[f"{pre}{k}"] = v
    return out


def counters(client):
    """`data_path_counters()` flattened, without the nondeterministic ones
    (it also joins the EC stragglers)."""
    return {k: v for k, v in flat(client.io.data_path_counters()).items()
            if k not in NONDETERMINISTIC}


def image(client):
    """The committed on-media image of a client's fleet, as the port's
    `media_image` builds it (the reference has no such function): every
    block of every alive device of every up target, after writeback, as
    {(target, device, key): bytes}."""
    out = {}
    for t in client.cluster.targets:
        if not client.cluster.pool_map.is_up(t.target_id):
            continue
        for d in t.store.devices:
            if not d.alive:
                continue
            d.writeback()
            with d._lock:
                blocks = dict(d._blocks)
            for key, data in blocks.items():
                out[(t.target_id, d.name, key)] = bytes(data)
    return out


def no_leaks(client):
    """The leak witness's end-state invariants (donated slots drained,
    free lists whole, no rkey grant or handle left) on either package's
    client: `client_leaks` only duck-types it."""
    from tools.analysis.leakwitness import client_leaks
    problems = client_leaks(client)
    assert not problems, f"{client.__class__.__module__}: {problems}"


def _diff(got, want, path="result"):
    if isinstance(want, dict) and isinstance(got, dict):
        assert got.keys() == want.keys(), (
            f"{path}: keys differ: only in port "
            f"{sorted(map(str, got.keys() - want.keys()))}, only in "
            f"reference {sorted(map(str, want.keys() - got.keys()))}")
        for k in want:
            _diff(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)) and isinstance(got, (list, tuple)):
        assert len(got) == len(want), f"{path}: {len(got)} != {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            _diff(g, w, f"{path}[{i}]")
    else:
        assert got == want, f"{path}: port {got!r:.200} != " \
                            f"reference {want!r:.200}"


def same(scenario, *args, **kw):
    """Run `scenario` through the reference and the port and hold what each
    observed equal; returns the port's observation."""
    want = scenario(REF, *args, **kw)
    got = scenario(PORT, *args, **kw)
    _diff(got, want)
    return got


def placed(img):
    """An on-media image as what each target holds: the multiset of block
    payloads per target. Block keys come from a per-device allocation
    counter and replicas pick a device by load, so where background commits
    interleave (replica stragglers, EC cell fan-out) keys and devices vary
    from run to run in the reference itself; what each target stores does
    not."""
    from collections import Counter
    return Counter((key[0], hashlib.sha256(data).hexdigest())
                   for key, data in img.items())


class InlineExecutor:
    """An executor that runs each task in the submitting thread, at once,
    in submission order."""

    def submit(self, fn, *args, **kw):
        from concurrent.futures import Future
        fut = Future()
        try:
            fut.set_result(fn(*args, **kw))
        except BaseException as e:          # noqa: BLE001 - the future's
            fut.set_exception(e)
        return fut

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def serial_router(client):
    """Run a striped client's fan-out (the router's per-target runs and EC
    cells) inline, one after another in submission order, so the fault
    injector's match counts follow the op order in either package. With the
    router's pool, which cell or run reaches a rule's m-th match first is a
    race in the reference itself."""
    client.io._pool = InlineExecutor()
    return client
