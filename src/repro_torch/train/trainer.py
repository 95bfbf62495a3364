"""The train and serve steps, the counterparts of
`repro/train/trainer.py`: microbatched gradient accumulation, the
optional int8 gradient round trip, and the compiled steps
`jit_train_step`, `jit_prefill_step` and `jit_decode_step`.

Gradients come from autograd over `api.loss` with the params as leaf
tensors; `adamw_update` updates params and moments in place.

A compiled step is the port's counterpart of a function under `jax.jit`
on one device (`StaticStep`): its inputs live in static buffers made from
`api.input_specs(shape)`, and on the card the step is captured once into
a CUDA graph and replayed on every later call, one host call a step as an
XLA executable is. Donation (`donate_argnums`) becomes an update of those
buffers in place. On the CPU the same body runs eagerly on the same
buffers.

On a mesh (`MeshCtx.device_mesh`) the steps take the reference's
shardings: params as DTensors placed by `param_pspecs`, AdamW moments by
`zero1_pspecs` (with `cfg.zero1`), inputs by `input_pspecs` and a decode
cache by `cache_pspecs`; whatever a call is given is placed there first
(`models.params.place`: a global tensor is cut into each rank's shard
with no communication). Inside the body each rank computes on its batch
shard and on the params' local shards (`local_params`): every family
shards its compute over "model" and gathers fsdp leaves a layer at a
time (`models/`), so no param is whole on a rank. Each rank's loss is
its batch shard's, the same on every model rank, and its gradient of a
local shard is that shard's: summed over "data" already where the leaf
is sharded there (fsdp's reduce-scatter), else the rank's part. Scaled by 1/(data
ranks), the loss is summed over the data axes and each gradient reduced
into its moment's placement (a reduce-scatter where ZeRO-1 shards it);
the update all-gathers each param back into its own placement. The
metrics are replicated. A decode step reads and writes the local kv
heads (or recurrent channels) of its cache where the model shards them;
a cache sharded over "model" along its sequence (`cache_seq_shard`,
`ModelAPI.cache_seq_axis`) is gathered along "model" and its shard
written back.
StaticStep captures and replays the body on the DTensors' local
tensors, with its collectives.

`StaticStep.trace` runs a step's body once on arguments placed as a call
places them (`placed`), with no copy into buffers and no capture: under
FakeTensorMode it is the counterpart of `jax.jit(...).lower(...)`, which
the dry-run records (`launch/dryrun.py`); on real tensors it is the step
run eagerly.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.common.config import ShapeConfig, TrainConfig
from repro_torch.models.api import ModelAPI, shardings_for
from repro_torch.models.context import MeshCtx
from repro_torch.models.params import (fit_spec, local_params,
                                       param_pspecs, place, placements, spec,
                                       tree_leaves, tree_map, zero1_pspecs)
from repro_torch.models.transformer import CacheSpec
from repro_torch.train.optimizer import AdamState, adamw_update, local


# ---------------------------------------------------------------------------
# Gradient compression

def compress_int8(tree):
    """Per-leaf symmetric int8 quantization: (q, scale). torch.round
    rounds half to even, as jnp.round does."""
    def one(x):
        xf = x.float()
        scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
        return (torch.clamp(torch.round(xf / scale), -127, 127)
                .to(torch.int8), scale)
    return tree_map(one, tree)


def decompress_int8(qtree):
    return tree_map(lambda q_s: q_s[0].float() * q_s[1], qtree)


# ---------------------------------------------------------------------------
# Train step

def _microbatch(batch: Dict[str, Any], nmb: int, mctx: MeshCtx):
    """(B, ...) -> (nmb, B/nmb, ...), each microbatch over the data axes
    (on a mesh, a redistribution of the batch's DTensors), as this rank's
    local tensors. DTensor cannot split a dim sharded over more ranks than
    the new leading size divides, so where nmb is not a multiple of the
    data ways the batch is gathered whole first."""
    def one(x):
        assert x.shape[0] % nmb == 0, (x.shape, nmb)
        if isinstance(x, DTensor) and nmb % mctx.dp_size():
            x = x.redistribute(x.device_mesh,
                               [Replicate()] * x.device_mesh.ndim)
        y = x.reshape((nmb, x.shape[0] // nmb) + tuple(x.shape[1:]))
        return local(mctx.constraint(
            y, spec(None, mctx.batch_axes, *([None] * (y.dim() - 2)))))
    return {k: one(v) for k, v in batch.items()}


def _model_replicated(pl, mesh) -> list:
    """Placements `pl` on `mesh` with "model" replicated: the compute
    view's of a step's inputs, which every model rank reads whole (its
    batch shard)."""
    return [p if name != "model" else Replicate()
            for name, p in zip(mesh.mesh_dim_names, pl)]


def _compute_view(t, mctx: MeshCtx):
    """This rank's tensor of a placed input: its local shard along the
    batch axes, whole along "model" (gathered where it is sharded
    there)."""
    if not isinstance(t, DTensor):
        return t
    pl = _model_replicated(t.placements, mctx.device_mesh)
    if tuple(pl) != tuple(t.placements):
        t = t.redistribute(mctx.device_mesh, pl)
    return t.to_local()


def _placed_output(t: torch.Tensor, s, mctx: MeshCtx,
                   model_local: bool = False):
    """A rank's compute view `t` (its batch shard, whole along "model", or
    with `model_local` its shard there too) as the DTensor at spec `s`
    (fitted to the global shape)."""
    mesh = mctx.device_mesh
    pl = placements(s, mesh)
    if model_local:
        return DTensor.from_local(t, mesh, pl)
    return DTensor.from_local(t, mesh, _model_replicated(pl, mesh)
                              ).redistribute(mesh, pl)


def _mesh_sum(loss, grads, params, like, mctx: MeshCtx):
    """The mesh's loss and gradients from each rank's: every rank's part
    scaled by 1/(data ranks) (each rank's loss is its batch shard's mean,
    the same on every model rank), the loss summed over the data axes and
    each gradient of a local shard of `params` reduced into the placement
    of its moment in `like` (a sum over the data axes that do not shard
    the param; a reduce-scatter where the moments shard it)."""
    mesh = mctx.device_mesh
    if mesh is None:
        return loss, grads
    dp = mctx.dp_size()
    if dp > 1:
        loss = loss / dp
        tree_map(lambda g: g.mul_(1.0 / dp), grads)
    batch = mctx.batch_axes

    def parts(pl):
        return [Partial() if name in batch and p.is_replicate() else p
                for name, p in zip(mesh.mesh_dim_names, pl)]
    loss = DTensor.from_local(loss, mesh, parts([Replicate()] * mesh.ndim)
                              ).redistribute(mesh, [Replicate()] * mesh.ndim
                                             ).to_local()
    return loss, tree_map(
        lambda g, p, m: DTensor.from_local(g, mesh, parts(p.placements)
                                           ).redistribute(mesh, m.placements),
        grads, params, like)


def value_and_grad(api: ModelAPI, params, batch, mctx: MeshCtx):
    """(loss, grads) of `api.loss` with respect to the params, which are
    leaf tensors; grads mirror params in their dtype. A param the loss
    does not use gets zeros, as under jax.grad (a hybrid of fewer layers
    than a super-block keeps its super-blocks' stacks with 0 layers)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = api.loss(params, batch, mctx)
        flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(flat), params)


def make_train_step(api: ModelAPI, tcfg: TrainConfig, mctx: MeshCtx):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics)."""
    nmb = tcfg.num_microbatches

    def train_step(params, opt_state: AdamState, batch):
        compute = local_params(params)
        if nmb > 1:
            mbs = _microbatch(batch, nmb, mctx)
            adt = getattr(torch, tcfg.accum_dtype)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                               device=p.device), compute)
            loss_sum = None
            for i in range(nmb):
                loss, g = value_and_grad(api, compute,
                                         {k: v[i] for k, v in mbs.items()},
                                         mctx)
                tree_map(lambda a, b: a.add_(b.to(adt)), grads, g)
                loss_sum = loss if loss_sum is None else loss_sum + loss
                # a microbatch's gradients go as soon as they are added:
                # the update needs only the sum
                del g
            loss = loss_sum / nmb
            tree_map(lambda g: g.div_(nmb), grads)
        else:
            loss, grads = value_and_grad(
                api, compute, {k: _compute_view(v, mctx)
                               for k, v in batch.items()}, mctx)
        loss, grads = _mesh_sum(loss, grads, params, opt_state.m, mctx)

        if tcfg.grad_compression == "int8":
            # quantize-dequantize of the reduced gradient before the
            # optimizer, as the reference does (its int8 all-reduce is
            # only modelled there): a quantized wire would change the sums
            grads = tree_map(lambda g: g.float(),
                         decompress_int8(compress_int8(grads)))

        new_params, new_opt, metrics = adamw_update(grads, opt_state, params,
                                                    tcfg)
        metrics = dict(metrics, loss=loss)
        return new_params, new_opt, metrics

    return train_step


# ---------------------------------------------------------------------------
# Compiled steps: static buffers, captured once, replayed

BIND = "bind"   # the first call's tensors become the step's own (donated)
LIKE = "like"   # the step makes its own copies of the first call's tensors


def map_tree(fn, tree, *rest):
    """fn over the leaves (tensors, arrays, specs) of nested dicts and
    tuples of one structure; None stays None, a NamedTuple keeps its
    type."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray, CacheSpec)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        for r in rest:
            if set(r) != set(tree):
                raise ValueError(f"an input with keys {sorted(r)} where the "
                                 f"step takes {sorted(tree)}")
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    items = [map_tree(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)


def _tensors(tree) -> list:
    out = []
    map_tree(lambda t: out.append(t) if isinstance(t, torch.Tensor) else None,
             tree)
    return out


def _is_specs(tree) -> bool:
    leaves = []
    map_tree(leaves.append, tree)
    return bool(leaves) and isinstance(leaves[0], CacheSpec)


class StaticStep:
    """`body(*args)` on static buffers: the port's counterpart of a
    function under `jax.jit`, on one device.

    `buffers` names the body's arguments in order, each mapped to a tree
    of CacheSpecs, to BIND or to LIKE. For specs the step makes its own
    tensors at the first call, in the specs' shapes and the dtypes of the
    tensors given (as jax.jit specialises on its arguments' dtypes); for
    LIKE, in the shapes given too; with BIND the first call's tensors
    become the step's own (the params, and state donated to the step).
    Every later call copies what it is given into the step's tensors,
    unless it is given those very tensors, as the previous call's outputs
    are; a shape other than the buffer's raises.

    On a CUDA device the first call runs the body on a side stream, which
    warms up the libraries, the allocator and autograd and is that call's
    step (`warmup_s` times it); the body is then captured into a CUDA
    graph, and every later call is one replay, which returns the graph's
    outputs (the next replay overwrites them). A capture or a replay that
    fails raises: there is no eager fallback on the card. Steps given one
    `pool` (`torch.cuda.graph_pool_handle()`) share their graphs' memory
    and must run one at a time, as an engine's prefill and decode do. On
    the CPU the body runs eagerly on the same buffers."""

    def __init__(self, body: Callable, device, buffers: Dict[str, Any],
                 pool=None):
        self.body, self.device, self.pool = body, torch.device(device), pool
        self.buffers = dict(buffers)
        self.graph = None
        self.out = None
        self.copies = 0         # leaves copied into the buffers
        self.calls = 0          # on the card each but the first a replay
        self.capture_s = 0.0    # warm-up and capture, host wall time
        self.warmup_s = 0.0     # the warm-up alone (the body run eagerly)

    def trace(self, *args):
        """The body once on `args` as they are: no copy into the step's
        buffers, no capture, on any device."""
        if len(args) != len(self.buffers):
            raise TypeError(f"the step takes {list(self.buffers)}")
        return self.body(*args)

    def _take(self, name: str, value) -> None:
        static = self.buffers[name]
        if static is BIND:
            self.buffers[name] = value
            return
        if static is LIKE or _is_specs(static):
            def make(v, spec=None):
                if isinstance(v, DTensor):      # placed on a mesh
                    return torch.empty_like(v)
                shape = tuple(v.shape) if spec is None else spec.shape
                return torch.empty(shape, dtype=torch.as_tensor(v).dtype,
                                   device=self.device)
            static = self.buffers[name] = (
                map_tree(make, value) if static is LIKE
                else map_tree(lambda spec, v: make(v, spec), static, value))

        def copy(s, v):
            if v is s:
                return
            v = torch.as_tensor(v)
            if tuple(v.shape) != tuple(s.shape):
                raise ValueError(f"{name}: a {tuple(v.shape)} input where "
                                 f"the step's buffer is {tuple(s.shape)}")
            s.copy_(v)
            self.copies += 1
        map_tree(copy, static, value)

    def __call__(self, *args):
        if len(args) != len(self.buffers):
            raise TypeError(f"the step takes {list(self.buffers)}")
        with torch.no_grad():       # buffers take data, not gradients
            for name, value in zip(self.buffers, args):
                self._take(name, value)
        self.calls += 1
        if self.device.type != "cuda":
            return self.body(*self.buffers.values())
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        return self.out

    def _capture(self):
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.body(*self.buffers.values())
        side.synchronize()
        self.warmup_s = time.perf_counter() - t0
        main.wait_stream(side)
        for t in _tensors(out):
            local(t).record_stream(main)
        graph = torch.cuda.CUDAGraph()
        # no graph may be freed during the capture: garbage is collected
        # first and the collector waits until the capture ends (on an H100,
        # captures next to graphs left to the collector left the default
        # CUDA generator in capture mode, and the next torch.randn raised).
        # thread_local: the storage client's and the loader's threads may
        # call CUDA while this one captures
        gc.collect()
        # the warm-up's memory, cached in the default pool, handed back: the
        # graph's private pool cannot reuse it, and the allocator frees no
        # cached block while a capture is under way, so a step whose peak
        # fits the card once would not fit it twice
        torch.cuda.empty_cache()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                self.out = self.body(*self.buffers.values())
        finally:
            if collecting:
                gc.enable()
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return out


def _undonated(step: StaticStep, donated: tuple):
    """`step` returning copies of its outputs at `donated`, so that no
    buffer of the step is handed out (donate=False)."""
    def call(*args):
        out = step(*args)
        return tuple(map_tree(torch.clone, o) if i in donated else o
                     for i, o in enumerate(out))
    call.step = step
    return call


def _placing(step, placers):
    """`step` called with each argument placed on the mesh first by its
    placer (the reference's in_shardings); `.step` is the StaticStep."""
    def call(*args):
        return step(*(put(a) for put, a in zip(placers, args)))
    call.step = getattr(step, "step", step)
    call.placers = placers
    return call


def placed(step, *args) -> tuple:
    """`args` placed as a call of `step` (a jit_* step) places them before
    its body runs: on a mesh each by its placer (the reference's
    in_shardings), else as they are."""
    placers = getattr(step, "placers", None)
    if placers is None:
        return args
    return tuple(put(a) for put, a in zip(placers, args))


def same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a and b start at the same place in one storage, as equal
    `data_ptr()`s say of real tensors; fake tensors' `data_ptr()` reads 0,
    so the storages are compared themselves."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


def _placer(mctx: MeshCtx, specs):
    """A function placing a tree shaped like `specs` (fitted specs) at
    those specs' placements, worked out once."""
    mesh = mctx.device_mesh
    pls = tree_map(lambda s: None if s is None
                   else tuple(placements(s, mesh)), specs)
    return lambda tree: tree_map(
        lambda t, pl: None if t is None else place(t, mesh, pl), tree, pls)


def jit_train_step(api: ModelAPI, tcfg: TrainConfig, mctx: MeshCtx,
                   shape: ShapeConfig, donate: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), compiled on the batch buffers of `api.input_specs(shape)`.
    With `donate`, the first call's params and AdamState become the
    step's and every call updates them in place (the reference's
    donate_argnums=(0, 1)); without, the step keeps copies and returns
    copies. The returned object is the StaticStep (or, without `donate`
    or on a mesh, a function whose `.step` is). On a mesh the params,
    moments and batch are placed by `param_pspecs`, `zero1_pspecs` (with
    cfg.zero1, else the param specs) and `input_pspecs`."""
    train_step = make_train_step(api, tcfg, mctx)

    def body(params, opt_state, batch):
        params, new_opt, metrics = train_step(params, opt_state, batch)
        opt_state.step.copy_(new_opt.step)
        return params, opt_state, metrics

    held = BIND if donate else LIKE
    step = StaticStep(body, mctx.device, {
        "params": held, "opt_state": held,
        "batch": api.input_specs(shape)})
    step = step if donate else _undonated(step, (0, 1))
    mesh = mctx.device_mesh
    if mesh is None:
        return step
    defs = api.param_defs()
    p_specs = param_pspecs(defs, mesh, mctx.rules)
    z_put = _placer(mctx, zero1_pspecs(defs, mesh, mctx.rules)
                    if api.cfg.zero1 else p_specs)
    return _placing(step, (
        _placer(mctx, p_specs),
        lambda o: AdamState(o.step, z_put(o.m), z_put(o.v)),
        _placer(mctx, shardings_for(mesh, api.input_specs(shape),
                                    api.input_pspecs(mctx, shape)))))


def _mesh_io(api: ModelAPI, mctx: MeshCtx, shape: ShapeConfig):
    """On a mesh: the placer of the params, the fitted specs of the
    inputs of `shape`, of the logits and of the cache."""
    mesh = mctx.device_mesh
    B = shape.global_batch
    return (_placer(mctx, param_pspecs(api.param_defs(), mesh, mctx.rules)),
            shardings_for(mesh, api.input_specs(shape),
                          api.input_pspecs(mctx, shape)),
            fit_spec((B, api.cfg.vocab), mctx.batch_spec(None), mesh),
            shardings_for(mesh, api.cache_specs(B, shape.seq_len),
                          api.cache_pspecs(mctx)))


def jit_prefill_step(api: ModelAPI, mctx: MeshCtx, shape: ShapeConfig):
    """Returns prefill_step(params, inputs) -> (logits, cache), compiled on
    the input buffers of `api.input_specs(shape)`. On a mesh the params
    and inputs are placed as `jit_train_step` places them, and the logits
    and cache come back as DTensors, the cache placed by
    `cache_pspecs`."""
    mesh = mctx.device_mesh
    if mesh is None:
        def body(params, inputs):
            return api.prefill(params, inputs, mctx)
    else:
        put_params, in_specs, logits_spec, cache_spec = _mesh_io(
            api, mctx, shape)
        model_local = api.cache_seq_axis(mctx) is None

        def body(params, inputs):
            logits, cache = api.prefill(
                local_params(params),
                {k: _compute_view(v, mctx) for k, v in inputs.items()}, mctx)
            return (_placed_output(logits, logits_spec, mctx),
                    tree_map(lambda c, s: None if c is None
                             else _placed_output(c, s, mctx, model_local),
                             cache, cache_spec))
    step = StaticStep(body, mctx.device, {
        "params": BIND,
        "inputs": api.input_specs(shape)})
    if mesh is None:
        return step
    return _placing(step, (put_params, _placer(mctx, in_specs)))


def jit_decode_step(api: ModelAPI, mctx: MeshCtx, shape: ShapeConfig,
                    donate: bool = True):
    """Returns decode_step(params, token, pos, cache) -> (logits, cache),
    compiled on the token, position and cache buffers of
    `api.input_specs(shape)`. The cache buffer is updated in place and
    returned (the reference's donate_argnums=(3,)): a call given it makes
    no copy. Without `donate` the step returns a copy of it. On a mesh
    the cache is placed by `cache_pspecs`; each step reads and writes its
    local shards, or, where "model" shards the sequence, gathers the cache
    whole along "model" and writes its shard back."""
    specs = api.input_specs(shape)
    mesh = mctx.device_mesh
    if mesh is None:
        def body(params, token, pos, cache):
            logits, new = api.decode(params, {"token": token, "pos": pos},
                                     cache, mctx)
            map_tree(lambda c, n: None if n is c else c.copy_(n), cache, new)
            return logits, cache
    else:
        put_params, in_specs, logits_spec, cache_spec = _mesh_io(
            api, mctx, shape)
        model_local = api.cache_seq_axis(mctx) is None

        def body(params, token, pos, cache):
            # its local shards, or where "model" shards the caches'
            # sequence, its batch shard whole along "model"
            view = tree_map(lambda c: None if c is None else (
                local(c) if model_local else _compute_view(c, mctx)), cache)
            logits, new = api.decode(
                local_params(params),
                {"token": _compute_view(token, mctx),
                 "pos": _compute_view(pos, mctx)}, view, mctx)

            def write(c, v, n, s):
                if n is v and same_memory(v, local(c)):
                    return              # updated in place, c's own storage
                local(c).copy_(local(_placed_output(n, s, mctx,
                                                    model_local)))
            tree_map(lambda c, v, n, s: None if c is None
                     else write(c, v, n, s), cache, view, new, cache_spec)
            return _placed_output(logits, logits_spec, mctx), cache

    step = StaticStep(body, mctx.device, {
        "params": BIND, "token": specs["token"], "pos": specs["pos"],
        "cache": specs["cache"]})
    step = step if donate else _undonated(step, (1,))
    if mesh is None:
        return step
    return _placing(step, (put_params, *(_placer(mctx, in_specs[k])
                                          for k in ("token", "pos", "cache"))))
