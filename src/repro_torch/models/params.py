"""Parameter definitions and their tensors.

Models declare parameters as nested dicts of `ParamDef(shape, axes, init)`
where `axes` are logical axis names, as in the reference
(`repro/models/params.py`). Params are nested dicts of tensors with the
reference's key paths and shapes, the stacked layer axis first.

The sharding rules (`DEFAULT_RULES`, the pspec functions) wait for the
multi-device slice; on one card `axes` are carried but not read.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Axes = Tuple[Optional[str], ...]


@dataclass
class ParamDef:
    shape: Tuple[int, ...]
    axes: Axes                       # logical axis name per dim (None = replicated)
    init: str = "normal"             # normal | zeros | ones | embed
    scale: Optional[float] = None    # overrides fan-in scaling


def pdef(shape: Sequence[int], axes: Sequence[Optional[str]], init: str = "normal",
         scale: Optional[float] = None) -> ParamDef:
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return ParamDef(shape, axes, init, scale)


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in sorted key order, the order jax.tree uses."""
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _leaves(node, prefix + (key,))
        else:
            yield prefix + (key,), node


def tree_leaves(tree: Dict[str, Any]):
    """The leaves of a nested dict in sorted key order (jax.tree's)."""
    return [leaf for _, leaf in _leaves(tree)]


def tree_map(fn, *trees: Dict[str, Any]) -> Dict[str, Any]:
    """fn over the leaves of nested dicts of one structure, keys in sorted
    order, as jax.tree.map walks them."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(first)}
    return fn(*trees)


def _init_leaf(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    if d.init == "embed":
        return x.mul_(0.02).to(dtype)
    # fan-in scaled normal over the last-but-one dim (input dim)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return x.mul_(scale).to(dtype)


def init_params(defs: Dict[str, Any], generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Materialise a ParamDef tree into tensors on `device` (the CUDA card
    unless the caller asks for the CPU), leaf by leaf in sorted key order
    from `generator`, which must live on that device.

    The distributions are the reference's (fan-in normal, embed 0.02,
    ones, zeros), but the values are not: a torch.Generator does not give
    jax.random's numbers. To run both packages on the same weights, make
    them with the reference and carry them across with
    `params_from_numpy`."""
    device = resolve_device(device)
    out: Dict[str, Any] = {}
    for path, d in _leaves(defs):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _init_leaf(d, generator, dtype, device)
    return out


def count_params(defs: Dict[str, Any]) -> int:
    return sum(int(np.prod(d.shape)) for _, d in _leaves(defs))


def _from_numpy(a, device: torch.device,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes: torch refuses it
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The reference's params, as a nested dict of numpy arrays with its
    key paths (stacked layer axis first), as the port's tensors on
    `device`, cast to `dtype` if given. bfloat16 leaves arrive as
    ml_dtypes arrays and cross through a uint16 view."""
    device = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a, device, dtype), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                      # what the reference's arrays use
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The reverse of `params_from_numpy`: numpy arrays on the host, with
    bfloat16 leaves as ml_dtypes arrays."""
    return tree_map(_to_numpy, params)
