"""Minimal functional module system: parameter descriptors -> params.

A model is described by a tree of ``ParamDesc`` leaves (shape + logical
axes + initializer) in nested dicts and lists, as in the JAX package;
``init_params`` turns it into the same tree of tensors, with the same keys
and layouts, and ``stack`` prepends a layer axis for the stacked layer
groups of the transformer LM. (The JAX package also derives sharding specs
from the descriptors; that belongs to the port's sharding slice.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asks
    for another. A CUDA device on a machine without one raises; nothing
    falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]          # logical axis name per dim
    init: str = "normal"                         # normal|zeros|ones|embed
    scale: Optional[float] = None                # None -> fan-in scaling
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def tree_map(fn, tree):
    """``fn`` over every ``ParamDesc`` leaf of a tree of dicts and lists, in
    insertion order; the result has the tree's structure."""
    if isinstance(tree, ParamDesc):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"not a descriptor tree node: {type(tree).__name__}")


def _leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _init_one(d: ParamDesc, generator: torch.Generator) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype)
    scale = d.scale
    if scale is None:
        fan_in = int(np.prod(d.shape[:-1])) if len(d.shape) >= 2 else \
            max(d.shape[-1], 1)
        scale = fan_in ** -0.5
    if d.init == "embed":
        scale = 1.0 if d.scale is None else d.scale
    return (torch.randn(d.shape, generator=generator, dtype=torch.float32)
            * scale).to(d.dtype)


def init_params(tree, generator: torch.Generator, device="cuda"):
    """Initialize a descriptor tree: normal * fan_in^-1/2 by default, drawn
    from ``generator`` on the CPU in a fixed leaf order, then moved to
    ``device``. (The numbers differ from the JAX package's, whose RNG is
    another; parity tests pass the reference's params through numpy.)"""
    dev = resolve_device(device)
    return tree_map(lambda d: _init_one(d, generator).to(dev), tree)


def stack(tree, n: int, logical: str = "layers"):
    """Prepend a stacked dim of size n (the layer axis of a group of
    identical layers). As in the JAX package, ``init_params`` then takes
    the fan-in over every dim but the last, the stacked one included, so a
    stacked (L, d, f) weight draws at scale (L * d) ** -0.5."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, logical=(logical,) + d.logical), tree)


def n_params(tree) -> int:
    return int(sum(np.prod(d.shape) for d in _leaves(tree)))

