"""Minimal functional module system: parameter descriptors -> params.

A model is described by a tree of ``ParamDesc`` leaves (shape + logical
axes + initializer) in nested dicts and lists, as in the JAX package;
``init_params`` turns it into the same tree of tensors, with the same keys
and layouts, and ``stack`` prepends a layer axis for the stacked layer
groups of the transformer LM. ``param_specs`` / ``param_shardings`` derive
each leaf's sharding spec over a mesh from its logical axes, as the JAX
package does (``parallel.sharding``).
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


HOST_SLICE = 1 << 26     # elements of one float32 draw on the host
DEVICE_DRAW = 1 << 26    # a card draws leaves of more elements itself


def _scale(d: ParamDesc) -> float:
    if d.init == "embed":
        return 1.0 if d.scale is None else d.scale
    if d.scale is not None:
        return d.scale
    fan_in = int(np.prod(d.shape[:-1])) if len(d.shape) >= 2 else \
        max(d.shape[-1], 1)
    return fan_in ** -0.5


def _row_chunks(shape, limit: int):
    """Leading-axis ranges of at most ``limit`` elements each (one row at
    least)."""
    rows = max(1, limit // max(int(np.prod(shape[1:])), 1))
    return [(r, min(r + rows, shape[0])) for r in range(0, shape[0], rows)]


def _init_one(d: ParamDesc, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """One leaf, drawn on the host in float32, cast and moved. A leaf over
    HOST_SLICE elements is drawn slice by slice along its leading axis,
    which bounds the host's float32 copy and gives the numbers of one
    draw when each row holds a multiple of 16 elements (the CPU generator
    fills normals in blocks of 16); other shapes are drawn whole."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    scale = _scale(d)
    if int(np.prod(d.shape)) <= HOST_SLICE or len(d.shape) < 2 \
            or int(np.prod(d.shape[1:])) % 16:
        return (torch.randn(d.shape, generator=generator, dtype=torch.float32)
                * scale).to(d.dtype).to(device)
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    for r0, r1 in _row_chunks(d.shape, HOST_SLICE):
        out[r0:r1] = (torch.randn((r1 - r0, *d.shape[1:]),
                                  generator=generator, dtype=torch.float32)
                      * scale).to(d.dtype)
    return out


def _slices(shape, limit: int) -> list:
    """Index tuples of the slices of a ``shape`` leaf of at most ``limit``
    elements each: leading-axis ranges (``_row_chunks``), and where one
    leading row alone holds more, that row sliced along the next axes the
    same way (a (1, 384, 7168, 2048) expert stack of one layer is 5.6 B
    elements)."""
    if len(shape) < 2 or int(np.prod(shape[1:])) <= limit:
        return [(slice(r0, r1),) for r0, r1 in _row_chunks(shape, limit)]
    return [(slice(r, r + 1),) + inner for r in range(shape[0])
            for inner in _slices(shape[1:], limit)]


def _init_on_device(d: ParamDesc, generator: torch.Generator,
                    device: torch.device, limit: int) -> torch.Tensor:
    """One leaf drawn on ``device`` from a generator of its own, seeded by
    one draw of the host ``generator``, slice by slice (``_slices``:
    float32 slices of at most ``limit`` elements)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = _scale(d)
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    for idx in _slices(d.shape, limit):
        part = out[idx]
        out[idx] = (torch.randn(part.shape, generator=gen,
                                dtype=torch.float32, device=device)
                    * scale).to(d.dtype)
    return out


def init_params(tree, generator: torch.Generator, device="cuda"):
    """Initialize a descriptor tree: normal * fan_in^-1/2 by default, drawn
    from ``generator`` on the CPU in a fixed leaf order, then moved to
    ``device``. (The numbers differ from the JAX package's, whose RNG is
    another; parity tests pass the reference's params through numpy.)

    On a CUDA device, a random leaf of more than DEVICE_DRAW elements is
    drawn there instead (``_init_on_device``), as models of tens of
    billions of parameters need: the host's generator is serial (some
    170 M normals a second). Such a leaf's numbers come from the device's
    generator; no leaf of smollm-135m or of a reduced config is that
    large."""
    dev = resolve_device(device)

    def one(d: ParamDesc) -> torch.Tensor:
        if dev.type == "cuda" and d.init in ("normal", "embed") \
                and int(np.prod(d.shape)) > DEVICE_DRAW:
            return _init_on_device(d, generator, dev, DEVICE_DRAW)
        return _init_one(d, generator, dev)

    return tree_map(one, tree)


def stack(tree, n: int, logical: str = "layers"):
    """Prepend a stacked dim of size n (the layer axis of a group of
    identical layers). As in the JAX package, ``init_params`` then takes
    the fan-in over every dim but the last, the stacked one included, so a
    stacked (L, d, f) weight draws at scale (L * d) ** -0.5."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, logical=(logical,) + d.logical), tree)


def param_specs(tree, rules, mesh):
    """Each leaf's spec over ``mesh`` by ``rules`` (``ShardingRules``),
    from its logical axes: the JAX package's ``param_specs``."""
    return tree_map(lambda d: rules.spec(d.logical, mesh), tree)


def param_shardings(tree, rules, mesh):
    """Each leaf's storage spec over ``mesh``: its ``param_specs`` entry
    with the axes that do not divide their dim dropped (``prune_spec``).
    The JAX package's ``param_shardings`` wraps the unpruned spec in a
    ``NamedSharding`` and its serving engine prunes it; the port has no
    sharding object, and its engine stores each leaf by this spec."""
    from repro_torch.parallel.sharding import prune_spec
    return tree_map(lambda d: prune_spec(d.shape, rules.spec(d.logical,
                                                             mesh), mesh),
                    tree)


def n_params(tree) -> int:
    return int(sum(np.prod(d.shape) for d in _leaves(tree)))

