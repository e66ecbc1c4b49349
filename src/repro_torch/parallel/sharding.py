"""Logical-axis sharding rules, after the JAX package's
``repro.parallel.sharding``.

Mesh axes, as in the JAX package:
  single-pod : ('data', 'model')
  multi-pod  : ('pod', 'data', 'model')

Parameter and cache descriptors name a logical axis per dim; a
:class:`ShardingRules` maps each name to mesh axes. Parameters are FSDP
sharded over 'data' (the 'fsdp' logical axis) and tensor-parallel over
'model' on heads / mlp / vocab / experts dims; a serving pool's slot rows
('batch') go over 'data' and its KV heads over 'model'.

A spec is a tuple with one entry per dim (trailing replicated dims
dropped, as a JAX ``PartitionSpec``): None for a replicated dim, a mesh
axis name, or a tuple of names for a dim sharded over several axes (the
major axis first). The mesh is the port's
``torch.distributed.device_mesh.DeviceMesh``, read only through its
``mesh_dim_names`` and ``shape``, so a :class:`MeshLayout` with the same
two attributes plans a mesh that no process group backs (the tests, a
1 x 1 host mesh).

The port has no GSPMD: nothing places an activation by a spec, so
:func:`constrain` is the identity, and the sharded code moves every byte
itself (``parallel.collectives``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes without ranks behind it: what the
    planning functions read of a ``DeviceMesh``."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshLayout`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_positions(mesh) -> int:
    """The number of positions (ranks) of ``mesh``; 1 for None."""
    if mesh is None:
        return 1
    n = 1
    for s in tuple(mesh.shape):
        n *= s
    return n


def entry_axes(entry: Axes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch: Axes = ("pod", "data")     # activation batch dim
    seq: Axes = None                  # activation sequence dim (SP option)
    embed: Axes = None                # activation embed dim
    heads: Axes = "model"             # attention heads (TP)
    kv_heads: Axes = "model"
    head_dim: Axes = None
    mlp: Axes = "model"               # ffn hidden (TP)
    vocab: Axes = "model"             # embedding/logits vocab (TP)
    experts: Axes = "model"           # MoE experts (EP)
    fsdp: Axes = "data"               # param sharding axis (ZeRO-3)
    layers: Axes = None               # stacked layer axis
    kv_lora: Axes = None              # MLA compressed dim
    conv_io: Axes = None              # conv in/out channels
    stage: Axes = None                # optional pipeline axis

    def axes_for(self, name: Optional[str], mesh) -> Axes:
        """The mesh axes a logical name maps to, those absent from
        ``mesh`` left out (None when none is left)."""
        if name is None:
            return None
        ax = getattr(self, name)
        if ax is None:
            return None
        names = tuple(mesh.mesh_dim_names)
        if isinstance(ax, str):
            return ax if ax in names else None
        pruned = tuple(a for a in ax if a in names)
        return pruned if pruned else None

    def spec(self, logical: Tuple[Optional[str], ...], mesh) -> Spec:
        """The spec of a tuple of logical dim names (None: a replicated
        dim). A mesh axis goes to the first dim that asks for it; later
        dims drop it."""
        used = set()
        parts = []
        for name in logical:
            tup = tuple(a for a in entry_axes(self.axes_for(name, mesh))
                        if a not in used)
            if not tup:
                parts.append(None)
                continue
            used.update(tup)
            parts.append(tup[0] if len(tup) == 1 else tup)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)


DEFAULT_RULES = ShardingRules()

# Sequence-parallel variant: activations sharded on seq between blocks.
SEQ_PARALLEL_RULES = dataclasses.replace(DEFAULT_RULES, seq="model")

# FSDP over both pod and data (ZeRO across all data-parallel replicas).
WIDE_FSDP_RULES = dataclasses.replace(DEFAULT_RULES, fsdp=("pod", "data"))


def prune_spec(shape, spec: Spec, mesh) -> Spec:
    """Drop the mesh axes that do not divide the dim they shard (that dim
    falls back to replication there), and every repeat of an axis that an
    earlier dim already took: a mesh axis shards at most one dim."""
    sizes = axis_sizes(mesh)
    used = set()
    parts = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            parts.append(None)
            continue
        keep = []
        remaining = shape[i]
        for a in entry_axes(entry):
            if a not in used and remaining % sizes[a] == 0:
                keep.append(a)
                used.add(a)
                remaining //= sizes[a]
        parts.append(tuple(keep) if len(keep) > 1 else
                     (keep[0] if keep else None))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def constrain(x, rules: ShardingRules, *logical):
    """The identity. The JAX package's ``constrain`` asks GSPMD to place
    an activation by its logical axes; the port has no compiler that
    places tensors, and its sharded code moves the bytes it needs."""
    return x


def mesh_axis_size(axis: str, mesh) -> int:
    """The size of ``axis`` on ``mesh``; 1 where there is no mesh or no
    such axis. (The JAX package reads its ambient mesh; the port passes
    the mesh.)"""
    if mesh is None:
        return 1
    return axis_sizes(mesh).get(axis, 1)


# ---------------------------------------------------------------------------
# Trees of shards
# ---------------------------------------------------------------------------

def map_specs(fn, tree, specs, *more):
    """``fn(leaf, spec, *more_leaves)`` over the tensor leaves of ``tree``
    and the spec tuples of ``specs`` (the same dicts and lists)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], specs[k], *(m[k] for m in more))
                for k in tree}
    if isinstance(tree, list):
        return [map_specs(fn, t, s, *m)
                for t, s, *m in zip(tree, specs, *more)]
    return fn(tree, specs, *more)


def position(mesh, axes) -> Tuple[int, int]:
    """This rank's combined index over ``axes`` (major first), and their
    combined size."""
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def slice_leaf(x, spec, mesh, skip_dim=None):
    """This rank's shard of the full ``x`` by ``spec`` (every sharded dim
    but ``skip_dim``): a view."""
    for d, entry in enumerate(spec):
        if entry is None or d == skip_dim:
            continue
        idx, n = position(mesh, entry_axes(entry))
        loc = x.shape[d] // n
        x = x.narrow(d, idx * loc, loc)
    return x
