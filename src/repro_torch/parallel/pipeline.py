"""GPipe-style pipeline parallelism over a 'stage' mesh axis, after the JAX
package's ``repro.parallel.pipeline``.

Each rank of the ``stage_axis`` group runs one stage: it takes its slice of
the params stacked on a leading stage dim, and the schedule runs T = M +
S - 1 ticks for M microbatches over S stages. At tick t stage s works on
microbatch t - s when there is one (stage 0 reads it from
``microbatches``, every other stage takes what the stage before it made at
tick t - 1), and the last stage keeps its outputs. The bubble is (S - 1) /
(M + S - 1) of the ticks; an idle stage computes nothing (the reference
computes and masks).

The reference hands activations on with ``ppermute`` and broadcasts the
last stage's outputs with a masked ``psum``, which would turn -0.0 into
+0.0 here. The port moves bytes only: each hand-off is an all-gather over
the stage group of which a stage keeps its predecessor's part, and the
outputs are an all-gather of which every rank keeps the last stage's. So
the result is the sequential loop's, microbatch by microbatch, bit for
bit, whenever ``fn`` gives the same bits on each rank as on one device.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import mesh_positions


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(fn: Callable, mesh, params, microbatches: torch.Tensor,
                   stage_axis: str = "stage") -> torch.Tensor:
    """``fn(stage_params, x) -> y`` of each stage in turn over every
    microbatch: ``params`` is a tensor or a tree of tensors stacked on a
    leading dim of S stages (whole on every rank), ``microbatches`` (M,
    ...) the same on every rank; ``y`` must have ``x``'s shape and dtype.
    Returns the last stage's (M, ...) outputs on every rank. Collective
    over ``mesh``'s ``stage_axis`` group; a mesh of one position runs the
    stages in turn."""
    n_micro = microbatches.shape[0]
    if mesh_positions(mesh) <= 1:
        n_stages = len(next(iter(_leaves(params))))
        outs = []
        for i in range(n_micro):
            x = microbatches[i]
            for s in range(n_stages):
                x = fn(_map(lambda p, s=s: p[s], params), x)
            outs.append(x)
        return torch.stack(outs)
    group = mesh.get_group(stage_axis)
    n_stages = dist.get_world_size(group)
    sid = mesh.get_local_rank(stage_axis)
    local = _map(lambda p: p[sid], params)
    outs = torch.zeros_like(microbatches)
    buf = None
    for t in range(n_micro + n_stages - 1):
        i = t - sid
        if 0 <= i < n_micro:
            x = microbatches[i] if sid == 0 else buf
            y = fn(local, x)
            if y.shape != x.shape or y.dtype != x.dtype:
                raise ValueError(
                    f"a stage maps {tuple(x.shape)} {x.dtype} to "
                    f"{tuple(y.shape)} {y.dtype}: the pipeline hands on "
                    "activations of one shape and dtype")
            if sid == n_stages - 1:
                outs[i] = y
        else:
            y = torch.zeros_like(microbatches[0])    # never read
        if t < n_micro + n_stages - 2:               # the last tick hands on nothing
            buf = C.all_gather_bytes(y, group)[(sid - 1) % n_stages]
    return C.all_gather_bytes(outs, group)[n_stages - 1]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
