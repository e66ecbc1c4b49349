"""The collectives of the port's sharded code, over the process groups of
a mesh's axes, and a launcher that runs one function in a world of
spawned ranks.

Only two operations cross ranks, the ones the JAX package's sharded code
uses:

  * ``all_gather`` moves bytes: any tensor is viewed as uint8, gathered,
    and viewed back, so the gathered operand is the original bit for bit;
  * ``all_reduce`` with SUM on int32 partial sums, which is exact in any
    order (two's-complement addition wraps the same way whatever the
    order).

Nothing adds floats across ranks. (``barrier`` moves no data: a
checkpoint written by one rank is published before any rank goes on.)

Backends. The caller names the process group's backend; nothing here
switches it. NCCL takes one rank per card. On one card several ranks share
the device over a gloo group, which runs a collective of card tensors
through host memory itself: on the H100 machine the port is checked on
(torch 2.11.0+cu128) gloo takes card tensors for both collectives, so
nothing is staged through host memory here (``chip_smoke.py``'s shard
phase probes it and fails otherwise).

``STATS`` counts the all-gathers, their bytes received and their host
seconds (the clock around the call, which returns once the bytes are in
place), for the serving engine's per-step figures.
"""
from __future__ import annotations

import collections
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import entry_axes, map_specs

STATS: collections.Counter = collections.Counter()


def all_gather_bytes(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on every rank), in group
    rank order, gathered as bytes."""
    n = dist.get_world_size(group)
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(parts, flat, group=group)
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes"] += flat.numel() * n
    STATS["calls"] += 1
    return [p.view(x.dtype).reshape(x.shape) for p in parts]


ALIGN = 16     # bytes: each tensor's offset in a coalesced buffer


def all_gather_many(xs: Sequence[torch.Tensor], group
                    ) -> List[List[torch.Tensor]]:
    """``all_gather_bytes`` of several tensors (any dtypes and shapes, the
    same on every rank) in one collective: their bytes are packed into one
    buffer, each at an ALIGN-byte offset, gathered, and unpacked. Returns,
    per tensor, every rank's copy in group rank order."""
    if len(xs) == 1:
        return [all_gather_bytes(xs[0], group)]
    sizes = [x.numel() * x.element_size() for x in xs]
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=torch.uint8, device=xs[0].device)
    for x, o, n in zip(xs, offs, sizes):
        buf[o:o + n] = x.contiguous().reshape(-1).view(torch.uint8)
    parts = all_gather_bytes(buf, group)
    return [[p[o:o + n].view(x.dtype).reshape(x.shape) for p in parts]
            for x, o, n in zip(xs, offs, sizes)]


def all_gather_dim(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """Concatenate every ``axis`` position's block of a tensor sharded
    along ``dim``, in mesh order: the inverse of taking this rank's
    block."""
    group = mesh.get_group(axis)
    if dist.get_world_size(group) == 1:
        return x
    return torch.cat(all_gather_bytes(x, group), dim=dim)


def all_reduce_int32(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum int32 partial sums over ``axis`` in place; returns ``x``."""
    if x.dtype != torch.int32:
        raise TypeError(f"all_reduce_int32 takes int32, not {x.dtype}: "
                        "the sharded code adds no floats across ranks")
    group = mesh.get_group(axis)
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def barrier(mesh) -> None:
    """Return once every rank of ``mesh`` has called it: a barrier over
    each axis group in turn. A rank past the last axis's barrier knows
    that its group there passed the one before, whose groups passed the
    one before that, and so on: every rank of the mesh has arrived."""
    for axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
        if dist.get_world_size(group) > 1:
            dist.barrier(group=group)


def agree(values: Sequence[int], mesh, what: str = "values") -> None:
    """Raise unless every rank of ``mesh`` holds the same ``values``:
    each axis group gathers them, and agreement along every axis is
    agreement over the mesh."""
    t = torch.tensor(list(values) or [0], dtype=torch.int64)
    for axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
        if dist.get_world_size(group) == 1:
            continue
        parts = all_gather_bytes(t, group)
        if any(not torch.equal(p, t) for p in parts):
            raise RuntimeError(
                f"ranks disagree on the {what} along {axis!r}: "
                f"{[p.tolist() for p in parts]}")


# ---------------------------------------------------------------------------
# Trees of shards, gathered
# ---------------------------------------------------------------------------

def _gathers(spec, skip_dim=None) -> List[Tuple[int, str]]:
    """The (dim, mesh axis) all-gathers that rebuild a leaf sharded by
    ``spec`` (every sharded dim but ``skip_dim``), in order: dims
    ascending, the minor mesh axis first within a dim, so that blocks land
    in place."""
    return [(d, ax) for d, entry in enumerate(spec)
            if entry is not None and d != skip_dim
            for ax in reversed(entry_axes(entry))]


def gather_leaves(xs, specs, mesh, skip_dim=None) -> list:
    """The inverse of ``slice_leaf`` over many leaves: all-gather each
    shard back to the full tensor along every sharded dim but
    ``skip_dim``. Byte movement, coalesced: each round packs every leaf's
    next gather over one axis into one collective."""
    xs = list(xs)
    plans = [_gathers(s, skip_dim) for s in specs]
    stage = 0
    while True:
        groups: Dict[str, List[int]] = {}
        for i, plan in enumerate(plans):
            if stage < len(plan):
                groups.setdefault(plan[stage][1], []).append(i)
        if not groups:
            return xs
        for axis in sorted(groups):
            idx = groups[axis]
            parts = all_gather_many([xs[i] for i in idx],
                                    mesh.get_group(axis))
            for i, ps in zip(idx, parts):
                xs[i] = torch.cat(ps, dim=plans[i][stage][0])
        stage += 1


def gather_tree(tree, specs, mesh, skip_dim=None):
    """``gather_leaves`` over a tree of leaves and its spec tree."""
    leaves, flat = [], []
    map_specs(lambda t, s: (leaves.append(t), flat.append(s)), tree, specs)
    it = iter(gather_leaves(leaves, flat, mesh, skip_dim))
    return map_specs(lambda t, s: next(it), tree, specs)


def gather_stack(x, mesh, axes):
    """Every position's ``x`` over ``axes``, stacked on a new leading dim
    in combined index order (major axis first)."""
    out = x[None]
    for ax in reversed(axes):
        out = torch.cat(all_gather_bytes(out, mesh.get_group(ax)))
    return out


# ---------------------------------------------------------------------------
# A world of spawned ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, init_method: str, backend: str,
               device: str, timeout_s: float, args, results) -> None:
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:                          # reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable[..., Any], world: int, args: tuple = (), *,
              backend: str = "gloo", device: str = "cpu",
              init_method: Optional[str] = None,
              timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` new processes joined in one
    process group of ``backend``, and return their results in rank order.

    The ranks fork from a fresh server process (the ``forkserver`` start
    method), which imports torch and ``fn``'s module once and never
    touches the card, so each rank starts with its own CUDA context and
    without importing torch again. ``fn`` must be importable by name from
    a module that interpreter can import, and return host objects (no
    card tensors).
    Each rank first selects card ``rank % device_count`` when ``device``
    is ``"cuda"``: several ranks share a card over gloo, while NCCL takes
    one rank per card and is refused here with more ranks than cards. The
    ranks meet at ``init_method`` (default: a file in a fresh temporary
    directory). If a rank raises or dies, or ``timeout_s`` passes, every
    rank is stopped and ``RuntimeError`` carries the first failure."""
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank per card: {world} ranks, "
                         f"{torch.cuda.device_count()} cards; use gloo to "
                         "share a card")
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(sorted({"__main__", "torch",
                                       "torch.distributed", fn.__module__}))
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = init_method or f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, init, backend, device, timeout_s, args, results))
            for r in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        failure = None
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world and failure is None:
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [(i, p.exitcode) for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and i not in out]
                    if dead:
                        failure = f"rank {dead[0][0]} exited with code " \
                                  f"{dead[0][1]}"
                    elif time.monotonic() > deadline:
                        failure = f"the ranks did not finish in {timeout_s} s"
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} raised:\n{value}"
        finally:
            for p in procs:
                p.join(timeout=30 if failure is None else 1)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]
