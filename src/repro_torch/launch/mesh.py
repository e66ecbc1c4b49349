"""The card the port runs on (one NVIDIA H100 SXM) and its published
rates, from which every bound of the port is computed (``chip_smoke.py``,
``launch.dryrun``), and the device meshes of its sharded serving, after
the JAX package's ``repro.launch.mesh``.

The rates are data-sheet rates at the card's full 700 W power limit (dense,
without sparsity), not measurements; a card set below that limit runs
slower under load, so a measured time is reported beside the card's
``nvidia-smi`` name and power limit.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with one rank per
position and the JAX mesh's axis names (``"data"``, ``"model"``), built
over the ranks of an initialised process group (``init_distributed``
joins the one ``torch.distributed.run`` describes, with the backend the
caller names). ``make_host_mesh`` is the 1 x 1 mesh of a single process,
a ``MeshLayout`` that no process group backs: a mesh of one position
serves, multiplies and trains unsharded. ``make_production_mesh`` builds
the JAX package's production shapes, (16, 16) ('data', 'model') and (2,
16, 16) ('pod', 'data', 'model'), over a world of 256 or 512 ranks;
``production_layout`` plans them without ranks (the dry-run's per-rank
state, ``launch.dryrun --mesh``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import MeshLayout, mesh_positions

# Device memory: 80 GB of HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
DEVICE_MEMORY_BYTES = 80 * 2 ** 30

# Tensor cores: int8 products (TOP/s; the approximate backends' K1-K4
# launches run int8 codes) and bf16 products with float32 accumulation
# (FLOP/s; the fastest rate of the card for the port's float products,
# whose bf16 operands multiply exactly in float32, so a bound over it stays
# a lower bound).
INT8_TC_OPS_PER_S = 1979e12
BF16_TC_FLOPS_PER_S = 989e12

# The data sheet gives no rate for 32-bit integer work on the CUDA cores.
# Each SM has 64 INT32 lanes, but IMAD issues on the FP32 pipe, so integer
# work is capped only by issue: 4 schedulers x 32 lanes per clock per SM.
# 132 SMs x 128 lanes x 1.98 GHz (the boost clock behind the data sheet's
# 67 TFLOP/s float32) = 33.5 T operations/s, which keeps the bound a lower
# bound.
INT_ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
# Shared memory answers 32 lanes (one 4-byte bank each) per clock per SM:
# at most one table lookup per lane per clock, at the same clock.
LDS_LOOKUPS_PER_S = 132 * 32 * 1.98e9


def compute_s(flops: float, flops_int8: float = 0.0) -> float:
    """Least seconds of ``flops`` products on the card, of which
    ``flops_int8`` run on int8 codes and the rest on float operands."""
    return ((flops - flops_int8) / BF16_TC_FLOPS_PER_S
            + flops_int8 / INT8_TC_OPS_PER_S)


def bound_ms(flops: float, flops_int8: float, nbytes: float) -> float:
    """The least time of a step: the larger of its products over the
    tensor cores' rates and its bytes over the memory rate."""
    return 1e3 * max(compute_s(flops, flops_int8), nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend: str, device_type: str = "cuda") -> tuple:
    """Join the process group that ``python -m torch.distributed.run``
    describes in the environment, over ``backend`` (``"nccl"`` or
    ``"gloo"``: the caller's choice, never switched here); returns (rank,
    world size).

    On the card each rank first selects card ``LOCAL_RANK % cards``. NCCL
    takes one rank per card, so more local ranks than cards raise
    ``ValueError`` (gloo lets several ranks share one card). Outside
    ``torch.distributed.run`` this raises ``RuntimeError``: nothing falls
    back to serving unsharded."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing and not dist.is_initialized():
        raise RuntimeError(
            "no process group to join (" + ", ".join(missing) + " unset): "
            "run under python -m torch.distributed.run --standalone "
            "--nproc-per-node N ...")
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass "
                               "device_type='cpu' (and gloo) on the CPU")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        if backend == "nccl" and local_world > cards:
            raise ValueError(
                f"NCCL takes one rank per card: {local_world} local ranks, "
                f"{cards} cards; use gloo to share a card")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % cards)
    elif backend == "nccl":
        raise ValueError("NCCL needs the card: use gloo on the CPU")
    if not dist.is_initialized():
        dist.init_process_group(backend)
    return dist.get_rank(), dist.get_world_size()


def serving_shape(n: int) -> tuple:
    """The JAX package's factorization of ``n`` ranks into (data, model):
    as even as it goes, the larger factor on 'model'."""
    d = 1
    for cand in range(int(n ** 0.5), 0, -1):
        if n % cand == 0:
            d = cand
            break
    return (d, n // d)


def make_serving_mesh(shape=None, axis_names=("data", "model"),
                      device_type: str = "cuda"):
    """A ``DeviceMesh`` over the ranks of the initialised process group:
    ``shape`` pins the factorization (its product must not exceed the
    world size; the first ranks take part), by default the whole world by
    ``serving_shape``. Every rank of the world calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialised process "
                           "group (init_distributed)")
    n = dist.get_world_size()
    if shape is None:
        if len(axis_names) != 2:
            raise ValueError("pass an explicit shape for non-2D meshes")
        shape = serving_shape(n)
    shape = tuple(int(s) for s in shape)
    total = 1
    for s in shape:
        total *= s
    if total > n:
        raise ValueError(f"mesh shape {shape} needs {total} ranks, have {n}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(total).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def join_mesh(axes: str, backend, device_type: str = "cuda"):
    """The mesh that a CLI's ``--mesh AXES`` (e.g. "data,model") names over
    the ranks of ``python -m torch.distributed.run``: the process group
    joined over ``backend`` (``init_distributed``), then the whole world by
    ``serving_shape``. Exits with an error message where there is no
    backend or no process group to join."""
    if backend is None:
        raise SystemExit("--mesh needs --dist-backend nccl|gloo")
    try:
        init_distributed(backend, device_type)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--mesh: {e}") from None
    return make_serving_mesh(None, tuple(axes.split(",")), device_type)


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def production_layout(multi_pod: bool = False) -> MeshLayout:
    """The JAX package's production mesh, (16, 16) ('data', 'model') or
    with ``multi_pod`` (2, 16, 16) ('pod', 'data', 'model'), as a layout
    without ranks."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return MeshLayout(axes, shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh (``production_layout``) as a ``DeviceMesh`` over
    the initialised world, which must have exactly its 256 (or 512) ranks:
    any other world raises ``ValueError`` naming its size. Every rank
    calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised "
                           "process group (init_distributed)")
    layout = production_layout(multi_pod)
    want, n = mesh_positions(layout), dist.get_world_size()
    if n != want:
        raise ValueError(
            f"the production mesh {layout.shape} {layout.mesh_dim_names} "
            f"takes a world of {want} ranks; this world has {n}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(n).reshape(layout.shape),
                      mesh_dim_names=layout.mesh_dim_names)


def make_host_mesh() -> MeshLayout:
    """The degenerate 1 x 1 ('data', 'model') mesh of one process."""
    return MeshLayout(("data", "model"), (1, 1))
