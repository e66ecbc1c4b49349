"""The card the port runs on: one NVIDIA H100 SXM, and its published
rates, from which every bound of the port is computed (``chip_smoke.py``,
``launch.dryrun``).

These are data-sheet rates at the card's full 700 W power limit (dense,
without sparsity), not measurements; a card set below that limit runs
slower under load, so a measured time is reported beside the card's
``nvidia-smi`` name and power limit.

The JAX package's ``repro.launch.mesh`` also builds device meshes
(``make_production_mesh``, ``make_serving_mesh``); the port's mesh
builders come with its sharding slice (ROADMAP.md queue A, item 20).
"""
from __future__ import annotations

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
