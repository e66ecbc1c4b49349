"""Deficit-plane formulation of the approximate multiplier (TPU-native).

Key identity: every *exact* component of the reduction tree (FA, HA, final
adder) preserves the weighted bit-sum of its column. Only approximate 4:2
compressors change it, each by exactly ``-2^c * deficit`` where

    deficit = (x1+x2+x3+x4) - table_value(x1,x2,x3,x4)     (may be negative)

Therefore, for ANY compressor design plugged into the pinned tree:

    approx(a, b) = a*b - sum_over_sites 2^{c_s} * deficit_s(a, b)

Stage-2 site inputs are true stage-1 outputs (computed under the approximate
semantics), so stage-1 compressor outputs and the cheap FA/HA bits must be
evaluated — but the final adder, cleanup and all bookkeeping vanish. This
evaluates in ~100 gather-free vector bit-ops per element (vs ~300 for the
full gate-level tree and vs a 64K-entry LUT gather). kernels/codegen.py
prints it as CUDA; the CUDA-core kernel (kernels/csrc/approx_matmul.cu)
reads it from a 129 x 129 table built from this function
(kernels/approx_matmul.correction_table).

Validated bit-exact against core.multiplier over the full 2^16 input space
(tests/test_deficit.py).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core import compressors as C
from repro_torch.core.multiplier import (MultiplierConfig, N_BITS, STAGE1_PLAN,
                                   STAGE2_COMP_COLS, _fa, _ha)


def _comp_outputs(design: str, bits):
    """(sum, carry, deficit) of an approximate 4:2 compressor.

    Works on numpy arrays, torch int tensors, and the symbolic values of
    kernels/codegen.py. Uses arithmetic (no gathers) for the
    proposed/saturating family; numpy falls back to the 16-entry table
    lookup for arbitrary designs, everything else to its minterm sum.
    """
    d = C.DESIGNS[design]
    p = d.input_perm
    x1, x2, x3, x4 = bits[p[0]], bits[p[1]], bits[p[2]], bits[p[3]]
    t = x1 + x2 + x3 + x4
    if np.array_equal(d.table, C.PROPOSED):
        # saturating sum: v = min(t, 3); deficit = [t == 4]
        fire = _as_int(t >= 4, t)
        v = t - fire
        return v & 1, (v >> 1) & 1, fire
    idx = x1 + 2 * x2 + 4 * x3 + 8 * x4
    table = d.table
    if isinstance(idx, np.ndarray):
        v = table[idx]
    else:
        # torch / symbolic path: evaluate the 16-entry truth table as a
        # minterm sum of baked-in Python ints — gather-free, so the same
        # straight-line code is what kernels/codegen.py emits for CUDA.
        v = None
        for i in range(16):
            ti = int(table[i])
            if ti == 0:
                continue
            term = _as_int(idx == i, idx) * ti
            v = term if v is None else v + term
        if v is None:
            v = idx * 0
    return v & 1, (v >> 1) & 1, t - v


def approx_product(a, b, cfg: MultiplierConfig):
    """approx(a,b) for the 'proposed' (all-approximate) structure via the
    deficit identity. `a`, `b` integer arrays in [0, 255].

    Only valid for structure == 'proposed' (design1/design2 change the tree;
    use core.multiplier for those — they are baselines, not the hot path).
    """
    if cfg.structure != "proposed":
        raise ValueError(f"the deficit identity needs structure 'proposed', "
                         f"got {cfg.structure!r}")
    return _mul_int(a, b) - deficit_sum(a, b, cfg.compressor)


def deficit_sum(a, b, design: str = "proposed"):
    """err(a, b) = a*b - approx(a, b) for UNSIGNED magnitudes in [0, 255].

    Returns the summed site deficits (non-negative for the proposed design).
    This is the quantity the Pallas kernel subtracts per k-step; it avoids
    the final product/adder entirely (~60 vector bit-ops).
    """
    ncols = 2 * N_BITS + 2
    cols: List[List] = [[] for _ in range(ncols)]
    for i in range(N_BITS):
        ai = (a >> i) & 1
        for j in range(N_BITS):
            cols[i + j].append(ai & ((b >> j) & 1))

    err = None

    def add_err(deficit, c):
        nonlocal err
        term = _sh(deficit, c)
        err = term if err is None else err + term

    mid: List[List] = [[] for _ in range(ncols)]
    for c in range(ncols - 1):
        bits = list(cols[c]) + mid[c]
        mid[c] = []
        for op in STAGE1_PLAN.get(c, ()):
            if op == "c" and len(bits) >= 4:
                s, cy, df = _comp_outputs(design, bits[:4])
                bits = bits[4:]
                add_err(df, c)
            elif op == "fa" and len(bits) >= 3:
                s, cy = _fa(*bits[:3])
                bits = bits[3:]
            elif op == "ha" and len(bits) >= 2:
                s, cy = _ha(*bits[:2])
                bits = bits[2:]
            else:
                continue
            mid[c].append(s)
            mid[c + 1].append(cy)
        mid[c] = bits + mid[c]
    for c in range(ncols - 1):
        bits = mid[c]
        if c in STAGE2_COMP_COLS and len(bits) >= 4:
            _, _, df = _comp_outputs(design, bits[:4])
            add_err(df, c)
    return err


def _as_int(cond, like):
    """0/1 integer of a comparison, in the dtype of ``like``. Torch tensors
    have no ``.astype``, so each array type is named explicitly; python
    bools become ints and symbolic comparisons already are 0/1 ints."""
    if isinstance(cond, np.ndarray):
        return cond.astype(like.dtype)
    if isinstance(cond, torch.Tensor):
        return cond.to(like.dtype)
    if isinstance(cond, (bool, np.bool_)):
        return int(cond)
    return cond


def _sh(x, c):
    if isinstance(x, np.ndarray):
        return x.astype(np.int64) << c
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32) << c
    return x << c


def _mul_int(a, b):
    if isinstance(a, np.ndarray):
        return a.astype(np.int64) * b.astype(np.int64)
    if isinstance(a, torch.Tensor):
        return a.to(torch.int32) * b.to(torch.int32)
    return a * b
