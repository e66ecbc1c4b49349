"""Configurable 8×8 unsigned approximate multiplier (gate-level, vectorized).

Implements the three multiplier structures of paper Fig. 2 on a pinned
Dadda-style reduction tree (recovered by matching paper Table 2 — see
EXPERIMENTS.md §Repro-validation):

  Stage 1 (8 → 4 rows):   c4: HA | c5: C | c6: C+HA | c7: C,C | c8: C+FA
                          c9: C+HA | c10: C | c11: HA
  Stage 2 (4 → 2 rows):   4:2 compressors at columns 3..10, exact FA/HA
                          cleanup elsewhere
  Final:                  exact two-row carry-propagate addition

Structures:
  - ``proposed`` (Fig. 2c): every 4:2 compressor is approximate (no Cin/Cout
    anywhere — the carry chain is fully broken).
  - ``design1``  (Fig. 2a, [12,17,19]): columns >= ``approx_below`` use exact
    (chained) 4:2 compressors, lower columns use the approximate design.
  - ``design2``  (Fig. 2b, [13,15]): partial products in the ``truncate_cols``
    least-significant columns are dropped and replaced by a constant
    compensation bit; all compressors approximate.

With the ``proposed`` compressor this tree reproduces paper Table 2 to all
printed digits on NMED (0.046 %) and MRED (0.109 %); ER is 6.940 % vs the
paper's 6.994 % (Δ = 0.054 pp ≈ 35/65536 input pairs — an unrecoverable
micro-detail of the paper's dot diagram; all other rows track, see
benchmarks/table2_error_metrics.py).

Everything is vectorized: bit variables are integer arrays, one call
evaluates the multiplier over arbitrary operand batches (e.g. the full 2^16
input space at once). Works with numpy arrays or torch int tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import compressors as C

N_BITS = 8

# Pinned stage-1 plan: column -> ops ('c' = 4:2 compressor, 'fa', 'ha').
STAGE1_PLAN: Dict[int, Tuple[str, ...]] = {
    4: ("ha",), 5: ("c",), 6: ("c", "ha"), 7: ("c", "c"),
    8: ("c", "fa"), 9: ("c", "ha"), 10: ("c",), 11: ("ha",),
}
# Pinned stage-2 compressor columns.
STAGE2_COMP_COLS: Tuple[int, ...] = tuple(range(3, 11))


@dataclasses.dataclass(frozen=True)
class MultiplierConfig:
    """Structure + compressor selection for an 8x8 unsigned multiplier."""
    name: str
    compressor: str = "proposed"      # design name from compressors.DESIGNS
    structure: str = "proposed"       # 'proposed' | 'design1' | 'design2' | 'exact'
    approx_below: int = 8             # design1: approx comps in cols < this
    truncate_cols: int = 4            # design2: drop pp bits in cols < this
    design2_comp: int = 0             # design2: compensation constant

    @property
    def key(self) -> str:
        return (f"{self.structure}:{self.compressor}:{self.approx_below}:"
                f"{self.truncate_cols}:{self.design2_comp}")


def _fa(x, y, z):
    return x ^ y ^ z, (x & y) | (x & z) | (y & z)


def _ha(x, y):
    return x ^ y, x & y


class _Tree:
    """One evaluation of the reduction tree over array-valued bits."""

    def __init__(self, cfg: MultiplierConfig):
        self.cfg = cfg
        self.perm = C.DESIGNS[cfg.compressor].input_perm

    def _is_exact(self, col: int) -> bool:
        cfg = self.cfg
        return (cfg.structure == "exact"
                or (cfg.structure == "design1" and col >= cfg.approx_below))

    def _comp(self, bits, col, pend):
        """4:2 compressor at `col`. `pend` is a dict col -> list of couts
        generated by exact compressors earlier in this stage."""
        if self._is_exact(col):
            # exact 4:2 = two chained FAs; consume one cin from pend[col].
            cin = pend[col].pop() if pend.get(col) else bits[0] * 0
            s1, cout = _fa(bits[0], bits[1], bits[2])
            s, carry = _fa(s1, bits[3], cin)
            pend.setdefault(col + 1, []).append(cout)
            return s, carry
        p = self.perm
        b = (bits[p[0]], bits[p[1]], bits[p[2]], bits[p[3]])
        s, carry = C.compress(self.cfg.compressor, *b)
        return s, carry

    def run(self, a, b):
        cfg = self.cfg
        ncols = 2 * N_BITS + 2
        cols: List[List] = [[] for _ in range(ncols)]
        for i in range(N_BITS):
            ai = (a >> i) & 1
            for j in range(N_BITS):
                cols[i + j].append(ai & ((b >> j) & 1))

        if cfg.structure == "design2":
            for c in range(min(cfg.truncate_cols, ncols)):
                cols[c] = []
            # constant compensation (binary bits appended as ones)
            ones = ((a >> 0) & 1) * 0 + 1
            for c in range(ncols):
                if (cfg.design2_comp >> c) & 1:
                    cols[c].append(ones)

        # ---- stage 1 ----
        mid: List[List] = [[] for _ in range(ncols)]
        pend: Dict[int, List] = {}
        for c in range(ncols - 1):
            bits = list(cols[c]) + mid[c]
            mid[c] = []
            for op in STAGE1_PLAN.get(c, ()):  # plan ops consume from head
                if op == "c" and len(bits) >= 4:
                    s, cy = self._comp(bits[:4], c, pend)
                    bits = bits[4:]
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
            # any cout not consumed by a compressor at this column spills
            mid[c].extend(pend.pop(c, []))
            mid[c] = bits + mid[c]

        # ---- stage 2 ----
        out: List[List] = [[] for _ in range(ncols + 1)]
        pend = {}
        for c in range(ncols - 1):
            bits = list(mid[c])
            if c in STAGE2_COMP_COLS and len(bits) >= 4:
                s, cy = self._comp(bits[:4], c, pend)
                bits = bits[4:]
                out[c].append(s)
                out[c + 1].append(cy)
            out[c].extend(pend.pop(c, []))
            out[c] = bits + out[c]

        # ---- exact cleanup to <= 2 rows, then final exact addition ----
        for c in range(len(out)):
            while len(out[c]) > 2:
                s, cy = _fa(*out[c][:3])
                out[c] = out[c][3:] + [s]
                if c + 1 < len(out):
                    out[c + 1].append(cy)
        total = None
        for c, bits in enumerate(out):
            for bit in bits:
                term = _lshift(bit, c)
                total = term if total is None else total + term
        return total


def _lshift(bit, c):
    if isinstance(bit, np.ndarray):
        return bit.astype(np.int64) << c
    if isinstance(bit, torch.Tensor):
        return bit.to(torch.int32) << c
    return bit << c  # python int


def multiply(a, b, cfg: MultiplierConfig):
    """Gate-level approximate product of uint8 arrays ``a``, ``b``."""
    return _Tree(cfg).run(a, b)


# ---------------------------------------------------------------------------
# Canonical configs
# ---------------------------------------------------------------------------

def proposed_multiplier(compressor: str = "proposed") -> MultiplierConfig:
    return MultiplierConfig(name=f"proposed[{compressor}]",
                            compressor=compressor, structure="proposed")


def design1_multiplier(compressor: str) -> MultiplierConfig:
    return MultiplierConfig(name=f"design1[{compressor}]",
                            compressor=compressor, structure="design1")


def design2_multiplier(compressor: str) -> MultiplierConfig:
    return MultiplierConfig(name=f"design2[{compressor}]",
                            compressor=compressor, structure="design2")


def exact_multiplier() -> MultiplierConfig:
    return MultiplierConfig(name="exact", compressor="proposed",
                            structure="exact")


def exhaustive_products(cfg: MultiplierConfig) -> np.ndarray:
    """(256, 256) int64 table: approx product for every (a, b) pair."""
    a = np.arange(256, dtype=np.int64)[:, None] + np.zeros((1, 256), np.int64)
    b = np.arange(256, dtype=np.int64)[None, :] + np.zeros((256, 1), np.int64)
    return multiply(a, b, cfg)
