"""Error metrics for approximate arithmetic (paper §4.1, Eq. 4-7)."""
from __future__ import annotations

import dataclasses

import numpy as np

MAX_PRODUCT = 255 * 255  # normalization for NMED of an 8x8 multiplier
# normalization for NMED over the signed int8 operand domain the quantized
# backends actually see (|a|, |b| <= QMAX = 127)
MAX_PRODUCT_SIGNED = 127 * 127


@dataclasses.dataclass(frozen=True)
class ErrorMetrics:
    er_pct: float      # Error Rate, % of inputs with any deviation (Eq. 5)
    med: float         # Mean Error Distance
    nmed_pct: float    # MED / max product, % (paper Table 2 convention)
    mred_pct: float    # Mean Relative Error Distance, % (Eq. 7)
    max_ed: int

    def row(self) -> str:
        return (f"ER={self.er_pct:.3f}%  NMED={self.nmed_pct:.3f}%  "
                f"MRED={self.mred_pct:.3f}%  MED={self.med:.3f}  "
                f"maxED={self.max_ed}")

    def to_dict(self) -> dict:
        """JSON-ready flat dict (repro.eval artifact rows)."""
        return dataclasses.asdict(self)


def evaluate(approx: np.ndarray, exact: np.ndarray) -> ErrorMetrics:
    """Compute ER/NMED/MRED over paired approx/exact outputs.

    RED for exact==0 cases is defined as 0 (approx is also 0 there for any
    multiplier that zeroes on zero operands; asserted by tests).
    """
    approx = np.asarray(approx, dtype=np.int64)
    exact = np.asarray(exact, dtype=np.int64)
    ed = np.abs(approx - exact)
    n = ed.size
    er = (ed != 0).sum() / n * 100.0
    med = ed.mean()
    nmed = med / MAX_PRODUCT * 100.0
    nz = exact != 0
    red = np.zeros(ed.shape, dtype=np.float64)
    red[nz] = ed[nz] / exact[nz]
    mred = red.mean() * 100.0
    return ErrorMetrics(er_pct=float(er), med=float(med),
                        nmed_pct=float(nmed), mred_pct=float(mred),
                        max_ed=int(ed.max()))


def evaluate_signed(approx: np.ndarray, exact: np.ndarray,
                    max_product: int = MAX_PRODUCT_SIGNED) -> ErrorMetrics:
    """ER/NMED/MRED over a SIGNED product domain.

    `evaluate` divides RED by the raw exact value — correct on the
    unsigned 8x8 table, sign-flipping on signed products. Here the error
    distance is normalized by |exact| and NMED by ``max_product`` (the
    signed operand domain's max |product|, 127^2 by default)."""
    approx = np.asarray(approx, dtype=np.int64)
    exact = np.asarray(exact, dtype=np.int64)
    ed = np.abs(approx - exact)
    n = ed.size
    er = (ed != 0).sum() / n * 100.0
    med = ed.mean()
    nmed = med / max_product * 100.0
    nz = exact != 0
    red = np.zeros(ed.shape, dtype=np.float64)
    red[nz] = ed[nz] / np.abs(exact[nz])
    mred = red.mean() * 100.0
    return ErrorMetrics(er_pct=float(er), med=float(med),
                        nmed_pct=float(nmed), mred_pct=float(mred),
                        max_ed=int(ed.max()))


def exhaustive_exact() -> np.ndarray:
    a = np.arange(256, dtype=np.int64)
    return a[:, None] * a[None, :]


def exhaustive_exact_signed() -> np.ndarray:
    """(256, 256) exact signed products in the two's-complement index
    convention of `luts.signed_product_lut` (row/col k is the value
    ``k if k < 128 else k - 256``)."""
    a = np.arange(256, dtype=np.int64)
    s = np.where(a < 128, a, a - 256)
    return s[:, None] * s[None, :]
