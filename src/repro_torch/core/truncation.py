"""Gate-level references for the MSR/truncation approximate family.

Three approximate-multiplier schemes from the literature that compete with
the paper's compressor designs in the same registry:

  msr4    Most-Significant-Run weight compression (related accelerator
          repo, akira2963753/Low-Cost-AI-Accelerator): a two's-complement
          int8 weight whose top 4 bits repeat the sign bit (a "4-bit MSR")
          is fully determined by its low 5 bits — trained int8 weight
          tensors hit that case for 98.9-99.98% of entries. The datapath
          stores every weight as a 5-bit mantissa plus a 2-bit shift:
          MSR hits decode exactly; the ~3-per-256 outliers are re-rounded
          to mantissa << shift (round-half-up, saturating), which the
          accelerator compensates with an exact side path. Activations
          stay exact: P(a, w) = a * msr4_decode_value(w).
  drum6   DRUM-style dynamic-range truncation (Hashemi et al., ICCAD'15):
          leading-one detect on each |operand|, keep the top
          ``DRUM_K = 6`` significant bits, and force the lowest kept bit
          to 1 so the truncation error is sign-balanced (unbiased) instead
          of a floor. P = sign(a)*sign(b) * d6(|a|) * d6(|b|).
  posneg  Positive/Negative asymmetric truncation in the spirit of
          Spantidi et al. (arXiv:2107.09366): products are classed by
          their sign, and each class uses a *floor* truncation with a
          different aggressiveness (k=4 significant bits for positive
          products, k=6 for negative). Floor-truncating magnitudes only
          shrinks them, so positive products are always underestimated
          and negative products overestimated — errors of opposite signed
          direction that cancel in the accumulator of a mixed-sign dot
          product rather than drifting.

Everything here is numpy on explicit bit operations — the "gate level" the
torch backends in ``repro_torch.quant.truncated`` are tested against, in
the same exhaustive-table form as ``core.multiplier`` / ``core.luts``. The signed
(256, 256) product tables use the two's-complement index convention of
``luts.signed_product_lut``: row/col ``k`` is the signed value
``k if k < 128 else k - 256``.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np

KINDS = ("msr4", "drum6", "posneg")

MSR_RUN = 4          # run length that makes an int8 weight losslessly 5-bit
MSR_MANT_BITS = 5    # signed mantissa width: values in [-16, 15]
MSR_MANT_MIN, MSR_MANT_MAX = -(1 << (MSR_MANT_BITS - 1)), (1 << (MSR_MANT_BITS - 1)) - 1
DRUM_K = 6           # significant bits kept by the drum6 backend
POSNEG_K_POS = 4     # floor-truncation width for positive products
POSNEG_K_NEG = 6     # floor-truncation width for negative products


# ---------------------------------------------------------------------------
# Bit-level primitives
# ---------------------------------------------------------------------------

def leading_one_pos(v: np.ndarray) -> np.ndarray:
    """Index of the highest set bit of ``v`` (LOD priority chain), -1 for 0.

    v: unsigned magnitudes < 256."""
    v = np.asarray(v, dtype=np.int64)
    pos = np.full(v.shape, -1, dtype=np.int64)
    for i in range(8):
        pos = np.where((v >> i) & 1 == 1, i, pos)
    return pos


def msr_run_length(v: np.ndarray) -> np.ndarray:
    """Length of the most-significant run of an int8 two's-complement
    value: how many consecutive bits, starting at the sign bit (bit 7),
    equal the sign bit. In [1, 8]; 0 and -1 (all-same bytes, the
    "zero-run" edge cases) give 8; 127 and -128 give 1."""
    v = np.asarray(v, dtype=np.int64)
    u = v & 0xFF
    # XOR against the sign-replicated byte: leading zeros of t = run length
    t = u ^ (((u >> 7) & 1) * 0xFF)
    return 7 - leading_one_pos(t)


# ---------------------------------------------------------------------------
# msr4: 5-bit mantissa + shift weight decode
# ---------------------------------------------------------------------------

def msr4_shift(v: np.ndarray) -> np.ndarray:
    """Per-value shift s = max(0, MSR_RUN - run_length): 0 for MSR hits
    (v in [-16, 15]), 1..3 for outliers."""
    return np.maximum(0, MSR_RUN - msr_run_length(v))


def msr4_mantissa(v: np.ndarray) -> np.ndarray:
    """Signed 5-bit mantissa: round-half-up arithmetic shift by
    ``msr4_shift``, saturated to [-16, 15]. Exact (= v) for MSR hits."""
    v = np.asarray(v, dtype=np.int64)
    s = msr4_shift(v)
    half = (1 << s) >> 1                     # 0 when s == 0
    m = (v + half) >> s                      # arithmetic shift: floor div
    return np.clip(m, MSR_MANT_MIN, MSR_MANT_MAX)


def msr4_decode_value(v: np.ndarray) -> np.ndarray:
    """mantissa << shift — the value the 5-bit datapath multiplies by.
    Identity on [-16, 15]; max |decode - v| is 7 (at v = 127, where the
    half-up rounding saturates)."""
    return msr4_mantissa(v) << msr4_shift(v)


@dataclasses.dataclass(frozen=True)
class MSR4Plan:
    """Encoded weight tensor: what the accelerator's weight SRAM holds.

    mantissa: int8, values in [-16, 15] (5 bits used)
    shift:    uint8, in {0, 1, 2, 3} (2 bits used)
    outlier:  bool, True where shift > 0 (the run was shorter than 4)
    raw:      the original int8 weights (kept for the exact side path)
    """
    mantissa: np.ndarray
    shift: np.ndarray
    outlier: np.ndarray
    raw: np.ndarray

    def decode(self, exact_outliers: bool = False) -> np.ndarray:
        """mantissa << shift per value; with ``exact_outliers`` the
        outlier positions are served from the exact side path instead
        (the accelerator's compensation), making decode lossless."""
        dec = (self.mantissa.astype(np.int64) << self.shift.astype(np.int64))
        if exact_outliers:
            dec = np.where(self.outlier, self.raw.astype(np.int64), dec)
        return dec

    def outlier_count(self, axis: int = -1) -> np.ndarray:
        """Outliers per row (reduced along ``axis``) — the per-row exact
        compensation budget; ~3 per 256 on trained weight tensors."""
        return self.outlier.sum(axis=axis)


def msr4_encode(w: np.ndarray) -> MSR4Plan:
    """Encode an int8 weight tensor to 5-bit mantissa + 2-bit shift."""
    w = np.asarray(w)
    if w.dtype != np.int8 and (w.min() < -128 or w.max() > 127):
        raise ValueError("msr4_encode expects int8-range weights")
    v = w.astype(np.int64)
    return MSR4Plan(mantissa=msr4_mantissa(v).astype(np.int8),
                    shift=msr4_shift(v).astype(np.uint8),
                    outlier=msr4_shift(v) > 0,
                    raw=np.asarray(w, dtype=np.int8))


# ---------------------------------------------------------------------------
# drum: dynamic-range unbiased truncation
# ---------------------------------------------------------------------------

def drum_truncate(v: np.ndarray, k: int = DRUM_K) -> np.ndarray:
    """DRUM operand approximation on unsigned magnitudes: keep the top
    ``k`` significant bits below the leading one (inclusive) and force the
    lowest kept bit to 1.

    Values with fewer than ``k`` bits pass through exactly. For
    ``L = leading_one_pos(v) >= k`` the truncation distance is
    ``t = L - (k - 1)`` and the certified envelope is
    ``|v - drum_truncate(v, k)| <= 2**t`` — i.e. 2^(L-5) at the default
    k=6 (the forced one over-shoots by at most 2^t when the dropped tail
    was all zeros, and undershoots by at most 2^t - 1 otherwise)."""
    v = np.asarray(v, dtype=np.int64)
    if not 2 <= k <= 8:
        raise ValueError(f"drum keep-width k={k} out of range [2, 8]")
    pos = leading_one_pos(v)
    t = np.maximum(0, pos - (k - 1))
    kept = ((v >> t) | 1) << t
    return np.where(pos >= k, kept, v)


def floor_truncate(v: np.ndarray, k: int) -> np.ndarray:
    """Keep the top ``k`` significant bits, zeroing the tail (floor):
    always <= v, error in [0, 2**t - 1] with t = leading_one_pos - (k-1)."""
    v = np.asarray(v, dtype=np.int64)
    pos = leading_one_pos(v)
    t = np.maximum(0, pos - (k - 1))
    return (v >> t) << t


# ---------------------------------------------------------------------------
# Signed product semantics + exhaustive tables
# ---------------------------------------------------------------------------

def _signed_vals() -> np.ndarray:
    vals = np.arange(256)
    return np.where(vals < 128, vals, vals - 256).astype(np.int64)


def msr4_product(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """P(a, w) = a * msr4_decode_value(w) — weight-only approximation."""
    return np.asarray(a, np.int64) * msr4_decode_value(w)


def drum_product(a: np.ndarray, b: np.ndarray, k: int = DRUM_K) -> np.ndarray:
    """P = sign(a)*sign(b) * drum(|a|) * drum(|b|)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    return (np.sign(a) * np.sign(b)
            * drum_truncate(np.abs(a), k) * drum_truncate(np.abs(b), k))


def posneg_product(a: np.ndarray, b: np.ndarray,
                   k_pos: int = POSNEG_K_POS,
                   k_neg: int = POSNEG_K_NEG) -> np.ndarray:
    """Sign-classed floor truncation: positive products via k_pos-bit
    floors (underestimated), negative via k_neg-bit floors
    (overestimated), zero products exact."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    s = np.sign(a) * np.sign(b)
    pos = (floor_truncate(np.abs(a), k_pos)
           * floor_truncate(np.abs(b), k_pos))
    neg = (floor_truncate(np.abs(a), k_neg)
           * floor_truncate(np.abs(b), k_neg))
    return np.where(s > 0, pos, np.where(s < 0, -neg, 0))


@lru_cache(maxsize=8)
def product_table(kind: str) -> np.ndarray:
    """(256, 256) int32 signed product table for one family member,
    indexed like ``luts.signed_product_lut`` (two's-complement bytes)."""
    if kind not in KINDS:
        raise KeyError(f"unknown truncation kind {kind!r}; one of {KINDS}")
    sval = _signed_vals()
    a = sval[:, None]
    b = sval[None, :]
    if kind == "msr4":
        out = msr4_product(a, b)
    elif kind == "drum6":
        out = drum_product(a, b, DRUM_K)
    else:
        out = posneg_product(a, b)
    return out.astype(np.int32)


@lru_cache(maxsize=8)
def error_table(kind: str) -> np.ndarray:
    """(65536,) int16 signed error (approx - exact) indexed by
    (a & 0xFF) * 256 + (b & 0xFF) — the gather layout of
    ``quant.matmul._approx_error_lut``. Max |error| over the full signed
    domain is < 2^12 for every kind, so int16 is lossless."""
    sval = _signed_vals()
    exact = sval[:, None] * sval[None, :]
    err = product_table(kind).astype(np.int64) - exact
    assert np.abs(err).max() < (1 << 15)
    return err.astype(np.int16).reshape(-1)


def table_stats(kind: str) -> Tuple[float, float]:
    """(error rate %, max |error|) over the signed 2^16 domain — quick
    summary for docs and sanity checks."""
    err = error_table(kind).astype(np.int64)
    return (float((err != 0).mean() * 100.0), float(np.abs(err).max()))
