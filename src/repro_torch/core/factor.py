"""Exact rank factorization of approximate-multiplier error tables.

The deficit identity (core/deficit.py) writes the paper's multiplier as

    approx(a, b) = a*b - E[a, b],      E[a, b] = sum_sites 2^{c_s} * deficit_s

Element-wise evaluation of E inside a matmul costs O(M*K*N) vector bit-ops
(the deficit planes).  This module removes the element-wise work entirely by
factoring the 256x256 integer error table E exactly as

    E[a, b] = sum_s U[a, s] * V[s, b]            (bit-exact, integer)

so the matmul-level correction becomes dense linear algebra:

    sum_k E[|x[m,k]|, |w[k,n]|] * sx * sw
        = sum_s ( U[|x|, s]*sx ) @ ( V[s, |w|]*sw )      -- R matmuls,
                                                            MXU-shaped.

Two exact mechanisms produce the factors:

1. **Stage-1 separability** (`stage1_terms`). A stage-1 compressor site at
   column c consumes four raw partial-product bits ``x_t = a_{ra+t} *
   b_{c-ra-t}``.  Its deficit is a pseudo-Boolean function of idempotent
   bits, so its multilinear (Mobius) expansion has *integer* coefficients
   and every monomial ``prod_{t in S} x_t`` factors exactly as

       (AND of the a-bits in S) * (AND of the b-bits in S)

   — a rank-1 term per monomial.  For the proposed (saturating) compressor
   the deficit is ``[x1+x2+x3+x4 == 4]`` = the single monomial
   ``x1*x2*x3*x4``: one rank-1 term per site, seven for the pinned tree.

2. **Skeleton of the residual** (`factorize`).  Stage-2 site inputs are
   stage-1 *outputs*, so their deficits do not split per-site; instead the
   residual table ``E - stage1`` is decomposed by the same zeta/Mobius pair
   applied to whole rows: with Z[a, S] = [S subseteq bits(a)] (unit lower
   triangular in the subset order, i.e. a pivoted-LU with unimodular
   factors) and F = Z^{-1} E, dropping the zero rows of F gives

       E = Z[:, nz] @ F[nz, :]

   with U = Z[:, nz] in {0,1} and V = F[nz, :] integer — an exact integer
   skeleton (CUR with indicator columns), no rational pivots, validated
   bit-exact over the full operand space.  Stage-1 monomials merge into the
   same row basis, so the runtime factor count R equals the number of
   distinct a-bit subsets supporting E.

Domains.  Runtime operands are signed int8: |v| <= 128 (bit 7 set only for
v = -128), so the factorization is built over magnitudes 0..128 — which
*kills* every stage-1 site whose 4-bit window touches bit 7 and shrinks R
by ~3x versus the full unsigned domain (exact rank 43 vs 128 for the
proposed design).  `factorize(design, domain="full")` covers all 2^16
unsigned pairs for validation and the rank report.

Float-exact evaluation.  U entries are 0/+-1 and |V| <= a few thousand, so
the correction GEMM can run in float32 — the fastest dense path on CPU —
and stay bit-exact as long as every partial sum is an integer below 2^24.
`k_exact_f32` is the largest K for which that bound holds; longer
contractions are split into K-chunks and accumulated in int32
(quant/matmul.py).  The Pallas kernel instead splits V into base-128 int8
digit planes (`v_digit_planes`) so every correction dot is an int8 MXU
matmul (kernels/approx_matmul.py).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np

from repro_torch.core import compressors as C
from repro_torch.core import luts
from repro_torch.core.multiplier import MultiplierConfig, N_BITS

# f32 has 24 mantissa bits: integers with |v| < 2^24 are exact, and so is
# every FMA whose inputs and result stay under the bound.
_F32_EXACT = 1 << 24

# Base of the int8 digit planes used by the Pallas kernel (digits are
# balanced into [-64, 63] so they always fit int8).
DIGIT_BASE = 128


@dataclasses.dataclass(frozen=True)
class Stage1Term:
    """One rank-1 monomial of a stage-1 site's deficit expansion.

    Contributes ``coeff * 2^col * AND(a bits of a_mask) * AND(b bits of
    b_mask)`` to the error table E."""
    col: int
    a_mask: int          # bit mask over the a operand
    b_mask: int          # bit mask over the b operand
    coeff: int           # integer Mobius coefficient


@dataclasses.dataclass(frozen=True)
class RankFactorization:
    """Exact integer factorization E = U @ V of one design's error table.

    U:        (n_mag, R) uint8 in {0,1}; U[a, s] = [subsets[s] subseteq a].
    V:        (R, n_mag) int32; integer Mobius rows.
    subsets:  (R,) a-bit masks indexing the retained skeleton rows.
    u_signed: (256, R) int8 — U by uint8-cast *signed* operand with the
              operand's sign folded in (u_signed[x & 0xFF] = sign(x) *
              U[|x|]); the runtime gather needs no abs/sign pass.
    v_signed: (R, 256) int32 — same for the V side.
    stage1:   the surviving analytic stage-1 rank-1 terms on this domain.
    rank:     exact rank of E over Q on this domain (certified mod two
              62-bit-safe primes; always <= R).
    """
    design: str
    domain: str                      # 'int8' | 'full'
    subsets: Tuple[int, ...]
    U: np.ndarray
    V: np.ndarray
    u_signed: np.ndarray
    v_signed: np.ndarray
    stage1: Tuple[Stage1Term, ...]
    rank: int

    @property
    def R(self) -> int:
        return len(self.subsets)

    @property
    def max_abs_v(self) -> int:
        return int(np.abs(self.V).max()) if self.V.size else 0

    @property
    def k_exact_f32(self) -> int:
        """Largest contraction length K for which the correction GEMM is
        bit-exact in float32: K * max_b sum_s |V[s, b]| < 2^24."""
        col_sum = int(np.abs(self.V).sum(axis=0).max()) if self.V.size else 0
        return max(1, (_F32_EXACT - 1) // max(1, col_sum))

    @property
    def n_digits(self) -> int:
        """int8 digit planes needed to carry V (Pallas kernel)."""
        d, top = 1, DIGIT_BASE // 2 - 1
        while self.max_abs_v > top:
            top = top * DIGIT_BASE + DIGIT_BASE // 2 - 1
            d += 1
        return d


# ---------------------------------------------------------------------------
# Stage-1 analytic terms
# ---------------------------------------------------------------------------

# Stage-1 compressor sites of the pinned tree: (column, a-row window start,
# b-col window start); window length is always 4 and bit t of the window is
# the partial product a_{ra+t} * b_{col-ra-t}. Derived from
# multiplier.STAGE1_PLAN head selection (site analysis in scripts/).
STAGE1_SITES: Tuple[Tuple[int, int, int], ...] = (
    (5, 0, 2), (6, 0, 3), (7, 0, 4), (7, 4, 0),
    (8, 1, 4), (9, 2, 4), (10, 3, 4),
)


def _site_deficit_table(design: str) -> np.ndarray:
    """(16,) deficit of one stage-1 site as a function of its four raw
    window bits b0..b3 (head order; the design's input_perm applied)."""
    d = C.DESIGNS[design]
    out = np.zeros(16, np.int64)
    for idx in range(16):
        bits = [(idx >> t) & 1 for t in range(4)]
        x = [bits[p] for p in d.input_perm]
        v = int(d.table[x[0] + 2 * x[1] + 4 * x[2] + 8 * x[3]])
        out[idx] = sum(bits) - v
    return out


def _mobius(values: np.ndarray, nbits: int) -> np.ndarray:
    """In-place fast Mobius transform over the subset lattice: returns the
    integer multilinear coefficients of an integer-valued bit function."""
    coeff = values.astype(np.int64).copy()
    n = len(coeff)
    for bit in range(nbits):
        mask = 1 << bit
        hi = np.arange(n)[(np.arange(n) & mask) != 0]
        coeff[hi] -= coeff[hi ^ mask]
    return coeff


def stage1_terms(design: str, max_mag: int = 255) -> Tuple[Stage1Term, ...]:
    """All rank-1 monomial terms of the stage-1 site deficits.

    ``max_mag`` restricts to operand magnitudes <= max_mag: a term whose
    bit mask cannot be covered by any such magnitude is dropped (for the
    int8 domain, max_mag=128 removes every site touching bit 7)."""
    coeffs = _mobius(_site_deficit_table(design), 4)
    terms = []
    for col, ra, rb in STAGE1_SITES:
        for s in range(1, 16):
            if coeffs[s] == 0:
                continue
            a_mask = b_mask = 0
            for t in range(4):
                if (s >> t) & 1:
                    a_mask |= 1 << (ra + t)
                    b_mask |= 1 << (col - ra - t)
            if _min_mag(a_mask) > max_mag or _min_mag(b_mask) > max_mag:
                continue
            terms.append(Stage1Term(col=col, a_mask=a_mask, b_mask=b_mask,
                                    coeff=int(coeffs[s])))
    return tuple(terms)


def _min_mag(mask: int) -> int:
    """Smallest magnitude whose bits cover `mask` (= mask itself)."""
    return mask


# ---------------------------------------------------------------------------
# Error table + exact rank
# ---------------------------------------------------------------------------

def error_table(design: str) -> np.ndarray:
    """(256, 256) int64 deficit table E[a, b] = a*b - approx(a, b) for the
    proposed (all-approximate) structure — the gate-level oracle's error,
    exhaustive over all 2^16 unsigned operand pairs."""
    cfg = MultiplierConfig(name=f"proposed[{design}]", compressor=design,
                           structure="proposed")
    return -luts.error_lut(cfg).astype(np.int64)


def _rank_mod_p(M: np.ndarray, p: int) -> int:
    """Rank of an integer matrix mod a prime < 2^31 (int64-safe)."""
    A = (M.astype(np.int64) % p).copy()
    rows = A.shape[0]
    r = 0
    for c in range(A.shape[1]):
        nz = np.nonzero(A[r:, c])[0]
        if nz.size == 0:
            continue
        piv = r + nz[0]
        A[[r, piv]] = A[[piv, r]]
        A[r] = (A[r] * pow(int(A[r, c]), p - 2, p)) % p
        fac = A[:, c].copy()
        fac[r] = 0
        A = (A - fac[:, None] * A[r][None, :]) % p
        r += 1
        if r == rows:
            break
    return r


def exact_rank(M: np.ndarray) -> int:
    """Exact rank of an integer matrix over Q.

    rank mod p never exceeds the rational rank, so the max over two large
    primes is a certified lower bound; it equals the true rank unless both
    primes divide the same nonzero minor (vanishing probability for these
    small-entry tables, and always bracketed above by the factor count R).
    """
    return max(_rank_mod_p(M, 2147483629), _rank_mod_p(M, 2147483587))


# ---------------------------------------------------------------------------
# Skeleton factorization
# ---------------------------------------------------------------------------

def _signed_tables(U: np.ndarray, V: np.ndarray):
    """Fold operand signs into uint8-indexed gather tables.

    Index k in 0..255 represents the signed int8 value ``k if k < 128 else
    k - 256``; magnitudes (<= 128) index the magnitude-domain factors and
    the sign rides along, so  u_signed[x & 0xFF] @ v_signed[:, w & 0xFF]
    equals sign(x)*sign(w) * E[|x|, |w|] with no abs/sign ops at runtime.
    """
    vals = np.arange(256)
    sval = np.where(vals < 128, vals, vals - 256)
    mag = np.abs(sval)
    sgn = np.sign(sval)
    u_signed = (U[mag].astype(np.int64) * sgn[:, None]).astype(np.int8)
    v_signed = (V[:, mag].astype(np.int64) * sgn[None, :]).astype(np.int32)
    return u_signed, v_signed


@lru_cache(maxsize=32)
def factorize(design: str, domain: str = "int8") -> RankFactorization:
    """Exact integer factorization of `design`'s error table.

    domain='int8': magnitudes 0..128 (everything a signed int8 operand can
    reach through sign-magnitude); the runtime tables. domain='full': all
    2^16 unsigned pairs; used for validation and the rank report.
    """
    E = error_table(design)
    if domain == "int8":
        n_mag = 129
        Eq = E[:n_mag, :n_mag]
        # Mobius over the 7 low bits for magnitudes 0..127; magnitude 128
        # (bit 7 alone) is covered by the single extra subset {7} with row
        # E[128, :] - E[0, :] (E[0, :] == 0: a zero operand never errs).
        F = np.zeros((256, n_mag), np.int64)
        F[:128] = Eq[:128]
        for bit in range(7):
            mask = 1 << bit
            hi = np.arange(128)[(np.arange(128) & mask) != 0]
            F[hi] -= F[hi ^ mask]
        F[128] = Eq[128] - Eq[0]
        max_mag = 128
    elif domain == "full":
        n_mag = 256
        Eq = E
        F = _mobius_rows(Eq)
        max_mag = 255
    else:
        raise ValueError(f"unknown domain {domain!r}")

    nz = np.nonzero(np.any(F != 0, axis=1))[0]
    subsets = tuple(int(s) for s in nz)
    mags = np.arange(n_mag)
    U = ((mags[:, None] & nz[None, :]) == nz[None, :]).astype(np.uint8)
    V = F[nz].astype(np.int32)
    # bit-exact over the whole domain, by construction — assert anyway
    # (this is the 2^16-pair identity the tests re-check per design)
    if not np.array_equal(U.astype(np.int64) @ F[nz], Eq):
        raise AssertionError(f"factorization of {design!r} is not exact")
    # signed gather tables work for both domains: uint8-cast operands have
    # magnitudes <= 128, in range for either row count
    u_signed, v_signed = _signed_tables(U, V)
    return RankFactorization(
        design=design, domain=domain, subsets=subsets, U=U, V=V,
        u_signed=u_signed, v_signed=v_signed,
        stage1=stage1_terms(design, max_mag=max_mag),
        rank=exact_rank(Eq))


def _mobius_rows(M: np.ndarray) -> np.ndarray:
    F = M.astype(np.int64).copy()
    for bit in range(N_BITS):
        mask = 1 << bit
        hi = np.arange(256)[(np.arange(256) & mask) != 0]
        F[hi] -= F[hi ^ mask]
    return F


def v_digit_planes(fac: RankFactorization) -> Tuple[np.ndarray, ...]:
    """Split v_signed into balanced base-128 int8 digit planes:
    v = sum_d planes[d] * 128^d with planes[d] in [-64, 63], so every
    Pallas correction dot is an int8 x int8 -> int32 MXU matmul."""
    planes = []
    rem = fac.v_signed.astype(np.int64)
    for _ in range(fac.n_digits):
        dig = ((rem + DIGIT_BASE // 2) % DIGIT_BASE) - DIGIT_BASE // 2
        rem = (rem - dig) // DIGIT_BASE
        planes.append(dig.astype(np.int8))
    assert not np.any(rem), "digit planes did not exhaust V"
    return tuple(planes)


# ---------------------------------------------------------------------------
# Rank report (docs/kernels.md + eval profiles)
# ---------------------------------------------------------------------------

def rank_report() -> Tuple[dict, ...]:
    """Per-design factorization summary: analytic stage-1 term counts and
    skeleton rank on both domains (the table in docs/kernels.md)."""
    rows = []
    for name in C.DESIGNS:
        fi = factorize(name, "int8")
        ff = factorize(name, "full")
        rows.append({
            "design": name,
            "stage1_terms_full": len(stage1_terms(name, 255)),
            "stage1_terms_int8": len(fi.stage1),
            "R_int8": fi.R,
            "rank_int8": fi.rank,
            "R_full": ff.R,
            "rank_full": ff.rank,
            "max_abs_v": fi.max_abs_v,
            "k_exact_f32": fi.k_exact_f32,
            "digits": fi.n_digits,
        })
    return tuple(rows)
