"""Vectorized torch cores for the MSR/truncation backend family.

Each function implements the ``(x_q (M,K) int8, w_q (K,N) int8, cfg) ->
(M,N) int32`` registry contract of `repro_torch.quant.matmul` and is
bit-identical to its gate-level reference table
(`repro_torch.core.truncation.product_table`) over the full 2^16
signed-pair domain. Unlike the LUT emulation backends these cores never
materialize an (M, K, N) intermediate; each is a few dense contractions
over operand-wise transforms:

  msr4_matmul     decode weights to mantissa << shift (still int8), then
                  one exact dot: the weight-only scheme costs a K*N
                  element-wise decode and nothing else.
  drum6_matmul    truncate both operands to 6 significant bits with the
                  forced-one debias, then one dot. The operands are int16
                  only to carry the drum(128) = 132 edge of the full
                  oracle domain.
  posneg_matmul   four masked dots: the positive product classes
                  (a>0,b>0) + (a<0,b<0) on 4-bit floored magnitudes
                  minus the negative classes (a>0,b<0) + (a<0,b>0)
                  on 6-bit floored magnitudes.

Every dot is `kernels.ref.int8_matmul`, which runs in float64 and is exact
for int16 operands too (|sum| < 2^53); the card has no integer matmul.
This module does not import `repro_torch.quant.matmul` (it is imported
*by* it at registration time).
"""
from __future__ import annotations

import torch

from repro_torch.core.truncation import (DRUM_K, MSR_MANT_MAX, MSR_MANT_MIN,
                                         POSNEG_K_NEG, POSNEG_K_POS)
from repro_torch.kernels.ref import int8_matmul


def msr4_decode_weights(w_q: torch.Tensor) -> torch.Tensor:
    """int8 -> int8 decoded weights (mantissa << shift), the torch twin of
    `core.truncation.msr4_decode_value`. Decoded values stay in
    [-128, 120], so the result is still an int8 tensor."""
    v = w_q.to(torch.int32)
    u = v & 0xFF
    # sign-replicated XOR: leading zeros of t == MSR run length
    t = u ^ (((u >> 7) & 1) * 0xFF)
    # shift s = max(0, 4 - run) == number of thresholds 16/32/64 t clears
    s = ((t >= 16).to(torch.int32) + (t >= 32).to(torch.int32)
         + (t >= 64).to(torch.int32))
    half = (1 << s) >> 1                       # 0 when s == 0
    m = torch.clamp((v + half) >> s, MSR_MANT_MIN, MSR_MANT_MAX)
    return (m << s).to(torch.int8)


def msr4_matmul(x_q, w_q, cfg) -> torch.Tensor:
    """Exact activations x MSR-4 decoded weights: one exact dot."""
    return int8_matmul(x_q, msr4_decode_weights(w_q))


def _trunc_shift(mag: torch.Tensor, k: int) -> torch.Tensor:
    """t = max(0, leading_one_pos - (k-1)) for 8-bit magnitudes, as a sum
    of threshold comparisons (mag >= 2^j  <=>  leading_one_pos >= j)."""
    t = torch.zeros_like(mag)
    for j in range(k, 8):
        t = t + ((mag >> j) > 0).to(torch.int32)
    return t


def drum_truncate_ops(x: torch.Tensor, k: int = DRUM_K) -> torch.Tensor:
    """Sign-preserving DRUM operand truncation: sign * ((|x|>>t)|1)<<t
    with t from the leading-one position, exact below 2^k. int16 out
    (drum(128) = 132 exceeds int8 on the oracle's -128 edge)."""
    v = x.to(torch.int32)
    mag = v.abs()
    t = _trunc_shift(mag, k)
    kept = ((mag >> t) | 1) << t
    out = torch.where(mag >= (1 << k), kept, mag)
    return (v.sign() * out).to(torch.int16)


def drum6_matmul(x_q, w_q, cfg) -> torch.Tensor:
    """One dot over DRUM-truncated operands: P factors through the
    operands, so sign(a)d(|a|) . sign(b)d(|b|) is exactly the signed
    approximate product summed over K."""
    return int8_matmul(drum_truncate_ops(x_q), drum_truncate_ops(w_q))


def _floor_trunc(mag: torch.Tensor, k: int) -> torch.Tensor:
    t = _trunc_shift(mag, k)
    return (mag >> t) << t


def posneg_matmul(x_q, w_q, cfg) -> torch.Tensor:
    """Sign-classed asymmetric truncation as four masked dots.

    Positive product classes (++ and --) use k=4 floors, negative
    classes (+- and -+) use k=6 floors; zero operands vanish from every
    mask so zero products contribute exactly 0."""
    xv = x_q.to(torch.int32)
    wv = w_q.to(torch.int32)
    xmag, wmag = xv.abs(), wv.abs()
    xp, xn = (xv > 0).to(torch.int32), (xv < 0).to(torch.int32)
    wp, wn = (wv > 0).to(torch.int32), (wv < 0).to(torch.int32)
    x4 = _floor_trunc(xmag, POSNEG_K_POS)
    w4 = _floor_trunc(wmag, POSNEG_K_POS)
    x6 = _floor_trunc(xmag, POSNEG_K_NEG)
    w6 = _floor_trunc(wmag, POSNEG_K_NEG)
    pos = int8_matmul(x4 * xp, w4 * wp) + int8_matmul(x4 * xn, w4 * wn)
    neg = int8_matmul(x6 * xp, w6 * wn) + int8_matmul(x6 * xn, w6 * wp)
    return pos - neg
