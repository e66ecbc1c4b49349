"""Product / error lookup tables for multiplier configs (cached)."""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from repro_torch.core import metrics
from repro_torch.core.multiplier import MultiplierConfig, exhaustive_products


@lru_cache(maxsize=32)
def _tables(key_cfg: MultiplierConfig):
    approx = exhaustive_products(key_cfg)            # (256,256) int64
    exact = metrics.exhaustive_exact()
    err = approx - exact
    return (approx.astype(np.int32),
            err.astype(np.int16))                    # |err| <= 3592


def product_lut(cfg: MultiplierConfig) -> np.ndarray:
    """(256,256) int32: approx product for unsigned operands."""
    return _tables(cfg)[0]


def error_lut(cfg: MultiplierConfig) -> np.ndarray:
    """(256,256) int16: approx - exact. Sparse (ER ~7% for proposed)."""
    return _tables(cfg)[1]


def flat_product_lut(cfg: MultiplierConfig) -> np.ndarray:
    """(65536,) int32 indexed by a*256+b — gather-friendly layout."""
    return product_lut(cfg).reshape(-1)


def signed_product_lut(cfg: MultiplierConfig) -> np.ndarray:
    """(256, 256) int32 table indexed by (a & 0xFF, b & 0xFF) for SIGNED
    int8 operands in [-127, 127], using sign-magnitude around the unsigned
    core: p = sign(a)*sign(b) * approx(|a|, |b|).

    Index convention: row/col k represents the signed value
    ``k if k < 128 else k - 256`` (two's complement byte).
    """
    u = product_lut(cfg)
    out = np.zeros((256, 256), np.int32)
    vals = np.arange(256)
    sval = np.where(vals < 128, vals, vals - 256)
    mag = np.minimum(np.abs(sval), 255)  # |x| <= 128 < 256, fits
    sign = np.sign(sval)
    out = (sign[:, None] * sign[None, :]) * u[mag[:, None], mag[None, :]]
    return out.astype(np.int32)
