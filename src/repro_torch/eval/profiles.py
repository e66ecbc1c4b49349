"""Per-backend error/energy profiles joined into the task tables.

The paper argues task quality *together with* multiplier error metrics and
silicon cost; the harness therefore annotates every task row (PSNR/SSIM,
accuracy) with the exhaustive ER/NMED/MRED of the multiplier that backend
emulates and the unit-gate energy/PDP proxy of the corresponding hardware.

Families:
  bf16                  float compute — no integer products, no proxy
  int8_*                exact products; hardware proxy = exact-compressor
                        multiplier
  approx_lut/deficit/*  the paper's gate-level multiplier for the selected
                        compressor design (exhaustive table from
                        core.multiplier)
  approx_stage1*        the exact-dot re-approximation (exhaustive table
                        from quant.matmul.stage1_exhaustive_products);
                        executed on exact matmul hardware, so no unit-gate
                        proxy
  msr4/drum6/posneg     the MSR/truncation family (core/truncation.py
                        gate tables). These schemes are defined on SIGNED
                        operands (sign-run detection, sign-classed
                        truncation), so their ER/NMED/MRED are exhaustive
                        over the signed operand domain [-127, 127]^2 the
                        quantizer emits, with NMED normalized by 127^2
                        (metrics.evaluate_signed) — noted in the docs
                        tables. Hardware proxies are truncated-core unit-
                        gate estimates (hwproxy.truncation_proxy).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np

from repro_torch.core import hwproxy as HW
from repro_torch.core import metrics as X
from repro_torch.core import multiplier as M
from repro_torch.core import truncation as T
from repro_torch.quant import matmul as QM

# Family roots: the backends whose exhaustive product table is known
# first-hand. Every other registered backend inherits its family by
# walking its declared `oracle` chain (a backend bit-identical to
# approx_lut realizes the paper multiplier, etc.), so backends added via
# register_backend(oracle=...) get correct profile columns for free.
_ROOT_FAMILY = {
    "int8_exact": "exact",
    "approx_lut": "paper",
    "approx_stage1": "stage1",
    "msr4_lut": "msr4",
    "drum6_lut": "drum6",
    "posneg_lut": "posneg",
}

# families whose exhaustive table lives in core.truncation (signed domain)
_TRUNCATION_FAMILIES = ("msr4", "drum6", "posneg")


def _family(backend: str) -> Optional[str]:
    name = backend
    seen = set()
    while name not in _ROOT_FAMILY:
        if name in seen:
            return None
        seen.add(name)
        try:
            oracle = QM.get_backend(name).oracle
        except KeyError:          # not a registered backend (e.g. bf16)
            return None
        if oracle is None:
            return None
        name = oracle
    return _ROOT_FAMILY[name]


@lru_cache(maxsize=32)
def _metrics(family: str, mult: str) -> Optional[X.ErrorMetrics]:
    exact = X.exhaustive_exact()
    if family == "exact":
        return X.evaluate(exact, exact)
    if family == "paper":
        return X.evaluate(
            M.exhaustive_products(M.proposed_multiplier(mult)), exact)
    if family == "stage1":
        return X.evaluate(QM.stage1_exhaustive_products(), exact)
    if family in _TRUNCATION_FAMILIES:
        # exhaustive over the signed operand domain the quantizer emits:
        # [-127, 127]^2 (index 128, the -128 byte, never occurs post-clip)
        keep = np.arange(256) != 128
        sel = np.ix_(keep, keep)
        return X.evaluate_signed(T.product_table(family).astype(np.int64)[sel],
                                 X.exhaustive_exact_signed()[sel])
    return None


def correction_cost(backend: str, multiplier: str):
    """(corr_rank, mac_proxy) for one backend.

    corr_rank: exact factor count R of the multiplier's error-table
    factorization on the int8 domain (core/factor.py) — the number of
    rank-1 correction terms the backend's semantics cost when executed as
    dense linear algebra. Shown for element-wise emulation backends too
    (their matmul-shaped equivalent), 0 for exact int8.

    mac_proxy: matrix-unit MACs issued per output MAC by the backend as
    actually implemented (1 exact dot + correction dots); None where
    execution is not MAC-shaped (bf16 float compute, gather- or
    elementwise-bound emulation).
    """
    if backend == "int8_exact":
        return 0, 1.0
    if backend.startswith("approx_stage1"):
        n_sites = len(QM.STAGE1_SITES)
        macs = 4.0 if backend == "approx_stage1_fused" else 1.0 + n_sites
        return n_sites, macs
    if backend.startswith("approx_rank1"):
        info = QM.rank1_info(multiplier)
        per_term = info["digits"] if backend.endswith("_pallas") else 1
        return info["R"], 1.0 + per_term * info["R"]
    fam = _family(backend)
    if fam == "paper":                   # element-wise emulation of the
        return QM.rank1_info(multiplier)["R"], None   # same error table
    if fam in _TRUNCATION_FAMILIES:
        # no correction terms: the approximation is executed directly as
        # dense dots (decode + 1 dot / truncate + 1 dot / 4 masked dots);
        # the *_lut gate references are gather-bound, not MAC-shaped
        if backend.endswith("_lut"):
            return None, None
        return None, {"msr4": 1.0, "drum6": 1.0, "posneg": 4.0}[fam]
    return None, None


def backend_profile(backend: str, multiplier: str = "proposed") -> Dict:
    """Flat dict of er/nmed/mred (%) + proxy energy/pdp + correction
    rank / MAC-count proxy for one backend.

    Values are None (rendered as an em dash) where the concept does not
    apply: bf16 runs no integer products; the stage1 family executes on
    exact matmul hardware so a unit-gate multiplier proxy would be
    meaningless.
    """
    family = _family(backend)
    m = _metrics(family, multiplier) if family else None
    d = m.to_dict() if m is not None else {}
    corr_rank, mac_proxy = correction_cost(backend, multiplier)
    row: Dict = {
        "er": None if m is None else round(d["er_pct"], 3),
        "nmed": None if m is None else round(d["nmed_pct"], 3),
        "mred": None if m is None else round(d["mred_pct"], 3),
        "corr_rank": corr_rank,
        "mac_proxy": mac_proxy,
        "proxy_energy": None,
        "proxy_pdp": None,
    }
    if family == "exact":
        hwm = HW.multiplier_proxy("exact")
    elif family == "paper":
        hwm = HW.multiplier_proxy(multiplier)
    elif family in _TRUNCATION_FAMILIES:
        hwm = HW.truncation_proxy(family)
    else:
        hwm = None
    if hwm is not None:
        row["proxy_energy"] = round(hwm["energy"], 2)
        row["proxy_pdp"] = round(hwm["pdp"], 2)
    return row
