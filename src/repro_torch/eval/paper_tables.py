"""Row builders for the paper's deterministic tables (2, 3 and 4), on the
port's numpy core: the same rows as the JAX package's
``repro/eval/paper_tables.py``, value for value.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core import hwproxy as HW
from repro_torch.core import metrics as X
from repro_torch.core import multiplier as M

# Paper Table 2: (ER %, NMED %, MRED %) of the proposed 8x8 structure per
# compressor design.
PAPER_TABLE2 = {
    "design12": (68.498, 0.596, 3.496),
    "design15": (65.425, 0.673, 3.531),
    "single_error": (6.994, 0.046, 0.109),
    "design16_d2": (86.326, 1.879, 9.551),
    "design17_d2": (21.296, 0.162, 0.578),
    "design13": (95.681, 1.565, 20.276),
    "proposed": (6.994, 0.046, 0.109),
}

# Paper Table 4 proposed-structure MRED row (design1/design2/proposed %),
# quoted in reports next to the proxy-derived values.
PAPER_TABLE4_PROPOSED_MRED = (0.023, 0.715, 0.109)


def rank_corr(a, b) -> float:
    """Spearman rank correlation (ranks by argsort-argsort)."""
    ra = np.argsort(np.argsort(np.asarray(a)))
    rb = np.argsort(np.argsort(np.asarray(b)))
    return float(np.corrcoef(ra, rb)[0, 1])


def table2_rows() -> List[Dict]:
    """Exhaustive ER/NMED/MRED of the proposed structure per compressor,
    next to the paper's Table 2 values."""
    exact = X.exhaustive_exact()
    rows = []
    for name, (er_p, nmed_p, mred_p) in PAPER_TABLE2.items():
        t = M.exhaustive_products(M.proposed_multiplier(name))
        m = X.evaluate(t, exact)
        rows.append({"design": name,
                     "er": round(m.er_pct, 3), "er_paper": er_p,
                     "nmed": round(m.nmed_pct, 3), "nmed_paper": nmed_p,
                     "mred": round(m.mred_pct, 3), "mred_paper": mred_p})
    return rows


def table3_rows() -> List[Dict]:
    """Unit-gate proxy metrics per 4:2 compressor next to paper Table 3."""
    rows = []
    for name, paper in HW.PAPER_TABLE3.items():
        nl = HW.COMPRESSORS[name]
        rows.append({"design": name, "area_u": nl.area,
                     "delay_u": nl.delay, "energy_u": nl.energy,
                     "pdp_u": nl.pdp, "paper_area": paper[0],
                     "paper_pdp": paper[3], "err_prob": paper[4]})
    return rows


def table3_rank_corr(rows: List[Dict]) -> float:
    return rank_corr([r["pdp_u"] for r in rows],
                     [r["paper_pdp"] for r in rows])


def table3_summary(rows: List[Dict]) -> Dict:
    """Proxy-fidelity summary of a table3_rows() result: rank correlation
    plus the proposed/exact energy ratio next to the paper's power ratio
    (Table 3: proposed 1.12 uW vs exact 1.99 uW)."""
    prop = next(r for r in rows if r["design"] == "proposed")
    exact = next(r for r in rows if r["design"] == "exact")
    return {
        "pdp_rank_corr": round(table3_rank_corr(rows), 3),
        "proposed_over_exact_energy": round(
            prop["energy_u"] / exact["energy_u"], 3),
        "paper_proposed_over_exact_energy": round(1.12 / 1.99, 3),
    }


def table4_rows() -> List[Dict]:
    """Multiplier-level proxy metrics + exhaustive MRED per structure."""
    exact_tab = X.exhaustive_exact()
    rows = []
    for comp in ["design12", "design15", "design16_d2", "design17_d2",
                 "design13", "single_error", "proposed"]:
        hwm = HW.multiplier_proxy(comp)
        row = {"design": comp, **{k: round(v, 2) for k, v in hwm.items()}}
        for struct, mk in (("design1", M.design1_multiplier),
                           ("design2", M.design2_multiplier),
                           ("proposed", M.proposed_multiplier)):
            m = X.evaluate(M.exhaustive_products(mk(comp)), exact_tab)
            row[f"mred_{struct}"] = round(m.mred_pct, 3)
        rows.append(row)
    return rows
