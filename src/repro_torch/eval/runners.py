"""Experiment runners, one per suite, behind ``python -m repro_torch.eval``.

The JAX package's ``repro/eval/runners.py`` on the port. Each runner
returns a versioned artifact (see :mod:`repro_torch.eval.artifacts`) whose
tables join task metrics (PSNR/SSIM, accuracy) with the per-backend error
metrics and hardware proxies from :mod:`repro_torch.eval.profiles`:

  metrics   paper Table 2 — exhaustive ER/NMED/MRED per compressor design
  hw        paper Tables 3/4 — unit-gate proxy (area/energy/delay/PDP)
  denoise   paper §5.2 / Figs 7-8 — FFDNet PSNR/SSIM per backend per sigma
  mnist     paper §5.1 / Table 5 — LeNet-5 accuracy per backend
  lm        beyond paper — decoder-LM perplexity / logit NMED per backend
  serve     beyond paper — continuous-batching serving parity per backend

The task suites train with QAT (serve: random weights) and then sweep bf16,
every registered backend and the two worst-baseline multiplier variants, on
``device`` ("cuda" unless the caller asks for the CPU). ``smoke`` swaps
the paper-scale budgets for minute-scale ones without changing the sweep
structure.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.eval import artifacts, paper_tables, profiles
from repro_torch.eval.markdown import Column, markdown_table
from repro_torch.models import cnn as CNN
from repro_torch.nn.module import resolve_device
from repro_torch.quant.matmul import list_backends
from repro_torch.quant.quantize import BF16, QuantConfig
from repro_torch.train import cnn_train as T

# ---------------------------------------------------------------------------
# Backend sweep
# ---------------------------------------------------------------------------

# Extra (backend, multiplier) points echoing the paper's worst-baseline
# comparisons (Table 5 / Fig. 8 evaluate design [13] and [16]-D2 too).
VARIANT_SWEEP = (("approx_lut", "design13"), ("approx_lut", "design16_d2"))

def sweep_points(variants: bool = True) -> List[Tuple[str, str, str]]:
    """(label, backend, multiplier) for bf16 + every registered backend
    (+ the worst-baseline multiplier variants)."""
    pts = [("bf16", "bf16", "proposed")]
    pts += [(b, b, "proposed") for b in list_backends()]
    if variants:
        pts += [(f"{b}[{m}]", b, m) for b, m in VARIANT_SWEEP]
    return pts


def quant_for(backend: str, multiplier: str = "proposed") -> QuantConfig:
    """QuantConfig for one sweep point."""
    if backend == "bf16":
        return BF16
    return QuantConfig(backend=backend, multiplier=multiplier)


def _base_config(smoke: bool, seed: int, device) -> Dict:
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"smoke": bool(smoke), "seed": int(seed),
            "torch": torch.__version__, "device": name}


# ---------------------------------------------------------------------------
# Deterministic suites (no training)
# ---------------------------------------------------------------------------

def run_metrics(smoke: bool = False, seed: int = 0, device="cuda") -> Dict:
    return artifacts.make_artifact(
        "metrics", {"table2": paper_tables.table2_rows()},
        _base_config(smoke, seed, device))


def run_hw(smoke: bool = False, seed: int = 0, device="cuda") -> Dict:
    t3 = paper_tables.table3_rows()
    return artifacts.make_artifact(
        "hw", {"table3": t3,
               "table3_summary": [paper_tables.table3_summary(t3)],
               "table4": paper_tables.table4_rows()},
        _base_config(smoke, seed, device))


# ---------------------------------------------------------------------------
# Task suites (train once, sweep backends at eval)
# ---------------------------------------------------------------------------

def denoise_rows(params, cfg: CNN.FFDNetConfig, *, sigmas, n_eval: int,
                 size: int, seed: int, device="cuda") -> List[Dict]:
    """The denoise table of trained ``params``: one row per sigma and sweep
    point."""
    rows = []
    for sigma in sigmas:
        for label, backend, mult in sweep_points(variants=True):
            psnr, ssim, noisy_psnr = T.eval_denoiser(
                params, cfg, quant_for(backend, mult), sigma=sigma,
                n=n_eval, size=size, seed=seed + 3, device=device)
            rows.append({"backend": label, "sigma": sigma,
                         "psnr": round(psnr, 2), "ssim": round(ssim, 4),
                         "noisy_psnr": round(noisy_psnr, 2),
                         **profiles.backend_profile(backend, mult)})
    return rows


def run_denoise(smoke: bool = False, seed: int = 0, device="cuda") -> Dict:
    if smoke:
        cfg = CNN.FFDNetConfig(depth=3, width=8)
        steps, size, n_eval = 40, 32, 4
    else:
        cfg = CNN.FFDNetConfig(depth=6, width=32)
        steps, size, n_eval = 150, 64, 16
    sigmas = (25.0, 50.0)
    config = _base_config(smoke, seed, device)
    params = T.train_denoiser(cfg, steps=steps, size=size, seed=seed,
                              qat=True, device=device)
    rows = denoise_rows(params, cfg, sigmas=sigmas, n_eval=n_eval,
                        size=size, seed=seed, device=device)
    config.update({"model": "ffdnet", "depth": cfg.depth,
                   "width": cfg.width, "steps": steps, "size": size,
                   "n_eval": n_eval, "sigmas": list(sigmas)})
    return artifacts.make_artifact("denoise", {"denoise": rows}, config)


def mnist_rows(params, *, n_test: int, seed: int,
               device="cuda") -> List[Dict]:
    """The mnist table of trained LeNet-5 ``params``: one row per sweep
    point."""
    rows = []
    for label, backend, mult in sweep_points(variants=True):
        acc = T.eval_classifier(params, CNN.lenet5_apply,
                                quant_for(backend, mult), n_test=n_test,
                                seed=seed + 1, device=device)
        rows.append({"backend": label, "acc": round(acc, 2),
                     **profiles.backend_profile(backend, mult)})
    return rows


def run_mnist(smoke: bool = False, seed: int = 0, device="cuda") -> Dict:
    if smoke:
        steps, n_train, n_test = 60, 1500, 128
    else:
        steps, n_train, n_test = 300, 5000, 500
    config = _base_config(smoke, seed, device)
    params = T.train_classifier(CNN.lenet5_descs(), CNN.lenet5_apply,
                                steps=steps, n_train=n_train, seed=seed,
                                qat=True, device=device)
    rows = mnist_rows(params, n_test=n_test, seed=seed, device=device)
    config.update({"model": "lenet5", "steps": steps, "n_train": n_train,
                   "n_test": n_test})
    return artifacts.make_artifact("mnist", {"mnist": rows}, config)


def run_lm(smoke: bool = False, seed: int = 0, device="cuda") -> Dict:
    from repro_torch.eval import lm as LM
    return LM.run(smoke=smoke, seed=seed, device=device)


def run_serve(smoke: bool = False, seed: int = 0, device="cuda") -> Dict:
    from repro_torch.eval import serve as SERVE
    return SERVE.run(smoke=smoke, seed=seed, device=device)


# ---------------------------------------------------------------------------
# Suite registry + markdown rendering
# ---------------------------------------------------------------------------

_PROFILE_COLS: Tuple[Column, ...] = (
    ("er", "ER %", ".3f"), ("nmed", "NMED %", ".3f"),
    ("mred", "MRED %", ".3f"),
    ("corr_rank", "corr rank R", None),
    ("mac_proxy", "MACs/MAC", ".0f"),
    ("proxy_energy", "proxy energy (u)", ".1f"),
    ("proxy_pdp", "proxy PDP (u)", ".1f"),
)

# appended to every task-table note that carries _PROFILE_COLS
_PROFILE_NOTE = (
    " msr4/drum6/posneg rows: ER/NMED/MRED exhaustive over the signed "
    "operand domain [-127, 127]² with NMED normalized by 127² "
    "(eval/profiles.py); compressor-family rows use the unsigned 8×8 "
    "domain normalized by 255² (paper convention).")


@dataclasses.dataclass(frozen=True)
class TableSpec:
    title: str
    columns: Tuple[Column, ...]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class Suite:
    name: str
    run: Callable[..., Dict]
    tables: Dict[str, TableSpec]
    doc: str = ""


SUITES: Dict[str, Suite] = {
    "metrics": Suite(
        "metrics", run_metrics,
        {"table2": TableSpec(
            "Paper Table 2 — exhaustive error metrics (proposed structure)",
            (("design", "design", None),
             ("er", "ER %", ".3f"), ("er_paper", "paper ER %", ".3f"),
             ("nmed", "NMED %", ".3f"),
             ("nmed_paper", "paper NMED %", ".3f"),
             ("mred", "MRED %", ".3f"),
             ("mred_paper", "paper MRED %", ".3f")),
            "Exhaustive over all 2^16 operand pairs. The proposed / "
            "single_error rows reproduce the paper to all printed NMED and "
            "MRED digits (ER differs by 0.054 pp — an unrecoverable "
            "dot-diagram micro-detail, see `core/multiplier.py`); baseline "
            "designs track the paper's ordering but not exact values, as "
            "their tree micro-structure is not fully specified.")},
        doc="Table 2 error-metric zoo (deterministic)"),
    "hw": Suite(
        "hw", run_hw,
        {"table3": TableSpec(
            "Paper Table 3 — 4:2 compressor hardware (unit-gate proxy)",
            (("design", "design", None), ("area_u", "area (u)", ".1f"),
             ("delay_u", "delay (u)", ".1f"),
             ("energy_u", "energy (u)", ".1f"), ("pdp_u", "PDP (u)", ".2f"),
             ("paper_area", "paper area (µm²)", ".2f"),
             ("paper_pdp", "paper PDP (fJ)", ".3f"),
             ("err_prob", "err /256", None)),
            "Proxy-modeled: unit-gate weights, not 90 nm synthesis — "
            "orderings and ratios are the claim, absolute values are not."),
         "table3_summary": TableSpec(
            "Proxy fidelity summary",
            (("pdp_rank_corr", "PDP rank corr (proxy vs paper)", ".3f"),
             ("proposed_over_exact_energy", "proposed/exact energy", ".3f"),
             ("paper_proposed_over_exact_energy",
              "paper proposed/exact power", ".3f"))),
         "table4": TableSpec(
            "Paper Table 4 — 8x8 multiplier hardware proxy + exhaustive "
            "MRED per structure",
            (("design", "compressor", None), ("area", "area (u)", ".2f"),
             ("energy", "energy (u)", ".2f"), ("delay", "delay (u)", ".2f"),
             ("pdp", "PDP (u)", ".2f"),
             ("mred_design1", "MRED % d1", ".3f"),
             ("mred_design2", "MRED % d2", ".3f"),
             ("mred_proposed", "MRED % prop", ".3f")),
            "MRED columns are exact (exhaustive); area/energy/delay/PDP "
            "are unit-gate proxies.")},
        doc="Tables 3/4 hardware proxies (deterministic)"),
    "denoise": Suite(
        "denoise", run_denoise,
        {"denoise": TableSpec(
            "Denoising — FFDNet PSNR/SSIM per backend (paper §5.2)",
            (("backend", "backend", None), ("sigma", "σ", ".0f"),
             ("psnr", "PSNR (dB)", ".2f"), ("ssim", "SSIM", ".4f"),
             ("noisy_psnr", "noisy PSNR", ".2f")) + _PROFILE_COLS,
            "Synthetic textures stand in for the paper's image set; the "
            "exact-vs-approx delta is the claim. "
            "SSIM is the standard Gaussian-window formulation."
            + _PROFILE_NOTE)},
        doc="FFDNet denoising PSNR/SSIM backend sweep"),
    "mnist": Suite(
        "mnist", run_mnist,
        {"mnist": TableSpec(
            "Digit recognition — LeNet-5 accuracy per backend "
            "(paper Table 5)",
            (("backend", "backend", None), ("acc", "accuracy %", ".2f"))
            + _PROFILE_COLS,
            "Synthetic digits stand in for MNIST. "
            "Paper Table 5 (LeNet-5 on MNIST): exact 98.24, proposed "
            "96.45, design [13] 91.66." + _PROFILE_NOTE)},
        doc="LeNet-5 classification accuracy backend sweep"),
    "lm": Suite(
        "lm", run_lm,
        {"lm": TableSpec(
            "Decoder LM — perplexity and logit NMED per backend "
            "(beyond paper)",
            (("backend", "backend", None), ("ppl", "ppl", ".3f"),
             ("d_ppl", "Δppl vs bf16", "+.3f"),
             ("logit_nmed", "logit NMED %", ".4f")) + _PROFILE_COLS,
            "smollm-family decoder (QAT-trained on a synthetic zipf "
            "stream), every projection — QKV, attention output, MLP, LM "
            "head — through the selected backend with per-token activation "
            "scales. Logit NMED is mean |Δlogit| / max |logit_bf16| vs the "
            "bf16 reference." + _PROFILE_NOTE)},
        doc="decoder-LM perplexity/logit-NMED backend sweep"),
    "serve": Suite(
        "serve", run_serve,
        {"serve": TableSpec(
            "Serving — continuous-batching output parity per backend "
            "(beyond paper)",
            (("backend", "backend", None), ("requests", "requests", None),
             ("new_tokens", "new tokens", None),
             ("hit_rate", "prefix hit rate", ".3f"),
             ("solo_match", "solo == batched", None),
             ("match_bf16", "tokens == bf16 %", ".2f"),
             ("prefix_bf16", "shared prefix (tok)", ".2f"),
             ("spec_match", "spec == sequential", None),
             ("spec_accept", "accepted drafts/pass", ".2f")),
            "Mixed-length workload behind a shared system prefix (more "
            "requests than slots; the last request is admitted mid-decode "
            "into a reused slot on a prefix-cache hit) served by the "
            "continuous-batching engine (repro_torch.serve) under every "
            "backend with per-token activation scales. `prefix hit rate` "
            "is the fraction of prompt tokens gathered from the paged KV "
            "cache instead of prefilled; `solo == batched` is the engine's "
            "batching + cache-hit invariance; the bf16 columns measure "
            "where approximate accumulators first flip a greedy argmax; "
            "`spec == sequential` re-serves the workload with speculative "
            "decoding (K=4, approx_stage1 draft), with `accepted "
            "drafts/pass` the mean acceptance length. Params are "
            "random-init: this scores the serving path, not task quality "
            "(see suite `lm`).")},
        doc="continuous-batching serving parity backend sweep"),
}

SUITE_ORDER = ("metrics", "hw", "denoise", "mnist", "lm", "serve")


def resolve_suites(name: str) -> Sequence[str]:
    """'all', a suite name, or a comma list ('metrics,hw') -> run order."""
    if name == "all":
        return SUITE_ORDER
    names = tuple(n.strip() for n in name.split(",") if n.strip())
    unknown = [n for n in names if n not in SUITES]
    if unknown or not names:
        raise KeyError(f"unknown suite(s) {unknown or [name]}; choose from "
                       f"{SUITE_ORDER + ('all',)} (comma lists allowed)")
    return names


def render_artifact(art: Dict) -> str:
    """Suite artifact -> markdown (titles + tables + notes). Deterministic
    given the artifact's tables — timestamps and config are not rendered."""
    suite = SUITES[art["suite"]]
    parts = []
    for tname, spec in suite.tables.items():
        if tname not in art["tables"]:
            raise KeyError(
                f"artifact for suite {art['suite']!r} is missing table "
                f"{tname!r} — stale file? re-run the suite")
        rows = art["tables"][tname]
        parts.append(f"#### {spec.title}\n")
        parts.append(markdown_table(rows, spec.columns))
        if spec.note:
            parts.append(f"\n*{spec.note}*\n")
        parts.append("\n")
    return "".join(parts).rstrip() + "\n"
