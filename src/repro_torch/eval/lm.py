"""LM suite: approximate-transformer inference through the backend
registry, after the JAX package's ``repro.eval.lm``.

A small smollm-family decoder is trained once with QAT on the synthetic
zipf stream, then evaluated teacher-forced with per-token activation scales
(``quantize.for_lm``) per sweep point. Reported per backend:

  ppl         teacher-forced perplexity on a held-out synthetic stream
  d_ppl       perplexity delta vs the bf16 reference run
  logit_nmed  mean |logits − logits_bf16| / max |logits_bf16| (%), the NMED
              of the full logit tensor
  + the per-backend ER/NMED/MRED and unit-gate proxy columns shared with
    the CNN suites (repro_torch.eval.profiles)

The port's trained weights are its own (its init RNG is another), so its
rows stand beside the JAX package's, not equal to them; on one set of
weights the two agree (tests/test_torch_lm_suites.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.eval import artifacts, profiles
from repro_torch.models import transformer_lm as TLM
from repro_torch.nn import layers as L
from repro_torch.nn.module import resolve_device
from repro_torch.optim import adamw
from repro_torch.quant.quantize import for_lm
from repro_torch.train import steps as ST


def arch(smoke: bool):
    """Smoke-sized (CI) or small (full) smollm-family config."""
    if smoke:
        return registry.reduced(
            "smollm-135m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=256, vocab_pad=256, head_dim=16)
    return registry.reduced(
        "smollm-135m", n_layers=4, d_model=128, d_ff=256,
        vocab=512, vocab_pad=512)


def budgets(smoke: bool) -> Dict[str, int]:
    if smoke:
        return {"steps": 40, "batch": 8, "seq": 32, "eval_seqs": 8}
    return {"steps": 300, "batch": 16, "seq": 64, "eval_seqs": 32}


def train_lm(cfg, steps: int, batch: int, seq: int, seed: int,
             device="cuda"):
    """QAT-train a tiny decoder on the synthetic zipf stream -> (params,
    last loss)."""
    dev = resolve_device(device)
    n_seqs = max(64, 4 * batch)
    toks = synthetic.token_stream(n_seqs, seq + 1, cfg.vocab, seed=seed)
    params = TLM.init(cfg, torch.Generator().manual_seed(seed), dev)
    ocfg = adamw.AdamWConfig(lr=2e-3)
    opt_state = adamw.init(params, ocfg)
    step_fn = ST.make_train_step(cfg, ocfg, qat=True)
    rng = np.random.default_rng(seed)
    loss = float("nan")
    for _ in range(steps):
        idx = rng.integers(0, n_seqs, batch)
        batch_d = {"tokens": torch.as_tensor(toks[idx, :-1], device=dev),
                   "labels": torch.as_tensor(toks[idx, 1:], device=dev)}
        params, opt_state, metrics = step_fn(params, opt_state, batch_d)
        loss = float(metrics["loss"])
    return params, loss


def eval_point(params, cfg, quant, tokens, labels):
    """Teacher-forced logits + mean CE under one QuantConfig.

    Returns (logits (B, S, vocab) float32 over the true vocab, loss)."""
    cfg_q = dataclasses.replace(cfg, quant=quant)
    with torch.inference_mode():
        x = TLM.embed_tokens(params, tokens, cfg_q)
        h, _, _ = TLM.backbone(params, x, cfg_q, training=False)
        lg = TLM.lm_logits(params, h, cfg_q)
        loss = L.softmax_cross_entropy(lg, labels, cfg_q.vocab)
    return lg[..., :cfg_q.vocab].to(torch.float32), float(loss)


def logit_nmed_pct(logits, ref) -> float:
    """mean |l − ref| / max |ref| in percent: NMED over the logit tensor."""
    l, r = (np.asarray(torch.as_tensor(t).cpu(), np.float64)
            for t in (logits, ref))
    return float(np.abs(l - r).mean() / max(np.abs(r).max(), 1e-12) * 100.0)


def lm_rows(params, cfg, tokens, labels) -> List[Dict]:
    """The lm table of trained ``params``: one row per sweep point (bf16
    first, the reference of d_ppl and logit_nmed)."""
    from repro_torch.eval import runners
    rows: List[Dict] = []
    ref_logits, ref_ppl = None, None
    for label, backend, mult in runners.sweep_points(variants=True):
        lg, loss = eval_point(params, cfg, for_lm(backend, mult), tokens,
                              labels)
        ppl = round(math.exp(loss), 3)
        if label == "bf16":
            ref_logits, ref_ppl = lg, ppl
        rows.append({
            "backend": label,
            "ppl": ppl,
            # delta of the rounded ppls, so that the published columns stay
            # consistent to the displayed digits
            "d_ppl": round(ppl - ref_ppl, 3),
            "logit_nmed": round(logit_nmed_pct(lg, ref_logits), 4),
            **profiles.backend_profile(backend, mult),
        })
    return rows


def run(smoke: bool = False, seed: int = 0, device="cuda") -> Dict:
    """The ``lm`` suite runner (registered in repro_torch.eval.runners)."""
    from repro_torch.eval.runners import _base_config
    dev = resolve_device(device)
    cfg = arch(smoke)
    b = budgets(smoke)
    params, train_loss = train_lm(cfg, b["steps"], b["batch"], b["seq"],
                                  seed, dev)
    eval_toks = synthetic.token_stream(b["eval_seqs"], b["seq"] + 1,
                                       cfg.vocab, seed=seed + 7)
    tokens = torch.as_tensor(eval_toks[:, :-1], device=dev)
    labels = torch.as_tensor(eval_toks[:, 1:], device=dev)
    rows = lm_rows(params, cfg, tokens, labels)
    config = {**_base_config(smoke, seed, dev), "arch": cfg.name,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "d_ff": cfg.d_ff, "vocab": cfg.vocab,
              "act_scale": "per_token", "train_loss": round(train_loss, 4),
              **{k: int(v) for k, v in b.items()}}
    return artifacts.make_artifact("lm", {"lm": rows}, config)
