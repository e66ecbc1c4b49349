"""Serve suite: backend-vs-bf16 output parity under mixed continuous
batching with prefix caching, after the JAX package's ``repro.eval.serve``.

Every sweep point drives the continuous-batching engine on a mixed-length
workload (more requests than slots, so the tail is admitted mid-decode
into reused slots; every prompt opens with a shared system prefix, so late
admissions are prefix-cache hits) and is compared with the bf16 serve of
the same workload. Reported per backend:

  solo_match   the probe request (admitted mid-decode on a prefix-cache
               hit) decodes the same tokens served alone on a cold engine
  hit_rate     fraction of prompt tokens served from the paged prefix cache
  match_bf16   % of decoded tokens equal to the bf16 serve (greedy)
  prefix_bf16  mean shared-prefix length with the bf16 serve
  spec_match   re-serving the workload with speculative decoding (K=4,
               approx_stage1 draft) emits this backend's sequential tokens
  spec_accept  mean accepted drafts per verify pass in that serve

On the card the draft runs through approx_stage1's CUDA twin,
approx_stage1_pallas (``spec_config``): its products, and so its drafts,
are approx_stage1's bit for bit, at a fraction of the plain version's
host-bound time.

Params are randomly initialized: the suite measures divergence onset on the
serving path, not task quality (that is the ``lm`` suite's job).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.eval import artifacts
from repro_torch.eval import lm as LM
from repro_torch.models import transformer_lm as TLM
from repro_torch.nn.module import resolve_device
from repro_torch.quant.quantize import for_lm
from repro_torch.serve import Engine, ServeRequest, SpecConfig

# one full page (engine default page_size=8) shared by every prompt, so
# requests admitted after the first retirement hit the prefix cache
SHARED_PREFIX = 8
SPEC = SpecConfig(k=4, draft_backend="approx_stage1")
CUDA_DRAFT = "approx_stage1_pallas"     # bitwise approx_stage1


def spec_config(device) -> SpecConfig:
    """SPEC, its draft on the CUDA twin of approx_stage1 on the card."""
    if torch.device(device).type == "cuda":
        return dataclasses.replace(SPEC, draft_backend=CUDA_DRAFT)
    return SPEC


def workload(vocab: int, smoke: bool, seed: int):
    """Mixed prompt lengths and budgets behind a shared system prefix; more
    requests than slots, so that the last request is admitted mid-decode
    (and, with the prefix published by a retired request, as a cache hit).
    Returns (requests, slots, max_len) with requests = [(rid, prompt,
    max_new), ...]."""
    rng = np.random.default_rng(seed + 11)
    if smoke:
        n_req, slots, max_len = 4, 3, 48
        lens, news = rng.integers(2, 9, n_req), rng.integers(3, 7, n_req)
    else:
        n_req, slots, max_len = 8, 4, 112
        lens, news = rng.integers(4, 25, n_req), rng.integers(8, 17, n_req)
    shared = rng.integers(0, vocab, SHARED_PREFIX).astype(np.int32)
    reqs = [(rid,
             np.concatenate([shared, rng.integers(0, vocab, int(lens[rid]))
                             .astype(np.int32)]),
             int(news[rid])) for rid in range(n_req)]
    return reqs, slots, max_len


def serve_outputs(cfg, params, reqs, slots: int, max_len: int, spec=None,
                  device="cuda") -> Tuple[Dict[int, List[int]], Dict]:
    """Serve ``reqs`` through a continuous engine -> ({rid: tokens},
    stats)."""
    eng = Engine(cfg, params, slots=slots, max_len=max_len, spec=spec,
                 device=device)
    for rid, prompt, max_new in reqs:
        eng.submit(ServeRequest(rid=rid, prompt=prompt, max_new=max_new))
    stats = eng.run()
    return {r.rid: list(r.output) for r in eng.completed}, stats


def _parity(outs: Dict[int, List[int]],
            ref: Dict[int, List[int]]) -> Tuple[float, float]:
    """(token match % vs ref, mean shared-prefix length); (0, 0) on empty
    inputs."""
    total = match = 0
    prefixes = []
    for rid, toks in outs.items():
        rtoks = ref.get(rid, [])
        total += len(rtoks)
        match += sum(a == b for a, b in zip(toks, rtoks))
        p = 0
        for a, b in zip(toks, rtoks):
            if a != b:
                break
            p += 1
        prefixes.append(p)
    return (100.0 * match / max(total, 1),
            sum(prefixes) / max(len(prefixes), 1))


def serve_rows(cfg0, params, reqs, slots: int, max_len: int,
               device="cuda") -> List[Dict]:
    """The serve table of ``params``: one row per sweep point."""
    from repro_torch.eval import runners
    probe = reqs[-1]       # admitted mid-decode (n_req > slots)
    # the bf16 reference serve, computed explicitly
    ref_cfg = dataclasses.replace(cfg0, quant=for_lm("bf16"))
    ref, ref_stats = serve_outputs(ref_cfg, params, reqs, slots, max_len,
                                   device=device)
    rows: List[Dict] = []
    for label, backend, mult in runners.sweep_points(variants=True):
        cfg = dataclasses.replace(cfg0, quant=for_lm(backend, mult))
        if label == "bf16":
            outs, stats = ref, ref_stats
        else:
            outs, stats = serve_outputs(cfg, params, reqs, slots, max_len,
                                        device=device)
        # the probe alone on a COLD engine with the same pool shape: in the
        # batched run it was admitted mid-decode onto a prefix-cache hit
        solo, _ = serve_outputs(cfg, params, [probe], slots, max_len,
                                device=device)
        spec_outs, spec_stats = serve_outputs(cfg, params, reqs, slots,
                                              max_len,
                                              spec=spec_config(device),
                                              device=device)
        match_pct, prefix = _parity(outs, ref)
        rows.append({
            "backend": label,
            "requests": len(reqs),
            "new_tokens": sum(len(t) for t in outs.values()),
            "hit_rate": round(stats["prefix_hit_rate"], 3),
            "solo_match": bool(solo[probe[0]] == outs[probe[0]]),
            "match_bf16": round(match_pct, 2),
            "prefix_bf16": round(prefix, 2),
            "spec_match": bool(spec_outs == outs),
            "spec_accept": round(spec_stats["spec_accept_mean"], 2),
        })
    return rows


def run(smoke: bool = False, seed: int = 0, device="cuda") -> Dict:
    """The ``serve`` suite runner (registered in repro_torch.eval.runners)."""
    from repro_torch.eval.runners import _base_config
    dev = resolve_device(device)
    cfg0 = LM.arch(smoke)
    params = TLM.init(cfg0, torch.Generator().manual_seed(seed), dev)
    reqs, slots, max_len = workload(cfg0.vocab, smoke, seed)
    rows = serve_rows(cfg0, params, reqs, slots, max_len, dev)
    config = {**_base_config(smoke, seed, dev), "arch": cfg0.name,
              "n_layers": cfg0.n_layers, "d_model": cfg0.d_model,
              "vocab": cfg0.vocab, "slots": slots, "max_len": max_len,
              "n_req": len(reqs), "shared_prefix": SHARED_PREFIX,
              "act_scale": "per_token",
              "params": "random-init (parity suite)"}
    return artifacts.make_artifact("serve", {"serve": rows}, config)
