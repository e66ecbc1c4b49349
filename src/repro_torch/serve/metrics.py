"""Serving metrics: per-request latency timestamps + engine-level summary
(a copy of the JAX package's ``repro.serve.metrics``).

TTFT (time to first token) spans submit -> first emitted token, so it
includes queueing delay — the quantity continuous batching improves over the
drain baseline at mixed loads. Slot occupancy is busy-slot-steps over
slots x decode-steps: the fraction of decode compute that served a live
request rather than a parked slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class RequestTiming:
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def total_s(self) -> Optional[float]:
        if self.submit_t is None or self.done_t is None:
            return None
        return self.done_t - self.submit_t


def summarize(completed, elapsed_s: float, *, n_slots: int,
              decode_steps: int, busy_slot_steps: int, prefills: int,
              waves: int, prefill_tokens: int = 0,
              prefix_hit_tokens: int = 0,
              prefix_stats: Optional[Dict] = None,
              spec: Optional[Dict] = None) -> Dict:
    """Aggregate stats over a finished engine run (flat dict — the
    benchmark writes these rows into the versioned artifact schema).

    ``prefix_hit_rate`` is the fraction of prompt tokens served from the
    paged prefix cache instead of being prefilled: hit_tokens /
    (hit_tokens + prefilled_tokens). 0.0 on an unpaged engine or a fully
    cold workload — the quantity the shared-system-prompt traffic shape
    drives up (every avoided prefill token skips the MAC-densest phase,
    where the approximate-multiplier energy savings are largest).

    ``spec`` is the speculative-decoding summary of the JAX package's
    ``serve.speculative.SpecMetrics`` (None on a non-speculative engine;
    the port has no speculative engine yet):
    verify passes, drafted vs committed token counters, and the
    acceptance-length histogram — hist[a] counts verify outcomes that
    accepted exactly a draft tokens, so committed == accepted + outcomes
    (each outcome also commits the target's own next token).
    """
    new_tokens = sum(len(r.output) for r in completed)
    ttfts = [r.timing.ttft_s for r in completed
             if r.timing.ttft_s is not None]
    reasons: Dict[str, int] = {}
    for r in completed:
        reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
    prompt_tokens = prefix_hit_tokens + prefill_tokens
    return {
        "requests": len(completed),
        "new_tokens": new_tokens,
        "elapsed_s": elapsed_s,
        "tok_per_s": new_tokens / max(elapsed_s, 1e-9),
        "decode_steps": decode_steps,
        "prefills": prefills,
        "prefill_tokens": prefill_tokens,
        "prefix_hit_tokens": prefix_hit_tokens,
        "prefix_hit_rate": prefix_hit_tokens / max(prompt_tokens, 1),
        "prefix_stats": prefix_stats,
        "waves": waves,
        "occupancy": busy_slot_steps / max(decode_steps * n_slots, 1),
        "ttft_ms_mean": (sum(ttfts) / len(ttfts) * 1e3) if ttfts else None,
        "ttft_ms_max": max(ttfts) * 1e3 if ttfts else None,
        "finish_reasons": ",".join(f"{k}:{v}"
                                   for k, v in sorted(reasons.items())),
        **(spec or {}),
    }
