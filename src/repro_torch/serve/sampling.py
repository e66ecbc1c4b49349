"""Per-request sampling for the serving engine.

Every draw is keyed by (seed, rid, step) alone — never by batch composition
or slot index — so sampled requests keep the batching-invariance contract
of greedy ones: a request decodes the same tokens whether it is served
alone, in a full batch, or admitted mid-decode into a reused slot.
``step`` is the request's committed-token counter (len(req.output) at the
moment of the draw).

Greedy is a host argmax with the JAX package's first-max tie-break, so
greedy streams can match the reference's token for token. The random
draws come from a ``torch.Generator`` seeded from (seed, rid, step) through
numpy's ``SeedSequence``: the same invariance signature as the reference's
``stream_key``, but not its numbers — JAX's PRNG is another, so the port's
sampled streams differ from the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

KINDS = ("greedy", "temperature", "top_k")


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    kind: str = "greedy"            # 'greedy' | 'temperature' | 'top_k'
    temperature: float = 1.0
    top_k: int = 0                  # used when kind == 'top_k'
    seed: int = 0

    def __post_init__(self):
        # an invalid temperature must not silently turn into near-argmax;
        # greedy ignores temperature
        if self.kind in ("temperature", "top_k") and self.temperature <= 0:
            raise ValueError(
                f"kind={self.kind!r} requires temperature > 0, got "
                f"{self.temperature} (use kind='greedy' for argmax)")


GREEDY = SamplingConfig()


def stream_generator(seed: int, rid: int, step: int) -> torch.Generator:
    """The generator for one draw of request ``rid``'s sampling stream at
    committed-token index ``step``: a pure function of (seed, rid, step)."""
    state = np.random.SeedSequence([seed, rid, step]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def _categorical(logits: np.ndarray, gen: torch.Generator) -> int:
    """One index drawn with probabilities softmax(logits) (Gumbel-max, in
    float64; -inf entries are never drawn)."""
    u = torch.rand(logits.shape[-1], generator=gen,
                   dtype=torch.float64).numpy()
    u = np.clip(u, np.finfo(np.float64).tiny, 1.0)
    return int(np.argmax(logits.astype(np.float64) - np.log(-np.log(u))))


def sample_token(logits, scfg: SamplingConfig, rid: int, step: int) -> int:
    """One token id from a (V,) logits row (a numpy array or a tensor,
    pulled to the host)."""
    if scfg.kind not in KINDS:
        raise ValueError(f"unknown sampling kind {scfg.kind!r}; "
                         f"one of {KINDS}")
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().to(torch.float32).cpu().numpy()
    logits = np.asarray(logits)
    if scfg.kind == "greedy":
        return int(np.argmax(logits))        # first max on ties
    with np.errstate(over="ignore"):        # masked entries -> -inf
        scaled = logits.astype(np.float32) / np.float32(scfg.temperature)
    gen = stream_generator(scfg.seed, rid, step)
    if scfg.kind == "top_k":
        if scfg.top_k < 1:
            raise ValueError("kind='top_k' requires top_k >= 1")
        k = min(scfg.top_k, scaled.shape[-1])
        # exactly k candidates, ties at the k-th value broken by index
        # order (lax.top_k's rule): a threshold keep (scaled >= kth) would
        # keep every tied logit and sample from more than k
        idx = np.argsort(-scaled, kind="stable")[:k]
        return int(idx[_categorical(scaled[idx], gen)])
    return _categorical(scaled, gen)
