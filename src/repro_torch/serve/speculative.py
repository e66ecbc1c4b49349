"""Draft-model speculative decoding, after the JAX package's
``repro.serve.speculative``.

The decode loop's latency is one full model pass per token. Speculation
amortizes it: a cheap *draft* model proposes K-1 greedy continuations per
slot, the *target* model scores the whole (slots, K) window in ONE batched
:func:`models.transformer_lm.verify_step` pass, and the engine commits the
longest prefix where draft and target agree plus the target's own next
token: between 1 and K tokens per pass.

The contract: served tokens equal sequential decode's. It holds because

  * verify logits row j equals the j-th sequential decode's row: per-token
    activation scales make every int8 code and integer accumulator
    row-local, and the float work around them computes each row alone
    (what is claimed bitwise, per backend and device, is in PERF.md);
  * emission samples row j with the committed-token step counter
    (serve/sampling.py), so sampled streams advance identically with
    speculation on or off;
  * acceptance stops at the first draft/emission disagreement, and the
    rejected suffix is erased by
    :func:`models.transformer_lm.rollback_positions`, so each pool row ends
    in the state sequential decode would have left (zeros past the
    frontier, the ``init_cache`` state).

The draft is either the same parameters on a cheaper registered backend
(``SpecConfig(draft_backend='approx_stage1')``) or a smaller registered
config with its own parameters (``draft_cfg=`` / ``Engine(draft_params=)``).
It keeps its own slot pool on the engine's device and always cold-prefills
the full prompt at admission: accepted drafts equal target tokens, so after
rollback its pool is "the draft ran over the true stream"; a wrong draft
can only shorten acceptance, never change output.

Speculation is gated to position-indexed cache layouts (the
``padded_prefill_ok`` predicate that gates paging): SSM states fold tokens
in irreversibly and windowed ring buffers alias positions. PyTorch runs
eagerly, so the reference's compiled-function caches have no counterpart;
the caches are written in place, and the draft's pool is its own.

Over a mesh (the engine's ``mesh=``) the draft runs through a
``serve.engine.MeshPlan`` of its own config, as the reference's draft runs
through its own ``mesh_compiled_fns``: the draft pool is sharded like the
target's, each draft step gathers the params and runs on the rank's slot
rows, and the proposals come from the gathered logits, so every rank
proposes the same window. A draft on the target's architecture shares the
engine's parameter shards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer_lm as TLM
from repro_torch.models.transformer_lm import ArchConfig
from repro_torch.quant.quantize import for_lm


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Engine-level speculative-decoding configuration.

    k              verify window width = max tokens committed per pass
                   (k-1 draft proposals + the target's own next token);
                   k=1 degenerates to sequential decode through the verify
                   path.
    draft_backend  registry backend the draft runs on ('bf16' or any
                   ``quant.matmul.list_backends()`` name). Ignored when
                   draft_cfg pins a full config.
    draft_cfg      optional smaller ArchConfig for the draft (its own
                   params go in ``Engine(draft_params=)``); None drafts with
                   the target architecture + draft_backend.

    Per-request override: ``ServeRequest.spec_k`` caps how many drafts that
    request accepts per pass (0 = sequential for that request; None = the
    engine window). The verify window stays k wide.
    """
    k: int = 4
    draft_backend: str = "bf16"
    draft_cfg: Optional[ArchConfig] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")

    def draft_arch(self, target_cfg: ArchConfig) -> ArchConfig:
        """The draft's ArchConfig: explicit draft_cfg, or the target
        architecture re-quantized onto draft_backend."""
        if self.draft_cfg is not None:
            return self.draft_cfg
        return dataclasses.replace(target_cfg,
                                   quant=for_lm(self.draft_backend))


class SpecMetrics:
    """Acceptance bookkeeping for one engine run.

    hist[a] counts verify outcomes that accepted exactly ``a`` draft
    tokens, a in [0, k-1]. Committed tokens per outcome are always
    accepted + 1 (the target's own token rides along even when every draft
    is rejected)."""

    def __init__(self, k: int):
        self.k = k
        self.passes = 0               # verify_step calls
        self.drafted = 0              # draft tokens offered to slots
        self.committed = 0            # tokens emitted from verify passes
        self.hist = [0] * k           # accepted-draft count per outcome

    def record(self, drafted: int, committed: int) -> None:
        accepted = committed - 1
        self.drafted += drafted
        self.committed += committed
        self.hist[min(accepted, self.k - 1)] += 1

    def summary(self) -> Dict:
        outcomes = sum(self.hist)
        accepted = sum(a * n for a, n in enumerate(self.hist))
        return {
            "spec_passes": self.passes,
            "spec_drafted": self.drafted,
            "spec_committed": self.committed,
            "spec_accept_hist": list(self.hist),
            "spec_accept_mean": accepted / max(outcomes, 1),
            "spec_accept_rate": accepted / max(self.drafted, 1),
        }


class Speculator:
    """The engine's draft half: a second slot pool on the engine's device
    and the acceptance metrics. The Engine drives it: ``admit`` at prefill,
    ``propose`` before each verify pass, ``advance`` on plain fallback steps
    (so the draft pool never falls behind the frontier), ``rollback`` after
    acceptance."""

    def __init__(self, spec: SpecConfig, target_cfg: ArchConfig, params,
                 draft_params, *, slots: int, max_len: int, cache_dtype,
                 device, mesh=None, rules=None):
        """``params`` are the engine's (its shards over a mesh);
        ``draft_params`` the draft config's own, full, or None."""
        self.spec = spec
        self.cfg = spec.draft_arch(target_cfg)
        TLM.require_position_indexed(target_cfg)
        TLM.require_position_indexed(self.cfg)
        if spec.draft_cfg is not None and draft_params is None:
            raise ValueError("SpecConfig.draft_cfg set but no draft_params "
                             "given to the Engine")
        self.slots, self.max_len = slots, max_len
        self.device = device
        self._cache_dtype = cache_dtype
        self.plan = None
        if mesh is not None:
            from repro_torch.serve.engine import MeshPlan
            self.plan = MeshPlan(self.cfg, mesh, rules, slots=slots,
                                 max_len=max_len, cache_dtype=cache_dtype,
                                 device=device)
            self.params = (params if draft_params is None
                           else self.plan.shard_params(draft_params))
            self.pool = self.plan.init_pool()
        else:
            self.params = params if draft_params is None else draft_params
            self.pool = TLM.init_cache(self.cfg, slots, max_len,
                                       cache_dtype, device)
        self.metrics = SpecMetrics(spec.k)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _decode(self, tok: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        if self.plan is not None:
            return self.plan.decode(self.params, self.pool, self._tensor(tok),
                                    self._tensor(pos))[0]
        logits, _ = TLM.decode_step(self.params, self._tensor(tok),
                                    self._tensor(pos), self.cfg, self.pool)
        return logits

    # ---- admission: cold draft prefill of the full prompt ---------------
    def admit(self, slot: int, prompt: np.ndarray, bucket_fn) -> None:
        """Prefill the draft pool row for a freshly admitted request:
        always the FULL prompt from position 0 into a fresh row (the draft
        never reads the paged prefix store), then a full-row copy, so the
        slot keeps nothing of its previous occupant."""
        plen = len(prompt)
        toks = np.zeros((1, bucket_fn(plen, 0)), np.int32)
        toks[0, :plen] = prompt
        fresh = TLM.init_cache(self.cfg, 1, self.max_len, self._cache_dtype,
                               self.device)
        if self.plan is not None:
            self.plan.prefill(self.params, self._tensor(toks), fresh,
                              self._tensor([plen]), 0)
            self.plan.write_slot(self.pool, fresh, slot)
            return
        TLM.prefill(self.params, self._tensor(toks), self.cfg, fresh,
                    lengths=self._tensor([plen]), pos_offset=0)
        TLM.write_slot(self.pool, fresh, slot)

    # ---- the draft phase -------------------------------------------------
    def propose(self, tok: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """K greedy draft steps over the whole pool -> (slots, K) window.

        window[:, 0] is the committed next-input token; window[:, j] for
        j >= 1 is the draft's greedy proposal after consuming
        window[:, :j]. Runs K single-token decodes (not K-1): the last step
        feeds window[:, K-1] so that the draft pool holds KV for every
        window position (a full accept advances the frontier K tokens); its
        logits are discarded."""
        k = self.spec.k
        win = np.zeros((self.slots, k), np.int32)
        win[:, 0] = tok
        dpos = pos.copy()
        for j in range(1, k):
            logits = self._decode(win[:, j - 1:j], dpos)
            win[:, j] = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            dpos += 1
        self._decode(win[:, k - 1:k], dpos)
        return win

    def advance(self, tok: np.ndarray, pos: np.ndarray) -> None:
        """One width-1 draft step mirroring a plain engine decode step (the
        near-ceiling fallback), so the draft pool tracks the true stream."""
        self._decode(tok[:, None], pos)

    def rollback(self, start: np.ndarray, stop: np.ndarray) -> None:
        """Erase draft KV at positions [start[s], stop[s]) per slot."""
        if self.plan is not None:
            self.plan.rollback(self.pool, start, stop)
        else:
            TLM.rollback_positions(self.pool, start, stop)


def acceptance(window_row: np.ndarray, emitted: List[int]) -> int:
    """Accepted-draft count for one slot's outcome: the length of the
    leading run where emission j matched the draft it was verified against
    (committed == acceptance + 1)."""
    a = 0
    for j, tok in enumerate(emitted[:-1]):
        if j + 1 < len(window_row) and tok == window_row[j + 1]:
            a += 1
        else:
            break
    return a
