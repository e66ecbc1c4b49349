"""Batch-synchronous serving baseline over the continuous-batching engine,
after the JAX package's ``repro.train.serve_loop``.

``Server`` is ``repro_torch.serve.Engine`` run under the 'drain' admission
policy: admit a full batch, decode until every request in the wave
finishes, only then admit the next wave: the baseline that continuous
batching is compared against. It takes no mesh: ``Engine(mesh=)`` serves
over one directly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.models.transformer_lm import ArchConfig
from repro_torch.serve import Engine, ServeRequest


class Server:
    """Single-device batch-synchronous server (drain policy)."""

    def __init__(self, cfg: ArchConfig, params, batch_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 device="cuda"):
        self.engine = Engine(cfg, params, slots=batch_slots,
                             max_len=max_len, eos_id=eos_id,
                             admission="drain", device=device)

    @property
    def completed(self):
        return self.engine.completed

    def submit(self, req: ServeRequest) -> None:
        self.engine.submit(req)

    def run(self) -> Dict[str, Any]:
        stats = self.engine.run()
        stats["batches"] = stats["waves"]   # historical key
        return stats
