"""Continuous-batching serving engine (the JAX package's ``repro.serve``).

Public surface:
  Engine, ServeRequest, FINISH_REASONS   — the serving loop (engine.py)
  SamplingConfig, GREEDY, sample_token   — per-request sampling (sampling.py)
  SlotScheduler                          — admission + slot free-list
  PagePool, PrefixCache                  — refcounted page ids + radix
                                           prefix cache (paging.py)
  padded_prefill_ok                      — the paging / padding predicate

``python -m repro_torch.serve`` serves a request queue from the command
line (__main__.py). Speculative decoding and the sharded engine are later
slices of the port.
"""
from repro_torch.serve.engine import (Engine, FINISH_REASONS, ServeRequest,
                                      padded_prefill_ok)
from repro_torch.serve.paging import PagePool, PrefixCache
from repro_torch.serve.sampling import GREEDY, SamplingConfig, sample_token
from repro_torch.serve.scheduler import SlotScheduler

__all__ = ["Engine", "ServeRequest", "FINISH_REASONS", "SamplingConfig",
           "GREEDY", "sample_token", "SlotScheduler", "PagePool",
           "PrefixCache", "padded_prefill_ok"]
