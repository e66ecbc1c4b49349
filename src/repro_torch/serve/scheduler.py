"""Slot scheduler for the continuous-batching engine (pure Python; a copy
of the JAX package's ``repro.serve.scheduler``).

Request lifecycle:  QUEUED --admit--> RUNNING --release--> FINISHED.
Slots live in a free-list; admission is strictly FIFO over the queue, so no
request can be starved (tested property — tests/test_torch_serve.py drives
this class with random arrival orders through the hypothesis shim).

Two admission policies:

  'continuous'  admit whenever a slot is free — freed slots are refilled
                mid-decode (the engine's default)
  'drain'       admit only when *every* slot is free — the batch-synchronous
                baseline, which leaves slots
                idle until the slowest request of a wave finishes

The scheduler never touches a tensor: it moves opaque items between queue, slots
and the completed count, which is what lets the property tests simulate
thousands of arrival orders without compiling a model.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Dict, List, Tuple

POLICIES = ("continuous", "drain")


class SlotScheduler:
    def __init__(self, n_slots: int, policy: str = "continuous"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.n_slots = n_slots
        self.policy = policy
        # min-heap so the lowest-numbered free slot is handed out first —
        # deterministic slot assignment makes slot-reuse and prefix-cache
        # page-layout tests exact (O(log n) per release, no re-sort)
        self._free: List[int] = list(range(n_slots))
        self._queue: deque = deque()
        self._running: Dict[int, Any] = {}
        self.submitted = 0
        self.completed = 0
        self.waves = 0          # admission events ('batches' of the drain
        #                         policy; admission bursts of continuous)

    # ---- state -----------------------------------------------------------
    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def running(self) -> int:
        return len(self._running)

    @property
    def idle(self) -> bool:
        """Nothing queued and nothing running."""
        return not self._queue and not self._running

    def occupied(self) -> List[int]:
        """Slots currently running a request (sorted)."""
        return sorted(self._running)

    def item(self, slot: int):
        return self._running[slot]

    # ---- transitions -----------------------------------------------------
    def submit(self, item) -> None:
        self._queue.append(item)
        self.submitted += 1

    def admit(self) -> List[Tuple[int, Any]]:
        """(slot, item) assignments admissible right now, FIFO order.

        'continuous' fills every free slot; 'drain' only starts a new wave
        once the pool is completely empty."""
        if self.policy == "drain" and self._running:
            return []
        out: List[Tuple[int, Any]] = []
        while self._free and self._queue:
            slot = heapq.heappop(self._free)
            item = self._queue.popleft()
            self._running[slot] = item
            out.append((slot, item))
        if out:
            self.waves += 1
        return out

    def release(self, slot: int):
        """Finish the request occupying `slot`; the slot returns to the
        free-list (lowest-numbered slots are reused first)."""
        item = self._running.pop(slot)          # KeyError = engine bug
        heapq.heappush(self._free, slot)
        self.completed += 1
        return item
