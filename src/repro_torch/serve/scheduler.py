"""Admission planner: the paper's P2 principle applied to serving (the
port's copy of ``repro.serve.scheduler``; numpy only).

Serving contention = concurrent requests competing for KV-cache slots and
batch positions. A dynamic allocator decides per step (locks, retries,
fragmentation — the serving twin of dynamic 2PL). ORTHRUS-style, we instead
*plan*: each request's batch slot and cache pages are assigned at admission,
in canonical (slot, page) order, before any decode step runs. The decode
step then executes a static schedule — no allocation, no retry, no
recompilation (fixed shapes).

OLLP analogue: a request's output length is data-dependent, so admission
uses an *estimate* (`max_new_tokens`); when a sequence finishes early its
slot/pages are released at the next planning boundary — the "estimate was
wrong, re-annotate and continue" move.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32 [prompt_len]
    max_new_tokens: int
    slot: int = -1
    generated: int = 0
    done: bool = False
    output: Optional[list] = None


class AdmissionPlanner:
    """Plans batch slots + cache budget ahead of execution (P2)."""

    def __init__(self, batch_slots: int, cache_len: int):
        self.batch_slots = batch_slots
        self.cache_len = cache_len
        self.free_slots = list(range(batch_slots))[::-1]  # canonical order
        self.active: dict[int, Request] = {}
        self.queue: list[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def plan(self) -> list[Request]:
        """Admit queued requests into free slots, canonical slot order."""
        admitted = []
        while self.queue and self.free_slots:
            req = self.queue[0]
            need = len(req.prompt) + req.max_new_tokens
            if need > self.cache_len:
                req.done = True
                req.output = []
                self.queue.pop(0)
                continue
            req = self.queue.pop(0)
            req.slot = self.free_slots.pop()
            req.output = []
            self.active[req.slot] = req
            admitted.append(req)
        return admitted

    def release(self, slot: int):
        req = self.active.pop(slot, None)
        if req is not None:
            req.done = True
            self.free_slots.append(slot)
            self.free_slots.sort(reverse=True)  # keep canonical order

    @property
    def has_work(self) -> bool:
        return bool(self.active or self.queue)
