"""The plain reference host loop: run a reference plan to the end of its
round budget and report the simulation's counters.

The budget is read as the figures read it: the rounds run in chunks of
``chunk_rounds`` (one more bound at ``warmup_rounds`` when it falls
inside a chunk) up to ``max_rounds``; the counters at the last bound at
or before ``warmup_rounds`` are the warm-up, subtracted from the rest,
and the run stops at the first bound where the commits since the
warm-up reach ``target_commits``. Each step advances the round to the
next one at which a slot can act, never past the chunk's bound.

On a CUDA device one step is captured once as a CUDA graph and
replayed (the step reads nothing on the host); elsewhere it runs
eagerly. Either way the host reads the round after every step.
"""

from __future__ import annotations

import numpy as np
import torch

from simbench.reference import engine
from simbench.reference.plan import BatchPlan

BREAKDOWN = ("idle", "exec", "lock", "wait", "deadlock", "msg")
COUNTERS = ("commits", "aborts_dl", "aborts_ollp", "wasted", "next_txn",
            "steps", "cat", "lat_hist")


def bounds(cfg: engine.Config):
    r = 0
    while r < cfg.max_rounds:
        nxt = (r // cfg.chunk_rounds + 1) * cfg.chunk_rounds
        if r < cfg.warmup_rounds < nxt:
            nxt = cfg.warmup_rounds
        yield nxt
        r = nxt


def _tensors(p: dict, device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
            for k, v in p.items()}


class _Stepper:
    """Advances a state one step at a time; on CUDA by replaying one
    captured step whose output is copied back into the state's
    buffers."""

    def __init__(self, step, p: dict, state: dict, device):
        self.step, self.p, self.state = step, p, state
        self.r_end = torch.zeros((), dtype=torch.int32, device=device)
        self.graph = None
        if device.type != "cuda":
            return
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # a first launch outside the capture
            scratch = {k: v.clone() for k, v in state.items()}
            step(p, scratch, scratch["r"] + 1)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = step(p, self.state, self.r_end)
            for k, v in out.items():
                if v is not self.state[k]:
                    self.state[k].copy_(v)

    def run_to(self, b: int) -> None:
        self.r_end.fill_(b)
        while int(self.state["r"]) < b:
            if self.graph is not None:
                self.graph.replay()
            else:
                self.state = self.step(self.p, self.state, self.r_end)

    def counters(self) -> dict:
        return {k: self.state[k].cpu().numpy().astype(np.int64)
                for k in COUNTERS}

    def close(self) -> None:
        if self.graph is not None:
            self.graph.reset()


def simulate(cfg: engine.Config, plan, device) -> dict:
    """Run ``plan`` (``reference.plan.make_plan``) and return its
    fingerprint (:func:`fingerprint`'s fields)."""
    device = torch.device(device)
    T = cfg.n_slots
    p = _tensors(plan.p, device)
    if isinstance(plan, BatchPlan):
        step = engine.make_batch_step(cfg, plan.meta, device)
        state = engine.batch_state0(cfg, plan, T, device)
    else:
        step = engine.make_step(cfg, plan.meta, device)
        state = engine.state0(cfg, plan.meta.num_records, T,
                              plan.meta.max_keys, device)
    stepper = _Stepper(step, p, state, device)
    warm = {k: np.zeros_like(v) for k, v in stepper.counters().items()}
    warm_r, snap, snap_r = 0, None, 0
    try:
        for b in bounds(cfg):
            stepper.run_to(b)
            snap, snap_r = stepper.counters(), b
            if b <= cfg.warmup_rounds:
                warm, warm_r = snap, b
            if int(snap["commits"] - warm["commits"]) >= cfg.target_commits:
                break
    finally:
        stepper.close()
    return fingerprint(cfg, snap, warm, snap_r, warm_r)


def fingerprint(cfg: engine.Config, snap: dict, warm: dict, r: int,
                warm_r: int) -> dict:
    """Every simulated number a run reports, from the counters at the
    stopping bound and at the warm-up."""
    d = {k: snap[k] - warm[k] for k in COUNTERS}
    commits = int(d["commits"])
    rounds = r - warm_r
    sim_seconds = rounds * cfg.cost.round_seconds
    cat = d["cat"]
    lane_rounds = max(int(cat.sum()), 1)
    fp = dict(
        commits=commits,
        aborts_deadlock=int(d["aborts_dl"]),
        aborts_ollp=int(d["aborts_ollp"]),
        wasted_ops=int(d["wasted"]),
        rounds=rounds,
        sim_seconds=sim_seconds,
        throughput_txn_s=commits / max(sim_seconds, 1e-12),
        total_commits=int(snap["commits"]),
        next_txn=int(snap["next_txn"]),
        rounds_total=r,
        steps_executed=int(snap["steps"]),
    )
    for k, name in enumerate(BREAKDOWN):
        fp[f"breakdown.{name}"] = float(cat[k]) / lane_rounds
    for k, v in enumerate(d["lat_hist"]):
        fp[f"lat_hist.{k}"] = int(v)
    return fp
