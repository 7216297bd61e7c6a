"""Host loop of one simulation: chunked round execution with the warmup
snapshot and the ``target_commits`` stop.

The port of the serial path of ``repro.core.sweep``: the chunk runner
(``run_chunk``) is a Python loop that, while ``r < r_end``, runs one step
(after an enqueue-stamp rebase, for the lock-table engine); counters
are read at every chunk
boundary (``chunk_boundaries``), warmup counters are subtracted, and the
run stops at the first boundary where the measured commits reach
``target_commits``. The results equal the reference driver's in every
one of its modes, which are all bit-identical to its serial loop.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.convert import plan_from_numpy
from repro_torch.core.engine import NCAT, EngineConfig, SimResult

# Engine-code version tag of the reference this port reproduces.
ENGINE_VERSION = "4-mega-dispatch"

_SCALARS = ("commits", "aborts_dl", "aborts_ollp", "wasted", "next_txn", "steps")
# Present only in some states; each is cumulative and reported
# warmup-subtracted in ``SimResult.raw`` (see the reference's
# ``_OPT_SCALARS``): pipelined admission (pipe_*), the planner-lane
# model (plan_busy, plan_qdelay, epoch_ctr, plan_busy_int) and the
# overload layer (pol_*).
_OPT_SCALARS = (
    "pipe_adm", "pipe_commits", "plan_busy", "plan_qdelay", "epoch_ctr",
    "plan_busy_int",
    "pol_rejected", "pol_shed", "pol_timedout", "pol_tb_adm",
    "pol_sacrificed", "pol_backoff_rounds",
)
_METRIC_ARRAYS = ("lat_hist", "q_depth", "q_inflight")
_BREAKDOWN_NAMES = ("idle", "exec", "lock", "wait", "deadlock", "msg")


def chunk_boundaries(cfg: EngineConfig):
    """Yield the host-loop chunk boundaries for one simulation budget:
    the ``chunk_rounds`` grid (the last may overshoot ``max_rounds``),
    with one extra boundary at ``warmup_rounds`` when it is off the grid.
    """
    r = 0
    while r < cfg.max_rounds:
        nxt = (r // cfg.chunk_rounds + 1) * cfg.chunk_rounds
        if r < cfg.warmup_rounds < nxt:
            nxt = cfg.warmup_rounds
        yield nxt
        r = nxt


def run_chunk(step, p: dict, state: dict, r_end: int,
              rebase: bool = True) -> dict:
    """Advance ``state`` to round ``r_end``: one step per iteration, each
    after a stamp rebase when ``rebase`` (the lock-table engine), while
    ``r < r_end`` (the host reads ``r`` each step)."""
    r_end_t = torch.tensor(r_end, dtype=torch.int32, device=state["r"].device)
    while int(state["r"]) < r_end:
        if rebase:
            state = engine_lib.rebase_enq(state)
        state = step(p, state, r_end_t)
    return state


def read_counters(state: dict) -> dict[str, np.ndarray]:
    """Device -> host copy of the small counters."""
    keys = _SCALARS + ("cat",) + _METRIC_ARRAYS + tuple(
        k for k in _OPT_SCALARS if k in state)
    return {k: state[k].cpu().numpy().astype(np.int64) for k in keys}


def _zeros_like_counters() -> dict[str, np.ndarray]:
    out = {k: np.zeros((), np.int64) for k in _SCALARS}
    out["cat"] = np.zeros((NCAT,), np.int64)
    return out


def _result(cfg, plan, snap, wsnap, ri, wri, wall) -> SimResult:
    """Assemble the :class:`SimResult` of one cell (the reference's
    ``_GroupRun.finish``)."""
    cm = cfg.cost

    def delta(k):
        return int(snap.get(k, 0)) - int(wsnap.get(k, 0))

    commits = delta("commits")
    meas_rounds = ri - wri
    sim_seconds = meas_rounds * cm.round_seconds
    cat = snap["cat"] - wsnap["cat"]
    total_lane_rounds = max(int(cat.sum()), 1)
    breakdown = {
        nm: float(cat[k]) / total_lane_rounds
        for k, nm in enumerate(_BREAKDOWN_NAMES)
    }
    # goodput split (committed <= admitted <= offered): admitted is the
    # arrival stream's consumption less the queue-side drops, offered
    # the arrival schedule's output over the measured window (0 under
    # closed loop, as in the reference)
    rejected = delta("pol_rejected")
    shed = delta("pol_shed")
    admitted = delta("next_txn") - rejected - shed
    offered = engine_lib.offered_by_round(cfg, plan, ri) - (
        engine_lib.offered_by_round(cfg, plan, wri))
    hist = snap["lat_hist"] - np.asarray(wsnap.get("lat_hist", 0), np.int64)
    qgrid = (
        np.arange(metrics_lib.QDEPTH_SAMPLES, dtype=np.int64) + 1
    ) * engine_lib.qgrid_interval(cfg)
    met = metrics_lib.build_metrics(
        lat_hist=hist,
        q_depth=snap["q_depth"],
        q_inflight=snap["q_inflight"],
        q_grid=qgrid,
        breakdown=breakdown,
        exec_lane_rounds=total_lane_rounds,
        plan_busy_rounds=delta("plan_busy_int"),
        plan_lane_rounds=cfg.n_planner_lanes * meas_rounds,
        committed=commits,
        admitted=admitted,
        offered=offered,
        rejected=rejected,
        shed=shed,
        timedout=delta("pol_timedout"),
        sacrificed=delta("pol_sacrificed"),
    )
    return SimResult(
        commits=commits,
        aborts_deadlock=delta("aborts_dl"),
        aborts_ollp=delta("aborts_ollp"),
        wasted_ops=delta("wasted"),
        rounds=meas_rounds,
        sim_seconds=sim_seconds,
        throughput_txn_s=commits / max(sim_seconds, 1e-12),
        breakdown=breakdown,
        raw=dict(
            total_commits=int(snap["commits"]),
            next_txn=int(snap["next_txn"]),
            rounds_total=ri,
            steps_executed=int(snap["steps"]),
            wall_s_group=round(wall, 3),
            group_cells=1,
            engine_version=ENGINE_VERSION,
            **{k: delta(k) for k in _OPT_SCALARS if k in snap},
        ),
        metrics=met,
    )


def simulate_plans(
    cfg: EngineConfig,
    plans: list,
    *,
    device: torch.device | str | None = None,
) -> list[SimResult]:
    """Run the simulation of one plan on ``device`` (CUDA by default).

    The reference accepts several same-shape plans and drives them as one
    vmapped group; this slice runs exactly one.
    """
    engine_lib.check_ported(cfg)
    if len(plans) != 1:
        raise NotImplementedError(
            "more than one plan per call (the multi-cell sweep) is not "
            "ported yet (slice 8)"
        )
    dev = engine_lib.resolve_device(device)
    plan = plans[0]
    meta = engine_lib.plan_meta(cfg, plan)
    p = plan_from_numpy(engine_lib.plan_device(cfg, plan), dev)
    batch = cfg.is_batch_planned
    if batch:
        state = engine_lib._batch_state0(cfg, plan, cfg.n_slots, dev)
        step = engine_lib.make_batch_step(cfg, meta, dev)
    else:
        state = engine_lib._state0(
            cfg, plan.num_records, cfg.n_slots, meta.max_keys, dev
        )
        step = engine_lib.make_step(cfg, meta, dev)

    t0 = time.time()
    warm, warm_rounds = _zeros_like_counters(), 0
    final, rounds_done, stop = None, 0, None
    for b in chunk_boundaries(cfg):
        state = run_chunk(step, p, state, b, rebase=not batch)
        host = read_counters(state)
        rounds_done, final = b, host
        if b <= cfg.warmup_rounds:
            warm, warm_rounds = host, b
        if host["commits"] - warm["commits"] >= cfg.target_commits:
            stop = (host, warm, b, warm_rounds)
            break
    if final is None:
        final = read_counters(state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    snap, wsnap, ri, wri = stop or (final, warm, rounds_done, warm_rounds)
    return [_result(cfg, plan, snap, wsnap, ri, wri, wall)]
