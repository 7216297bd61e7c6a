#!/usr/bin/env python3
"""Dense per-round replay of one cell of the PyTorch port + Chrome trace
export: the port of ``tools/trace_export.py``, with the same output.

Two consumers:

  * the latency oracle (``tests/test_torch_trace_export.py`` on the CPU,
    ``chip_smoke.py``'s phase 14 on the card): :func:`replay_dense`
    re-runs a cell one round at a time (the cached chunk runner of
    ``repro_torch.core.sweep`` called with ``r_end = r + 1``, so event
    leaps clamp to single rounds; on a card one CUDA-graph replay per
    round) and :func:`txn_events` recovers every transaction's exact
    ``(tid, arrive_round, commit_round)`` from consecutive slot-matrix
    snapshots. Per-txn latencies computed from observed state
    transitions, independent of the engine's carried histogram, pin the
    in-round log-bucket scatter and the host-side percentile extraction.
  * ``chrome://tracing`` / Perfetto: :func:`chrome_trace` turns the same
    snapshots into trace-event JSON: one duration event per (slot,
    transaction, phase) span plus an in-flight counter track, so
    individual grant/wait/abort/commit timelines are inspectable.

Commit detection (non-batch slot layout): a committing slot releases to
EMPTY with ``tid = -1`` at the end of its commit round, and admission
(stage 1 of the round) can never refill a slot in the same round it
commits, so a commit is exactly a snapshot-to-snapshot transition from
``tid >= 0`` to a different tid. The commit round is the round the step
executed (the earlier snapshot's ``r``), matching the engine's
``lat = r - arrive`` convention. Batch-planned cells interleave
fragment rows and are not supported by the event extractor. The replay
reads the packed layout's slot matrix (``state_layout="packed"``).

Usage (on a card by default; ``--device cpu`` on the CPU):
    PYTHONPATH=src python tools/torch_trace_export.py \\
        --protocol deadlock_free --num-txns 512 --num-hot 16 \\
        --rounds 1500 --out trace.json --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np

PHASE_NAMES = (
    "empty", "init", "acq", "msg", "ready", "exec", "rel", "backoff",
)


def replay_dense(cfg, workload, device=None):
    """Run ``cfg`` on ``workload`` one round at a time on ``device``
    (CUDA by default).

    Returns ``(snaps, state)`` where ``snaps[i]`` is the [SLOT_F, T]
    slot matrix after ``i`` rounds (``snaps[0]`` is the initial state),
    as numpy, and ``state`` is the final engine state as numpy arrays in
    the reference's shapes (``convert.state_to_numpy``). Uses the same
    cached chunk runner as the sweep driver (only the chunk bound
    differs), so the replayed trajectory is bit-identical to a normal
    run's.
    """
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import sweep as sweep_lib
    from repro_torch.core.convert import plan_from_numpy, state_to_numpy

    dev = engine_lib.resolve_device(device)
    plan = engine_lib.make_plan(cfg, workload)
    meta = engine_lib.plan_meta(cfg, plan)
    p = plan_from_numpy(engine_lib.plan_device(cfg, plan), dev)
    state = sweep_lib._initial_state(cfg, plan, meta, dev)
    runner = sweep_lib.get_runner(cfg, meta, dev)

    snaps = [state["slots"].cpu().numpy().copy()]
    for r in range(cfg.max_rounds):
        state = runner(p, state, r + 1)
        snaps.append(state["slots"].cpu().numpy().copy())
    return snaps, state_to_numpy(state)


def txn_events(snaps) -> list[tuple[int, int, int]]:
    """Exact per-txn ``(tid, arrive_round, commit_round)`` events from
    dense snapshots of a *non-batch* cell (see module docstring)."""
    from repro_torch.core.engine import C_ARRIVE, C_TID

    events = []
    for r in range(len(snaps) - 1):
        prev, cur = snaps[r], snaps[r + 1]
        com = (prev[C_TID] >= 0) & (cur[C_TID] != prev[C_TID])
        for t in np.nonzero(com)[0]:
            events.append(
                (int(prev[C_TID, t]), int(prev[C_ARRIVE, t]), r)
            )
    return events


def chrome_trace(snaps, cfg) -> list[dict]:
    """Trace-event JSON records (Chrome ``chrome://tracing`` / Perfetto
    format) for the replayed cell: per-slot phase spans + an in-flight
    counter. Timestamps are microseconds of simulated time.

    Works on both slot layouts: the phase enum is shared, only the row
    indices differ ([SLOT_F, T] vs the batch-planned [BATCH_SLOT_F, T]
    matrix). Batch rows are fragment-granular under ``fragment_exec``,
    so a span's ``txn`` is the schedulable unit, not always a whole
    transaction."""
    if cfg.is_batch_planned:
        from repro_torch.core.engine import BC_PHASE as C_PHASE
        from repro_torch.core.engine import BC_TID as C_TID
    else:
        from repro_torch.core.engine import C_PHASE, C_TID

    us = cfg.cost.round_seconds * 1e6
    T = snaps[0].shape[1]
    events = []
    # coalesce consecutive rounds with unchanged (tid, phase) per slot
    for slot in range(T):
        start, cur_tid, cur_ph = 0, int(snaps[0][C_TID, slot]), int(
            snaps[0][C_PHASE, slot]
        )
        for r in range(1, len(snaps) + 1):
            nxt = (
                (int(snaps[r][C_TID, slot]), int(snaps[r][C_PHASE, slot]))
                if r < len(snaps)
                else None
            )
            if nxt == (cur_tid, cur_ph):
                continue
            if cur_tid >= 0:
                events.append(dict(
                    name=f"txn{cur_tid}:{PHASE_NAMES[cur_ph]}",
                    cat="slot", ph="X", pid=0, tid=slot,
                    ts=round(start * us, 3),
                    dur=round((r - start) * us, 3),
                    args=dict(txn=cur_tid, phase=PHASE_NAMES[cur_ph],
                              rounds=r - start),
                ))
            if nxt is None:
                break
            start, (cur_tid, cur_ph) = r, nxt
    for r, snap in enumerate(snaps):
        events.append(dict(
            name="inflight", ph="C", pid=0, ts=round(r * us, 3),
            args=dict(inflight=int((snap[C_TID] >= 0).sum())),
        ))
    return events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocol", default="deadlock_free")
    ap.add_argument("--num-txns", type=int, default=512)
    ap.add_argument("--num-hot", type=int, default=16)
    ap.add_argument("--num-records", type=int, default=10_000)
    ap.add_argument("--n-exec", type=int, default=8)
    ap.add_argument("--window", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=1500)
    ap.add_argument("--epoch-interval-rounds", type=int, default=0)
    ap.add_argument("--out", default="trace.json")
    ap.add_argument("--device", default="cuda",
                    help="device the replay runs on (cuda or cpu)")
    args = ap.parse_args(argv)

    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.workloads import WorkloadConfig, make_workload

    wl = make_workload(WorkloadConfig(
        kind="ycsb", num_txns=args.num_txns, num_records=args.num_records,
        num_hot=args.num_hot, seed=0,
    ))
    cfg = EngineConfig(
        protocol=args.protocol, n_exec=args.n_exec, window=args.window,
        epoch_interval_rounds=args.epoch_interval_rounds,
        max_rounds=args.rounds, warmup_rounds=0, chunk_rounds=args.rounds,
        target_commits=10**9,
    )
    snaps, _state = replay_dense(cfg, wl, device=args.device)
    events = chrome_trace(snaps, cfg)
    with open(args.out, "w") as f:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms"), f)
    n_commits = len(txn_events(snaps)) if not cfg.is_batch_planned else -1
    print(f"{args.out}: {len(events)} events, {n_commits} commits, "
          f"{args.rounds} rounds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
