"""Transaction access planning (paper §3.2): the P2 design principle.

A *plan* fixes, ahead of execution, the set of locks a transaction will
request and the canonical order in which it requests them:

  - ``plan_dynamic``        — no planning; acquisition order is the program
                              order (contended records first, as in the
                              paper's experiments). Used by the 2PL baselines.
  - ``plan_sorted``         — Deadlock-free locking: lexicographic key order
                              (paper: "acquires locks in the lexicographical
                              order in advance of transaction execution").
  - ``plan_orthrus``        — ORTHRUS: order by (CC-lane id, key) so a txn
                              visits concurrency-control lanes in ascending
                              lane order; the engine forwards the request
                              CC_i -> CC_{i+1} (N_cc + 1 messages, §3.3).
  - ``plan_partition_store``— H-Store baseline: the lock set becomes the set
                              of *partition* locks, sorted (coarse-grain CC).
  - ``plan_dgcc``           — DGCC: batch-level planning; per batch the
                              planner builds the transaction conflict graph
                              (last-writer chains per key) and wavefront
                              levels; execution is lock-free (dependency
                              checks only).
  - ``plan_quecc``          — QueCC: batch-level planning; per batch the
                              planner materializes one totally-ordered
                              execution queue per CC lane with intra-batch
                              dependency stamps; execution is lock-free.
  - ``plan_scheduled``      — Scheduled (Prasaad et al.): per batch a
                              union-find clusterer chains each conflict-
                              connected component in admission order; no
                              wavefronts, no queues, no lock table —
                              scheduling, not planning.

Deadlock freedom of the sorted plans is structural: a transaction never
waits on lock j while holding a lock that sorts after j, so the waits-for
relation embeds in a total order and is acyclic. ``tests/test_core_engine``
property-tests this claim.

OLLP (Thomson et al. [44], paper §3.2): for transactions whose access set is
data-dependent (TPC-C Payment by customer last name), the workload marks the
txn as requiring reconnaissance. The engine charges the reconnaissance read
ahead of admission and, when the (rare, configurable) estimate is wrong,
aborts the first attempt and retries with the corrected annotation — exactly
the paper's mechanism. The *planner* sees only the estimated set; the keys in
the retry are the corrected ones (same array — the estimate error is modeled
by the ``ollp_miss`` flag, not by divergent keys, which keeps the lock
footprint faithful while exercising the abort path).

Module contract
---------------
Planning is **host-side numpy** and runs once per (config, workload) cell,
before anything is traced: a :class:`Plan` is a set of engine-ready arrays
(plus, for dgcc/quecc, a ``depgraph.BatchSchedule``). The engine turns a
Plan into *traced* device arrays via ``engine.plan_device`` — so two cells
whose Plans share shapes (``engine.plan_meta``) reuse one compiled runner,
and nothing in this module can invalidate a compile cache entry. What this
module computes is protocol *semantics* (acquisition order, batch
schedules); what it never computes is *cost* — planning-cost charging
(the pipelined latency, and the planner-lane throughput model's
conflict-graph-scaled work) lives in ``engine._batch_plan_rounds`` /
``engine._planner_work_rounds`` over the schedule built here. The
``epoch_txns`` stamp (set by ``engine.make_plan``) only feeds the
open-arrival schedule; it does not alter any planned order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import depgraph as depgraph_lib
from repro_torch.core.lockgrant import KEY_SENTINEL
from repro_torch.core.workloads import MODE_WRITE, Workload


@dataclasses.dataclass
class Plan:
    """Planned (reordered) lock arrays, engine-ready."""

    keys: np.ndarray  # int32[N, K], KEY_SENTINEL padded
    modes: np.ndarray  # int32[N, K]
    part: np.ndarray  # int32[N, K]
    nkeys: np.ndarray  # int32[N]
    exec_ops: np.ndarray  # int32[N]
    ollp: np.ndarray
    ollp_miss: np.ndarray
    num_records: int
    # H-Store routing: lane_stream[l] = txn indices homed to worker lane l
    # (partitioned-store executes a txn on its home partition's worker, so
    # single-partition spinlocks stay core-local).
    lane_stream: np.ndarray | None = None
    # Batch-planned protocols (dgcc / quecc): the per-batch dependency
    # schedule (conflict graph + wavefront levels, or per-lane queues).
    sched: depgraph_lib.BatchSchedule | None = None
    # Transactions per epoch (= WorkloadConfig.batch_epoch, stamped by
    # ``engine.make_plan``): the open-arrival model
    # (``EngineConfig.epoch_interval_rounds``) releases the workload in
    # epoch-sized slices for the non-batch protocols too.
    epoch_txns: int = 0


def _reorder(w: Workload, order: np.ndarray) -> Plan:
    def take(a):
        return np.take_along_axis(a, order, axis=1)

    return Plan(
        keys=take(w.keys),
        modes=take(w.modes),
        part=take(w.part),
        nkeys=w.nkeys,
        exec_ops=w.exec_ops,
        ollp=w.ollp,
        ollp_miss=w.ollp_miss,
        num_records=w.num_records,
    )


def plan_dynamic(w: Workload) -> Plan:
    """Program order (no planning). Sentinel-padded tail stays last.

    Dynamic 2PL needs no access analysis, so OLLP reconnaissance/miss flags
    are cleared (the paper's 2PL baselines read secondary indexes inline).
    """
    n, k = w.keys.shape
    p = _reorder(w, np.broadcast_to(np.arange(k), (n, k)).copy())
    p.ollp = np.zeros(n, bool)
    p.ollp_miss = np.zeros(n, bool)
    return p


def plan_sorted(w: Workload) -> Plan:
    """Canonical lexicographic order over record keys (deadlock-free)."""
    order = np.argsort(w.keys, axis=1, kind="stable")
    return _reorder(w, order)


def plan_orthrus(w: Workload, n_cc: int) -> Plan:
    """Order by (CC lane, key); CC lane of a key is part % n_cc."""
    cc = w.part.astype(np.int64) % n_cc
    cc = np.where(w.keys == KEY_SENTINEL, np.iinfo(np.int32).max, cc)
    composite = cc * (1 << 32) + w.keys.astype(np.int64)
    order = np.argsort(composite, axis=1, kind="stable")
    return _reorder(w, order)


def plan_dgcc(
    w: Workload, batch_epoch: int, *, n_lanes: int = 1,
    fragments: bool = False,
) -> Plan:
    """DGCC: batch dependency-graph planning over the program-order batch.

    Execution acquires no locks, so key order inside a transaction is
    irrelevant; the schedule fixes the serial order (= submission order)
    and the conflict-graph wavefronts. OLLP reconnaissance stays charged
    (the planner must know the full access set to build the graph), but
    estimate misses never reach execution: the planner corrects the graph
    before the batch is released, so ``ollp_miss`` is cleared.

    ``fragments=True`` additionally emits the fragment-granular schedule
    (one fragment per (txn, planner lane), lane = ``part % n_lanes``):
    the engine then schedules fragments independently and joins them at
    commit, so one hot record serializes only the fragments that touch
    its lane, not whole transactions.
    """
    n, k = w.keys.shape
    p = _reorder(w, np.broadcast_to(np.arange(k), (n, k)).copy())
    p.ollp_miss = np.zeros(n, bool)
    p.sched = depgraph_lib.build_schedule(
        p.keys, p.modes, p.part, p.nkeys, batch_epoch, kind="conflict",
        n_lanes=n_lanes, fragments=fragments,
    )
    return p


def plan_scheduled(w: Workload, batch_epoch: int, *, n_lanes: int = 1) -> Plan:
    """Scheduled family (Prasaad et al., arXiv 1810.01997): cluster, don't
    plan.

    Per batch, a union-find clusterer groups transactions into
    conflict-connected components over the record-level conflict edges
    and serializes each component as one admission-order chain
    (``depgraph.build_schedule(kind="cluster")``); components map to
    execution lanes round-robin (``cluster % n_lanes``, ``n_lanes`` =
    the engine's exec-lane count). No wavefront levels, no per-lane
    queue materialization, no lock table — the only dependency any
    transaction carries is its cluster's previous member, which is what
    makes scheduling cheaper than full planning
    (``CostModel.scheduler_batch_cycles`` vs ``planner_batch_cycles``).

    Like dgcc, the clusterer needs the full access set, so OLLP
    reconnaissance stays charged but estimate misses never reach
    execution (the cluster is corrected before the batch releases).
    """
    n, k = w.keys.shape
    p = _reorder(w, np.broadcast_to(np.arange(k), (n, k)).copy())
    p.ollp_miss = np.zeros(n, bool)
    p.sched = depgraph_lib.build_schedule(
        p.keys, p.modes, p.part, p.nkeys, batch_epoch, kind="cluster",
        n_lanes=n_lanes,
    )
    return p


def plan_quecc(
    w: Workload, n_cc: int, batch_epoch: int, *, fragments: bool = False,
) -> Plan:
    """QueCC: per-CC-lane execution queues with dependency stamps.

    CC lane of a key is ``part % n_cc`` (as in ORTHRUS); per batch each
    lane's queue is totally ordered by submission order. Txn granularity
    chains whole transactions (a transaction depends on its predecessor
    in every queue it appears in); ``fragments=True`` chains per-lane
    *fragments* instead — the QueCC paper's actual execution model,
    where a multi-partition transaction's per-lane work items proceed
    independently and commit via an all-fragments-done join.
    """
    n, k = w.keys.shape
    p = _reorder(w, np.broadcast_to(np.arange(k), (n, k)).copy())
    p.ollp_miss = np.zeros(n, bool)
    p.sched = depgraph_lib.build_schedule(
        p.keys, p.modes, p.part, p.nkeys, batch_epoch,
        kind="lane", n_lanes=n_cc, fragments=fragments,
    )
    return p


def plan_partition_store(w: Workload, n_partitions: int) -> Plan:
    """Coarse partition locks: dedup (part % n_partitions), sorted.

    Every partition lock is exclusive (serial execution per partition).
    The executable work remains the original op count.
    """
    n, k = w.keys.shape
    pid = w.part.astype(np.int64) % n_partitions
    pid = np.where(w.keys == KEY_SENTINEL, np.iinfo(np.int32).max, pid)
    pid_sorted = np.sort(pid, axis=1)
    # dedup: keep first occurrence in sorted order
    dup = np.concatenate(
        [np.zeros((n, 1), bool), pid_sorted[:, 1:] == pid_sorted[:, :-1]], axis=1
    )
    pkeys = np.where(dup, np.iinfo(np.int32).max, pid_sorted)
    pkeys = np.sort(pkeys, axis=1)
    valid = pkeys != np.iinfo(np.int32).max
    keys = np.where(valid, pkeys, int(KEY_SENTINEL)).astype(np.int32)

    # Route each txn to its home partition's worker lane (H-Store executes
    # a txn at the partition that owns its (first) data).
    home = pkeys[:, 0] % n_partitions
    per_lane = [
        np.where(home == lane)[0] for lane in range(n_partitions)
    ]
    m = max(1, max((len(x) for x in per_lane), default=1))
    lane_stream = np.full((n_partitions, m), -1, np.int32)
    for lane, idxs in enumerate(per_lane):
        if len(idxs):
            reps = int(np.ceil(m / len(idxs)))
            lane_stream[lane] = np.tile(idxs, reps)[:m]

    return Plan(
        keys=keys,
        modes=np.full((n, k), MODE_WRITE, np.int32),
        part=np.where(valid, pkeys, 0).astype(np.int32),
        nkeys=valid.sum(axis=1).astype(np.int32),
        exec_ops=w.exec_ops,
        ollp=np.zeros(n, bool),  # partition-store needs no record-level plan
        ollp_miss=np.zeros(n, bool),
        num_records=n_partitions,
        lane_stream=lane_stream,
    )
