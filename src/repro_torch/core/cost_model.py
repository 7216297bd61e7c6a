"""Multicore hardware cost model for the ORTHRUS engine.

The *protocol logic* in the engine is exact; what we model with constants is
the machine the paper ran on (80-core, 8-socket Intel E7-8850 @ 2.0 GHz).
Constants are in CPU cycles; the simulator advances in *rounds* of
``cycles_per_round`` cycles.

The key physical effect (paper §2.1) is modeled as **line occupancy**: each
record's concurrency-control meta-data (latch + lock-request list) behaves as
a serially-reusable resource. A lock-table operation on record k

  * must wait for the line to be free (backlog from earlier ops),
  * then occupies it for ``lock_op + coherence_per_sharer * (contenders-1)``
    cycles, where ``contenders`` counts the lock-table ops and waiters
    touching k this round (invalidation/transfer traffic grows with sharers
    [Boyd-Wickizer et al., Linux OLS'12; David et al., SOSP'13]).

Under load, per-op service time grows with core count, so record-level
capacity *shrinks* as cores are added — reproducing the paper's observation
that 2PL throughput can *decrease* with cores (Fig 1) even for read-only
workloads. ORTHRUS CC lanes have a fixed per-op cost and per-round admission
capacity instead (single-owner meta-data: no coherence term), so they
saturate but never degrade.

Sources for magnitudes: uncontended atomic ~20-60 cyc, contended line
transfer ~70-300 cyc (we use a blended on/off-socket figure), SPSC queue hop
~100-250 ns [RCL, ATC'12], ~1 us of real work per 1 KB stored-procedure op.
Only ratios matter for the paper's claims; absolute txn/s lands within the
paper's order of magnitude.

Module contract
---------------
Everything in this module is **static**: a :class:`CostModel` instance is
part of ``EngineConfig.trace_statics()``, so every constant below is baked
into the compiled step computation — changing any of them recompiles (and
must invalidate benchmark caches via a ``repro_torch.core.sweep.ENGINE_VERSION``
bump if committed). Nothing here is traced per cell. The host-side
*functions* are :func:`CostModel.planner_batch_cycles` /
:func:`CostModel.scheduler_batch_cycles` (per-batch planner / clusterer
work, consumed by ``engine._planner_work_rounds`` at plan-build time) and
the pure-python oracles — :func:`planner_lane_schedule` for the engine's
in-round planner-lane recurrence (``tests/test_planner_model``),
:func:`cluster_components` / :func:`cluster_chain_edges` for the
`scheduled` family's clusterer (``tests/test_scheduling``), and the
overload-robustness oracles below (``tests/test_overload``).

Planner-lane throughput model (fig15)
-------------------------------------
The batch-planned protocols (dgcc / quecc) historically charged planning
as a fixed **pipelined latency**: batch b+1's plan lands one planning span
after batch b's, and planning capacity is infinite. DGCC (Yao et al.) and
QueCC (Qadah & Sadoghi) both report the regime that model cannot show:
planner *throughput* saturates, plans queue behind busy planner lanes, and
execution starves — the planning-cost crossover that lets lock-based
protocols win back the low-contention end.

With ``EngineConfig.n_planner_lanes = L > 0`` the engine switches to a
throughput model. Assumptions:

  * one batch is planned end-to-end by **one** planner lane (batches are
    round-robined across lanes, lane = global epoch index mod L), so
    planning parallelism is *across* batches, never within one;
  * per-batch planner work scales with the batch's conflict-graph size —
    ``plan_txn_cycles`` per transaction, ``batch_plan_cycles_per_op`` per
    key-op, ``plan_edge_cycles`` per dependency edge, ``plan_frag_cycles``
    per fragment (fragment mode only), plus OLLP reconnaissance;
  * batches *arrive* at the epoch rate (``EngineConfig.
    epoch_interval_rounds`` between batches; 0 = all input is pre-arrived,
    the fully planner-bound regime), and a lane can only start a plan once
    the batch has arrived and the lane is free;
  * a batch's transactions admit only after its modeled plan-completion
    round (``plan_fin``), and the inter-batch pipeline's level-0 prefix
    waits for the *next plan*, not the batch barrier.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Cycle costs for the simulated multicore machine."""

    # Simulator granularity: one round = this many cycles (0.25 us @ 2 GHz).
    cycles_per_round: int = 500
    clock_ghz: float = 2.0

    # --- shared-memory lock table (2PL / deadlock-free) ---
    # Base cost of one lock-table interaction (latch + bucket probe + list
    # edit) and the additional coherence cost per *other* contender on the
    # same record's meta-data this round.
    lock_op_cycles: int = 500
    coherence_cycles_per_sharer: int = 300

    # --- deadlock handling (paper §2.2, §4.1) ---
    # wait-die: one timestamp comparison per denied attempt (cheap, one-off).
    waitdie_check_cycles: int = 100
    # wait-for graph: per wait-round node/edge maintenance + local cycle walk.
    waitfor_maintain_cycles: int = 200
    # dreadlocks: waiters spin on the holder's digest; every wait round
    # re-reads a remote, frequently-invalidated line (paper §4.4.1).
    dreadlocks_spin_cycles: int = 300
    # post-abort backoff before the restart.
    abort_backoff_rounds: int = 4

    # --- ORTHRUS message passing (paper §3.1, §3.3) ---
    # One SPSC queue hop (enqueue + transfer + dequeue): ~0.25 us.
    msg_hop_cycles: int = 500
    # CC lane cost to process one key (hash insert / release, cache-local,
    # latch-free). Admission capacity per CC lane per round is
    # cycles_per_round // cc_op_cycles key-operations.
    cc_op_cycles: int = 150

    # --- batch planning (DGCC / QueCC, paper P1+P2 pushed to batches) ---
    # Planner-lane work to place one key-op into the batch's dependency
    # graph / execution queues (hash + chain append, cache-local,
    # vectorizable). Planning of batch b+1 is pipelined behind batch b's
    # execution; the engine charges the pipeline's critical path.
    batch_plan_cycles_per_op: int = 100
    # Scheduler check that one predecessor has committed (a read of a
    # single cache line owned by the scheduler — no coherence storm).
    dep_check_cycles: int = 40

    # --- planner-lane throughput model (fig15; see module docstring) ---
    # Per-transaction planner overhead: allocate the batch entry, stamp
    # the serial order, route to the home structure.
    plan_txn_cycles: int = 300
    # Per dependency edge of the batch's conflict graph / queue chains:
    # last-writer lookup + chain append (cache-local hash).
    plan_edge_cycles: int = 80
    # Per fragment (fragment mode only): per-lane queue segment setup
    # and the commit-join bookkeeping entry.
    plan_frag_cycles: int = 150

    # --- transaction scheduling (Prasaad et al., arXiv 1810.01997) ---
    # The `scheduled` family clusters each batch's transactions by
    # data-access overlap (union-find over the conflict edges) instead
    # of building a full dependency graph: no wavefront levels, no
    # per-lane queue materialization — just find(), union(), and a
    # queue append per transaction. Each term is therefore cheaper
    # than its planning counterpart above (plan_txn_cycles /
    # batch_plan_cycles_per_op / plan_edge_cycles): the scheduler
    # touches each access once to hash it and each conflict edge once
    # to union two roots.
    sched_txn_cycles: int = 100  # batch entry + cluster-queue append
    sched_op_cycles: int = 60  # hash one access into the key table
    sched_edge_cycles: int = 40  # union-find find+union per edge scanned

    # --- transaction logic ---
    # One stored-procedure op on a 1 KB record (probe + RMW + logic,
    # ~0.6 us — paper-scale one-shot stored procedures).
    exec_op_cycles: int = 1200
    # Fixed per-transaction logic (parse, commit record, ...).
    txn_fixed_cycles: int = 1500
    # OLLP reconnaissance (secondary-index read ahead of execution).
    recon_cycles: int = 1500

    # --- partitioned-store (H-Store style) ---
    # Acquiring a partition spinlock (cache-resident when single-partition).
    partition_lock_cycles: int = 150
    # Extra per-op cost of probing a *shared* (non-partitioned) index whose
    # working set exceeds a core's cache (paper §4.3: Partitioned-store's
    # single-partition advantage is mostly partitioned-index cache locality;
    # SPLIT ORTHRUS / Split Deadlock-free drop this penalty).
    shared_index_penalty_cycles: int = 600

    # Derived helpers -----------------------------------------------------
    def rounds(self, cycles):
        """ceil(cycles / cycles_per_round); works on ints and jnp arrays."""
        return (cycles + self.cycles_per_round - 1) // self.cycles_per_round

    @property
    def round_seconds(self) -> float:
        return self.cycles_per_round / (self.clock_ghz * 1e9)

    @property
    def cc_keys_per_round(self) -> int:
        return max(1, self.cycles_per_round // self.cc_op_cycles)

    @property
    def exec_op_rounds(self) -> int:
        return int(self.rounds(self.exec_op_cycles))

    @property
    def txn_fixed_rounds(self) -> int:
        return int(self.rounds(self.txn_fixed_cycles))

    @property
    def recon_rounds(self) -> int:
        return int(self.rounds(self.recon_cycles))

    @property
    def msg_hop_rounds(self) -> int:
        return int(self.rounds(self.msg_hop_cycles))

    def planner_batch_cycles(self, n_txns, n_ops, n_edges, n_frags, n_ollp):
        """Planner-lane cycles to plan one batch end to end.

        All arguments may be ints or numpy arrays (one entry per batch).
        This is the *throughput*-model cost: the work one planner lane
        performs for one batch, scaling with the batch's conflict-graph
        size. It is **not** divided by any lane count — parallelism in
        the throughput model is across batches (round-robin over
        ``EngineConfig.n_planner_lanes``), never within one batch.

        >>> cm = CostModel()
        >>> cm.planner_batch_cycles(n_txns=2, n_ops=6, n_edges=3,
        ...                         n_frags=0, n_ollp=0)
        1440
        >>> int(cm.rounds(1440))  # rounds at 500 cycles per round
        3
        """
        return (
            n_txns * self.plan_txn_cycles
            + n_ops * self.batch_plan_cycles_per_op
            + n_edges * self.plan_edge_cycles
            + n_frags * self.plan_frag_cycles
            + n_ollp * self.recon_cycles
        )

    def scheduler_batch_cycles(self, n_txns, n_ops, n_edges, n_ollp):
        """Clusterer cycles to schedule one batch (the `scheduled`
        family's analogue of :func:`planner_batch_cycles`).

        All arguments may be ints or numpy arrays (one entry per
        batch). ``n_edges`` counts the conflict edges the clusterer
        *scans* to union components — the full record-level conflict
        graph of the batch, not the (smaller) per-cluster chains the
        engine executes. Like the planner cost this is per-lane work
        under the throughput model and never divided by a lane count.

        Scheduling is strictly cheaper than planning the same batch:
        every term is below its planning counterpart and the fragment
        term is absent (clusters are txn-granular).

        >>> cm = CostModel()
        >>> cm.scheduler_batch_cycles(n_txns=2, n_ops=6, n_edges=3,
        ...                           n_ollp=0)
        680
        >>> int(cm.rounds(680))  # rounds at 500 cycles per round
        2
        >>> cm.scheduler_batch_cycles(2, 6, 3, 0) < cm.planner_batch_cycles(
        ...     2, 6, 3, 0, 0)
        True
        """
        return (
            n_txns * self.sched_txn_cycles
            + n_ops * self.sched_op_cycles
            + n_edges * self.sched_edge_cycles
            + n_ollp * self.recon_cycles
        )


def planner_lane_schedule(work_rounds, interval_rounds: int, n_lanes: int):
    """Reference planner-lane schedule (pure python, execution-independent).

    Batch (epoch) g arrives at round ``g * interval_rounds`` and is
    planned by lane ``g % n_lanes``; a lane plans its batches serially,
    so plan g starts at ``max(arrive[g], lane_free[g % n_lanes])`` and
    completes ``work_rounds[g]`` rounds later. Returns
    ``(ready, queue_delay)`` — per-batch plan-completion rounds and the
    rounds each plan spent queued behind its busy lane.

    This recurrence depends only on the arrival and work sequences — not
    on execution — so it doubles as the oracle for the engine's carried
    ``lane_free`` state: ``tests/test_planner_model`` pins the engine's
    ``plan_qdelay`` / ``plan_busy`` counters against it.

    Two lanes hide every other plan; one lane queues them:

    >>> planner_lane_schedule([10, 10, 10], interval_rounds=5, n_lanes=2)
    ([10, 15, 20], [0, 0, 0])
    >>> planner_lane_schedule([10, 10, 10], interval_rounds=5, n_lanes=1)
    ([10, 20, 30], [0, 5, 10])
    """
    lane_free = [0] * max(n_lanes, 1)
    ready, delay = [], []
    for g, w in enumerate(work_rounds):
        arrive = g * interval_rounds
        lane = g % max(n_lanes, 1)
        delay.append(max(lane_free[lane] - arrive, 0))
        fin = max(arrive, lane_free[lane]) + w
        lane_free[lane] = fin
        ready.append(fin)
    return ready, delay


def planner_busy_integral(
    work_rounds, interval_rounds: int, n_lanes: int, horizon: int
) -> int:
    """Lane-busy rounds that have *elapsed* by ``horizon`` under the
    reference schedule: each plan occupies its lane over the span
    ``[ready - work, ready)``, and only the part of the span before the
    horizon counts. This is the round-granular oracle for the engine's
    ``plan_busy_int`` counter (``plan_busy`` charges each whole span at
    rollover, so its running value can exceed ``n_lanes * r`` — the
    fig15 >1.0-utilization artifact this integral fixes).

    Spans on one lane never overlap, so the integral is bounded by
    ``n_lanes * horizon`` — utilization from it is always <= 1:

    >>> planner_busy_integral([10, 10, 10], 5, 1, horizon=25)
    25
    >>> planner_busy_integral([10, 10, 10], 5, 1, horizon=1000)
    30
    >>> planner_busy_integral([10, 10, 10], 5, 2, horizon=12)
    19
    """
    ready, _ = planner_lane_schedule(work_rounds, interval_rounds, n_lanes)
    return int(sum(
        max(min(f, horizon) - min(f - w, horizon), 0)
        for f, w in zip(ready, work_rounds)
    ))


def cluster_components(n: int, edge_dst, edge_src) -> list[int]:
    """Reference clusterer for the `scheduled` family: union-find over
    the batch's conflict edges, returning one dense cluster id per
    transaction. Clusters are numbered by their smallest member (0 is
    the cluster containing the lowest conflicting txn id, singletons
    included), which is exactly how ``depgraph.build_schedule(kind=
    "cluster")`` numbers them — ``tests/test_scheduling`` pins the
    engine-side schedule bit-exactly against this function.

    Pure python on purpose (like every oracle in this module): it must
    stay independent of the vectorized numpy clusterer it checks, and
    importable without numpy for the standalone doctest run.

    A 0-2-4 chain with 1 and 3 as singletons:

    >>> cluster_components(5, [2, 4], [0, 2])
    [0, 1, 0, 2, 0]
    >>> cluster_components(3, [], [])
    [0, 1, 2]
    >>> cluster_components(4, [1, 3, 3], [0, 2, 1])  # merge {0,1} + {2,3}
    [0, 0, 0, 0]
    """
    root = list(range(int(n)))

    def find(x):
        while root[x] != x:
            root[x] = root[root[x]]  # path halving
            x = root[x]
        return x

    for d, s in zip(edge_dst, edge_src):
        a, b = find(int(d)), find(int(s))
        if a != b:  # union by smaller id, so the root is the min member
            if a > b:
                a, b = b, a
            root[b] = a
    # dense ids in order of first appearance = by smallest member
    seen: dict[int, int] = {}
    out = []
    for x in range(int(n)):
        r = find(x)
        if r not in seen:
            seen[r] = len(seen)
        out.append(seen[r])
    return out


def cluster_chain_edges(cluster_of) -> list[tuple[int, int]]:
    """The execution edges the `scheduled` engine path runs: within
    each cluster, txn i depends on the cluster's previous member (in
    admission = id order); cluster heads have no predecessor. This is
    the whole schedule — no wavefront DAG, so every txn has in-degree
    <= 1 and cross-cluster txns stay concurrent.

    Returns ``(dst, src)`` pairs sorted by dst.

    >>> cluster_chain_edges([0, 1, 0, 2, 0])
    [(2, 0), (4, 2)]
    >>> cluster_chain_edges([0, 0, 0])
    [(1, 0), (2, 1)]
    >>> cluster_chain_edges([0, 1, 2])
    []
    """
    last: dict[int, int] = {}
    edges = []
    for i, c in enumerate(cluster_of):
        c = int(c)
        if c in last:
            edges.append((i, last[c]))
        last[c] = i
    return edges


# --------------------------------------------------------------------------
# Overload-robustness oracles (admission control + bounded backoff).
#
# The engine's admission policies and abort backoff are exact integer
# recurrences over the closed-form arrival schedule; the functions below
# are their pure-python mirrors, pinned bit-exactly against the carried
# engine counters in ``tests/test_overload.py``. Like the planner
# schedule above they depend only on the arrival/attempt sequences —
# never on execution — which is what makes them usable as oracles.
# --------------------------------------------------------------------------

# Shift cap for the exponential backoff (see :func:`exp_backoff_rounds`):
# the doubling stops after this many aborts so the shift never overflows
# int32 (base << 16 with the default base of 4 is ~262k rounds).
BACKOFF_SHIFT_CAP = 16


def exp_backoff_rounds(base_rounds: int, attempt: int, max_rounds: int) -> int:
    """Bounded exponential backoff after the ``attempt``-th abort
    (attempt 0 = first execution): ``min(base << min(attempt, 16), max)``
    — shift-and-cap integer math, the exact formula the engine applies
    to the ``C_ATTEMPT`` slot column under
    ``EngineConfig.backoff_mode == "exp"``.

    >>> [exp_backoff_rounds(4, a, 256) for a in range(8)]
    [4, 8, 16, 32, 64, 128, 256, 256]
    >>> exp_backoff_rounds(4, 40, 1 << 20)  # shift saturates at 16
    262144
    """
    shift = min(int(attempt), BACKOFF_SHIFT_CAP)
    return min(int(base_rounds) << shift, int(max_rounds))


def token_grant(r: int, interval_rounds: int, burst: int) -> int:
    """Tokens granted by round ``r`` under the token-bucket admission
    policy: the bucket starts full (``burst`` tokens) and refills one
    token every ``interval_rounds`` rounds. Global txn id ``g`` may be
    admitted at round ``r`` iff ``g < token_grant(r, ...)``.

    >>> [token_grant(r, 10, 2) for r in (0, 9, 10, 25, 100)]
    [2, 2, 3, 4, 12]
    """
    return int(burst) + int(r) // int(interval_rounds)


def token_ready_round(g: int, interval_rounds: int, burst: int) -> int:
    """Earliest round at which the token bucket admits global txn id
    ``g`` (ignoring arrival and slot availability): the inverse of
    :func:`token_grant`, used both by the engine's event-leap wake
    candidate and by the host-side admission-schedule oracle.

    >>> [token_ready_round(g, 10, 2) for g in (0, 1, 2, 3, 11)]
    [0, 0, 10, 20, 100]
    >>> all(token_grant(token_ready_round(g, 7, 3), 7, 3) > g
    ...     for g in range(50))
    True
    """
    return max(int(g) - int(burst) + 1, 0) * int(interval_rounds)


def token_bucket_schedule(
    arrive_rounds, interval_rounds: int, burst: int
) -> list[int]:
    """Admission-eligibility round of each transaction under the
    token-bucket gate: ``max(arrival, token_ready_round(g))``. This is
    the pure gate schedule — actual admission additionally waits for a
    free exec slot, so the engine's admission rounds are lower-bounded
    by (and, with spare slots, equal to) this schedule.

    >>> token_bucket_schedule([0, 0, 0, 0], interval_rounds=5, burst=2)
    [0, 0, 5, 10]
    >>> token_bucket_schedule([0, 20, 40], interval_rounds=5, burst=1)
    [0, 20, 40]
    """
    return [
        max(int(a), token_ready_round(g, interval_rounds, burst))
        for g, a in enumerate(arrive_rounds)
    ]


def backlog_drops(arrived: int, consumed: int, cap: int) -> int:
    """Transactions a bounded-backlog gate drops *right now*: the
    excess of the waiting queue (``arrived - consumed``) over the cap.
    ``consumed`` counts transactions already admitted or dropped. The
    engine applies this floor every executed round (dropping the
    *oldest* waiters), so the carried reject counter equals the sum of
    these increments — and the backlog never exceeds ``cap`` except
    transiently within an arrival round.

    >>> backlog_drops(arrived=10, consumed=3, cap=5)
    2
    >>> backlog_drops(arrived=10, consumed=8, cap=5)
    0
    """
    return max(int(arrived) - int(consumed) - int(cap), 0)


def deadline_drops(arrived_stale: int, consumed: int) -> int:
    """Transactions a deadline-shed gate drops right now: every waiter
    that arrived long enough ago to have exceeded the queueing deadline
    (``arrived_stale`` = arrivals up to round ``r - deadline - 1``) and
    was neither admitted nor already dropped.

    >>> deadline_drops(arrived_stale=7, consumed=5)
    2
    >>> deadline_drops(arrived_stale=4, consumed=5)
    0
    """
    return max(int(arrived_stale) - int(consumed), 0)


def megadispatch_speedup(compute_us: float, overhead_us: float,
                         k: int) -> float:
    """Predicted warm-throughput ratio of fusing ``k`` engine rounds
    into one dispatch versus one round per dispatch. With per-round
    compute ``c`` and per-dispatch overhead ``o`` (launch, host
    round-trip, runtime bookkeeping), K-fusing amortizes ``o`` over
    ``k`` rounds::

        speedup(k) = (c + o) / (c + o / k)

    The model says where fusing pays: it approaches ``1 + o/c`` as
    ``k`` grows, so the win is bounded by the overhead-to-compute
    ratio. On XLA CPU ``o`` is a few microseconds against a
    multi-hundred-microsecond round, so the predicted (and measured)
    ratio is ~1.0 — the lever is accelerator backends where a kernel
    launch costs as much as the round itself.

    >>> megadispatch_speedup(compute_us=10.0, overhead_us=10.0, k=8)
    1.7777777777777777
    >>> round(megadispatch_speedup(compute_us=300.0, overhead_us=3.0, k=8), 4)
    1.0087
    >>> megadispatch_speedup(compute_us=100.0, overhead_us=50.0, k=1)
    1.0
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    c, o = float(compute_us), float(overhead_us)
    return (c + o) / (c + o / k)


DEFAULT_COST_MODEL = CostModel()
