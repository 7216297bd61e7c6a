"""The ORTHRUS transaction engine in PyTorch.

A port of ``repro.core.engine`` that computes the same simulation bit
for bit. The simulator advances in rounds (``CostModel.cycles_per_round``
cycles); in each round every lane interacts with the lock table at most
once. See the reference module for the protocol families and the cost
model; this module keeps its names, row constants and stage numbering.

Ported so far, ``release_path`` "csr" or "dense", any
``rounds_per_dispatch`` (the dispatch is ``repro_torch.core.sweep``'s),
with event leaping on or off, closed loop or open epoch
arrival (uniform, burst or diurnal) under every admission policy, retry
budget and backoff mode of the overload layer:

* ``make_step``: ``orthrus`` (CC lanes own key partitions, exec lanes
  multiplex a window of transactions, P1 + P2), ``deadlock_free``
  (canonical-order acquisition, P2 alone), the dynamic-2PL baselines
  ``twopl_waitdie``, ``twopl_waitfor`` and ``twopl_dreadlocks``, and
  ``partitioned_store`` (H-Store partition locks and per-lane streams);
* ``make_batch_step``: the batch-planned ``dgcc``, ``quecc`` and
  ``scheduled``, with or without ``fragment_exec`` and
  ``inter_batch_pipeline``, and the planner-lane model
  (``n_planner_lanes > 0``).

``state_layout="legacy"`` runs the frozen pre-packed step builders of
``repro_torch.core.engine_legacy`` (the conformance oracle) through the
same host loop.

State is a dict of int32 / bool tensors on one device, as in the
reference, with one difference: the arrays of ``DROP_ROW_ARRAYS`` (the
per-record ``wh``, ``rc``, ``heat``, ``line``, ``agg_sum``, the reader
bitmask ``rdr``, and the batch engine's per-unit ``done`` and per-txn
``txn_left``) carry one extra last row. The reference scatters into
them with ``mode="drop"`` at the index one past the end; here those
writes land in the extra row, which nothing reads.
``repro_torch.core.convert`` adds and strips it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import planner as planner_lib
from repro_torch.core.cost_model import (
    BACKOFF_SHIFT_CAP,
    DEFAULT_COST_MODEL,
    CostModel,
)
from repro_torch.core.lockgrant import (
    I32_MAX,
    I32_MIN,
    KEY_SENTINEL,
    REQ_NONE,
    REQ_READ,
    REQ_RELEASE,
    REQ_WRITE,
    lex_order,
    segment_starts,
    sorted_grant,
)
from repro_torch.core.metrics import LAT_BUCKETS, QDEPTH_SAMPLES
from repro_torch.core.workloads import (
    MODE_READ,
    MODE_WRITE,
    Workload,
    epoch_arrival_schedule,
)
from repro_torch.kernels import use_kernel

I32 = torch.int32

# Phases
EMPTY, INIT, ACQ, MSG, READY, EXEC, REL, BACKOFF = range(8)

# Packed state matrix: every per-slot scalar field is one row of the
# int32 [SLOT_F, T] matrix ``state["slots"]`` (bool fields stored 0/1).
(
    C_TID,         # loaded txn id (-1 = none)
    C_WIDX,        # workload index of the loaded txn
    C_LANE_CTR,    # H-Store per-lane stream cursor
    C_TS,          # timestamp (= txn id; unique per slot)
    C_PHASE,       # EMPTY .. BACKOFF
    C_COMMITTING,  # bool: REL path ends in commit (vs abort/backoff)
    C_BUSY_UNTIL,  # round until which the slot is busy
    C_BUSY_KIND,   # CAT_* charged while busy
    C_KPTR,        # next key index (program/canonical order)
    C_ATTEMPT,     # retry attempt counter
    C_CCPTR,       # ORTHRUS: first key of the current CC group
    C_MSG_ARRIVE,  # ORTHRUS/batch: message arrival round
    C_MSG_STAGE,   # ORTHRUS: 0 = acquire hop, 1 = response hop
    C_RELEASE_AT,  # round the release (message) lands
    C_WAITED,      # bool: slot was lock-waiting last round
    C_DL_DEBT,     # accumulated deadlock-handling cycles (mod round)
    C_ARRIVE,      # arrival round of the loaded txn (metrics: latency)
) = range(17)
SLOT_F = 17
SLOT_COLS = (
    "tid", "widx", "lane_ctr", "ts", "phase", "committing", "busy_until",
    "busy_kind", "kptr", "attempt", "ccptr", "msg_arrive", "msg_stage",
    "release_at", "waited", "dl_debt", "arrive",
)

# Batch-planned engine rows (ported with make_batch_step).
(
    BC_TID,
    BC_WIDX,
    BC_TS,
    BC_PHASE,
    BC_BUSY_UNTIL,
    BC_BUSY_KIND,
    BC_MSG_ARRIVE,
    BC_FTXN,
    BC_ARRIVE,
) = range(9)
BATCH_SLOT_F = 9
BATCH_SLOT_COLS = (
    "tid", "widx", "ts", "phase", "busy_until", "busy_kind", "msg_arrive",
    "ftxn", "arrive",
)

# State arrays with one extra last row for the reference's dropped
# writes: per record [R + 1, ...], per unit done [NU + 1], txn_left [N + 1].
DROP_ROW_ARRAYS = ("wh", "rc", "heat", "line", "agg_sum", "rdr", "done",
                   "txn_left")

# Sharer-heat epoch length (rounds) for the coherence model.
EPOCH_BITS = 12
# Lane-time categories (paper Fig 10 breakdown)
CAT_IDLE, CAT_EXEC, CAT_LOCK, CAT_WAIT, CAT_DL, CAT_MSG = range(6)
NCAT = 6

_IMAX = I32_MAX

# Saturation bound for the open-arrival closed forms (see reference).
_SAT = 1 << 30


def _sat_mul(a, b):
    """``a * b`` clamped to ``_SAT`` (int32-safe; a >= 0, b >= 0)."""
    return torch.where(a > _SAT // torch.clamp(b, min=1), _SAT, a * b)


PROTOCOLS = (
    "twopl_waitdie",
    "twopl_waitfor",
    "twopl_dreadlocks",
    "deadlock_free",
    "orthrus",
    "partitioned_store",
    "dgcc",
    "quecc",
    "scheduled",
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine configuration; the fields, defaults and checks of
    ``repro.core.engine.EngineConfig``, so one set of keyword arguments
    builds a valid config in both packages.

    ``kernel_impl`` keeps the reference's values: "jnp" is the plain
    PyTorch formulation of the grant pass, "pallas" the hand-written
    CUDA kernel (its plain version for CPU tensors), and "auto" the
    kernel for CUDA tensors and the plain formulation for CPU tensors.
    """

    protocol: str
    n_exec: int
    n_cc: int = 0
    window: int = 1
    split_index: bool = False
    event_leap: bool = True
    state_layout: str = "packed"
    fragment_exec: bool = False
    inter_batch_pipeline: bool = False
    n_planner_lanes: int = 0
    epoch_interval_rounds: int = 0
    admission_policy: str = "none"
    backlog_cap: int = 0
    token_interval_rounds: int = 0
    token_burst: int = 0
    deadline_rounds: int = 0
    retry_budget: int = 0
    backoff_mode: str = "fixed"
    backoff_max_rounds: int = 256
    arrival_pattern: str = "uniform"
    burst_period_epochs: int = 0
    burst_on_epochs: int = 0
    rounds_per_dispatch: int = 1
    release_path: str = "csr"
    kernel_impl: str = "auto"
    max_rounds: int = 60_000
    warmup_rounds: int = 4_000
    chunk_rounds: int = 4_000
    target_commits: int = 50_000
    cost: CostModel = DEFAULT_COST_MODEL

    def __post_init__(self):
        assert self.protocol in PROTOCOLS, self.protocol
        assert self.state_layout in ("packed", "legacy"), self.state_layout
        if self.protocol == "orthrus":
            assert self.n_cc >= 1
        if self.protocol == "quecc":
            assert self.n_cc >= 1, "quecc needs n_cc planner/queue lanes"
        if self.protocol == "scheduled":
            assert self.state_layout == "packed", (
                "the frozen legacy engine predates the scheduled family"
            )
        if self.fragment_exec or self.inter_batch_pipeline:
            assert self.protocol in ("dgcc", "quecc"), (
                "fragment execution / inter-batch pipelining are "
                "batch-planned (dgcc/quecc) features; the scheduled "
                "family's clusters are txn-granular"
            )
            assert self.state_layout == "packed", (
                "the frozen legacy engine predates fragment execution"
            )
        if self.inter_batch_pipeline:
            assert self.fragment_exec, (
                "inter-batch pipelining admits level-0 *fragments*: "
                "enable fragment_exec"
            )
        assert self.n_planner_lanes >= 0
        assert self.epoch_interval_rounds >= 0
        if self.n_planner_lanes:
            assert self.is_batch_planned, (
                "the planner-lane throughput model charges *batch* "
                "planning/scheduling: it applies to dgcc/quecc/"
                "scheduled only"
            )
        if self.n_planner_lanes or self.epoch_interval_rounds:
            assert self.state_layout == "packed", (
                "the frozen legacy engine predates the planner-lane "
                "model and open epoch arrival"
            )
        if self.epoch_interval_rounds:
            assert self.protocol != "partitioned_store", (
                "open epoch arrival is not modeled for the H-Store "
                "per-lane admission streams"
            )
        assert self.admission_policy in (
            "none", "bounded_backlog", "token_bucket", "deadline_shed"
        ), self.admission_policy
        assert self.backoff_mode in ("fixed", "exp"), self.backoff_mode
        assert self.arrival_pattern in (
            "uniform", "burst", "diurnal"
        ), self.arrival_pattern
        assert self.retry_budget >= 0
        if self.admission_policy != "none":
            assert self.epoch_interval_rounds > 0, (
                "admission policies gate the open-arrival backlog: "
                "set epoch_interval_rounds"
            )
            assert not self.inter_batch_pipeline, (
                "admission policies skip whole epochs at batch "
                "rollover, which the pipelined level-0 cursor does "
                "not model"
            )
            if self.admission_policy == "bounded_backlog":
                assert self.backlog_cap > 0
            if self.admission_policy == "token_bucket":
                assert self.token_interval_rounds > 0
                assert self.token_burst > 0
            if self.admission_policy == "deadline_shed":
                assert self.deadline_rounds > 0
        if self.retry_budget or self.backoff_mode != "fixed":
            assert not self.is_batch_planned, (
                "batch-planned execution has no abort path: retry "
                "budgets and backoff shaping do not apply"
            )
        if self.arrival_pattern != "uniform":
            assert self.epoch_interval_rounds > 0, (
                "bursty arrival shapes the open-arrival schedule: "
                "set epoch_interval_rounds"
            )
            assert self.burst_period_epochs > 0
            if self.arrival_pattern == "burst":
                assert 0 < self.burst_on_epochs <= self.burst_period_epochs
        if (
            self.admission_policy != "none"
            or self.retry_budget
            or self.backoff_mode != "fixed"
            or self.arrival_pattern != "uniform"
        ):
            assert self.state_layout == "packed", (
                "the frozen legacy engine predates the overload "
                "robustness layer"
            )
        assert self.rounds_per_dispatch >= 1, self.rounds_per_dispatch
        assert self.release_path in ("csr", "dense"), self.release_path
        assert self.kernel_impl in ("auto", "jnp", "pallas"), self.kernel_impl
        if self.release_path != "csr" or self.kernel_impl != "auto":
            assert self.state_layout == "packed", (
                "the frozen legacy engine has a single (dense, jnp) "
                "grant/wait-for formulation"
            )

    @property
    def n_slots(self) -> int:
        return self.n_exec * self.window

    @property
    def is_orthrus(self) -> bool:
        return self.protocol == "orthrus"

    @property
    def is_batch_planned(self) -> bool:
        return self.protocol in ("dgcc", "quecc", "scheduled")

    @property
    def dispatch_rounds(self) -> int:
        return 1 << (self.rounds_per_dispatch - 1).bit_length()

    @property
    def is_dynamic_2pl(self) -> bool:
        return self.protocol.startswith("twopl")

    @property
    def deadlock_scheme(self) -> str:
        return {
            "twopl_waitdie": "waitdie",
            "twopl_waitfor": "waitfor",
            "twopl_dreadlocks": "dreadlocks",
        }.get(self.protocol, "none")

    def trace_statics(self) -> tuple:
        """The config fields the step computation depends on (the
        reference's compile-cache key; the port keeps it for parity)."""
        return (
            self.protocol,
            self.n_exec,
            self.n_cc,
            self.window,
            self.split_index,
            self.event_leap,
            self.state_layout,
            self.fragment_exec,
            self.inter_batch_pipeline,
            self.n_planner_lanes,
            self.epoch_interval_rounds > 0,
            self.admission_policy,
            self.retry_budget > 0,
            self.backoff_mode,
            self.arrival_pattern != "uniform",
            self.dispatch_rounds,
            self.release_path,
            self.kernel_impl,
            self.cost,
        )


@dataclasses.dataclass(frozen=True)
class PlanMeta:
    """Static (shape-only) description of a plan."""

    n_txns: int  # N
    max_keys: int  # K
    num_records: int  # R, padded to a pow2 bucket by _compact_keys
    lane_cols: int = 0  # H-Store lane_stream width; 0 = absent
    pred_width: int = 0  # batch schedule: pred_pad columns
    num_batches: int = 0  # batch schedule: NB
    n_frags: int = 0  # fragment mode: total fragments F
    frag_pred_width: int = 0  # fragment mode: frag_pred_pad columns


@dataclasses.dataclass
class SimResult:
    commits: int
    aborts_deadlock: int
    aborts_ollp: int
    wasted_ops: int
    rounds: int
    sim_seconds: float
    throughput_txn_s: float
    breakdown: dict[str, float]  # exec-lane time fractions
    raw: dict[str, Any]
    # repro_torch.core.metrics.Metrics: latency histogram + percentiles,
    # queue trajectories, extended breakdown
    metrics: Any = None


def plan_meta(cfg: EngineConfig, plan: planner_lib.Plan) -> PlanMeta:
    """Shape signature of a plan."""
    if cfg.is_batch_planned:
        sched = plan.sched
        assert sched is not None, "batch protocols require a planned schedule"
        frag_kw = {}
        if cfg.fragment_exec:
            frag_kw = dict(
                n_frags=sched.n_frags,
                frag_pred_width=sched.frag_pred_pad.shape[1],
            )
        return PlanMeta(
            n_txns=sched.n_txns,
            max_keys=plan.keys.shape[1],
            num_records=plan.num_records,
            pred_width=sched.pred_pad.shape[1],
            num_batches=sched.num_batches,
            **frag_kw,
        )
    return PlanMeta(
        n_txns=plan.keys.shape[0],
        max_keys=plan.keys.shape[1],
        num_records=plan.num_records,
        lane_cols=0 if plan.lane_stream is None else plan.lane_stream.shape[1],
    )


def qgrid_interval(cfg: EngineConfig) -> int:
    """Round spacing of the queue-depth sample grid: QDEPTH_SAMPLES
    points cover (0, max_rounds] for any budget."""
    return max(1, -(-cfg.max_rounds // QDEPTH_SAMPLES))


def _epoch_schedule_arrays(cfg: EngineConfig) -> tuple[np.ndarray, int, int]:
    """One period of the bursty epoch-arrival schedule:
    ``(sched [SP], period_rounds, SP)``."""
    sched, period = epoch_arrival_schedule(
        cfg.arrival_pattern,
        cfg.epoch_interval_rounds,
        cfg.burst_period_epochs,
        cfg.burst_on_epochs,
    )
    return sched.astype(np.int64), int(period), len(sched)


def _policy_scalars(cfg: EngineConfig) -> dict:
    """Scalar parameters of the active overload-robustness policy."""
    p: dict = {}
    i32 = np.int32
    if cfg.admission_policy == "bounded_backlog":
        p["pol_cap"] = np.asarray(cfg.backlog_cap, i32)
    elif cfg.admission_policy == "token_bucket":
        p["pol_tb_iv"] = np.asarray(cfg.token_interval_rounds, i32)
        p["pol_tb_burst"] = np.asarray(cfg.token_burst, i32)
    elif cfg.admission_policy == "deadline_shed":
        p["pol_deadline"] = np.asarray(cfg.deadline_rounds, i32)
    if cfg.retry_budget > 0:
        p["pol_retry_budget"] = np.asarray(cfg.retry_budget, i32)
    if cfg.backoff_mode == "exp":
        p["pol_bo_max"] = np.asarray(cfg.backoff_max_rounds, i32)
    return p


def plan_device(cfg: EngineConfig, plan: planner_lib.Plan) -> dict:
    """The plan arrays the step reads, as numpy: the entries of
    ``repro.core.engine.plan_device``, open arrival and policy scalars
    included. ``convert.plan_from_numpy`` moves them to a device.
    """
    if cfg.is_batch_planned:
        return _batch_plan_device(cfg, plan)
    keys = np.asarray(plan.keys, np.int32)
    modes = np.asarray(plan.modes, np.int32)
    part = np.asarray(plan.part, np.int32)
    nkeys = np.asarray(plan.nkeys, np.int32)
    exec_ops = np.asarray(plan.exec_ops, np.int32)
    ollp = np.asarray(plan.ollp, bool)
    ollp_miss = np.asarray(plan.ollp_miss, bool)
    p = dict(
        keys=keys,
        modes=modes,
        part=part,
        nkeys=nkeys,
        exec_ops=exec_ops,
        ollp=ollp,
        ollp_miss=ollp_miss,
        txn_scalars=np.stack(
            [nkeys, exec_ops, ollp.astype(np.int32),
             ollp_miss.astype(np.int32)], axis=1
        ),
    )
    if plan.lane_stream is not None:
        p["lane_stream"] = np.asarray(plan.lane_stream, np.int32)
    if cfg.epoch_interval_rounds > 0:
        # open arrival: txn i arrives with its epoch (epoch-sized slices
        # of submission order); the workload wraps modulo N
        n = keys.shape[0]
        b = max(int(plan.epoch_txns), 1)
        iv = int(cfg.epoch_interval_rounds)
        n_ep = -(-n // b)
        if cfg.arrival_pattern != "uniform":
            sched_arr, period, sp = _epoch_schedule_arrays(cfg)
            reps = -(-n_ep // sp)
            ep_arr = (
                np.tile(sched_arr, reps)
                + np.repeat(np.arange(reps, dtype=np.int64) * period, sp)
            )[:n_ep]
            p["arrive_round"] = ep_arr[
                np.arange(n, dtype=np.int64) // b
            ].astype(np.int32)
            p["arrive_cycle"] = np.asarray(reps * period, np.int32)
            p["ep_arrive"] = ep_arr.astype(np.int32)
        else:
            p["arrive_round"] = (
                (np.arange(n, dtype=np.int64) // b) * iv
            ).astype(np.int32)
            p["arrive_cycle"] = np.asarray(n_ep * iv, np.int32)
        p["epoch_txns"] = np.asarray(b, np.int32)
        p["epoch_interval"] = np.asarray(iv, np.int32)
        p.update(_policy_scalars(cfg))
    elif cfg.backoff_mode == "exp" or cfg.retry_budget > 0:
        p.update(_policy_scalars(cfg))
    p["qgrid_iv"] = np.asarray(qgrid_interval(cfg), np.int32)
    return p


def _batch_plan_device(cfg: EngineConfig, plan: planner_lib.Plan) -> dict:
    """The batch-planned branch of :func:`plan_device`."""
    sched = plan.sched
    npred = np.asarray(sched.npred, np.int32)
    exec_ops = np.asarray(plan.exec_ops, np.int32)
    p = dict(
        exec_ops=exec_ops,
        npred=npred,
        txn_ne=np.stack([npred, exec_ops], axis=1),
        pred_pad=np.asarray(sched.pred_pad, np.int32),
        batch_of=np.asarray(sched.batch_of, np.int32),
        batch_start=np.asarray(sched.batch_start, np.int32),
        batch_size=np.asarray(sched.batch_size, np.int32),
        plan_rounds=_batch_plan_rounds(cfg, plan),
    )
    if cfg.fragment_exec:
        # per-fragment executable ops: the fragment's own key-ops, plus
        # the txn's non-keyed ops on the fragment holding its first key
        frag_txn = np.asarray(sched.frag_txn, np.int64)
        extra = (exec_ops - np.asarray(plan.nkeys, np.int32))[frag_txn]
        frag_exec = np.asarray(sched.frag_nkeys, np.int32) + np.where(
            sched.frag_first, np.maximum(extra, 0), 0
        ).astype(np.int32)
        frag_npred = np.asarray(sched.frag_npred, np.int32)
        p.update(
            frag_ne=np.stack([frag_npred, frag_exec], axis=1),
            frag_pred_pad=np.asarray(sched.frag_pred_pad, np.int32),
            frag_txn=frag_txn.astype(np.int32),
            frag_batch=np.asarray(sched.batch_of[frag_txn], np.int32),
            txn_nfrags=np.asarray(sched.txn_nfrags, np.int32),
            batch_fstart=np.asarray(sched.batch_fstart, np.int32),
            batch_fsize=np.asarray(sched.batch_fsize, np.int32),
            lvl0_fcount=np.asarray(sched.lvl0_fcount, np.int32),
        )
    if cfg.n_planner_lanes > 0:
        p["plan_work"] = _planner_work_rounds(cfg, plan)
    if cfg.n_planner_lanes > 0 or cfg.epoch_interval_rounds > 0:
        p["epoch_interval"] = np.asarray(cfg.epoch_interval_rounds, np.int32)
    if cfg.epoch_interval_rounds > 0:
        # cumulative batch sizes in admission units (fragments under
        # fragment_exec): closed-form arrived-unit counts at any round
        usz = sched.batch_fsize if cfg.fragment_exec else sched.batch_size
        p["cum_usize"] = np.concatenate([[0], np.cumsum(usz)]).astype(
            np.int32)
    if cfg.arrival_pattern != "uniform":
        sched_arr, period, sp = _epoch_schedule_arrays(cfg)
        p["ep_sched"] = sched_arr.astype(np.int32)
        p["sched_period"] = np.asarray(period, np.int32)
        p["sched_epochs"] = np.asarray(sp, np.int32)
    p.update(_policy_scalars(cfg))
    if cfg.admission_policy in ("bounded_backlog", "token_bucket"):
        # the batch engine sheds / gates whole epochs: caps given in
        # transactions round down to epochs (at least one)
        b = max(int(plan.epoch_txns), 1)
        if cfg.admission_policy == "bounded_backlog":
            p["pol_cap_epochs"] = np.asarray(
                max(cfg.backlog_cap // b, 1), np.int32)
        else:
            p["pol_tb_burst_e"] = np.asarray(
                max(cfg.token_burst // b, 1), np.int32)
    p["qgrid_iv"] = np.asarray(qgrid_interval(cfg), np.int32)
    return p


def offered_by_round(
    cfg: EngineConfig, plan: planner_lib.Plan, r: int
) -> int:
    """How many schedulable units (txns; fragments under
    ``fragment_exec``) the open-arrival schedule has offered by round
    ``r`` inclusive, in exact int64 arithmetic: the host mirror of the
    steps' arrived-by closed forms and the goodput denominator of
    ``Metrics``. 0 for closed-loop configs."""
    if cfg.epoch_interval_rounds <= 0 or r < 0:
        return 0
    iv = int(cfg.epoch_interval_rounds)
    if cfg.is_batch_planned:
        sched = plan.sched
        nb = sched.num_batches
        usz = sched.batch_fsize if cfg.fragment_exec else sched.batch_size
        cum = np.concatenate([[0], np.cumsum(np.asarray(usz, np.int64))])
        nu = int(cum[-1])
        if cfg.arrival_pattern != "uniform":
            ep_sched, period, sp = _epoch_schedule_arrays(cfg)
            n_arr = (r // period) * sp + int(
                np.searchsorted(ep_sched, r % period, side="right")
            )
        else:
            n_arr = r // iv + 1
        return int((n_arr // nb) * nu + cum[n_arr % nb])
    n = int(plan.keys.shape[0])
    b = max(int(plan.epoch_txns), 1)
    n_ep = -(-n // b)
    if cfg.arrival_pattern != "uniform":
        ep_sched, period, sp = _epoch_schedule_arrays(cfg)
        reps = -(-n_ep // sp)
        ep_arr = (
            np.tile(ep_sched, reps)
            + np.repeat(np.arange(reps, dtype=np.int64) * period, sp)
        )[:n_ep]
        cyc = reps * period
        in_cyc = int(np.searchsorted(ep_arr, r % cyc, side="right")) * b
    else:
        cyc = n_ep * iv
        in_cyc = (r % cyc // iv + 1) * b
    return int((r // cyc) * n + min(in_cyc, n))


def rebase_enq(s: dict) -> dict:
    """Rebase enqueue stamps against the minimum live stamp (bit-exact:
    grant decisions depend only on stamp differences among live
    entries); see ``repro.core.engine.rebase_enq``."""
    live = s["want"] | s["granted"]
    m = torch.where(live, s["enq"], _IMAX).min()
    delta = torch.minimum(m, s["enq_ctr"]) - 1
    s = dict(s)
    s["enq"] = s["enq"] - delta
    s["enq_ctr"] = s["enq_ctr"] - delta
    return s


def _state0(cfg: EngineConfig, num_records: int, T: int, K: int,
            device: torch.device | str = "cuda") -> dict:
    """Initial round state, with the extra dropped-write row on every
    per-record array (see the module docstring)."""
    R = num_records
    dev = torch.device(device)

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    slots = z(SLOT_F, T)
    slots[C_TID] = -1
    heat = z(R + 1, 3)
    heat[:, 0] = -10
    line = z(R + 1, 2)
    line[:, 1] = -1
    s = dict(
        r=z(),
        next_txn=z(),
        enq_ctr=torch.ones((), dtype=I32, device=dev),
        slots=slots,
        want=z(T, K, dtype=torch.bool),
        granted=z(T, K, dtype=torch.bool),
        enq=z(T, K),
        adm_done=z(T, K, dtype=torch.bool),
        rel_done=z(T, K, dtype=torch.bool),
        reach=z(T, T, dtype=torch.bool),
        wh=full((R + 1,), -1),
        rc=z(R + 1),
        heat=heat,
        line=line,
        commits=z(),
        aborts_dl=z(),
        aborts_ollp=z(),
        wasted=z(),
        cat=z(NCAT),
        steps=z(),
        lat_hist=z(LAT_BUCKETS),
        q_depth=z(QDEPTH_SAMPLES),
        q_inflight=z(QDEPTH_SAMPLES),
    )
    if cfg.protocol != "orthrus":
        # carried per-record same-round contention sums (stage 9)
        s["agg_sum"] = z(R + 1, 3)
        s["agg_prev_idx"] = full((T, K), R)
        s["agg_prev_upd"] = z(T, K, 3)
    if cfg.release_path == "csr" and cfg.deadlock_scheme != "none":
        # csr wait-for: carried per-record packed reader bitmask (bit u
        # of rdr[q, u // 32] = slot u holds >= 1 granted read entry on
        # record q), kept at grant and release; the deadlock stage
        # gathers waiters' digests from it
        s["rdr"] = z(R + 1, (T + 31) // 32)
    s.update(_policy_counters(cfg, dev))
    return s


def _policy_counters(cfg: EngineConfig, device) -> dict:
    """The overload layer's carried counters, keyed on the same statics
    as the step builders (``sweep._OPT_SCALARS`` reports them)."""
    names = []
    if cfg.admission_policy != "none":
        # bounded_backlog drops, deadline_shed queue drops, in-flight
        # deadline hits, token-bucket admissions
        names += ["pol_rejected", "pol_shed", "pol_timedout", "pol_tb_adm"]
    if cfg.retry_budget > 0:
        names.append("pol_sacrificed")  # retry budget exhausted
    if cfg.backoff_mode == "exp":
        names.append("pol_backoff_rounds")  # total backoff issued
    return {k: torch.zeros((), dtype=I32, device=device) for k in names}


def grant_chain(keys, modes, pend2d, rel_entries, enq, wh_r, rc_r, ent_slot,
                kind_consts, grant_sorted):
    """The ORTHRUS grant decision of one round (stage 7 of
    :func:`make_step`) as a chain of eager ops around ``grant_sorted``,
    the segmented grant over entries sorted by (key, stamp): entry kinds
    and keys, the lock-table gathers (``wh_r`` and ``rc_r`` hold the R
    records; keys past them read as write-held with no readers), the
    stable sort, the grant, the unsort and the re-entrant grant.
    ``ent_slot`` is each entry's slot, int32 [T * K], and
    ``kind_consts`` the int32 scalars REQ_WRITE, REQ_READ, REQ_RELEASE
    and REQ_NONE on the device (made once by the caller). Returns bool
    [T, K]. The plain path runs it with ``sorted_grant``, the kernel
    path above lock_grant's fused capacity with the kernel; below it the
    fused kernel takes the whole chain's place."""
    T, K = keys.shape
    R = wh_r.shape[0]
    c_write, c_read, c_release, c_none = kind_consts
    ent_kind = torch.where(
        pend2d,
        torch.where(modes == MODE_WRITE, c_write, c_read),
        torch.where(rel_entries, c_release, c_none),
    ).reshape(-1)
    ent_key = torch.where(pend2d | rel_entries, keys, KEY_SENTINEL).reshape(-1)
    ent_enq = enq.reshape(-1)
    safe = torch.clamp(ent_key, max=R - 1).long()
    in_rng = ent_key < R
    wh_ent = wh_r[safe]
    wh_free = (wh_ent == -1) & in_rng
    rcv = torch.where(in_rng, rc_r[safe], 0)
    order = lex_order(ent_key, ent_enq)
    g_sorted = grant_sorted(
        ent_key[order], ent_kind[order], wh_free[order], rcv[order]
    )
    grant = torch.empty_like(g_sorted)
    grant[order] = g_sorted  # unsort
    # re-entrant grants bypass the FIFO
    self_grant = (
        (ent_kind != REQ_NONE)
        & (ent_kind != REQ_RELEASE)
        & in_rng
        & (wh_ent == ent_slot)
    )
    return (grant | self_grant).view(T, K)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(I32)


def make_step(cfg: EngineConfig, meta: PlanMeta,
              device: torch.device | str = "cuda"):
    """Build the single-round transition for this config and plan shape.

    Returns ``step(p, s, r_end)``: ``p`` the plan tensors (see
    :func:`plan_device`), ``s`` the round state, ``r_end`` the exclusive
    chunk bound (an int32 0-d tensor) that event leaps are clamped to.
    The step returns a new state dict; it updates the per-record arrays
    of ``DROP_ROW_ARRAYS`` in place (``sweep.guard_step`` keeps them
    when the step must not run).
    """
    dev = torch.device(device)
    cm = cfg.cost
    T, K = cfg.n_slots, meta.max_keys
    R = meta.num_records
    N = meta.n_txns
    W = cfg.window
    n_cc = max(cfg.n_cc, 1)
    cap_keys = cm.cc_keys_per_round
    orthrus = cfg.is_orthrus
    has_lane_stream = meta.lane_cols > 0
    # open epoch arrival: admission also waits for the txn's epoch. The
    # overload layer's kinds are statics; their parameters ride the
    # plan dict as scalars (pol_*)
    open_arrival = cfg.epoch_interval_rounds > 0
    policy = cfg.admission_policy
    exp_backoff = cfg.backoff_mode == "exp"
    has_budget = cfg.retry_budget > 0
    bursty = cfg.arrival_pattern != "uniform"

    consts: dict = {}

    def const(v):
        """The int32 0-d tensor ``v`` on the device, made once: a step
        copies nothing from the host (a CUDA graph cannot capture that
        copy)."""
        if v not in consts:
            consts[v] = torch.tensor(v, dtype=I32, device=dev)
        return consts[v]

    for v in (INIT, ACQ, MSG, READY, EXEC, REL, CAT_LOCK, CAT_DL, I32_MIN,
              -1):
        const(v)  # every constant the step asks for, made here
    lane_of = torch.arange(T, dtype=I32, device=dev) // W
    lane_idx = lane_of.long()
    slot_ids = torch.arange(T, dtype=I32, device=dev)
    kk = torch.arange(K, dtype=I32, device=dev)
    lat_pow2 = torch.tensor([1 << k for k in range(LAT_BUCKETS - 1)],
                            dtype=I32, device=dev)
    qgrid_pos = torch.arange(QDEPTH_SAMPLES, dtype=I32, device=dev) + 1
    ent_slot = slot_ids[:, None].expand(T, K).reshape(-1)
    lane2d = lane_of[:, None].expand(T, K)
    # within-slot key order (stage 4): [1, K, K] "column j before column i"
    k_before = (kk[None, None, :] < kk[None, :, None])
    kind_consts = tuple(map(const, (REQ_WRITE, REQ_READ, REQ_RELEASE,
                                    REQ_NONE)))
    c_zero, c_one = const(0), const(1)
    c_wait, c_msg, c_idle = const(CAT_WAIT), const(CAT_MSG), const(CAT_IDLE)
    c_exec = const(CAT_EXEC)
    c_empty, c_backoff = const(EMPTY), const(BACKOFF)
    c_n, c_base = const(N), const(cm.abort_backoff_rounds)

    lock_op_cycles = (
        cm.partition_lock_cycles
        if cfg.protocol == "partitioned_store"
        else cm.lock_op_cycles
    )
    # shared-index cache penalty (paper §4.3): partitioned-store and SPLIT
    # variants probe thread-local indexes; everyone else shares one index
    shared_index = cfg.protocol != "partitioned_store" and not cfg.split_index
    exec_cycles_per_op = cm.exec_op_cycles + (
        cm.shared_index_penalty_cycles if shared_index else 0
    )
    dl = cfg.deadlock_scheme
    dl_wait_cycles = {
        "waitfor": cm.waitfor_maintain_cycles,
        "dreadlocks": cm.dreadlocks_spin_cycles,
    }.get(dl, 0)
    # compact CSR release / wait-for path (EngineConfig.release_path)
    use_csr = cfg.release_path == "csr" and not orthrus
    need_rdr = use_csr and dl != "none"
    # reader-bitmask word and bit per slot; bit 31 is INT32_MIN, and the
    # words add and subtract it with int32 wraparound, as the reference
    n_words = (T + 31) // 32
    rdr_word = (slot_ids // 32).long()
    rdr_shift = slot_ids % 32
    bit64 = torch.ones(T, dtype=torch.int64, device=dev) << rdr_shift
    rdr_bit = _wrap32(bit64)
    rdr_unbit = _wrap32(-bit64)
    if dl in ("waitfor", "dreadlocks"):
        own = torch.eye(T, dtype=torch.bool, device=dev)
    # the grant decision (stage 7): on the kernel path the whole pass is
    # one launch of lock_grant's fused form up to its capacity, its
    # output allocated here once; above it the sorted form runs between
    # the engine's own sort and unsort. The plain path runs the plain
    # formulation. CPU tensors take each wrapper's plain version.
    grant_out = None
    grant_sorted = sorted_grant
    if orthrus and use_kernel(cfg.kernel_impl, dev):
        from repro_torch.kernels.lock_grant import ops as lg_ops

        if T * K <= lg_ops.STEP_CAPACITY:
            grant_out = lg_ops.step_output(T, K, R, dev)
        else:
            def grant_sorted(keys, kind, wh_free, rc):
                return lg_ops.lock_grant_sorted(keys, kind, wh_free, rc)[0]

    def rounds_of(cyc):
        return (cyc + cm.cycles_per_round - 1) // cm.cycles_per_round

    exec_rounds_one = rounds_of(exec_cycles_per_op)

    def take_col(a, col):
        """a[t, col[t]] for a [T, K] array and a [T] column index."""
        return torch.gather(a, 1, col[:, None]).squeeze(1)

    def lane_next(lane_stream, lane_ctr):
        """lane_stream[slot, lane_ctr % M] per slot; slots past the
        stream's rows read its last row (the reference's gather clamps)."""
        rows = torch.clamp(slot_ids, max=lane_stream.shape[0] - 1).long()
        return lane_stream[rows, (lane_ctr % meta.lane_cols).long()]

    def step(p, s, r_end):
        s = dict(s)
        r = s["r"]
        wkeys = p["keys"]
        wmodes = p["modes"]
        wpart = p["part"]
        sc_all = p["txn_scalars"]  # [N, 4] = (nkeys, exec_ops, ollp, miss)

        sl = s["slots"]
        tid = sl[C_TID]
        widx = sl[C_WIDX]
        lane_ctr = sl[C_LANE_CTR]
        ts = sl[C_TS]
        phase = sl[C_PHASE]
        committing = sl[C_COMMITTING] != 0
        busy_until = sl[C_BUSY_UNTIL]
        busy_kind = sl[C_BUSY_KIND]
        kptr = sl[C_KPTR]
        attempt = sl[C_ATTEMPT]
        ccptr = sl[C_CCPTR]
        msg_arrive = sl[C_MSG_ARRIVE]
        msg_stage = sl[C_MSG_STAGE]
        release_at = sl[C_RELEASE_AT]
        waited = sl[C_WAITED] != 0
        dl_debt = sl[C_DL_DEBT]
        arrive = sl[C_ARRIVE]

        free = busy_until <= r

        if open_arrival:
            # closed forms over the arrival schedule (saturating: ids
            # and rounds past the int32-exact range read as "never")
            def arr_of(g):
                # arrival round of global txn id g (the workload wraps
                # modulo N every arrive_cycle rounds)
                return _at(p["arrive_round"], g % N) + _sat_mul(
                    g // N, p["arrive_cycle"])

            def arrived_by(x):
                # txns with arrival round <= x, the exact inverse of
                # arr_of: arrived_by(x) > g iff x >= arr_of(g)
                cyc = p["arrive_cycle"]
                xp = torch.clamp(x, min=0)
                if bursty:
                    in_cyc = _searchsorted_right(
                        p["ep_arrive"], xp % cyc) * p["epoch_txns"]
                else:
                    in_cyc = (
                        xp % cyc // p["epoch_interval"] + 1
                    ) * p["epoch_txns"]
                n_in = torch.clamp(in_cyc, max=N)
                return torch.where(x < 0, c_zero,
                                   _sat_mul(xp // cyc, c_n) + n_in)

        # --------------------------------------- 1a. admission-control drops
        # Queue-side drops advance next_txn before slot ranking, so a
        # dropped txn is never loaded. Drops happen at executed rounds
        # only; the stage-12 leap candidates keep every drop round one.
        if policy == "bounded_backlog":
            # drop the oldest waiters beyond the backlog cap
            drop = torch.clamp(
                arrived_by(r) - p["pol_cap"] - s["next_txn"], min=0)
            s["pol_rejected"] = s["pol_rejected"] + drop
            s["next_txn"] = s["next_txn"] + drop
        elif policy == "deadline_shed":
            # drop waiters whose queueing delay exceeds the deadline
            drop = torch.clamp(
                arrived_by(r - p["pol_deadline"] - 1) - s["next_txn"], min=0)
            s["pol_shed"] = s["pol_shed"] + drop
            s["next_txn"] = s["next_txn"] + drop

        # ------------------------------------------ 1+2. admission & retry
        empty = phase == EMPTY
        if has_lane_stream:
            # H-Store routing: each worker lane pulls the next txn homed
            # to its partition (lanes with no homed txns stay idle)
            new_widx = lane_next(p["lane_stream"], lane_ctr)
            adm = empty & (new_widx >= 0)
            new_tid = lane_ctr * T + slot_ids
            lane_ctr = torch.where(adm, lane_ctr + 1, lane_ctr)
        else:
            rank = torch.cumsum(empty, 0, dtype=I32) - 1
            new_tid = s["next_txn"] + rank
            if open_arrival:
                # arrival is monotone in the global id, so the admitted
                # set is a prefix of the ranked empty slots
                arr_t = arr_of(new_tid)
                adm = empty & (arr_t <= r)
                if policy == "token_bucket":
                    # backpressure: txn g also waits for token g (the
                    # bucket starts with token_burst and refills one
                    # every token_interval_rounds)
                    adm = adm & (
                        new_tid < p["pol_tb_burst"] + r // p["pol_tb_iv"])
                    s["pol_tb_adm"] = s["pol_tb_adm"] + adm.sum(dtype=I32)
            else:
                adm = empty
            new_widx = new_tid % N
        s["next_txn"] = s["next_txn"] + adm.sum(dtype=I32)
        retry = (phase == BACKOFF) & free
        reset = adm | retry
        widx = torch.where(adm, new_widx, widx)
        tid = torch.where(adm, new_tid, tid)
        ts = torch.where(adm, new_tid, ts)
        # arrival stamp: the epoch's arrival under open arrival (latency
        # includes queueing), else the admission round; retries keep it
        arrive = torch.where(adm, arr_t if open_arrival else r, arrive)
        attempt = torch.where(
            adm, c_zero, torch.where(retry, attempt + 1, attempt)
        )
        wsafe = torch.where(tid >= 0, widx % N, 0).long()
        keys = wkeys[wsafe]
        modes = wmodes[wsafe]
        ccids = wpart[wsafe] % n_cc
        sc = sc_all[wsafe]
        nkeys = sc[:, 0]
        execops = sc[:, 1]
        ollp = sc[:, 2] != 0
        miss = sc[:, 3] != 0
        kvalid = kk[None, :] < nkeys[:, None]
        init_busy = rounds_of(
            cm.txn_fixed_cycles + torch.where(ollp, cm.recon_cycles, 0)
        ).to(I32)
        phase = torch.where(reset, const(INIT), phase)
        busy_until = torch.where(
            adm,
            r + init_busy,
            torch.where(retry, r + rounds_of(cm.txn_fixed_cycles),
                        busy_until),
        )
        busy_kind = torch.where(reset, const(CAT_LOCK), busy_kind)
        keep = ~reset[:, None]
        for f in ("want", "granted", "adm_done", "rel_done"):
            s[f] = s[f] & keep
        kptr = torch.where(reset, c_zero, kptr)
        ccptr = torch.where(reset, c_zero, ccptr)
        waited = waited & ~reset

        free = busy_until <= r

        # ------------------------------------------------ 3. INIT -> acquire
        start = (phase == INIT) & free & (tid >= 0)
        if orthrus:
            phase = torch.where(start, const(MSG), phase)
            msg_stage = torch.where(start, c_zero, msg_stage)
            msg_arrive = torch.where(start, r + cm.msg_hop_rounds, msg_arrive)
        else:
            phase = torch.where(start, const(ACQ), phase)

        # ------------------------------------------------ 4. ORTHRUS CC work
        if orthrus:
            def cur_group(ccptr):
                cc_at = take_col(ccids, torch.clamp(ccptr, max=K - 1).long())
                return (
                    (kk[None, :] >= ccptr[:, None])
                    & kvalid
                    & (ccids == cc_at[:, None])
                )

            in_cur_group = cur_group(ccptr)
            acq_cand = (phase == MSG) & (msg_stage == 0) & (msg_arrive <= r)
            acq_keys = acq_cand[:, None] & in_cur_group & ~s["adm_done"]
            rel_cand = (phase == REL) & (release_at <= r)
            rel_keys = rel_cand[:, None] & s["granted"] & ~s["rel_done"]
            # rank every active entry within its CC lane by (ts, key
            # slot): a [T] slot sort plus per-CC prefix counts
            act2d = acq_keys | rel_keys  # [T, K]
            cc_act = torch.where(act2d, ccids, n_cc)
            cnt_tc = torch.zeros(T * (n_cc + 1), dtype=I32, device=dev)
            cnt_tc.index_add_(
                0, (slot_ids[:, None] * (n_cc + 1) + cc_act).reshape(-1),
                torch.ones(T * K, dtype=I32, device=dev),
            )
            cnt_tc = cnt_tc.view(T, n_cc + 1)
            slot_order = torch.sort(ts, stable=True).indices  # ts unique
            cnt_sorted = cnt_tc[slot_order]
            excl_sorted = torch.cumsum(cnt_sorted, 0, dtype=I32) - cnt_sorted
            excl = torch.empty_like(excl_sorted)
            excl[slot_order] = excl_sorted
            base_rank = torch.gather(excl, 1, cc_act.long())
            same_cc_earlier = (
                (cc_act[:, :, None] == cc_act[:, None, :])
                & act2d[:, None, :]
                & k_before
            )
            within = same_cc_earlier.sum(-1, dtype=I32)
            seg_pos2d = base_rank + within + 1  # 1-based within CC lane
            proc2d = (seg_pos2d <= cap_keys) & act2d
            s["adm_done"] = s["adm_done"] | (proc2d & acq_keys)
            # group fully admitted -> requests live in the CC's lock table
            grp_all = (s["adm_done"] | ~in_cur_group).all(dim=1)
            admit_now = acq_cand & grp_all
            new_want = admit_now[:, None] & in_cur_group
            phase = torch.where(admit_now, const(ACQ), phase)
            # release processing
            do_rel = proc2d & rel_keys
            rel_k = torch.where(do_rel, keys, 0)
            is_wr = do_rel & (modes == MODE_WRITE)
            s["wh"].index_fill_(
                0, torch.where(is_wr, rel_k, R).reshape(-1).long(), -1)
            is_rd = do_rel & (modes == MODE_READ)
            s["rc"].index_add_(
                0, torch.where(is_rd, rel_k, R).reshape(-1),
                -is_rd.reshape(-1).to(I32),
            )
            s["rel_done"] = s["rel_done"] | do_rel
            s["granted"] = s["granted"] & ~do_rel
            rel_entries = torch.zeros((T, K), dtype=torch.bool, device=dev)
        else:
            # ------------------------------------------ 5. shared releases
            rel_now = (phase == REL) & (release_at <= r)
            rel_entries = rel_now[:, None] & s["granted"]
            rel_k = torch.where(rel_entries, keys, 0)
            is_wr = rel_entries & (modes == MODE_WRITE)
            s["wh"].index_fill_(
                0, torch.where(is_wr, rel_k, R).reshape(-1).long(), -1)
            is_rd = rel_entries & (modes == MODE_READ)
            s["rc"].index_add_(
                0, torch.where(is_rd, rel_k, R).reshape(-1),
                -is_rd.reshape(-1).to(I32),
            )
            if need_rdr:
                # clear the slot's reader bit once per *distinct* released
                # read key: a slot releases all its granted entries at
                # once, and re-entrant reads may hold several columns on
                # one record; only the first contributes
                dup = (
                    (keys[:, :, None] == keys[:, None, :])
                    & is_rd[:, None, :]
                    & k_before
                ).any(-1)
                first_rd = is_rd & ~dup
                cell = torch.where(first_rd, rel_k, R) * n_words + (
                    rdr_word[:, None])
                s["rdr"].view(-1).index_add_(
                    0, cell.reshape(-1),
                    torch.where(first_rd, rdr_unbit[:, None], c_zero)
                    .reshape(-1),
                )
            s["granted"] = s["granted"] & ~rel_entries

        # ------------------------------------------------ 6. requests: want
        if orthrus:
            s["want"] = s["want"] | new_want
            want_new = new_want
            flat_new = want_new.reshape(-1)
            new_rank = torch.cumsum(flat_new, 0, dtype=I32) - 1
            enq_val = (s["enq_ctr"] + new_rank).view(T, K)
            s["enq"] = torch.where(want_new, enq_val, s["enq"])
            n_new = flat_new.sum(dtype=I32)
        else:
            # single in-flight request at kptr when ACQ & free
            at_k = kk[None, :] == kptr[:, None]
            need = (
                ((phase == ACQ) & free)[:, None]
                & at_k
                & kvalid
                & ~s["granted"]
                & ~s["want"]
            )
            want_new = need
            s["want"] = s["want"] | need
            # <= 1 new request per slot: rank over [T]
            new_t = want_new.any(dim=1)
            new_rank = torch.cumsum(new_t, 0, dtype=I32) - 1
            s["enq"] = torch.where(
                want_new, (s["enq_ctr"] + new_rank)[:, None], s["enq"]
            )
            n_new = new_t.sum(dtype=I32)
        # releases consume stamp ids too
        s["enq_ctr"] = s["enq_ctr"] + n_new + rel_entries.sum(dtype=I32)

        # ------------------------------------------------ 7. grant pass
        pend2d = s["want"] & ~s["granted"] & (phase == ACQ)[:, None]
        newop2d = want_new | rel_entries
        wh_r, rc_r = s["wh"][:R], s["rc"][:R]
        if orthrus:
            if grant_out is not None:
                # one launch: kinds, keys, table gathers, grant, self-grant
                grant = lg_ops.lock_grant_step(
                    keys, modes, pend2d, rel_entries, s["enq"], s["wh"],
                    s["rc"], R, out=grant_out,
                )
            else:
                grant = grant_chain(keys, modes, pend2d, rel_entries,
                                    s["enq"], wh_r, rc_r, ent_slot,
                                    kind_consts, grant_sorted)
            # apply grants to the lock table
            gk = torch.where(grant, keys, 0)
            g_wr = grant & (modes == MODE_WRITE)
            g_rd = grant & (modes == MODE_READ)
            wr_idx = torch.where(g_wr, gk, R).reshape(-1).long()
            s["wh"][wr_idx] = ent_slot
            s["rc"].index_add_(
                0, torch.where(g_rd, gk, R).reshape(-1),
                g_rd.reshape(-1).to(I32),
            )
        else:
            # single pending request per slot, at column kptr
            kptr_c = torch.clamp(kptr, max=K - 1).long()
            pend_t = take_col(pend2d, kptr_c)
            rkey = take_col(keys, kptr_c)
            renq = take_col(s["enq"], kptr_c)
            rmode = take_col(modes, kptr_c)
            is_wr_req = pend_t & (rmode == MODE_WRITE)
            if use_csr:
                # compact CSR grant over the <= T requests sorted by
                # (key, stamp): segmented minima of the stamps
                skey = torch.where(pend_t, rkey, _IMAX)
                order = lex_order(skey, renq)
                ks = skey[order]
                eqs = renq[order]
                seg_id = (
                    torch.cumsum(segment_starts(ks), 0, dtype=I32) - 1
                ).long()
                imax_t = torch.full((T,), _IMAX, dtype=I32, device=dev)
                min_req_seg = imax_t.scatter_reduce(
                    0, seg_id, eqs, "amin", include_self=True
                )
                min_wr_seg = imax_t.scatter_reduce(
                    0, seg_id, torch.where(is_wr_req[order], eqs, _IMAX),
                    "amin", include_self=True,
                )
                min_req = torch.empty_like(renq)
                min_req[order] = min_req_seg[seg_id]
                min_wr = torch.empty_like(renq)
                min_wr[order] = min_wr_seg[seg_id]
            else:
                # the all-pairs [T, T] stamp comparison
                same_key = (rkey[None, :] == rkey[:, None]) & pend_t[None, :]
                enq_b = renq[None, :].expand(T, T)
                min_wr = torch.where(
                    same_key & is_wr_req[None, :], enq_b, _IMAX
                ).amin(dim=1)
                min_req = torch.where(same_key, enq_b, _IMAX).amin(dim=1)
            rkey_c = torch.clamp(rkey, max=R - 1).long()
            whv = wh_r[rkey_c]
            rc_t = rc_r[rkey_c]
            wh_free_t = whv == -1
            # enq stamps are unique, so strict compares are exact
            grant_rd = wh_free_t & (min_wr > renq)
            grant_wr = wh_free_t & (rc_t == 0) & (min_req == renq)
            grant_t = pend_t & torch.where(
                rmode == MODE_WRITE, grant_wr, grant_rd
            )
            grant_t = grant_t | (pend_t & (whv == slot_ids))
            grant = pend2d & grant_t[:, None]

            g_wr_t = grant_t & (rmode == MODE_WRITE)
            g_rd_t = grant_t & (rmode == MODE_READ)
            s["wh"][torch.where(g_wr_t, rkey, R).long()] = slot_ids
            s["rc"].index_add_(
                0, torch.where(g_rd_t, rkey, R), g_rd_t.to(I32)
            )
            if need_rdr:
                # reader bitmask: set the slot's bit on its *first*
                # granted read column of the record; a re-entrant read
                # increments rc but the bit tracks distinct membership
                already = (
                    (keys == rkey[:, None])
                    & s["granted"]
                    & (modes == MODE_READ)
                ).any(dim=1)
                new_rd = g_rd_t & ~already
                s["rdr"].view(-1).index_add_(
                    0, torch.where(new_rd, rkey, R) * n_words + rdr_word,
                    torch.where(new_rd, rdr_bit, c_zero),
                )
        s["granted"] = s["granted"] | grant

        # ------------------------------------------------ 8. deadlock logic
        # (runs before cost charging so a wait-die "die" probe, a read of
        # the holder's timestamp, costs latency but does not occupy the
        # record's meta-data line the way a queue mutation does); the
        # planned protocols have none, abort_dl == 0
        abort_dl = None
        if dl != "none":
            kptr_c = torch.clamp(kptr, max=K - 1).long()
            blocked = (phase == ACQ) & take_col(
                s["want"] & ~s["granted"], kptr_c
            )
            waitkey = torch.where(blocked, take_col(keys, kptr_c),
                                  KEY_SENTINEL)
            waiting = waitkey != KEY_SENTINEL
            mymode = take_col(modes, kptr_c)
            # adj[t, u]: t waits on a lock u holds in a conflicting mode
            if use_csr:
                # compact wait-for: the writer holding my key is one
                # lock-table gather; read holders come from the carried
                # reader bitmask (bit u of word u // 32). A read holder
                # conflicts only with a write waiter; a write holder
                # conflicts with everyone.
                wt_c = torch.clamp(waitkey, max=R - 1).long()
                hw = s["wh"][wt_c]  # [T] writer of my key (-1 = none)
                dig = s["rdr"][wt_c]  # [T, W] packed reader bits
                rd_bits = dig[:, rdr_word]  # [T, T]
                adj_rd = ((rd_bits >> rdr_shift[None, :]) & 1) != 0
                adj = (
                    (slot_ids[None, :] == hw[:, None])
                    | (adj_rd & (mymode == MODE_WRITE)[:, None])
                )
            else:
                key_eq = keys[None, :, :] == waitkey[:, None, None]
                conflict = (mymode[:, None, None] == MODE_WRITE) | (
                    modes[None, :, :] == MODE_WRITE
                )
                adj = (key_eq & s["granted"][None, :, :] & conflict).any(-1)
            adj = (
                adj
                & waiting[:, None]
                & (slot_ids[None, :] != slot_ids[:, None])
                & (tid[None, :] >= 0)
            )
            if dl == "waitdie":
                # a waiter dies whenever its wait-for edge points at an
                # older holder, re-checked on every holder change; the
                # "die" probe is costed as latency only in stage 9
                newly_waiting = waiting & ~waited
                older_holder = (adj & (ts[None, :] < ts[:, None])).any(-1)
                abort_dl = older_holder & waiting
                dl_debt = dl_debt + torch.where(
                    newly_waiting, cm.waitdie_check_cycles, c_zero
                )
            else:
                # one propagation step per round (dreadlocks-style
                # digests); the bool product is an OR of ANDs
                reach = own | (adj[:, :, None] & s["reach"][None]).any(1)
                s["reach"] = torch.where(waiting[:, None], reach, own)
                reach_t = s["reach"].t()
                in_cycle = (adj & reach_t).any(-1)  # holder reaches me
                # abort the youngest member of the detected cycle;
                # waitfor and dreadlocks are logically equivalent
                # detectors (paper §4.1) and differ in their costs
                scc = s["reach"] & reach_t
                scc_ts_max = torch.where(
                    scc & in_cycle[None, :], ts[None, :], -1
                ).amax(dim=1)
                abort_dl = in_cycle & (ts >= scc_ts_max)
                dl_debt = dl_debt + torch.where(
                    waiting, dl_wait_cycles, c_zero
                )
            waited = waiting
            # convert deadlock-handling debt into lane busy time
            debt_rounds = dl_debt // cm.cycles_per_round
            has_debt = debt_rounds > 0
            busy_until = torch.where(
                has_debt, torch.maximum(busy_until, r) + debt_rounds,
                busy_until,
            )
            busy_kind = torch.where(has_debt, const(CAT_DL), busy_kind)
            dl_debt = dl_debt % cm.cycles_per_round

            abort_dl = abort_dl & waiting
            s["aborts_dl"] = s["aborts_dl"] + abort_dl.sum(dtype=I32)
            s["wasted"] = s["wasted"] + torch.where(
                abort_dl, kptr, c_zero
            ).sum(dtype=I32)
            phase = torch.where(abort_dl, const(REL), phase)
            committing = committing & ~abort_dl
            release_at = torch.where(abort_dl, r, release_at)
            s["want"] = s["want"] & ~abort_dl[:, None]

        # ------------------------------------------------ 9. line-cost model
        if not orthrus:
            newop = newop2d
            mutate = newop  # fresh ops enqueue ...
            if abort_dl is not None:
                mutate = mutate & ~abort_dl[:, None]  # ... dies do not
            active2d = pend2d | rel_entries
            aidx = torch.where(active2d, keys, R)
            sum_upd = torch.stack(
                [active2d.to(I32), newop.to(I32), mutate.to(I32)], dim=-1
            )  # [T, K, 3]
            s["agg_sum"].index_add_(
                0,
                torch.cat([s["agg_prev_idx"], aidx], 0).reshape(-1),
                torch.cat([-s["agg_prev_upd"], sum_upd], 0).reshape(-1, 3),
            )
            agg_s = s["agg_sum"]
            s["agg_prev_idx"] = aidx
            s["agg_prev_upd"] = sum_upd
            e = r >> EPOCH_BITS
            opk_r = torch.clamp(torch.where(newop, keys, 0), max=R - 1).long()
            seg = agg_s[opk_r]  # [T, K, 3], this round's per-key totals
            contend = seg[..., 0]
            new_in_seg = seg[..., 1]
            mut_in_seg = seg[..., 2]
            heat_k = s["heat"][opk_r]  # [T, K, 3] = (ep, cnt_cur, cnt_prev)
            ep_k = heat_k[..., 0]
            cur_k = heat_k[..., 1]
            prev_k = heat_k[..., 2]
            line_k = s["line"][opk_r]  # [T, K, 2] = (lnf, last_lane)
            sharers = torch.where(
                ep_k == e,
                torch.maximum(prev_k, cur_k),
                torch.where(ep_k == e - 1, cur_k, c_zero),
            )
            remote = line_k[..., 1] != lane2d
            coh = torch.where(
                remote,
                cm.coherence_cycles_per_sharer
                * torch.clamp(sharers, 1, cfg.n_exec - 1),
                c_zero,
            )
            if dl == "dreadlocks":
                # waiters spin on the holders' digests: every queued
                # waiter keeps the lock meta-data lines hot, so each op
                # pays extra coherence in the current queue (paper §4.4.1)
                coh = coh + cm.dreadlocks_spin_cycles * torch.clamp(
                    contend - 1, min=0
                )
            dur = rounds_of(lock_op_cycles + coh)
            lnf_cur = line_k[..., 0]
            backlog = torch.clamp(
                torch.where(mutate, lnf_cur - r, c_zero), min=0
            )
            charge = torch.where(newop, backlog + dur, c_zero).sum(
                dim=1, dtype=I32
            )
            # occupancy: same-round queue mutations serialize on the line
            occupy = torch.where(mutate, mut_in_seg * dur, c_zero)
            tgt = torch.maximum(lnf_cur, r) + occupy
            opk_heat = torch.where(newop, opk_r, R).reshape(-1)
            # lnf only at mutating entries (INT32_MIN is the max identity);
            # last_lane at every fresh op
            line_upd = torch.stack(
                [torch.where(mutate, tgt, const(I32_MIN)), lane2d], dim=-1
            ).reshape(-1, 2)
            s["line"].scatter_reduce_(
                0, opk_heat[:, None].expand(-1, 2), line_upd, "amax",
                include_self=True,
            )
            new_prev = torch.where(
                ep_k == e, prev_k, torch.where(ep_k == e - 1, cur_k, c_zero)
            )
            new_cur = torch.where(ep_k == e, cur_k, c_zero) + new_in_seg
            heat_upd = torch.stack(
                [e.expand(T, K), new_cur, new_prev], dim=-1
            ).reshape(-1, 3)
            # values are per-key identical, so duplicate keys agree
            s["heat"][opk_heat] = heat_upd
            charged = charge > 0
            busy_until = torch.where(
                charged, torch.maximum(busy_until, r) + charge, busy_until
            )
            busy_kind = torch.where(charged, const(CAT_LOCK), busy_kind)

        # ------------------------------------------------ 10. transitions
        free = busy_until <= r
        if cfg.is_dynamic_2pl:
            # one key per go; the txn's extra exec ops are charged on
            # its last key
            cur_granted = take_col(
                s["granted"], torch.clamp(kptr, max=K - 1).long()
            )
            go = (phase == ACQ) & free & cur_granted & ~abort_dl
            last = go & (kptr + 1 >= nkeys)
            extra = torch.clamp(execops - nkeys, min=0)
            add = torch.where(
                go,
                exec_rounds_one
                + torch.where(last, extra * exec_rounds_one, c_zero),
                c_zero,
            )
            busy_until = torch.where(
                go, torch.maximum(busy_until, r) + add, busy_until
            )
            busy_kind = torch.where(go, c_exec, busy_kind)
            kptr = torch.where(go, kptr + 1, kptr)
            phase = torch.where(last, const(EXEC), phase)
        elif not orthrus:  # deadlock_free, partitioned_store
            cur_granted = take_col(
                s["granted"], torch.clamp(kptr, max=K - 1).long()
            )
            go = (phase == ACQ) & free & cur_granted
            kptr = torch.where(go, kptr + 1, kptr)
            alldone = go & (kptr >= nkeys)
            phase = torch.where(alldone, const(EXEC), phase)
            busy_until = torch.where(
                alldone,
                torch.maximum(busy_until, r) + execops * exec_rounds_one,
                busy_until,
            )
            busy_kind = torch.where(alldone, c_exec, busy_kind)
        else:
            in_cur_group = cur_group(ccptr)
            grp_done = (phase == ACQ) & (s["granted"] | ~in_cur_group).all(
                dim=1
            )
            nxt_cc = torch.where(
                (kk[None, :] >= ccptr[:, None]) & kvalid & ~in_cur_group,
                kk[None, :],
                K,
            ).amin(dim=1)
            more = grp_done & (nxt_cc < K)
            ccptr = torch.where(more, nxt_cc, ccptr)
            s["adm_done"] = s["adm_done"] & ~more[:, None]
            phase = torch.where(grp_done, const(MSG), phase)
            msg_stage = torch.where(
                grp_done, torch.where(more, c_zero, c_one), msg_stage
            )
            msg_arrive = torch.where(
                grp_done, r + cm.msg_hop_rounds, msg_arrive
            )
            # response arrives -> READY
            resp = (phase == MSG) & (msg_stage == 1) & (msg_arrive <= r)
            phase = torch.where(resp, const(READY), phase)
            # exec-lane scheduling: oldest READY per idle lane starts
            # (lanes are W consecutive slots)
            lane_busy = ((phase == EXEC) & ~free).view(cfg.n_exec, W).any(1)
            ready = phase == READY
            ready_ts = torch.where(ready, ts, _IMAX)
            lane_min = ready_ts.view(cfg.n_exec, W).amin(dim=1)
            startx = (
                ready
                & (ready_ts == lane_min[lane_idx])
                & ~lane_busy[lane_idx]
            )
            phase = torch.where(startx, const(EXEC), phase)
            busy_until = torch.where(
                startx, r + execops * exec_rounds_one, busy_until
            )
            busy_kind = torch.where(startx, c_exec, busy_kind)

        # EXEC finished -> release (commit, or OLLP-miss abort+retry)
        free = busy_until <= r
        fin = (phase == EXEC) & free
        is_miss = fin & miss & (attempt == 0)
        s["aborts_ollp"] = s["aborts_ollp"] + is_miss.sum(dtype=I32)
        s["wasted"] = s["wasted"] + torch.where(is_miss, execops, c_zero).sum(
            dtype=I32
        )
        phase = torch.where(fin, const(REL), phase)
        committing = torch.where(fin, ~is_miss, committing)
        rel_delay = cm.msg_hop_rounds if orthrus else 0
        release_at = torch.where(fin, r + rel_delay, release_at)
        s["rel_done"] = s["rel_done"] & ~fin[:, None]
        s["want"] = s["want"] & ~fin[:, None]

        # REL complete -> EMPTY (commit) or BACKOFF (retry)
        rel_done_all = (
            (phase == REL) & (release_at <= r) & ~s["granted"].any(dim=1)
        )
        com = rel_done_all & committing
        s["commits"] = s["commits"] + com.sum(dtype=I32)
        # commit-latency histogram (bucket = count of powers of two <= lat)
        lat = r - arrive
        lat_b = (lat[:, None] >= lat_pow2[None, :]).sum(dim=1, dtype=I32)
        s["lat_hist"] = s["lat_hist"].index_add(
            0, torch.where(com, lat_b, 0), com.to(I32)
        )
        aborting = rel_done_all & ~committing
        if exp_backoff:
            # bounded exponential backoff, base << attempt shift-capped
            # then clamped (cost_model.exp_backoff_rounds)
            bo = torch.minimum(
                c_base << torch.clamp(attempt, max=BACKOFF_SHIFT_CAP),
                p["pol_bo_max"],
            )
        else:
            bo = cm.abort_backoff_rounds
        leave, drop_tid, back = committing, com, aborting
        if has_budget or policy == "deadline_shed":
            # give up instead of backing off when the retry budget is
            # spent (pol_sacrificed, checked first) or, under
            # deadline_shed, when the end-to-end latency already blew
            # the deadline (pol_timedout)
            give_up = torch.zeros_like(aborting)
            if has_budget:
                sac = aborting & (attempt + 1 >= p["pol_retry_budget"])
                s["pol_sacrificed"] = s["pol_sacrificed"] + sac.sum(
                    dtype=I32)
                give_up = give_up | sac
            if policy == "deadline_shed":
                timed = (aborting & ~give_up
                         & (r - arrive > p["pol_deadline"]))
                s["pol_timedout"] = s["pol_timedout"] + timed.sum(dtype=I32)
                give_up = give_up | timed
            leave = committing | give_up
            drop_tid = com | give_up
            back = aborting & ~give_up
        if exp_backoff:
            s["pol_backoff_rounds"] = s["pol_backoff_rounds"] + torch.where(
                back, bo, c_zero).sum(dtype=I32)
        phase = torch.where(
            rel_done_all, torch.where(leave, c_empty, c_backoff), phase
        )
        tid = torch.where(drop_tid, const(-1), tid)
        busy_until = torch.where(back, r + bo, busy_until)
        s["want"] = s["want"] & ~rel_done_all[:, None]

        # ------------------------------------------------ 11. lane accounting
        busy = busy_until > r
        slot_cat = torch.where(
            busy,
            busy_kind,
            torch.where(
                (phase == ACQ) & (s["want"] & ~s["granted"]).any(dim=1),
                c_wait,
                torch.where(
                    (phase == MSG) | (phase == READY) | (phase == REL),
                    c_msg,
                    c_idle,
                ),
            ),
        )
        if orthrus:
            # a lane is "exec" if its running slot is busy executing; else
            # classify by the most advanced outstanding slot state
            def lane_any(x):
                return x.view(cfg.n_exec, W).any(dim=1)

            lane_cat = torch.where(
                lane_any(busy & (slot_cat == CAT_EXEC)),
                c_exec,
                torch.where(
                    lane_any(slot_cat == CAT_WAIT),
                    c_wait,
                    torch.where(lane_any(slot_cat == CAT_MSG), c_msg, c_idle),
                ),
            )
            cat_idx = lane_cat
        else:
            cat_idx = slot_cat
        cat_counts = torch.zeros(NCAT, dtype=I32, device=dev).index_add_(
            0, cat_idx, torch.ones_like(cat_idx)
        )

        # ------------------------------------------------ 12. event leap
        # advance straight to the next round at which any slot can act
        if cfg.event_leap:
            busy2 = busy_until > r
            free2 = ~busy2
            cand = torch.where(busy2, busy_until, _IMAX)
            cand = torch.minimum(cand, torch.where(
                (phase == MSG) & (msg_arrive > r), msg_arrive, _IMAX))
            cand = torch.minimum(cand, torch.where(
                (phase == REL) & (release_at > r), release_at, _IMAX))
            if has_lane_stream:
                # a lane with no homed txn left to pull stays idle
                can_adm = lane_next(p["lane_stream"], lane_ctr) >= 0
            elif open_arrival:
                # the earliest admissible txn is global id next_txn; an
                # empty slot acts once it has arrived, and its arrival
                # round is the wake-up until then
                g0 = s["next_txn"]
                arr0 = arr_of(g0)
                if policy == "token_bucket":
                    # ... and once token g0 is granted
                    # (cost_model.token_ready_round)
                    arr0 = torch.maximum(arr0, _sat_mul(
                        torch.clamp(g0 - p["pol_tb_burst"] + 1, min=0),
                        p["pol_tb_iv"],
                    ))
                can_adm = arr0 <= r + 1
                cand = torch.minimum(cand, torch.where(
                    (phase == EMPTY).any(), arr0, _IMAX))
                # the next policy drop round is a wake-up of its own,
                # closed-form in next_txn, so stage 1a stays dense-exact
                if policy == "bounded_backlog":
                    cand = torch.minimum(cand, arr_of(g0 + p["pol_cap"]))
                elif policy == "deadline_shed":
                    cand = torch.minimum(
                        cand, arr0 + p["pol_deadline"] + 1)
            else:
                can_adm = True
            act_next = (
                ((phase == EMPTY) & can_adm)
                | ((phase == MSG) & (msg_arrive <= r))
                | ((phase == REL) & (release_at <= r))
                | (free2 & ((phase == INIT) | (phase == BACKOFF)))
            )
            if orthrus:
                # a READY slot starts the round its lane goes idle
                lane_exec_busy = (
                    ((phase == EXEC) & busy2).view(cfg.n_exec, W).any(dim=1)
                )
                act_next = act_next | (
                    (phase == READY) & ~lane_exec_busy[lane_idx]
                )
            else:
                # an acquiring slot with no pending request places its
                # next one immediately
                blocked = take_col(
                    s["want"] & ~s["granted"],
                    torch.clamp(kptr, max=K - 1).long(),
                )
                act_next = act_next | ((phase == ACQ) & free2 & ~blocked)
            if dl in ("waitfor", "dreadlocks"):
                # graph detectors evolve every waiting round (reach
                # propagation and per-round spin debt): stay dense while
                # any slot waits
                act_next = act_next | waited.any()
            cand = torch.where(act_next, r + 1, cand)
            nxt = torch.minimum(torch.maximum(cand.min(), r + 1), r_end)
        else:
            nxt = r + 1
        leap = nxt - r
        s["cat"] = s["cat"] + cat_counts * leap
        s["steps"] = s["steps"] + 1
        s["r"] = nxt
        # queue samples at every grid point in (r, nxt]
        qgrid = qgrid_pos * p["qgrid_iv"]
        qm = (qgrid > r) & (qgrid <= nxt)
        s["q_inflight"] = torch.where(
            qm, (tid >= 0).sum(dtype=I32), s["q_inflight"]
        )
        if open_arrival:
            # backlog at grid point x: txns arrived by x minus the
            # admission cursor (policy drops advance the cursor)
            s["q_depth"] = torch.where(
                qm, torch.clamp(arrived_by(qgrid) - s["next_txn"], min=0),
                s["q_depth"],
            )
        s["slots"] = torch.stack(
            [tid, widx, lane_ctr, ts, phase, committing.to(I32),
             busy_until, busy_kind, kptr, attempt, ccptr, msg_arrive,
             msg_stage, release_at, waited.to(I32), dl_debt, arrive],
            dim=0,
        )
        return s

    return step


def _batch_plan_rounds(cfg: EngineConfig, plan: planner_lib.Plan):
    """Per-batch planning latency in rounds (int32[NB]): planner lanes
    place every key-op into the dependency graph / queues and run OLLP
    reconnaissance; the scheduled family charges its clusterer instead.
    Divided by the pipelined planner-lane count ``n_cc``."""
    cm = cfg.cost
    sched = plan.sched
    n_ollp = np.bincount(
        sched.batch_of, weights=plan.ollp.astype(np.int64),
        minlength=sched.num_batches,
    )
    if cfg.protocol == "scheduled":
        work = cm.scheduler_batch_cycles(
            n_txns=sched.batch_size.astype(np.int64),
            n_ops=sched.plan_ops.astype(np.int64),
            n_edges=sched.scan_edges.astype(np.int64),
            n_ollp=n_ollp.astype(np.int64),
        )
    else:
        work = (
            sched.plan_ops.astype(np.int64) * cm.batch_plan_cycles_per_op
            + n_ollp.astype(np.int64) * cm.recon_cycles
        )
    plan_cycles = work // max(cfg.n_cc, 1)
    return np.asarray(cm.rounds(plan_cycles), np.int32)  # [NB]


def _planner_work_rounds(cfg: EngineConfig, plan: planner_lib.Plan):
    """Per-batch planner-lane work in rounds (int32[NB]) under the
    throughput model (``n_planner_lanes > 0``): one lane plans a whole
    batch, and the work scales with the batch's conflict-graph size. Not
    divided by a lane count: planner parallelism is across batches."""
    cm = cfg.cost
    sched = plan.sched
    n_ollp = np.bincount(
        sched.batch_of, weights=plan.ollp.astype(np.int64),
        minlength=sched.num_batches,
    ).astype(np.int64)
    if cfg.protocol == "scheduled":
        cycles = cm.scheduler_batch_cycles(
            n_txns=sched.batch_size.astype(np.int64),
            n_ops=sched.plan_ops.astype(np.int64),
            n_edges=sched.scan_edges.astype(np.int64),
            n_ollp=n_ollp,
        )
        return np.asarray(cm.rounds(cycles), np.int32)
    if cfg.fragment_exec:
        n_edges = sched.frag_edges_per_batch()
        n_frags = sched.batch_fsize.astype(np.int64)
    else:
        n_edges = sched.edges_per_batch()
        n_frags = np.zeros(sched.num_batches, np.int64)
    cycles = cm.planner_batch_cycles(
        n_txns=sched.batch_size.astype(np.int64),
        n_ops=sched.plan_ops.astype(np.int64),
        n_edges=n_edges,
        n_frags=n_frags,
        n_ollp=n_ollp,
    )
    return np.asarray(cm.rounds(cycles), np.int32)


def _batch_state0(cfg: EngineConfig, plan: planner_lib.Plan, T: int,
                  device: torch.device | str = "cuda") -> dict:
    """Initial state of the batch engine, with the extra dropped-write
    row on ``done`` and ``txn_left`` (see the module docstring)."""
    dev = torch.device(device)
    sched = plan.sched
    N = sched.n_txns

    def scalar(v):
        return torch.tensor(int(v), dtype=I32, device=dev)

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    slots = z(BATCH_SLOT_F, T)
    slots[BC_TID] = -1
    s = dict(
        r=z(),
        next_txn=z(),
        cur_batch=z(),
        bpos=z(),
        batch_left=scalar(sched.batch_size[0]),
        plan_fin=scalar(_batch_plan_rounds(cfg, plan)[0]),
        done=z(N + 1, dtype=torch.bool),
        slots=slots,
        commits=z(),
        aborts_dl=z(),
        aborts_ollp=z(),
        wasted=z(),
        cat=z(NCAT),
        steps=z(),
        lat_hist=z(LAT_BUCKETS),
        q_depth=z(QDEPTH_SAMPLES),
        q_inflight=z(QDEPTH_SAMPLES),
    )
    if cfg.fragment_exec:
        # done flags per fragment; the commit barrier counts down each
        # txn's outstanding fragments
        s["done"] = z(sched.n_frags + 1, dtype=torch.bool)
        s["txn_left"] = z(N + 1)
        s["txn_left"][:N] = torch.as_tensor(sched.txn_nfrags, dtype=I32)
    if cfg.inter_batch_pipeline and sched.num_batches > 1:
        # cursor into the next batch's level-0 fragment prefix, and the
        # traffic that ran ahead of the batch barrier
        s["pbpos"] = scalar(sched.batch_fstart[1])
        s["pipe_com"] = z()
        s["pipe_adm"] = z()
        s["pipe_commits"] = z()
    if cfg.n_planner_lanes > 0 or cfg.epoch_interval_rounds > 0:
        s["epoch_ctr"] = z()  # global batch (epoch) index
    # the batch engine sheds whole epochs, so pol_timedout never moves
    s.update(_policy_counters(cfg, dev))
    if cfg.n_planner_lanes > 0:
        # batch 0 arrives at round 0 on a free lane 0, so its plan
        # completes after its own work span
        ready0 = int(_planner_work_rounds(cfg, plan)[0])
        s["plan_fin"] = scalar(ready0)
        s["lane_free"] = z(cfg.n_planner_lanes)
        s["lane_free"][0] = ready0
        s["plan_busy"] = scalar(ready0)
        s["plan_qdelay"] = z()
        s["lane_start"] = z(cfg.n_planner_lanes)
        s["pb_span"] = z(2)
        s["plan_busy_int"] = z()
    return s


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for an int index tensor of any shape, 0-d included, in
    the index's shape. Indexing with a 0-d tensor itself reads the index
    on the host (a device sync)."""
    return x.index_select(0, i.reshape(-1)).reshape(i.shape)


def _searchsorted_right(seq: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(seq, v, side="right")`` as int32, for int32 ``v``
    of any shape and a 1-D int32 ``seq``."""
    return torch.searchsorted(seq, v.reshape(-1), right=True).to(I32).reshape(
        v.shape)


def make_batch_step(cfg: EngineConfig, meta: PlanMeta,
                    device: torch.device | str = "cuda"):
    """Single-round transition of the batch-planned protocols (``dgcc``,
    ``quecc``, ``scheduled``): lock-free execution over a precomputed
    dependency schedule, with the stage numbering of the reference.

    Returns ``step(p, s, r_end)`` with the contract of :func:`make_step`
    (no stamp rebase: this state has no lock table). The step updates
    ``done`` and ``txn_left`` in place. The schedulable unit is a whole
    transaction, or a per-(txn, lane) fragment under
    ``cfg.fragment_exec`` (``done`` is then per fragment and a txn
    commits when its last fragment finishes); with
    ``cfg.inter_batch_pipeline`` the next batch's level-0 fragments are
    admitted while the current batch drains.

    Stage 4, "all planned predecessors committed", is the dep_wavefront
    row form: one launch of the CUDA kernel (its plain version for CPU
    tensors) over the slot rows' edges when ``use_kernel(cfg.kernel_impl,
    device)``, else the dense per-slot gather.
    """
    dev = torch.device(device)
    cm = cfg.cost
    T = cfg.n_slots
    N = meta.n_txns
    W = cfg.window
    NB = meta.num_batches
    frag = cfg.fragment_exec
    NU = meta.n_frags if frag else N
    # one batch cannot pipeline into itself (nothing to overlap)
    pipe = cfg.inter_batch_pipeline and NB > 1
    L = cfg.n_planner_lanes
    planner_model = L > 0
    open_arrival = cfg.epoch_interval_rounds > 0
    # the overload layer reduces to epoch-granular admission control
    # here (no abort path): bounded_backlog and deadline_shed skip stale
    # whole epochs at rollover, token_bucket delays an epoch's plan start
    policy = cfg.admission_policy
    bursty = cfg.arrival_pattern != "uniform"

    slot_ids = torch.arange(T, dtype=I32, device=dev)
    lane_idx = (slot_ids // W).long()
    lane_ids = torch.arange(L, dtype=I32, device=dev)
    lat_pow2 = torch.tensor([1 << k for k in range(LAT_BUCKETS - 1)],
                            dtype=I32, device=dev)
    qgrid_pos = torch.arange(QDEPTH_SAMPLES, dtype=I32, device=dev) + 1
    lane_ones = torch.ones(cfg.n_exec, dtype=I32, device=dev)
    neg_ones = torch.full((T,), -1, dtype=I32, device=dev)
    c_zero = torch.zeros((), dtype=I32, device=dev)
    c_nu = torch.tensor(NU, dtype=I32, device=dev)
    shared_index = not cfg.split_index
    exec_cycles_per_op = cm.exec_op_cycles + (
        cm.shared_index_penalty_cycles if shared_index else 0
    )
    P = meta.frag_pred_width if frag else meta.pred_width
    # stage 4 on the kernel path: one launch of dep_wavefront's row form,
    # its output allocated here once
    rows_out = None
    if use_kernel(cfg.kernel_impl, dev) and P > 0:
        from repro_torch.kernels.dep_wavefront import ops as dw_ops

        rows_out = dw_ops.rows_output(T, P, NU + 1, dev)

    def rounds_of(cyc):
        return (cyc + cm.cycles_per_round - 1) // cm.cycles_per_round

    exec_rounds_one = rounds_of(exec_cycles_per_op)

    def lane_any(x):
        """[n_exec]: any slot of the lane (lanes are W consecutive slots)."""
        return x.view(cfg.n_exec, W).any(dim=1)

    def step(p, s, r_end):
        s = dict(s)
        r = s["r"]
        if frag:
            ne_all = p["frag_ne"]  # [F, 2] = (npred, exec_ops)
            pred_pad = p["frag_pred_pad"]  # [F, PF]
            unit_batch = p["frag_batch"]
            ustart = p["batch_fstart"]
            usize = p["batch_fsize"]
        else:
            ne_all = p["txn_ne"]  # [N, 2] = (npred, exec_ops)
            pred_pad = p["pred_pad"]  # [N, P]
            unit_batch = p["batch_of"]
            ustart = p["batch_start"]
            usize = p["batch_size"]
        batch_of = p["batch_of"]  # [N] txn-level (commit barrier)
        bsize = p["batch_size"]
        done = s["done"]  # [NU + 1], updated in place
        if planner_model or open_arrival:
            interval = p["epoch_interval"]
        if open_arrival:
            # closed forms over the epoch-arrival schedule (saturating):
            # epoch g arrives whole at ep_arrival(g); epochs_arrived_by
            # is its exact inverse
            if bursty:
                def ep_arrival(g):
                    return _sat_mul(
                        g // p["sched_epochs"], p["sched_period"]
                    ) + _at(p["ep_sched"], g % p["sched_epochs"])

                def epochs_arrived_by(x):
                    xp = torch.clamp(x, min=0)
                    cnt = _sat_mul(
                        xp // p["sched_period"], p["sched_epochs"]
                    ) + _searchsorted_right(
                        p["ep_sched"], xp % p["sched_period"])
                    return torch.where(x < 0, c_zero, cnt)
            else:
                def ep_arrival(g):
                    return _sat_mul(g, interval)

                def epochs_arrived_by(x):
                    return torch.where(
                        x < 0, c_zero, torch.clamp(x, min=0) // interval + 1)

            def units_before(g):
                # schedulable units in global epochs [0, g) (fragments
                # in fragment mode; the workload wraps modulo NB)
                return _sat_mul(g // NB, c_nu) + _at(p["cum_usize"], g % NB)

        sl = s["slots"]
        tid = sl[BC_TID]
        widx = sl[BC_WIDX]
        ts = sl[BC_TS]
        phase = sl[BC_PHASE]
        busy_until = sl[BC_BUSY_UNTIL]
        busy_kind = sl[BC_BUSY_KIND]
        msg_arrive = sl[BC_MSG_ARRIVE]
        ftxn = sl[BC_FTXN]
        arrive = sl[BC_ARRIVE]

        # -------------------------------------------- 1. batch rollover
        # When every transaction of the current batch has committed, open
        # the next one; its plan is ready one planning span after the
        # last one (pipelined planners), or, under the planner-lane
        # model, after lane g % L has planned it end to end.
        adv = s["batch_left"] == 0
        if policy in ("bounded_backlog", "deadline_shed"):
            # epoch-granular shedding at rollover (an executed round in
            # dense and leaped runs alike): skip past the epochs beyond
            # the backlog cap, or those whose queueing delay already
            # exceeds the deadline. Dropped units advance next_txn, so
            # the backlog samples see them leave the queue.
            g_next = s["epoch_ctr"] + 1
            if policy == "bounded_backlog":
                floor_g = epochs_arrived_by(r) - p["pol_cap_epochs"]
            else:
                floor_g = epochs_arrived_by(r - p["pol_deadline"] - 1)
            skip = torch.where(adv, torch.clamp(floor_g - g_next, 0, _SAT),
                               c_zero)
            dropped = units_before(g_next + skip) - units_before(g_next)
            ckey = ("pol_rejected" if policy == "bounded_backlog"
                    else "pol_shed")
            s[ckey] = s[ckey] + dropped
            s["next_txn"] = s["next_txn"] + dropped
        else:
            skip = 0
        new_b = torch.where(adv, (s["cur_batch"] + 1 + skip) % NB,
                            s["cur_batch"])
        # stale flags (the workload wraps modulo NB) are cleared one
        # batch ahead of admission
        clr_b = (new_b + 1) % NB if pipe else new_b
        done[:NU].masked_fill_(adv & (unit_batch == clr_b), False)
        if frag:
            tl = s["txn_left"]  # [N + 1], updated in place
            tl[:N] = torch.where(adv & (batch_of == clr_b), p["txn_nfrags"],
                                 tl[:N])
        if pipe:
            # admission continues where the pipelined cursor stopped;
            # commits that ran ahead of the barrier are already paid
            s["bpos"] = torch.where(adv, s["pbpos"], s["bpos"])
            s["pbpos"] = torch.where(adv, _at(ustart, clr_b), s["pbpos"])
            s["batch_left"] = torch.where(
                adv, _at(bsize, new_b) - s["pipe_com"], s["batch_left"]
            )
            s["pipe_com"] = torch.where(adv, 0, s["pipe_com"])
        else:
            s["bpos"] = torch.where(adv, _at(ustart, new_b), s["bpos"])
            s["batch_left"] = torch.where(adv, _at(bsize, new_b),
                                          s["batch_left"])
        if planner_model or open_arrival:
            g_new = s["epoch_ctr"] + 1 + skip  # the new batch's global index
            if open_arrival:
                arrive_new = ep_arrival(g_new)
                if policy == "token_bucket":
                    # epoch g's plan also waits for its (epoch-granular)
                    # token; the arrival stamp keeps the true arrival, so
                    # latency includes the token wait
                    arrive_new = torch.maximum(arrive_new, _sat_mul(
                        torch.clamp(g_new - p["pol_tb_burst_e"] + 1, min=0),
                        p["pol_tb_iv"],
                    ))
            else:
                arrive_new = g_new * interval
        if planner_model:
            lane = g_new % L
            at_lane = adv & (lane_ids == lane)
            lane_free_prev = _at(s["lane_free"], lane)
            work_new = _at(p["plan_work"], new_b)
            start_new = torch.maximum(arrive_new, lane_free_prev)
            ready = start_new + work_new
            s["plan_qdelay"] = s["plan_qdelay"] + torch.where(
                adv, torch.clamp(lane_free_prev - arrive_new, min=0), 0
            )
            s["plan_busy"] = s["plan_busy"] + torch.where(adv, work_new, 0)
            # round-granular lane-busy integral: credit the elapsed part
            # of the new span now, its future part as rounds elapse
            # (below); park the replaced span's remainder in pb_span
            elapsed_part = torch.clamp(
                torch.minimum(ready, r) - start_new, min=0
            )
            s["plan_busy_int"] = s["plan_busy_int"] + torch.where(
                adv, elapsed_part, 0
            )
            old_start = _at(s["lane_start"], lane)
            keep_old = adv & (lane_free_prev > r)
            s["pb_span"] = torch.where(
                keep_old,
                torch.stack([torch.maximum(old_start, r), lane_free_prev]),
                s["pb_span"],
            )
            s["lane_start"] = torch.where(at_lane, start_new,
                                          s["lane_start"])
            s["lane_free"] = torch.where(at_lane, ready, s["lane_free"])
            new_plan_fin = ready
        elif open_arrival:
            # a plan cannot start before its batch arrives
            new_plan_fin = torch.maximum(arrive_new, s["plan_fin"]) + _at(
                p["plan_rounds"], new_b)
        else:
            new_plan_fin = s["plan_fin"] + _at(p["plan_rounds"], new_b)
        s["plan_fin"] = torch.where(adv, new_plan_fin, s["plan_fin"])
        if planner_model or open_arrival:
            s["epoch_ctr"] = s["epoch_ctr"] + adv.to(I32) + skip
        s["cur_batch"] = new_b

        def next_plan_fin(nb):
            # modeled plan-ready round of the next batch (global epoch
            # epoch_ctr + 1): what the pipelined level-0 prefix waits for
            if not (planner_model or open_arrival):
                return s["plan_fin"] + _at(p["plan_rounds"], nb)
            g_nxt = s["epoch_ctr"] + 1
            a_nxt = ep_arrival(g_nxt) if open_arrival else g_nxt * interval
            if planner_model:
                lane_free = _at(s["lane_free"], g_nxt % L)
                return torch.maximum(a_nxt, lane_free) + _at(
                    p["plan_work"], nb)
            return torch.maximum(a_nxt, s["plan_fin"]) + _at(
                p["plan_rounds"], nb)

        # -------------------------------------------- 2. admission
        # Empty slots pull the next positions of the current batch, in
        # the planner's serial order, once the batch's plan is ready.
        empty = phase == EMPTY
        rank = torch.cumsum(empty, 0, dtype=I32) - 1
        pos = s["bpos"] + rank
        bend = _at(ustart, new_b) + _at(usize, new_b)
        if pipe:
            # ranks beyond the current batch's remaining units spill into
            # the next batch's level-0 fragment prefix
            cur_avail = torch.clamp(bend - s["bpos"], min=0)
            adm_cur = empty & (rank < cur_avail) & (r >= s["plan_fin"])
            nb = (new_b + 1) % NB
            nlvl_end = _at(ustart, nb) + _at(p["lvl0_fcount"], nb)
            plan_fin_next = next_plan_fin(nb)
            ppos = s["pbpos"] + (rank - cur_avail)
            adm_pipe = (
                empty
                & (rank >= cur_avail)
                & (ppos < nlvl_end)
                & (r >= plan_fin_next)
            )
            adm = adm_cur | adm_pipe
            upos = torch.where(adm_pipe, ppos, pos)
            s["bpos"] = s["bpos"] + adm_cur.sum(dtype=I32)
            n_pipe = adm_pipe.sum(dtype=I32)
            s["pbpos"] = s["pbpos"] + n_pipe
            s["pipe_adm"] = s["pipe_adm"] + n_pipe
            n_adm = adm.sum(dtype=I32)
        else:
            adm = empty & (pos < bend) & (r >= s["plan_fin"])
            upos = pos
            n_adm = adm.sum(dtype=I32)
            s["bpos"] = s["bpos"] + n_adm
        widx = torch.where(adm, upos, widx)
        new_tid = s["next_txn"] + rank
        tid = torch.where(adm, new_tid, tid)
        ts = torch.where(adm, new_tid, ts)
        # arrival stamp: the unit's epoch arrival under open arrival
        # (pipelined early admissions belong to the next epoch), else
        # the admission round
        if open_arrival:
            arr_new = ep_arrival(s["epoch_ctr"])
            if pipe:
                arr_new = torch.where(
                    adm_pipe, ep_arrival(s["epoch_ctr"] + 1), arr_new)
            arrive = torch.where(adm, arr_new, arrive)
        else:
            arrive = torch.where(adm, r, arrive)
        s["next_txn"] = s["next_txn"] + n_adm
        if policy == "token_bucket":
            s["pol_tb_adm"] = s["pol_tb_adm"] + n_adm
        # the reference's gathers clamp; widx is in range by construction
        wsafe = torch.clamp(widx, 0, NU - 1).long()
        if frag:
            ftxn = torch.where(adm, p["frag_txn"][wsafe], ftxn)
        else:
            ftxn = torch.where(adm, widx, ftxn)
        # one [T, 2] gather of (npred, exec_ops); the predecessor rows
        # serve both the wavefront check and the event leap
        ne = ne_all[wsafe]
        npred_t = ne[:, 0]
        exec_t = ne[:, 1]
        preds = pred_pad[wsafe]  # [T, P]
        preds0 = torch.clamp(preds, min=0).long()
        init_busy = rounds_of(
            cm.txn_fixed_cycles + npred_t * cm.dep_check_cycles
        )
        phase = torch.where(adm, INIT, phase)
        busy_until = torch.where(adm, r + init_busy, busy_until)
        busy_kind = torch.where(adm, CAT_LOCK, busy_kind)

        # -------------------------------------------- 3. INIT -> MSG
        # The exec lane fetches its next planned entry from the scheduler
        # queue: one SPSC hop.
        free = busy_until <= r
        start = (phase == INIT) & free & (tid >= 0)
        phase = torch.where(start, MSG, phase)
        msg_arrive = torch.where(start, r + cm.msg_hop_rounds, msg_arrive)
        got = (phase == MSG) & (msg_arrive <= r)
        phase = torch.where(got, READY, phase)

        # -------------------------------------------- 4. wavefront check
        if rows_out is not None:
            # gathers done[preds], scans the rows' edges grouped by row
            dep_ok = dw_ops.dep_wavefront_rows(widx, preds, done,
                                               out=rows_out)
        else:
            dep_ok = ((preds < 0) | done[preds0]).all(dim=1)
        ready = (phase == READY) & dep_ok

        # -------------------------------------------- 5. lane scheduling
        busy = busy_until > r
        lane_busy = lane_any((phase == EXEC) & busy)
        ready_ts = torch.where(ready, ts, _IMAX)
        lane_min = ready_ts.view(cfg.n_exec, W).amin(dim=1)
        startx = (
            ready
            & (ready_ts == lane_min[lane_idx])
            & ~lane_busy[lane_idx]
        )
        phase = torch.where(startx, EXEC, phase)
        busy_until = torch.where(
            startx, r + exec_t * exec_rounds_one, busy_until
        )
        busy_kind = torch.where(startx, CAT_EXEC, busy_kind)

        # -------------------------------------------- 6. commit
        # No locks and no abort path. In fragment mode a finished
        # fragment marks itself done and decrements its txn's count; the
        # txn commits (once) when the count hits zero.
        free = busy_until <= r
        fin = (phase == EXEC) & free
        done.index_fill_(0, torch.where(fin, widx, NU).long(), True)
        if frag:
            tl.index_add_(0, torch.where(fin, ftxn, N), neg_ones)
            tl_t = tl[torch.where(fin, ftxn, 0).long()]
            com_slot = fin & (tl_t == 0)
            # fragments of one txn finishing in the same round on
            # different slots: only the lowest such slot commits it
            same = (ftxn[None, :] == ftxn[:, None]) & com_slot[None, :]
            com_first = slot_ids == torch.where(
                same, slot_ids[None, :], T).amin(dim=1)
            com = com_slot & com_first
            ncom = com.sum(dtype=I32)
            if pipe:
                com_b = batch_of[torch.where(com, ftxn, 0).long()]
                ncom_ahead = (com & (com_b != new_b)).sum(dtype=I32)
                s["pipe_com"] = s["pipe_com"] + ncom_ahead
                s["pipe_commits"] = s["pipe_commits"] + ncom_ahead
                s["batch_left"] = s["batch_left"] - (ncom - ncom_ahead)
            else:
                s["batch_left"] = s["batch_left"] - ncom
        else:
            com = fin
            ncom = fin.sum(dtype=I32)
            s["batch_left"] = s["batch_left"] - ncom
        s["commits"] = s["commits"] + ncom
        # commit-latency histogram (bucket = powers of two <= latency)
        lat = r - arrive
        lat_b = (lat[:, None] >= lat_pow2[None, :]).sum(dim=1, dtype=I32)
        s["lat_hist"] = s["lat_hist"].index_add(
            0, torch.where(com, lat_b, 0), com.to(I32)
        )
        phase = torch.where(fin, EMPTY, phase)
        tid = torch.where(fin, -1, tid)

        # -------------------------------------------- 7. lane accounting
        busy2 = busy_until > r
        slot_cat = torch.where(
            busy2,
            busy_kind,
            torch.where(
                phase == MSG,
                CAT_MSG,
                torch.where(phase == READY, CAT_WAIT, CAT_IDLE),
            ),
        )
        lane_cat = torch.where(
            lane_any(busy2 & (slot_cat == CAT_EXEC)),
            CAT_EXEC,
            torch.where(
                lane_any(slot_cat == CAT_WAIT),
                CAT_WAIT,
                torch.where(lane_any(slot_cat == CAT_MSG), CAT_MSG, CAT_IDLE),
            ),
        )
        cat_counts = torch.zeros(NCAT, dtype=I32, device=dev).index_add_(
            0, lane_cat, lane_ones
        )

        # -------------------------------------------- 8. event leap
        # Timers: busy_until, msg_arrive and the scalar admission gate
        # (plan_fin / batch rollover). A dep-clear READY slot starts the
        # round its lane goes idle.
        if cfg.event_leap:
            busy3 = busy_until > r
            cand = torch.where(busy3, busy_until, _IMAX)
            cand = torch.minimum(cand, torch.where(
                (phase == MSG) & (msg_arrive > r), msg_arrive, _IMAX))
            act_next = (
                (~busy3 & (phase == INIT))
                | ((phase == MSG) & (msg_arrive <= r))
            )
            # same pred rows as stage 4; `done` moved, so re-gather
            dep_ok2 = ((preds < 0) | done[preds0]).all(dim=1)
            lane_exec_busy = lane_any((phase == EXEC) & busy3)
            act_next = act_next | (
                (phase == READY) & dep_ok2 & ~lane_exec_busy[lane_idx]
            )
            cand = torch.where(act_next, r + 1, cand)
            # admission is a scalar event: the next batch opens the round
            # after batch_left hits zero; within a batch, empty slots
            # admit once plan_fin has passed and positions remain
            adm_evt = torch.where(
                s["batch_left"] == 0,
                r + 1,
                torch.where(
                    s["bpos"] < bend,
                    torch.maximum(s["plan_fin"], r + 1),
                    _IMAX,
                ),
            )
            if pipe:
                # pipelined admission wakes when the next batch's plan
                # lands, while level-0 fragment positions remain
                pipe_evt = torch.where(
                    s["pbpos"] < nlvl_end,
                    torch.maximum(plan_fin_next, r + 1),
                    _IMAX,
                )
                adm_evt = torch.minimum(adm_evt, pipe_evt)
            adm_evt = torch.where((phase == EMPTY).any(), adm_evt, _IMAX)
            nxt = torch.minimum(
                torch.maximum(torch.minimum(cand.min(), adm_evt), r + 1),
                r_end,
            )
        else:
            nxt = r + 1
        leap = nxt - r
        s["cat"] = s["cat"] + cat_counts * leap
        s["steps"] = s["steps"] + 1
        s["r"] = nxt
        if planner_model:
            # planner-busy rounds: overlap of each lane's live span (and
            # the carried span) with the elapsed window [r, nxt)
            acc = torch.clamp(
                torch.minimum(s["lane_free"], nxt)
                - torch.maximum(s["lane_start"], r),
                min=0,
            ).sum(dtype=I32)
            acc = acc + torch.clamp(
                torch.minimum(s["pb_span"][1], nxt)
                - torch.maximum(s["pb_span"][0], r),
                min=0,
            )
            s["plan_busy_int"] = s["plan_busy_int"] + acc
        # queue samples at every grid point in (r, nxt]
        qgrid = qgrid_pos * p["qgrid_iv"]
        qm = (qgrid > r) & (qgrid <= nxt)
        s["q_inflight"] = torch.where(
            qm, (tid >= 0).sum(dtype=I32), s["q_inflight"]
        )
        if open_arrival:
            # backlog in admission units: every unit of the epochs
            # arrived by grid point x, minus the admission cursor
            arrived = units_before(epochs_arrived_by(qgrid))
            s["q_depth"] = torch.where(
                qm, torch.clamp(arrived - s["next_txn"], min=0),
                s["q_depth"],
            )
        s["slots"] = torch.stack(
            [tid, widx, ts, phase, busy_until, busy_kind, msg_arrive, ftxn,
             arrive],
            dim=0,
        )
        return s

    return step


def _compact_keys(plan: planner_lib.Plan) -> planner_lib.Plan:
    """Remap record keys to a dense id space padded to a power-of-two
    bucket (see ``repro.core.engine._compact_keys``)."""
    keys = plan.keys
    uniq, inv = np.unique(keys, return_inverse=True)
    dense = inv.reshape(keys.shape).astype(np.int32)
    num = len(uniq)
    if uniq[-1] == int(KEY_SENTINEL):  # keep padding as sentinel
        dense = np.where(keys == int(KEY_SENTINEL), int(KEY_SENTINEL), dense)
        num -= 1
    num = max(int(num), 1)
    r_pad = max(16, 1 << (num + (num >> 2) - 1).bit_length())
    plan = dataclasses.replace(plan, keys=dense, num_records=r_pad)
    return plan


def make_plan(cfg: EngineConfig, workload: Workload) -> planner_lib.Plan:
    """Plan the workload for the protocol (engine-ready arrays)."""
    if cfg.protocol == "orthrus":
        plan = planner_lib.plan_orthrus(workload, cfg.n_cc)
    elif cfg.protocol == "deadlock_free":
        plan = planner_lib.plan_sorted(workload)
    elif cfg.protocol == "partitioned_store":
        plan = planner_lib.plan_partition_store(workload, cfg.n_exec)
    elif cfg.protocol == "dgcc":
        plan = planner_lib.plan_dgcc(
            workload, workload.cfg.batch_epoch,
            n_lanes=max(cfg.n_cc, 1), fragments=cfg.fragment_exec,
        )
    elif cfg.protocol == "quecc":
        plan = planner_lib.plan_quecc(
            workload, max(cfg.n_cc, 1), workload.cfg.batch_epoch,
            fragments=cfg.fragment_exec,
        )
    elif cfg.protocol == "scheduled":
        plan = planner_lib.plan_scheduled(
            workload, workload.cfg.batch_epoch, n_lanes=max(cfg.n_exec, 1),
        )
    else:
        plan = planner_lib.plan_dynamic(workload)
    plan.epoch_txns = workload.cfg.batch_epoch  # open-arrival epoch size
    if not cfg.is_batch_planned:
        plan = _compact_keys(plan)
    return plan


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU"
        )
    return dev


def run_simulation(
    cfg: EngineConfig,
    workload: Workload,
    seed: int = 0,
    *,
    device: torch.device | str | None = None,
) -> SimResult:
    """Plan the workload for the protocol, then simulate on ``device``
    (CUDA by default)."""
    from repro_torch.core import sweep as sweep_lib  # sweep imports us

    del seed  # the workload carries its own seed, as in the reference
    dev = resolve_device(device)
    plan = make_plan(cfg, workload)
    return sweep_lib.simulate_plans(cfg, [plan], device=dev)[0]
