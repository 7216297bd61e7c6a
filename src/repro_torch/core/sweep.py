"""Host loop of the simulator: the chunk runners and their cache, chunked
round execution with the warmup snapshot and the ``target_commits``
stop, for one cell or a group of cells.

The port of ``repro.core.sweep``:

* :func:`get_runner` — a bounded LRU of chunk runners keyed on
  ``(cfg.trace_statics(), PlanMeta, device)``, with the reference's
  hit, miss and eviction counters, default capacity 256 and
  ``REPRO_SWEEP_RUNNER_CACHE``. A runner advances a state to a chunk
  bound ``r_end`` one dispatch at a time: while ``r < r_end``, one
  dispatch of ``cfg.dispatch_rounds`` (K) steps, the enqueue-stamp
  rebase before the first (the packed lock-table engine), every inner
  step after the first guarded by ``r < r_end`` (:func:`guard_step`),
  as the reference's K-round mega-dispatch. The state at every chunk
  boundary, every counter included, is the same for every K. The step
  builders come from ``engine``, or from ``engine_legacy`` under
  ``state_layout="legacy"`` (:func:`_step_module`).
* On a CUDA device a runner captures one dispatch as a CUDA graph
  (static plan, state and ``r_end`` buffers) and replays it: one graph
  launch and one read of ``r`` per dispatch (and one as each chunk
  starts). A later cell with the same
  key copies its plan and initial state into the buffers and replays
  the same graph. On the CPU, and in :func:`simulate_eager` (the oracle
  the graphs are held to), the same dispatch runs eagerly
  (:func:`run_chunk`).
* :func:`get_group_runner` — the runner of a group of C cells, in the
  same LRU under the key ``(statics, PlanMeta, device, C)``. Every
  cell's whole dispatch, rebase included, is guarded by its own 0-d
  ``r_end`` (a cell at or past its bound comes out bit-identical, as a
  select-masked lane of the reference's vmapped loop). On CUDA the
  group is one CUDA graph with one branch per cell (a side stream
  forked off the capture and joined back), which ends by copying every
  cell's ``r`` into one [C] buffer: a replay advances every cell by one
  dispatch and the host reads one small tensor. On the CPU the same
  dispatches run eagerly, cell after cell.
* :func:`simulate_plans` and :func:`run_cells` — the host loop over
  the ``chunk_boundaries`` (``_GroupRun``): counters read at every
  boundary (one device-to-host copy for all the cells of a card),
  warmup counters subtracted, each cell's result taken at the first
  boundary where its measured commits reach ``target_commits``, under
  a :class:`SweepMode` (several cards, a pipelined host loop, per-cell
  early exit). One plan runs through :func:`get_runner`; several run
  as one group. Every mode gives the reference's serial results.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.convert import plan_from_numpy
from repro_torch.core.engine import NCAT, EngineConfig, PlanMeta, SimResult
from repro_torch.core.graphs import CountedGraph
from repro_torch.sharding.policies import cell_mesh

# Engine-code version tag of the reference this port reproduces.
ENGINE_VERSION = "4-mega-dispatch"


@dataclasses.dataclass(frozen=True)
class SweepMode:
    """How the host loop drives a group of cells (the reference's
    fields). Every combination gives ``SERIAL_MODE``'s results.

      * ``devices`` — split the group's cells into this many contiguous
        blocks, one CUDA graph per card (clamped to the cards that
        exist, and to 1 on the CPU).
      * ``pipeline`` — how many replays the host keeps queued beyond
        the one whose ``r`` it reads, and how many chunk boundaries'
        counters may stay unread (0 = synchronous). Any depth > 0 also
        lets :func:`run_cells` build the next group's plans and states
        while the current group runs.
      * ``early_exit`` — freeze a cell (bound 0) once its counters are
        taken at ``target_commits``.
    """

    devices: int = 1
    pipeline: int = 1
    early_exit: bool = True


# The reference's serial host loop: one card, every boundary read at
# once, every cell run to the group's last boundary.
SERIAL_MODE = SweepMode(devices=1, pipeline=0, early_exit=False)


def sweep_mode() -> SweepMode:
    """The environment-selected mode: ``REPRO_SWEEP_DEVICES`` (card
    count; "auto", "0" or unset = every CUDA card), ``REPRO_SWEEP_PIPELINE``
    (depth, default 1) and ``REPRO_SWEEP_EARLY_EXIT`` (default on)."""
    raw = os.environ.get("REPRO_SWEEP_DEVICES", "auto").strip().lower()
    if raw in ("", "auto", "0"):
        devices = max(1, torch.cuda.device_count())
    else:
        devices = max(1, int(raw))
    pipeline = max(0, int(os.environ.get("REPRO_SWEEP_PIPELINE", "1")))
    early = os.environ.get("REPRO_SWEEP_EARLY_EXIT", "1").strip().lower()
    return SweepMode(
        devices=devices,
        pipeline=pipeline,
        early_exit=early not in ("0", "false", "off"),
    )


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


def guard_step(step):
    """``step`` run only where ``r < r_end``: elsewhere the state comes
    back bit-identical (the reference's ``lax.cond`` around every inner
    step after the first). The 0-d guard is decided on the device: the
    arrays the step updates in place (``engine.DROP_ROW_ARRAYS``) are
    copied first, and every field the step changed is selected with
    ``torch.where``."""

    def guarded(p, s, r_end):
        live = s["r"] < r_end
        old = {k: s[k].clone() for k in engine_lib.DROP_ROW_ARRAYS if k in s}
        new = step(p, s, r_end)
        out = {}
        for k, v in new.items():
            prev = old.get(k, s[k])
            out[k] = v if v is prev else torch.where(live, v, prev)
        return out

    return guarded


def make_dispatch(cfg: EngineConfig, step):
    """One dispatch of ``cfg.dispatch_rounds`` steps, ``dispatch(p, s,
    r_end)``: the enqueue-stamp rebase (the packed lock-table engine; it
    bounds the monotone ``enq_ctr`` and is bit-exact; the legacy layout
    keeps the unrebased counter, as the reference), one step, then K - 1
    guarded steps. The caller runs it only while ``r < r_end``."""
    rebase = cfg.state_layout == "packed" and not cfg.is_batch_planned
    guarded = guard_step(step)
    inner = cfg.dispatch_rounds - 1

    def dispatch(p, s, r_end):
        if rebase:
            s = engine_lib.rebase_enq(s)
        s = step(p, s, r_end)
        for _ in range(inner):
            s = guarded(p, s, r_end)
        return s

    return dispatch


def run_chunk(dispatch, p: dict, state: dict, r_end: int) -> dict:
    """Advance ``state`` to round ``r_end`` eagerly: one ``dispatch`` per
    iteration while ``r < r_end`` (the host reads ``r`` each dispatch)."""
    r_end_t = torch.tensor(r_end, dtype=torch.int32, device=state["r"].device)
    while int(state["r"]) < r_end:
        state = dispatch(p, state, r_end_t)
    return state


def _signature(d: dict) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(d.items()))


def _step_module(cfg: EngineConfig):
    """The step-builder module for the config's state layout: the packed
    [T, F] engine, or the frozen pre-rewrite engine
    (``repro_torch.core.engine_legacy``), the conformance oracle."""
    if cfg.state_layout == "legacy":
        from repro_torch.core import engine_legacy

        return engine_legacy
    return engine_lib


def _build_step(cfg: EngineConfig, meta: PlanMeta, device):
    mod = _step_module(cfg)
    builder = mod.make_batch_step if cfg.is_batch_planned else mod.make_step
    return builder(cfg, meta, device)


class _Graph:
    """One dispatch captured as a counted CUDA graph
    (:class:`~repro_torch.core.graphs.CountedGraph`) over static buffers:
    the plan dict, the state dict and a 0-d int32 ``r_end``. The dispatch
    ends by copying its output state into the state buffers, so that
    replays chain. The warm-up runs the dispatch twice on scratch copies
    of the state."""

    def __init__(self, dispatch, p: dict, state: dict, device):
        t0 = time.perf_counter()
        self.p = {k: v.clone() for k, v in p.items()}
        self.state = {k: v.clone() for k, v in state.items()}
        self.r_end = torch.zeros((), dtype=torch.int32, device=device)
        self.bound_p = p

        def warm():
            scratch = {k: v.clone() for k, v in self.state.items()}
            for _ in range(2):
                scratch = dispatch(self.p, scratch, scratch["r"] + 1)

        def body():
            _copy_back(dispatch(self.p, self.state, self.r_end), self.state)

        self.graph = CountedGraph(warm, body, device)
        self.capture_s = time.perf_counter() - t0

    def load(self, p: dict, state: dict) -> None:
        """Copy a cell's plan and state into the buffers, where they are
        not the buffers already."""
        if p is not self.bound_p:
            for k, v in self.p.items():
                v.copy_(p[k])
            self.bound_p = p
        if state is not self.state:
            for k, v in self.state.items():
                v.copy_(state[k])

    def replay(self) -> None:
        self.graph.replay()


def _copy_back(out: dict, static: dict) -> None:
    """``static[k] <- out[k]`` for every field, under capture. A field the
    step updated in place is its buffer already; any other output that
    shares a buffer's memory would be read after that buffer's copy, so
    it raises."""
    if out.keys() != static.keys():
        raise RuntimeError(f"the dispatch changed the state's fields: "
                           f"{sorted(out.keys() ^ static.keys())}")
    ptrs = {v.untyped_storage().data_ptr() for v in static.values()}
    moved = {k: v for k, v in out.items() if v is not static[k]}
    for k, v in moved.items():
        if v.untyped_storage().data_ptr() in ptrs:
            raise RuntimeError(f"the dispatch's {k} aliases a state buffer")
    for k, v in moved.items():
        static[k].copy_(v)


class ChunkRunner:
    """The chunk runner of one ``(trace statics, plan shape, device)``
    key: ``runner(p, state, r_end)`` advances ``state`` to round
    ``r_end`` and returns it, as the reference's jitted runner. The step
    is built at the first call. On a CUDA device each dispatch is one
    replay of a captured graph, one per shape signature of the plan and
    the state, and the state returned is the graph's own buffers: valid
    until another cell enters the runner. On the CPU each dispatch runs
    eagerly (:func:`run_chunk`)."""

    def __init__(self, cfg: EngineConfig, meta: PlanMeta, device):
        self.cfg, self.meta = cfg, meta
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self._dispatch = None
        self.graphs: dict[tuple, _Graph] = {}
        self.replays = 0

    @property
    def dispatch(self):
        if self._dispatch is None:
            step = _build_step(self.cfg, self.meta, self.device)
            self._dispatch = make_dispatch(self.cfg, step)
        return self._dispatch

    def __call__(self, p: dict, state: dict, r_end: int) -> dict:
        if not self.graphed:
            return run_chunk(self.dispatch, p, state, r_end)
        sig = (_signature(p), _signature(state))
        g = self.graphs.get(sig)
        if g is None:
            with torch.cuda.device(self.device):
                g = self.graphs[sig] = _Graph(self.dispatch, p, state,
                                              self.device)
        g.load(p, state)
        g.r_end.fill_(r_end)
        while int(g.state["r"]) < r_end:
            g.replay()
            self.replays += 1
        return g.state

    def close(self) -> None:
        """Free the captured graphs, their memory pools and buffers."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs.clear()


class _GroupGraph:
    """The guarded dispatches of a group's C cells captured as one
    counted CUDA graph over static buffers: per cell a plan dict and a
    state dict, and one [C] int32 ``r_end`` (cell i reads element i).
    Cell i's dispatch runs on a side stream of its own, forked off the
    capture and joined back, so the cells are independent branches of
    the graph; the graph ends by copying every cell's ``r`` into
    ``r_out``. Each cell is warmed up first on scratch copies of its
    state (as :class:`_Graph`); a replay adds to the kernels'
    ``launches`` what the capture recorded, every branch's (C x K a
    replay on a kernel path, the inactive branches' included)."""

    def __init__(self, dispatches: list, ps: list, states: list, device):
        t0 = time.perf_counter()
        n = len(dispatches)
        self.p = [{k: v.clone() for k, v in p.items()} for p in ps]
        self.state = [{k: v.clone() for k, v in s.items()} for s in states]
        self.r_end = torch.zeros(n, dtype=torch.int32, device=device)
        self.r_out = torch.zeros(n, dtype=torch.int32, device=device)
        branches = [torch.cuda.Stream(device) for _ in range(n)]

        def warm():
            for d, p, s in zip(dispatches, self.p, self.state):
                scratch = {k: v.clone() for k, v in s.items()}
                for _ in range(2):
                    scratch = d(p, scratch, scratch["r"] + 1)

        def body():
            cap = torch.cuda.current_stream(device)
            for d, br, p, s, r_end in zip(dispatches, branches, self.p,
                                          self.state, self.r_end):
                br.wait_stream(cap)
                with torch.cuda.stream(br):
                    _copy_back(d(p, s, r_end), s)
            for br in branches:
                cap.wait_stream(br)
            torch.stack([s["r"] for s in self.state], out=self.r_out)

        self.graph = CountedGraph(warm, body, device)
        self.capture_s = time.perf_counter() - t0

    def load(self, ps: list, states: list) -> None:
        """Copy a group's plans and initial states into the buffers."""
        for mine, theirs in zip(self.p + self.state, ps + states):
            for k, v in mine.items():
                v.copy_(theirs[k])

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.r_out


class _EagerCells:
    """A group's cells advanced eagerly, one guarded dispatch each a
    replay (the CPU's path, with :class:`_GroupGraph`'s buffers)."""

    def __init__(self, dispatches: list, ps: list, states: list):
        self.dispatches, self.p, self.state = dispatches, ps, list(states)
        self.r_end = torch.zeros(len(ps), dtype=torch.int32,
                                 device=states[0]["r"].device)

    def replay(self) -> torch.Tensor:
        for i, d in enumerate(self.dispatches):
            self.state[i] = d(self.p[i], self.state[i], self.r_end[i])
        return torch.stack([s["r"] for s in self.state])


class GroupRunner:
    """The runner of a group of ``n_cells`` cells of one ``(trace
    statics, plan shape, device)`` key. Each cell has a step of its own
    (a built step owns its kernel's output buffer) and a dispatch that
    is guarded whole (:func:`guard_step` around :func:`make_dispatch`):
    a cell whose ``r >= r_end`` comes out of a replay bit-identical, its
    bound 0 freezes it. :meth:`load` enters a group's plans and initial
    states (on CUDA into the buffers of a graph captured at the first
    load of each shape signature), :meth:`set_bounds` sets the cells'
    bounds, :meth:`replay` advances every cell by one dispatch and
    returns the cells' ``r``, to be read later."""

    def __init__(self, cfg: EngineConfig, meta: PlanMeta, device,
                 n_cells: int):
        self.cfg, self.meta, self.n = cfg, meta, n_cells
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self._dispatches = None
        self.graphs: dict[tuple, _GroupGraph] = {}
        self.cells: _GroupGraph | _EagerCells | None = None
        self.replays = 0

    @property
    def dispatches(self) -> list:
        if self._dispatches is None:
            self._dispatches = [
                guard_step(make_dispatch(
                    self.cfg, _build_step(self.cfg, self.meta, self.device)))
                for _ in range(self.n)]
        return self._dispatches

    def load(self, ps: list, states: list) -> None:
        if len(ps) != self.n or len(states) != self.n:
            raise ValueError(f"{len(ps)} plans and {len(states)} states "
                             f"for a runner of {self.n} cells")
        if not self.graphed:
            self.cells = _EagerCells(self.dispatches, ps, states)
            return
        sig = (_signature(ps[0]), _signature(states[0]))
        if any((_signature(p), _signature(s)) != sig
               for p, s in zip(ps, states)):
            raise ValueError("a group's cells must share plan and state "
                             "shapes")
        g = self.graphs.get(sig)
        if g is None:
            with torch.cuda.device(self.device):
                g = self.graphs[sig] = _GroupGraph(self.dispatches, ps,
                                                   states, self.device)
        g.load(ps, states)
        self.cells = g

    def set_bounds(self, bounds: np.ndarray) -> None:
        self.cells.r_end.copy_(torch.from_numpy(
            np.ascontiguousarray(bounds, dtype=np.int32)))

    def replay(self) -> _Pending:
        self.replays += 1
        if self.graphed:
            with torch.cuda.device(self.device):
                return _Pending(self.cells.replay())
        return _Pending(self.cells.replay())

    def counters(self) -> _Counters:
        return _Counters(self.cells.state)

    def release(self) -> None:
        """Drop the loaded group (a graph's buffers stay for the next)."""
        self.cells = None

    def close(self) -> None:
        """Free the captured graphs, their memory pools and buffers."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs.clear()
        self.cells = None


# Bounded LRU of chunk runners (most-recently-used last).
_RUNNER_CACHE: OrderedDict = OrderedDict()
_RUNNER_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_RUNNER_CACHE_CAPACITY = max(
    1, int(os.environ.get("REPRO_SWEEP_RUNNER_CACHE", "256"))
)


def runner_cache_info() -> dict:
    """Cached runners and the LRU's hit, miss and eviction counters
    (cumulative per process)."""
    return {
        "entries": len(_RUNNER_CACHE),
        "keys": list(_RUNNER_CACHE),
        "capacity": _RUNNER_CACHE_CAPACITY,
        **_RUNNER_CACHE_STATS,
    }


def _evict_to(capacity: int) -> None:
    while len(_RUNNER_CACHE) > capacity:
        _RUNNER_CACHE.popitem(last=False)[1].close()
        _RUNNER_CACHE_STATS["evictions"] += 1


def set_runner_cache_capacity(capacity: int) -> int:
    """Set the LRU bound (evicting down to it); returns the old bound."""
    global _RUNNER_CACHE_CAPACITY
    old = _RUNNER_CACHE_CAPACITY
    _RUNNER_CACHE_CAPACITY = max(1, int(capacity))
    _evict_to(_RUNNER_CACHE_CAPACITY)
    return old


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _cached(key: tuple, make):
    runner = _RUNNER_CACHE.get(key)
    if runner is not None:
        _RUNNER_CACHE.move_to_end(key)
        _RUNNER_CACHE_STATS["hits"] += 1
        return runner
    _RUNNER_CACHE_STATS["misses"] += 1
    runner = _RUNNER_CACHE[key] = make()
    _evict_to(_RUNNER_CACHE_CAPACITY)
    return runner


def get_runner(cfg: EngineConfig, meta: PlanMeta, device) -> ChunkRunner:
    """The cached :class:`ChunkRunner` for this (config statics, plan
    shape, device) key; a miss makes one (its step is built, and on CUDA
    its graph captured, at its first call)."""
    dev = _device_key(device)
    return _cached((cfg.trace_statics(), meta, dev),
                   lambda: ChunkRunner(cfg, meta, dev))


def get_group_runner(cfg: EngineConfig, meta: PlanMeta, device,
                     n_cells: int) -> GroupRunner:
    """The cached :class:`GroupRunner` of ``n_cells`` cells for this
    (config statics, plan shape, device) key: the reference's batched
    runner key with ``batched`` replaced by the cell count."""
    dev = _device_key(device)
    return _cached((cfg.trace_statics(), meta, dev, n_cells),
                   lambda: GroupRunner(cfg, meta, dev, n_cells))


class _Pending:
    """A device -> host copy issued on the stream now and read later
    (:meth:`get` waits for it); on the CPU the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _counter_layout(state: dict) -> list[tuple[str, tuple]]:
    """The counters read at a chunk boundary: the metrics arrays and the
    optional scalars only where the state carries them (the legacy
    layout predates both)."""
    keys = _SCALARS + ("cat",) + tuple(
        k for k in _METRIC_ARRAYS + _OPT_SCALARS if k in state)
    return [(k, tuple(state[k].shape)) for k in keys]


class _Counters:
    """The small counters of some cells' states, packed into one tensor
    on the device (a copy: later dispatches leave it be) and copied to
    the host in one copy. :meth:`get` gives one dict of int64 arrays per
    cell."""

    def __init__(self, states: list):
        self.layout = _counter_layout(states[0])
        self.n = len(states)
        self.copy = _Pending(torch.cat(
            [s[k].reshape(-1).to(torch.int32)
             for s in states for k, _ in self.layout]))

    def get(self) -> list[dict[str, np.ndarray]]:
        flat = self.copy.get().astype(np.int64)
        out, at = [], 0
        for _ in range(self.n):
            cell = {}
            for k, shape in self.layout:
                size = int(np.prod(shape, dtype=np.int64))
                cell[k] = flat[at:at + size].reshape(shape)
                at += size
            out.append(cell)
        return out


def _zeros_like_counters() -> dict[str, np.ndarray]:
    out = {k: np.zeros((), np.int64) for k in _SCALARS}
    out["cat"] = np.zeros((NCAT,), np.int64)
    return out


def _result(cfg, plan, snap, wsnap, ri, wri, wall,
            group_cells: int) -> SimResult:
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
    met = None  # the legacy layout carries no metrics state
    if "lat_hist" in snap:
        hist = snap["lat_hist"] - np.asarray(wsnap.get("lat_hist", 0),
                                             np.int64)
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
            group_cells=group_cells,
            engine_version=ENGINE_VERSION,
            **{k: delta(k) for k in _OPT_SCALARS if k in snap},
        ),
        metrics=met,
    )


def _initial_state(cfg: EngineConfig, plan, meta: PlanMeta, dev) -> dict:
    mod = _step_module(cfg)
    if cfg.is_batch_planned:
        return mod._batch_state0(cfg, plan, cfg.n_slots, dev)
    return mod._state0(cfg, plan.num_records, cfg.n_slots, meta.max_keys,
                       dev)


def _budget(cfg: EngineConfig) -> tuple:
    return (cfg.max_rounds, cfg.warmup_rounds, cfg.chunk_rounds,
            cfg.target_commits)


class _GroupRun:
    """One group of cells driven to completion: the chunk-boundary
    schedule, the queue of boundaries whose counters are not read yet,
    and each cell's warmup and ``target_commits`` snapshots. Cells may
    differ in traced values (plans, epoch rates, policy parameters) and
    in their ``EngineConfig``s, as long as every config shares
    ``trace_statics()``, the host-loop budget and the plan shapes.

    One cell runs through ``run`` (its chunk runner; by default the
    cached :func:`get_runner`), which returns the state at each bound;
    its counters are read at every boundary. Several run as blocks of
    contiguous cells, one :class:`GroupRunner` per card: a chunk sets
    each cell's bound (the boundary, or 0 once an early-exited cell is
    frozen) and replays until no cell is below its bound, keeping up to
    ``mode.pipeline`` replays queued beyond the one whose ``r`` it
    reads. A replay queued past the chunk's end is inactive in every
    cell, so the state at the boundary stays as it was.
    """

    def __init__(self, cfgs: list, plans: list, mode: SweepMode, device,
                 ps: list | None = None, run=None):
        n = len(plans)
        if n == 0 or n != len(cfgs):
            raise ValueError(f"{len(cfgs)} configs for {n} plans")
        if len({c.trace_statics() for c in cfgs}) != 1:
            raise ValueError("grouped cells must share trace statics")
        if len({_budget(c) for c in cfgs}) != 1:
            raise ValueError("grouped cells must share the host-loop budget")
        metas = {engine_lib.plan_meta(c, pl) for c, pl in zip(cfgs, plans)}
        if len(metas) != 1:
            raise ValueError(f"plans must share shapes, got {metas}")
        self.meta = next(iter(metas))
        self.cfgs, self.plans, self.mode, self.n = cfgs, plans, mode, n
        self.device = _device_key(device)
        self.ps, self.run = ps, run
        self.cells = None  # one cell: (p, state); several: the blocks

        self.live = np.ones(n, dtype=bool)
        self.warm = [_zeros_like_counters()] * n
        self.warm_rounds = 0
        self.snaps: list[tuple | None] = [None] * n
        self.final: list | None = None
        self.rounds_done = 0
        self.boundaries = chunk_boundaries(cfgs[0])
        self.pending: deque = deque()
        self.stopped = False
        self.exhausted = False
        self.t0: float | None = None
        self.wall = 0.0
        self.hook = None

    def _blocks(self) -> list[tuple[np.ndarray, torch.device]]:
        """Contiguous blocks of cells, one per card of ``mode.devices``
        (clamped to the cards there are and to the cell count): the
        devices of ``sharding.cell_mesh``, the first cards in order."""
        dev = self.device
        cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        d = max(1, min(self.mode.devices, cards, self.n))
        idxs = np.array_split(np.arange(self.n), d)
        if d == 1:
            return [(idxs[0], dev)]
        return list(zip(idxs, cell_mesh(d).devices))

    def prepare(self) -> None:
        """Plan tensors and initial states of every cell, on its block's
        device (:func:`run_cells` calls this on the next group while the
        current one runs)."""
        if self.cells is not None:
            return
        if self.ps is None:
            self.ps = [engine_lib.plan_device(c, pl)
                       for c, pl in zip(self.cfgs, self.plans)]
        if self.n == 1:
            self.cells = (
                plan_from_numpy(self.ps[0], self.device),
                _initial_state(self.cfgs[0], self.plans[0], self.meta,
                               self.device))
            return
        self.cells = [
            (ix, dev,
             [plan_from_numpy(self.ps[i], dev) for i in ix],
             [_initial_state(self.cfgs[i], self.plans[i], self.meta, dev)
              for i in ix])
            for ix, dev in self._blocks()]

    def start(self) -> None:
        """Enter the cells into their runners (capturing on a miss) and
        run the first chunk."""
        if self.t0 is not None:
            return
        self.prepare()
        self.t0 = time.time()
        if self.n == 1:
            if self.run is None:
                self.run = get_runner(self.cfgs[0], self.meta, self.device)
        else:
            blocks = []
            for ix, dev, ps, states in self.cells:
                runner = get_group_runner(self.cfgs[0], self.meta, dev,
                                          len(ix))
                runner.load(ps, states)
                blocks.append((ix, runner))
            self.cells = blocks
        self._dispatch_one()

    def _fire_hook(self) -> None:
        if self.hook is not None:
            hook, self.hook = self.hook, None
            hook()

    def _counters(self) -> list[_Counters]:
        if self.n == 1:
            return [_Counters([self.cells[1]])]
        return [runner.counters() for _ix, runner in self.cells]

    def _dispatch_one(self) -> bool:
        if self.exhausted:
            return False
        b = next(self.boundaries, None)
        if b is None:
            self.exhausted = True
            return False
        if self.n == 1:
            p, state = self.cells
            self.cells = (p, self.run(p, state, b))
            self._fire_hook()
        else:
            active = self.live if self.mode.early_exit else np.ones(
                self.n, dtype=bool)
            self._run_chunk(np.where(active, b, 0).astype(np.int32))
        self.pending.append((b, self._counters()))
        return True

    def _run_chunk(self, bounds: np.ndarray) -> None:
        """Replay every block until no cell is below its bound."""
        for ix, runner in self.cells:
            runner.set_bounds(bounds[ix])
        depth = max(0, self.mode.pipeline)
        queue: deque = deque()
        while True:
            while len(queue) <= depth:
                queue.append([runner.replay() for _ix, runner in self.cells])
                self._fire_hook()
            r = np.concatenate([c.get() for c in queue.popleft()])
            if (r >= bounds).all():
                return

    def _resolve_one(self) -> None:
        b, counters = self.pending.popleft()
        host = [cell for c in counters for cell in c.get()]
        self.rounds_done = b
        self.final = host
        if b <= self.cfgs[0].warmup_rounds:
            self.warm = host
            self.warm_rounds = b
        for i in range(self.n):
            if self.snaps[i] is None and (
                host[i]["commits"] - self.warm[i]["commits"]
                >= self.cfgs[i].target_commits
            ):
                self.snaps[i] = (host[i], self.warm[i], b, self.warm_rounds)
                self.live[i] = False
        if all(sn is not None for sn in self.snaps):
            self.stopped = True

    def drive(self, prefetch=None) -> None:
        """Run the host loop to completion. Up to ``mode.pipeline`` chunk
        boundaries stay unread (one cell: none, its runner is
        synchronous); ``prefetch`` (the next group's :meth:`prepare`)
        runs once this group's first replays are queued. Chunks run past
        the stopping boundary are discarded unread: their cells' results
        were taken at earlier boundaries."""
        self.hook = prefetch
        self.start()
        depth = max(0, self.mode.pipeline) if self.n > 1 else 0
        while not self.stopped and not self.exhausted:
            while len(self.pending) > depth and not self.stopped:
                self._resolve_one()
            if not self.stopped:
                self._dispatch_one()
        while self.pending and not self.stopped:
            self._resolve_one()
        self.pending.clear()
        self._fire_hook()
        devices = {self.device} if self.n == 1 else {
            runner.device for _ix, runner in self.cells}
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.wall = time.time() - self.t0

    def finish(self, time_sink: dict | None = None) -> list[SimResult]:
        """Each cell's :class:`SimResult` (its own config drives its cost
        and arrival accounting); the group's buffers are dropped."""
        if self.final is None:
            self.final = [cell for c in self._counters() for cell in c.get()]
        if time_sink is not None:
            time_sink["wall_s"] = self.wall
            time_sink["group_cells"] = self.n
        results = []
        for i in range(self.n):
            snap, wsnap, ri, wri = self.snaps[i] or (
                self.final[i], self.warm[i], self.rounds_done,
                self.warm_rounds)
            results.append(_result(self.cfgs[i], self.plans[i], snap, wsnap,
                                   ri, wri, self.wall, self.n))
        if self.n > 1:
            for _ix, runner in self.cells:
                runner.release()
        self.cells = None
        return results


def simulate_plans(
    cfg: EngineConfig,
    plans: list,
    *,
    device: torch.device | str | None = None,
    mode: SweepMode | None = None,
    time_sink: dict | None = None,
) -> list[SimResult]:
    """Run one simulation per plan on ``device`` (CUDA by default). All
    plans must share a :class:`PlanMeta`; one plan runs through its
    cached chunk runner, several as one group (:func:`get_group_runner`)
    under ``mode`` (default :func:`sweep_mode`). Each cell's counters are
    taken at the boundary where it meets ``target_commits``, so every
    mode gives the same results as one run per plan."""
    if mode is None:
        mode = sweep_mode()
    dev = engine_lib.resolve_device(device)
    run = _GroupRun([cfg] * len(plans), plans, mode, dev)
    run.drive()
    return run.finish(time_sink)


def simulate_eager(
    cfg: EngineConfig,
    plan,
    *,
    device: torch.device | str | None = None,
) -> SimResult:
    """:func:`simulate_plans` with every dispatch run eagerly and no
    CUDA graph (a fresh runner, not cached): the CPU's path, and on a
    card the oracle its graphs are held to."""
    dev = engine_lib.resolve_device(device)
    meta = engine_lib.plan_meta(cfg, plan)
    dispatch = ChunkRunner(cfg, meta, dev).dispatch
    run = _GroupRun([cfg], [plan], SERIAL_MODE, dev,
                    run=functools.partial(run_chunk, dispatch))
    run.drive()
    return run.finish()[0]


def _plan_shape_sig(p: dict) -> tuple:
    return tuple(
        sorted((k, tuple(np.shape(v)), str(np.asarray(v).dtype))
               for k, v in p.items())
    )


def run_cells(
    cells: list,
    mode: SweepMode | None = None,
    *,
    device: torch.device | str | None = None,
) -> list[SimResult]:
    """Simulate many ``(EngineConfig, Workload)`` cells on ``device``
    (CUDA by default). Cells are planned and grouped by the reference's
    key (shared ``trace_statics()``, host-loop budget, ``PlanMeta`` and
    plan shapes; configs may differ in traced values such as epoch rates
    or policy parameters), and each group runs as one simulation under
    ``mode`` (default :func:`sweep_mode`). Results come back in input
    order, equal to :func:`engine.run_simulation` per cell."""
    if mode is None:
        mode = sweep_mode()
    dev = engine_lib.resolve_device(device)
    plans = [engine_lib.make_plan(cfg, wl) for cfg, wl in cells]
    ps = [engine_lib.plan_device(cfg, pl)
          for (cfg, _wl), pl in zip(cells, plans)]
    groups: dict = {}
    for idx, ((cfg, _wl), plan, p) in enumerate(zip(cells, plans, ps)):
        key = (cfg.trace_statics(), _budget(cfg),
               engine_lib.plan_meta(cfg, plan), _plan_shape_sig(p))
        groups.setdefault(key, []).append(idx)

    order = list(groups.values())
    runs: list[_GroupRun | None] = [None] * len(order)

    def ensure(gi: int) -> _GroupRun:
        if runs[gi] is None:
            idxs = order[gi]
            runs[gi] = _GroupRun([cells[i][0] for i in idxs],
                                 [plans[i] for i in idxs], mode, dev,
                                 ps=[ps[i] for i in idxs])
        return runs[gi]

    out: list = [None] * len(cells)
    for gi, idxs in enumerate(order):
        g = ensure(gi)
        prefetch = None
        if mode.pipeline > 0 and gi + 1 < len(order):
            # build the next group's plans and states on the card while
            # this group runs
            prefetch = lambda j=gi + 1: ensure(j).prepare()  # noqa: E731
        g.drive(prefetch)
        for idx, res in zip(idxs, g.finish()):
            out[idx] = res
        runs[gi] = None  # release the group's buffers promptly
    return out
