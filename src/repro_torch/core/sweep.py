"""Host loop of one simulation: the chunk runner and its cache, chunked
round execution with the warmup snapshot and the ``target_commits``
stop.

The port of the serial path of ``repro.core.sweep``:

* :func:`get_runner` — a bounded LRU of chunk runners keyed on
  ``(cfg.trace_statics(), PlanMeta, device)``, with the reference's
  hit, miss and eviction counters, default capacity 256 and
  ``REPRO_SWEEP_RUNNER_CACHE``. A runner advances a state to a chunk
  bound ``r_end`` one dispatch at a time: while ``r < r_end``, one
  dispatch of ``cfg.dispatch_rounds`` (K) steps, the enqueue-stamp
  rebase before the first (lock-table engine), every inner step after
  the first guarded by ``r < r_end`` (:func:`guard_step`), as the
  reference's K-round mega-dispatch. The state at every chunk boundary,
  every counter included, is the same for every K.
* On a CUDA device a runner captures one dispatch as a CUDA graph
  (static plan, state and ``r_end`` buffers) and replays it: one graph
  launch and one read of ``r`` per dispatch (and one as each chunk
  starts). A later cell with the same
  key copies its plan and initial state into the buffers and replays
  the same graph. On the CPU, and in :func:`simulate_eager` (the oracle
  the graphs are held to), the same dispatch runs eagerly
  (:func:`run_chunk`).
* :func:`simulate_plans` — the host loop over the ``chunk_boundaries``:
  counters read at every boundary, warmup counters subtracted, the run
  stopping at the first boundary where the measured commits reach
  ``target_commits``. The results equal the reference driver's in every
  one of its modes, which are all bit-identical to its serial loop.
"""

from __future__ import annotations

import functools
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.convert import plan_from_numpy
from repro_torch.core.engine import NCAT, EngineConfig, PlanMeta, SimResult

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
    r_end)``: the enqueue-stamp rebase (lock-table engine; it bounds the
    monotone ``enq_ctr`` and is bit-exact), one step, then K - 1 guarded
    steps. The caller runs it only while ``r < r_end``."""
    rebase = not cfg.is_batch_planned
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


def _counted_ops() -> list:
    """The ops modules of the kernels a step may launch. Each counts its
    launches on the host, so a replay adds what its capture recorded."""
    from repro_torch.kernels.dep_wavefront import ops as dw_ops
    from repro_torch.kernels.lock_grant import ops as lg_ops

    return [lg_ops, dw_ops]


def _signature(d: dict) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(d.items()))


class _Graph:
    """One dispatch captured as a CUDA graph over static buffers: the
    plan dict, the state dict and a 0-d int32 ``r_end``. The dispatch
    ends by copying its output state into the state buffers, so that
    replays chain. Capturing runs the dispatch first on scratch copies of
    the state, on a side stream (the first launches, such as a kernel's
    ``cudaFuncSetAttribute``, may not happen under capture); neither that
    warm-up nor the capture counts in the kernels' ``launches``."""

    def __init__(self, dispatch, p: dict, state: dict, device):
        t0 = time.perf_counter()
        self.p = {k: v.clone() for k, v in p.items()}
        self.state = {k: v.clone() for k, v in state.items()}
        self.r_end = torch.zeros((), dtype=torch.int32, device=device)
        self.bound_p = p
        ops = _counted_ops()
        before = [m.launches for m in ops]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            scratch = {k: v.clone() for k, v in self.state.items()}
            for _ in range(2):
                scratch = dispatch(self.p, scratch, scratch["r"] + 1)
        torch.cuda.current_stream(device).wait_stream(side)
        del scratch
        warm = [m.launches for m in ops]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = dispatch(self.p, self.state, self.r_end)
            _copy_back(out, self.state)
            del out
        self.per_replay = [(m, m.launches - w) for m, w in zip(ops, warm)]
        for m, b in zip(ops, before):
            m.launches = b
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
        for m, n in self.per_replay:
            m.launches += n


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
            builder = (engine_lib.make_batch_step if self.cfg.is_batch_planned
                       else engine_lib.make_step)
            step = builder(self.cfg, self.meta, self.device)
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


def get_runner(cfg: EngineConfig, meta: PlanMeta, device) -> ChunkRunner:
    """The cached :class:`ChunkRunner` for this (config statics, plan
    shape, device) key; a miss makes one (its step is built, and on CUDA
    its graph captured, at its first call)."""
    dev = _device_key(device)
    key = (cfg.trace_statics(), meta, dev)
    runner = _RUNNER_CACHE.get(key)
    if runner is not None:
        _RUNNER_CACHE.move_to_end(key)
        _RUNNER_CACHE_STATS["hits"] += 1
        return runner
    _RUNNER_CACHE_STATS["misses"] += 1
    runner = _RUNNER_CACHE[key] = ChunkRunner(cfg, meta, dev)
    _evict_to(_RUNNER_CACHE_CAPACITY)
    return runner


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
    """Run the simulation of one plan on ``device`` (CUDA by default)
    through its cached chunk runner (graph replays on CUDA).

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
    meta = engine_lib.plan_meta(cfg, plans[0])
    return [_host_loop(cfg, plans[0], meta, dev, get_runner(cfg, meta, dev))]


def simulate_eager(
    cfg: EngineConfig,
    plan,
    *,
    device: torch.device | str | None = None,
) -> SimResult:
    """:func:`simulate_plans` with every dispatch run eagerly and no
    CUDA graph (a fresh runner, not cached): the CPU's path, and on a
    card the oracle its graphs are held to."""
    engine_lib.check_ported(cfg)
    dev = engine_lib.resolve_device(device)
    meta = engine_lib.plan_meta(cfg, plan)
    dispatch = ChunkRunner(cfg, meta, dev).dispatch
    return _host_loop(cfg, plan, meta, dev,
                      functools.partial(run_chunk, dispatch))


def _host_loop(cfg: EngineConfig, plan, meta: PlanMeta, dev: torch.device,
               run) -> SimResult:
    """``run(p, state, r_end)`` advances the state chunk by chunk."""
    p = plan_from_numpy(engine_lib.plan_device(cfg, plan), dev)
    if cfg.is_batch_planned:
        state = engine_lib._batch_state0(cfg, plan, cfg.n_slots, dev)
    else:
        state = engine_lib._state0(
            cfg, plan.num_records, cfg.n_slots, meta.max_keys, dev
        )

    t0 = time.time()
    warm, warm_rounds = _zeros_like_counters(), 0
    final, rounds_done, stop = None, 0, None
    for b in chunk_boundaries(cfg):
        state = run(p, state, b)
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
    return _result(cfg, plan, snap, wsnap, ri, wri, wall)
