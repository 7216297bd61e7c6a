"""K-fused dispatch (``rounds_per_dispatch``) in the PyTorch port against
the JAX reference's mega-dispatch, on the CPU.

  * **Fused K equals the reference**: for each of the nine protocols the
    port at K = 1, 2, 5 and 8 gives ``repro.core.engine.run_simulation``'s
    fingerprint, metrics and ``raw`` counters; with leaping off, the
    leaped run's apart from ``steps_executed``.
  * **State at every chunk boundary**: at K = 8 every state array, the
    enqueue stamps and their counter included, equals the reference
    runner's (``repro.core.sweep.get_runner``), which pins the stamp
    rebase to the start of each dispatch.
  * **The guarded step**: at ``r >= r_end`` it leaves every state array
    bit-identical; below it equals the unguarded step.
  * Mirrors of ``tests/test_megadispatch.py``'s fused-K cells, property
    and near-wrap regression, and of ``tests/test_sweep_cache.py``'s
    runner-cache accounting, with one cached runner serving two epoch
    intervals.

Sizes are ``tests/test_megadispatch.py``'s (its protocols' lanes, the
512-txn / 20,000-record YCSB), at 300 rounds in chunks of 100 in place
of its 900 in chunks of 300.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from golden.regenerate import fingerprint  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import sweep as ref_sweep  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import engine, sweep, workloads  # noqa: E402
from repro_torch.core.convert import (  # noqa: E402
    plan_from_numpy,
    state_to_numpy,
)
from repro_torch.core.engine import EngineConfig, PlanMeta  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAST = dict(max_rounds=300, warmup_rounds=100, chunk_rounds=100,
            target_commits=10**9)

PROTO_KW = {
    "twopl_waitdie": dict(n_exec=8),
    "twopl_waitfor": dict(n_exec=8),
    "twopl_dreadlocks": dict(n_exec=8),
    "deadlock_free": dict(n_exec=8),
    "orthrus": dict(n_cc=2, n_exec=6, window=2),
    "partitioned_store": dict(n_exec=8),
    "dgcc": dict(n_cc=2, n_exec=6, window=2),
    "quecc": dict(n_cc=4, n_exec=6, window=2),
    "scheduled": dict(n_exec=8),
}

YCSB_HOT = dict(kind="ycsb", num_txns=512, num_records=20_000, num_hot=8,
                seed=0)
YCSB_MULTIPART = dict(kind="ycsb", num_txns=256, num_records=10_000,
                      num_hot=8, multipart_frac=1.0, num_partitions=8,
                      batch_epoch=64, seed=0)
BACKLOG = dict(admission_policy="bounded_backlog", backlog_cap=48,
               epoch_interval_rounds=60)
# the cache tests' base config (tests/test_sweep_cache.py's BASE)
BASE = dict(protocol="twopl_waitdie", n_exec=4)


@functools.lru_cache(maxsize=None)
def _wl(items):
    kw = dict(items)
    return (workloads.make_workload(workloads.WorkloadConfig(**kw)),
            ref_workloads.make_workload(ref_workloads.WorkloadConfig(**kw)))


def _wls(wl_kw):
    return _wl(tuple(sorted(wl_kw.items())))


def _cfg(protocol, sim=FAST, **kw):
    return dict(protocol=protocol, **PROTO_KW[protocol], **sim, **kw)


def _port(eng_kw, wl_kw):
    return engine.run_simulation(EngineConfig(**eng_kw), _wls(wl_kw)[0],
                                 device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_cached(eng_items, wl_items):
    return ref_engine.run_simulation(ref_engine.EngineConfig(**dict(eng_items)),
                                     _wl(wl_items)[1])


def _ref(eng_kw, wl_kw):
    return _ref_cached(tuple(sorted(eng_kw.items())),
                       tuple(sorted(wl_kw.items())))


def _raw(res):
    return {k: v for k, v in res.raw.items() if k != "wall_s_group"}


def _assert_same(got, ref):
    """Fingerprint, metrics and every ``raw`` counter."""
    assert fingerprint(got, include_metrics=True) == fingerprint(
        ref, include_metrics=True)
    assert got.metrics.summary_row() == ref.metrics.summary_row()
    assert _raw(got) == _raw(ref)


# ------------------------------------------------------ (a) fused K


@pytest.mark.parametrize("protocol", sorted(PROTO_KW))
def test_fused_k_matches_reference(protocol):
    """K = 1, 2, 5, 8 give the reference's K = 1 run; leaping off at K = 8
    gives it apart from steps_executed."""
    ref = _ref(_cfg(protocol), YCSB_HOT)
    for k in (1, 2, 5, 8):
        _assert_same(_port(_cfg(protocol, rounds_per_dispatch=k), YCSB_HOT),
                     ref)
    dense = _port(_cfg(protocol, rounds_per_dispatch=8, event_leap=False),
                  YCSB_HOT)
    want = fingerprint(ref, include_metrics=True)
    got = fingerprint(dense, include_metrics=True)
    want.pop("steps_executed")
    assert got.pop("steps_executed") == FAST["max_rounds"]
    assert got == want


# --------------------------------------- (b) state at chunk boundaries


def _chunk_states(protocol, k, **kw):
    """The port's and the reference's state after every chunk of one run
    at K = ``k``, each through its runner."""
    eng_kw = _cfg(protocol, rounds_per_dispatch=k, **kw)
    wl, ref_wl = _wls(YCSB_HOT)
    cfg = EngineConfig(**eng_kw)
    ref_cfg = ref_engine.EngineConfig(**dict(eng_kw, kernel_impl="auto"))
    plan, ref_plan = engine.make_plan(cfg, wl), ref_engine.make_plan(
        ref_cfg, ref_wl)
    meta = engine.plan_meta(cfg, plan)
    p = plan_from_numpy(engine.plan_device(cfg, plan), "cpu")
    ref_p = ref_engine.plan_device(ref_cfg, ref_plan)
    if cfg.is_batch_planned:
        s = engine._batch_state0(cfg, plan, cfg.n_slots, "cpu")
        ref_s = ref_engine._batch_state0(ref_cfg, ref_plan, cfg.n_slots)
    else:
        s = engine._state0(cfg, plan.num_records, cfg.n_slots,
                           meta.max_keys, "cpu")
        ref_s = ref_engine._state0(ref_cfg, ref_plan.num_records,
                                   cfg.n_slots, meta.max_keys)
    runner = sweep.get_runner(cfg, meta, "cpu")
    ref_runner = ref_sweep.get_runner(ref_cfg, ref_engine.plan_meta(
        ref_cfg, ref_plan), False)
    for b in sweep.chunk_boundaries(cfg):
        s = runner(p, s, b)
        ref_s = ref_runner(ref_p, ref_s, np.int32(b))
        yield b, state_to_numpy(s), {k: np.asarray(v)
                                     for k, v in ref_s.items()}


@pytest.mark.parametrize("protocol,kw", [
    ("orthrus", dict(kernel_impl="pallas")),
    ("twopl_waitfor", {}),
    ("dgcc", {}),
], ids=["orthrus_kernel_wrapper", "twopl_waitfor", "dgcc"])
def test_state_at_every_chunk_boundary(protocol, kw):
    n = 0
    for b, got, want in _chunk_states(protocol, 8, **kw):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{key} at round {b}")
        assert int(got["r"]) >= b
        n += 1
    assert n == 3
    if protocol != "dgcc":
        assert "enq_ctr" in got and "enq" in got


# ------------------------------------------------ (c) the guarded step


def _mid_run(eng_kw, wl_kw, rounds=150):
    """A state partway through a run, its plan and its step."""
    cfg = EngineConfig(**eng_kw, **FAST)
    plan = engine.make_plan(cfg, _wls(wl_kw)[0])
    meta = engine.plan_meta(cfg, plan)
    p = plan_from_numpy(engine.plan_device(cfg, plan), "cpu")
    if cfg.is_batch_planned:
        s = engine._batch_state0(cfg, plan, cfg.n_slots, "cpu")
        step = engine.make_batch_step(cfg, meta, "cpu")
    else:
        s = engine._state0(cfg, plan.num_records, cfg.n_slots,
                           meta.max_keys, "cpu")
        step = engine.make_step(cfg, meta, "cpu")
    s = sweep.run_chunk(sweep.make_dispatch(cfg, step), p, s, rounds)
    return p, s, step


def _clone(s):
    return {k: v.clone() for k, v in s.items()}


@pytest.mark.parametrize("eng_kw,wl_kw", [
    (_cfg("orthrus", sim={}), YCSB_HOT),
    (_cfg("twopl_waitfor", sim={}), YCSB_HOT),
    (_cfg("quecc", sim={}, fragment_exec=True, inter_batch_pipeline=True),
     YCSB_MULTIPART),
    (dict(_cfg("deadlock_free", sim={}), admission_policy="deadline_shed",
          deadline_rounds=200, epoch_interval_rounds=40), YCSB_HOT),
    (dict(_cfg("dgcc", sim={}), n_planner_lanes=1, epoch_interval_rounds=30,
          fragment_exec=True), YCSB_MULTIPART),
], ids=["orthrus", "twopl_waitfor", "quecc_frag_pipe", "open_shed",
        "open_dgcc_lanes"])
def test_guarded_step(eng_kw, wl_kw):
    p, s, step = _mid_run(eng_kw, wl_kw)
    guarded = sweep.guard_step(step)
    r = s["r"].clone()
    # inactive: r >= r_end, every array comes back as it was
    for r_end in (r, r - 1):
        before = _clone(s)
        out = guarded(p, _clone(s), r_end)
        assert out.keys() == before.keys()
        for k in before:
            assert torch.equal(out[k], before[k]), k
    # active: the unguarded step's state
    r_end = r + 50
    want = step(p, _clone(s), r_end)
    got = guarded(p, _clone(s), r_end)
    assert int(got["r"]) > int(r)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_step_updates_only_drop_row_arrays_in_place():
    """The guard copies exactly the arrays a step may update in place."""
    for eng_kw, wl_kw in ((_cfg("twopl_waitfor", sim={}), YCSB_HOT),
                          (_cfg("dgcc", sim={}, fragment_exec=True),
                           YCSB_MULTIPART)):
        p, s, step = _mid_run(eng_kw, wl_kw, rounds=50)
        versions = {k: v._version for k, v in s.items()}
        step(p, s, s["r"] + 10)
        moved = {k for k, v in s.items() if v._version != versions[k]}
        assert moved and moved <= set(engine.DROP_ROW_ARRAYS), moved


# ---------------------------------- (d) mirrors of test_megadispatch.py


def test_fused_k_bounded_backlog_cell():
    eng = _cfg("twopl_waitdie", **BACKLOG)
    ref = _ref(eng, YCSB_HOT)
    assert ref.raw["pol_rejected"] > 0
    for k in (2, 8):
        _assert_same(_port(dict(eng, rounds_per_dispatch=k), YCSB_HOT), ref)


def test_fused_k_quecc_fragment_cell():
    eng = _cfg("quecc", fragment_exec=True)
    ref = _ref(eng, YCSB_MULTIPART)
    for k in (2, 8):
        _assert_same(_port(dict(eng, rounds_per_dispatch=k), YCSB_MULTIPART),
                     ref)


@settings(max_examples=6, deadline=None)
@given(
    protocol=st.sampled_from(sorted(PROTO_KW)),
    k=st.sampled_from([1, 2, 8]),
    num_hot=st.sampled_from([4, 32]),
    seed=st.integers(min_value=0, max_value=3),
)
def test_fused_k_property(protocol, k, num_hot, seed):
    """Any (protocol, K, contention, seed) cell: the port's fused K equals
    the reference's K = 1."""
    wl_kw = dict(kind="ycsb", num_txns=256, num_records=8_000,
                 num_hot=num_hot, seed=seed)
    sim = dict(max_rounds=200, warmup_rounds=0, chunk_rounds=100,
               target_commits=10**9)
    ref = _ref(_cfg(protocol, sim=sim), wl_kw)
    _assert_same(_port(_cfg(protocol, sim=sim, rounds_per_dispatch=k),
                       wl_kw), ref)


def test_enq_ctr_near_wrap_rebase(monkeypatch):
    """A starting enq_ctr 2,000 stamps short of the int32 wrap leaves
    every counter unchanged at K = 8: the rebase at each dispatch's start
    keeps the live stamps near 1."""
    eng = _cfg("twopl_waitdie", rounds_per_dispatch=8)
    base = _ref(_cfg("twopl_waitdie"), YCSB_HOT)
    orig = engine._state0

    def bumped(*args, **kw):
        s = orig(*args, **kw)
        s["enq_ctr"] = s["enq_ctr"] + (2**31 - 2_000)
        return s

    monkeypatch.setattr(engine, "_state0", bumped)
    _assert_same(_port(eng, YCSB_HOT), base)


# --------------------------- (e) the runner cache (test_sweep_cache.py)

TRACED_VARIANTS = {
    "protocol": dict(protocol="deadlock_free"),
    "n_exec": dict(n_exec=5),
    "n_cc": dict(n_cc=2),
    "window": dict(window=3),
    "split_index": dict(split_index=True),
    "event_leap": dict(event_leap=False),
    "fragment_exec": dict(protocol="dgcc", n_cc=2, fragment_exec=True),
    "inter_batch_pipeline": dict(protocol="dgcc", n_cc=2,
                                 fragment_exec=True,
                                 inter_batch_pipeline=True),
    "n_planner_lanes": dict(protocol="dgcc", n_cc=2, n_planner_lanes=2),
    "epoch_interval_rounds": dict(epoch_interval_rounds=100),
    "admission_policy": dict(admission_policy="bounded_backlog",
                             backlog_cap=64, epoch_interval_rounds=100),
    "retry_budget": dict(retry_budget=2),
    "backoff_mode": dict(backoff_mode="exp"),
    "arrival_pattern": dict(arrival_pattern="burst", burst_period_epochs=4,
                            burst_on_epochs=1, epoch_interval_rounds=100),
    "cost": dict(cost=dataclasses.replace(EngineConfig(**BASE).cost,
                                          lock_op_cycles=999)),
    "rounds_per_dispatch": dict(rounds_per_dispatch=2),
    "release_path": dict(release_path="dense"),
    "kernel_impl": dict(kernel_impl="jnp"),
}


@pytest.fixture
def scratch_cache():
    """An empty runner cache for the test, the process's own restored
    after it."""
    saved = dict(sweep._RUNNER_CACHE)
    stats = dict(sweep._RUNNER_CACHE_STATS)
    old_cap = sweep.set_runner_cache_capacity(256)
    sweep._RUNNER_CACHE.clear()
    yield old_cap
    sweep._RUNNER_CACHE.clear()
    sweep._RUNNER_CACHE.update(saved)
    sweep._RUNNER_CACHE_STATS.update(stats)
    sweep.set_runner_cache_capacity(old_cap)


def test_runner_cache_capacity_and_key(scratch_cache):
    """The reference's bound (256, or ``REPRO_SWEEP_RUNNER_CACHE``), and
    the key (statics, plan shape, device); the step is built lazily."""
    assert scratch_cache == ref_sweep.runner_cache_info()["capacity"]
    runner = sweep.get_runner(EngineConfig(**BASE), PlanMeta(8, 2, 16), "cpu")
    key = sweep.runner_cache_info()["keys"][0]
    assert key == (EngineConfig(**BASE).trace_statics(), PlanMeta(8, 2, 16),
                   torch.device("cpu"))
    assert isinstance(runner, sweep.ChunkRunner) and not runner.graphed
    assert runner._dispatch is None  # built at the first call


def test_runner_cache_misses_on_statics_and_shapes(scratch_cache):
    meta = PlanMeta(n_txns=8, max_keys=2, num_records=16)
    cfg = EngineConfig(**BASE)
    base = sweep.runner_cache_info()
    sweep.get_runner(cfg, meta, "cpu")
    sweep.get_runner(EngineConfig(**BASE), meta, "cpu")
    n = 1
    assert sweep.runner_cache_info()["entries"] == n
    for f, kw in TRACED_VARIANTS.items():
        sweep.get_runner(dataclasses.replace(cfg, **kw), meta, "cpu")
        n += 1
        assert sweep.runner_cache_info()["entries"] == n, f
    for shape_kw in (dict(n_txns=9), dict(max_keys=3), dict(num_records=32),
                     dict(lane_cols=4), dict(pred_width=2),
                     dict(num_batches=2), dict(n_frags=4),
                     dict(frag_pred_width=2)):
        sweep.get_runner(cfg, dataclasses.replace(meta, **shape_kw), "cpu")
        n += 1
        assert sweep.runner_cache_info()["entries"] == n, shape_kw
    info = sweep.runner_cache_info()
    assert info["hits"] == base["hits"] + 1
    assert info["misses"] == base["misses"] + n
    # K = 5 shares K = 8's runner (the pow2 bucket)
    k8 = sweep.get_runner(dataclasses.replace(cfg, rounds_per_dispatch=8),
                          meta, "cpu")
    assert sweep.get_runner(dataclasses.replace(cfg, rounds_per_dispatch=5),
                            meta, "cpu") is k8


def test_host_loop_and_traced_values_share_a_runner(scratch_cache):
    meta = PlanMeta(n_txns=8, max_keys=2, num_records=16)
    cfg = EngineConfig(**BASE)
    a = sweep.get_runner(cfg, meta, "cpu")
    for f, v in (("max_rounds", 123), ("warmup_rounds", 7),
                 ("chunk_rounds", 11), ("target_commits", 1)):
        assert sweep.get_runner(dataclasses.replace(cfg, **{f: v}), meta,
                                "cpu") is a
    base = dict(BASE, epoch_interval_rounds=100)
    for kind_kw, a_kw, b_kw in (
        ({}, dict(epoch_interval_rounds=50),
         dict(epoch_interval_rounds=400)),
        (dict(admission_policy="bounded_backlog"),
         dict(backlog_cap=32), dict(backlog_cap=512)),
        (dict(admission_policy="token_bucket", token_burst=8),
         dict(token_interval_rounds=2), dict(token_interval_rounds=64)),
        (dict(admission_policy="deadline_shed"),
         dict(deadline_rounds=50), dict(deadline_rounds=5000)),
        (dict(backoff_mode="exp"),
         dict(backoff_max_rounds=16), dict(backoff_max_rounds=1024)),
        ({}, dict(retry_budget=1), dict(retry_budget=9)),
        (dict(arrival_pattern="burst", burst_period_epochs=8),
         dict(burst_on_epochs=1), dict(burst_on_epochs=7)),
    ):
        ra = sweep.get_runner(EngineConfig(**dict(base, **kind_kw, **a_kw)),
                              meta, "cpu")
        rb = sweep.get_runner(EngineConfig(**dict(base, **kind_kw, **b_kw)),
                              meta, "cpu")
        assert ra is rb, (kind_kw, a_kw)


def test_runner_cache_lru_eviction(scratch_cache):
    cfg = EngineConfig(**BASE)
    metas = [PlanMeta(n_txns=8 + i, max_keys=2, num_records=16)
             for i in range(3)]
    keys = [(cfg.trace_statics(), m, torch.device("cpu")) for m in metas]
    sweep.set_runner_cache_capacity(2)
    base = sweep.runner_cache_info()
    a = sweep.get_runner(cfg, metas[0], "cpu")
    sweep.get_runner(cfg, metas[1], "cpu")
    assert sweep.get_runner(cfg, metas[0], "cpu") is a  # refreshed to MRU
    sweep.get_runner(cfg, metas[2], "cpu")
    info = sweep.runner_cache_info()
    assert info["entries"] == info["capacity"] == 2
    assert info["hits"] == base["hits"] + 1
    assert info["misses"] == base["misses"] + 3
    assert info["evictions"] == base["evictions"] + 1
    assert keys[1] not in info["keys"]
    assert keys[0] in info["keys"] and keys[2] in info["keys"]
    sweep.get_runner(cfg, metas[1], "cpu")
    info = sweep.runner_cache_info()
    assert keys[0] not in info["keys"]
    assert info["misses"] == base["misses"] + 4
    assert info["evictions"] == base["evictions"] + 2


def test_runner_cache_capacity_shrink_evicts(scratch_cache):
    cfg = EngineConfig(**BASE)
    metas = [PlanMeta(n_txns=64 + i, max_keys=2, num_records=16)
             for i in range(4)]
    sweep.set_runner_cache_capacity(8)
    closed = []
    for m in metas:
        sweep.get_runner(cfg, m, "cpu").close = (
            lambda m=m: closed.append(m))
    before = sweep.runner_cache_info()["evictions"]
    assert sweep.set_runner_cache_capacity(2) == 8
    info = sweep.runner_cache_info()
    assert info["entries"] == 2 and info["evictions"] == before + 2
    assert info["keys"] == [(cfg.trace_statics(), m, torch.device("cpu"))
                            for m in metas[2:]]
    assert closed == metas[:2]  # eviction frees the runner


def test_one_runner_serves_two_epoch_intervals(scratch_cache):
    """A cached runner through two cells that differ only in the epoch
    interval, then the first again: each gives the reference's run."""
    eng = _cfg("deadlock_free", sim=FAST, admission_policy="deadline_shed",
               deadline_rounds=300)
    runs = [dict(eng, epoch_interval_rounds=iv) for iv in (40, 80, 40)]
    base = sweep.runner_cache_info()
    for eng_kw in runs:
        _assert_same(_port(eng_kw, YCSB_HOT), _ref(eng_kw, YCSB_HOT))
    info = sweep.runner_cache_info()
    assert info["entries"] == 1 and info["hits"] == base["hits"] + 2
