"""Open epoch arrival and the overload layer in the PyTorch port:
admission policies, bursty arrival, retry budgets and exponential
backoff, on both step builders.

  * **Differentials**: every reported number of a run (counters, the
    ``pol_*`` counters, ``offered`` and the rest of the metrics layer)
    equals ``repro.core.engine.run_simulation``'s on the cells of
    ``tests/test_overload.py`` and on orthrus and the planner-lane
    batch engines under open arrival.
  * **Oracle pins**: the port's counters equal the host recurrences of
    its own ``cost_model`` copy over the closed-form arrival schedule
    (``engine.offered_by_round``), as the reference's do.
  * **Leap against dense**: policy drop and wake rounds are leap
    candidates, so the port's leaping loop reproduces its dense loop
    exactly for every policy, backoff mode and arrival pattern.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from golden.regenerate import fingerprint  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import cost_model, workloads  # noqa: E402
from repro_torch.core import engine as engine_lib  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402

SIM = dict(max_rounds=1200, warmup_rounds=300, chunk_rounds=300,
           target_commits=10**9)
# warmup 0: raw pol_* deltas equal the full-run totals
SIM0 = dict(max_rounds=1200, warmup_rounds=0, chunk_rounds=300,
            target_commits=10**9)

OVERLOAD_WL = dict(kind="ycsb", num_txns=512, num_records=10_000,
                   num_hot=8, batch_epoch=64, seed=0)
MP_WL = dict(kind="ycsb", num_txns=256, num_records=10_000, num_hot=8,
             multipart_frac=1.0, num_partitions=8, batch_epoch=64, seed=0)
# uniform keys: the scheduled family's clusters stay small
UNIFORM_WL = dict(OVERLOAD_WL, num_hot=0)
TPCC_WL = dict(kind="tpcc", num_txns=256, num_warehouses=4,
               ollp_miss_prob=0.5, batch_epoch=64, seed=4)

BASE_ENG = dict(protocol="deadlock_free", n_exec=8,
                epoch_interval_rounds=150)
BATCH_ENG = dict(protocol="dgcc", n_cc=2, n_exec=6, window=2,
                 fragment_exec=True, epoch_interval_rounds=30)

# tests/test_overload.py's cells: one per policy, backoff and burst
# mechanism (fig17's sweep space)
POLICY_CELLS = {
    "bounded_backlog": dict(
        BASE_ENG, admission_policy="bounded_backlog", backlog_cap=100),
    "token_bucket": dict(
        BASE_ENG, admission_policy="token_bucket",
        token_interval_rounds=4, token_burst=32),
    "deadline_shed": dict(
        BASE_ENG, admission_policy="deadline_shed", deadline_rounds=400),
    "shed_exp_budget": dict(
        BASE_ENG, admission_policy="deadline_shed", deadline_rounds=400,
        retry_budget=3, backoff_mode="exp", backoff_max_rounds=256),
    "burst": dict(
        BASE_ENG, arrival_pattern="burst", burst_period_epochs=4,
        burst_on_epochs=1),
    "diurnal": dict(
        BASE_ENG, arrival_pattern="diurnal", burst_period_epochs=4),
    "bb_burst": dict(
        BASE_ENG, admission_policy="bounded_backlog", backlog_cap=100,
        arrival_pattern="burst", burst_period_epochs=4,
        burst_on_epochs=1),
    "batch_bb": dict(
        BATCH_ENG, admission_policy="bounded_backlog", backlog_cap=128),
    "batch_burst": dict(
        BATCH_ENG, arrival_pattern="burst", burst_period_epochs=4,
        burst_on_epochs=1),
    "batch_bb_quecc": dict(
        protocol="quecc", n_cc=4, n_exec=6, window=2,
        fragment_exec=True, epoch_interval_rounds=30,
        admission_policy="bounded_backlog", backlog_cap=128),
}
BATCH_CELLS = {"batch_bb", "batch_burst", "batch_bb_quecc"}

# open arrival on the paths POLICY_CELLS leaves out: orthrus (B1's
# path) with a policy, a retry budget and exp backoff, on TPC-C, whose
# OLLP misses are orthrus's only aborts; the planner-lane
# batch engines (B2's path), the batch token bucket and deadline shed,
# and pipelined admission under open arrival
ORTHRUS_OA = dict(protocol="orthrus", n_cc=2, n_exec=6, window=2,
                  epoch_interval_rounds=150,
                  admission_policy="deadline_shed", deadline_rounds=400,
                  retry_budget=3, backoff_mode="exp", backoff_max_rounds=256)
EXTRA_CELLS = {
    "orthrus_shed_budget_exp": (TPCC_WL, ORTHRUS_OA),
    "orthrus_bb_burst_budget1": (TPCC_WL, dict(
        protocol="orthrus", n_cc=2, n_exec=6, window=2,
        epoch_interval_rounds=150, admission_policy="bounded_backlog",
        backlog_cap=100, arrival_pattern="burst", burst_period_epochs=4,
        burst_on_epochs=1, retry_budget=1)),
    "dgcc_planner_l2": (MP_WL, dict(
        protocol="dgcc", n_cc=2, n_exec=6, window=2, n_planner_lanes=2,
        epoch_interval_rounds=45)),
    "scheduled_planner_l1_shed": (UNIFORM_WL, dict(
        protocol="scheduled", n_exec=8, n_planner_lanes=1,
        epoch_interval_rounds=60, admission_policy="deadline_shed",
        deadline_rounds=200)),
    "dgcc_token_bucket": (MP_WL, dict(
        BATCH_ENG, admission_policy="token_bucket",
        token_interval_rounds=20, token_burst=128)),
    "quecc_frag_shed_diurnal": (MP_WL, dict(
        protocol="quecc", n_cc=4, n_exec=6, window=2, fragment_exec=True,
        epoch_interval_rounds=30, admission_policy="deadline_shed",
        deadline_rounds=100, arrival_pattern="diurnal",
        burst_period_epochs=4)),
    "quecc_frag_pipe_planner_oa": (MP_WL, dict(
        protocol="quecc", n_cc=4, n_exec=6, window=2, fragment_exec=True,
        inter_batch_pipeline=True, n_planner_lanes=2,
        epoch_interval_rounds=40)),
    "waitdie_exp_closed": (OVERLOAD_WL, dict(
        protocol="twopl_waitdie", n_exec=8, backoff_mode="exp",
        backoff_max_rounds=4096)),
}

POL_KEYS = ("pol_rejected", "pol_shed", "pol_timedout", "pol_tb_adm",
            "pol_sacrificed", "pol_backoff_rounds", "epoch_ctr")


def _fingerprint(res):
    """Counters, policy counters and the whole metrics layer: all that a
    result shows except wall time and step counts."""
    fp = [
        res.commits, res.aborts_deadlock, res.aborts_ollp,
        res.wasted_ops, res.rounds,
        tuple(sorted(res.breakdown.items())),
        res.raw["total_commits"], res.raw["next_txn"],
        res.raw["rounds_total"],
        tuple((k, res.raw.get(k)) for k in POL_KEYS),
    ]
    m = res.metrics
    fp += [
        tuple(int(x) for x in m.lat_hist),
        tuple(int(x) for x in m.q_depth),
        tuple(int(x) for x in m.q_inflight),
        m.p50, m.p99, m.p999,
        m.offered, m.admitted, m.committed, m.rejected, m.shed,
        m.timedout, m.sacrificed,
    ]
    return tuple(fp)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _wl(key):
    return workloads.make_workload(workloads.WorkloadConfig(**dict(key)))


@functools.cache
def _port_run(cfg, wl_key):
    """One port run on the CPU, memoized across this module's tests (a
    policy cell's run serves its differential and its leap check; no
    test changes a returned result)."""
    return engine_lib.run_simulation(cfg, _wl(wl_key), device="cpu")


def _run(eng_kw, wl_kw, sim=SIM, **overrides):
    cfg = EngineConfig(**dict(eng_kw, **overrides), **sim)
    return _port_run(cfg, tuple(sorted(wl_kw.items())))


@functools.lru_cache(maxsize=None)
def _ref_wl(key):
    return ref_workloads.make_workload(
        ref_workloads.WorkloadConfig(**dict(key)))


def _ref(eng_kw, wl_kw, sim=SIM):
    return ref_engine.run_simulation(
        ref_engine.EngineConfig(**eng_kw, **sim),
        _ref_wl(tuple(sorted(wl_kw.items()))),
    )


def _assert_same_run(got, ref):
    assert _fingerprint(got) == _fingerprint(ref)
    assert fingerprint(got, include_metrics=True) == fingerprint(
        ref, include_metrics=True)
    skip = {"wall_s_group"}
    assert {k: v for k, v in got.raw.items() if k not in skip} == {
        k: v for k, v in ref.raw.items() if k not in skip}
    assert got.metrics.summary_row() == ref.metrics.summary_row()
    assert got.metrics.breakdown_ext == ref.metrics.breakdown_ext


# ---------------------------------------------------------------------------
# differentials against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(POLICY_CELLS))
def test_policy_cell_matches_reference(name):
    wl = MP_WL if name in BATCH_CELLS else OVERLOAD_WL
    eng = POLICY_CELLS[name]
    got, ref = _run(eng, wl), _ref(eng, wl)
    _assert_same_run(got, ref)
    assert got.metrics.offered > 0


# the counters each extra cell is there to move
MOVES = {
    "orthrus_shed_budget_exp": ("pol_backoff_rounds", "pol_shed",
                                "pol_timedout"),
    "orthrus_bb_burst_budget1": ("pol_rejected", "pol_sacrificed"),
    "dgcc_token_bucket": ("pol_tb_adm",),
    "quecc_frag_shed_diurnal": ("pol_shed",),
    "scheduled_planner_l1_shed": ("pol_shed", "plan_busy"),
    "waitdie_exp_closed": ("pol_backoff_rounds",),
}


@pytest.mark.parametrize("name", sorted(EXTRA_CELLS))
def test_open_arrival_cell_matches_reference(name):
    """Orthrus and the planner-lane batch engines under open arrival,
    on the plain path and through the kernels' wrappers (their plain
    versions on CPU tensors)."""
    wl, eng = EXTRA_CELLS[name]
    ref = _ref(eng, wl)
    for impl in ("jnp", "pallas"):
        got = _run(eng, wl, kernel_impl=impl)
        _assert_same_run(got, ref)
    for k in MOVES.get(name, ()):
        assert got.raw[k] > 0, k
    if name == "orthrus_bb_burst_budget1":
        # a budget of one attempt sacrifices every OLLP-miss abort
        assert got.raw["pol_sacrificed"] == got.aborts_ollp


# ---------------------------------------------------------------------------
# oracle pins: the port's counters against its cost_model copy
# ---------------------------------------------------------------------------


def _plan(eng, wl_kw, sim):
    cfg = EngineConfig(**eng, **sim)
    return cfg, engine_lib.make_plan(cfg, _wl(tuple(sorted(wl_kw.items()))))


def test_bounded_backlog_never_exceeds_cap():
    """After the last executed round the backlog (arrivals by the host
    oracle less consumed txns) is at most the cap, and consumption
    splits exactly into admitted and rejected."""
    cap = 100
    eng = dict(BASE_ENG, admission_policy="bounded_backlog",
               backlog_cap=cap)
    res = _run(eng, OVERLOAD_WL, sim=SIM0)
    cfg, plan = _plan(eng, OVERLOAD_WL, SIM0)
    arrived = engine_lib.offered_by_round(cfg, plan,
                                          res.raw["rounds_total"] - 1)
    consumed = res.raw["next_txn"]
    assert res.raw["pol_rejected"] > 0
    assert cost_model.backlog_drops(arrived, consumed, cap) == 0
    assert 0 <= arrived - consumed <= cap
    assert (int(np.max(res.metrics.q_depth))
            <= cap + OVERLOAD_WL["batch_epoch"])
    m = res.metrics
    assert m.admitted + m.rejected == consumed
    assert m.committed <= m.admitted <= m.offered


def test_deadline_shed_clears_stale_waiters():
    deadline = 400
    eng = dict(BASE_ENG, admission_policy="deadline_shed",
               deadline_rounds=deadline)
    res = _run(eng, OVERLOAD_WL, sim=SIM0)
    cfg, plan = _plan(eng, OVERLOAD_WL, SIM0)
    stale = engine_lib.offered_by_round(
        cfg, plan, res.raw["rounds_total"] - 1 - deadline - 1)
    assert res.raw["pol_shed"] > 0
    assert cost_model.deadline_drops(stale, res.raw["next_txn"]) == 0
    assert res.metrics.shed == res.raw["pol_shed"]


def test_token_bucket_admissions_match_grant_oracle():
    """With arrivals and slots both non-binding the token bucket is the
    only gate, so admissions equal ``cost_model.token_grant`` at the
    last executed round: the leap wakes at every token-ready round."""
    wl = dict(kind="ycsb", num_txns=512, num_records=10_000, num_hot=0,
              batch_epoch=512, seed=0)
    iv, burst = 8, 4
    eng = dict(protocol="deadlock_free", n_exec=32, epoch_interval_rounds=1,
               admission_policy="token_bucket", token_interval_rounds=iv,
               token_burst=burst)
    res = _run(eng, wl, sim=SIM0)
    r_last = res.raw["rounds_total"] - 1
    assert res.raw["pol_tb_adm"] == cost_model.token_grant(r_last, iv, burst)
    sched = cost_model.token_bucket_schedule(
        [0] * res.raw["pol_tb_adm"], iv, burst)
    assert sum(s <= r_last for s in sched) == res.raw["pol_tb_adm"]


def test_exp_backoff_with_cap_at_base_matches_fixed():
    """``min(base << shift, base) == base``: exp backoff capped at the
    base equals fixed backoff, and issues base rounds per abort."""
    cap = EngineConfig(protocol="twopl_waitdie",
                       n_exec=8).cost.abort_backoff_rounds
    fixed = _run(dict(protocol="twopl_waitdie", n_exec=8), OVERLOAD_WL,
                 sim=SIM0)
    exp = _run(dict(protocol="twopl_waitdie", n_exec=8, backoff_mode="exp",
                    backoff_max_rounds=cap), OVERLOAD_WL, sim=SIM0)
    assert _fingerprint(exp)[:9] == _fingerprint(fixed)[:9]
    aborts = exp.aborts_deadlock + exp.aborts_ollp
    assert aborts > 0
    assert all(cost_model.exp_backoff_rounds(cap, a, cap) == cap
               for a in range(8))
    assert exp.raw["pol_backoff_rounds"] == cap * aborts


def test_exp_backoff_unbounded_cap_exceeds_fixed_total():
    base_rounds = EngineConfig(
        protocol="twopl_waitdie", n_exec=8).cost.abort_backoff_rounds
    res = _run(dict(protocol="twopl_waitdie", n_exec=8, backoff_mode="exp",
                    backoff_max_rounds=4096), OVERLOAD_WL, sim=SIM0)
    aborts = res.aborts_deadlock + res.aborts_ollp
    assert aborts > 0
    assert res.raw["pol_backoff_rounds"] > base_rounds * aborts


def test_retry_budget_one_sacrifices_every_abort():
    res = _run(dict(protocol="twopl_waitdie", n_exec=8, retry_budget=1),
               OVERLOAD_WL, sim=SIM0)
    aborts = res.aborts_deadlock + res.aborts_ollp
    assert aborts > 0
    assert res.raw["pol_sacrificed"] == aborts


def test_sat_mul_saturates_instead_of_wrapping():
    sat = engine_lib._SAT

    def m(a, b):
        return int(engine_lib._sat_mul(torch.tensor(a, dtype=torch.int32),
                                       torch.tensor(b, dtype=torch.int32)))

    assert m(3, 5) == 15
    assert m(0, 2**30) == 0
    assert m(2**20, 2**20) == sat
    assert m(sat, 2) == sat
    assert m(sat // 7, 7) == (sat // 7) * 7


@pytest.mark.parametrize("policy_kw", [
    dict(admission_policy="bounded_backlog", backlog_cap=50),
    dict(admission_policy="deadline_shed", deadline_rounds=64),
    dict(admission_policy="token_bucket", token_interval_rounds=10**6,
         token_burst=1),
], ids=["bounded_backlog", "deadline_shed", "token_bucket"])
def test_max_sweepable_rate_stays_in_int32(policy_kw):
    """One whole workload per round, the fastest sweepable schedule: the
    closed forms' products leave int32 and must saturate, leap must
    still match dense, and the port must match the reference."""
    wl = dict(kind="ycsb", num_txns=512, num_records=10_000, num_hot=8,
              batch_epoch=512, seed=0)
    eng = dict(protocol="deadlock_free", n_exec=8, epoch_interval_rounds=1,
               **policy_kw)
    sim = dict(SIM0, max_rounds=600)
    res = _run(eng, wl, sim=sim)
    assert _fingerprint(res) == _fingerprint(
        _run(eng, wl, sim=sim, event_leap=False))
    _assert_same_run(res, _ref(eng, wl, sim))
    for k in POL_KEYS:
        if res.raw.get(k) is not None:
            assert res.raw[k] >= 0, k
    cfg, plan = _plan(eng, wl, sim)
    offered = engine_lib.offered_by_round(cfg, plan,
                                          res.raw["rounds_total"] - 1)
    consumed = res.raw["next_txn"]
    admitted = consumed - res.raw["pol_rejected"] - res.raw["pol_shed"]
    assert 0 <= admitted <= consumed <= offered
    assert res.commits <= admitted


@pytest.mark.parametrize("name", ["deadline_shed", "burst", "diurnal",
                                  "batch_bb", "batch_burst",
                                  "batch_bb_quecc"])
def test_offered_by_round_is_exact_int64(name):
    """The port's host oracle equals the reference's in exact int64,
    far past any simulated budget too."""
    eng = POLICY_CELLS[name]
    wl_kw = MP_WL if name in BATCH_CELLS else OVERLOAD_WL
    cfg, plan = _plan(eng, wl_kw, SIM)
    ref_cfg = ref_engine.EngineConfig(**eng, **SIM)
    ref_plan = ref_engine.make_plan(ref_cfg,
                                    _ref_wl(tuple(sorted(wl_kw.items()))))
    for r in (-1, 0, 1, 149, 150, 599, 1200, 10**7, 10**12):
        got = engine_lib.offered_by_round(cfg, plan, r)
        assert type(got) is int
        assert got == ref_engine.offered_by_round(ref_cfg, ref_plan, r), r
    assert engine_lib.offered_by_round(cfg, plan, -1) == 0
    if name == "deadline_shed":
        n, b, iv = (OVERLOAD_WL["num_txns"], OVERLOAD_WL["batch_epoch"],
                    BASE_ENG["epoch_interval_rounds"])
        cyc = n // b * iv
        r = 10**7
        assert engine_lib.offered_by_round(cfg, plan, r) == (
            (r // cyc) * n + min((r % cyc // iv + 1) * b, n))


def test_closed_loop_offers_nothing():
    cfg, plan = _plan(dict(protocol="deadlock_free", n_exec=8),
                      OVERLOAD_WL, SIM)
    assert engine_lib.offered_by_round(cfg, plan, 10**6) == 0


def test_searchsorted_right_matches_numpy_on_vectors_and_scalars():
    """The bursty closed forms' search, on a 0-d value (stage 1a) and a
    vector (the queue-depth grid), against numpy's side="right"."""
    seq = np.array([0, 0, 40, 40, 40, 90, 300], np.int32)
    vals = np.array([-5, 0, 1, 39, 40, 41, 90, 299, 300, 301, 10**6],
                    np.int32)
    want = np.searchsorted(seq, vals, side="right")
    t_seq = torch.from_numpy(seq)
    got = engine_lib._searchsorted_right(t_seq, torch.from_numpy(vals))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for v, w in zip(vals, want):
        g = engine_lib._searchsorted_right(t_seq, torch.tensor(v))
        assert g.shape == () and int(g) == w


# ---------------------------------------------------------------------------
# leap against dense, on the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(POLICY_CELLS))
def test_leap_matches_dense_per_policy(name):
    wl = MP_WL if name in BATCH_CELLS else OVERLOAD_WL
    leap = _run(POLICY_CELLS[name], wl, event_leap=True)
    dense = _run(POLICY_CELLS[name], wl, event_leap=False)
    assert _fingerprint(leap) == _fingerprint(dense)
    assert leap.raw["steps_executed"] <= dense.raw["steps_executed"]
    assert dense.raw["steps_executed"] == dense.raw["rounds_total"]


PROTO_KW = {
    "twopl_waitdie": dict(n_exec=8),
    "twopl_waitfor": dict(n_exec=8),
    "twopl_dreadlocks": dict(n_exec=8),
    "deadlock_free": dict(n_exec=8),
    "orthrus": dict(n_cc=2, n_exec=6, window=2),
    "partitioned_store": dict(n_exec=8),
    "dgcc": dict(n_cc=2, n_exec=6, window=2),
    "quecc": dict(n_cc=4, n_exec=6, window=2),
}


def _metrics_fp(res):
    m = res.metrics
    return (
        tuple(int(x) for x in m.lat_hist),
        tuple(int(x) for x in m.q_depth),
        tuple(int(x) for x in m.q_inflight),
        m.p50, m.p99, m.p999,
        tuple(sorted((k, float(v)) for k, v in m.breakdown_ext.items())),
    )


@settings(max_examples=8, deadline=None)
@given(
    protocol=st.sampled_from(sorted(PROTO_KW)),
    num_hot=st.sampled_from([0, 8, 512]),
    interval=st.sampled_from([0, 45, 150]),
    planner_lanes=st.sampled_from([0, 2]),
    seed=st.integers(min_value=0, max_value=3),
)
def test_leap_metrics_match_dense_property(protocol, num_hot, interval,
                                           planner_lanes, seed):
    """The port's histogram and queue samples leap bit-identically across
    protocol families, contention, open or closed arrival and the
    planner model. The partitioned store has no open arrival (its
    EngineConfig rejects an interval), so it draws closed loop only."""
    if protocol == "partitioned_store":
        interval = 0
    wl = dict(kind="ycsb", num_txns=256, num_records=10_000,
              num_hot=num_hot, batch_epoch=64, seed=seed)
    sim = dict(max_rounds=1000, warmup_rounds=250, chunk_rounds=250,
               target_commits=10**9)
    kw = dict(PROTO_KW[protocol], protocol=protocol,
              epoch_interval_rounds=interval)
    if planner_lanes and protocol in ("dgcc", "quecc") and interval:
        kw["n_planner_lanes"] = planner_lanes
    leap = _run(kw, wl, sim=sim, event_leap=True)
    dense = _run(kw, wl, sim=sim, event_leap=False)
    assert _metrics_fp(leap) == _metrics_fp(dense)
    assert leap.raw.get("plan_busy_int") == dense.raw.get("plan_busy_int")


def test_partitioned_store_rejects_open_arrival():
    with pytest.raises(AssertionError):
        EngineConfig(protocol="partitioned_store", n_exec=8,
                     epoch_interval_rounds=45)
