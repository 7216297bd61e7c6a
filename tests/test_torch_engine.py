"""The port's round engine against the JAX reference, step by step, plus
its own leap-vs-dense and csr-vs-dense identities, config checks and
unported paths."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from golden.regenerate import fingerprint  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import engine, sweep, workloads  # noqa: E402
from repro_torch.core.convert import (  # noqa: E402
    plan_from_numpy,
    state_from_numpy,
    state_to_numpy,
)

YCSB = dict(kind="ycsb", num_txns=128, num_records=2000, num_hot=8, seed=1)
TPCC = dict(kind="tpcc", num_txns=128, num_warehouses=2, ollp_miss_prob=0.5,
            seed=2)
ORTHRUS = dict(protocol="orthrus", n_cc=2, n_exec=3, window=2)
DF = dict(protocol="deadlock_free", n_exec=4)
# batch-planned cells: four 16-txn batches, so 200 steps wrap the
# workload; multipart txns so fragments differ from txns
YCSB_B = dict(YCSB, num_txns=64, batch_epoch=16)
YCSB_MP = dict(kind="ycsb", num_txns=64, num_records=5000, num_hot=8,
               multipart_frac=1.0, num_partitions=8, batch_epoch=16, seed=1)
TPCC_B = dict(TPCC, num_txns=64, batch_epoch=16)
DGCC = dict(protocol="dgcc", n_cc=2, n_exec=3, window=2)
QUECC = dict(protocol="quecc", n_cc=2, n_exec=3, window=2)
SCHED = dict(protocol="scheduled", n_exec=5)
DGCC_FRAG = dict(DGCC, fragment_exec=True)
QUECC_PIPE = dict(QUECC, fragment_exec=True, inter_batch_pipeline=True)
DGCC_LANES = dict(DGCC, n_planner_lanes=1)
# the dynamic-2PL baselines and the partitioned store (lock-table
# engine). At 40 slots the reader bitmask spans two words and bit 31 of
# the first (the int32 sign bit) is in use
WAITDIE = dict(protocol="twopl_waitdie", n_exec=40)
WAITFOR = dict(protocol="twopl_waitfor", n_exec=40)
DREADLOCKS = dict(protocol="twopl_dreadlocks", n_exec=24)
PSTORE = dict(protocol="partitioned_store", n_exec=4)
# YCSB with a quarter of its accesses turned into reads (see _workloads)
YCSB_MIXED = "ycsb_mixed"
SIM = dict(max_rounds=800, warmup_rounds=250, chunk_rounds=200,
           target_commits=10**9)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_rebase(state):
    return state


def _workloads(wl_kw):
    """The (port, reference) workloads of one config, made once for this
    module. YCSB_MIXED is YCSB with a quarter of its accesses turned into
    reads (seeded numpy): readers fill the reader bitmask while writers
    still deadlock (TPC-C's programs never do under wait-for)."""
    return _workload_pair(
        wl_kw if wl_kw == YCSB_MIXED else tuple(sorted(wl_kw.items())))


@functools.cache
def _workload_pair(key):
    mixed = key == YCSB_MIXED
    wl_kw = YCSB if mixed else dict(key)
    pair = (workloads.make_workload(workloads.WorkloadConfig(**wl_kw)),
            ref_workloads.make_workload(ref_workloads.WorkloadConfig(**wl_kw)))
    if mixed:
        rng = np.random.default_rng(0)
        modes = np.where(rng.random(pair[0].modes.shape) < 0.25,
                         workloads.MODE_READ, workloads.MODE_WRITE)
        pair = tuple(dataclasses.replace(w, modes=modes.astype(np.int32))
                     for w in pair)
    return pair


@functools.cache
def _ref_step(ref_cfg, meta):
    """The reference's jitted step for a config and plan shape, compiled
    once for this module."""
    make = (ref_engine.make_batch_step if ref_cfg.is_batch_planned
            else ref_engine.make_step)
    return jax.jit(make(ref_cfg, meta))


_REF_REBASE = jax.jit(ref_engine.rebase_enq)


@pytest.mark.parametrize("eng_kw,wl_kw,leap,impl", [
    (ORTHRUS, YCSB, True, "jnp"),
    (ORTHRUS, YCSB, False, "jnp"),
    (ORTHRUS, TPCC, True, "pallas"),
    (DF, YCSB, True, "jnp"),
    (DF, YCSB, False, "jnp"),
    (DF, TPCC, True, "jnp"),
    (DGCC, YCSB_B, True, "jnp"),
    (DGCC, YCSB_B, False, "pallas"),
    (DGCC, TPCC_B, True, "pallas"),
    (QUECC, YCSB_B, True, "pallas"),
    (QUECC, YCSB_B, False, "jnp"),
    (SCHED, YCSB_B, True, "pallas"),
    (SCHED, YCSB_B, False, "jnp"),
    (DGCC_FRAG, YCSB_MP, True, "pallas"),
    (DGCC_FRAG, YCSB_MP, False, "jnp"),
    (QUECC_PIPE, YCSB_MP, True, "jnp"),
    (QUECC_PIPE, YCSB_MP, False, "pallas"),
    (DGCC_LANES, YCSB_B, True, "pallas"),
    (DGCC_LANES, YCSB_B, False, "jnp"),
    (dict(WAITDIE, n_exec=4), TPCC, True, "jnp"),
    (WAITDIE, YCSB_MIXED, False, "jnp"),
    (WAITFOR, YCSB_MIXED, True, "jnp"),
    (dict(WAITFOR, release_path="dense"), YCSB_MIXED, False, "jnp"),
    (DREADLOCKS, YCSB, True, "jnp"),
    (dict(PSTORE, window=2), YCSB, True, "jnp"),
], ids=["orthrus-leap", "orthrus-dense", "orthrus-tpcc-kernel-wrapper",
        "df-leap", "df-dense", "df-tpcc",
        "dgcc-leap", "dgcc-dense-kernel-wrapper", "dgcc-tpcc-kernel-wrapper",
        "quecc-leap-kernel-wrapper", "quecc-dense",
        "scheduled-leap-kernel-wrapper", "scheduled-dense",
        "dgcc-frag-leap-kernel-wrapper", "dgcc-frag-dense",
        "quecc-frag-pipe-leap", "quecc-frag-pipe-dense-kernel-wrapper",
        "dgcc-planner-lanes-leap-kernel-wrapper",
        "dgcc-planner-lanes-dense", "waitdie-tpcc", "waitdie-mixed-dense",
        "waitfor-mixed", "waitfor-mixed-release-dense", "dreadlocks",
        "pstore-window2"])
def test_step_matches_reference(eng_kw, wl_kw, leap, impl):
    """From one carried-across state, >= 200 steps of both engines (with
    the chunk runner's stamp rebase and chunk bounds) leave every state
    array equal after every step. The batch engine starts from its own
    initial state, which must equal the reference's."""
    wl, ref_wl = _workloads(wl_kw)
    cfg = engine.EngineConfig(**eng_kw, event_leap=leap, kernel_impl=impl)
    ref_cfg = ref_engine.EngineConfig(**eng_kw, event_leap=leap,
                                      kernel_impl="jnp")
    ref_plan = ref_engine.make_plan(ref_cfg, ref_wl)
    meta = ref_engine.plan_meta(ref_cfg, ref_plan)
    p_np = ref_engine.plan_device(ref_cfg, ref_plan)
    p_ref = {k: jnp.asarray(v) for k, v in p_np.items()}
    p = plan_from_numpy(p_np, "cpu")
    plan = engine.make_plan(cfg, wl)
    batch = cfg.is_batch_planned
    if batch:
        ref_step = _ref_step(ref_cfg, meta)
        step = engine.make_batch_step(cfg, engine.plan_meta(cfg, plan), "cpu")
        s_ref = ref_engine._batch_state0(ref_cfg, ref_plan, cfg.n_slots)
        s = engine._batch_state0(cfg, plan, cfg.n_slots, "cpu")
        got = state_to_numpy(s)
        assert sorted(got) == sorted(s_ref)
        for k, v in s_ref.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        rebase = ref_rebase = _no_rebase  # no lock table, no stamps
    else:
        ref_step = _ref_step(ref_cfg, meta)
        ref_rebase = _REF_REBASE
        rebase = engine.rebase_enq
        step = engine.make_step(cfg, engine.plan_meta(cfg, plan), "cpu")
        s_ref = ref_engine._state0(ref_cfg, ref_plan.num_records, cfg.n_slots,
                                   meta.max_keys)
        s = state_from_numpy({k: np.asarray(v) for k, v in s_ref.items()},
                             "cpu")
    assert sorted(s) == sorted(s_ref)
    n_steps, r_end = 0, 0
    # leaping batch runs go on until the workload wraps (stale flags)
    wrap = meta.n_txns if batch and leap else -1
    while n_steps < 200 or int(s_ref["next_txn"]) <= wrap:
        r_end += 37  # chunk bounds that clamp leaps
        while int(s_ref["r"]) < r_end:
            s_ref = ref_step(p_ref, ref_rebase(s_ref), jnp.int32(r_end))
            s = step(p, rebase(s), torch.tensor(r_end, dtype=torch.int32))
            n_steps += 1
            got = state_to_numpy(s)
            for k, v in s_ref.items():
                assert s[k].dtype in (torch.int32, torch.bool), k
                np.testing.assert_array_equal(
                    got[k], np.asarray(v), err_msg=f"step {n_steps}: {k}")
    assert int(s_ref["commits"]) > 0
    if cfg.deadlock_scheme != "none":
        assert int(s_ref["aborts_dl"]) > 0


@pytest.mark.parametrize("eng_kw", [ORTHRUS, DF], ids=["orthrus", "df"])
@pytest.mark.parametrize("wl_kw", [YCSB, TPCC], ids=["ycsb", "tpcc"])
def test_leap_matches_dense(eng_kw, wl_kw):
    _assert_leap_matches_dense(eng_kw, wl_kw)


@pytest.mark.parametrize("eng_kw,wl_kw", [
    (DGCC, YCSB_B), (QUECC, TPCC_B), (SCHED, YCSB_B), (DGCC_FRAG, YCSB_MP),
    (QUECC_PIPE, YCSB_MP), (DGCC_LANES, YCSB_B),
], ids=["dgcc", "quecc-tpcc", "scheduled", "dgcc-frag", "quecc-frag-pipe",
        "dgcc-planner-lanes"])
def test_batch_leap_matches_dense(eng_kw, wl_kw):
    _assert_leap_matches_dense(eng_kw, wl_kw)


# the lock-table protocols with a deadlock stage or lane streams, each on
# the workload that exercises it
LOCK_TABLE_CELLS = {
    "waitdie": (WAITDIE, YCSB_MIXED),
    "waitfor": (WAITFOR, YCSB_MIXED),
    "dreadlocks": (DREADLOCKS, YCSB_MIXED),
    "pstore": (PSTORE, YCSB),
}


@pytest.mark.parametrize("cell", sorted(LOCK_TABLE_CELLS))
def test_lock_table_leap_matches_dense(cell):
    _assert_leap_matches_dense(*LOCK_TABLE_CELLS[cell])


@functools.cache
def _port_run(cfg, wl_key):
    """One port run on the CPU, memoized across this module's tests."""
    wl, _ = _workloads(wl_key if wl_key == YCSB_MIXED else dict(wl_key))
    return engine.run_simulation(cfg, wl, device="cpu")


def _run(eng_kw, wl_kw, **kw):
    wl_key = wl_kw if wl_kw == YCSB_MIXED else tuple(sorted(wl_kw.items()))
    return _port_run(engine.EngineConfig(**eng_kw, **kw, **SIM), wl_key)


@pytest.mark.parametrize("cell", sorted(LOCK_TABLE_CELLS) + ["df"])
def test_csr_release_matches_dense_oracle(cell):
    """The compact CSR grant and wait-for path (sorted requests, the
    carried reader bitmask) reports exactly what the dense [T, T(, K)]
    formulation does, the port's in-tree oracle."""
    eng_kw, wl_kw = LOCK_TABLE_CELLS.get(cell, (DF, TPCC))
    csr = _run(eng_kw, wl_kw)
    dense = _run(eng_kw, wl_kw, release_path="dense")
    assert fingerprint(dense, include_metrics=True) == fingerprint(
        csr, include_metrics=True)
    assert dense.raw["steps_executed"] == csr.raw["steps_executed"]
    assert csr.commits > 0
    if cell not in ("pstore", "df"):
        assert csr.aborts_deadlock > 0


@pytest.fixture(scope="module")
def waitfor_mid_run():
    """The reference's csr wait-for on mixed YCSB, stepped to the first
    state in which ``reach`` holds a path between two slots while the
    reader bitmask ``rdr`` is non-zero: (plan arrays, state), numpy."""
    _, ref_wl = _workloads(YCSB_MIXED)
    ref_cfg = ref_engine.EngineConfig(**WAITFOR)
    ref_plan = ref_engine.make_plan(ref_cfg, ref_wl)
    meta = ref_engine.plan_meta(ref_cfg, ref_plan)
    p_np = ref_engine.plan_device(ref_cfg, ref_plan)
    p_ref = {k: jnp.asarray(v) for k, v in p_np.items()}
    ref_step = _ref_step(ref_cfg, meta)
    ref_rebase = _REF_REBASE
    T = ref_cfg.n_slots
    s = ref_engine._state0(ref_cfg, ref_plan.num_records, T, meta.max_keys)
    off_diag = ~np.eye(T, dtype=bool)
    for _ in range(5000):
        s = ref_step(p_ref, ref_rebase(s), jnp.int32(10**6))
        if (np.asarray(s["reach"]) & off_diag).any() and np.asarray(
                s["rdr"]).any():
            return p_np, {k: np.asarray(v) for k, v in s.items()}
    raise AssertionError("no mid-run state with a wait-for path and readers")


@pytest.mark.parametrize("release_path", ["csr", "dense"])
def test_deadlock_stage_matches_reference_mid_run(waitfor_mid_run,
                                                  release_path):
    """From a mid-run wait-for state with a live reach matrix (and, on
    the csr path, reader bits), one port step equals one reference step
    array for array, and so does every step after it up to and past the
    next deadlock abort. The dense path starts from the same state
    without ``rdr``, which it does not carry."""
    p_np, s_np = waitfor_mid_run
    kw = dict(WAITFOR, release_path=release_path)
    if release_path == "dense":
        s_np = {k: v for k, v in s_np.items() if k != "rdr"}
    ref_cfg = ref_engine.EngineConfig(**kw)
    cfg = engine.EngineConfig(**kw)
    _, ref_wl = _workloads(YCSB_MIXED)
    meta = ref_engine.plan_meta(ref_cfg, ref_engine.make_plan(ref_cfg,
                                                              ref_wl))
    ref_step = _ref_step(ref_cfg, meta)
    step = engine.make_step(cfg, meta, "cpu")
    p_ref = {k: jnp.asarray(v) for k, v in p_np.items()}
    p = plan_from_numpy(p_np, "cpu")
    s_ref = {k: jnp.asarray(v) for k, v in s_np.items()}
    s = state_from_numpy(s_np, "cpu")
    r_end = int(s_np["r"]) + 10**6
    aborts = int(s_np["aborts_dl"])
    n = 0
    while int(s_ref["aborts_dl"]) == aborts or n < 30:
        assert n < 2000, "the detector never fired"
        n += 1
        s_ref = ref_step(p_ref, ref_engine.rebase_enq(s_ref),
                         jnp.int32(r_end))
        s = step(p, engine.rebase_enq(s),
                 torch.tensor(r_end, dtype=torch.int32))
        got = state_to_numpy(s)
        assert sorted(got) == sorted(s_ref)
        for k, v in s_ref.items():
            np.testing.assert_array_equal(got[k], np.asarray(v),
                                          err_msg=f"step {n}: {k}")


def test_state_round_trip_keeps_rdr(waitfor_mid_run):
    """``rdr`` carries the extra dropped-write row on the port's side and
    round-trips through convert unchanged."""
    _, s_np = waitfor_mid_run
    s = state_from_numpy(s_np, "cpu")
    R, words = s_np["rdr"].shape
    assert words == 2 and s["rdr"].shape == (R + 1, 2)
    assert s["rdr"].dtype == torch.int32 and not s["rdr"][R].any()
    back = state_to_numpy(s)
    assert sorted(back) == sorted(s_np)
    for k, v in s_np.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_reader_bits_wrap_like_int32():
    """Slot 31's reader bit is INT32_MIN: the port's words set, clear
    and read it back with the reference's int32 wraparound."""
    slot = np.arange(64, dtype=np.int32) % 32
    bit64 = torch.ones(64, dtype=torch.int64) << torch.as_tensor(slot)
    ref_bit = jnp.int32(1) << jnp.asarray(slot)
    bit, unbit = engine._wrap32(bit64), engine._wrap32(-bit64)
    np.testing.assert_array_equal(bit.numpy(), np.asarray(ref_bit))
    np.testing.assert_array_equal(unbit.numpy(), np.asarray(-ref_bit))
    # slot 31 sets its bit of word 0, slot 0 sets its bit, slot 31
    # clears and sets again; index 1 is the dropped-write row
    idx = [0, 0, 0, 1, 0]
    vals = [31, 0, 31, 31, 31]
    sign = [1, 1, -1, 1, 1]
    word = torch.zeros(2, dtype=torch.int32)
    ref = jnp.zeros(2, jnp.int32)
    for i, v, sg in zip(idx, vals, sign):
        add = (bit if sg > 0 else unbit)[v:v + 1]
        word.index_add_(0, torch.tensor([i]), add)
        ref = ref.at[i].add(ref_bit[v] if sg > 0 else -ref_bit[v])
        np.testing.assert_array_equal(word.numpy(), np.asarray(ref))
    assert int(word[0]) == 1 + engine.I32_MIN
    held = ((word[0] >> torch.arange(32, dtype=torch.int32)) & 1) != 0
    assert held.nonzero().flatten().tolist() == [0, 31]


def _assert_leap_matches_dense(eng_kw, wl_kw):
    res = {leap: _run(eng_kw, wl_kw, event_leap=leap)
           for leap in (True, False)}
    fps = {k: fingerprint(v, include_metrics=True) for k, v in res.items()}
    assert fps[True].pop("steps_executed") <= fps[False].pop("steps_executed")
    assert res[False].raw["steps_executed"] == res[False].raw["rounds_total"]
    assert fps[True] == fps[False]


def test_config_fields_match_reference():
    mine = dataclasses.fields(engine.EngineConfig)
    ref = dataclasses.fields(ref_engine.EngineConfig)
    assert [f.name for f in mine] == [f.name for f in ref]
    for a, b in zip(mine, ref):
        if a.name != "cost":
            assert a.default == b.default, a.name
    assert dataclasses.asdict(engine.DEFAULT_COST_MODEL) == dataclasses.asdict(
        ref_engine.DEFAULT_COST_MODEL)
    assert engine.PROTOCOLS == ref_engine.PROTOCOLS
    for name in ("SLOT_F", "SLOT_COLS", "BATCH_SLOT_F", "BATCH_SLOT_COLS",
                 "C_ARRIVE", "BC_ARRIVE", "NCAT", "EPOCH_BITS"):
        assert getattr(engine, name) == getattr(ref_engine, name), name


BAD_CONFIGS = [
    dict(protocol="nope", n_exec=4),
    dict(protocol="orthrus", n_exec=4),
    dict(protocol="quecc", n_exec=4),
    dict(protocol="scheduled", n_exec=4, state_layout="legacy"),
    dict(protocol="deadlock_free", n_exec=4, state_layout="flat"),
    dict(protocol="deadlock_free", n_exec=4, fragment_exec=True),
    dict(protocol="dgcc", n_exec=4, inter_batch_pipeline=True),
    dict(protocol="dgcc", n_exec=4, fragment_exec=True, state_layout="legacy"),
    dict(protocol="deadlock_free", n_exec=4, n_planner_lanes=1),
    dict(protocol="dgcc", n_exec=4, n_planner_lanes=-1),
    dict(protocol="deadlock_free", n_exec=4, epoch_interval_rounds=-1),
    dict(protocol="dgcc", n_exec=4, n_planner_lanes=1, state_layout="legacy"),
    dict(protocol="partitioned_store", n_exec=4, epoch_interval_rounds=10),
    dict(protocol="deadlock_free", n_exec=4, admission_policy="drop"),
    dict(protocol="deadlock_free", n_exec=4, admission_policy="bounded_backlog",
         backlog_cap=4),
    dict(protocol="deadlock_free", n_exec=4, admission_policy="bounded_backlog",
         epoch_interval_rounds=10),
    dict(protocol="deadlock_free", n_exec=4, admission_policy="token_bucket",
         epoch_interval_rounds=10, token_interval_rounds=2),
    dict(protocol="deadlock_free", n_exec=4, admission_policy="deadline_shed",
         epoch_interval_rounds=10),
    dict(protocol="dgcc", n_exec=4, n_cc=1, fragment_exec=True,
         inter_batch_pipeline=True, admission_policy="deadline_shed",
         epoch_interval_rounds=10, deadline_rounds=5),
    dict(protocol="deadlock_free", n_exec=4, retry_budget=-1),
    dict(protocol="dgcc", n_exec=4, retry_budget=2),
    dict(protocol="quecc", n_exec=4, n_cc=2, backoff_mode="exp"),
    dict(protocol="deadlock_free", n_exec=4, backoff_mode="linear"),
    dict(protocol="deadlock_free", n_exec=4, arrival_pattern="zipf"),
    dict(protocol="deadlock_free", n_exec=4, arrival_pattern="burst",
         burst_period_epochs=4, burst_on_epochs=2),
    dict(protocol="deadlock_free", n_exec=4, arrival_pattern="diurnal",
         epoch_interval_rounds=10),
    dict(protocol="deadlock_free", n_exec=4, arrival_pattern="burst",
         epoch_interval_rounds=10, burst_period_epochs=4, burst_on_epochs=5),
    dict(protocol="deadlock_free", n_exec=4, retry_budget=2,
         state_layout="legacy"),
    dict(protocol="deadlock_free", n_exec=4, rounds_per_dispatch=0),
    dict(protocol="deadlock_free", n_exec=4, release_path="sparse"),
    dict(protocol="deadlock_free", n_exec=4, kernel_impl="triton"),
    dict(protocol="deadlock_free", n_exec=4, kernel_impl="pallas",
         state_layout="legacy"),
    dict(protocol="deadlock_free", n_exec=4, release_path="dense",
         state_layout="legacy"),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=range(len(BAD_CONFIGS)))
def test_config_asserts_mirror_reference(kw):
    with pytest.raises(AssertionError):
        ref_engine.EngineConfig(**kw)
    with pytest.raises(AssertionError):
        engine.EngineConfig(**kw)


GOOD_CONFIGS = [
    dict(protocol="orthrus", n_exec=64, n_cc=16, window=4),
    dict(protocol="deadlock_free", n_exec=80, rounds_per_dispatch=5),
    dict(protocol="twopl_waitfor", n_exec=8, release_path="dense"),
    dict(protocol="quecc", n_exec=6, n_cc=4, fragment_exec=True,
         inter_batch_pipeline=True, n_planner_lanes=2,
         epoch_interval_rounds=20),
    dict(protocol="deadlock_free", n_exec=8, epoch_interval_rounds=150,
         admission_policy="deadline_shed", deadline_rounds=400,
         retry_budget=3, backoff_mode="exp", arrival_pattern="burst",
         burst_period_epochs=4, burst_on_epochs=2),
]


@pytest.mark.parametrize("kw", GOOD_CONFIGS, ids=range(len(GOOD_CONFIGS)))
def test_config_properties_match_reference(kw):
    mine, ref = engine.EngineConfig(**kw), ref_engine.EngineConfig(**kw)
    for prop in ("n_slots", "is_orthrus", "is_batch_planned",
                 "dispatch_rounds", "is_dynamic_2pl", "deadlock_scheme"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.trace_statics()[:-1] == ref.trace_statics()[:-1]
    assert engine.qgrid_interval(mine) == ref_engine.qgrid_interval(ref)


# open arrival and the overload layer, which raised until slice 7's
# item 7 ported them, and K-fused dispatch (item 8): each now runs
# through both packages
FORMERLY_UNPORTED = [
    dict(protocol="dgcc", n_exec=4, n_cc=2, epoch_interval_rounds=50),
    dict(protocol="quecc", n_exec=4, n_cc=2, epoch_interval_rounds=50),
    dict(protocol="scheduled", n_exec=4, epoch_interval_rounds=50),
    dict(protocol="deadlock_free", n_exec=4, epoch_interval_rounds=50),
    dict(protocol="orthrus", n_exec=4, n_cc=2, retry_budget=3),
    dict(protocol="deadlock_free", n_exec=4, backoff_mode="exp"),
    dict(protocol="deadlock_free", n_exec=4, rounds_per_dispatch=2),
]


@pytest.mark.parametrize("kw", FORMERLY_UNPORTED,
                         ids=range(len(FORMERLY_UNPORTED)))
def test_formerly_unported_paths_match_reference(kw):
    wl, ref_wl = _workloads(YCSB)
    got = engine.run_simulation(engine.EngineConfig(**kw, **SIM), wl,
                                device="cpu")
    ref = ref_engine.run_simulation(ref_engine.EngineConfig(**kw, **SIM),
                                    ref_wl)
    assert fingerprint(got, include_metrics=True) == fingerprint(
        ref, include_metrics=True)
    assert got.metrics.summary_row() == ref.metrics.summary_row()


def test_one_plan_per_call():
    """Several plans in one call run as one group: each equals its own
    single-plan run, apart from ``group_cells`` and the wall."""
    cfg = engine.EngineConfig(**DF, **SIM)
    plans = [engine.make_plan(cfg, _workloads(dict(YCSB, seed=seed))[0])
             for seed in (1, 2)]
    both = sweep.simulate_plans(cfg, plans, device="cpu")
    for got, plan in zip(both, plans):
        want = sweep.simulate_plans(cfg, [plan], device="cpu")[0]
        assert (got.raw["group_cells"], want.raw["group_cells"]) == (2, 1)
        assert fingerprint(got, include_metrics=True) == fingerprint(
            want, include_metrics=True)
        skip = ("group_cells", "wall_s_group")
        assert {k: v for k, v in got.raw.items() if k not in skip} == {
            k: v for k, v in want.raw.items() if k not in skip}
    assert fingerprint(both[0]) != fingerprint(both[1])


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    wl, _ = _workloads(YCSB)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.run_simulation(engine.EngineConfig(**DF, **SIM), wl)


def test_sat_mul_saturates_int32():
    a = torch.tensor([0, 3, 1 << 20, 1 << 29], dtype=torch.int32)
    b = torch.tensor([5, 7, 1 << 12, 0], dtype=torch.int32)
    got = engine._sat_mul(a, b)
    want = np.asarray(ref_engine._sat_mul(jnp.asarray(a.numpy()),
                                          jnp.asarray(b.numpy())))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunk_boundaries_match_reference():
    from repro.core import sweep as ref_sweep

    for kw in (dict(max_rounds=1200, warmup_rounds=300, chunk_rounds=300),
               dict(max_rounds=1000, warmup_rounds=250, chunk_rounds=200),
               dict(max_rounds=999, warmup_rounds=0, chunk_rounds=400)):
        cfg = engine.EngineConfig(**DF, **kw)
        ref_cfg = ref_engine.EngineConfig(**DF, **kw)
        assert list(sweep.chunk_boundaries(cfg)) == list(
            ref_sweep.chunk_boundaries(ref_cfg))
    assert sweep.ENGINE_VERSION == ref_sweep.ENGINE_VERSION
