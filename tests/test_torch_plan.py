"""The port's host plan layer against the JAX reference: workloads, plans
and plan arrays array-equal; the copied cost model and metrics doctests."""

import dataclasses
import doctest

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from golden.regenerate import CELLS, SIM  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import cost_model, metrics  # noqa: E402
from repro_torch.core import engine, workloads  # noqa: E402
from repro_torch.core.convert import plan_from_numpy  # noqa: E402

LOCK_TABLE = ("orthrus", "deadlock_free", "twopl_waitdie", "twopl_waitfor",
              "twopl_dreadlocks", "partitioned_store")
LOCK_TABLE_CELLS = sorted(
    name for name, (_wl, eng) in CELLS.items()
    if eng["protocol"] in LOCK_TABLE
)


def _assert_same_fields(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


def test_cells_cover_both_ported_protocols():
    """Every lock-table protocol, the partitioned store's H-Store lane
    streams (``plan_device``'s ``lane_stream``) included."""
    assert {CELLS[n][1]["protocol"] for n in LOCK_TABLE_CELLS} == set(
        LOCK_TABLE)


@pytest.mark.parametrize("name", LOCK_TABLE_CELLS)
def test_workload_plan_and_plan_arrays_match_reference(name):
    wl_kw, eng_kw = CELLS[name]
    wl = workloads.make_workload(workloads.WorkloadConfig(**wl_kw))
    ref_wl = ref_workloads.make_workload(ref_workloads.WorkloadConfig(**wl_kw))
    _assert_same_fields(wl, ref_wl)

    cfg = engine.EngineConfig(**eng_kw, **SIM)
    ref_cfg = ref_engine.EngineConfig(**eng_kw, **SIM)
    plan = engine.make_plan(cfg, wl)
    ref_plan = ref_engine.make_plan(ref_cfg, ref_wl)
    _assert_same_fields(plan, ref_plan)
    assert dataclasses.astuple(engine.plan_meta(cfg, plan)) == (
        dataclasses.astuple(ref_engine.plan_meta(ref_cfg, ref_plan)))

    p = engine.plan_device(cfg, plan)
    ref_p = ref_engine.plan_device(ref_cfg, ref_plan)
    assert sorted(p) == sorted(ref_p)
    on_device = plan_from_numpy(p, "cpu")
    for k, v in ref_p.items():
        t = on_device[k]
        assert t.dtype == (torch.bool if v.dtype == np.bool_ else torch.int32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(v), err_msg=k)


BATCH_CELLS = sorted(
    name for name, (_wl, eng) in CELLS.items()
    if eng["protocol"] in ("dgcc", "quecc", "scheduled")
)


def test_batch_cells_cover_the_batch_engine():
    kw = [CELLS[n][1] for n in BATCH_CELLS]
    assert {e["protocol"] for e in kw} == {"dgcc", "quecc", "scheduled"}
    assert any(e.get("inter_batch_pipeline") for e in kw)
    assert any(e.get("n_planner_lanes") for e in kw)


# open-arrival batch cells of tests/test_overload.py: the bounded
# backlog in epochs and the bursty schedule's period
MP_WL = dict(kind="ycsb", num_txns=256, num_records=10_000, num_hot=8,
             multipart_frac=1.0, num_partitions=8, batch_epoch=64, seed=0)
BATCH_ENG = dict(protocol="dgcc", n_cc=2, n_exec=6, window=2,
                 fragment_exec=True, epoch_interval_rounds=30)
OPEN_BATCH_CELLS = {
    "batch_bb": (MP_WL, dict(BATCH_ENG, admission_policy="bounded_backlog",
                             backlog_cap=128)),
    "batch_burst": (MP_WL, dict(BATCH_ENG, arrival_pattern="burst",
                                burst_period_epochs=4, burst_on_epochs=1)),
    "batch_tb": (MP_WL, dict(BATCH_ENG, admission_policy="token_bucket",
                             token_interval_rounds=20, token_burst=32)),
}
ALL_BATCH_CELLS = {**{n: CELLS[n] for n in BATCH_CELLS}, **OPEN_BATCH_CELLS}


def test_open_batch_cells_cover_open_arrival():
    kw = [e for _w, e in ALL_BATCH_CELLS.values()]
    assert any(e.get("epoch_interval_rounds") and e.get("n_planner_lanes")
               for e in kw)
    assert {e.get("admission_policy") for e in kw} >= {
        "bounded_backlog", "token_bucket"}
    assert any(e.get("arrival_pattern") == "burst" for e in kw)


@pytest.mark.parametrize("name", sorted(ALL_BATCH_CELLS))
def test_batch_plan_arrays_match_reference(name):
    """plan_meta and every plan_device array of the batch engine,
    planning latencies, planner-lane work and the open-arrival and
    policy keys included."""
    wl_kw, eng_kw = ALL_BATCH_CELLS[name]
    cfg = engine.EngineConfig(**eng_kw, **SIM)
    ref_cfg = ref_engine.EngineConfig(**eng_kw, **SIM)
    plan = engine.make_plan(
        cfg, workloads.make_workload(workloads.WorkloadConfig(**wl_kw)))
    ref_plan = ref_engine.make_plan(
        ref_cfg,
        ref_workloads.make_workload(ref_workloads.WorkloadConfig(**wl_kw)))
    assert dataclasses.astuple(engine.plan_meta(cfg, plan)) == (
        dataclasses.astuple(ref_engine.plan_meta(ref_cfg, ref_plan)))
    p = engine.plan_device(cfg, plan)
    ref_p = ref_engine.plan_device(ref_cfg, ref_plan)
    assert sorted(p) == sorted(ref_p)
    for k, v in ref_p.items():
        assert p[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(p[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("protocol", ["dgcc", "quecc", "scheduled",
                                      "twopl_waitdie", "partitioned_store"])
def test_other_protocols_plan_like_reference(protocol):
    """make_plan is numpy for every protocol; the batch planners come
    along for the next slice and already agree."""
    wl_kw = dict(kind="ycsb", num_txns=128, num_records=5000, num_hot=8,
                 batch_epoch=32, seed=3)
    kw = dict(protocol=protocol, n_exec=4, n_cc=2)
    plan = engine.make_plan(engine.EngineConfig(**kw), workloads.make_workload(
        workloads.WorkloadConfig(**wl_kw)))
    ref_plan = ref_engine.make_plan(
        ref_engine.EngineConfig(**kw),
        ref_workloads.make_workload(ref_workloads.WorkloadConfig(**wl_kw)))
    for f in ("keys", "modes", "part", "nkeys", "exec_ops", "num_records",
              "epoch_txns"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(ref_plan, f))
    if ref_plan.sched is not None:
        for f in dataclasses.fields(ref_plan.sched):
            a = getattr(plan.sched, f.name)
            b = getattr(ref_plan.sched, f.name)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f.name)


@pytest.mark.parametrize("module", [cost_model, metrics],
                         ids=["cost_model", "metrics"])
def test_copied_doctests(module):
    res = doctest.testmod(module, verbose=False)
    assert res.attempted > 0 and res.failed == 0
