"""Whole-run differential: the port's ``run_simulation`` reports exactly
what ``repro.core.engine.run_simulation`` reports, metrics included."""

import functools

import pytest

torch = pytest.importorskip("torch")

from golden.regenerate import fingerprint  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import engine, workloads  # noqa: E402

WORKLOADS = {
    "ycsb_hot": dict(kind="ycsb", num_txns=256, num_records=10_000,
                     num_hot=8, seed=5),
    "tpcc_ollp": dict(kind="tpcc", num_txns=256, num_warehouses=4,
                      ollp_miss_prob=0.5, seed=6),
}
CELLS = {
    "orthrus_2_6_2": dict(protocol="orthrus", n_cc=2, n_exec=6, window=2),
    "orthrus_4_12_4": dict(protocol="orthrus", n_cc=4, n_exec=12, window=4),
    "df_8": dict(protocol="deadlock_free", n_exec=8),
    "df_16": dict(protocol="deadlock_free", n_exec=16),
    # the paper's dynamic-2PL baselines and the partitioned store
    "waitdie_8": dict(protocol="twopl_waitdie", n_exec=8),
    "waitfor_8": dict(protocol="twopl_waitfor", n_exec=8),
    "waitfor_16": dict(protocol="twopl_waitfor", n_exec=16),
    "dreadlocks_8": dict(protocol="twopl_dreadlocks", n_exec=8),
    "pstore_8": dict(protocol="partitioned_store", n_exec=8),
    # SPLIT variants (thread-local indexes, no shared-index penalty) and
    # two outstanding txns per lane on the single-request protocols
    "orthrus_split": dict(protocol="orthrus", n_cc=2, n_exec=6, window=2,
                          split_index=True),
    "df_split_8": dict(protocol="deadlock_free", n_exec=8, split_index=True),
    "df_8_w2": dict(protocol="deadlock_free", n_exec=8, window=2),
    "waitdie_8_w2": dict(protocol="twopl_waitdie", n_exec=8, window=2),
    "dreadlocks_8_w2": dict(protocol="twopl_dreadlocks", n_exec=8, window=2),
}
# Fig 1's path: read-only YCSB under wait-die. Every grant sets a reader
# bit and every release clears one; 40 slots span two bitmask words and
# use bit 31 (the int32 sign bit) of the first
YCSB_READ_ONLY = dict(WORKLOADS["ycsb_hot"], read_only=True)
# warmup off the chunk grid: the host loop splits the chunk at warmup
SIM = dict(max_rounds=900, warmup_rounds=250, chunk_rounds=200,
           target_commits=10**9)

# batch-planned cells: 96 txns in 16-txn batches, so the runs roll over
# several batches (the per-step differentials also wrap the workload)
YCSB_B = dict(WORKLOADS["ycsb_hot"], num_txns=96, batch_epoch=16)
YCSB_MP = dict(kind="ycsb", num_txns=96, num_records=10_000, num_hot=8,
               multipart_frac=1.0, num_partitions=8, batch_epoch=16, seed=7)
TPCC_B = dict(WORKLOADS["tpcc_ollp"], num_txns=96, batch_epoch=16)
BATCH_CELLS = {
    "dgcc_2_6_2": (YCSB_B, dict(protocol="dgcc", n_cc=2, n_exec=6, window=2)),
    "dgcc_tpcc": (TPCC_B, dict(protocol="dgcc", n_cc=2, n_exec=6, window=2)),
    "quecc_4_6_2": (YCSB_B, dict(protocol="quecc", n_cc=4, n_exec=6,
                                 window=2)),
    "scheduled_8": (YCSB_B, dict(protocol="scheduled", n_exec=8)),
    "dgcc_frag": (YCSB_MP, dict(protocol="dgcc", n_cc=2, n_exec=6, window=2,
                                fragment_exec=True)),
    "quecc_frag_pipe": (YCSB_MP, dict(protocol="quecc", n_cc=4, n_exec=6,
                                      window=2, fragment_exec=True,
                                      inter_batch_pipeline=True)),
    # the planner-lane model, closed loop
    "dgcc_planner_l1": (YCSB_B, dict(protocol="dgcc", n_cc=2, n_exec=6,
                                     window=2, n_planner_lanes=1)),
    "scheduled_planner_l2": (YCSB_B, dict(protocol="scheduled", n_exec=8,
                                          n_planner_lanes=2)),
    "quecc_frag_pipe_planner_l2": (
        YCSB_MP, dict(protocol="quecc", n_cc=4, n_exec=6, window=2,
                      fragment_exec=True, inter_batch_pipeline=True,
                      n_planner_lanes=2)),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(kw):
    return tuple(sorted(kw.items()))


@functools.cache
def _workload_pair(wl_key):
    """The (port, reference) workloads of a config, made once for this
    module."""
    wl_kw = dict(wl_key)
    return (workloads.make_workload(workloads.WorkloadConfig(**wl_kw)),
            ref_workloads.make_workload(
                ref_workloads.WorkloadConfig(**wl_kw)))


@functools.cache
def _ref_run(eng_key, wl_key):
    """One reference run, memoized across this module's tests (a batch
    cell's serves both of its kernel_impl cases; no test changes a
    returned result)."""
    return ref_engine.run_simulation(ref_engine.EngineConfig(**dict(eng_key)),
                                     _workload_pair(wl_key)[1])


def _both(eng_kw, wl_kw, sim, impl="auto"):
    ref = _ref_run(_key(dict(eng_kw, **sim)), _key(wl_kw))
    got = engine.run_simulation(
        engine.EngineConfig(**eng_kw, **sim, kernel_impl=impl),
        _workload_pair(_key(wl_kw))[0], device="cpu",
    )
    return got, ref


@pytest.mark.parametrize("wl", sorted(WORKLOADS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fingerprint_matches_reference(cell, wl):
    got, ref = _both(CELLS[cell], WORKLOADS[wl], SIM)
    assert fingerprint(got, include_metrics=True) == fingerprint(
        ref, include_metrics=True)
    assert got.raw["steps_executed"] == ref.raw["steps_executed"]
    assert got.metrics.breakdown_ext == ref.metrics.breakdown_ext
    assert got.metrics.summary_row() == ref.metrics.summary_row()


def test_read_only_fingerprint_matches_reference():
    got, ref = _both(dict(protocol="twopl_waitdie", n_exec=40),
                     YCSB_READ_ONLY, SIM)
    assert fingerprint(got, include_metrics=True) == fingerprint(
        ref, include_metrics=True)
    assert got.raw["steps_executed"] == ref.raw["steps_executed"]
    assert got.commits > 0 and got.aborts_deadlock == 0


@pytest.mark.parametrize("cell", ["orthrus_2_6_2", "df_8"])
def test_target_commits_stop_matches_reference(cell):
    """The run stops at the first chunk boundary whose measured commits
    reach the target, in both packages."""
    sim = dict(SIM, target_commits=8, chunk_rounds=100)
    got, ref = _both(CELLS[cell], WORKLOADS["ycsb_hot"], sim)
    assert got.raw["rounds_total"] < sim["max_rounds"]
    assert fingerprint(got, include_metrics=True) == fingerprint(
        ref, include_metrics=True)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("cell", sorted(BATCH_CELLS))
def test_batch_fingerprint_matches_reference(cell, impl):
    """Every reported integer of a batch-planned run, the optional
    counters of ``raw`` (pipelined admission, planner lanes) and the
    metrics included, on the plain path and through the kernel's wrapper
    (its plain version on CPU tensors)."""
    wl_kw, eng_kw = BATCH_CELLS[cell]
    got, ref = _both(eng_kw, wl_kw, SIM, impl)
    assert fingerprint(got, include_metrics=True) == fingerprint(
        ref, include_metrics=True)
    skip = {"wall_s_group"}
    assert {k: v for k, v in got.raw.items() if k not in skip} == {
        k: v for k, v in ref.raw.items() if k not in skip}
    assert got.metrics.breakdown_ext == ref.metrics.breakdown_ext
    assert got.metrics.summary_row() == ref.metrics.summary_row()
    assert got.raw["next_txn"] > wl_kw["batch_epoch"]  # batches rolled over


def test_batch_target_commits_stop_matches_reference():
    sim = dict(SIM, target_commits=8, chunk_rounds=100)
    wl_kw, eng_kw = BATCH_CELLS["quecc_frag_pipe"]
    got, ref = _both(eng_kw, wl_kw, sim)
    assert got.raw["rounds_total"] < sim["max_rounds"]
    assert fingerprint(got, include_metrics=True) == fingerprint(
        ref, include_metrics=True)
