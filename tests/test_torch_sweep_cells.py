"""The multi-cell sweep of the PyTorch port against the JAX reference, on
the CPU.

``repro_torch.core.sweep.run_cells`` groups cells by the reference's key
and drives each group's cells together (on the CPU each replay runs
every cell's guarded dispatch eagerly; on a card it is one CUDA graph
with a branch per cell). Held here:

  * **Every protocol, every mode**: the nine protocols at
    ``tests/test_engine_leap.py``'s ``EXIT_SIM`` on hot sets 4, 64 and
    1,024 (cells that stop at different boundaries), under
    ``SERIAL_MODE`` and the reference's three other modes
    (``tests/test_engine_leap.py:351-357``): each cell's fingerprint,
    metrics and ``raw`` counters (``group_cells`` included,
    ``wall_s_group`` aside) equal ``repro.core.sweep.run_cells``'s in
    the same mode and the port's per-cell ``run_simulation``. For
    their time, deadlock_free and orthrus are in
    ``tests/test_torch_sweep_planned.py`` and the dynamic-2PL schemes in
    ``tests/test_torch_sweep_{waitdie,waitfor,dreadlocks}.py``, with
    :func:`check_protocol_mode`; the goldens and several groups in one
    call in ``tests/test_torch_sweep_goldens.py``.
  * A fragment-mode quecc group, an overload group whose cells differ
    only in traced values, a K = 4 group, ``simulate_plans`` over
    several plans.
  * A frozen cell (bound 0) comes out of every later dispatch
    array-for-array unchanged, the other cells advancing.
  * ``sweep_mode()``'s three environment variables.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from golden.regenerate import fingerprint  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import sweep as ref_sweep  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import engine, sweep, workloads  # noqa: E402
from repro_torch.core.convert import plan_from_numpy  # noqa: E402

# tests/test_engine_leap.py's EXIT_SIM: a finite commit target and small
# chunks, so the cells of a group stop at different boundaries
EXIT_SIM = dict(max_rounds=2000, warmup_rounds=500, chunk_rounds=250,
                target_commits=60)
HOTS = (4, 64, 1024)
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
# SERIAL_MODE and tests/test_engine_leap.py:351-357's three modes, as
# (devices, pipeline, early_exit); four devices clamp to the one there is
MODES = {
    "serial": (1, 0, False),
    "exit": (1, 0, True),
    "pipelined": (1, 2, True),
    "devices4": (4, 1, True),
}
YCSB_EXIT = dict(kind="ycsb", num_txns=256, num_records=10_000, seed=3)
# tests/test_engine_leap.py's fragment cell (its FRAG_SIM and
# multi-partition YCSB: quecc's fragment schedule depends only on the
# partitions, so the two hot sets share plan shapes)
FRAG_SIM = dict(max_rounds=2500, warmup_rounds=500, chunk_rounds=500,
                target_commits=10**9)
YCSB_FRAG = dict(kind="ycsb", num_txns=256, num_records=10_000,
                 multipart_frac=1.0, num_partitions=8, batch_epoch=64, seed=0)
# tests/test_overload.py's SIM and OVERLOAD_WL
OVERLOAD_SIM = dict(max_rounds=1200, warmup_rounds=300, chunk_rounds=300,
                    target_commits=10**9)
OVERLOAD_WL = dict(kind="ycsb", num_txns=512, num_records=10_000,
                   batch_epoch=64, seed=0)
# the host loop's own cases: half EXIT_SIM's depth
SHORT_SIM = dict(max_rounds=1000, warmup_rounds=250, chunk_rounds=250,
                 target_commits=30)

@functools.lru_cache(maxsize=None)
def _wl_items(items):
    kw = dict(items)
    return (workloads.make_workload(workloads.WorkloadConfig(**kw)),
            ref_workloads.make_workload(ref_workloads.WorkloadConfig(**kw)))


def _wl(**kw):
    return _wl_items(tuple(sorted(kw.items())))


def _raw(res):
    return {k: v for k, v in res.raw.items() if k != "wall_s_group"}


def assert_same(got, want, what="", group_cells=True):
    """Fingerprint, metrics and every ``raw`` counter but the wall (and
    ``group_cells`` where ``want`` ran alone)."""
    assert fingerprint(got, include_metrics=True) == fingerprint(
        want, include_metrics=True), what
    assert got.metrics.summary_row() == want.metrics.summary_row(), what
    skip = set() if group_cells else {"group_cells"}
    assert {k: v for k, v in _raw(got).items() if k not in skip} == {
        k: v for k, v in _raw(want).items() if k not in skip}, what


def run_both(cells, mode):
    """``cells`` as (engine kwargs, workload kwargs) through the port's
    and the reference's ``run_cells`` in ``mode`` (a MODES tuple)."""
    port = [(engine.EngineConfig(**e), _wl(**w)[0]) for e, w in cells]
    ref = [(ref_engine.EngineConfig(**e), _wl(**w)[1]) for e, w in cells]
    got = sweep.run_cells(port, mode=sweep.SweepMode(*mode), device="cpu")
    want = ref_sweep.run_cells(ref, mode=ref_sweep.SweepMode(*mode))
    return got, want


@functools.lru_cache(maxsize=None)
def _singles(protocol):
    eng = dict(protocol=protocol, **PROTO_KW[protocol], **EXIT_SIM)
    return [engine.run_simulation(engine.EngineConfig(**eng),
                                  _wl(**YCSB_EXIT, num_hot=h)[0],
                                  device="cpu") for h in HOTS]


def check_protocol_mode(protocol, mode_name):
    """The three hot sets of ``protocol`` as one group in ``mode_name``:
    the reference's ``run_cells`` in that mode and the port's per-cell
    ``run_simulation``, cell for cell."""
    eng = dict(protocol=protocol, **PROTO_KW[protocol], **EXIT_SIM)
    cells = [(eng, dict(YCSB_EXIT, num_hot=h)) for h in HOTS]
    got, want = run_both(cells, MODES[mode_name])
    for h, g, w, s in zip(HOTS, got, want, _singles(protocol)):
        assert_same(g, w, (protocol, mode_name, h))
        assert_same(g, s, (protocol, mode_name, h, "single"),
                    group_cells=False)
    return got


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode_name", sorted(MODES))
@pytest.mark.parametrize("protocol", ["dgcc", "quecc", "scheduled",
                                      "partitioned_store"])
def test_run_cells_matches_reference(protocol, mode_name):
    got = check_protocol_mode(protocol, mode_name)
    if protocol == "dgcc":
        # the cells meet the commit target at different boundaries
        assert len({r.raw["rounds_total"] for r in got}) == 2


@pytest.mark.parametrize("mode_name", ["serial", "pipelined"])
def test_fragment_quecc_group(mode_name):
    eng = dict(protocol="quecc", fragment_exec=True, **PROTO_KW["quecc"],
               **FRAG_SIM)
    got, want = run_both([(eng, dict(YCSB_FRAG, num_hot=h))
                          for h in (8, 64)], MODES[mode_name])
    assert [r.raw["group_cells"] for r in got] == [2, 2]
    for g, w in zip(got, want):
        assert_same(g, w)


def test_overload_group_of_traced_values():
    """Cells that differ only in traced values (the epoch interval, the
    backlog cap, the workload's contents) share one group."""
    base = dict(protocol="deadlock_free", n_exec=8,
                admission_policy="bounded_backlog", **OVERLOAD_SIM)
    cells = [
        (dict(base, epoch_interval_rounds=150, backlog_cap=100),
         dict(OVERLOAD_WL, num_hot=8)),
        (dict(base, epoch_interval_rounds=60, backlog_cap=32),
         dict(OVERLOAD_WL, num_hot=8)),
        (dict(base, epoch_interval_rounds=150, backlog_cap=100),
         dict(OVERLOAD_WL, num_hot=64)),
    ]
    got, want = run_both(cells, MODES["pipelined"])
    assert [r.raw["group_cells"] for r in got] == [3, 3, 3]
    for g, w in zip(got, want):
        assert_same(g, w)
    assert got[0].raw["pol_rejected"] != got[1].raw["pol_rejected"]


def test_simulate_plans_several_plans_k4():
    """A group of two plans at K = 4 (the whole dispatch guarded, the
    inner steps too) equals each plan's own run."""
    eng = dict(protocol="orthrus", **PROTO_KW["orthrus"],
               rounds_per_dispatch=4, **SHORT_SIM)
    cfg = engine.EngineConfig(**eng)
    plans = [engine.make_plan(cfg, _wl(**YCSB_EXIT, num_hot=h)[0])
             for h in (4, 64)]
    sink = {}
    got = sweep.simulate_plans(cfg, plans, device="cpu",
                               mode=sweep.SweepMode(1, 1, True),
                               time_sink=sink)
    assert sink["group_cells"] == 2 and sink["wall_s"] > 0
    for g, plan in zip(got, plans):
        assert g.raw["group_cells"] == 2
        want = sweep.simulate_plans(cfg, [plan], device="cpu")[0]
        assert want.raw["group_cells"] == 1
        assert_same(g, want, group_cells=False)


def _group_states(protocol, k, hots=(4, 64, 1024)):
    eng = dict(protocol=protocol, **PROTO_KW[protocol],
               rounds_per_dispatch=k, **EXIT_SIM)
    cfg = engine.EngineConfig(**eng)
    plans = [engine.make_plan(cfg, _wl(**YCSB_EXIT, num_hot=h)[0])
             for h in hots]
    meta = engine.plan_meta(cfg, plans[0])
    ps = [plan_from_numpy(engine.plan_device(cfg, pl), "cpu")
          for pl in plans]
    states = [sweep._initial_state(cfg, pl, meta, "cpu") for pl in plans]
    return sweep.GroupRunner(cfg, meta, "cpu", len(hots)), ps, states


def _replay_until(runner, bounds):
    runner.set_bounds(np.asarray(bounds, np.int32))
    while True:
        r = runner.replay().get()
        if (r >= bounds).all():
            return r


@pytest.mark.parametrize("protocol,k", [("orthrus", 1), ("twopl_waitfor", 4),
                                        ("dgcc", 1), ("quecc", 4)])
def test_frozen_cell_is_unchanged(protocol, k):
    """Run a group to round 150, freeze cell 1 (bound 0) and give the
    others a far bound: every later replay leaves cell 1's state
    array-for-array as it was, while the others advance; then the frozen
    cell resumes as if it had never stopped (its run to 300 equals a
    group run that never froze it)."""
    runner, ps, states = _group_states(protocol, k)
    runner.load(ps, states)
    _replay_until(runner, [150, 150, 150])
    frozen = {key: v.clone() for key, v in runner.cells.state[1].items()}
    runner.set_bounds(np.asarray([300, 0, 300], np.int32))
    for _ in range(8):
        runner.replay().get()
        now = runner.cells.state[1]
        assert now.keys() == frozen.keys()
        for key, v in frozen.items():
            assert torch.equal(now[key], v), key
    assert (runner.replay().get() > [150, 150, 150]).tolist() == [
        True, False, True]
    _replay_until(runner, [300, 300, 300])
    resumed = {key: v.clone() for key, v in runner.cells.state[1].items()}

    straight, ps2, states2 = _group_states(protocol, k)
    straight.load(ps2, states2)
    _replay_until(straight, [150, 150, 150])
    _replay_until(straight, [300, 300, 300])
    for key, v in resumed.items():
        assert torch.equal(straight.cells.state[1][key], v), key


ENV = ("REPRO_SWEEP_DEVICES", "REPRO_SWEEP_PIPELINE",
       "REPRO_SWEEP_EARLY_EXIT")


@pytest.mark.parametrize("env", [
    {},
    {"REPRO_SWEEP_DEVICES": "auto"},
    {"REPRO_SWEEP_DEVICES": "0", "REPRO_SWEEP_PIPELINE": "0"},
    {"REPRO_SWEEP_DEVICES": " ", "REPRO_SWEEP_EARLY_EXIT": "off"},
    {"REPRO_SWEEP_DEVICES": "3", "REPRO_SWEEP_PIPELINE": "4",
     "REPRO_SWEEP_EARLY_EXIT": "FALSE"},
    {"REPRO_SWEEP_DEVICES": "-2", "REPRO_SWEEP_PIPELINE": "-1",
     "REPRO_SWEEP_EARLY_EXIT": "0"},
    {"REPRO_SWEEP_EARLY_EXIT": "yes"},
], ids=range(7))
def test_sweep_mode_environment(monkeypatch, env):
    """The reference's parsing; "auto", "0" or unset devices = every
    CUDA card (one on the CPU, as the reference's one local device)."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for name, v in env.items():
        monkeypatch.setenv(name, v)
    got = sweep.sweep_mode()
    want = ref_sweep.sweep_mode()
    auto = env.get("REPRO_SWEEP_DEVICES", "auto").strip() in ("", "auto",
                                                              "0")
    assert got.devices == (max(1, torch.cuda.device_count()) if auto
                           else want.devices)
    assert (got.pipeline, got.early_exit) == (want.pipeline, want.early_exit)
    assert sweep.SERIAL_MODE == sweep.SweepMode(devices=1, pipeline=0,
                                                early_exit=False)
    assert sweep.SweepMode() == sweep.SweepMode(1, 1, True)
