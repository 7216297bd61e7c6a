"""The port's dense replay and Chrome trace export
(``tools/torch_trace_export.py``) against ``tools/trace_export.py``, and
the port's exact per-txn latency oracle, on the CPU.

  * Snapshots round by round, and the final state, equal to the
    reference's replay on a lock-table cell (contended wait-die), an
    overloaded open-arrival cell with the overload layer, and a
    batch-planned cell.
  * ``txn_events`` and ``chrome_trace`` equal to the reference's on the
    same snapshots, and to the reference's output on its own.
  * The latency oracle of ``tests/test_metrics.py``, on the port: exact
    per-txn latencies from slot transitions give ``run_simulation``'s
    ``lat_hist`` and its bucketed p50 / p99 / p999, closed loop (arrival =
    admission round) and under open arrival (arrival = the epoch's).
  * The CLI with ``--device cpu``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import engine, metrics, workloads  # noqa: E402
from tools import torch_trace_export as tte  # noqa: E402
from tools import trace_export as ref_tte  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUNDS = 400
SIM = dict(max_rounds=ROUNDS, warmup_rounds=0, chunk_rounds=ROUNDS,
           target_commits=10**9)
# tests/test_trace_export.py's cells
CELLS = {
    "waitdie_hot": (
        dict(kind="ycsb", num_txns=128, num_records=10_000, num_hot=8,
             seed=0),
        dict(protocol="twopl_waitdie", n_exec=4),
    ),
    "scheduled_hot": (
        dict(kind="ycsb", num_txns=128, num_records=1_000_000, num_hot=8,
             hot_per_txn=1, seed=0),
        dict(protocol="scheduled", n_exec=4),
    ),
    "overload_shed": (
        dict(kind="ycsb", num_txns=256, num_records=10_000, num_hot=8,
             batch_epoch=64, seed=0),
        dict(protocol="twopl_waitdie", n_exec=4,
             epoch_interval_rounds=100,
             admission_policy="deadline_shed", deadline_rounds=200,
             retry_budget=3, backoff_mode="exp",
             backoff_max_rounds=128),
    ),
}


@pytest.fixture(scope="module")
def replays():
    out = {}
    for name, (wl_kw, eng_kw) in CELLS.items():
        cfg = engine.EngineConfig(**eng_kw, **SIM)
        ref_cfg = ref_engine.EngineConfig(**eng_kw, **SIM)
        mine = tte.replay_dense(
            cfg, workloads.make_workload(workloads.WorkloadConfig(**wl_kw)),
            device="cpu")
        ref = ref_tte.replay_dense(
            ref_cfg, ref_workloads.make_workload(
                ref_workloads.WorkloadConfig(**wl_kw)))
        out[name] = (cfg, ref_cfg, mine, ref)
    return out


@pytest.mark.parametrize("name", sorted(CELLS))
def test_snapshots_match_reference(replays, name):
    _cfg, _ref_cfg, (snaps, state), (ref_snaps, ref_state) = replays[name]
    assert len(snaps) == len(ref_snaps) == ROUNDS + 1
    for r, (got, want) in enumerate(zip(snaps, ref_snaps)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"round {r}")
    assert sorted(state) == sorted(ref_state)
    for k, v in ref_state.items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_events_and_trace_match_reference(replays, name):
    cfg, ref_cfg, (snaps, _s), (ref_snaps, _rs) = replays[name]
    events = tte.chrome_trace(snaps, cfg)
    assert events == ref_tte.chrome_trace(ref_snaps, ref_cfg)
    assert events == ref_tte.chrome_trace(snaps, ref_cfg)
    assert len(events) > ROUNDS + 1
    if not cfg.is_batch_planned:
        got = tte.txn_events(snaps)
        assert got == ref_tte.txn_events(ref_snaps)
        assert got and got == ref_tte.txn_events(snaps)


def _oracle_check(cfg, wl, expected_arrival):
    """tests/test_metrics.py's oracle on the port: replay densely,
    extract exact per-txn (arrive, commit) events, and pin the carried
    histogram and the bucketed percentiles against them.
    ``expected_arrival(tid, admit_round)`` computes each txn's arrival
    independently of the engine's C_ARRIVE stamp."""
    res = engine.run_simulation(cfg, wl, device="cpu")
    snaps, _ = tte.replay_dense(cfg, wl, device="cpu")
    events = tte.txn_events(snaps)
    assert len(events) == res.commits > 0

    # first snapshot index where each tid occupies a slot = the round
    # after its admission round
    admit = {}
    for r in range(len(snaps) - 1):
        newly = set(snaps[r + 1][engine.C_TID][
            snaps[r + 1][engine.C_TID] >= 0]) - set(
            snaps[r][engine.C_TID][snaps[r][engine.C_TID] >= 0])
        for tid in newly:
            admit.setdefault(int(tid), r)

    lats = []
    for tid, arrive_stamp, commit_r in events:
        want_arrive = expected_arrival(tid, admit[tid])
        assert arrive_stamp == want_arrive, (tid, arrive_stamp, want_arrive)
        lats.append(commit_r - want_arrive)
    lats = np.asarray(lats)
    assert np.all(lats >= 0)

    hist = np.bincount(metrics.bucket_index(lats),
                       minlength=metrics.LAT_BUCKETS)
    assert hist.tolist() == [int(x) for x in res.metrics.lat_hist]
    edges = metrics.bucket_edges()
    srt = np.sort(lats)
    for q, got in ((0.5, res.metrics.p50), (0.99, res.metrics.p99),
                   (0.999, res.metrics.p999)):
        rank = max(int(np.ceil(q * len(lats))), 1)
        assert got == int(edges[metrics.bucket_index(srt[rank - 1])]), q
    return lats


ORACLE_SIM = dict(max_rounds=1200, warmup_rounds=0, chunk_rounds=300,
                  target_commits=10**9)


def test_latency_oracle_closed_loop():
    """Closed loop: arrival == admission round, observed from slot
    transitions (never from the C_ARRIVE stamp)."""
    wl = workloads.make_workload(workloads.WorkloadConfig(
        kind="ycsb", num_txns=256, num_records=10_000, num_hot=8, seed=0))
    cfg = engine.EngineConfig(protocol="twopl_waitdie", n_exec=8,
                              **ORACLE_SIM)
    _oracle_check(cfg, wl, expected_arrival=lambda tid, admit_r: admit_r)


def test_latency_oracle_open_arrival():
    """Open arrival: arrival == the txn's epoch arrival round
    (tid // epoch_txns * interval), so queueing delay is part of the
    measured latency; on this overloaded cell some txn queues past its
    epoch's arrival."""
    iv, epoch = 150, 64
    wl = workloads.make_workload(workloads.WorkloadConfig(
        kind="ycsb", num_txns=256, num_records=10_000, num_hot=16,
        batch_epoch=epoch, seed=0))
    cfg = engine.EngineConfig(protocol="deadlock_free", n_exec=8,
                              epoch_interval_rounds=iv, **ORACLE_SIM)
    snaps_arrival = {}

    def arrival(tid, admit_r):
        snaps_arrival[tid] = admit_r
        return (tid // epoch) * iv

    _oracle_check(cfg, wl, expected_arrival=arrival)
    assert any(admit_r > (tid // epoch) * iv
               for tid, admit_r in snaps_arrival.items())


def test_main_round_trip(tmp_path, capsys):
    """The CLI writes a loadable trace file whose event population
    matches a direct chrome_trace call, on the CPU."""
    out = tmp_path / "trace.json"
    argv = ["--protocol", "deadlock_free", "--num-txns", "64",
            "--num-hot", "8", "--n-exec", "4", "--rounds", "120",
            "--out", str(out)]
    assert tte.main(argv + ["--device", "cpu"]) == 0
    data = json.loads(out.read_text())
    assert data["displayTimeUnit"] == "ms"
    events = data["traceEvents"]
    assert any(e["ph"] == "X" for e in events)
    assert sum(e["ph"] == "C" for e in events) == 121
    msg = capsys.readouterr().out
    assert str(out) in msg and "commits" in msg
    ref_out = tmp_path / "ref.json"
    assert ref_tte.main(argv[:-1] + [str(ref_out)]) == 0
    assert json.loads(ref_out.read_text()) == data
    assert capsys.readouterr().out.split(":", 1)[1] == msg.split(":", 1)[1]


def test_default_device_is_cuda():
    """Without --device the CLI asks for a card (and says so without one)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tte.main(["--rounds", "4", "--out", "unused.json"])
