"""Each per-layer reader on a hand-made trace with known values, and a
reader that finds nothing to read returns nothing."""

import types

import pytest

from simbench import spec, yardstick
from simbench.trace import Trace

MS = 1_000_000  # ns


def reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py",
                            f"simbench_metric_{name}")


def result(steps, rounds):
    return types.SimpleNamespace(raw={"steps_executed": steps,
                                      "rounds_total": rounds})


@pytest.fixture
def ctx():
    # a 10 ms window; device busy 0-2 ms (B1, then an elementwise kernel
    # overlapping it), 4-5 ms (a copy) and 6-7 ms (B1): 4 ms busy
    b1 = "void lock_grant_step_kernel(int const*, int const*)"
    dev = [(b1, 0, 1 * MS), ("elementwise", MS // 2, 2 * MS),
           ("Memcpy HtoD (Pageable -> Device)", 4 * MS, 5 * MS),
           (b1, 6 * MS, 7 * MS)]
    host = [("simbench.simulate_plans", 0, 10 * MS),
            ("aten::item", 2 * MS, 4 * MS)]
    return dict(results=[result(steps=4, rounds=8)], steps=4,
                spans={"plan_s": [0.002, 0.004]},
                trace=Trace((0, 10 * MS), dev, host),
                shapes=dict(protocol="orthrus", n_slots=256, max_keys=10,
                            pred_width=3))


def test_readers_on_a_known_trace(ctx):
    assert reader("plan_ms").read(ctx) == pytest.approx(3.0)
    assert reader("steps_per_round").read(ctx) == 0.5
    assert reader("host_ms_per_step").read(ctx) == pytest.approx(1.5)
    assert reader("step_kernels").read(ctx) == 0.75
    assert reader("step_device_ms").read(ctx) == pytest.approx(1.125)
    assert reader("device_idle_share").read(ctx) == pytest.approx(60.0)
    least = 256 * 10 * 14 / yardstick.HBM_BYTES_PER_S
    assert reader("b1_roofline").read(ctx) == pytest.approx(
        100 * least / 1e-3)
    assert reader("b2_roofline").read(ctx) is None


def test_trace_breakdown(ctx):
    tr = ctx["trace"]
    assert tr.busy_s() == pytest.approx(0.004)
    ops = dict(tr.device_ops())
    assert ops["void lock_grant_step_kernel(int const*, int const*)"] == \
        pytest.approx(0.002)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["simbench.simulate_plans", pytest.approx(0.003)]
    assert ["aten::item", pytest.approx(0.002)] in gaps
    assert len(gaps) == 3


def test_only_what_started_in_the_window_counts():
    # the window [0, 10) ms; a kernel that starts at 12 ms is not in it,
    # one that runs past its end counts up to the end
    dev = [("k", 2 * MS, 3 * MS), ("k", 9 * MS, 11 * MS),
           ("k", 12 * MS, 13 * MS)]
    tr = Trace((0, 10 * MS), dev, [])
    assert len(tr.kernels()) == 2
    assert tr.busy_s() == pytest.approx(0.002)
    assert tr.busy_intervals() is tr.busy_intervals()


def test_readers_without_a_device_trace(ctx):
    ctx["trace"] = Trace((0, 10 * MS), [], [])
    for name in ("host_ms_per_step", "step_kernels", "step_device_ms",
                 "device_idle_share", "b1_roofline",
                 "b2_roofline"):
        assert reader(name).read(ctx) is None


@pytest.mark.parametrize("name", ["orthrus-80c.ycsb-hot64",
                                  "dgcc-80c.ycsb-hot64"])
def test_a_traced_run_on_the_cpu(name, fresh_runners):
    # the CPU has no device activity: only the host's readers report
    import time

    from simbench import harness
    from simbench.tests.conftest import tiny

    out = harness.run_cell(tiny(name), 5, 0.0, True, "cpu",
                           time.perf_counter())
    assert out["correct"] and out["attempted"] == 1
    assert set(out["metrics"]) == {"plan_ms", "steps_per_round"}
    assert 0 < out["metrics"]["steps_per_round"]["value"] <= 1
    assert out["device"]["busy_s"] == 0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
