"""The comparison that decides ``correct`` fails what it has to fail: the
control (the reference with isolation broken) at a size a test holds,
and a whole run of each cell, past the harness's look for a card, with
the timed path broken underneath. The cells run on one card, so there
is no exchange between cards to leave out."""

import dataclasses
import time

import pytest

from simbench import check, control, harness
from simbench.tests.conftest import CELLS, tiny


def run(cell, seed=3):
    return harness.run_cell(cell, seed, 0.0, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_comparison(name):
    cell = tiny(name)
    compared = control.control(cell, harness.make_inputs(cell, 11), "cpu")
    assert not check.within(compared)
    assert compared["calls_differing"][0] == 1


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, fresh_runners):
    out = run(tiny(name))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) == {"sim_rounds_per_s", "setup_s"}


def _unchanged_state(engine, monkeypatch):
    """Every step returns its state unchanged but for the round."""

    def frozen(build):
        def make(*a, **k):
            build(*a, **k)

            def step(p, s, r_end):
                out = dict(s)
                out["r"] = s["r"] + 1
                return out
            return step
        return make

    monkeypatch.setattr(engine, "make_step", frozen(engine.make_step))
    monkeypatch.setattr(engine, "make_batch_step",
                        frozen(engine.make_batch_step))


def _half_batch(engine, monkeypatch):
    """The planner sees the first half of the transactions only."""
    make_plan = engine.make_plan

    def half(cfg, wl):
        n = wl.keys.shape[0] // 2
        cut = {f: getattr(wl, f)[:n] for f in (
            "keys", "modes", "nkeys", "part", "exec_ops", "ollp",
            "ollp_miss")}
        return make_plan(cfg, dataclasses.replace(wl, **cut))

    monkeypatch.setattr(engine, "make_plan", half)


def _altered_answer(engine, monkeypatch):
    """Each result reports one commit more than it simulated."""
    from repro_torch.core import sweep

    result = sweep._result

    def altered(*a, **k):
        res = result(*a, **k)
        res.commits += 1
        return res

    monkeypatch.setattr(sweep, "_result", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch,
                                    fresh_runners):
    from repro_torch.core import engine

    fault(engine, monkeypatch)
    out = run(tiny(name))
    assert out["correct"] is False
    assert out["failed"] == out["attempted"]
