"""Golden-trace conformance of the PyTorch port: the ported cells of
``tests/golden`` replay bit-exactly on the CPU."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from golden.regenerate import CELLS, GOLDEN_DIR, METRICS_CELLS, fingerprint  # noqa: E402

from repro_torch.core import engine  # noqa: E402
from repro_torch.core.workloads import WorkloadConfig, make_workload  # noqa: E402


def _slice_of(eng_kw: dict) -> int | None:
    """The port slice that brings a cell, or None when it is ported."""
    cfg = engine.EngineConfig(**eng_kw)
    try:
        engine.check_ported(cfg)
    except NotImplementedError as exc:
        return int(str(exc).rsplit("slice ", 1)[1].rstrip(")"))
    return None


@pytest.mark.parametrize("name", sorted(CELLS))
def test_golden_trace_on_port(name):
    wl_kw, eng_kw = CELLS[name]
    pending = _slice_of(eng_kw)
    if pending is not None:
        pytest.skip(f"not yet ported (slice {pending})")
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    assert golden["workload"] == wl_kw and golden["engine"] == eng_kw
    cfg = engine.EngineConfig(**eng_kw, **golden["sim"])
    res = engine.run_simulation(cfg, make_workload(WorkloadConfig(**wl_kw)),
                                device="cpu")
    assert fingerprint(res, include_metrics=name in METRICS_CELLS) == (
        golden["trace"])


def test_ported_golden_cells():
    """All 17 goldens, the open-arrival and overload cells included."""
    ported = {n for n, (_w, e) in CELLS.items() if _slice_of(e) is None}
    assert ported == set(CELLS) and len(CELLS) == 17
    assert {"deadlock_free_overload", "deadlock_free_overload_shed",
            "dgcc_planner_sat", "scheduled_planner_sat"} <= ported
