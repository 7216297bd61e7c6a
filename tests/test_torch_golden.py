"""Golden-trace conformance of the PyTorch port: the ported cells of
``tests/golden`` replay bit-exactly on the CPU."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from golden.regenerate import CELLS, GOLDEN_DIR, METRICS_CELLS, fingerprint  # noqa: E402

from repro_torch.core import engine  # noqa: E402
from repro_torch.core.workloads import WorkloadConfig, make_workload  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_golden_trace_on_port(name):
    wl_kw, eng_kw = CELLS[name]
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    assert golden["workload"] == wl_kw and golden["engine"] == eng_kw
    cfg = engine.EngineConfig(**eng_kw, **golden["sim"])
    res = engine.run_simulation(cfg, make_workload(WorkloadConfig(**wl_kw)),
                                device="cpu")
    assert fingerprint(res, include_metrics=name in METRICS_CELLS) == (
        golden["trace"])


def test_ported_golden_cells():
    """All 17 goldens, the open-arrival and overload cells included, each
    a valid config of the port."""
    for _wl_kw, eng_kw in CELLS.values():
        engine.EngineConfig(**eng_kw)
    assert len(CELLS) == 17
    assert {"deadlock_free_overload", "deadlock_free_overload_shed",
            "dgcc_planner_sat", "scheduled_planner_sat"} <= set(CELLS)
