"""The 17 golden fixtures through the port's multi-cell sweep, on the CPU.

As ``tests/test_golden_traces.py``'s parallel replay: every
fixture twice in one ``repro_torch.core.sweep.run_cells`` call, under
the pipelined early-exit mode, so each group carries at least two cells
and the groups follow one another with the next one prepared while the
current one runs. Both copies of every cell must equal the committed
trace bit for bit (the overload cells' metrics included). Also here,
against the reference's ``run_cells``: interleaved cells of several
groups in one call (input order and ``group_cells``).
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from golden.regenerate import (  # noqa: E402
    CELLS,
    GOLDEN_DIR,
    METRICS_CELLS,
    SIM,
    fingerprint,
)
from test_torch_sweep_cells import (  # noqa: E402
    MODES,
    PROTO_KW,
    SHORT_SIM,
    YCSB_EXIT,
    assert_same,
    run_both,
)

from repro_torch.core import engine, sweep  # noqa: E402
from repro_torch.core.workloads import WorkloadConfig, make_workload  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_goldens_twice_in_one_sweep():
    names = sorted(CELLS)
    cells = []
    for name in names:
        wl_kw, eng_kw = CELLS[name]
        cfg = engine.EngineConfig(**eng_kw, **SIM)
        wl = make_workload(WorkloadConfig(**wl_kw))
        cells.extend([(cfg, wl), (cfg, wl)])
    mode = sweep.SweepMode(devices=max(1, torch.cuda.device_count()),
                           pipeline=2, early_exit=True)
    results = sweep.run_cells(cells, mode=mode, device="cpu")
    assert len(names) == 17
    for k, name in enumerate(names):
        with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
            want = json.load(f)["trace"]
        for lane in (0, 1):
            res = results[2 * k + lane]
            assert res.raw["group_cells"] == 2, name
            got = fingerprint(res, include_metrics=name in METRICS_CELLS)
            assert got == want, (name, lane, {
                q: (got[q], want.get(q)) for q in got
                if got[q] != want.get(q)})


@pytest.mark.parametrize("mode_name", ["serial", "pipelined"])
def test_several_groups_in_input_order(mode_name):
    """Interleaved cells of five groups (two protocols, a shorter budget,
    a K = 4 group, a one-cell group) come back in input order with the
    reference's ``group_cells``; the pipelined mode prepares each next
    group while the current one runs."""
    df = dict(protocol="deadlock_free", n_exec=8, **SHORT_SIM)
    dg = dict(protocol="dgcc", **PROTO_KW["dgcc"], **SHORT_SIM)
    short = dict(df, max_rounds=500)
    k4 = dict(protocol="twopl_waitdie", n_exec=8, rounds_per_dispatch=4,
              **SHORT_SIM)
    one = dict(protocol="orthrus", **PROTO_KW["orthrus"], **SHORT_SIM)
    cells = [(df, 4), (dg, 64), (k4, 4), (df, 64), (short, 4), (one, 64),
             (dg, 1024), (k4, 1024), (short, 64), (df, 1024)]
    got, want = run_both([(e, dict(YCSB_EXIT, num_hot=h))
                          for e, h in cells], MODES[mode_name])
    groups = [r.raw["group_cells"] for r in got]
    assert groups == [r.raw["group_cells"] for r in want]
    assert groups == [3, 2, 2, 3, 2, 1, 2, 2, 2, 3]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, i)
