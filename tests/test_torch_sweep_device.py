"""The multi-cell sweep on CUDA cards (marked ``cuda``; each test skips
without the cards it needs). No JAX here: the port's group runs are
held against its own per-cell runs.

  * One card: a group of cells is one CUDA graph with a branch per cell;
    under every sweep mode each cell equals its own ``run_simulation``
    (its K = 1 graph) and its eager run, and the group runner's kernel
    launches are C x K a replay.
  * Two cards: ``SweepMode(devices=2)`` splits a group into two blocks,
    one graph per card, and gives the one-card results.
"""

import pytest

torch = pytest.importorskip("torch")

from golden.regenerate import fingerprint  # noqa: E402

from repro_torch.core import engine, sweep, workloads  # noqa: E402

EXIT_SIM = dict(max_rounds=2000, warmup_rounds=500, chunk_rounds=250,
                target_commits=60)
CELLS = {
    "orthrus": dict(protocol="orthrus", n_cc=2, n_exec=6, window=2),
    "dgcc": dict(protocol="dgcc", n_cc=2, n_exec=6, window=2),
    "twopl_waitfor": dict(protocol="twopl_waitfor", n_exec=8,
                          rounds_per_dispatch=4),
}
HOTS = (4, 64, 1024)


def _cells(name):
    cfg = engine.EngineConfig(**CELLS[name], **EXIT_SIM)
    return [(cfg, workloads.make_workload(workloads.WorkloadConfig(
        kind="ycsb", num_txns=256, num_records=10_000, num_hot=h, seed=3)))
        for h in HOTS]


def _same(got, want):
    skip = ("wall_s_group", "group_cells")
    assert fingerprint(got, include_metrics=True) == fingerprint(
        want, include_metrics=True)
    assert {k: v for k, v in got.raw.items() if k not in skip} == {
        k: v for k, v in want.raw.items() if k not in skip}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_group_graph_matches_single_runs_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.dep_wavefront import ops as dw_ops
    from repro_torch.kernels.lock_grant import ops as lg_ops

    cells = _cells(name)
    singles = [engine.run_simulation(cfg, wl, device="cuda")
               for cfg, wl in cells]
    eager = [sweep.simulate_eager(cfg, engine.make_plan(cfg, wl),
                                  device="cuda") for cfg, wl in cells]
    for s, e in zip(singles, eager):
        _same(s, e)
    kernel = name in ("orthrus", "dgcc")
    for mode in (sweep.SERIAL_MODE, sweep.SweepMode(1, 0, True),
                 sweep.SweepMode(1, 2, True)):
        before = lg_ops.launches + dw_ops.launches
        replays = {k: r.replays for k, r in sweep._RUNNER_CACHE.items()}
        got = sweep.run_cells(cells, mode=mode, device="cuda")
        want = sum(getattr(r, "n", 1) * r.cfg.dispatch_rounds
                   * (r.replays - replays.get(k, 0))
                   for k, r in sweep._RUNNER_CACHE.items())
        launched = lg_ops.launches + dw_ops.launches - before
        assert launched == (want if kernel else 0) and want > 0
        for g, s in zip(got, singles):
            assert g.raw["group_cells"] > 1
            _same(g, s)


@pytest.mark.cuda
def test_two_cards_split_a_group():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    cells = _cells("orthrus") + _cells("dgcc")
    one = sweep.run_cells(cells, mode=sweep.SweepMode(1, 1, True),
                          device="cuda:0")
    two = sweep.run_cells(cells, mode=sweep.SweepMode(2, 1, True),
                          device="cuda:0")
    for a, b in zip(one, two):
        _same(a, b)
        assert a.raw["group_cells"] == b.raw["group_cells"] == 3
    devices = {k[2] for k in sweep.runner_cache_info()["keys"]
               if len(k) == 4}
    assert {torch.device("cuda", 0), torch.device("cuda", 1)} <= devices
