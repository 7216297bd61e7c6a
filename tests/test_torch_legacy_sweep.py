"""The port's legacy state layout through its host loop, on the CPU (one
case on a card, marked ``cuda``).

  * Packed against legacy: the port's own mirror of
    ``tests/test_engine_leap.py``'s ``test_packed_matches_legacy_property``
    and ``test_fragment_off_matches_legacy_property``, over randomized
    (protocol, lanes, window, contention, batch epoch, leap mode) cells
    with a bounded, derandomized example count: the packed engine's
    fingerprint equals the frozen legacy engine's.
  * K-fused dispatch on the legacy layout: K = 8 equals K = 1.
  * A ``run_cells`` group that mixes legacy and packed cells equals the
    per-cell runs.
  * On a card: legacy cells through their CUDA graphs (K = 1 and 8) equal
    the CPU's runs, and launch no kernel.
"""

import pytest

torch = pytest.importorskip("torch")

from golden.regenerate import fingerprint  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch.core import engine, sweep, workloads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROTO_KW = {
    "twopl_waitdie": dict(n_exec=8),
    "twopl_waitfor": dict(n_exec=8),
    "twopl_dreadlocks": dict(n_exec=8),
    "deadlock_free": dict(n_exec=8),
    "orthrus": dict(n_cc=2, n_exec=6, window=2),
    "partitioned_store": dict(n_exec=8),
    "dgcc": dict(n_cc=2, n_exec=6, window=2),
    "quecc": dict(n_cc=4, n_exec=6, window=2),
}
PROP_SIM = dict(max_rounds=1000, warmup_rounds=250, chunk_rounds=250,
                target_commits=10**9)
SIM = dict(max_rounds=800, warmup_rounds=200, chunk_rounds=200,
           target_commits=10**9)


def _wl(**kw):
    base = dict(kind="ycsb", num_txns=256, num_records=10_000, num_hot=8,
                seed=0)
    return workloads.make_workload(workloads.WorkloadConfig(**{**base,
                                                               **kw}))


def _run(wl, device="cpu", **eng_kw):
    return engine.run_simulation(engine.EngineConfig(**eng_kw), wl,
                                 device=device)


def _same(got, want, group=False):
    skip = {"wall_s_group"} | ({"group_cells"} if group else set())
    assert fingerprint(got, include_metrics=True) == fingerprint(
        want, include_metrics=True)
    assert {k: v for k, v in got.raw.items() if k not in skip} == {
        k: v for k, v in want.raw.items() if k not in skip}


def _layouts(wl, **eng_kw):
    packed = _run(wl, **eng_kw)
    legacy = _run(wl, state_layout="legacy", **eng_kw)
    assert legacy.metrics is None and packed.metrics is not None
    assert fingerprint(packed) == fingerprint(legacy)
    return packed, legacy


@settings(max_examples=6, deadline=None, derandomize=True)
@given(
    protocol=st.sampled_from(sorted(PROTO_KW)),
    n_exec=st.sampled_from([2, 6, 16]),
    window=st.sampled_from([1, 3]),
    num_hot=st.sampled_from([0, 8, 512]),
    batch_epoch=st.sampled_from([64, 256]),
    event_leap=st.booleans(),
    seed=st.integers(min_value=0, max_value=3),
)
def test_packed_matches_legacy_property(protocol, n_exec, window, num_hot,
                                        batch_epoch, event_leap, seed):
    """Differential conformance inside the port: packed against legacy
    over randomized cells (the fig13 sweeps' cross product)."""
    wl = _wl(num_hot=num_hot, batch_epoch=batch_epoch, seed=seed)
    kw = dict(PROTO_KW[protocol], n_exec=n_exec)
    if protocol in ("orthrus", "dgcc", "quecc"):
        kw["window"] = window
    _layouts(wl, protocol=protocol, event_leap=event_leap, **kw, **PROP_SIM)


@settings(max_examples=6, deadline=None, derandomize=True)
@given(
    protocol=st.sampled_from(["dgcc", "quecc"]),
    n_exec=st.sampled_from([2, 6, 16]),
    window=st.sampled_from([1, 3]),
    num_hot=st.sampled_from([0, 8, 512]),
    batch_epoch=st.sampled_from([64, 256]),
    seed=st.integers(min_value=0, max_value=3),
)
def test_fragment_off_matches_legacy_property(protocol, n_exec, window,
                                              num_hot, batch_epoch, seed):
    """The fragment-capable batch engine with ``fragment_exec=False``
    stays bit-identical to the frozen pre-fragment engine."""
    wl = _wl(num_hot=num_hot, batch_epoch=batch_epoch, seed=seed)
    kw = dict(PROTO_KW[protocol], n_exec=n_exec, window=window)
    _layouts(wl, protocol=protocol, fragment_exec=False, **kw, **PROP_SIM)


@pytest.mark.parametrize("protocol", ["orthrus", "twopl_waitfor",
                                      "partitioned_store", "dgcc"])
def test_legacy_fused_k_matches_k1(protocol):
    """K = 8 (guarded inner steps, no stamp rebase) leaves every counter
    of the legacy layout as K = 1, and both equal the packed layout."""
    wl = _wl(num_hot=16, batch_epoch=64)
    kw = dict(protocol=protocol, **PROTO_KW[protocol], **SIM)
    one = _run(wl, state_layout="legacy", **kw)
    eight = _run(wl, state_layout="legacy", rounds_per_dispatch=8, **kw)
    _same(eight, one)
    assert fingerprint(one) == fingerprint(_run(wl, **kw))
    assert one.commits > 0


def test_legacy_rebase_is_off(monkeypatch):
    """The stamp rebase applies to the packed lock-table engine only: the
    legacy layout keeps the unrebased counter (the reference's rule)."""
    calls = []
    monkeypatch.setattr(engine, "rebase_enq",
                        lambda s: calls.append(1) or s)
    for layout, want in (("legacy", []), ("packed", [1])):
        cfg = engine.EngineConfig(protocol="twopl_waitdie", n_exec=4,
                                  state_layout=layout, **SIM)
        calls.clear()
        sweep.make_dispatch(cfg, lambda p, s, r_end: s)(None, {}, None)
        assert calls == want, layout


def _mixed_cells():
    """Two legacy deadlock_free cells of one plan shape (one group), the
    packed cell of the first, and a legacy dgcc cell."""
    df = dict(protocol="deadlock_free", n_exec=8, **SIM)
    dg = dict(protocol="dgcc", n_cc=2, n_exec=6, window=2, **SIM)
    legacy = dict(state_layout="legacy")
    return [
        (engine.EngineConfig(**df, **legacy), _wl(seed=0)),
        (engine.EngineConfig(**df), _wl(seed=0)),
        (engine.EngineConfig(**df, **legacy), _wl(seed=1)),
        (engine.EngineConfig(**dg, **legacy), _wl(batch_epoch=64)),
    ]


@pytest.mark.parametrize("mode", [sweep.SERIAL_MODE,
                                  sweep.SweepMode(1, 2, True)],
                         ids=["serial", "pipelined"])
def test_run_cells_mixes_layouts(mode):
    cells = _mixed_cells()
    got = sweep.run_cells(cells, mode=mode, device="cpu")
    singles = [engine.run_simulation(cfg, wl, device="cpu")
               for cfg, wl in cells]
    for g, s in zip(got, singles, strict=True):
        _same(g, s, group=True)
    assert [g.raw["group_cells"] for g in got] == [2, 1, 2, 1]
    assert [g.metrics is None for g in got] == [True, False, True, True]
    assert fingerprint(got[0]) == fingerprint(got[1])


@pytest.mark.cuda
def test_legacy_graphs_match_cpu_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.dep_wavefront import ops as dw_ops
    from repro_torch.kernels.lock_grant import ops as lg_ops

    for protocol in ("orthrus", "twopl_waitfor", "dgcc"):
        wl = _wl(num_hot=16, batch_epoch=64)
        kw = dict(protocol=protocol, state_layout="legacy",
                  **PROTO_KW[protocol], **SIM)
        want = _run(wl, **kw)
        before = lg_ops.launches + dw_ops.launches
        for k in (1, 8):
            _same(_run(wl, device="cuda", rounds_per_dispatch=k, **kw), want)
        assert lg_ops.launches + dw_ops.launches == before
