"""The port's dep_wavefront plain versions and wrappers against the JAX
reference (integers and bools: tolerance 0), and the engine's row form
(stage 4 in one launch on a card) against the wrapper, the JAX wrapper
and the dense check."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import depgraph as dg  # noqa: E402
from repro_torch.core.lockgrant import KEY_SENTINEL  # noqa: E402
from repro_torch.core.workloads import WorkloadConfig, make_workload  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dep_wavefront import ops  # noqa: E402
from repro_torch.kernels.dep_wavefront.ref import (  # noqa: E402
    dep_wavefront_ref,
    dep_wavefront_rows_ref,
)

BATCH = 128


def _jax():
    """(jax.numpy, the JAX wrappers' module, the Pallas kernel, the JAX
    plain version). The JAX package is imported only in the comparisons
    with it, so the card cases run where it is missing."""
    jnp = pytest.importorskip("jax.numpy")
    ref_ops = pytest.importorskip("repro.kernels.dep_wavefront.ops")
    kernel = pytest.importorskip("repro.kernels.dep_wavefront.kernel")
    ref = pytest.importorskip("repro.kernels.dep_wavefront.ref")
    return jnp, ref_ops, kernel.dep_wavefront_kernel, ref.dep_wavefront_ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grouped_edges(n, seed, n_units=None):
    """Edges grouped by dst: geometric runs (some longer than a 1,024
    tile), padding entries inside the list and a padding tail."""
    rng = np.random.default_rng(seed)
    lens = rng.geometric(1 / 12, size=n)
    lens[rng.random(n) < 0.02] *= 150
    dst = np.repeat(np.arange(len(lens)), lens)[:n]
    if n_units is not None:
        dst = np.minimum(dst, n_units - 1)
    dst = np.where(rng.random(n) < 0.05, KEY_SENTINEL, dst)
    dst[n - n // 16:] = KEY_SENTINEL
    ok = rng.random(n) < 0.7
    return dst.astype(np.int32), ok


@pytest.mark.parametrize("n,block", [(256, 64), (1024, 256), (555, 128)])
def test_dep_wavefront_ref_matches_reference(n, block):
    """The kernel contract: the port's plain version against the JAX
    plain version and the Pallas kernel in interpret mode, on the inputs
    of tests/test_core_depgraph.py::test_dep_wavefront_kernel_vs_ref and
    on grouped inputs with padding inside."""
    jnp, ref_ops, dep_wavefront_kernel, jax_dep_wavefront_ref = _jax()
    rng = np.random.default_rng(n)
    dst = np.sort(rng.integers(0, 64, n)).astype(np.int32)
    ok = rng.random(n) < 0.7
    pad = (-n) % block
    for d, o in ((np.concatenate([dst, np.full(pad, KEY_SENTINEL, np.int32)]),
                  np.concatenate([ok, np.ones(pad, bool)])),
                 _grouped_edges(n + pad, seed=n)):
        m0, p0 = jax_dep_wavefront_ref(jnp.asarray(d), jnp.asarray(o))
        m1, p1 = dep_wavefront_kernel(jnp.asarray(d), jnp.asarray(o),
                                      block_n=block, interpret=True)
        got = dep_wavefront_ref(_t(d), _t(o))
        for g in got:
            assert g.dtype == torch.int32
        for want in ((m0, p0), (m1, p1)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n,block", [(256, 64), (1024, 256), (777, 128)])
@pytest.mark.parametrize("n_txns", [16, 200])
def test_dep_wavefront_ready_matches_reference_wrapper(n, block, n_txns):
    """The whole wrapper against the JAX wrapper (Pallas in interpret
    mode) and the dense oracle, over tests/test_kernels.py's grid, with
    unsorted edges and padding entries mixed in."""
    jnp, ref_ops, dep_wavefront_kernel, jax_dep_wavefront_ref = _jax()
    rng = np.random.default_rng(n + n_txns)
    dst = rng.integers(0, n_txns, n).astype(np.int32)
    dst[rng.random(n) < 0.1] = KEY_SENTINEL
    src = rng.integers(0, n_txns, n).astype(np.int32)
    done = rng.random(n_txns) < 0.5
    want = np.asarray(ref_ops.dep_wavefront_ready(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(done),
        num_txns=n_txns, block_n=block, interpret=True,
    ))
    got = ops.dep_wavefront_ready(_t(dst), _t(src), _t(done),
                                  num_txns=n_txns, block_n=block)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    expect = np.ones(n_txns, bool)
    live = dst != KEY_SENTINEL
    np.logical_and.at(expect, dst[live], done[src[live]])
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.fixture(scope="module")
def frag_schedules():
    """The fragment schedules of tests/test_core_depgraph.py's
    ``_frag_schedules`` (multipart YCSB, four lanes)."""
    wl = make_workload(
        WorkloadConfig(kind="ycsb", num_txns=512, num_records=50_000,
                       num_hot=16, multipart_frac=1.0, num_partitions=16,
                       seed=0, batch_epoch=BATCH)
    )
    return [
        dg.build_schedule(wl.keys, wl.modes, wl.part, wl.nkeys, BATCH,
                          kind=kind, n_lanes=4, fragments=True)
        for kind in ("conflict", "lane")
    ]


def test_frag_ready_matches_reference(frag_schedules):
    """dep_wavefront_frag_ready / frag_commit_barrier against the JAX
    wrappers and the engine's dense pred_pad / txn_left formulation."""
    jnp, ref_ops, dep_wavefront_kernel, jax_dep_wavefront_ref = _jax()
    for s in frag_schedules:
        rng = np.random.default_rng(7)
        for _ in range(3):
            fdone = rng.random(s.n_frags) < rng.random()
            fr0, td0 = ref_ops.dep_wavefront_frag_ready(
                jnp.asarray(s.frag_edge_dst), jnp.asarray(s.frag_edge_src),
                jnp.asarray(fdone), jnp.asarray(s.frag_txn),
                num_frags=s.n_frags, num_txns=s.n_txns, block_n=256,
            )
            fr1, td1 = ops.dep_wavefront_frag_ready(
                _t(s.frag_edge_dst), _t(s.frag_edge_src), _t(fdone),
                _t(s.frag_txn), num_frags=s.n_frags, num_txns=s.n_txns,
                block_n=256,
            )
            np.testing.assert_array_equal(fr1.numpy(), np.asarray(fr0))
            np.testing.assert_array_equal(td1.numpy(), np.asarray(td0))
            dense_ready = (
                (s.frag_pred_pad < 0) | fdone[np.maximum(s.frag_pred_pad, 0)]
            ).all(axis=1)
            dense_done = np.ones(s.n_txns, bool)
            np.minimum.at(dense_done, s.frag_txn, fdone)
            np.testing.assert_array_equal(fr1.numpy(), dense_ready)
            np.testing.assert_array_equal(td1.numpy(), dense_done)
            np.testing.assert_array_equal(
                ops.frag_commit_barrier(_t(fdone), _t(s.frag_txn),
                                        num_txns=s.n_txns).numpy(),
                np.asarray(ref_ops.frag_commit_barrier(
                    jnp.asarray(fdone), jnp.asarray(s.frag_txn),
                    num_txns=s.n_txns)),
            )


@pytest.mark.parametrize("seed", range(4))
def test_engine_row_call_matches_wrapper_and_dense(frag_schedules, seed):
    """The engine's row-grouped call (stage 4 of make_batch_step) on the
    slot rows of a real fragment schedule, with stale rows that repeat a
    live unit, adjacent duplicates of full-width rows (so two rows share
    one segment), and rows of edgeless units; against the whole wrapper
    gathered per row and against the dense check."""
    s = frag_schedules[seed % 2]
    pred_pad = s.frag_pred_pad
    NU, P = pred_pad.shape
    rng = np.random.default_rng(seed)
    T = 96
    widx = rng.integers(0, NU, T)
    full = np.flatnonzero((pred_pad >= 0).all(axis=1))
    if len(full):
        u = full[seed % len(full)]
        widx[10:14] = u  # adjacent full-width duplicates
    widx[40:43] = widx[39]  # stale copies of a live row
    widx[50] = np.flatnonzero(s.frag_npred == 0)[0]
    widx = widx.astype(np.int32)
    done = rng.random(NU + 1) < rng.random()  # the engine's [NU + 1] flags
    preds = pred_pad[widx]
    src_ok = done[np.maximum(preds, 0)]
    got = ops.dep_wavefront_rows(_t(widx), _t(preds), _t(done))
    dense = ((preds < 0) | src_ok).all(axis=1)
    np.testing.assert_array_equal(got.numpy(), dense)
    edge_dst = np.where(preds >= 0, widx[:, None], KEY_SENTINEL).reshape(-1)
    ready_u = ops.dep_wavefront_ready(
        _t(edge_dst.astype(np.int32)),
        _t(np.maximum(preds, 0).reshape(-1).astype(np.int32)),
        _t(done), num_txns=NU, block_n=256,
    )
    np.testing.assert_array_equal(got.numpy(), ready_u.numpy()[widx])
    assert not dense.all() and dense.any()


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    dst, ok = _grouped_edges(300, seed=3)
    before = ops.launches
    got = ops.dep_wavefront_sorted(_t(dst), _t(ok))
    want = dep_wavefront_ref(_t(dst), _t(ok))
    assert ops.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_launch_rejects_cpu_tensors():
    with pytest.raises(ValueError):
        ops.dep_wavefront_cuda(torch.zeros(8, dtype=torch.int32),
                               torch.ones(8, dtype=torch.bool))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A CUDA tensor either gets the kernel or an error: with no nvcc the
    first launch's build raises (no cached library to fall back on)."""
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(ops, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops._library()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 128, 768, 1000, 1024, 2048, 3000, 65536])
def test_dep_wavefront_kernel_matches_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    dst, ok = _grouped_edges(n, seed=n)
    args = (_t(dst).to(dev), _t(ok).to(dev))
    got = ops.dep_wavefront_cuda(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, dep_wavefront_ref(*args)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def txn_schedules():
    """Transaction-level schedules (the dgcc and quecc kinds) of the same
    multipart YCSB workload."""
    wl = make_workload(
        WorkloadConfig(kind="ycsb", num_txns=512, num_records=50_000,
                       num_hot=16, multipart_frac=1.0, num_partitions=16,
                       seed=0, batch_epoch=BATCH)
    )
    return [
        dg.build_schedule(wl.keys, wl.modes, wl.part, wl.nkeys, BATCH,
                          kind=kind, n_lanes=4)
        for kind in ("conflict", "lane")
    ]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("frag", [False, True], ids=["txns", "fragments"])
def test_row_form_matches_dense_and_pallas_interpret(
        txn_schedules, frag_schedules, frag, seed):
    """The row form's plain version (and its CPU dispatch) on the slot
    rows of a real schedule, units or fragments, with adjacent rows of
    one unit, all -1 rows and a done flag per unit plus the engine's
    drop row: equal to the dense check and to the JAX wrapper's
    per-unit readiness (Pallas in interpret mode) gathered per row."""
    jnp, ref_ops, dep_wavefront_kernel, jax_dep_wavefront_ref = _jax()
    s = (frag_schedules if frag else txn_schedules)[seed % 2]
    pred_pad = s.frag_pred_pad if frag else s.pred_pad
    NU, P = pred_pad.shape
    rng = np.random.default_rng(seed)
    T = 64
    widx = rng.integers(0, NU, T)
    widx[5:9] = widx[4]  # adjacent rows of one unit
    none = np.flatnonzero((pred_pad < 0).all(axis=1))
    widx[20:23] = none[:3]  # rows with no predecessor
    widx = widx.astype(np.int32)
    done = rng.random(NU + 1) < 0.6
    preds = pred_pad[widx]
    assert (preds < 0).all(axis=1).any() and (preds >= 0).any()
    got = dep_wavefront_rows_ref(_t(widx), _t(preds), _t(done))
    np.testing.assert_array_equal(
        ops.dep_wavefront_rows(_t(widx), _t(preds), _t(done)).numpy(),
        got.numpy())
    dense = ((preds < 0) | done[np.maximum(preds, 0)]).all(axis=1)
    np.testing.assert_array_equal(got.numpy(), dense)
    edge_dst = np.where(preds >= 0, widx[:, None], KEY_SENTINEL)
    ready = ref_ops.dep_wavefront_ready(
        jnp.asarray(edge_dst.reshape(-1).astype(np.int32)),
        jnp.asarray(np.maximum(preds, 0).reshape(-1).astype(np.int32)),
        jnp.asarray(done), num_txns=NU, block_n=256, interpret=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ready)[widx])
    assert not dense.all() and dense.any()


def _row_verdicts(row_unit, preds, done):
    """The row kernel's rule (csrc/dep_wavefront.cu, form 2), in numpy: a
    row passes where no live edge of it misses and, where its first edge
    continues the segment of the row before (live, the same unit, after
    a live last edge), that segment has no miss so far."""
    T, P = preds.shape
    out = np.zeros(T, bool)
    carried = 0  # misses of the open segment after the row before
    prev_dst = None
    for t in range(T):
        live = preds[t] >= 0
        miss = live & ~done[np.clip(preds[t], 0, len(done) - 1)]
        dst0 = row_unit[t] if live[0] else None
        opens = dst0 is None or dst0 != prev_dst
        out[t] = not miss.any() and (opens or carried == 0)
        # the open segment at the row's end: from its last segment start
        run = 0 if opens else carried
        for j in range(P):
            if not live[j] or (j > 0 and not live[j - 1]):
                run = 0
            run += int(miss[j])
        carried = run
        prev_dst = row_unit[t] if live[-1] else None
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("T,P", [(1, 1), (40, 1), (64, 3), (128, 8)])
def test_row_verdicts_of_random_rows(T, P, seed):
    """On random rows whose runs of one unit differ (not the engine's:
    the segments then carry misses from one row to the next), the plain
    version equals the row kernel's rule."""
    rng = np.random.default_rng(seed * 13 + T)
    unit = rng.integers(0, 6, T)
    for t in range(1, T):
        if rng.random() < 0.5:
            unit[t] = unit[t - 1]
    preds = rng.integers(0, 6, (T, P))
    preds[rng.random((T, P)) < 0.3] = -1
    preds[rng.random(T) < 0.1] = -1
    done = rng.random(7) < 0.7
    want = _row_verdicts(unit, preds, done)
    got = dep_wavefront_rows_ref(*map(_t, (unit.astype(np.int32),
                                           preds.astype(np.int32), done)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_rows_output_checks_the_static_shapes():
    out = ops.rows_output(256, 8, 8193, "cpu")
    assert out.shape == (256,) and out.dtype == torch.bool
    for bad in ((0, 3, 10), (4, 0, 10), (4, 3, 0)):
        with pytest.raises(ValueError):
            ops.rows_output(*bad, "cpu")


def test_rows_cpu_tensors_take_the_plain_version_and_do_not_count():
    rng = np.random.default_rng(0)
    args = (_t(rng.integers(0, 9, 40).astype(np.int32)),
            _t(rng.integers(-1, 9, (40, 3)).astype(np.int32)),
            _t(rng.random(10) < 0.5))
    before = ops.launches
    got = ops.dep_wavefront_rows(*args, out=torch.zeros(40, dtype=bool))
    assert ops.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  dep_wavefront_rows_ref(*args).numpy())


def test_rows_kernel_launch_rejects_cpu_tensors():
    with pytest.raises(ValueError):
        ops.dep_wavefront_rows_cuda(torch.zeros(4, dtype=torch.int32),
                                    torch.zeros(4, 2, dtype=torch.int32),
                                    torch.ones(5, dtype=torch.bool))


def _random_rows(T, P, seed):
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, max(T // 2, 2), T)
    run = rng.random(T) < 0.4
    for t in range(1, T):
        if run[t]:
            unit[t] = unit[t - 1]
    preds = rng.integers(-1, max(T // 2, 2), (T, P))
    preds[rng.random(T) < 0.1] = -1
    done = rng.random(max(T // 2, 2) + 1) < 0.7
    return unit.astype(np.int32), preds.astype(np.int32), done


@pytest.mark.cuda
@pytest.mark.parametrize("T,P", [(40, 1), (128, 1), (256, 3), (256, 8),
                                 (1500, 3), (3000, 2)])
def test_row_kernel_matches_plain_on_card(T, P):
    """The main path's shapes (E = 40, 128, 768, 2,048) and rows past one
    block (the tile loop)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    args = [_t(a).to(dev) for a in _random_rows(T, P, T + P)]
    out = ops.rows_output(T, P, args[2].shape[0], dev)
    got = ops.dep_wavefront_rows_cuda(*args, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, dep_wavefront_rows_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 40, 2048, 4097, 65536])
def test_earlier_design_matches_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    dst, ok = _grouped_edges(n, seed=n)
    args = (_t(dst).to(dev), _t(ok).to(dev))
    want = dep_wavefront_ref(*args)
    for got in (ops._dep_wavefront_tile(*args), ops.dep_wavefront_cuda(*args)):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
