"""The port's lock-grant primitives, lock_grant wrapper and the engine's
fused grant pass against the JAX reference (integers: tolerance 0)."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import engine  # noqa: E402
from repro_torch.core import lockgrant as lg  # noqa: E402
from repro_torch.core.workloads import (  # noqa: E402
    MODE_WRITE,
    WorkloadConfig,
    make_workload,
)
from repro_torch.kernels import _build, use_kernel  # noqa: E402
from repro_torch.kernels.lock_grant import ops  # noqa: E402
from repro_torch.kernels.lock_grant.ref import (  # noqa: E402
    lock_grant_ref,
    lock_grant_step_ref,
)

KINDS = [lg.REQ_READ, lg.REQ_WRITE, lg.REQ_RELEASE, lg.REQ_NONE]


def _jax():
    """(jax.numpy, repro.core.lockgrant, the JAX wrapper ``lock_grant``).
    The JAX package is imported only in the comparisons with it, so the
    card cases run where it is missing."""
    jnp = pytest.importorskip("jax.numpy")
    ref_lg = pytest.importorskip("repro.core.lockgrant")
    ref_ops = pytest.importorskip("repro.kernels.lock_grant.ops")
    return jnp, ref_lg, ref_ops.lock_grant


def _random_round(seed, n, nkeys, R, past=0):
    """Entries as in tests/test_core_lockgrant.py's property test (keys
    below ``nkeys``, every kind, unique stamps), with optional keys up to
    ``R + past`` that lie past the lock table."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, n).astype(np.int32)
    keys = rng.integers(0, nkeys + past, n).astype(np.int32)
    keys = np.where(kind == lg.REQ_NONE, lg.KEY_SENTINEL, keys).astype(np.int32)
    ts = rng.permutation(max(1000, n))[:n].astype(np.int32)
    wh = np.full(R, -1, np.int32)
    wh[rng.integers(0, R, R // 2)] = 3
    rc = np.zeros(R, np.int32)
    rc[rng.integers(0, R, R // 3)] = rng.integers(1, 4, R // 3)
    return keys, ts, kind, wh, rc


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_constants_match_reference():
    jnp, ref_lg, ref_lock_grant = _jax()
    assert lg.KEY_SENTINEL == int(ref_lg.KEY_SENTINEL)
    for name in ("REQ_READ", "REQ_WRITE", "REQ_RELEASE", "REQ_NONE"):
        assert getattr(lg, name) == getattr(ref_lg, name)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [1, 7, 40, 333])
def test_grant_round_matches_reference(seed, n):
    jnp, ref_lg, ref_lock_grant = _jax()
    keys, ts, kind, wh, rc = _random_round(seed * 1000 + n, n, 8, 8)
    want = ref_lg.grant_round(
        jnp.asarray(keys), jnp.asarray(ts), jnp.asarray(kind),
        jnp.asarray(wh), jnp.asarray(rc), 8, weight=jnp.asarray(kind % 2),
    )
    got = lg.grant_round(_t(keys), _t(ts), _t(kind), _t(wh), _t(rc), 8,
                         weight=_t(kind % 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32


@pytest.mark.parametrize("seed", range(4))
def test_lex_order_and_segment_primitives_match_reference(seed):
    jnp, ref_lg, ref_lock_grant = _jax()
    rng = np.random.default_rng(seed)
    n = 257
    prim = rng.integers(-3, 5, n).astype(np.int32)
    prim[:4] = [lg.I32_MAX, lg.I32_MIN, 0, lg.I32_MAX]
    sec = rng.integers(lg.I32_MIN, lg.I32_MAX, n, dtype=np.int64).astype(np.int32)
    sec[::7] = sec[0]  # ties in both keys keep their original order
    prim[::7] = prim[0]
    order = lg.lex_order(_t(prim), _t(sec))
    ref_order = np.asarray(ref_lg.lex_order(jnp.asarray(prim), jnp.asarray(sec)))
    np.testing.assert_array_equal(order.numpy(), ref_order)
    np.testing.assert_array_equal(
        lg.inverse_permutation(order).numpy(),
        np.asarray(ref_lg.inverse_permutation(jnp.asarray(ref_order))),
    )
    ks = np.sort(rng.integers(0, 9, n)).astype(np.int32)
    w = rng.integers(0, 5, n).astype(np.int32)
    np.testing.assert_array_equal(
        lg.segment_sum_sorted(_t(ks), _t(w)).numpy(),
        np.asarray(ref_lg.segment_sum_sorted(jnp.asarray(ks), jnp.asarray(w))),
    )
    seg_id = np.cumsum(np.r_[True, ks[1:] != ks[:-1]]).astype(np.int32) - 1
    incl = np.cumsum(w).astype(np.int32)
    np.testing.assert_array_equal(
        lg._segment_broadcast_last(_t(incl), _t(seg_id)).numpy(),
        np.asarray(ref_lg._segment_broadcast_last(jnp.asarray(incl),
                                                  jnp.asarray(seg_id))),
    )


@pytest.mark.parametrize("seed", range(4))
def test_segmented_grant_sorted_matches_reference(seed):
    jnp, ref_lg, ref_lock_grant = _jax()
    keys, ts, kind, wh, rc = _random_round(seed, 200, 6, 8)
    order = np.lexsort((ts, keys))
    wh_free = (wh[np.minimum(keys, 7)] == -1) & (keys < 8)
    rcv = np.where(keys < 8, rc[np.minimum(keys, 7)], 0).astype(np.int32)
    args = (keys[order], ts[order], kind[order], wh_free[order], rcv[order])
    got = lg.segmented_grant(*map(_t, args))
    want = ref_lg.segmented_grant(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the engine's grant-only plain path
    grant_only = lg.sorted_grant(*map(_t, (args[0], *args[2:])))
    np.testing.assert_array_equal(grant_only.numpy(), np.asarray(want[0]))


def test_reads_share_writes_exclusive_fifo():
    def run(keys, kind):
        n = len(keys)
        g, c, _ = lg.grant_round(
            torch.tensor(keys, dtype=torch.int32),
            torch.arange(1, n + 1, dtype=torch.int32),
            torch.tensor(kind, dtype=torch.int32),
            torch.full((64,), -1, dtype=torch.int32),
            torch.zeros(64, dtype=torch.int32), 64,
        )
        return g.tolist(), c.tolist()

    assert run([5, 5, 5], [lg.REQ_READ] * 3) == ([True] * 3, [3] * 3)
    assert run([5, 5], [lg.REQ_WRITE] * 2)[0] == [True, False]
    assert run([5, 5, 5], [lg.REQ_WRITE, lg.REQ_READ, lg.REQ_READ])[0] == [
        True, False, False]
    assert run([5, 5], [lg.REQ_RELEASE, lg.REQ_READ]) == ([False, True],
                                                          [2, 2])
    assert run([lg.KEY_SENTINEL, 5], [lg.REQ_NONE, lg.REQ_READ]) == (
        [False, True], [0, 1])


@pytest.mark.parametrize("n,block", [(256, 64), (1024, 256), (555, 128)])
@pytest.mark.parametrize("nkeys", [4, 32])
def test_lock_grant_matches_reference_wrapper(n, block, nkeys):
    """The port's wrapper (plain version on CPU tensors) against the JAX
    wrapper running the Pallas kernel in interpret mode, over the grid of
    tests/test_kernels.py::test_lock_grant_vs_oracle, with keys past the
    lock table mixed in."""
    jnp, ref_lg, ref_lock_grant = _jax()
    R = max(nkeys, 2)
    keys, ts, kind, wh, rc = _random_round(n + nkeys, n, R, R, past=R // 2)
    g0, c0 = ref_lock_grant(
        jnp.asarray(keys), jnp.asarray(ts), jnp.asarray(kind),
        jnp.asarray(wh), jnp.asarray(rc), num_records=R, block_n=block,
        interpret=True,
    )
    g1, c1 = ops.lock_grant(_t(keys), _t(ts), _t(kind), _t(wh), _t(rc),
                            num_records=R, block_n=block)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(g0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c0))


@pytest.mark.parametrize("seed", range(3))
def test_lock_grant_ref_matches_pallas_interpret(seed):
    """The kernel contract itself: sorted entries through the port's plain
    version and the Pallas kernel in interpret mode."""
    jnp, ref_lg, ref_lock_grant = _jax()
    from repro.kernels.lock_grant.kernel import lock_grant_kernel

    keys, ts, kind, wh, rc = _random_round(seed, 512, 5, 8, past=3)
    order = np.lexsort((ts, keys))
    wh_free = (wh[np.minimum(keys, 7)] == -1) & (keys < 8)
    rcv = np.where(keys < 8, rc[np.minimum(keys, 7)], 0).astype(np.int32)
    args = (keys[order], kind[order], wh_free[order], rcv[order])
    want = lock_grant_kernel(*map(jnp.asarray, args), block_n=128,
                             interpret=True)
    got = lock_grant_ref(*map(_t, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_resolver():
    assert use_kernel("auto", "cuda") and not use_kernel("auto", "cpu")
    assert use_kernel("pallas", "cpu") and use_kernel("pallas", "cuda")
    assert not use_kernel("jnp", "cuda") and not use_kernel("jnp", "cpu")
    with pytest.raises(ValueError):
        use_kernel("triton", "cuda")


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    keys, ts, kind, wh, rc = _random_round(1, 64, 4, 4)
    before = ops.launches
    ops.lock_grant(_t(keys), _t(ts), _t(kind), _t(wh), _t(rc),
                   num_records=4, block_n=64)
    assert ops.launches == before


def test_kernel_launch_rejects_cpu_tensors():
    n = 8
    args = (torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.lock_grant_cuda(*args)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 2560, 3072, 65536])
def test_lock_grant_kernel_matches_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    keys, ts, kind, wh, rc = _random_round(n, n, n // 4, n // 4, past=n // 8)
    order = np.lexsort((ts, keys))
    R = n // 4
    wh_free = (wh[np.minimum(keys, R - 1)] == -1) & (keys < R)
    rcv = np.where(keys < R, rc[np.minimum(keys, R - 1)], 0).astype(np.int32)
    args = [_t(a[order]).to(dev)
            for a in (keys, kind, wh_free, rcv)]
    got = ops.lock_grant_cuda(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, lock_grant_ref(*args)):
        assert torch.equal(g, w)


# --------------------------------------------- the engine's fused grant pass
STEPS = [(4, 3), (16, 10), (64, 10)]


def _random_step(seed, T, K, R):
    """One ORTHRUS round's grant inputs: keys colliding on a small table
    and some past it, both modes, pending, release and inactive entries,
    negative and tied stamps (as after ``rebase_enq``), write holders
    that are the entries' own slots (re-entrant grants) and read
    counts."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, R + 3, (T, K)).astype(np.int32)
    modes = rng.integers(0, 2, (T, K)).astype(np.int32)
    pend = rng.random((T, K)) < 0.5
    rel = rng.random((T, K)) < 0.2
    enq = rng.integers(-6, 3 * K, (T, K)).astype(np.int32)
    wh = np.where(rng.random(R + 1) < 0.4, rng.integers(0, T, R + 1),
                  -1).astype(np.int32)
    rc = np.where(rng.random(R + 1) < 0.4, rng.integers(1, 3, R + 1),
                  0).astype(np.int32)
    return keys, modes, pend, rel, enq, wh, rc


def _engine_formulation(keys, modes, pend2d, rel_entries, enq, wh, rc, R):
    """The grant decision of make_step's stage 7 as the engine writes it
    around the plain sorted grant, recomputed here: entry kinds and keys,
    the table gathers through min(key, R - 1), the stable sort, the
    grant, the unsort and the re-entrant grant."""
    T, K = keys.shape
    i32 = torch.int32
    ent_kind = torch.where(
        pend2d,
        torch.where(modes == MODE_WRITE, lg.REQ_WRITE, lg.REQ_READ),
        torch.where(rel_entries, lg.REQ_RELEASE, lg.REQ_NONE),
    ).to(i32).reshape(-1)
    ent_key = torch.where(pend2d | rel_entries, keys,
                          lg.KEY_SENTINEL).reshape(-1)
    safe = torch.clamp(ent_key, max=R - 1).long()
    in_rng = ent_key < R
    wh_ent = wh[:R][safe]
    wh_free = (wh_ent == -1) & in_rng
    rcv = torch.where(in_rng, rc[:R][safe], 0)
    order = lg.lex_order(ent_key, enq.reshape(-1))
    g_sorted = lg.sorted_grant(ent_key[order], ent_kind[order],
                               wh_free[order], rcv[order])
    grant = torch.empty_like(g_sorted)
    grant[order] = g_sorted
    slot = torch.arange(T, dtype=i32).repeat_interleave(K)
    self_grant = ((ent_kind != lg.REQ_NONE) & (ent_kind != lg.REQ_RELEASE)
                  & in_rng & (wh_ent == slot))
    return (grant | self_grant).view(T, K)


def _chain(args, R, grant_sorted):
    """engine.grant_chain on a round's torch inputs."""
    keys, modes, pend, rel, enq, wh, rc = args
    T, K = keys.shape
    slot = torch.arange(T, dtype=torch.int32).repeat_interleave(K)
    consts = tuple(torch.tensor(v, dtype=torch.int32) for v in (
        lg.REQ_WRITE, lg.REQ_READ, lg.REQ_RELEASE, lg.REQ_NONE))
    return engine.grant_chain(keys, modes, pend, rel, enq, wh[:R], rc[:R],
                              slot, consts, grant_sorted)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("R", [2, 5, 40])
@pytest.mark.parametrize("T,K", STEPS)
def test_lock_grant_step_ref_matches_engine_formulation(T, K, R, seed):
    """The fused form's plain version, its CPU dispatch and the engine's
    chain (around the plain and around the kernel-contract sorted grant)
    against the engine's formulation recomputed here."""
    args = tuple(map(_t, _random_step(seed * 100 + T, T, K, R)))
    want = _engine_formulation(*args, R)
    assert want.dtype == torch.bool and want.shape == (T, K)
    got = lock_grant_step_ref(*args, R)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        ops.lock_grant_step(*args, R).numpy(), want.numpy())
    for grant_sorted in (lg.sorted_grant,
                         lambda *a: ops.lock_grant_sorted(*a)[0]):
        np.testing.assert_array_equal(
            _chain(args, R, grant_sorted).numpy(), want.numpy())


def test_random_rounds_grant_some_pending_entries():
    """The rounds above are not trivial: over the seeds, some pending
    entries are granted and some wait."""
    granted = pending = 0
    for T, K in STEPS:
        for seed in range(3):
            for R in (2, 5, 40):
                args = tuple(map(_t, _random_step(seed * 100 + T, T, K, R)))
                granted += int(lock_grant_step_ref(*args, R).sum())
                pending += int(args[2].sum())
    assert 0 < granted < pending


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("T,K", STEPS)
def test_lock_grant_step_ref_matches_pallas_interpret(T, K, seed):
    """The fused form's plain version against the JAX TPU wrapper (the
    Pallas kernel in interpret mode) on the round's entries, plus the
    re-entrant grant."""
    jnp, ref_lg, ref_lock_grant = _jax()
    R = 5
    keys, modes, pend, rel, enq, wh, rc = _random_step(seed + 7, T, K, R)
    kind = np.where(pend, np.where(modes == MODE_WRITE, lg.REQ_WRITE,
                                   lg.REQ_READ),
                    np.where(rel, lg.REQ_RELEASE, lg.REQ_NONE))
    key = np.where(pend | rel, keys, lg.KEY_SENTINEL)
    g, _contenders = ref_lock_grant(
        jnp.asarray(key.reshape(-1).astype(np.int32)),
        jnp.asarray(enq.reshape(-1)), jnp.asarray(kind.reshape(-1)),
        jnp.asarray(wh[:R]), jnp.asarray(rc[:R]), num_records=R, block_n=64,
        interpret=True,
    )
    slot = np.repeat(np.arange(T), K).reshape(T, K)
    self_grant = pend & (key < R) & (wh[np.clip(key, 0, R - 1)] == slot)
    want = np.asarray(g).reshape(T, K) | self_grant
    got = lock_grant_step_ref(*map(_t, (keys, modes, pend, rel, enq, wh,
                                        rc)), R)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_releases_change_no_grant(seed):
    """Release entries contend but are never granted and count in
    neither the requests nor the writes before an entry: the grant is
    the same without them (the fused kernel does not read them)."""
    keys, modes, pend, rel, enq, wh, rc = map(_t, _random_step(seed, 64, 10,
                                                               5))
    with_rel = lock_grant_step_ref(keys, modes, pend, rel, enq, wh, rc, 5)
    without = lock_grant_step_ref(keys, modes, pend, torch.zeros_like(rel),
                                  enq, wh, rc, 5)
    np.testing.assert_array_equal(with_rel.numpy(), without.numpy())


def _per_record_minima(keys, modes, pend, enq, wh, rc, R):
    """The fused kernel's decision rule (csrc/lock_grant.cu), in numpy:
    per record in the table, the least (stamp, index) of its pending
    requests and of its pending writes; a read is granted on a
    write-free record below the least write, a write on a write-free
    record with no readers when it is the least request; or the slot
    holds the record's write lock."""
    T, K = keys.shape
    key, mode, p, stamp = (a.reshape(-1) for a in (keys, modes, pend, enq))
    cand = p & (key < R)
    order = [(int(stamp[i]), i) for i in range(T * K)]
    least_req, least_wr = {}, {}
    for i in np.flatnonzero(cand):
        k = int(key[i])
        least_req[k] = min(least_req.get(k, order[i]), order[i])
        if mode[i] == MODE_WRITE:
            least_wr[k] = min(least_wr.get(k, order[i]), order[i])
    grant = np.zeros(T * K, bool)
    for i in np.flatnonzero(cand):
        k = int(key[i])
        holder = wh[max(k, 0)]
        if mode[i] == MODE_WRITE:
            fifo = least_req[k] == order[i] and rc[max(k, 0)] == 0
        else:
            fifo = order[i] < least_wr.get(k, (2**31, 0))
        grant[i] = (holder == -1 and fifo) or holder == i // K
    return grant.reshape(T, K)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("R", [2, 40])
@pytest.mark.parametrize("T,K", STEPS)
def test_per_record_minima_decide_the_grant(T, K, R, seed):
    """The rule the fused kernel decides by (two minima per record, no
    sort) equals the sort-and-scan of the plain version."""
    args = _random_step(seed * 7 + R, T, K, R)
    keys, modes, pend, rel, enq, wh, rc = args
    want = lock_grant_step_ref(*map(_t, args), R).numpy()
    np.testing.assert_array_equal(
        _per_record_minima(keys, modes, pend, enq, wh, rc, R), want)


def test_step_output_checks_the_static_shapes():
    out = ops.step_output(256, 10, 131072, "cpu")
    assert out.shape == (256, 10) and out.dtype == torch.bool
    assert ops.step_output(512, 8, 1, "cpu").shape == (512, 8)
    for bad in ((512, 9, 10), (0, 3, 10), (4, 3, 0)):
        with pytest.raises(ValueError):
            ops.step_output(*bad, "cpu")


def test_step_cpu_tensors_take_the_plain_version_and_do_not_count():
    args = tuple(map(_t, _random_step(3, 16, 10, 5)))
    before = ops.launches
    got = ops.lock_grant_step(*args, 5, out=torch.zeros(16, 10, dtype=bool))
    assert ops.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  lock_grant_step_ref(*args, 5).numpy())


def test_step_kernel_launch_rejects_cpu_tensors():
    args = tuple(map(_t, _random_step(3, 4, 3, 5)))
    with pytest.raises(ValueError):
        ops.lock_grant_step_cuda(*args, 5)


@pytest.mark.parametrize("n_exec,fused", [(3, True), (128, False)])
def test_engine_dispatches_by_size(monkeypatch, n_exec, fused):
    """make_step's kernel path (CPU tensors: each wrapper's plain
    version) runs the fused form up to its capacity (T*K = 6*10) and the
    chain around the sorted form above it (512*10 > 4,096), once per
    step; both give the plain path's fingerprint."""
    from golden.regenerate import fingerprint

    calls = {"step": 0, "sorted": 0}
    for name, key in (("lock_grant_step", "step"),
                      ("lock_grant_sorted", "sorted")):
        orig = getattr(ops, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    wl = make_workload(WorkloadConfig(kind="ycsb", num_txns=256,
                                      num_records=3000, num_hot=8, seed=1))
    res = {}
    for impl in ("pallas", "jnp"):
        cfg = engine.EngineConfig(protocol="orthrus", n_cc=2, n_exec=n_exec,
                                  window=2 if fused else 4, max_rounds=120,
                                  warmup_rounds=0, chunk_rounds=120,
                                  target_commits=10**9, kernel_impl=impl)
        res[impl] = engine.run_simulation(cfg, wl, device="cpu")
    steps = res["pallas"].raw["steps_executed"]
    assert calls == ({"step": steps, "sorted": 0} if fused
                     else {"step": 0, "sorted": steps})
    assert fingerprint(res["pallas"]) == fingerprint(res["jnp"])
    assert res["pallas"].commits > 0


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,R", [(256, 10, 131072), (256, 10, 40),
                                   (409, 10, 50), (512, 8, 3), (4, 3, 5)])
def test_lock_grant_step_kernel_matches_plain_on_card(T, K, R):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    args = [_t(a).to(dev) for a in _random_step(T + R, T, K, R)]
    out = ops.step_output(T, K, R, dev)
    got = ops.lock_grant_step_cuda(*args, R, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, lock_grant_step_ref(*args, R))


@pytest.mark.cuda
def test_above_the_fused_capacity_the_chain_runs_on_card():
    """512*10 entries: no fused output; the engine's chain around the
    sorted-form kernel equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    with pytest.raises(ValueError):
        ops.step_output(512, 10, 40, dev)
    host = tuple(map(_t, _random_step(11, 512, 10, 40)))
    args = tuple(a.to(dev) for a in host)
    keys, modes, pend, rel, enq, wh, rc = args
    slot = torch.arange(512, dtype=torch.int32,
                        device=dev).repeat_interleave(10)
    consts = tuple(torch.tensor(v, dtype=torch.int32, device=dev) for v in (
        lg.REQ_WRITE, lg.REQ_READ, lg.REQ_RELEASE, lg.REQ_NONE))
    got = engine.grant_chain(keys, modes, pend, rel, enq, wh[:40], rc[:40],
                             slot, consts,
                             lambda *a: ops.lock_grant_sorted(*a)[0])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), lock_grant_step_ref(*host, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2560, 4097, 65536])
def test_earlier_design_matches_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    keys, ts, kind, wh, rc = _random_round(n, n, n // 4 + 1, n // 4 + 1,
                                           past=n // 8 + 1)
    R = n // 4 + 1
    order = np.lexsort((ts, keys))
    wh_free = (wh[np.minimum(keys, R - 1)] == -1) & (keys < R)
    rcv = np.where(keys < R, rc[np.minimum(keys, R - 1)], 0).astype(np.int32)
    args = [_t(a[order]).to(dev) for a in (keys, kind, wh_free, rcv)]
    want = lock_grant_ref(*args)
    for got in (ops._lock_grant_tile(*args), ops.lock_grant_cuda(*args)):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
