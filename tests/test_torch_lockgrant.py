"""The port's lock-grant primitives and lock_grant wrapper against the
JAX reference (integers: tolerance 0)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import lockgrant as ref_lg  # noqa: E402
from repro.kernels.lock_grant.ops import lock_grant as ref_lock_grant  # noqa: E402
from repro_torch.core import lockgrant as lg  # noqa: E402
from repro_torch.kernels import _build, use_kernel  # noqa: E402
from repro_torch.kernels.lock_grant import ops  # noqa: E402
from repro_torch.kernels.lock_grant.ref import lock_grant_ref  # noqa: E402

KINDS = [lg.REQ_READ, lg.REQ_WRITE, lg.REQ_RELEASE, lg.REQ_NONE]


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
    assert lg.KEY_SENTINEL == int(ref_lg.KEY_SENTINEL)
    for name in ("REQ_READ", "REQ_WRITE", "REQ_RELEASE", "REQ_NONE"):
        assert getattr(lg, name) == getattr(ref_lg, name)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [1, 7, 40, 333])
def test_grant_round_matches_reference(seed, n):
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
