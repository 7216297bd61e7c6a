"""The port's moe_dispatch (kernel B3) against the JAX package: the
sorted form's plain version against the JAX oracle and the Pallas kernel
in interpret mode; the port's plan (``moe_dispatch_plan``, whose CPU path
is the plain plan) and ``plan_dispatch`` against JAX's two plans, on rows
with ties too (the port's top-k breaks them as ``jax.lax.top_k`` does);
the fused kernel's rule, written out in numpy, against the plain plan;
the wrappers' CPU paths and argument checks; and (on a card) both
kernels against their plain versions, bit for bit. The JAX package is
imported by the tests that compare with it, so the card's tests run
where JAX is not installed.

Tolerances: positions, keep-masks, expert ids and slot tokens are
integers and equal; slot weights and loads against JAX at
tests/test_kernels.py's rtol 1e-6 / atol 1e-7 (both sides divide the
same f32 top-k weights by the same sum; XLA may multiply by a
reciprocal where the port divides); the numpy rule and the card's
kernel against the plain plan exactly (the same f32 operations).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import dispatch_positions_ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402

SIZES = [1, 16, 1000, 1024, 3000, 6000]
_I32_MAX = 2**31 - 1
# test_kernels.py's three grids, mixtral's (E 8, top 2) at a 3,000-token
# prefill and at a decode step of 8 slots: (N tokens, E, k, capacity)
GRIDS = [(512, 8, 2, 128), (1000, 16, 1, 64), (2048, 4, 2, 640),
         (3000, 8, 2, 1024), (8, 8, 2, 128), (3000, 8, 2, 640)]


def _sorted_ids(n, num_experts, seed):
    """int32[n]: sorted random expert ids, then about n/8 trailing -1."""
    rng = np.random.default_rng(seed)
    m = n - n // 8
    return np.concatenate([np.sort(rng.integers(0, num_experts, m)),
                           np.full(n - m, -1)]).astype(np.int32)


def _capacity(ids, drop, num_experts=8):
    """A capacity that drops entries (half the mean run; 0 where that is
    below 1) or none (every entry, as far as the slots stay in int32)."""
    m = int((ids >= 0).sum())
    return m // (2 * num_experts) if drop else min(m, _I32_MAX // num_experts)


def _probs(N, E, seed):
    """f32[N, E] router probabilities: a softmax of normal logits (no
    ties, so torch's and JAX's top-k agree)."""
    z = np.random.default_rng(seed).standard_normal((N, E)) * 2.0
    z = np.exp(z - z.max(-1, keepdims=True))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


# more plan grids: one token; llama4-maverick's E = 128, top 1; no expert
# reaching its capacity; every expert past it (N tokens, E, k, capacity)
MORE_GRIDS = [(1, 8, 2, 128), (3000, 128, 1, 128), (512, 8, 2, 1024),
              (4096, 4, 2, 64)]
TIES = ["equal", "pairs", "kth"]


def _tied_probs(N, E, k, kind, seed):
    """f32[N, E] probabilities with ties: every row equal (``equal``);
    each value held by two experts (``pairs``); distinct values but the
    k-th and (k+1)-th largest equal (``kth``). Every fourth row is a
    softmax of normal logits, as ``_probs``."""
    rng = np.random.default_rng(seed)
    if kind == "equal":
        z = np.ones((N, E))
    elif kind == "pairs":
        z = np.repeat(rng.integers(1, 1000, (N, (E + 1) // 2)), 2, 1)[:, :E]
        z = np.take_along_axis(z, rng.permuted(np.tile(np.arange(E), (N, 1)),
                                               axis=1), 1)
    else:
        z = rng.permutation(np.arange(1, E + 1))[None].repeat(N, 0) * 1.0
        z = rng.permuted(z, axis=1)
        order = np.argsort(-z, 1)
        if k < E:
            rows = np.arange(N)
            z[rows, order[:, k]] = z[rows, order[:, k - 1]]
    z = z.astype(np.float32)
    p = z / z.sum(-1, keepdims=True)
    p[::4] = _probs(len(p[::4]), E, seed + 1)
    return p.astype(np.float32)


@pytest.fixture(scope="module")
def jax_dispatch():
    """(the JAX oracle, the Pallas kernel in interpret mode, JAX's plain
    plan, JAX's kernel-backed plan)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    kernel = pytest.importorskip("repro.kernels.moe_dispatch.kernel")
    ref = pytest.importorskip("repro.kernels.moe_dispatch.ref")
    jops = pytest.importorskip("repro.kernels.moe_dispatch.ops")
    jmoe = pytest.importorskip("repro.models.moe")

    def oracle(ids, cap):
        pos, keep = jax.jit(ref.dispatch_positions_ref,
                            static_argnums=1)(jnp.asarray(ids), cap)
        return np.asarray(pos), np.asarray(keep)

    def interpret(ids, cap, block_n=1024):
        n = len(ids)
        padded = np.concatenate([ids, np.full((-n) % block_n, -1, np.int32)])
        pos, keep = kernel.dispatch_positions_kernel(
            jnp.asarray(padded), capacity=cap, block_n=block_n,
            interpret=True)
        return np.asarray(pos)[:n], np.asarray(keep)[:n]

    def plain_plan(probs, k, cap):
        return jax.jit(jmoe.plan_dispatch, static_argnums=(1, 2))(
            jnp.asarray(probs), k, cap)

    def kernel_plan(probs, k, cap):
        return jops.moe_dispatch_plan(jnp.asarray(probs), top_k=k,
                                      capacity=cap, block_n=256,
                                      interpret=True)

    return oracle, interpret, plain_plan, kernel_plan


def _ref(ids, cap):
    pos, keep = dispatch_positions_ref(torch.from_numpy(ids), cap)
    assert pos.dtype == torch.int32 and keep.dtype == torch.bool
    return pos.numpy(), keep.numpy()


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_plain_version_matches_oracle_and_pallas_interpret(jax_dispatch, n,
                                                           drop):
    oracle, interpret, _, _ = jax_dispatch
    ids = _sorted_ids(n, 8, seed=n)
    cap = _capacity(ids, drop)
    pos, keep = _ref(ids, cap)
    for want_pos, want_keep in (oracle(ids, cap), interpret(ids, cap)):
        np.testing.assert_array_equal(pos, want_pos)
        np.testing.assert_array_equal(keep, want_keep)
    assert keep.sum() < (ids >= 0).sum() if drop else keep.sum() == (
        ids >= 0).sum()


@pytest.mark.parametrize("n,seed", [(7, 0), (1000, 1), (2500, 2)])
def test_plain_version_counts_runs_on_any_input(jax_dispatch, n, seed):
    """Unsorted ids with padding inside: positions by runs of equal ids,
    as the Pallas kernel gives them (block_n 256: runs cross blocks)."""
    oracle, interpret, _, _ = jax_dispatch
    rng = np.random.default_rng(seed)
    ids = np.repeat(rng.integers(-1, 3, n), rng.integers(1, 400, n))[:n]
    ids = ids.astype(np.int32)
    pos, keep = _ref(ids, 150)
    for want_pos, want_keep in (oracle(ids, 150),
                                interpret(ids, 150, block_n=256)):
        np.testing.assert_array_equal(pos, want_pos)
        np.testing.assert_array_equal(keep, want_keep)


def _check_plan(got, want):
    np.testing.assert_array_equal(got["slot_token"].numpy(),
                                  np.asarray(want["slot_token"]))
    for f in ("slot_weight", "load"):
        assert got[f].dtype == torch.float32
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("port", ["moe_dispatch_plan", "plan_dispatch"])
@pytest.mark.parametrize("N,E,k,cap", GRIDS)
def test_plans_match_jax(jax_dispatch, N, E, k, cap, port):
    """The port's two plans against both of JAX's, slot tokens equal."""
    _, _, plain_plan, kernel_plan = jax_dispatch
    probs = _probs(N, E, seed=N + E)
    if port == "moe_dispatch_plan":
        got = ops.moe_dispatch_plan(torch.from_numpy(probs), top_k=k,
                                    capacity=cap)
    else:
        got = moe.plan_dispatch(torch.from_numpy(probs), k, cap)
    assert got["slot_token"].dtype == torch.int32
    assert tuple(got["slot_token"].shape) == (E * cap,)
    for want in (plain_plan(probs, k, cap), kernel_plan(probs, k, cap)):
        _check_plan(got, want)


def _port_plan(port, probs, k, cap):
    p = torch.from_numpy(probs)
    if port == "moe_dispatch_plan":
        return ops.moe_dispatch_plan(p, top_k=k, capacity=cap)
    return moe.plan_dispatch(p, k, cap)


@pytest.mark.parametrize("port", ["moe_dispatch_plan", "plan_dispatch"])
@pytest.mark.parametrize("N,E,k,cap", MORE_GRIDS)
def test_plans_match_jax_on_more_grids(jax_dispatch, N, E, k, cap, port):
    _, _, plain_plan, kernel_plan = jax_dispatch
    probs = _probs(N, E, seed=N + E + k)
    got = _port_plan(port, probs, k, cap)
    counts = np.bincount(np.argsort(-probs, 1, kind="stable")[:, :k].ravel(),
                         minlength=E)
    if cap == 1024:
        assert counts.max() < cap  # no expert reaches its capacity
    if cap == 64:
        assert counts.min() > cap  # every expert drops entries
    for want in (plain_plan(probs, k, cap), kernel_plan(probs, k, cap)):
        _check_plan(got, want)


@pytest.mark.parametrize("port", ["moe_dispatch_plan", "plan_dispatch"])
@pytest.mark.parametrize("kind", TIES)
@pytest.mark.parametrize("N,E,k,cap", [(512, 8, 2, 128), (64, 8, 2, 128),
                                       (300, 4, 2, 64), (200, 128, 1, 128),
                                       (1000, 16, 1, 64)])
def test_plans_match_jax_on_ties(jax_dispatch, N, E, k, cap, kind, port):
    """Tied probabilities: the same experts, slots and loads as JAX's."""
    _, _, plain_plan, kernel_plan = jax_dispatch
    probs = _tied_probs(N, E, k, kind, seed=N + E)
    got = _port_plan(port, probs, k, cap)
    for want in (plain_plan(probs, k, cap), kernel_plan(probs, k, cap)):
        _check_plan(got, want)


@pytest.mark.parametrize("kind", TIES)
@pytest.mark.parametrize("E,k", [(8, 2), (4, 2), (128, 1), (8, 3), (4, 4)])
def test_route_breaks_ties_as_jax_top_k(kind, E, k):
    jax = pytest.importorskip("jax")
    probs = _tied_probs(100, E, k, kind, seed=E + k)
    w, eidx = moe.route(torch.from_numpy(probs), k)
    jw, jidx = jax.lax.top_k(probs, k)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jidx))
    jw = np.asarray(jw)
    np.testing.assert_allclose(w.numpy(), jw / np.maximum(
        jw.sum(-1, keepdims=True), 1e-9), rtol=1e-6, atol=1e-7)


def _fused_rule(probs, k, cap):
    """The fused kernel's rule in numpy, token by token: the top-k by an
    insertion with a strict ``>`` over the experts in ascending order;
    an entry's position = its expert's count over the earlier tokens;
    the rest of the table -1 / 0; load = count / (N * k)."""
    N, E = probs.shape
    slot_token = np.full(E * cap, -1, np.int32)
    slot_weight = np.zeros(E * cap, np.float32)
    count = np.zeros(E, np.int64)
    for t in range(N):
        top = []  # (value, expert), value descending
        for x in range(E):
            v = probs[t, x]
            at = next((j for j, (u, _) in enumerate(top) if v > u), len(top))
            top.insert(at, (v, x))
            del top[k:]
        total = top[0][0]
        for v, _ in top[1:]:
            total = np.float32(total + v)
        den = np.maximum(total, np.float32(1e-9))
        for v, x in top:
            if count[x] < cap:
                slot_token[x * cap + count[x]] = t
                slot_weight[x * cap + count[x]] = v / den
            count[x] += 1
    load = count.astype(np.float32) / np.float32(N * k)
    return slot_token, slot_weight, load


@pytest.mark.parametrize("kind", ["normal"] + TIES)
@pytest.mark.parametrize("N,E,k,cap", [(1, 8, 2, 128), (300, 8, 2, 64),
                                       (257, 4, 2, 256), (100, 128, 1, 128),
                                       (90, 16, 3, 8)])
def test_fused_rule_equals_the_plain_plan(N, E, k, cap, kind):
    """The kernel's rule (no sort: per-expert prefix counts) computes the
    plain plan bit for bit."""
    probs = (_probs(N, E, seed=N) if kind == "normal"
             else _tied_probs(N, E, k, kind, seed=N))
    got = moe.plan_dispatch(torch.from_numpy(probs), k, cap)
    for name, want in zip(("slot_token", "slot_weight", "load"),
                          _fused_rule(probs, k, cap)):
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)


def test_capacity_binds_on_the_drop_grid():
    """(3000, 8, 2, 640) drops entries; every kept entry is in the table."""
    probs = torch.from_numpy(_probs(3000, 8, seed=3008))
    plan = ops.moe_dispatch_plan(probs, top_k=2, capacity=640)
    kept = int((plan["slot_token"] >= 0).sum())
    assert 0 < kept < 6000
    per_expert = (plan["slot_token"].reshape(8, 640) >= 0).sum(1)
    want = torch.minimum(torch.round(plan["load"] * 6000), torch.tensor(640.))
    assert torch.equal(per_expert.float(), want)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    ids = torch.from_numpy(_sorted_ids(3000, 8, seed=5))
    before = ops.launches
    pos, keep, slot = ops.dispatch_positions(ids, 200, 8)
    ops.moe_dispatch_plan(torch.from_numpy(_probs(64, 8, 1)), top_k=2,
                          capacity=128)
    assert ops.launches == before
    want_pos, want_keep = dispatch_positions_ref(ids, 200)
    assert torch.equal(pos, want_pos) and torch.equal(keep, want_keep)
    assert torch.equal(slot, torch.where(want_keep, ids * 200 + want_pos,
                                         1600))
    assert slot.dtype == torch.int32


@pytest.mark.parametrize("case", ["float64", "bfloat16", "1-D", "3-D",
                                  "4-D", "not contiguous", "top_k above E",
                                  "top_k 0", "top_k above the limit",
                                  "E above the limit", "negative capacity",
                                  "slots past int32"])
def test_plan_bad_arguments_raise(case):
    """The plan wrapper's checks, on the CPU path as on the card's."""
    probs, k, cap = torch.from_numpy(_probs(16, 8, 0)), 2, 128
    if case in ("float64", "bfloat16"):
        probs = probs.to(getattr(torch, case))
    elif case == "1-D":
        probs = probs.reshape(-1)
    elif case == "3-D":  # grouped plans, but no group
        probs = probs.reshape(1, 16, 8)[:0]
    elif case == "4-D":
        probs = probs.reshape(2, 1, 8, 8)
    elif case == "not contiguous":
        probs = torch.from_numpy(_probs(8, 16, 0)).t()
    elif case == "top_k above E":
        k = 9
    elif case == "top_k 0":
        k = 0
    elif case == "top_k above the limit":
        probs, k = torch.from_numpy(_probs(16, 32, 0)), ops.MAX_TOP_K + 1
    elif case == "E above the limit":
        probs = torch.from_numpy(_probs(16, ops.MAX_EXPERTS + 1, 0))
    elif case == "negative capacity":
        cap = -1
    else:
        cap = 2**28
    with pytest.raises((TypeError, ValueError)):
        ops.moe_dispatch_plan(probs, top_k=k, capacity=cap)
    with pytest.raises((TypeError, ValueError)):
        ops.moe_dispatch_plan_cuda(probs, top_k=k, capacity=cap)


def test_plan_limits_take_the_repo_configs():
    """mixtral's E 8 top 2, llama4-maverick's E 128 top 1, the SMOKE E 4
    pass the checks, as does the largest E."""
    for n, E, k in ((8, 8, 2), (8, 128, 1), (8, 4, 2),
                    (8, ops.MAX_EXPERTS, ops.MAX_TOP_K)):
        plan = ops.moe_dispatch_plan(torch.from_numpy(_probs(n, E, 1)),
                                     top_k=k, capacity=128)
        assert tuple(plan["slot_token"].shape) == (E * 128,)


def test_plan_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ops.moe_dispatch_plan_cuda(torch.from_numpy(_probs(8, 8, 0)),
                                   top_k=2, capacity=128)


@pytest.mark.parametrize("case", ["int64", "2-D", "negative capacity",
                                  "slots past int32"])
def test_bad_arguments_raise(case):
    ids, cap, n_exp = torch.zeros(8, dtype=torch.int32), 4, 8
    if case == "int64":
        ids = ids.long()
    elif case == "2-D":
        ids = ids.reshape(2, 4)
    elif case == "negative capacity":
        cap = -1
    else:
        cap = 2**30
    with pytest.raises((TypeError, ValueError)):
        ops.dispatch_positions(ids, cap, n_exp)


def test_kernel_launch_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ops.dispatch_positions_cuda(torch.zeros(8, dtype=torch.int32), 4, 8)


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
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("n", [1, 16, 1023, 1024, 1025, 6000, 65536,
                               1 << 20])
def test_moe_dispatch_kernel_matches_plain_on_card(n, drop):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for num_experts in (8, 4096):
        ids = torch.from_numpy(_sorted_ids(n, num_experts, seed=n)).cuda()
        cap = _capacity(ids.cpu().numpy(), drop, num_experts)
        before = ops.launches
        got = ops.dispatch_positions_cuda(ids, cap, num_experts)
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        pos, keep = dispatch_positions_ref(ids, cap)
        assert torch.equal(got[0], pos) and torch.equal(got[1], keep)
        assert torch.equal(got[2], torch.where(keep, ids * cap + pos,
                                               num_experts * cap))


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,k,cap", GRIDS)
def test_plans_match_on_card(N, E, k, cap):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    probs = torch.from_numpy(_probs(N, E, seed=N + E)).cuda()
    got = ops.moe_dispatch_plan(probs, top_k=k, capacity=cap)
    want = moe.plan_dispatch(probs, k, cap)
    for f in ("slot_token", "slot_weight", "load"):
        assert torch.equal(got[f], want[f]), f


def _card_probs(N, E, k, kind, seed):
    probs = (_probs(N, E, seed) if kind == "normal"
             else _tied_probs(N, E, k, kind, seed))
    return torch.from_numpy(probs).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal"] + TIES)
@pytest.mark.parametrize("N,E,k,cap", GRIDS + MORE_GRIDS + [
    (65536, 8, 2, 20480), (1025, 256, 1, 64)])
def test_fused_plan_matches_plain_on_card(N, E, k, cap, kind):
    """One launch of the fused kernel (one block up to 255 tokens, a
    cluster of up to 8 above, in passes above 8,192), bit for bit the
    plain plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    probs = _card_probs(N, E, k, kind, seed=N + E)
    before = ops.launches
    got = ops.moe_dispatch_plan_cuda(probs, top_k=k, capacity=cap)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = moe.plan_dispatch(probs, k, cap)
    for f in ("slot_token", "slot_weight", "load"):
        assert torch.equal(got[f], want[f]), f


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,k,cap", [(3000, 8, 2, 1024), (8, 8, 2, 128)])
def test_chain_matches_plain_on_card(N, E, k, cap):
    """The eager chain around the sorted form, as timed in chip_smoke."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    probs = _card_probs(N, E, k, "kth", seed=N)
    got = ops.moe_dispatch_chain(probs, top_k=k, capacity=cap)
    want = moe.plan_dispatch(probs, k, cap)
    for f in ("slot_token", "slot_weight", "load"):
        assert torch.equal(got[f], want[f]), f
