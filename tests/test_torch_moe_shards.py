"""Per-shard MoE dispatch (``dispatch_shards`` G > 1) against the JAX
package: ``apply_moe``'s output and aux loss against
``repro.models.moe.apply_moe`` on the same params and inputs, at ample
capacity (where it also equals the one-plan and the dense mode), at a
tight capacity that drops entries, at the shard plans' floor of 32
slots (n * k / E < 1; llama4-maverick's E 128, top 1, with and without
drops), and where G does not divide the tokens (the one-plan fallback);
top 1 and top 2, swiglu and gelu. B3's grouped plan, the wrapper's CPU
path and its plain version, bit for bit the one-group plan per group and
JAX's plan vmapped over the groups; on a card the grouped launch against
the plain version (G = 1, 2, 4, 8). JAX is imported by the tests that
compare with it, so the card's test runs where JAX is missing.

Tolerances (float32, absolute): 2e-5 for ``apply_moe``'s output and
1e-6 for the aux loss, tests/test_torch_moe.py's; slot tables and counts
equal; slot weights and loads against JAX at rtol 1e-6 / atol 1e-7
(tests/test_torch_moe_dispatch.py's), against the port's own plan
exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.moe_dispatch import ops  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import (  # noqa: E402
    moe_dispatch_plan_grouped_ref,
    moe_dispatch_plan_ref,
)
from repro_torch.models import moe as MOE  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IMPLS = ["jnp", "pallas"]  # "pallas" on CPU tensors: the wrapper's path


@pytest.fixture(scope="module")
def jax_moe():
    """(jax, jax.numpy, repro.models.moe)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    return jax, jnp, pytest.importorskip("repro.models.moe")


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _params(d, ff, E, mlp_kind, seed, router="normal"):
    """numpy weights at init_moe's scales; ``router="zero"`` ties every
    expert, so every token routes to expert 0 (and 1 at top 2)."""
    s_in, s_out = 1 / np.sqrt(d), 1 / np.sqrt(ff)
    p = {"router": _normal((d, E), seed, s_in),
         "wi": _normal((E, d, ff), seed + 1, s_in),
         "wo": _normal((E, ff, d), seed + 2, s_out)}
    if mlp_kind == "swiglu":
        p["wg"] = _normal((E, d, ff), seed + 3, s_in)
    if router == "zero":
        p["router"] = np.zeros((d, E), np.float32)
    return p


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _both(jax_moe, x, p, kernel_impl, **kw):
    """(port's output and aux, JAX's) on the same inputs."""
    jax, jnp, jmoe = jax_moe
    out, aux = MOE.apply_moe(torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in p.items()},
                             kernel_impl=kernel_impl, **kw)
    jout, jaux = jax.jit(lambda x, p: jmoe.apply_moe(x, p, **kw))(
        jnp.asarray(x), p)
    return out, aux, jout, jaux


# (name, x shape [B, S, D], E, ff, top_k, capacity factor, shards, mlp,
# router, whether entries drop). "tight": 1,024 tokens over 4 experts at
# capacity factor 1.0, each shard's capacity its mean load (a multiple
# of 128), so entries drop; "floor": a shard of 64 (or 2) tokens over 128 experts plans 0
# slots an expert before the floor lifts it to 32, and the tied router
# sends all 64 to expert 0, 32 of them past capacity; "fallback": 14
# tokens, which 4 shards do not divide.
CASES = [
    ("ample", (4, 16, 32), 4, 64, 2, 8.0, 2, "swiglu", "normal", False),
    ("ample", (4, 16, 32), 4, 64, 2, 8.0, 4, "gelu", "normal", False),
    ("ample", (4, 16, 32), 4, 64, 1, 8.0, 4, "swiglu", "normal", False),
    ("tight", (2, 512, 32), 4, 64, 2, 1.0, 2, "swiglu", "normal", True),
    ("tight", (2, 512, 32), 4, 64, 2, 1.0, 4, "gelu", "normal", True),
    ("tight", (2, 512, 32), 4, 64, 1, 1.0, 2, "swiglu", "normal", True),
    ("floor", (2, 64, 32), 128, 16, 1, 1.25, 2, "swiglu", "zero", True),
    ("floor", (8, 1, 32), 128, 16, 1, 1.25, 4, "swiglu", "normal", False),
    ("floor", (8, 1, 32), 8, 64, 2, 1.25, 4, "gelu", "normal", False),
    ("fallback", (2, 7, 32), 4, 64, 2, 1.25, 4, "swiglu", "normal", None),
    ("fallback", (2, 7, 32), 4, 64, 1, 1.0, 4, "gelu", "normal", None),
]


@pytest.mark.parametrize("kernel_impl", IMPLS)
@pytest.mark.parametrize("name,shape,E,ff,k,cf,G,kind,router,drops", CASES,
                         ids=[f"{c[0]}-G{c[6]}-top{c[4]}-{c[7]}"
                              for c in CASES])
def test_apply_moe_per_shard_matches_jax(jax_moe, name, shape, E, ff, k, cf,
                                         G, kind, router, drops,
                                         kernel_impl):
    B, S, D = shape
    p = _params(D, ff, E, kind, seed=10 + G, router=router)
    x = _normal(shape, 20 + G, 0.5)
    kw = dict(top_k=k, capacity_factor=cf, mlp_kind=kind,
              dispatch_shards=G)
    before = ops.launches
    out, aux, jout, jaux = _both(jax_moe, x, p, kernel_impl, **kw)
    assert ops.launches == before  # CPU tensors never launch
    assert out.shape == (B, S, D) and out.dtype == torch.float32
    _close(out, jout, 2e-5)
    _close(aux, jaux, 1e-6)
    N = B * S
    if drops is None:  # the fallback
        assert N % G
        return
    n_loc = N // G
    cap = MOE.capacity_for(n_loc, k, E, cf, floor=32)
    if name == "floor":
        assert cap == 32 and int(cf * n_loc * k / E) == 0
    probs = torch.softmax(torch.from_numpy(x).reshape(N, D)
                          @ torch.from_numpy(p["router"]), -1)
    plan = MOE.plan_dispatch(probs.view(G, n_loc, E), k, cap)
    assert (int((plan["slot_token"] >= 0).sum()) < N * k) == drops


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_ample_shards_equal_one_plan_and_dense(G, k):
    """Mirror of tests/test_kernels.py::test_moe_per_shard_plan_matches_global:
    nothing dropped, per-shard plans compute the one plan's output and
    the dense mode's, and all three the same aux loss."""
    p = {n: torch.from_numpy(v) for n, v in
         _params(32, 64, 4, "swiglu", seed=30).items()}
    x = torch.from_numpy(_normal((4, 16, 32), 31, 0.3))
    kw = dict(top_k=k, capacity_factor=8.0)
    o1, a1 = MOE.apply_moe(x, p, **kw)
    o2, a2 = MOE.apply_moe(x, p, dispatch_shards=G, **kw)
    o3, a3 = MOE.apply_moe(x, p, mode="dense", **kw)
    _close(o2, o1.numpy(), 2e-5)
    _close(o2, o3.numpy(), 2e-5)
    assert torch.equal(a2, a1) and torch.equal(a2, a3)


def _group_probs(G, n, E, seed, ties=False):
    """f32[G, n, E]: softmax rows, or (``ties``) rows from four levels
    with a third of them all equal, so ties fall at every place."""
    rng = np.random.default_rng(seed)
    if ties:
        z = rng.integers(1, 5, (G, n, E)).astype(np.float32)
        z[:, ::3] = 1.0
    else:
        z = np.exp(rng.standard_normal((G, n, E)) * 2.0)
    return torch.from_numpy((z / z.sum(-1, keepdims=True)).astype(
        np.float32))


# (G, tokens a group, E, k, capacity): llama4's decode step at 8 slots and
# G = 4 (the floor of 32), its 3,000-token prefill at G = 8 (capacity
# 128), mixtral's shape, a capacity that drops
GROUP_GRIDS = [(4, 2, 128, 1, 32), (8, 375, 128, 1, 128), (2, 64, 8, 2, 128),
               (3, 100, 4, 2, 16), (1, 50, 8, 2, 32)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("G,n,E,k,cap", GROUP_GRIDS)
def test_grouped_plan_is_one_plan_per_group(G, n, E, k, cap, ties):
    probs = _group_probs(G, n, E, seed=G * n + E, ties=ties)
    before = ops.launches
    got = ops.moe_dispatch_plan(probs, top_k=k, capacity=cap)
    assert ops.launches == before
    plain = MOE.plan_dispatch(probs, k, cap)
    assert sorted(got) == ["count", "load", "slot_token", "slot_weight"]
    assert tuple(got["slot_token"].shape) == (G, E * cap)
    assert got["count"].dtype == torch.int32
    for f in got:
        assert torch.equal(got[f], plain[f]), f
    for g in range(G):
        want = moe_dispatch_plan_ref(probs[g], k, cap)
        for f in ("slot_token", "slot_weight", "load"):
            assert torch.equal(got[f][g], want[f]), (g, f)
        idx = torch.sort(probs[g], dim=-1, descending=True,
                         stable=True)[1][:, :k]
        assert torch.equal(got["count"][g], torch.bincount(
            idx.reshape(-1), minlength=E).to(torch.int32))
        assert int(got["count"][g].sum()) == n * k


@pytest.mark.parametrize("G,n,E,k,cap", GROUP_GRIDS)
def test_grouped_plan_matches_jax_vmapped(jax_moe, G, n, E, k, cap):
    """The JAX package vmaps its plain plan over the shards."""
    jax, jnp, jmoe = jax_moe
    probs = _group_probs(G, n, E, seed=7 * G + n)
    got = moe_dispatch_plan_grouped_ref(probs, k, cap)
    want = jax.jit(jax.vmap(lambda pr: jmoe.plan_dispatch(pr, k, cap)))(
        jnp.asarray(probs.numpy()))
    np.testing.assert_array_equal(got["slot_token"].numpy(),
                                  np.asarray(want["slot_token"]))
    for f in ("slot_weight", "load"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   rtol=1e-6, atol=1e-7)


def test_the_shard_capacity_floor():
    """A shard plans at least 32 slots an expert where one plan takes at
    least 128: llama4-maverick's decode step at 8 slots and 4 shards,
    and its 3,000-token prefill at 8."""
    assert MOE.capacity_for(2, 1, 128, 1.25, floor=32) == 32
    assert MOE.capacity_for(8, 1, 128, 1.25) == 128
    assert MOE.capacity_for(375, 1, 128, 1.25, floor=32) == 128
    assert MOE.capacity_for(512, 2, 4, 1.0, floor=32) == 256


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("n,E,k,cap,ties", [
    (2, 128, 1, 32, False), (375, 128, 1, 128, False),
    (750, 128, 1, 128, True), (1500, 8, 2, 256, True),
    (3000, 8, 2, 64, False)])
def test_grouped_launch_matches_plain_on_card(G, n, E, k, cap, ties):
    """One launch for G plans, bit for bit the plain plan of each group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    probs = _group_probs(G, n, E, seed=G + n + E, ties=ties).cuda()
    before = ops.launches
    got = ops.moe_dispatch_plan_cuda(probs, top_k=k, capacity=cap)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = moe_dispatch_plan_grouped_ref(probs, k, cap)
    for f in want:
        assert torch.equal(got[f], want[f]), f
    one = ops.moe_dispatch_plan_cuda(probs[0], top_k=k, capacity=cap)
    for f in one:
        assert torch.equal(got[f][0], one[f]), f
