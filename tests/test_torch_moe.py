"""The port's MoE path and mixtral-8x22b against the JAX package, in
float32, on the same weights (``params_from_numpy``) and inputs: the
config, ``apply_moe`` in every mode and FFN kind and on routers whose
probabilities tie (experts picked as ``jax.lax.top_k`` picks them), a
whole prefill and three decode steps at the SMOKE config, decode
against the full forward, the serving engine token for token, the
launcher, and the launcher's check that a config's weights fit the
card.

Tolerances (float32, absolute): 2e-5 for ``apply_moe`` and for a whole
prefill's or decode step's logits and cache, as for gemma3-1b in
tests/test_torch_models.py (the port sums in another order than XLA; the
routing is the same: ties break as jax.lax.top_k breaks them); the aux loss
to 1e-6. The decode-matches-forward mirror keeps
tests/test_models_smoke.py's 0.08 in bfloat16 and uses 1e-5 in float32.
The serving engine's tokens are equal.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as md_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rw_ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "mixtral-8x22b"
IMPLS = ["jnp", "pallas"]  # "pallas" on CPU tensors: the wrapper's path


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(jax_smoke(ARCH), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **kw))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(B, S_, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S_)).astype(
        np.int32)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_jax_ones(smoke):
    got = (get_smoke_config if smoke else get_config)(ARCH)
    want = (jax_smoke if smoke else jax_config)(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_params_keep_the_moe_layout_and_the_scan_order(model):
    """JAX stacks each pattern position's ``moe`` leaves [R, E, ...]; the
    port keeps one dict per layer, the router in f32."""
    _jcfg, tcfg, jp, tp = model
    assert len(tp["layers"]) == tcfg.num_layers == tcfg.pattern_repeats
    d, E, ff = tcfg.d_model, tcfg.num_experts, tcfg.expert_d_ff
    jmoe = jp["groups"]["l0"]["moe"]
    assert jmoe["wi"].shape == (tcfg.pattern_repeats, E, d, ff)
    for r, layer in enumerate(tp["layers"]):
        assert sorted(layer) == ["attn", "ln_attn", "ln_mlp", "moe"]
        p = layer["moe"]
        assert sorted(p) == ["router", "wg", "wi", "wo"]
        assert p["router"].shape == (d, E)
        assert p["wi"].shape == p["wg"].shape == (E, d, ff)
        assert p["wo"].shape == (E, ff, d)
        for name in p:
            np.testing.assert_array_equal(p[name].numpy(),
                                          np.asarray(jmoe[name][r]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_the_converted_shapes(dtype):
    """Shapes and types equal JAX's, the router f32 whatever the dtype."""
    jcfg, tcfg = _cfgs(dtype)
    jp = jax.eval_shape(lambda key: JM.init_params(jcfg, key),
                        jax.random.PRNGKey(0))
    want = params_from_numpy(
        tcfg, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jp),
        device="cpu")
    got = M.init_params(tcfg, seed=3, device="cpu")

    def shapes(tree):
        return [(tuple(t.shape), t.dtype) for t in jax.tree.leaves(tree)]

    assert shapes(got) == shapes(want)
    assert got["layers"][1]["moe"]["router"].dtype == torch.float32
    again = M.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(got["layers"][1]["moe"]["wo"],
                       again["layers"][1]["moe"]["wo"])


def _moe_params(d, ff, E, mlp_kind, shared, seed):
    """numpy weights at init_moe's scales."""
    s_in, s_out = 1 / np.sqrt(d), 1 / np.sqrt(ff)
    p = {"router": _normal((d, E), seed, s_in),
         "wi": _normal((E, d, ff), seed + 1, s_in),
         "wo": _normal((E, ff, d), seed + 2, s_out)}
    if mlp_kind in ("swiglu", "geglu"):
        p["wg"] = _normal((E, d, ff), seed + 3, s_in)
    if shared:
        p["shared"] = {"wi": _normal((d, ff), seed + 4, s_in),
                       "wo": _normal((ff, d), seed + 5, s_out)}
        if mlp_kind in ("swiglu", "geglu"):
            p["shared"]["wg"] = _normal((d, ff), seed + 6, s_in)
    return p


# (mode, capacity_factor, mlp kind, shared expert). At B*S = 512 tokens,
# E = 4 and top 2, a capacity factor of 1.0 gives capacity 256, the mean
# load, so about half the experts drop entries; 8.0 drops none.
MOE_CASES = [
    ("planned", 1.0, "swiglu", False),
    ("planned", 8.0, "swiglu", False),
    ("planned", 1.0, "swiglu", True),
    ("planned", 1.0, "geglu", False),
    ("planned", 1.0, "gelu", False),
    ("dense", 1.25, "swiglu", False),
    ("dense", 1.25, "geglu", True),
    ("dense", 1.25, "gelu", False),
]


@pytest.mark.parametrize("kernel_impl", IMPLS)
@pytest.mark.parametrize("mode,cf,kind,shared", MOE_CASES)
def test_apply_moe_matches_jax(mode, cf, kind, shared, kernel_impl):
    p = _moe_params(32, 64, 4, kind, shared, seed=10)
    x = _normal((2, 256, 32), 20)
    kw = dict(top_k=2, capacity_factor=cf, mlp_kind=kind, mode=mode)
    tp = jax.tree.map(torch.from_numpy, p)
    out, aux = MOE.apply_moe(torch.from_numpy(x), tp, kernel_impl=kernel_impl,
                             **kw)
    jout, jaux = jax.jit(lambda x, p: JMOE.apply_moe(x, p, **kw))(
        jnp.asarray(x), p)
    assert out.shape == (2, 256, 32) and out.dtype == torch.float32
    _close(out, jout, 2e-5)
    _close(aux, jaux, 1e-6)
    if mode == "planned":
        probs = torch.softmax(torch.from_numpy(x).reshape(512, 32)
                              @ tp["router"], -1)
        plan = MOE.plan_dispatch(probs, 2, MOE.capacity_for(512, 2, 4, cf))
        kept = int((plan["slot_token"] >= 0).sum())
        assert (kept < 1024) == (cf == 1.0)  # drops where they should


def _tied_router(kind, d, E, seed):
    """A router under which tokens' probabilities tie exactly (the inputs
    are in {-1, 0, 1} and the router in {0, 1}, so the logits are exact
    integers): all E equal (``zero``); experts (0, 1) and (2, 3) equal
    (``pairs``); experts 1-3 equal, so a tie at the second place or
    among the top two (``kth``)."""
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros((d, E), np.float32)
    cols = rng.integers(0, 2, (d, 2)).astype(np.float32)
    if kind == "pairs":
        return np.repeat(cols, E // 2, 1)
    return np.concatenate([cols[:, :1], np.repeat(cols[:, 1:], E - 1, 1)], 1)


@pytest.mark.parametrize("kernel_impl", IMPLS)
@pytest.mark.parametrize("mode,cf", [("dense", 1.25), ("planned", 1.0),
                                     ("planned", 8.0)])
@pytest.mark.parametrize("kind", ["zero", "pairs", "kth"])
def test_apply_moe_breaks_router_ties_as_jax(kind, mode, cf, kernel_impl):
    """Tied router probabilities pick JAX's experts (lower index first)."""
    p = _moe_params(32, 64, 4, "swiglu", False, seed=50)
    p["router"] = _tied_router(kind, 32, 4, seed=51)
    x = np.random.default_rng(52).integers(-1, 2, (2, 64, 32)).astype(
        np.float32)
    kw = dict(top_k=2, capacity_factor=cf, mlp_kind="swiglu", mode=mode)
    out, aux = MOE.apply_moe(torch.from_numpy(x),
                             jax.tree.map(torch.from_numpy, p),
                             kernel_impl=kernel_impl, **kw)
    jout, jaux = jax.jit(lambda x, p: JMOE.apply_moe(x, p, **kw))(
        jnp.asarray(x), p)
    _close(out, jout, 2e-5)
    _close(aux, jaux, 1e-6)


def test_planned_with_ample_capacity_equals_dense():
    """Mirror of tests/test_kernels.py::test_moe_per_shard_plan_matches_global:
    nothing dropped, the planned mode computes the dense one."""
    p = jax.tree.map(torch.from_numpy, _moe_params(32, 64, 4, "swiglu",
                                                   False, seed=30))
    x = torch.from_numpy(_normal((4, 16, 32), 31, 0.3))
    o1, a1 = MOE.apply_moe(x, p, top_k=2, capacity_factor=8.0)
    o2, a2 = MOE.apply_moe(x, p, top_k=2, capacity_factor=8.0, mode="dense")
    _close(o1, o2, 2e-5)
    assert torch.equal(a1, a2)


def test_weight_gather_changes_nothing_and_ample_shards_equal_one_plan():
    """``weight_gather`` is a sharding constraint; two shards' plans at a
    capacity that drops nothing compute the one plan's output (each
    token's expert rows are the same rows) and its aux loss."""
    p = jax.tree.map(torch.from_numpy, _moe_params(32, 64, 4, "swiglu",
                                                   False, seed=40))
    x = torch.from_numpy(_normal((2, 8, 32), 41))
    kw = dict(top_k=2, capacity_factor=1.25)
    o1, a1 = MOE.apply_moe(x, p, **kw)
    o2, _ = MOE.apply_moe(x, p, weight_gather=True, **kw)
    assert torch.equal(o1, o2)
    o3, a3 = MOE.apply_moe(x, p, dispatch_shards=2, **kw)
    _close(o3, o1, 2e-5)
    assert torch.equal(a3, a1)


@pytest.mark.parametrize("n_tokens,cf,want", [
    (16, 1.25, 128),      # a decode step at 8 slots, top 2 of 8
    (3000, 1.25, 1024),   # a 3,000-token mixtral prefill: 937 -> 1,024
    (512, 1.0, 256),      # exactly a multiple of 128
    (513, 1.0, 256),      # int() truncates before the round-up: 256.5,
                          # not 384
    (620, 1.25, 256),     # 193.75 -> 193 -> 256
])
def test_capacity_truncates_then_rounds_up(n_tokens, cf, want):
    E = 4 if cf == 1.0 else 8
    assert MOE.capacity_for(n_tokens, 2, E, cf) == want


def _check_cache(tc, jc, tcfg, atol):
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    np.testing.assert_array_equal(tc["pos"].numpy(), want["pos"].numpy())
    for got_l, want_l in zip(tc["layers"], want["layers"]):
        assert sorted(got_l) == sorted(want_l) == ["k", "v"]
        for name in got_l:
            _close(got_l[name], want_l[name], atol)


def _jax_run(jcfg, jp, toks, cache_len, steps=3):
    """JAX prefill, then ``steps`` greedy decode steps: the tokens fed,
    each step's logits, the caches after prefill and at the end."""
    prefill = jax.jit(lambda p, t: JM.prefill(p, jcfg, t,
                                              cache_len=cache_len))
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    logits, cache = prefill(jp, jnp.asarray(toks))
    out = dict(logits=[logits], fed=[], cache0=jax.tree.map(np.asarray, cache))
    for _ in range(steps):
        tok = np.argmax(np.asarray(logits)[:, -1], -1).astype(np.int32)[:, None]
        out["fed"].append(tok)
        logits, cache = decode(jp, cache, jnp.asarray(tok))
        out["logits"].append(logits)
    out["cache"] = cache
    return out


@pytest.mark.parametrize("kernel_impl", IMPLS)
@pytest.mark.parametrize("cf,S_", [(1.25, 40), (1.0, 128)])
def test_prefill_and_decode_steps(model, kernel_impl, cf, S_):
    """Two prompts of ``S_`` tokens, then three decode steps. At S_ = 128
    and capacity factor 1.0 the prefill plans 256 tokens at capacity 128,
    the mean load, so entries are dropped."""
    _jcfg, _tcfg, jp, tp = model
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    toks = _tokens(2, S_, tcfg.vocab_size, 16)
    ref = _jax_run(jcfg, jp, toks, cache_len=S_ + 8)
    tl, tc = M.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                       cache_len=S_ + 8, kernel_impl=kernel_impl)
    assert tuple(tl.shape) == (2, 1, tcfg.vocab_size)
    _close(tl, ref["logits"][0], 2e-5)
    _check_cache(tc, ref["cache0"], tcfg, 2e-5)
    for tok, jl in zip(ref["fed"], ref["logits"][1:]):
        tl, tc = M.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long(),
                               kernel_impl=kernel_impl)
        _close(tl, jl, 2e-5)
    _check_cache(tc, ref["cache"], tcfg, 2e-5)


@pytest.mark.parametrize("dtype,atol", [("bfloat16", 0.08), ("float32", 1e-5)])
def test_decode_matches_forward(dtype, atol):
    """Mirror of tests/test_models_smoke.py::test_decode_matches_forward:
    prefill + decode logits == the full forward's, position by position."""
    cfg = _cfgs(dtype)[1]
    params = M.init_params(cfg, seed=1, device="cpu")
    tokens = torch.from_numpy(_tokens(1, 12, cfg.vocab_size, 18)).long()
    x, aux = TF.forward(params, cfg, tokens)
    assert bool(torch.isfinite(aux))
    full = TF._lm_head(params, cfg, x)
    n_pre = 8
    _, cache = M.prefill(params, cfg, tokens[:, :n_pre], cache_len=12)
    for t in range(n_pre, 12):
        logits, cache = M.decode_step(params, cfg, cache, tokens[:, t:t + 1])
        _close(logits[0, 0], full[0, t], atol)


def _requests(cls, vocab):
    """Five requests over two prompt lengths (JAX compiles prefill once per
    length) and different output budgets, through two slots."""
    rng = np.random.default_rng(13)
    lens, news = (10, 15, 10, 15, 10), (5, 3, 6, 4, 7)
    return [cls(rid=i, prompt=rng.integers(2, vocab, size=n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


@pytest.fixture(scope="module")
def jax_outputs():
    cfg = _cfgs()[0]
    params = jax.jit(lambda key: JM.init_params(cfg, key))(
        jax.random.PRNGKey(5))
    eng = JaxEngine(cfg, JaxServeConfig(batch_slots=2, cache_len=32), params)
    done = eng.run(_requests(JaxRequest, cfg.vocab_size))
    return jax.tree.map(np.asarray, params), {r.rid: r.output for r in done}


@pytest.mark.parametrize("kernel_impl", ["auto", "jnp", "pallas"])
def test_serving_engine_matches_jax_token_for_token(jax_outputs, kernel_impl):
    tree, want = jax_outputs
    cfg = _cfgs()[1]
    params = params_from_numpy(cfg, tree, device="cpu")
    eng = ServingEngine(cfg, ServeConfig(batch_slots=2, cache_len=32), params,
                        device="cpu", kernel_impl=kernel_impl)
    before = (fa_ops.launches, rw_ops.launches, md_ops.launches)
    done = eng.run(_requests(Request, cfg.vocab_size))
    # CPU tensors: every wrapper takes its plain version
    assert (fa_ops.launches, rw_ops.launches, md_ops.launches) == before
    assert {r.rid: r.output for r in done} == want
    assert len(want) == 5
    assert eng.stats["prefills"] == 5 and eng.stats["decode_steps"] > 0


def test_launch_serve_runs_mixtral_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--device", "cpu",
                              "--requests", "3", "--max-new", "4",
                              "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "tok/s" in out
    assert "moe_dispatch launches 0" in out


@pytest.mark.parametrize("repeats,fits", [(56, False), (8, True)])
def test_launcher_checks_the_weights_fit_the_card(repeats, fits):
    """The full config's 281 GB of bf16 weights do not fit an 80 GB card;
    the 8-layer cut's 40.9 GB do. Checked before anything is allocated."""
    cfg = dataclasses.replace(get_config(ARCH), pattern_repeats=repeats)
    free = 80 * 10**9
    if fits:
        launch_serve.check_fits(cfg, free)
        launch_serve.check_fits(get_smoke_config(ARCH), free)
    else:
        with pytest.raises(RuntimeError, match="four-card distribution"):
            launch_serve.check_fits(cfg, free)
