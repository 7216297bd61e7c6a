"""The port's rwkv6-1.6b against the JAX package at the SMOKE config in
float32, on the same weights (``params_from_numpy``) and inputs: the
config, the time mix and channel mix, a whole prefill and three decode
steps, decode against the full forward, the serving engine token for
token, and the launcher.

Tolerances (float32, absolute): 2e-6 for the norms at the published
width (bfloat16: equal); 1e-5 for one time mix or channel mix
(projections, the decay's exp(-exp(.)) and a recurrence of up to 40
steps, summed in another order than XLA); 2e-5 for a whole prefill's
or decode step's logits and cache (two layers, as for gemma3-1b in
tests/test_torch_models.py), except the cache's state: it sums 40 and
more outer products and reaches |50|, so its f32 rounding in another
order is some ulps of its largest value, and it is held to 2e-5 or
2e-6 of the reference's largest |value|, whichever is larger (the
prefill's largest difference is 6.4e-7 of it). The
decode-matches-forward mirror keeps tests/test_models_smoke.py's 0.08
in bfloat16 and uses 1e-5 in float32. The serving engine's tokens are
equal.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rw_ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serve.engine import _splice_cache  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "rwkv6-1.6b"
IMPLS = ["jnp", "pallas"]  # "pallas" on CPU tensors: the wrapper's path


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_smoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


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


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_jax_ones(smoke):
    got = (get_smoke_config if smoke else get_config)(ARCH)
    want = (jax_smoke if smoke else jax_config)(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_params_keep_the_layouts_and_the_scan_order(model):
    jcfg, tcfg, jp, tp = model
    assert len(tp["layers"]) == tcfg.num_layers == tcfg.pattern_repeats
    d, H, hd = tcfg.d_model, tcfg.ssm_heads, tcfg.head_dim
    for r, layer in enumerate(tp["layers"]):
        assert sorted(layer) == ["cm", "ln_cm", "ln_tm", "tm"]
        assert layer["tm"]["wr"].shape == (d, H, hd)
        assert layer["tm"]["wo"].shape == (H, hd, d)
        assert layer["tm"]["wb"].shape == (64, H, hd)
        assert layer["cm"]["wk"].shape == (d, tcfg.d_ff)
        np.testing.assert_array_equal(
            layer["tm"]["u"].numpy(),
            np.asarray(jp["groups"]["l0"]["tm"]["u"][r]))


def test_init_params_matches_the_converted_shapes(model):
    _jcfg, tcfg, _jp, tp = model
    got = M.init_params(tcfg, seed=3, device="cpu")

    def shapes(tree):
        return [(tuple(t.shape), t.dtype) for t in jax.tree.leaves(tree)]

    assert shapes(got) == shapes(tp)
    again = M.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(got["layers"][1]["tm"]["wk"],
                       again["layers"][1]["tm"]["wk"])


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6), ("bfloat16", 0)])
def test_norms_at_the_published_width(dtype, atol):
    """layers.layernorm (ln_tm, ln_cm, the final norm) and rmsnorm (the
    time mix's ln_x) at rwkv6-1.6b's width, 2,048, where the statistics
    sum 32 times more terms than at SMOKE; bf16 equal, as at SMOKE in
    tests/test_torch_models.py."""
    d = get_config(ARCH).d_model
    x, w, b = (_normal(shape, seed) for shape, seed in (((2, 7, d), 50),
                                                        ((d,), 51),
                                                        ((d,), 52)))
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    tx, tw, tb = (_t(a).to(getattr(torch, dtype)) for a in (x, w, b))
    _close(L.layernorm(tx, tw, tb), JL.layernorm(jx, jw, jb), atol)
    _close(L.rmsnorm(tx, tw), JL.rmsnorm(jx, jw), atol)


def _layer(jp, tp, i):
    """Layer i's weights on both sides (the JAX leaves [R, ...] at i)."""
    return (jax.tree.map(lambda a: a[i], jp["groups"]["l0"]), tp["layers"][i])


def _mixer_inputs(tcfg, S_, seed):
    """x [2,S,D], x_prev [2,D] and a state [2,H,hd,hd], all non-zero."""
    H, hd = tcfg.ssm_heads, tcfg.head_dim
    return (_normal((2, S_, tcfg.d_model), seed),
            _normal((2, tcfg.d_model), seed + 1),
            _normal((2, H, hd, hd), seed + 2, 0.3))


@pytest.mark.parametrize("S_", [1, 13])
def test_rwkv_inputs(model, S_):
    _jcfg, tcfg, jp, tp = model
    pj, pt = _layer(jp, tp, 1)
    x, xp, _ = _mixer_inputs(tcfg, S_, 20)
    got = S._rwkv_inputs(_t(x), _t(xp), pt["tm"])
    want = jax.jit(JS._rwkv_inputs)(jnp.asarray(x), jnp.asarray(xp), pj["tm"])
    assert got[4].dtype == torch.float32
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-5)


@pytest.mark.parametrize("kernel_impl", IMPLS)
@pytest.mark.parametrize("S_", [1, 40])
def test_rwkv_timemix(model, S_, kernel_impl):
    _jcfg, tcfg, jp, tp = model
    pj, pt = _layer(jp, tp, 0)
    x, xp, st = _mixer_inputs(tcfg, S_, 30)
    out, x_last, new = S.rwkv_timemix(_t(x), _t(xp), _t(st), pt["tm"],
                                      kernel_impl=kernel_impl)
    jout, jx_last, jnew = jax.jit(JS.rwkv_timemix)(
        jnp.asarray(x), jnp.asarray(xp), jnp.asarray(st), pj["tm"])
    _close(out, jout, 1e-5)
    _close(x_last, jx_last, 0)
    _close(new, jnew, 1e-5)
    # the decode cache's call: the state written over the one passed in
    state = _t(st)
    out2, _, new2 = S.rwkv_timemix(_t(x), _t(xp), state, pt["tm"],
                                   kernel_impl=kernel_impl, state_out=state)
    assert new2 is state
    assert torch.equal(out2, out) and torch.equal(state, new)


@pytest.mark.parametrize("S_", [1, 13])
def test_rwkv_channelmix(model, S_):
    _jcfg, tcfg, jp, tp = model
    pj, pt = _layer(jp, tp, 1)
    x, xp, _ = _mixer_inputs(tcfg, S_, 40)
    out, x_last = S.rwkv_channelmix(_t(x), _t(xp), pt["cm"])
    jout, jx_last = jax.jit(JS.rwkv_channelmix)(jnp.asarray(x),
                                                 jnp.asarray(xp), pj["cm"])
    _close(out, jout, 1e-5)
    _close(x_last, jx_last, 0)


def _tokens(B, S_, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S_)).astype(
        np.int32)


def _check_cache(tc, jc, tcfg, atol):
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    np.testing.assert_array_equal(tc["pos"].numpy(), want["pos"].numpy())
    for got_l, want_l in zip(tc["layers"], want["layers"]):
        assert sorted(got_l) == sorted(want_l) == ["cm_x", "state", "tm_x"]
        for name in got_l:
            assert got_l[name].dtype == want_l[name].dtype
            tol = atol
            if name == "state":
                tol = max(atol, 2e-6 * float(want_l[name].abs().max()))
            _close(got_l[name], want_l[name], tol)


@pytest.fixture(scope="module")
def jax_run(model):
    """JAX prefill of two 40-token prompts, then three greedy decode
    steps: the tokens fed, each step's logits, the caches after prefill
    and at the end."""
    jcfg, tcfg, jp, _tp = model
    toks = _tokens(2, 40, tcfg.vocab_size, 16)
    prefill = jax.jit(lambda p, t: JM.prefill(p, jcfg, t, cache_len=48))
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    logits, cache = prefill(jp, jnp.asarray(toks))
    out = dict(logits=[logits], fed=[], cache0=jax.tree.map(np.asarray, cache))
    for _ in range(3):
        tok = np.argmax(np.asarray(logits)[:, -1], -1).astype(np.int32)[:, None]
        out["fed"].append(tok)
        logits, cache = decode(jp, cache, jnp.asarray(tok))
        out["logits"].append(logits)
    out["cache"] = cache
    return toks, out


@pytest.mark.parametrize("kernel_impl", IMPLS)
def test_prefill_and_decode_steps(model, jax_run, kernel_impl):
    _jcfg, tcfg, _jp, tp = model
    toks, ref = jax_run
    tl, tc = M.prefill(tp, tcfg, torch.from_numpy(toks).long(), cache_len=48,
                       kernel_impl=kernel_impl)
    assert tuple(tl.shape) == (2, 1, tcfg.vocab_size)
    _close(tl, ref["logits"][0], 2e-5)
    _check_cache(tc, ref["cache0"], tcfg, 2e-5)
    states = [e["state"] for e in tc["layers"]]
    for tok, jl in zip(ref["fed"], ref["logits"][1:]):
        tl, tc = M.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long(),
                               kernel_impl=kernel_impl)
        _close(tl, jl, 2e-5)
    _check_cache(tc, ref["cache"], tcfg, 2e-5)
    # updated in place
    assert all(e["state"] is s for e, s in zip(tc["layers"], states))


@pytest.mark.parametrize("dtype,atol", [("bfloat16", 0.08), ("float32", 1e-5)])
def test_decode_matches_forward(dtype, atol):
    """Mirror of tests/test_models_smoke.py::test_decode_matches_forward:
    prefill + decode logits == the full forward's, position by position."""
    cfg = _cfgs(dtype)[1]
    params = M.init_params(cfg, seed=1, device="cpu")
    tokens = torch.from_numpy(_tokens(1, 12, cfg.vocab_size, 18)).long()
    x, _ = TF.forward(params, cfg, tokens)
    full_logits = TF._lm_head(params, cfg, x)
    n_pre = 8
    _, cache = M.prefill(params, cfg, tokens[:, :n_pre], cache_len=12)
    for t in range(n_pre, 12):
        logits, cache = M.decode_step(params, cfg, cache, tokens[:, t:t + 1])
        np.testing.assert_allclose(_np(logits[0, 0]), _np(full_logits[0, t]),
                                   atol=atol, rtol=atol)


def _requests(cls, vocab):
    """Five requests over two prompt lengths (JAX compiles prefill once per
    length) and different output budgets, through two slots."""
    rng = np.random.default_rng(11)
    lens, news = (9, 14, 9, 14, 9), (4, 6, 3, 5, 7)
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
    before = (fa_ops.launches, rw_ops.launches)
    done = eng.run(_requests(Request, cfg.vocab_size))
    assert (fa_ops.launches, rw_ops.launches) == before  # CPU: plain
    assert {r.rid: r.output for r in done} == want
    assert len(want) == 5
    assert eng.stats["prefills"] == 5 and eng.stats["decode_steps"] > 0


def test_splice_cache_copies_the_rwkv_entries_into_the_slot_rows():
    cfg = _cfgs()[1]
    params = M.init_params(cfg, seed=0, device="cpu")
    batch = M.init_cache(cfg, 3, 20, "cpu")
    _, one = M.prefill(params, cfg, torch.arange(2, 9)[None], cache_len=20)
    _splice_cache(batch, one, 2, 7)
    assert batch["pos"].tolist() == [0, 0, 7]
    for b, o in zip(batch["layers"], one["layers"]):
        for name in ("tm_x", "cm_x", "state"):
            assert torch.equal(b[name][2], o[name][0])
            assert o[name][0].any()
            assert not b[name][:2].any()


def test_launch_serve_runs_rwkv_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--device", "cpu",
                              "--requests", "3", "--max-new", "4",
                              "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "tok/s" in out
    assert "flash_attention launches 0" in out
    assert "rwkv6_scan launches 0" in out
