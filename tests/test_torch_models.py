"""The port's gemma3-1b model against ``repro.models`` at the SMOKE config
in float32, on the same weights (``params_from_numpy``) and inputs.

Tolerances (float32, absolute): 1e-6 for the norms, RoPE and the MLP
(one op each; the two frameworks round single ops alike), 1e-5 for one
attention call, 2e-5 for a whole prefill's or decode step's logits and
cache (five layers; the port sums in another order than XLA). The
decode-matches-forward mirror keeps tests/test_models_smoke.py's 0.08
in bfloat16 and uses 1e-5 in float32.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import cache_from_numpy, params_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "gemma3-1b"
F32 = dict(dtype="float32")


def _cfgs(**kw):
    return (dataclasses.replace(jax_smoke(ARCH), **F32, **kw),
            dataclasses.replace(get_smoke_config(ARCH), **F32, **kw))


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


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_params_keep_the_einsum_layouts_and_the_scan_order(model):
    jcfg, tcfg, jp, tp = model
    R, P = tcfg.pattern_repeats, len(tcfg.pattern)
    assert len(tp["layers"]) == tcfg.num_layers == R * P + len(tcfg.tail)
    d, nq, nkv, hd = (tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads,
                      tcfg.head_dim)
    for r in range(R):
        for i in range(P):
            attn = tp["layers"][r * P + i]["attn"]
            assert attn["wq"].shape == (d, nq, hd)
            assert attn["wk"].shape == (d, nkv, hd)
            assert attn["wo"].shape == (nq, hd, d)
            np.testing.assert_array_equal(
                attn["wq"].numpy(),
                np.asarray(jp["groups"][f"l{i}"]["attn"]["wq"][r]))
    np.testing.assert_array_equal(
        tp["layers"][-1]["mlp"]["wg"].numpy(),
        np.asarray(jp["tail"]["l0"]["mlp"]["wg"]))


def test_init_params_matches_the_converted_shapes(model):
    _jcfg, tcfg, _jp, tp = model
    got = M.init_params(tcfg, seed=3, device="cpu")

    def shapes(tree):
        return [(tuple(t.shape), t.dtype)
                for t in jax.tree.leaves(tree)]

    assert shapes(got) == shapes(tp)
    again = M.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(got["layers"][0]["attn"]["wq"],
                       again["layers"][0]["attn"]["wq"])


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6), ("bfloat16", 0)])
def test_rmsnorm_and_layernorm(dtype, atol):
    x = _normal((2, 5, 64), 0)
    w = _normal((64,), 1)
    b = _normal((64,), 2)
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    tx, tw, tb = (_t(a).to(getattr(torch, dtype)) for a in (x, w, b))
    # bf16: the f32 statistics round to the same bf16 values
    _close(L.rmsnorm(tx, tw), JL.rmsnorm(jx, jw), atol)
    _close(L.layernorm(tx, tw, tb), JL.layernorm(jx, jw, jb),
           max(atol, 2e-6))


@pytest.mark.parametrize("frac", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(frac, theta):
    x = _normal((2, 7, 3, 32), 3)
    pos = np.random.default_rng(4).integers(0, 4096, (2, 7)).astype(np.int32)
    got = L.apply_rope(_t(x), torch.from_numpy(pos), theta, frac)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, frac)
    # angles up to 4,096 rad: cos/sin of f32 arguments differ in the last
    # place between the two libraries
    _close(got, want, 2e-6)


@pytest.mark.parametrize("kind", ["geglu", "swiglu", "gelu", "relu2"])
def test_apply_mlp(kind):
    x = _normal((2, 5, 64), 5)
    p = {"wi": _normal((64, 128), 6, 0.1), "wo": _normal((128, 64), 7, 0.1),
         "wg": _normal((64, 128), 8, 0.1)}
    got = L.apply_mlp(kind, _t(x), {k: _t(v) for k, v in p.items()})
    want = JL.apply_mlp(kind, jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in p.items()})
    _close(got, want, 1e-6)


@pytest.mark.parametrize("layer", [0, 1])  # swa, full (global theta)
@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_self_attention(model, layer, kernel_impl):
    jcfg, tcfg, jp, tp = model
    spec_t = TF.attn_spec(tcfg, tcfg.pattern[layer])
    spec_j = JTF.attn_spec(jcfg, jcfg.pattern[layer])
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    x = _normal((2, 40, tcfg.d_model), 9)
    pj = jax.tree.map(lambda a: a[0], jp["groups"][f"l{layer}"]["attn"])
    out, (k, v) = L.self_attention(_t(x), tp["layers"][layer]["attn"], spec_t,
                                   kernel_impl=kernel_impl)
    jout, (jk, jv) = jax.jit(JL.self_attention, static_argnums=2)(
        jnp.asarray(x), pj, spec_j)
    _close(out, jout, 1e-5)
    _close(k, jk, 1e-5)
    _close(v, jv, 1e-5)


@pytest.mark.parametrize("kind,window", [("full", 0), ("swa", 16),
                                         ("chunked", 16)])
@pytest.mark.parametrize("S", [40, 64, 37])
def test_attend_blocked(kind, window, S):
    """JAX halves its query block until it divides S; the port's last
    block is ragged. Same function."""
    spec = dict(num_heads=2, num_kv_heads=1, head_dim=32, kind=kind,
                window=window, q_block=16)
    q, k, v = (_normal((2, S, h, 32), s, 0.3) for s, h in ((10, 2), (11, 1),
                                                           (12, 1)))
    got = L._attend_blocked(_t(q), _t(k), _t(v), L.AttnSpec(**spec))
    want = jax.jit(JL._attend_blocked, static_argnums=3)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JL.AttnSpec(**spec))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind,window", [("full", 0), ("swa", 16),
                                         ("chunked", 16)])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention(model, kind, window, ring):
    jcfg, tcfg, jp, tp = model
    B, clen = 3, 16 if ring else 48
    spec = dict(num_heads=2, num_kv_heads=1, head_dim=32, kind=kind,
                window=window, qk_norm=True)
    p = tp["layers"][0]["attn"]
    pj = jax.tree.map(lambda a: a[0], jp["groups"]["l0"]["attn"])
    x = _normal((B, 1, tcfg.d_model), 13)
    ck = _normal((B, clen, 1, 32), 14, 0.3)
    cv = _normal((B, clen, 1, 32), 15, 0.3)
    pos = np.array([5, 30, 47], np.int32)
    kw = {}
    if ring:
        # slots hold positions pos-clen+1 .. pos-1 (one slot unwritten)
        kpos = np.full((B, clen), -1, np.int32)
        for b in range(B):
            for t in range(max(0, pos[b] - clen + 1), pos[b]):
                kpos[b, t % clen] = t
        kw = dict(cache_kpos=kpos)
    tk, tv = _t(ck), _t(cv)
    tkpos = torch.from_numpy(kw["cache_kpos"].copy()) if ring else None
    out = L.decode_attention(_t(x), p, L.AttnSpec(**spec), tk, tv,
                             torch.from_numpy(pos), ring=ring,
                             cache_kpos=tkpos)
    res = jax.jit(JL.decode_attention, static_argnums=(2, 6))(
        jnp.asarray(x), pj, JL.AttnSpec(**spec), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(pos), ring,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    _close(out, res[0], 1e-5)
    _close(tk, res[1], 1e-6)  # updated in place
    _close(tv, res[2], 1e-6)
    if ring:
        np.testing.assert_array_equal(tkpos.numpy(), np.asarray(res[3]))


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _check_cache(tc, jc, tcfg, atol):
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    np.testing.assert_array_equal(tc["pos"].numpy(), want["pos"].numpy())
    for got_l, want_l in zip(tc["layers"], want["layers"]):
        assert got_l.keys() == want_l.keys()
        for name in got_l:
            _close(got_l[name], want_l[name], atol)


def _jax_run(jcfg, jp, toks, steps, cache_len=48):
    """JAX prefill, then ``steps`` greedy decode steps: the tokens fed,
    each step's logits, and the caches after prefill and at the end."""
    prefill = jax.jit(lambda p, t: JM.prefill(p, jcfg, t, cache_len=cache_len))
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


@pytest.fixture(scope="module")
def jax_run(model):
    jcfg, tcfg, jp, _tp = model
    toks = _tokens(2, 40, tcfg.vocab_size, 16)
    return toks, _jax_run(jcfg, jp, toks, steps=4)


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_prefill_and_decode_steps(model, jax_run, kernel_impl):
    _jcfg, tcfg, _jp, tp = model
    toks, ref = jax_run
    tl, tc = M.prefill(tp, tcfg, torch.from_numpy(toks).long(), cache_len=48,
                       kernel_impl=kernel_impl)
    assert tuple(tl.shape) == (2, 1, tcfg.vocab_size)
    _close(tl, ref["logits"][0], 2e-5)
    _check_cache(tc, ref["cache0"], tcfg, 2e-5)
    for tok, jl in zip(ref["fed"], ref["logits"][1:]):
        tl, tc = M.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long())
        _close(tl, jl, 2e-5)
    _check_cache(tc, ref["cache"], tcfg, 2e-5)


def test_ring_cache_prefill_and_decode(model):
    """``swa_ring_cache``: the local layers keep a window-long ring; the
    prompt (40) is longer than the window (16), so it wraps."""
    _jcfg, _tcfg, jp, tp = model
    jcfg, tcfg = _cfgs(swa_ring_cache=True)
    toks = _tokens(1, 40, tcfg.vocab_size, 17)
    ref = _jax_run(jcfg, jp, toks, steps=3)
    tl, tc = M.prefill(tp, tcfg, torch.from_numpy(toks).long(), cache_len=48)
    assert tc["layers"][0]["k"].shape[1] == tcfg.window
    _close(tl, ref["logits"][0], 2e-5)
    _check_cache(tc, ref["cache0"], tcfg, 2e-5)
    for tok, jl in zip(ref["fed"], ref["logits"][1:]):
        tl, tc = M.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long())
        _close(tl, jl, 2e-5)
    _check_cache(tc, ref["cache"], tcfg, 2e-5)


@pytest.mark.parametrize("dtype,atol", [("bfloat16", 0.08), ("float32", 1e-5)])
def test_decode_matches_forward(dtype, atol):
    """Mirror of tests/test_models_smoke.py::test_decode_matches_forward:
    prefill + decode logits == the full forward's, position by position."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
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
