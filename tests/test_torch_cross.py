"""The port's cross-attention, whisper encoder and learned positions, and
whisper-tiny and llama-3.2-vision-11b whole, against ``repro.models`` and
``repro.serve`` at the SMOKE configs in float32, on the same weights
(``params_from_numpy`` of the JAX ``init_params`` tree) and inputs.

llama-3.2-vision's ``cross_gate`` starts at 0, and ``tanh(0) * o`` is
exactly 0: a wrong cross-attention would pass every comparison. So the
numpy tree sets every gate to 0.5 before it reaches both packages, and a
test checks that the vision embeddings then move the logits. Whisper's
cross-attention is ungated. The reference's encoder asks for "bidir"
attention, which its mask makes causal; the port computes the same, and a
test shows the causality in both.

Tolerance (float32, absolute): 1e-5, the value of the earlier model
slices; 1e-6 for one cross-attention call.
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
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
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


ARCHS = ("whisper-tiny", "llama-3.2-vision-11b")
ATOL = 1e-5
GATE = 0.5


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _extras(cfg, B, seed):
    """The stub frontends' outputs, numpy, unit normal."""
    out = {}
    if cfg.vision_tokens:
        out["vision_embeds"] = _normal((B, cfg.vision_tokens, cfg.d_model),
                                       seed)
    if cfg.audio_frames:
        out["audio_frames"] = _normal((B, cfg.audio_frames, cfg.d_model),
                                      seed + 1)
    return out


def _open_gates(tree):
    """Every ``cross_gate`` leaf set to GATE, in place."""
    for part in ("groups", "tail"):
        for layer in tree.get(part, {}).values():
            if "cross_gate" in layer:
                layer["cross_gate"] = np.full_like(layer["cross_gate"], GATE)
    return tree


def _model(arch, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(seed))
    tree = _open_gates(jax.tree.map(np.asarray, jp))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tcfg, tree, "cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return request.param, _model(request.param)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_cross_attention_and_its_cached_form(qk_norm, heads):
    nq, nkv = heads
    spec = dict(num_heads=nq, num_kv_heads=nkv, head_dim=16, qk_norm=qk_norm,
                use_rope=False)
    p = {"wq": _normal((64, nq, 16), 1, 0.125),
         "wk": _normal((64, nkv, 16), 2, 0.125),
         "wv": _normal((64, nkv, 16), 3, 0.125),
         "wo": _normal((nq, 16, 64), 4, 0.125)}
    if qk_norm:
        p["q_norm"] = 1 + _normal((16,), 5, 0.1)
        p["k_norm"] = 1 + _normal((16,), 6, 0.1)
    x, mem = _normal((2, 9, 64), 7), _normal((2, 12, 64), 8)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    out, (k, v) = L.cross_attention(torch.from_numpy(x), tp,
                                    L.AttnSpec(**spec), torch.from_numpy(mem))
    jout, (jk, jv) = jax.jit(JL.cross_attention, static_argnums=2)(
        jnp.asarray(x), jp, JL.AttnSpec(**spec), jnp.asarray(mem))
    _close(out, jout, 1e-6)
    _close(k, jk, 1e-6)
    _close(v, jv, 1e-6)
    # decode: one token against the memory's k/v
    got = L.cross_attention_cached(torch.from_numpy(x[:, :1]), tp,
                                   L.AttnSpec(**spec), k, v)
    want = jax.jit(JL.cross_attention_cached, static_argnums=2)(
        jnp.asarray(x[:, :1]), jp, JL.AttnSpec(**spec), jk, jv)
    _close(got, want, 1e-6)
    _close(got, out[:, :1], 1e-6)


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_run_encoder_matches_jax_and_is_causal_in_both(kernel_impl):
    """The reference asks for "bidir" but its mask is causal: changing the
    last frames leaves every earlier encoder output as it was, in JAX and
    in the port alike; the kernel path maps "bidir" to B4's "full"."""
    jcfg, tcfg, jp, tp = _model("whisper-tiny", seed=1)
    frames = _normal((2, jcfg.audio_frames, jcfg.d_model), 30)
    late = frames.copy()
    late[:, -4:] = _normal((2, 4, jcfg.d_model), 31)
    enc = jax.jit(lambda p, f: JTF.run_encoder(p, jcfg, f))
    for f in (frames, late):
        _close(TF.run_encoder(tp, tcfg, torch.from_numpy(f), kernel_impl),
               enc(jp, jnp.asarray(f)))
    for out in (lambda f: enc(jp, jnp.asarray(f)),
                lambda f: TF.run_encoder(tp, tcfg, torch.from_numpy(f),
                                         kernel_impl)):
        a, b = _np(out(frames)), _np(out(late))
        np.testing.assert_array_equal(a[:, :-4], b[:, :-4])
        assert np.abs(a[:, -4:] - b[:, -4:]).max() > 1e-3


def test_learned_positions_clamp_past_max_seq():
    """Decoding past ``max_seq`` reads the table's last row, as
    ``jnp.minimum(pos, max_seq - 1)`` does: a table of 24 rows, a prompt of
    20 tokens and 8 decode steps (positions 20-27)."""
    jcfg, tcfg, jp, tp = _model("whisper-tiny", seed=2, max_seq=24)
    toks = _tokens(1, 20, jcfg.vocab_size, 31)
    ex = _extras(jcfg, 1, 32)
    ref = _jax_run(jcfg, jp, toks, ex, steps=8, cache_len=32)
    _run_port(tcfg, tp, toks, ex, ref, cache_len=32)
    assert int(ref["cache"]["pos"][0]) == 28 > tcfg.max_seq


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
def _jax_run(jcfg, jp, toks, extras, steps, cache_len=48):
    prefill = jax.jit(lambda p, t, e: JM.prefill(p, jcfg, t, e,
                                                 cache_len=cache_len))
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    logits, cache = prefill(jp, jnp.asarray(toks),
                            {k: jnp.asarray(v) for k, v in extras.items()})
    out = dict(logits=[logits], fed=[], cache0=jax.tree.map(np.asarray, cache))
    for _ in range(steps):
        tok = np.argmax(np.asarray(logits)[:, -1], -1).astype(np.int32)[:, None]
        out["fed"].append(tok)
        logits, cache = decode(jp, cache, jnp.asarray(tok))
        out["logits"].append(logits)
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


def _check_cache(tc, jc, tcfg):
    want = cache_from_numpy(tcfg, jc, device="cpu")
    np.testing.assert_array_equal(tc["pos"].numpy(), want["pos"].numpy())
    for got_l, want_l in zip(tc["layers"], want["layers"]):
        assert got_l.keys() == want_l.keys()
        for name in got_l:
            assert got_l[name].dtype == want_l[name].dtype
            _close(got_l[name], want_l[name])


def _run_port(tcfg, tp, toks, extras, ref, kernel_impl="auto", cache_len=48):
    tl, tc = M.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                       {k: torch.from_numpy(v) for k, v in extras.items()},
                       cache_len=cache_len, kernel_impl=kernel_impl)
    _close(tl, ref["logits"][0])
    _check_cache(tc, ref["cache0"], tcfg)
    for tok, jl in zip(ref["fed"], ref["logits"][1:]):
        tl, tc = M.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long(),
                               kernel_impl=kernel_impl)
        _close(tl, jl)
    _check_cache(tc, ref["cache"], tcfg)


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_prefill_and_decode_steps(model, kernel_impl):
    arch, (jcfg, tcfg, jp, tp) = model
    toks = _tokens(2, 30, jcfg.vocab_size, 33)
    ex = _extras(jcfg, 2, 34)
    ref = _jax_run(jcfg, jp, toks, ex, steps=4)
    cross = [e for e in ref["cache0"]["tail" if arch == "whisper-tiny"
                                      else "groups"].values() if "ck" in e]
    assert cross and all(e["ck"].shape[-3] == (jcfg.vision_tokens
                                               or jcfg.audio_frames)
                         for e in cross)
    _run_port(tcfg, tp, toks, ex, ref, kernel_impl)


def test_the_memory_moves_the_logits(model):
    """With the gates open (and whisper ungated), other embeddings or
    frames give other logits: the cross layers are not silent."""
    _arch, (_jcfg, tcfg, _jp, tp) = model
    toks = torch.from_numpy(_tokens(1, 12, tcfg.vocab_size, 35)).long()
    a, _ = M.prefill(tp, tcfg, toks, M.random_extras(tcfg, 1, 0, "cpu"))
    b, _ = M.prefill(tp, tcfg, toks, M.random_extras(tcfg, 1, 1, "cpu"))
    assert float((a - b).abs().max()) > 1e-3


def test_decode_matches_forward(model):
    _arch, (_jcfg, tcfg, _jp, tp) = model
    tokens = torch.from_numpy(_tokens(1, 24, tcfg.vocab_size, 36)).long()
    ex = {k: torch.from_numpy(v) for k, v in _extras(tcfg, 1, 37).items()}
    x, _ = TF.forward(tp, tcfg, tokens, ex)
    full = TF._lm_head(tp, tcfg, x)
    _, cache = M.prefill(tp, tcfg, tokens[:, :18], ex, cache_len=24)
    for t in range(18, 24):
        logits, cache = M.decode_step(tp, tcfg, cache, tokens[:, t:t + 1])
        _close(logits[0, 0], full[0, t])


def test_serving_engine_with_extras_matches_jax_token_for_token(model):
    """One ``extras`` for every request's prefill, as the JAX engine
    takes it; more requests than slots, so ``ck``/``cv`` are spliced over
    a finished request's."""
    _arch, (jcfg, tcfg, jp, tp) = model
    rng = np.random.default_rng(9)
    lens, news = (7, 19, 7, 19, 19, 7), (5, 3, 7, 4, 6, 2)
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    ex = _extras(jcfg, 1, 38)
    scfg = dict(batch_slots=2, cache_len=32)
    want = JaxEngine(jcfg, JaxServeConfig(**scfg), jp).run(
        [JaxRequest(i, p, m) for i, (p, m) in enumerate(zip(prompts, news))],
        {k: jnp.asarray(v) for k, v in ex.items()})
    eng = ServingEngine(tcfg, ServeConfig(**scfg), tp, device="cpu")
    done = eng.run([Request(i, p, m)
                    for i, (p, m) in enumerate(zip(prompts, news))], ex)
    assert len(want) == 6
    assert {r.rid: r.output for r in done} == {r.rid: r.output for r in want}
