"""The port's stablelm-1.6b, starcoder2-3b and qwen3-32b against
``repro.models`` and ``repro.serve`` at their SMOKE configs in float32,
on the same weights (``params_from_numpy`` of the JAX ``init_params``
tree) and inputs: prefill logits and every cache leaf, 4 greedy decode
steps, a ring cache past starcoder2's window, the serving engine's tokens
token for token, and decode against the full forward.

These three are attention with a dense MLP, in combinations no arch of
the earlier slices had: stablelm's layernorm with partial rotary (0.25)
and MHA, starcoder2's gelu MLP with tied embeddings, layernorm and a
sliding window, qwen3's qk-norm with GQA.

Tolerance (float32, absolute): 1e-5 for logits and caches, the value of
the earlier model slices (the two frameworks sum in other orders).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
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


ARCHS = ("stablelm-1.6b", "starcoder2-3b", "qwen3-32b")
ATOL = 1e-5


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jp)
    return arch, jcfg, tcfg, jp, tree, params_from_numpy(tcfg, tree, "cpu")


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
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


def _check_cache(tc, jc, tcfg):
    want = cache_from_numpy(tcfg, jc, device="cpu")
    np.testing.assert_array_equal(tc["pos"].numpy(), want["pos"].numpy())
    assert len(tc["layers"]) == len(want["layers"]) == tcfg.num_layers
    for got_l, want_l in zip(tc["layers"], want["layers"]):
        assert got_l.keys() == want_l.keys()
        for name in got_l:
            assert got_l[name].dtype == want_l[name].dtype
            _close(got_l[name], want_l[name])


def _run_port(tcfg, tp, toks, ref, kernel_impl="auto", cache_len=48):
    tl, tc = M.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                       cache_len=cache_len, kernel_impl=kernel_impl)
    assert tuple(tl.shape) == (toks.shape[0], 1, tcfg.vocab_size)
    _close(tl, ref["logits"][0])
    _check_cache(tc, ref["cache0"], tcfg)
    for tok, jl in zip(ref["fed"], ref["logits"][1:]):
        tl, tc = M.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long(),
                               kernel_impl=kernel_impl)
        _close(tl, jl)
    _check_cache(tc, ref["cache"], tcfg)


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_prefill_and_decode_steps(model, kernel_impl):
    """Prefill of 40 tokens (past starcoder2's SMOKE window of 16), then 4
    decode steps; "pallas" on CPU tensors runs B4's plain version."""
    _arch, jcfg, tcfg, jp, _tree, tp = model
    toks = _tokens(2, 40, tcfg.vocab_size, 11)
    before = fa_ops.launches
    _run_port(tcfg, tp, toks, _jax_run(jcfg, jp, toks, steps=4), kernel_impl)
    assert fa_ops.launches == before


def test_ring_cache_prefill_and_decode():
    """starcoder2 with ``swa_ring_cache``: every layer keeps a
    window-long ring; the prompt (40) is longer than the window (16)."""
    jcfg, tcfg = _cfgs("starcoder2-3b", swa_ring_cache=True)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(4))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(1, 40, tcfg.vocab_size, 12)
    ref = _jax_run(jcfg, jp, toks, steps=3)
    assert ref["cache0"]["groups"]["l0"]["k"].shape[2] == tcfg.window
    _run_port(tcfg, tp, toks, ref)


def test_decode_matches_forward(model):
    """Prefill + decode logits == the full forward's, position by
    position (tests/test_models_smoke.py's check, float32)."""
    _arch, _jcfg, tcfg, _jp, _tree, tp = model
    tokens = torch.from_numpy(_tokens(1, 24, tcfg.vocab_size, 13)).long()
    x, _ = TF.forward(tp, tcfg, tokens)
    full = TF._lm_head(tp, tcfg, x)
    _, cache = M.prefill(tp, tcfg, tokens[:, :18], cache_len=24)
    for t in range(18, 24):
        logits, cache = M.decode_step(tp, tcfg, cache, tokens[:, t:t + 1])
        _close(logits[0, 0], full[0, t])


def _requests(cls, vocab):
    """Six requests over two prompt lengths (JAX compiles prefill once per
    length), with different output budgets; more requests than slots."""
    rng = np.random.default_rng(7)
    lens, news = (9, 21, 9, 21, 21, 9), (5, 3, 7, 4, 6, 2)
    return [cls(rid=i, prompt=rng.integers(2, vocab, size=n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


def test_serving_engine_matches_jax_token_for_token(model):
    _arch, jcfg, tcfg, jp, _tree, tp = model
    scfg = dict(batch_slots=2, cache_len=40)
    want = JaxEngine(jcfg, JaxServeConfig(**scfg), jp).run(
        _requests(JaxRequest, jcfg.vocab_size))
    eng = ServingEngine(tcfg, ServeConfig(**scfg), tp, device="cpu")
    done = eng.run(_requests(Request, tcfg.vocab_size))
    assert len(want) == 6 and eng.stats["prefills"] == 6
    assert {r.rid: r.output for r in done} == {r.rid: r.output for r in want}
