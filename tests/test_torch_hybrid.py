"""The port's Mamba head and hymba-1.5b against ``repro.models`` and
``repro.serve`` at the SMOKE config in float32, on the same weights
(``params_from_numpy`` of the JAX ``init_params`` tree) and inputs.

``mamba_head`` alone from a nonzero state (every weight drawn, the decay
and skip parameters off their init values), over a prompt and over one
decode step; hymba whole: prefill logits and every cache leaf (the
swa layers' k/v and the hybrid layers' Mamba ``state``), 4 greedy decode
steps, a ring cache past the SMOKE window of 16, the serving engine's
tokens token for token, and decode against the full forward.

Tolerance (float32, absolute): 1e-5, the value of the earlier model
slices (the two frameworks sum in other orders; the head's state sums
20-40 outer products).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
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


ARCH = "hymba-1.5b"
ATOL = 1e-5


def _cfgs(**kw):
    return (dataclasses.replace(jax_smoke(ARCH), dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **kw))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _normal(shape, rng, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _head(d=32, H=3, hd=8, N=4, seed=0):
    """A Mamba head's weights in the JAX layout, every leaf drawn:
    ``A_log`` and ``dt_bias`` away from 0 so decays differ by head."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(d)
    return {
        "wx": _normal((d, H, hd), rng, s), "wz": _normal((d, H, hd), rng, s),
        "wB": _normal((d, N), rng, s), "wC": _normal((d, N), rng, s),
        "wdt": _normal((d, H), rng, s), "dt_bias": _normal((H,), rng, 0.5),
        "A_log": _normal((H,), rng, 0.5), "D": _normal((H, hd), rng),
        "wo": _normal((H, hd, d), rng, 1.0 / np.sqrt(H * hd)),
        "ln": 1.0 + _normal((H * hd,), rng, 0.1),
    }


def test_init_mamba_head_keeps_the_jax_layout():
    got = S.init_mamba_head(32, 3, 8, 4, torch.float32, "cpu",
                            torch.Generator().manual_seed(0))
    want = JS.init_mamba_head(jax.random.PRNGKey(0), 32, 3, 8, 4, jnp.float32)
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
    for name in ("dt_bias", "A_log", "D", "ln"):  # constants at init
        np.testing.assert_array_equal(got[name].numpy(), want[name])


@pytest.mark.parametrize("S_", [1, 7, 40])
def test_mamba_head_matches_jax_from_a_nonzero_state(S_):
    p = _head()
    rng = np.random.default_rng(S_)
    x = _normal((2, S_, 32), rng)
    st = _normal((2, 3, 8, 4), rng, 0.5)
    tst = torch.from_numpy(st.copy())
    out, new = S.mamba_head(torch.from_numpy(x),
                            tst, {k: torch.from_numpy(v) for k, v in p.items()})
    jout, jnew = jax.jit(JS.mamba_head)(jnp.asarray(x), jnp.asarray(st),
                                        {k: jnp.asarray(v) for k, v in p.items()})
    _close(out, jout)
    _close(new, jnew)
    assert new.dtype == torch.float32
    np.testing.assert_array_equal(tst.numpy(), st)  # the input is kept


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, jp)
    # draw the Mamba heads' constants too, so a wrong decay or skip shows
    rng = np.random.default_rng(5)
    for name in ("dt_bias", "A_log", "D"):
        leaf = tree["groups"]["l0"]["ssm"][name]
        tree["groups"]["l0"]["ssm"][name] = _normal(leaf.shape, rng, 0.5)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jp, params_from_numpy(tcfg, tree, "cpu")


def _jax_run(jcfg, jp, toks, steps, cache_len=48):
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
    for got_l, want_l in zip(tc["layers"], want["layers"]):
        assert set(got_l) == set(want_l) >= {"k", "v", "state"}
        for name in got_l:
            assert got_l[name].dtype == want_l[name].dtype
            _close(got_l[name], want_l[name])


def _run_port(tcfg, tp, toks, ref, kernel_impl="auto"):
    tl, tc = M.prefill(tp, tcfg, torch.from_numpy(toks).long(), cache_len=48,
                       kernel_impl=kernel_impl)
    _close(tl, ref["logits"][0])
    _check_cache(tc, ref["cache0"], tcfg)
    for tok, jl in zip(ref["fed"], ref["logits"][1:]):
        tl, tc = M.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long(),
                               kernel_impl=kernel_impl)
        _close(tl, jl)
    _check_cache(tc, ref["cache"], tcfg)


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_prefill_and_decode_steps(model, kernel_impl):
    """40 prompt tokens, past the SMOKE window of 16, then 4 steps."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(2, 40, tcfg.vocab_size, 21)
    _run_port(tcfg, tp, toks, _jax_run(jcfg, jp, toks, steps=4), kernel_impl)


def test_ring_cache_past_the_window(model):
    """``swa_ring_cache``: the attention branch keeps a window-long ring
    (the prompt of 40 wraps it), the Mamba branch its state."""
    _jcfg, _tcfg, jp, tp = model
    jcfg, tcfg = _cfgs(swa_ring_cache=True)
    toks = _tokens(1, 40, tcfg.vocab_size, 22)
    ref = _jax_run(jcfg, jp, toks, steps=4)
    assert ref["cache0"]["groups"]["l0"]["k"].shape[2] == tcfg.window
    _run_port(tcfg, tp, toks, ref)


def test_decode_matches_forward(model):
    _jcfg, tcfg, _jp, tp = model
    tokens = torch.from_numpy(_tokens(1, 24, tcfg.vocab_size, 23)).long()
    x, _ = TF.forward(tp, tcfg, tokens)
    full = TF._lm_head(tp, tcfg, x)
    _, cache = M.prefill(tp, tcfg, tokens[:, :18], cache_len=24)
    for t in range(18, 24):
        logits, cache = M.decode_step(tp, tcfg, cache, tokens[:, t:t + 1])
        _close(logits[0, 0], full[0, t])


def test_serving_engine_matches_jax_token_for_token(model):
    """More requests than slots, so a slot's state is spliced over a
    finished request's."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(8)
    lens, news = (9, 30, 9, 30, 30, 9), (5, 3, 7, 4, 6, 2)
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    scfg = dict(batch_slots=2, cache_len=48)
    want = JaxEngine(jcfg, JaxServeConfig(**scfg), jp).run(
        [JaxRequest(i, p, m) for i, (p, m) in enumerate(zip(prompts, news))])
    eng = ServingEngine(tcfg, ServeConfig(**scfg), tp, device="cpu")
    done = eng.run([Request(i, p, m)
                    for i, (p, m) in enumerate(zip(prompts, news))])
    assert len(want) == 6
    assert {r.rid: r.output for r in done} == {r.rid: r.output for r in want}
