"""The port's llama4-maverick-400b-a17b against ``repro.models`` and
``repro.serve`` at its SMOKE config in float32, on the same weights
(``params_from_numpy`` of the JAX ``init_params`` tree) and inputs:
prefill logits and every cache leaf at prompts that cross SMOKE's
32-token attention chunk, greedy decode steps across a chunk boundary,
decode against the full forward, the early-fusion prefix (the logits
move with ``vision_embeds``), a prompt shorter than the prefix (pinned
to what the reference does), the serving engine's tokens token for
token, per-shard MoE dispatch (``moe_dispatch_shards`` 2) through
prefill and decode, and the launcher's memory check on the published
config and on the depth cut that one card serves.

SMOKE's pattern is llama4's: 3 chunked-local layers and 1 global NoPE
layer, MoE (4 experts, top 1, a shared expert) on the second and the
fourth, and a 4-row early-fusion prefix.

Tolerance (float32, absolute): 1e-5, the value of the earlier model
slices (the two frameworks sum in other orders).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as md_ops  # noqa: E402
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


ARCH = "llama4-maverick-400b-a17b"
ATOL = 1e-5
CACHE_LEN = 96


def _cfgs(**kw):
    return (dataclasses.replace(jax_smoke(ARCH), dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **kw))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _prefix(cfg, B, seed):
    """``extras`` with a unit-normal early-fusion prefix, numpy."""
    return {"vision_embeds": np.random.default_rng(seed).standard_normal(
        (B, cfg.early_fusion_tokens, cfg.d_model)).astype(np.float32)}


def _torch(extras):
    return {k: torch.from_numpy(v) for k, v in extras.items()}


def _load(**kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(5))
    return jcfg, tcfg, jp, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def model():
    return _load()


@pytest.fixture(scope="module")
def sharded():
    """The same weights with per-shard MoE dispatch over 2 shards."""
    return _load(moe_dispatch_shards=2)


def test_smoke_config_is_llama4s_pattern(model):
    _jcfg, tcfg, _jp, tp = model
    kinds = [(s.attn_kind, s.use_rope, s.is_moe) for s in tcfg.pattern]
    assert kinds == [("chunked", True, False), ("chunked", True, True),
                     ("chunked", True, False), ("full", False, True)]
    assert tcfg.early_fusion_tokens == 4 and tcfg.window == 32
    assert sorted(tp["layers"][1]["moe"]) == ["router", "shared", "wg", "wi",
                                              "wo"]


def _jax_run(jcfg, jp, toks, extras, steps, cache_len=CACHE_LEN):
    """JAX prefill, then ``steps`` greedy decode steps: the tokens fed,
    each step's logits, and the caches after prefill and at the end."""
    prefill = jax.jit(lambda p, t, e: JM.prefill(p, jcfg, t, e,
                                                 cache_len=cache_len))
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    logits, cache = prefill(jp, jnp.asarray(toks), extras)
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
        assert got_l.keys() == want_l.keys() == {"k", "v"}
        for name in got_l:
            _close(got_l[name], want_l[name])


def _run_port(tcfg, tp, toks, extras, ref, kernel_impl="auto"):
    tl, tc = M.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                       _torch(extras), cache_len=CACHE_LEN,
                       kernel_impl=kernel_impl)
    assert tuple(tl.shape) == (toks.shape[0], 1, tcfg.vocab_size)
    _close(tl, ref["logits"][0])
    _check_cache(tc, ref["cache0"], tcfg)
    for tok, jl in zip(ref["fed"], ref["logits"][1:]):
        tl, tc = M.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long(),
                               kernel_impl=kernel_impl)
        _close(tl, jl)
    _check_cache(tc, ref["cache"], tcfg)


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("S", [80, 62])
def test_prefill_and_decode_steps(model, S, kernel_impl):
    """A prompt of 80 tokens crosses two chunk boundaries in prefill; one
    of 62 crosses the third (64) in its 4 decode steps. "pallas" on CPU
    tensors runs B3's and B4's plain versions through their wrappers."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(2, S, tcfg.vocab_size, S)
    extras = _prefix(tcfg, 2, S + 1)
    before = (fa_ops.launches, md_ops.launches)
    _run_port(tcfg, tp, toks, extras,
              _jax_run(jcfg, jp, toks, extras, steps=4), kernel_impl)
    assert (fa_ops.launches, md_ops.launches) == before


def test_decode_matches_forward(model):
    """Prefill + decode logits == the full forward's, position by
    position (tests/test_models_smoke.py's check, float32), the prefix
    fused in both, across the chunk boundary at 32."""
    _jcfg, tcfg, _jp, tp = model
    tokens = torch.from_numpy(_tokens(1, 40, tcfg.vocab_size, 13)).long()
    extras = _torch(_prefix(tcfg, 1, 14))
    x, _ = TF.forward(tp, tcfg, tokens, extras)
    full = TF._lm_head(tp, tcfg, x)
    _, cache = M.prefill(tp, tcfg, tokens[:, :28], extras, cache_len=40)
    for t in range(28, 40):
        logits, cache = M.decode_step(tp, tcfg, cache, tokens[:, t:t + 1])
        _close(logits[0, 0], full[0, t])


def test_early_fusion_prefix_moves_the_logits(model):
    """Two prefixes give two sets of logits, each JAX's; the prefix
    replaces the prompt's first rows, so without it they differ too."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(1, 20, tcfg.vocab_size, 21)
    got = {}
    for seed in (22, 23):
        extras = _prefix(tcfg, 1, seed)
        got[seed], _ = M.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                                 _torch(extras))
        want, _ = JM.prefill(jp, jcfg, jnp.asarray(toks), extras)
        _close(got[seed], want)
    bare, _ = M.prefill(tp, tcfg, torch.from_numpy(toks).long())
    jbare, _ = JM.prefill(jp, jcfg, jnp.asarray(toks))
    _close(bare, jbare)
    assert float((got[22] - got[23]).abs().max()) > 1e-3
    assert float((got[22] - bare).abs().max()) > 1e-3
    # only the prefix's rows move the embedding: the rest are the tokens'
    x = TF._embed(tp, tcfg, torch.from_numpy(toks).long(),
                  _torch(_prefix(tcfg, 1, 22)))
    nf = tcfg.early_fusion_tokens
    assert torch.equal(x[:, :nf], torch.from_numpy(_prefix(tcfg, 1, 22)[
        "vision_embeds"]))
    assert torch.equal(x[:, nf:], tp["tok_embed"][torch.from_numpy(
        toks[:, nf:]).long()])


def test_short_prompt_is_pinned_to_the_reference(model):
    """A prompt shorter than the prefix: the sequence grows to the
    prefix's rows (the forward of both packages gives 4 rows for 2
    tokens, equal), and prefill raises ValueError in both, since the
    cache takes the prompt's length (ROADMAP Queue 3)."""
    jcfg, tcfg, jp, tp = model
    nf = tcfg.early_fusion_tokens
    toks = _tokens(1, nf - 2, tcfg.vocab_size, 31)
    extras = _prefix(tcfg, 1, 32)
    x, _ = TF.forward(tp, tcfg, torch.from_numpy(toks).long(),
                      _torch(extras))
    jx, _ = JTF.forward(jp, jcfg, jnp.asarray(toks), extras)
    assert x.shape == jx.shape == (1, nf, tcfg.d_model)
    _close(x, jx)
    with pytest.raises(ValueError):
        JM.prefill(jp, jcfg, jnp.asarray(toks), extras, cache_len=16)
    with pytest.raises(ValueError, match="shorter"):
        M.prefill(tp, tcfg, torch.from_numpy(toks).long(), _torch(extras),
                  cache_len=16)
    # a prompt as long as the prefix is all prefix
    toks = _tokens(1, nf, tcfg.vocab_size, 33)
    got, _ = M.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                       _torch(extras))
    want, _ = JM.prefill(jp, jcfg, jnp.asarray(toks), extras)
    _close(got, want)


def _requests(cls, vocab):
    """Six requests over two prompt lengths (JAX compiles prefill once per
    length), with different output budgets; more requests than slots."""
    rng = np.random.default_rng(7)
    lens, news = (9, 37, 9, 37, 37, 9), (5, 3, 7, 4, 6, 2)
    return [cls(rid=i, prompt=rng.integers(2, vocab, size=n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("shards", [0, 2])
def test_serving_engine_matches_jax_token_for_token(model, sharded, shards):
    jcfg, tcfg, jp, tp = sharded if shards else model
    scfg = dict(batch_slots=2, cache_len=48)
    extras = _prefix(tcfg, 1, 41)
    want = JaxEngine(jcfg, JaxServeConfig(**scfg), jp).run(
        _requests(JaxRequest, jcfg.vocab_size), extras)
    eng = ServingEngine(tcfg, ServeConfig(**scfg), tp, device="cpu")
    done = eng.run(_requests(Request, tcfg.vocab_size), extras)
    assert len(want) == 6 and eng.stats["prefills"] == 6
    assert {r.rid: r.output for r in done} == {r.rid: r.output for r in want}


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_per_shard_dispatch_prefill_and_decode(sharded, kernel_impl,
                                               monkeypatch):
    """``moe_dispatch_shards`` 2: a prompt of 2 x 40 tokens plans two
    shards at each MoE layer, a decode step of 2 slots one token each
    (the shards' floor of 32 slots); both against JAX's per-shard path,
    every plan a grouped one."""
    jcfg, tcfg, jp, tp = sharded
    assert tcfg.moe_dispatch_shards == 2
    name = "plan_dispatch" if kernel_impl == "jnp" else "moe_dispatch_plan"
    planner, shapes = getattr(MOE, name), []

    def spy(probs, *args, **kw):
        shapes.append((tuple(probs.shape), kw.get("capacity", args[-1:])))
        return planner(probs, *args, **kw)

    monkeypatch.setattr(MOE, name, spy)
    toks = _tokens(2, 40, tcfg.vocab_size, 51)
    extras = _prefix(tcfg, 2, 52)
    _run_port(tcfg, tp, toks, extras,
              _jax_run(jcfg, jp, toks, extras, steps=4), kernel_impl)
    E = tcfg.num_experts
    assert shapes == [((2, 40, E), 128)] * 2 + [((2, 1, E), 32)] * 8


def test_check_fits_refuses_the_whole_model_and_takes_the_cut():
    """The published config's 795.4 GB do not fit an 80 GB card; one of
    its 12 pattern repeats (35.04 B parameters, 70.08 GB of bf16) and a
    cache of 8 x 4,096 (0.54 GB) do, the cut chip_smoke.py serves."""
    cfg = get_config(ARCH)
    with pytest.raises(RuntimeError, match="one card cannot hold it"):
        launch_serve.check_fits(cfg, 80 * 10**9, 8, 4096)
    cut = dataclasses.replace(cfg, pattern_repeats=1)
    assert cut.num_layers == 4 and cut.param_count() == 35_037_511_680
    launch_serve.check_fits(cut, 80 * 10**9, 8, 4096)
    with pytest.raises(RuntimeError, match="cache"):
        launch_serve.check_fits(cut, 70_075_023_360 + 536_870_912 - 1, 8,
                                4096)
