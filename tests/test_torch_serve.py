"""The port's serving path against ``repro.serve``: the admission planner's
decisions, and the engine's output tokens token for token (gemma3-1b
SMOKE config in float32, the same weights, more requests than slots);
the archs and features ported since the first model slice build with
the JAX package's configs, shapes and dtypes; the launcher runs on the
CPU, every arch at SMOKE."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import AdmissionPlanner as JaxPlanner  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.configs.base import LayerSpec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.serve import AdmissionPlanner, Request, ServeConfig, ServingEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "gemma3-1b"


def test_admission_planner_matches_jax():
    """Same slots, rejections and queue after every plan/release, over
    requests that fit, requests that do not, and out-of-order releases."""
    rng = np.random.default_rng(0)
    port, ref = AdmissionPlanner(3, 64), JaxPlanner(3, 64)
    for rid in range(40):
        plen, new = int(rng.integers(1, 60)), int(rng.integers(1, 20))
        prompt = np.zeros(plen, np.int32)
        port.submit(Request(rid, prompt, new))
        ref.submit(JaxRequest(rid, prompt, new))
        if rng.random() < 0.5:
            got = [(r.rid, r.slot) for r in port.plan()]
            want = [(r.rid, r.slot) for r in ref.plan()]
            assert got == want
        if port.active and rng.random() < 0.6:
            slot = int(rng.choice(sorted(port.active)))
            port.release(slot)
            ref.release(slot)
        assert port.free_slots == ref.free_slots
        assert sorted(port.active) == sorted(ref.active)
        assert [r.rid for r in port.queue] == [r.rid for r in ref.queue]
        assert port.has_work == ref.has_work


def _requests(cls, vocab):
    """Six requests over two prompt lengths (JAX compiles prefill once per
    length), with different output budgets."""
    rng = np.random.default_rng(7)
    lens, news = (6, 11, 6, 11, 11, 6), (5, 3, 7, 4, 6, 2)
    return [cls(rid=i, prompt=rng.integers(2, vocab, size=n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


@pytest.fixture(scope="module")
def jax_outputs():
    cfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    params = jax.jit(lambda key: JM.init_params(cfg, key))(
        jax.random.PRNGKey(5))
    eng = JaxEngine(cfg, JaxServeConfig(batch_slots=2, cache_len=32), params)
    done = eng.run(_requests(JaxRequest, cfg.vocab_size))
    return jax.tree.map(np.asarray, params), {r.rid: r.output for r in done}


@pytest.mark.parametrize("kernel_impl", ["auto", "jnp", "pallas"])
def test_serving_engine_matches_jax_token_for_token(jax_outputs, kernel_impl):
    tree, want = jax_outputs
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    params = params_from_numpy(cfg, tree, device="cpu")
    eng = ServingEngine(cfg, ServeConfig(batch_slots=2, cache_len=32), params,
                        device="cpu", kernel_impl=kernel_impl)
    before = fa_ops.launches
    done = eng.run(_requests(Request, cfg.vocab_size))
    assert fa_ops.launches == before  # CPU tensors: the plain version
    assert {r.rid: r.output for r in done} == want
    assert len(want) == 6
    assert eng.stats["prefills"] == 6 and eng.stats["decode_steps"] > 0


def test_splice_cache_copies_into_the_slot_rows():
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    batch = M.init_cache(cfg, 3, 20, "cpu")
    _, one = M.prefill(params, cfg, torch.arange(2, 9)[None], cache_len=20)
    from repro_torch.serve.engine import _splice_cache

    _splice_cache(batch, one, 1, 7)
    assert batch["pos"].tolist() == [0, 7, 0]
    for b, o in zip(batch["layers"], one["layers"]):
        assert torch.equal(b["k"][1], o["k"][0])
        assert torch.equal(b["v"][1], o["v"][0])
        assert not b["k"][0].any() and not b["k"][2].any()


def test_engine_rejects_params_on_another_device():
    cfg = get_smoke_config(ARCH)
    params = M.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(cfg, ServeConfig(), params)  # the card by default


# the archs the port carries since the slice of the other archs' serving,
# and llama4-maverick since the slice after it
FORMERLY_UNPORTED = ("qwen3-32b", "stablelm-1.6b", "starcoder2-3b",
                     "llama-3.2-vision-11b", "hymba-1.5b", "whisper-tiny",
                     "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("arch", FORMERLY_UNPORTED)
def test_formerly_unported_arch_loads(arch):
    """Published and SMOKE configs field for field the JAX package's, with
    the same analytic parameter count."""
    assert arch in list_archs()
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.num_layers == ref.num_layers


@pytest.mark.parametrize("change", [
    dict(pattern=(LayerSpec(mixer="attn", attn_kind="none"),)),
    dict(pattern=(LayerSpec(mixer="hybrid"),)),
    dict(tail=(LayerSpec(has_cross=True),)),
    dict(encoder_layers=2),
    dict(pos_embedding="learned"),
    dict(pattern=(LayerSpec(is_moe=True),), num_experts=4,
         experts_per_token=2, moe_dispatch_shards=2),
    dict(early_fusion_tokens=4),
])
def test_building_a_formerly_unported_feature(change):
    """The port's own ``init_params`` and ``init_cache`` give the shapes
    and dtypes of the JAX trees carried across (``params_from_numpy``,
    ``cache_from_numpy``)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), **change)
    jcfg = dataclasses.replace(jax_smoke(ARCH), **change)
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
    jcache = jax.tree.map(np.asarray, JM.init_cache(jcfg, 2, 8))

    def shapes(t):
        return [(tuple(x.shape), x.dtype) for x in jax.tree.leaves(t)]

    got = M.init_params(cfg, seed=0, device="cpu")
    assert shapes(got) == shapes(params_from_numpy(cfg, tree, "cpu"))
    assert shapes(M.init_cache(cfg, 2, 8, "cpu")) == shapes(
        cache_from_numpy(cfg, jcache, "cpu"))


def test_launch_serve_runs_on_the_cpu(capsys):
    assert launch_serve.main(["--device", "cpu", "--requests", "3",
                              "--max-new", "4", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "tok/s" in out
    assert "flash_attention launches 0" in out


@pytest.mark.parametrize("arch", FORMERLY_UNPORTED)
def test_launch_serve_runs_each_arch_on_the_cpu(arch, capsys):
    """At SMOKE, with the seeded ``vision_embeds`` / ``audio_frames``
    that llama-3.2-vision's, llama4-maverick's and whisper's prefills
    take."""
    assert launch_serve.main(["--device", "cpu", "--arch", arch,
                              "--requests", "3", "--max-new", "4",
                              "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "flash_attention launches 0" in out


def test_check_fits_counts_the_cache():
    """qwen3-32b's weights fit 80 GB; with 8 x 4,096 cache rows a card with
    70 GB free does not hold them."""
    cfg = get_config("qwen3-32b")
    weights = cfg.param_count() * 2
    cache = 64 * 2 * 8 * 4096 * 8 * 128 * 2
    launch_serve.check_fits(cfg, weights + cache)
    with pytest.raises(RuntimeError, match="cache"):
        launch_serve.check_fits(cfg, weights + cache - 1, 8, 4096)
    launch_serve.check_fits(cfg, weights + cache - 1)
