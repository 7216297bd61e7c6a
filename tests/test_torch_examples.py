"""The port's four example programs (``examples/torch_*.py``) on the CPU,
at small sizes, against the JAX package:

  * quickstart: its three engines at a reduced budget and workload equal
    ``repro.core.engine.run_simulation``'s results exactly (commits, both
    abort counters, throughput, breakdown, the whole fingerprint); its
    dispatch plan equals ``repro.models.moe.plan_dispatch``'s on the same
    numpy probabilities (slot tokens exactly, weights and load within
    rtol 1e-6, atol 1e-7, as tests/test_torch_moe_dispatch.py holds them);
  * serve_lm: SMOKE mixtral-8x22b in float32 with the reference's
    weights carried across serves the reference engine's tokens, token
    for token;
  * train_lm: 8 steps of SMOKE gemma3-1b (one pattern repeat, float32)
    from the reference's weights, the crash at step 4: the state restored
    equals the state saved at step 4 bit for bit, and step 0's loss is
    the reference ``build_trainer``'s within 1e-5 relative
    (tests/test_torch_train_step.py's tolerance). Its loss falls only
    over many more steps (chip_smoke.py runs the example's 300);
  * the contention demo, on the port alone at budgets below
    REPRO_DEMO_FAST's: every stanza's header, and every printed cell
    equal to a direct ``run_simulation`` of its config (the golden and
    differential files hold those protocols to the reference).

Each example imports neither ``jax`` nor ``repro``, and its ``main``
without ``--device`` raises where there is no CUDA card.
"""

import ast
import contextlib
import dataclasses
import functools
import importlib.util
import io
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from golden.regenerate import fingerprint  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import TokenPipeline as JaxPipeline  # noqa: E402
from repro.launch.mesh import host_mesh as jax_host_mesh  # noqa: E402
from repro.launch.train import build_trainer as jax_build_trainer  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.moe import plan_dispatch as jax_plan_dispatch  # noqa: E402
from repro.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.optim import init_opt_state as jax_init_opt  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import engine, workloads  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_oltp_contention_demo", "torch_serve_lm",
         "torch_train_lm")

QUICK_SIM = dict(max_rounds=600, warmup_rounds=150, chunk_rounds=150,
                 target_commits=100_000)
QUICK_WORKLOAD = dict(kind="ycsb", num_txns=256, num_records=10_000,
                      num_hot=64, seed=0)
QUICK_LABELS = ("dynamic 2PL + wait-die", "deadlock-free (P2)",
                "ORTHRUS (P1+P2)")
PLAN_RTOL, PLAN_ATOL = 1e-6, 1e-7
SERVE_REQUESTS = 5  # the example's first 5, one more than its 4 slots
TRAIN_STEPS, TRAIN_INTERVAL = 8, 4  # the crash at step 4, saved there
# SMOKE gemma3-1b in float32 at one pattern repeat (3 layers, not 5)
TRAIN_CUT = dict(dtype="float32", pattern_repeats=1)
TRAIN_RTOL = 1e-5
# the demo's stanzas at budgets below REPRO_DEMO_FAST's 4,000 rounds,
# each long enough for what the stanza shows: the planner stanza's one
# lane queues plans at 2,000 rounds, the overload stanza's bounded
# backlog drops at 400
DEMO_SIM = {name: dict(max_rounds=r, warmup_rounds=r // 4,
                       chunk_rounds=r // 4, target_commits=100_000)
            for name, r in (("contention", 200), ("fragments", 200),
                            ("planner", 2000), ("overload", 400))}
DEMO_SIZE = dict(num_txns=256, num_records=10_000)


@functools.cache
def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(fn, *args, **kw):
    """``fn``'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


# -- quickstart ------------------------------------------------------------


@functools.cache
def _quickstart():
    return _quiet(_example("torch_quickstart").contention, "cpu",
                  sim=QUICK_SIM, workload=QUICK_WORKLOAD)


@functools.cache
def _quickstart_reference(label):
    wl = ref_workloads.make_workload(
        ref_workloads.WorkloadConfig(**QUICK_WORKLOAD))
    kw = _example("torch_quickstart").ENGINES[label]
    return ref_engine.run_simulation(
        ref_engine.EngineConfig(**kw, **QUICK_SIM), wl)


def test_quickstart_engines_are_the_reference_examples():
    q = _example("torch_quickstart")
    assert tuple(q.ENGINES) == QUICK_LABELS
    assert q.SIM == dict(max_rounds=6000, warmup_rounds=2000,
                         chunk_rounds=2000, target_commits=100_000)
    assert q.WORKLOAD == dict(QUICK_WORKLOAD, num_txns=4096,
                              num_records=1_000_000)


@pytest.mark.parametrize("label", QUICK_LABELS)
def test_quickstart_cell_matches_reference(label):
    results, out = _quickstart()
    got, want = results[label], _quickstart_reference(label)
    assert (got.commits, got.aborts_deadlock, got.aborts_ollp,
            got.throughput_txn_s, got.breakdown) == (
        want.commits, want.aborts_deadlock, want.aborts_ollp,
        want.throughput_txn_s, want.breakdown)
    assert fingerprint(got, include_metrics=True) == fingerprint(
        want, include_metrics=True)
    assert f"{label:24s} {want.throughput_txn_s/1e3:8.1f}k txn/s" in out
    assert got.commits > 0


def test_quickstart_plan_matches_reference():
    """On CPU tensors the plan is the plain ``plan_dispatch``."""
    q = _example("torch_quickstart")
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((q.TOKENS, q.EXPERTS)) * 2.0
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    got, out = _quiet(q.dispatch, torch.from_numpy(probs))
    want = jax_plan_dispatch(jax.numpy.asarray(probs), top_k=1,
                             capacity=q.CAPACITY)
    np.testing.assert_array_equal(got["slot_token"].numpy(),
                                  np.asarray(want["slot_token"]))
    for f in ("slot_weight", "load"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   rtol=PLAN_RTOL, atol=PLAN_ATOL)
    assert (got["slot_token"] < 0).any()  # some expert has empty slots
    assert out.count("slots -> tokens") == q.EXPERTS


def test_quickstart_router_is_seeded():
    q = _example("torch_quickstart")
    a, b = q.router_probs("cpu"), q.router_probs("cpu")
    assert a.shape == (q.TOKENS, q.EXPERTS) and a.dtype == torch.float32
    assert torch.equal(a, b)
    torch.testing.assert_close(a.sum(-1), torch.ones(q.TOKENS))


# -- serve_lm --------------------------------------------------------------


def _reference_requests(cfg, n):
    """examples/serve_lm.py's requests, the first ``n``."""
    rng = np.random.default_rng(7)
    return [JaxRequest(rid=i, prompt=rng.integers(
        2, cfg.vocab_size, size=int(rng.integers(4, 20))).astype(np.int32),
        max_new_tokens=12) for i in range(10)][:n]


@pytest.fixture(scope="module")
def serve_reference():
    """The reference engine on SMOKE mixtral-8x22b in float32: (its
    weights as numpy, its prompts and outputs by request)."""
    s = _example("torch_serve_lm")
    cfg = dataclasses.replace(jax_smoke(s.ARCH), dtype="float32")
    params = jax.jit(lambda key: JM.init_params(cfg, key))(
        jax.random.PRNGKey(0))
    eng = JaxEngine(cfg, JaxServeConfig(batch_slots=4, cache_len=96), params)
    done = eng.run(_reference_requests(cfg, SERVE_REQUESTS))
    return jax.tree.map(np.asarray, params), {
        r.rid: (r.prompt, r.output) for r in done}


def test_serve_lm_matches_reference_token_for_token(serve_reference):
    s = _example("torch_serve_lm")
    tree, want = serve_reference
    cfg = dataclasses.replace(get_smoke_config(s.ARCH), dtype="float32")
    reqs = s.make_requests(cfg)
    assert len(reqs) == s.N_REQUESTS == 10
    reqs = reqs[:SERVE_REQUESTS]
    for r in reqs:
        np.testing.assert_array_equal(r.prompt, want[r.rid][0])
        assert r.max_new_tokens == s.MAX_NEW
    params = params_from_numpy(cfg, tree, device="cpu")
    (done, stats), out = _quiet(s.serve, cfg, params, "cpu", reqs)
    assert {r.rid: r.output for r in done} == {
        rid: o for rid, (_p, o) in want.items()}
    assert stats["prefills"] == SERVE_REQUESTS and stats["decode_steps"] > 0
    assert f"{SERVE_REQUESTS} requests through 4 slots" in out


# -- train_lm --------------------------------------------------------------


@pytest.fixture(scope="module")
def train_reference():
    """The reference ``build_trainer``'s step on TRAIN_CUT's config at the
    example's batch, sequence and lr, from fresh AdamW state: (the
    initial params as numpy, step 0's loss)."""
    t = _example("torch_train_lm")
    args = t.parse_args([])
    cfg = dataclasses.replace(jax_smoke(args.arch), **TRAIN_CUT)
    _cfg, _init, run_step, _sh, _rules = jax_build_trainer(
        args.arch, jax_host_mesh(1, 1), smoke=True, batch=args.batch,
        seq=args.seq, lr=3e-3, mcfg=cfg)
    params = jax.jit(lambda key: JM.init_params(cfg, key))(
        jax.random.PRNGKey(0))
    state = {"params": params,
             "opt": jax_init_opt(JaxOptConfig(name="adamw", lr=3e-3), params)}
    # copied before the step donates the state's buffers
    params = jax.tree.map(np.array, params)
    batch = JaxPipeline(JaxDataConfig(vocab_size=cfg.vocab_size,
                                      global_batch=args.batch,
                                      seq_len=args.seq)).batch(0)
    _, metrics = run_step(state, batch)
    return params, float(metrics["loss"])


class _Recording(Checkpointer):
    """Keeps a copy of every tree it saves and of the tree it restores."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.saved, self.restored = {}, None
        _Recording.last = self

    def maybe_save(self, step, tree, force=False):
        done = super().maybe_save(step, tree, force)
        if done:
            self.saved[step] = pytree.tree_map(torch.clone, tree)
        return done

    def restore_latest(self, target_tree, device=None):
        step, tree = super().restore_latest(target_tree, device)
        self.restored = (step, pytree.tree_map(torch.clone, tree))
        return step, tree


def test_train_lm_resumes_bit_for_bit_and_matches_reference(train_reference):
    t = _example("torch_train_lm")
    tree, want_loss = train_reference
    args = t.parse_args(["--steps", str(TRAIN_STEPS), "--device", "cpu"])
    assert (args.arch, args.batch, args.seq) == ("gemma3-1b", 8, 64)
    cfg = dataclasses.replace(get_smoke_config(args.arch), **TRAIN_CUT)
    params = params_from_numpy(cfg, tree, device="cpu")
    state = {"params": params,
             "opt": init_opt_state(OptConfig(name="adamw", lr=3e-3), params)}
    out, printed = _quiet(t.train, args, interval=TRAIN_INTERVAL, mcfg=cfg,
                          state=state, checkpointer=_Recording)
    ckpt = _Recording.last
    assert sorted(ckpt.saved) == [0, 4] and out["resumed_from"] == 4
    step, restored = ckpt.restored
    got, saved = (pytree.tree_leaves(x) for x in (restored,
                                                  ckpt.saved[step]))
    assert len(got) == len(saved) > 0
    for a, b in zip(got, saved):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    assert "resumed from step 4" in printed
    assert len(out["losses"]) == TRAIN_STEPS
    assert abs(out["first"] - want_loss) <= TRAIN_RTOL * abs(want_loss)


# -- the contention demo ---------------------------------------------------


@functools.cache
def _demo():
    """The four stanzas (``demo``'s order) at DEMO_SIM's budgets and the
    fast demo's hot sets and fractions: (cells by stanza, the output)."""
    d = _example("torch_oltp_contention_demo")
    runs = {
        "contention": lambda sim: d.contention_sweep("cpu", sim, True,
                                                     DEMO_SIZE),
        "fragments": lambda sim: d.fragment_sweep("cpu", sim, True,
                                                  DEMO_SIZE),
        "planner": lambda sim: d.planner_saturation("cpu", sim, DEMO_SIZE),
        "overload": lambda sim: d.overload("cpu", sim, DEMO_SIZE),
    }
    stanzas, out = {}, ""
    for name, run in runs.items():
        stanzas[name], printed = _quiet(run, DEMO_SIM[name])
        out += printed
    return stanzas, out


def test_demo_prints_every_stanza():
    d = _example("torch_oltp_contention_demo")
    fast = d.budget(True)["max_rounds"]
    assert all(sim["max_rounds"] < fast for sim in DEMO_SIM.values())
    stanzas, out = _demo()
    for header in ("hot records", "multipart %", "planner lanes",
                   "admission policy", "bounded backlog", "deadline shed"):
        assert header in out
    assert [len(stanzas[k]) for k in DEMO_SIM] == [8, 8, 3, 3]
    assert out.count("k/s") == 8 + 8 + 3 + 3
    one_lane = stanzas["planner"][0][2]
    assert one_lane.raw["plan_qdelay"] > 0  # one planner lane queues plans
    backlog = stanzas["overload"][1][2].metrics
    assert backlog.rejected + backlog.shed > 0  # the backlog cap drops


@pytest.mark.parametrize("stanza", ["contention", "fragments", "planner",
                                    "overload"])
def test_demo_cells_equal_direct_runs(stanza):
    stanzas, out = _demo()
    made = {}
    for cfg, wcfg, res in stanzas[stanza]:
        assert (cfg.max_rounds, cfg.warmup_rounds) == (
            DEMO_SIM[stanza]["max_rounds"], DEMO_SIM[stanza]["warmup_rounds"])
        if wcfg not in made:
            made[wcfg] = workloads.make_workload(wcfg)
        direct = engine.run_simulation(cfg, made[wcfg], device="cpu")
        assert fingerprint(res, include_metrics=True) == fingerprint(
            direct, include_metrics=True)
        assert f"{direct.throughput_txn_s/1e3:.1f}k/s" in out


# -- every example ---------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_repro(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("name", NAMES)
def test_main_runs_on_cuda_by_default(name):
    """Without ``--device`` an example asks for the card, and raises
    where there is none: no fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main([])
