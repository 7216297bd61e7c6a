"""The port's legacy state layout against the JAX reference's, state by
state, on the CPU.

  * ``tests/test_engine_leap.py``'s 8 ``PROTO_KW`` cells on its
    ``ycsb_hot`` workload: from equal initial states, the port's legacy
    chunk runner and the reference's leave equal states, array for
    array (through ``convert``), at every chunk boundary.
  * Per-step differentials from one state (orthrus, twopl_waitfor,
    quecc; leaping on and off): every state array equal after every
    step.
  * ``convert`` carries a legacy state both ways.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import engine_legacy as ref_legacy  # noqa: E402
from repro.core import sweep as ref_sweep  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import engine, engine_legacy, sweep, workloads  # noqa: E402
from repro_torch.core.convert import (  # noqa: E402
    plan_from_numpy,
    state_from_numpy,
    state_to_numpy,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_engine_leap.py's cells
FAST = dict(max_rounds=2000, warmup_rounds=500, chunk_rounds=500,
            target_commits=10**9)
PROTO_KW = {
    "twopl_waitdie": dict(n_exec=8),
    "twopl_waitfor": dict(n_exec=8),
    "twopl_dreadlocks": dict(n_exec=8),
    "deadlock_free": dict(n_exec=8),
    "orthrus": dict(n_cc=2, n_exec=6, window=2),
    "partitioned_store": dict(n_exec=8),
    "dgcc": dict(n_cc=2, n_exec=6, window=2),
    "quecc": dict(n_cc=4, n_exec=6, window=2),
}
YCSB_HOT = dict(kind="ycsb", num_txns=512, num_records=20_000, num_hot=8,
                seed=0)


@functools.cache
def _workload_pair(wl_key):
    """The (port, reference) workloads of a config, made once for this
    module."""
    wl_kw = dict(wl_key)
    return (workloads.make_workload(workloads.WorkloadConfig(**wl_kw)),
            ref_workloads.make_workload(
                ref_workloads.WorkloadConfig(**wl_kw)))


def _plans(protocol, wl_kw, sim=FAST, **kw):
    """(port cfg, reference cfg, meta, numpy plan arrays, (reference
    plan, port plan))."""
    eng_kw = dict(protocol=protocol, state_layout="legacy", **kw, **sim)
    cfg = engine.EngineConfig(**eng_kw)
    ref_cfg = ref_engine.EngineConfig(**eng_kw)
    wl, ref_wl = _workload_pair(tuple(sorted(wl_kw.items())))
    ref_plan = ref_engine.make_plan(ref_cfg, ref_wl)
    plan = engine.make_plan(cfg, wl)
    meta = ref_engine.plan_meta(ref_cfg, ref_plan)
    assert engine.plan_meta(cfg, plan) == engine.PlanMeta(
        **vars(meta))
    return cfg, ref_cfg, meta, ref_engine.plan_device(ref_cfg, ref_plan), (
        ref_plan, plan)


def _assert_states_equal(got: dict, want: dict, what: str) -> None:
    got = state_to_numpy(got)
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v),
                                      err_msg=f"{what}: {k}")


@pytest.mark.parametrize("protocol", sorted(PROTO_KW))
def test_legacy_states_match_reference(protocol):
    """From the two packages' initial legacy states (equal), each chunk
    runner leaves equal states at every chunk boundary of FAST."""
    cfg, ref_cfg, meta, p_np, (ref_plan, plan) = _plans(
        protocol, YCSB_HOT, **PROTO_KW[protocol])
    T = cfg.n_slots
    if cfg.is_batch_planned:
        s_ref = ref_legacy._batch_state0(ref_cfg, ref_plan, T)
        s = engine_legacy._batch_state0(cfg, plan, T, "cpu")
    else:
        s_ref = ref_legacy._state0(ref_cfg, ref_plan.num_records, T,
                                   meta.max_keys)
        s = engine_legacy._state0(cfg, plan.num_records, T, meta.max_keys,
                                  "cpu")
    _assert_states_equal(s, s_ref, "initial state")
    ref_run = ref_sweep.get_runner(ref_cfg, meta, batched=False)
    run = sweep.get_runner(cfg, engine.plan_meta(cfg, plan), "cpu")
    p_ref = {k: jnp.asarray(v) for k, v in p_np.items()}
    p = plan_from_numpy(p_np, "cpu")
    for b in sweep.chunk_boundaries(cfg):
        s_ref = ref_run(p_ref, s_ref, jnp.asarray(b, jnp.int32))
        s = run(p, s, b)
        _assert_states_equal(s, s_ref, f"round {b}")
    assert int(s_ref["commits"]) > 0


STEP_CELLS = {
    "orthrus": (dict(protocol="orthrus", n_cc=2, n_exec=3, window=2),
                dict(kind="ycsb", num_txns=128, num_records=2000, num_hot=8,
                     seed=1)),
    "twopl_waitfor": (dict(protocol="twopl_waitfor", n_exec=24),
                      dict(kind="ycsb", num_txns=128, num_records=2000,
                           num_hot=8, seed=1)),
    "quecc": (dict(protocol="quecc", n_cc=2, n_exec=3, window=2),
              dict(kind="ycsb", num_txns=64, num_records=2000, num_hot=8,
                   batch_epoch=16, seed=1)),
}


@pytest.mark.parametrize("leap", [True, False], ids=["leap", "dense"])
@pytest.mark.parametrize("name", sorted(STEP_CELLS))
def test_legacy_step_matches_reference(name, leap):
    """From one state, >= 200 steps of both legacy step builders under
    chunk bounds that clamp leaps leave every state array equal after
    every step (no stamp rebase: the legacy layout has none)."""
    eng_kw, wl_kw = STEP_CELLS[name]
    eng_kw = dict(eng_kw)
    protocol = eng_kw.pop("protocol")
    cfg, ref_cfg, meta, p_np, (ref_plan, plan) = _plans(
        protocol, wl_kw, sim={}, event_leap=leap, **eng_kw)
    T = cfg.n_slots
    pmeta = engine.plan_meta(cfg, plan)
    if cfg.is_batch_planned:
        ref_step = jax.jit(ref_legacy.make_batch_step(ref_cfg, meta))
        step = engine_legacy.make_batch_step(cfg, pmeta, "cpu")
        s_ref = ref_legacy._batch_state0(ref_cfg, ref_plan, T)
    else:
        ref_step = jax.jit(ref_legacy.make_step(ref_cfg, meta))
        step = engine_legacy.make_step(cfg, pmeta, "cpu")
        s_ref = ref_legacy._state0(ref_cfg, ref_plan.num_records, T,
                                   meta.max_keys)
    s = state_from_numpy({k: np.asarray(v) for k, v in s_ref.items()}, "cpu")
    p_ref = {k: jnp.asarray(v) for k, v in p_np.items()}
    p = plan_from_numpy(p_np, "cpu")
    n_steps, r_end = 0, 0
    # the batch cell runs on until the workload wraps (stale done flags)
    wrap = meta.n_txns if cfg.is_batch_planned else -1
    while n_steps < 200 or int(s_ref["next_txn"]) <= wrap:
        r_end += 37
        while int(s_ref["r"]) < r_end:
            s_ref = ref_step(p_ref, s_ref, jnp.int32(r_end))
            s = step(p, s, torch.tensor(r_end, dtype=torch.int32))
            n_steps += 1
            for k in s:
                assert s[k].dtype in (torch.int32, torch.bool), k
            _assert_states_equal(s, s_ref, f"step {n_steps}")
    assert int(s_ref["commits"]) > 0
    if cfg.deadlock_scheme != "none":
        assert int(s_ref["aborts_dl"]) > 0


def test_convert_round_trips_a_legacy_state():
    """convert adds the dropped-write row to the legacy layout's
    per-record arrays and ``done``, and strips it again."""
    cfg, ref_cfg, meta, _p, (ref_plan, _plan) = _plans(
        "twopl_waitdie", YCSB_HOT, n_exec=8)
    s_np = {k: np.asarray(v) for k, v in ref_legacy._state0(
        ref_cfg, ref_plan.num_records, cfg.n_slots, meta.max_keys).items()}
    s = state_from_numpy(s_np, "cpu")
    for k in ("wh", "rc", "heat", "line"):
        assert s[k].shape[0] == s_np[k].shape[0] + 1, k
    back = state_to_numpy(s)
    for k, v in s_np.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
