"""The port's protocol registry (``repro_torch.core.protocols``) against
``repro.core.protocols``: the same entries, the same text, each protocol
mapped to the port's planner of the reference's name, and every planner
giving the reference's plan on one workload. The registry covers the
port's ``PROTOCOLS`` exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import protocols as ref_protocols  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import engine, planner, protocols, workloads  # noqa: E402

WL = dict(kind="ycsb", num_txns=96, num_records=5_000, num_hot=8,
          batch_epoch=32, seed=2)
# each planner's arguments beyond the workload (engine.make_plan's)
PLAN_ARGS = {
    "twopl_waitdie": ((), {}),
    "twopl_waitfor": ((), {}),
    "twopl_dreadlocks": ((), {}),
    "deadlock_free": ((), {}),
    "orthrus": ((4,), {}),
    "partitioned_store": ((8,), {}),
    "dgcc": ((32,), dict(n_lanes=2, fragments=False)),
    "quecc": ((4, 32), dict(fragments=False)),
    "scheduled": ((32,), dict(n_lanes=8)),
}


def test_registry_covers_the_ports_protocols_exactly():
    assert protocols.PROTOCOLS is engine.PROTOCOLS
    assert set(protocols.REGISTRY) == set(engine.PROTOCOLS)
    assert set(protocols.PLANNERS) == set(engine.PROTOCOLS)
    assert set(protocols.REGISTRY) == set(ref_protocols.REGISTRY)
    assert protocols.__all__ == ref_protocols.__all__
    assert protocols.EngineConfig is engine.EngineConfig
    assert protocols.run_simulation is engine.run_simulation


@pytest.mark.parametrize("name", sorted(ref_protocols.REGISTRY))
def test_registry_entry_matches_reference(name):
    mine = protocols.REGISTRY[name]
    assert isinstance(mine, protocols.ProtocolInfo)
    assert dataclasses.asdict(mine) == dataclasses.asdict(
        ref_protocols.REGISTRY[name])
    assert [f.name for f in dataclasses.fields(protocols.ProtocolInfo)] == [
        f.name for f in dataclasses.fields(ref_protocols.ProtocolInfo)]


def _plan_arrays(plan) -> dict:
    out = {f.name: getattr(plan, f.name)
           for f in dataclasses.fields(plan) if f.name != "sched"}
    if plan.sched is not None:
        out.update({f"sched.{f.name}": getattr(plan.sched, f.name)
                    for f in dataclasses.fields(plan.sched)})
    return out


@pytest.mark.parametrize("name", sorted(ref_protocols.PLANNERS))
def test_planner_matches_reference(name):
    mine, ref = protocols.PLANNERS[name], ref_protocols.PLANNERS[name]
    assert mine is getattr(planner, ref.__name__)
    args, kw = PLAN_ARGS[name]
    got = _plan_arrays(mine(
        workloads.make_workload(workloads.WorkloadConfig(**WL)), *args,
        **kw))
    want = _plan_arrays(ref(
        ref_workloads.make_workload(ref_workloads.WorkloadConfig(**WL)),
        *args, **kw))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
