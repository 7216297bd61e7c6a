"""ORTHRUS core in PyTorch: workloads, planning, the round engine and
the host loop, bit-exact with ``repro.core``.

Every protocol of ``engine.PROTOCOLS`` runs through ``run_simulation``
and ``sweep.run_cells``, closed loop or under open epoch arrival with
the overload layer, at any ``rounds_per_dispatch``: ``orthrus``,
``deadlock_free``, the dynamic-2PL schemes and ``partitioned_store`` on
the lock-table engine, and the batch-planned ``dgcc``, ``quecc`` and
``scheduled``. ``EngineConfig(state_layout="legacy")`` runs the frozen
pre-packed engine (``engine_legacy``), the conformance oracle of the
packed one. ``protocols`` is the protocol registry. ``distributed`` is
ORTHRUS with one CC shard per mesh position and explicit message
passing, on one device or one rank a shard.
"""

from repro_torch.core.cost_model import CostModel
from repro_torch.core.engine import EngineConfig, SimResult, run_simulation
from repro_torch.core.workloads import (
    WorkloadConfig,
    make_workload,
    tpcc_workload,
    ycsb_workload,
)

__all__ = [
    "CostModel",
    "EngineConfig",
    "SimResult",
    "run_simulation",
    "WorkloadConfig",
    "make_workload",
    "ycsb_workload",
    "tpcc_workload",
]
