"""ORTHRUS core in PyTorch: workloads, planning, the round engine and
the host loop, bit-exact with ``repro.core``.

Ported so far, closed loop, through ``run_simulation``: ``orthrus`` (P1
+ P2) and ``deadlock_free`` (P2 alone) on the lock-table engine, and the
batch-planned ``dgcc``, ``quecc`` and ``scheduled``.
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
