"""Protocol registry: the nine concurrency-control designs under test.

Thin façade over ``repro_torch.core.engine``, the port of
``repro.core.protocols`` with the same entries: the engine implements
all protocols over one cycle-accounting core; this module names them,
maps each to its planner in ``repro_torch.core.planner``, and documents
what each one models.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import planner as planner_lib
from repro_torch.core.engine import PROTOCOLS, EngineConfig, run_simulation


@dataclasses.dataclass(frozen=True)
class ProtocolInfo:
    name: str
    planner: str  # which access plan the protocol requires
    deadlocks: str  # how deadlocks are handled
    paper_ref: str


REGISTRY = {
    "twopl_waitdie": ProtocolInfo(
        "2PL + wait-die", "none (dynamic acquisition, program order)",
        "avoidance by timestamp aborts (false positives)", "§4, Fig 4",
    ),
    "twopl_waitfor": ProtocolInfo(
        "2PL + wait-for graph", "none (dynamic acquisition)",
        "detection via partitioned waits-for graph, abort youngest in cycle",
        "§4, Fig 4",
    ),
    "twopl_dreadlocks": ProtocolInfo(
        "2PL + dreadlocks", "none (dynamic acquisition)",
        "detection via digest bitsets (waiters spin on holders' digests)",
        "§4, Fig 4; Koskinen & Herlihy",
    ),
    "deadlock_free": ProtocolInfo(
        "Deadlock-free locking (P2)",
        "full read/write-set analysis; canonical lexicographic order",
        "structurally impossible (acyclic waits-for)", "§3.2",
    ),
    "orthrus": ProtocolInfo(
        "ORTHRUS (P1 + P2)",
        "read/write sets ordered by (CC lane, key); CC->CC forwarding",
        "structurally impossible; no handling logic at all", "§3",
    ),
    "partitioned_store": ProtocolInfo(
        "Partitioned-store (H-Store style)",
        "partition set, sorted; home-partition execution",
        "ordered coarse partition locks", "§4.3",
    ),
    "dgcc": ProtocolInfo(
        "DGCC (batch conflict-graph wavefronts)",
        "whole-batch dependency graph; lock-free wavefront execution",
        "structurally impossible (acyclic batch DAG); no lock table",
        "P1+P2 at batch scope; Yao et al., arXiv 1503.03642",
    ),
    "quecc": ProtocolInfo(
        "QueCC (batch per-lane execution queues)",
        "whole-batch per-CC-lane totally-ordered queues + dep stamps",
        "structurally impossible (per-lane total orders); no lock table",
        "P1+P2 at batch scope; Qadah & Sadoghi, arXiv 1910.10350",
    ),
    "scheduled": ProtocolInfo(
        "Scheduled (conflict-cluster lane chains)",
        "union-find clustering by data-access overlap; clusters chain "
        "in admission order on round-robin exec lanes",
        "structurally impossible (per-cluster total orders); no lock "
        "table, no wavefront DAG",
        "scheduling, not planning; Prasaad et al., arXiv 1810.01997",
    ),
}

PLANNERS = {
    "twopl_waitdie": planner_lib.plan_dynamic,
    "twopl_waitfor": planner_lib.plan_dynamic,
    "twopl_dreadlocks": planner_lib.plan_dynamic,
    "deadlock_free": planner_lib.plan_sorted,
    "orthrus": planner_lib.plan_orthrus,
    "partitioned_store": planner_lib.plan_partition_store,
    "dgcc": planner_lib.plan_dgcc,
    "quecc": planner_lib.plan_quecc,
    "scheduled": planner_lib.plan_scheduled,
}

# Registry/engine consistency (every engine protocol named and planned,
# no orphans) is checked by the tests, not by an import-time assert.

__all__ = ["PROTOCOLS", "REGISTRY", "PLANNERS", "EngineConfig", "run_simulation"]
