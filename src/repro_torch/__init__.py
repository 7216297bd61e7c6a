"""PyTorch port of the ORTHRUS OLTP simulator, for NVIDIA Hopper.

``repro_torch.core`` mirrors ``repro.core`` module by module and
computes the same results bit-exactly; ``repro_torch.kernels`` holds the
hand-written CUDA kernels that replace the Pallas TPU kernels. Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""

from repro_torch.core import (
    EngineConfig,
    SimResult,
    WorkloadConfig,
    make_workload,
    run_simulation,
)

__all__ = [
    "EngineConfig",
    "SimResult",
    "WorkloadConfig",
    "make_workload",
    "run_simulation",
]
