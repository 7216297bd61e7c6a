from repro_torch.runtime.fault_tolerance import (
    DeadlineExceeded,
    FailureInjector,
    StragglerMonitor,
    TrainSupervisor,
    Watchdog,
)

__all__ = ["DeadlineExceeded", "FailureInjector", "StragglerMonitor",
           "TrainSupervisor", "Watchdog"]
