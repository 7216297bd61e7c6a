from repro_torch.serve.engine import ServeConfig, ServingEngine
from repro_torch.serve.scheduler import AdmissionPlanner, Request

__all__ = ["AdmissionPlanner", "Request", "ServeConfig", "ServingEngine"]
