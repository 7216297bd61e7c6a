"""The entry ``run_simulation``: one call of the cell is one whole call of
``repro_torch.core.engine.run_simulation(cfg, workload, device="cuda")``,
which plans the workload on the host, uploads the plan and the state,
simulates and returns one ``SimResult``, as a figure pays for a cell.

``program`` builds the port's side from the generated arrays and
``reference`` the plain reference's; each imports its own side only
when called.
"""

from __future__ import annotations

import time

# Engine options that choose how the port computes, not what: the
# reference has one path and ignores them.
PATH_ONLY = frozenset({"kernel_impl", "state_layout", "rounds_per_dispatch",
                       "release_path"})


def _engine_kwargs(config: dict, traffic: dict) -> dict:
    return {**config["engine"], **traffic.get("engine", {})}


def _workload_params(config: dict, traffic: dict) -> dict:
    return {**config["workload"], **traffic["workload"]}


class Program:
    """The port's side of a cell: ``call()`` is the timed path;
    ``traced_call(spans)`` runs the same call as ``run_simulation`` does,
    ``make_plan`` then ``sweep.simulate_plans``, with the harness's clock
    around each."""

    def __init__(self, config: dict, traffic: dict, arrays: dict, device):
        from repro_torch.core import cost_model, engine, workloads

        self.engine = engine
        self.device = device
        self.cfg = engine.EngineConfig(
            **_engine_kwargs(config, traffic),
            cost=cost_model.CostModel(**config["cost"]))
        wcfg = workloads.WorkloadConfig(
            kind=config["generator"], batch_epoch=config["batch_epoch"],
            **_workload_params(config, traffic))
        self.workload = workloads.Workload(cfg=wcfg, **arrays)

    def call(self) -> list:
        return [self.engine.run_simulation(self.cfg, self.workload,
                                           device=self.device)]

    def traced_call(self, spans: dict) -> list:
        """The call as ``run_simulation`` makes it, with the harness's
        clock around each part."""
        import torch

        from repro_torch.core import sweep

        with torch.profiler.record_function("simbench.make_plan"):
            t0 = time.perf_counter()
            plan = self.engine.make_plan(self.cfg, self.workload)
            spans.setdefault("plan_s", []).append(time.perf_counter() - t0)
        self.meta = self.engine.plan_meta(self.cfg, plan)
        with torch.profiler.record_function("simbench.simulate_plans"):
            t0 = time.perf_counter()
            res = sweep.simulate_plans(self.cfg, [plan], device=self.device)
            spans.setdefault("simulate_s", []).append(
                time.perf_counter() - t0)
        return res

    def shapes(self) -> dict:
        """The launch shapes the kernel readers count bytes at: slots T,
        keys K, predecessor width P (of the last traced call's plan)."""
        meta = self.meta
        return dict(protocol=self.cfg.protocol, n_slots=self.cfg.n_slots,
                    max_keys=meta.max_keys, pred_width=meta.pred_width)


def reference(config: dict, traffic: dict, arrays: dict, device) -> list:
    """The reference's fingerprint of each result one call returns."""
    from simbench.reference import engine, loop, plan

    kw = _engine_kwargs(config, traffic)
    fields = set(engine.Config.__dataclass_fields__)
    unknown = set(kw) - fields - PATH_ONLY
    if unknown:
        raise ValueError(f"the reference does not model {sorted(unknown)}")
    cfg = engine.Config(**{k: v for k, v in kw.items() if k in fields},
                        cost=engine.CostModel(**config["cost"]))
    return [loop.simulate(cfg, plan.make_plan(cfg, arrays,
                                              config["batch_epoch"]), device)]
