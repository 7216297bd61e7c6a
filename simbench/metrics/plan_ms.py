"""Host planning (``core.workloads``, ``core.planner``, ``core.depgraph``
through ``engine.make_plan``): the harness's clock around its own call
of ``make_plan`` in each traced call, in ms, averaged over them."""


def read(ctx):
    spans = ctx["spans"].get("plan_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
