"""Host loop (``core.sweep``): executed steps per simulated round, the
port's exact counters (``steps_executed / rounds_total``) over the
traced calls. Below 1 by what event leaping skips."""


def read(ctx):
    rounds = sum(r.raw["rounds_total"] for r in ctx["results"])
    if not rounds:
        return None
    return sum(r.raw["steps_executed"] for r in ctx["results"]) / rounds
