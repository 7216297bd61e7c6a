"""Round engine (``engine.make_step`` or ``make_batch_step``): the device
time of the traced window (the durations of the kernels, copies and
memsets that started in it, summed) per step executed in it, in ms."""


def read(ctx):
    dev = ctx["trace"].in_window()
    if not dev or not ctx["steps"]:
        return None
    return sum(e - s for _n, s, e in dev) / 1e6 / ctx["steps"]
