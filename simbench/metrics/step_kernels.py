"""Round engine (``engine.make_step`` or ``make_batch_step``): CUDA
kernels that started in the traced window per step executed in it
(every kernel node of a graph replay counts; copies and memsets do
not)."""


def read(ctx):
    kernels = ctx["trace"].kernels()
    if not kernels or not ctx["steps"]:
        return None
    return len(kernels) / ctx["steps"]
