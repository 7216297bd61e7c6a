"""Host loop (``core.sweep``): the traced window's wall time less the
time the device was busy in it, per step executed in it, in ms: the time a
step leaves the card waiting on the host (replay, read of ``r``,
Python, the call's planning and upload). Read under the profiler,
which adds its own cost to every replay, so it overstates what an
untraced call pays; it moves with the host's work all the same."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device or not ctx["steps"]:
        return None
    return 1e3 * (tr.window_s - tr.busy_s()) / ctx["steps"]
