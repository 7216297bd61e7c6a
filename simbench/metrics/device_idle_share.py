"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card (1 - the union of their intervals over the
window), in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
