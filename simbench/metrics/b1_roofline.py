"""Kernels (``kernels.lock_grant``): B1's roofline share, in %: the least
time of one launch of the fused grant pass (``lock_grant_step_kernel``),
the bytes ``yardstick.lock_grant_step_bytes`` counts at the cell's T x K
over the HBM peak, over the launches' mean profiled time."""

from simbench import yardstick

KERNEL = "lock_grant_step_kernel"


def read(ctx):
    runs = [e - s for n, s, e in ctx["trace"].kernels() if KERNEL in n]
    if not runs:
        return None
    sh = ctx["shapes"]
    least = yardstick.least_seconds(
        yardstick.lock_grant_step_bytes(sh["n_slots"], sh["max_keys"]))
    return 100.0 * least / (sum(runs) / len(runs) / 1e9)
