"""Kernels (``kernels.dep_wavefront``): B2's roofline share, in %: the
least time of one launch of the row form (``dep_wavefront_rows_kernel``),
the bytes ``yardstick.dep_wavefront_rows_bytes`` counts at the cell's
T x P over the HBM peak, over the launches' mean profiled time."""

from simbench import yardstick

KERNEL = "dep_wavefront_rows_kernel"


def read(ctx):
    runs = [e - s for n, s, e in ctx["trace"].kernels() if KERNEL in n]
    if not runs:
        return None
    sh = ctx["shapes"]
    least = yardstick.least_seconds(
        yardstick.dep_wavefront_rows_bytes(sh["n_slots"], sh["pred_width"]))
    return 100.0 * least / (sum(runs) / len(runs) / 1e9)
