"""Run one cell of the benchmark once, on the CUDA cards of this machine.

    python3 simbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``compared`` last); the last
lines of standard error are the numbers compared, each beside its
limit. Exits non-zero and prints no result where CUDA is missing or
has fewer cards than the cell asks for, where the checkout lacks the
port or a file of the cell, or where the JAX package or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from simbench import guard, harness, spec  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    pinned = harness.pin_environment(ROOT)
    harness.log("simbench: pinned " + " ".join(
        f"{k}={v}" for k, v in pinned.items()))
    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as e:
        harness.log(f"simbench: {e}")
        return 2
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        harness.log(f"simbench: {cell.name} needs {cell.chips} CUDA "
                    f"card(s); this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        harness.log(f"simbench: the port is not in this checkout ({e})")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    loaded = guard.forbidden_loaded()
    if loaded:
        harness.log(f"simbench: the run loaded {loaded}: the benchmark "
                    f"measures {guard.PORT} alone")
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
