"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee of the
configuration broken, which the comparison has to fail.

The simulator runs no model and states no precision, so the control
breaks isolation: every write runs as a read, so conflicting writes no
longer exclude each other (the lock-table engine grants them together;
the dependency-graph planner draws no edge between them).

    python3 simbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints, for each seed, the numbers compared between the control and the
reference at the cell's own size, each beside its limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from simbench import check, harness, spec  # noqa: E402


def broken_isolation(arrays: dict) -> dict:
    """The same workload with every operation's mode set to read."""
    modes = arrays["modes"]
    return {**arrays, "modes": modes * 0}


def control(cell: spec.Cell, arrays: dict, device) -> dict:
    """The comparison of the control with the reference: {name: [gap,
    limit]}."""
    entry = harness.entry_module(cell)
    want = entry.reference(cell.config, cell.traffic, arrays, device)
    got = entry.reference(cell.config, cell.traffic,
                          broken_isolation(arrays), device)
    return check.compare([got], want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    failed = 0
    for seed in args.seeds:
        compared = control(cell, harness.make_inputs(cell, seed), args.device)
        ok = check.within(compared)
        failed += not ok
        print(f"control {cell.name} seed {seed}: passes the comparison: "
              f"{ok}; " + ", ".join(f"{k} {v} (limit {lim})"
                                    for k, (v, lim) in compared.items()),
              flush=True)
    print(f"control {cell.name}: failed the comparison on {failed} of "
          f"{len(args.seeds)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
