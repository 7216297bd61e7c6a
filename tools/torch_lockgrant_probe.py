#!/usr/bin/env python3
"""Quick check of kernels B1 (lock_grant) and B2 (dep_wavefront) on one
NVIDIA GPU, in about a minute.

    python3 tools/torch_lockgrant_probe.py

Builds B1's and B2's libraries and their earlier designs
(lock_grant_tile.cu, dep_wavefront_tile.cu) and prints nvcc's -Xptxas -v
report per kernel (it fails on a spill); holds every form bit-equal to
its plain version on random inputs: B1's fused form at T*K = 12 .. 4,096
and the engine's chain around the sorted form above that, B1's sorted
form and its earlier design at N = 1 .. 2^20, B2's row form at T = 1 ..
3,000 rows, B2's grouped-edge form and its earlier design at E = 1 ..
2^20; and times, in turns, on random inputs at the main path's shapes
(chip_smoke.py times them on inputs captured from full-width runs): the
new forms against the earlier designs, each fused launch against the
eager chain it replaces (graph replay and host-issued), and an empty
launch; then the sorted and grouped forms against their earlier designs
over N = 64 .. 65,536 (how their time grows with N), and the fused
form at the main path's T*K = 2,560 with 0, 10% and 40% of the entries
pending on 16 hot records, 64, or keys spread over the whole table.
Exits non-zero if a shape disagrees.
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels.dep_wavefront import ops as dw  # noqa: E402
from repro_torch.kernels.dep_wavefront.ref import (  # noqa: E402
    dep_wavefront_ref,
    dep_wavefront_rows_ref,
)
from repro_torch.kernels.lock_grant import ops as lg  # noqa: E402
from repro_torch.kernels.lock_grant.ref import (  # noqa: E402
    lock_grant_ref,
    lock_grant_step_ref,
)

STEPS = ((4, 3), (16, 10), (64, 10), (256, 10), (409, 10), (512, 8))
SIZES = (1, 40, 128, 768, 2048, 2560, 4096, 4097, 65536, 1 << 20)
ROWS = ((1, 1), (40, 1), (128, 1), (256, 3), (256, 8), (1500, 3), (3000, 2))


def holds(dev) -> list:
    """Every form against its plain version; the labels that disagree."""
    bad = []

    def check(label, got, want):
        if cs.max_abs_err(got, want) != 0:
            bad.append(label)
            print(f"BAD {label}")

    for i, (t, k) in enumerate(STEPS):
        for seed, R in enumerate((3, 50, 131072)):
            args = cs.random_step(t, k, R, 10 * i + seed, dev)
            check(f"fused T*K={t}*{k} R={R}",
                  (lg.lock_grant_step_cuda(*args),),
                  (lock_grant_step_ref(*args),))
    big = cs.random_step(512, 10, 1000, 99, dev)
    check("chain above the capacity",
          (engine.grant_chain(*cs.chain_inputs(big)[1],
                              lambda *a: lg.lock_grant_sorted(*a)[0]),),
          (lock_grant_step_ref(*big),))
    for i, n in enumerate(SIZES):
        args = cs.random_sorted_entries(n, seed=i, device=dev)
        want = lock_grant_ref(*args)
        check(f"sorted N={n}", lg.lock_grant_cuda(*args), want)
        check(f"earlier sorted N={n}", lg._lock_grant_tile(*args), want)
        args = cs.random_grouped_edges(n, seed=i, device=dev)
        want = dep_wavefront_ref(*args)
        check(f"grouped E={n}", dw.dep_wavefront_cuda(*args), want)
        check(f"earlier grouped E={n}", dw._dep_wavefront_tile(*args), want)
    for i, (t, p) in enumerate(ROWS):
        for seed in range(3):
            args = cs.random_rows(t, p, max(t // 2, 2), 10 * i + seed, dev)
            check(f"rows T={t} P={p}", (dw.dep_wavefront_rows_cuda(*args),),
                  (dep_wavefront_rows_ref(*args),))
    torch.cuda.synchronize()
    return bad


def timings(dev) -> None:
    """One reading in turns of each design at the main path's shapes."""
    step = cs.random_step(256, 10, 131072, 7, dev)
    sorted_args, chain_args = cs.chain_inputs(step)
    cs.print_turns("B1 sorted form at N=2,560", cs.in_turns({
        "kernel": lambda: lg.lock_grant_cuda(*sorted_args),
        "earlier design": lambda: lg._lock_grant_tile(*sorted_args),
    }, cs.graph_ms))
    out = lg.step_output(256, 10, step[7], dev)
    fns = {
        "fused launch": lambda: lg.lock_grant_step_cuda(*step, out=out),
        "chain (sorted-form kernel)": lambda: engine.grant_chain(
            *chain_args, lambda *a: lg.lock_grant_cuda(*a)[0]),
        "launch floor": lambda: lg._launch_floor(dev),
    }
    cs.print_turns("B1 grant pass at T*K = 256*10, graph replay",
                   cs.in_turns(fns, cs.graph_ms))
    fns["eager elementwise op"] = lambda: step[2] & step[3]
    cs.print_turns("B1 grant pass at T*K = 256*10, host-issued",
                   cs.in_turns(fns, cs.eager_ms))
    edges = cs.random_grouped_edges(2048, seed=5, device=dev)
    cs.print_turns("B2 grouped form at E=2,048", cs.in_turns({
        "kernel": lambda: dw.dep_wavefront_cuda(*edges),
        "earlier design": lambda: dw._dep_wavefront_tile(*edges),
    }, cs.graph_ms))
    rows = cs.random_rows(256, 8, 200, 5, dev)
    out = dw.rows_output(256, 8, rows[2].shape[0], dev)
    cs.print_turns("B2 row form at T=256, P=8, graph replay", cs.in_turns({
        "row form": lambda: dw.dep_wavefront_rows_cuda(*rows, out=out),
        "launch floor": lambda: dw._launch_floor(dev),
    }, cs.graph_ms))


def sweeps(dev) -> None:
    """Time against N for both designs of both scans; the fused form
    against the share of pending entries and their records' spread."""
    for n in (64, 512, 2048, 4096, 16384, 65536):
        a = cs.random_sorted_entries(n, seed=1, device=dev)
        e = cs.random_grouped_edges(n, seed=1, device=dev)
        cs.print_turns(f"sweep N={n}", cs.in_turns({
            "B1 sorted form": lambda: lg.lock_grant_cuda(*a),
            "B1 earlier design": lambda: lg._lock_grant_tile(*a),
            "B2 grouped form": lambda: dw.dep_wavefront_cuda(*e),
            "B2 earlier design": lambda: dw._dep_wavefront_tile(*e),
        }, cs.graph_ms))
    out = lg.step_output(256, 10, 131072, dev)
    rng = np.random.default_rng(3)
    for records in (16, 64, 131072):
        for share in (0.0, 0.1, 0.4):
            step = list(cs.random_step(256, 10, 131072, 3, dev))
            step[0] = torch.as_tensor(rng.integers(0, records, (256, 10)),
                                      dtype=torch.int32, device=dev)
            step[2] = torch.as_tensor(rng.random((256, 10)) < share,
                                      device=dev)
            if cs.max_abs_err((lg.lock_grant_step_cuda(*step, out=out),),
                              (lock_grant_step_ref(*step),)):
                raise AssertionError(f"fused form: {records} records, "
                                     f"{share} pending")
            cs.print_turns(
                f"B1 fused form at T*K = 256*10, keys over {records} "
                f"records, {share} of the entries pending",
                cs.in_turns({"fused launch": lambda: lg.lock_grant_step_cuda(
                    *step, out=out)}, cs.graph_ms))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), cs.gpu_name_and_power())
    t0 = time.time()
    builds = (lg._library, lg._tile_library, dw._library, dw._tile_library)
    with ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(b) for b in builds]:
            f.result()
    print(f"built in {time.time() - t0:.3f} s")
    cs.scan_build_report()
    bad = holds(dev)
    print(f"holds: {'all bit-equal' if not bad else bad} "
          f"({time.time() - t0:.3f} s)")
    if bad:
        return 1
    timings(dev)
    sweeps(dev)
    print(f"done in {time.time() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
