#!/usr/bin/env python3
"""Quick check of kernel B3 (moe_dispatch) on one NVIDIA GPU, in about a
minute.

    python3 tools/torch_moe_dispatch_probe.py

Builds B3's library and prints nvcc's -Xptxas -v report per kernel (it
fails on a spill); holds the fused plan (top-k, positions, dispatch
table and load in one launch) bit-equal to the plain plan on random
router probabilities (N = 1 .. 65,536, E 4, 8, 128 and 256, top 1, 2 and
3, rows with ties, capacities that drop and that do not), the eager
chain around the sorted form likewise at a few shapes, and the sorted
form bit-equal to its plain version on random sorted ids (N = 1 ..
2^20); then times, in turns, on random probabilities at mixtral-8x22b's
shapes (a 3,000-token prefill: N 3,000, E 8, top 2, capacity 1,024; a
decode step at 8 slots: N 8, capacity 128) the fused launch, the chain
and the plain plan (graph replay and host-issued) and the sorted form
against its plain version, and the fused launch against the chain over
N = 8 .. 65,536 (chip_smoke.py times them on probabilities captured from
a full-width run). Exits non-zero if a shape disagrees.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import dispatch_slots_ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402

SIZES = (1, 7, 16, 1000, 1023, 1024, 1025, 3000, 6000, 65536)
EXPERTS = ((4, (1, 2)), (8, (1, 2, 3)), (128, (1, 2)), (256, (1,)))
SHAPES = ((f"a {cs.MIXTRAL_CHECK_SEQ}-token prefill", cs.MIXTRAL_CHECK_SEQ,
           1024), (f"a decode step at {cs.SERVE_SLOTS} slots",
                   cs.SERVE_SLOTS, 128))


def plans_equal(got, want) -> bool:
    return all(torch.equal(got[f], want[f])
               for f in ("slot_token", "slot_weight", "load"))


def holds(dev) -> list:
    """Every form against its plain version; the labels that disagree."""
    bad = []

    def check(label, ok):
        if not ok:
            bad.append(label)
            print(f"BAD {label}")

    for n in SIZES:
        for E, top_ks in EXPERTS:
            for k in top_ks:
                for ties in (False, True):
                    probs = cs.random_router_probs(n, E, n + E + k, dev, ties)
                    for cap in (n * k // (2 * E), n):
                        check(f"fused N={n} E={E} top {k} ties {ties} "
                              f"capacity {cap}",
                              plans_equal(ops.moe_dispatch_plan_cuda(
                                  probs, top_k=k, capacity=cap),
                                  moe.plan_dispatch(probs, k, cap)))
    for n, cap in ((8, 128), (3000, 1024), (3000, 640), (65536, 16384)):
        probs = cs.random_router_probs(n, 8, n, dev, ties=True)
        check(f"chain N={n} capacity {cap}",
              plans_equal(ops.moe_dispatch_chain(probs, top_k=2, capacity=cap),
                          moe.plan_dispatch(probs, 2, cap)))
    for n in (1, 16, 1000, 1024, 1025, 6000, 65536, 1 << 20):
        ids = cs.random_expert_ids(n, 8, n, dev)
        for cap in ((n - n // 8) // 16, n):
            check(f"sorted form N={n} capacity {cap}", cs.max_abs_err(
                ops.dispatch_positions_cuda(ids, cap, 8),
                dispatch_slots_ref(ids, cap, 8)) == 0)
    torch.cuda.synchronize()
    return bad


def timings(dev) -> None:
    """In turns, at mixtral-8x22b's two shapes."""
    for name, n, cap in SHAPES:
        probs = cs.random_router_probs(n, 8, 11, dev)
        fns = {
            "fused launch": lambda: ops.moe_dispatch_plan_cuda(
                probs, top_k=2, capacity=cap),
            "chain (sorted form)": lambda: ops.moe_dispatch_chain(
                probs, top_k=2, capacity=cap),
            "plain plan": lambda: moe.plan_dispatch(probs, 2, cap),
        }
        cs.print_turns(f"B3 plan at {name}, graph replay",
                       cs.in_turns(fns, cs.graph_ms))
        cs.print_turns(f"B3 plan at {name}, host-issued",
                       cs.in_turns(fns, cs.eager_ms))
        ids = cs.sorted_expert_ids(probs, 2)
        cs.print_turns(f"B3 sorted form at {name} ({ids.shape[0]} entries)",
                       cs.in_turns({
                           "sorted form": lambda: ops.dispatch_positions_cuda(
                               ids, cap, 8),
                           "its plain version": lambda: dispatch_slots_ref(
                               ids, cap, 8),
                       }, cs.graph_ms))
        bound_ms, bound_by, n_bytes = cs.plan_bound(n, 8, 2, cap)
        print(f"B3 plan bound at {name}: {bound_ms:.9f} ms ({bound_by}, "
              f"{n_bytes} B)")


def sweeps(dev) -> None:
    """The fused launch against the chain over N (E 8, top 2, mixtral's
    capacity for N tokens)."""
    for n in (8, 64, 512, 1024, 3000, 8192, 16384, 65536):
        cap = moe.capacity_for(n, 2, 8, 1.25)
        probs = cs.random_router_probs(n, 8, n, dev)
        cs.print_turns(f"sweep N={n} capacity {cap}", cs.in_turns({
            "fused launch": lambda: ops.moe_dispatch_plan_cuda(
                probs, top_k=2, capacity=cap),
            "chain (sorted form)": lambda: ops.moe_dispatch_chain(
                probs, top_k=2, capacity=cap),
        }, cs.graph_ms))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), cs.gpu_name_and_power())
    t0 = time.time()
    ops._library()
    print(f"built in {time.time() - t0:.3f} s")
    cs.scan_build_report(("moe_dispatch",))
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
