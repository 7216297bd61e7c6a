"""Quickstart on the PyTorch port: the two ORTHRUS design principles.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's counterpart of examples/quickstart.py, on the CUDA card unless
``--device cpu`` is given (without a card the default raises):

1. Runs a high-contention YCSB workload under dynamic 2PL (wait-die), under
   deadlock-free locking and under ORTHRUS (partitioned CC + planned
   acquisition) and prints the throughput gap, the paper's headline
   result. On the card ORTHRUS's grant pass is kernel B1 (lock_grant).
2. Shows the same P2 principle one level up: a planned MoE dispatch
   (canonical order, capacity-bounded) on a toy router. On the card the
   plan is kernel B3 (moe_dispatch_plan), on the CPU ``plan_dispatch``.
"""

import argparse

import torch

from repro_torch.core.engine import EngineConfig, resolve_device, run_simulation
from repro_torch.core.workloads import WorkloadConfig, make_workload
from repro_torch.kernels import use_kernel
from repro_torch.kernels.moe_dispatch.ops import moe_dispatch_plan
from repro_torch.models.moe import plan_dispatch

SIM = dict(max_rounds=6000, warmup_rounds=2000, chunk_rounds=2000,
           target_commits=100_000)
WORKLOAD = dict(kind="ycsb", num_txns=4096, num_records=1_000_000,
                num_hot=64, seed=0)
# the three engines of section 1, by label (32 cores each)
ENGINES = {
    "dynamic 2PL + wait-die": dict(protocol="twopl_waitdie", n_exec=32),
    "deadlock-free (P2)": dict(protocol="deadlock_free", n_exec=32),
    "ORTHRUS (P1+P2)": dict(protocol="orthrus", n_cc=8, n_exec=24, window=4),
}
TOKENS, EXPERTS, CAPACITY = 64, 4, 16


def contention(device, sim=SIM, workload=WORKLOAD) -> dict:
    """Section 1: each engine's ``SimResult`` by label, printed as it
    comes."""
    print("=== 1. OLTP under high contention (64 hot records, 32 cores) ===")
    wl = make_workload(WorkloadConfig(**workload))
    out = {}
    for label, kw in ENGINES.items():
        res = run_simulation(EngineConfig(**kw, **sim), wl, device=device)
        print(
            f"{label:24s} {res.throughput_txn_s/1e3:8.1f}k txn/s  "
            f"deadlock aborts: {res.aborts_deadlock:6d}  "
            f"useful-work fraction: {res.breakdown['exec']:.2f}"
        )
        out[label] = res
    return out


def router_probs(device, seed: int = 0) -> torch.Tensor:
    """A toy router's probabilities, f32 [TOKENS, EXPERTS]: softmax of
    2 x standard normal logits from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn(TOKENS, EXPERTS, generator=gen) * 2.0
    return torch.softmax(logits, -1).to(device)


def plan(probs: torch.Tensor) -> dict:
    """The top-1 dispatch plan at CAPACITY slots an expert: kernel B3
    where ``use_kernel`` picks it (a CUDA tensor), else the plain
    ``plan_dispatch``."""
    if use_kernel("auto", probs.device):
        return moe_dispatch_plan(probs, top_k=1, capacity=CAPACITY)
    return plan_dispatch(probs, 1, CAPACITY)


def dispatch(probs: torch.Tensor) -> dict:
    """Section 2: plan ``probs`` and print each expert's slots."""
    print("\n=== 2. The same planning principle as an MoE dispatch plan ===")
    p = plan(probs)
    slots = p["slot_token"].reshape(EXPERTS, CAPACITY).cpu()
    for e in range(EXPERTS):
        row = [int(t) for t in slots[e] if t >= 0]
        print(f"expert {e}: {len(row):2d}/{CAPACITY} slots -> tokens "
              f"{row[:8]}{'...' if len(row) > 8 else ''}")
    print("load per expert:", [round(float(x), 2) for x in p["load"].cpu()])
    print("\n(The plan is computed before any expert runs, in canonical "
          "(expert, arrival) order — the deadlock-free lock schedule, "
          "as an all-to-all schedule.)")
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    contention(device)
    dispatch(router_probs(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
