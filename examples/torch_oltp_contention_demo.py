"""Sweep contention and watch the protocols separate (paper Fig 4b),
then watch fragment-granular batch execution un-serialize a
multi-partition workload (QueCC exec model + DGCC §5 pipelining), starve
the batch planner (planner-lane throughput model), and overload the
engine with and without admission control, on the PyTorch port.

  PYTHONPATH=src python examples/torch_oltp_contention_demo.py [--device cpu]

The port's counterpart of examples/oltp_contention_demo.py, on the CUDA
card unless ``--device cpu`` is given (without a card the default
raises). On the card every dgcc and quecc step runs kernel B2
(dep_wavefront). Set REPRO_DEMO_FAST=1 for the trimmed budget.
"""

import argparse
import os

from repro_torch.core.engine import EngineConfig, resolve_device, run_simulation
from repro_torch.core.workloads import WorkloadConfig, make_workload

# every stanza's workload is YCSB at this size
SIZE = dict(num_txns=4096, num_records=1_000_000)
PROTOS = ("deadlock_free", "twopl_waitdie", "twopl_dreadlocks", "dgcc")
# fragment-granular batch execution. Every transaction below spans two
# partitions. Txn-granular quecc chains the *whole* transaction through
# both per-lane queues, so one hot lane serializes it end to end;
# fragment mode schedules each (txn, lane) fragment independently and
# commits when all fragments are done, and inter-batch pipelining admits
# the next batch's level-0 fragments while the current batch drains.
VARIANTS = (
    ("quecc (txn)", dict(protocol="quecc")),
    ("quecc (frag)", dict(protocol="quecc", fragment_exec=True)),
    ("quecc (frag+pipe)", dict(protocol="quecc", fragment_exec=True,
                               inter_batch_pipeline=True)),
    ("dgcc (frag+pipe)", dict(protocol="dgcc", fragment_exec=True,
                              inter_batch_pipeline=True)),
)
POLICIES = (
    ("no admission control", {}),
    ("bounded backlog (cap 64)",
     dict(admission_policy="bounded_backlog", backlog_cap=64)),
    ("deadline shed (1000 rounds)",
     dict(admission_policy="deadline_shed", deadline_rounds=1000)),
)


def budget(fast: bool) -> dict:
    """The simulation budget: the full demo's, or REPRO_DEMO_FAST's."""
    return dict(max_rounds=4000 if fast else 8000,
                warmup_rounds=1000 if fast else 2000,
                chunk_rounds=1000 if fast else 2000, target_commits=100_000)


def _cell(eng_kw, wcfg, wl, sim, device):
    """One simulation: (EngineConfig, WorkloadConfig, SimResult)."""
    cfg = EngineConfig(**eng_kw, **sim)
    return cfg, wcfg, run_simulation(cfg, wl, device=device)


def _workload(size, **kw):
    wcfg = WorkloadConfig(kind="ycsb", seed=0, **size, **kw)
    return wcfg, make_workload(wcfg)


def _rate(res) -> str:
    return f"{res.throughput_txn_s/1e3:15.1f}k/s"


def contention_sweep(device, sim, fast, size=SIZE) -> list:
    """Fig 4b: the four protocols over shrinking hot sets. Returns each
    cell as (EngineConfig, WorkloadConfig, SimResult)."""
    cells = []
    print(f"{'hot records':>12s} " + " ".join(f"{p:>18s}" for p in PROTOS))
    for hot in ((256, 16) if fast else (4096, 256, 64, 16)):
        wcfg, wl = _workload(size, num_hot=hot)
        row = []
        for p in PROTOS:
            # core-for-core fair: dgcc splits the 48-core budget into
            # worker + planner lanes (paper §4.2 thread-allocation regime)
            n_cc = 8 if p == "dgcc" else 0
            cells.append(_cell(dict(protocol=p, n_exec=48 - n_cc, n_cc=n_cc),
                               wcfg, wl, sim, device))
            row.append(_rate(cells[-1][2]))
        print(f"{hot:12d} " + " ".join(f"{v:>18s}" for v in row))
    print("\ncontention grows downward; deadlock-free locking's advantage "
          "grows with it (paper Fig 4b)\n")
    return cells


def fragment_sweep(device, sim, fast, size=SIZE) -> list:
    """Txn- against fragment-granular batch execution over the share of
    multi-partition txns."""
    cells = []
    print(f"{'multipart %':>12s} "
          + " ".join(f"{n:>18s}" for n, _ in VARIANTS))
    for frac in ((0.2, 1.0) if fast else (0.2, 0.6, 1.0)):
        wcfg, wl = _workload(size, num_hot=64, multipart_frac=frac,
                             num_partitions=16, batch_epoch=512)
        row = []
        for _name, kw in VARIANTS:
            cells.append(_cell(dict(n_exec=40, n_cc=8, window=4, **kw),
                               wcfg, wl, sim, device))
            row.append(_rate(cells[-1][2]))
        print(f"{int(frac*100):11d}% " + " ".join(f"{v:>18s}" for v in row))
    print("\nthe fragment engine's margin grows with the multi-partition "
          "fraction: per-lane fragments run on different exec lanes in "
          "different rounds and join at commit\n")
    return cells


def planner_saturation(device, sim, size=SIZE) -> list:
    """The batch-planned family's hidden cost: every batch must be
    *planned* before it can run. With the planner-lane throughput model
    (n_planner_lanes = L), batch g arrives every epoch_interval_rounds
    rounds and is planned end-to-end by lane g % L: at a high epoch rate
    a single lane saturates, plans queue, and execution starves no matter
    how many exec lanes are idle. Low contention on purpose: execution is
    fast there, which is exactly where planning becomes the bottleneck."""
    cells = []
    wcfg, wl = _workload(size, num_hot=0, batch_epoch=256)
    print(f"{'planner lanes':>14s} {'throughput':>14s} {'lane util':>10s} "
          f"{'plan-queue delay':>17s}")
    for lanes in (1, 2, 4):
        cells.append(_cell(dict(protocol="dgcc", n_exec=32, n_cc=4, window=2,
                                n_planner_lanes=lanes,
                                epoch_interval_rounds=100),
                           wcfg, wl, sim, device))
        res = cells[-1][2]
        util = res.raw["plan_busy"] / max(lanes * res.rounds, 1)
        print(f"{lanes:14d} {res.throughput_txn_s/1e3:12.1f}k/s "
              f"{util:10.2f} {res.raw['plan_qdelay']:10d} rounds")
    print("\none planner lane saturates (util ~1) and its plan queue backs "
          "up; adding planner lanes drains the queue until execution is "
          "the bottleneck again — the fig15 planning-cost crossover "
          "mechanism\n")
    return cells


def overload(device, sim, size=SIZE) -> list:
    """Open the loop at ~2x the high-contention capacity knee: 64-txn
    epochs arrive on a fixed schedule whether or not the engine keeps
    up. Without admission control the backlog and the queueing tail grow
    with the horizon; a bounded backlog or a queueing deadline sheds the
    excess at arrival, holding p99 and the queue while committed
    throughput stays at capacity."""
    cells = []
    wcfg, wl = _workload(size, num_hot=16, batch_epoch=64)
    print(f"{'admission policy':>28s} {'goodput':>12s} {'p99':>8s} "
          f"{'backlog':>8s} {'dropped':>8s}")
    for name, kw in POLICIES:
        cells.append(_cell(dict(protocol="deadlock_free", n_exec=48,
                                epoch_interval_rounds=200, **kw),
                           wcfg, wl, sim, device))
        res = cells[-1][2]
        m = res.metrics
        print(f"{name:>28s} {res.throughput_txn_s/1e3:10.1f}k/s "
              f"{m.p99:8d} {int(max(m.q_depth)):8d} "
              f"{m.rejected + m.shed:8d}")
    print("\nsame committed throughput, but with admission control the "
          "excess load lands in the drop counters instead of the queue — "
          "p99 and the backlog stay bounded as the horizon grows")
    return cells


def demo(device, fast, sim=None, size=SIZE) -> dict:
    """The four stanzas in order; each one's cells by stanza name."""
    sim = budget(fast) if sim is None else sim
    return {
        "contention": contention_sweep(device, sim, fast, size),
        "fragments": fragment_sweep(device, sim, fast, size),
        "planner": planner_saturation(device, sim, size),
        "overload": overload(device, sim, size),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fast = os.environ.get("REPRO_DEMO_FAST", "0").lower() in (
        "1", "true", "yes")
    demo(resolve_device(args.device), fast)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
