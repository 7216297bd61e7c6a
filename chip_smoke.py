#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

  1. build   — compile every CUDA kernel of the path from this checkout,
               all at once (``nvcc`` for sm_90a, one process per source,
               into build/repro_torch_kernels/);
  2. kernels — hold each kernel bit-equal (integers, tolerance 0) to its
               plain PyTorch version on the card, and time both (CUDA
               graph replays): lock_grant on the entries of a real
               full-width ORTHRUS round (N = T*K = 2,560) and on random
               sorted inputs at N = 1,024 .. 2^20; dep_wavefront on the
               edges of a real scan of each full-width batch cell below
               (E = T*P = 768, 2,048, 128, 40), each also through the
               engine's row form against the dense check, and on random
               grouped inputs at E = 40 .. 2^20 (tile multiples and
               not), plus its whole wrapper against the dense oracle;
  3. goldens — replay the nine ported cells of tests/golden/ on the card,
               bit-exactly;
  4. main path, slice 1 — YCSB at the paper's width (10 M records, 64
               hot, 8,192 txns) through ``run_simulation``: orthrus (16 CC
               + 64 exec lanes, window 4) through lock_grant, the same
               cell on the plain path (identical fingerprint required),
               and deadlock_free on 80 exec lanes; a step profile of each;
  5. main path, slice 2 — the batch-planned engine at the paper's width:
               dgcc and quecc (16 planner + 64 exec lanes, window 4),
               quecc with fragments and inter-batch pipelining (fig14's
               16-hot multi-partition cell, 8 + 32 lanes) and scheduled
               (fig18's cell, 40 lanes), each through dep_wavefront and
               on the plain path (identical fingerprints, metrics
               included); dep_wavefront launches = steps on every kernel
               run; step profiles of dgcc on both paths and of
               quecc_frag_pipe.

Each path sets the kernels' launch counts to 0 just before it and reads
them just after. Then it prints the kernels' JSON line, the card's name
and power limit, and, last, ``{"ok": true, "device": {...}}``. It needs
one CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
GOLDEN_CELLS = ("orthrus", "deadlock_free", "deadlock_free_tpcc_ollp",
                "dgcc", "quecc", "scheduled", "dgcc_frag", "quecc_frag",
                "quecc_frag_pipe")

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # non-tensor-core rate; int32 adds and compares

# The paper's width (benchmarks/figures.py): YCSB at 10 M records, 80 cores
YCSB_FULL = dict(kind="ycsb", num_txns=8192, num_records=10_000_000,
                 num_hot=64, seed=0)
SIM_FULL = dict(max_rounds=6000, warmup_rounds=2000, chunk_rounds=2000,
                target_commits=10**9)
ORTHRUS_FULL = dict(protocol="orthrus", n_cc=16, n_exec=64, window=4)
DF_FULL = dict(protocol="deadlock_free", n_exec=80)
# The batch-planned cells (benchmarks/figures.py): fig13's 80-core split
# of dgcc and quecc on YCSB_FULL; fig14's 16-hot multi-partition cell
# with fragments and inter-batch pipelining; fig18's scheduled cell
DGCC_FULL = dict(protocol="dgcc", n_cc=16, n_exec=64, window=4)
QUECC_FULL = dict(protocol="quecc", n_cc=16, n_exec=64, window=4)
YCSB_FIG14 = dict(YCSB_FULL, num_hot=16, multipart_frac=1.0,
                  num_partitions=16)
QUECC_FRAG_PIPE_FULL = dict(protocol="quecc", n_cc=8, n_exec=32, window=4,
                            fragment_exec=True, inter_batch_pipeline=True)
YCSB_FIG18 = dict(YCSB_FULL, hot_per_txn=1)
SCHEDULED_FULL = dict(protocol="scheduled", n_exec=40)
BATCH_CELLS = (("dgcc", DGCC_FULL, YCSB_FULL),
               ("quecc", QUECC_FULL, YCSB_FULL),
               ("quecc_frag_pipe", QUECC_FRAG_PIPE_FULL, YCSB_FIG14),
               ("scheduled", SCHEDULED_FULL, YCSB_FIG18))


def fingerprint(res, include_metrics: bool = False) -> dict:
    """Everything a run reports except wall-clock (the keys of
    tests/golden/regenerate.py's ``fingerprint``)."""
    fp = dict(
        commits=res.commits,
        aborts_deadlock=res.aborts_deadlock,
        aborts_ollp=res.aborts_ollp,
        wasted_ops=res.wasted_ops,
        rounds=res.rounds,
        sim_seconds=res.sim_seconds,
        breakdown=res.breakdown,
        total_commits=res.raw["total_commits"],
        next_txn=res.raw["next_txn"],
        rounds_total=res.raw["rounds_total"],
        steps_executed=res.raw["steps_executed"],
    )
    if include_metrics and res.metrics is not None:
        m = res.metrics
        fp["lat_hist"] = [int(x) for x in m.lat_hist]
        fp["q_depth"] = [int(x) for x in m.q_depth]
        fp["q_inflight"] = [int(x) for x in m.q_inflight]
        fp["p50_rounds"] = m.p50
        fp["p99_rounds"] = m.p99
        fp["p999_rounds"] = m.p999
    return fp


def eager_ms(fn, repeats: int = 200, warmup: int = 10) -> float:
    """Milliseconds per ``fn()`` issued back to back from the host: CUDA
    events around ``repeats`` calls. Where the host issues work slower
    than the card runs it, this is the host's rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(repeats):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / repeats


def graph_ms(fn, repeats: int = 100, samples: int = 21) -> float:
    """Device milliseconds per ``fn()``: ``repeats`` calls captured in one
    CUDA graph, the graph replayed between CUDA events; the median of
    ``samples`` replays. No host work is inside the timed span."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / repeats)
    times.sort()
    return times[len(times) // 2]


def max_abs_err(got, want) -> int:
    """Largest absolute difference over matching integer/bool outputs."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output {g.shape} {g.dtype} vs plain "
                                 f"{w.shape} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def random_sorted_entries(n: int, seed: int, device):
    """Random kernel inputs sorted by key: long runs of one key, runs that
    cross 1,024-entry tiles, every REQ_* kind, inactive entries inside
    runs, and a KEY_SENTINEL padding tail."""
    import numpy as np
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL, REQ_NONE

    rng = np.random.default_rng(seed)
    n_pad = n // 16
    m = n - n_pad
    # geometric run lengths, a few runs thousands of entries long
    lens = np.minimum(rng.geometric(1 / 40, size=m // 10 + 1), m)
    lens[rng.random(len(lens)) < 0.02] *= 60
    runs = np.repeat(np.arange(len(lens)), lens)[:m]
    keys = np.concatenate([runs * 3, np.full(n_pad, KEY_SENTINEL)])
    kind = rng.integers(0, 4, n)
    kind[m:] = REQ_NONE
    wh_free = rng.random(n) < 0.7
    rc = np.where(rng.random(n) < 0.6, 0, rng.integers(1, 4, n))

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return (t(keys, torch.int32), t(kind, torch.int32),
            t(wh_free, torch.bool), t(rc, torch.int32))


def random_requests(n: int, num_records: int, seed: int, device):
    """Unsorted wrapper inputs: keys up to 2 * num_records (so some lie
    past the lock table), unique stamps, all REQ_* kinds, and a lock
    table with write holders and read counts."""
    import numpy as np
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL, REQ_NONE

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 * num_records, n)
    kind = rng.integers(0, 4, n)
    keys = np.where(kind == REQ_NONE, KEY_SENTINEL, keys)
    ts = rng.permutation(n)
    wh = np.where(rng.random(num_records) < 0.3, 5, -1)
    rc = np.where(rng.random(num_records) < 0.3, rng.integers(1, 4,
                                                              num_records), 0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return t(keys), t(ts), t(kind), t(wh), t(rc)


def capture_orthrus_round(device, max_rounds: int = 400):
    """The kernel's inputs (sorted entries) of the last ORTHRUS grant pass
    of a short full-width run."""
    from repro_torch.core.engine import EngineConfig, run_simulation
    from repro_torch.core.workloads import WorkloadConfig, make_workload
    from repro_torch.kernels.lock_grant import ops

    captured = []
    original = ops.lock_grant_sorted

    def capture(*args):
        captured[:] = [a.clone() for a in args]
        return original(*args)

    ops.lock_grant_sorted = capture
    try:
        run_simulation(
            EngineConfig(**ORTHRUS_FULL, max_rounds=max_rounds,
                         warmup_rounds=0, chunk_rounds=max_rounds,
                         target_commits=10**9, kernel_impl="pallas"),
            make_workload(WorkloadConfig(**YCSB_FULL)),
            device=device,
        )
    finally:
        ops.lock_grant_sorted = original
    if not captured:
        raise AssertionError("the ORTHRUS run made no grant pass")
    return captured


def check_lock_grant(device, sizes=(1024, 4096, 65536, 1 << 20)) -> dict:
    """Phase 2: lock_grant against its plain version, bit-equal."""
    import torch

    from repro_torch.core.lockgrant import grant_round
    from repro_torch.kernels.lock_grant import ops
    from repro_torch.kernels.lock_grant.ref import lock_grant_ref

    kernel = ops.lock_grant_sorted
    err = 0
    main = capture_orthrus_round(device)
    n_main = main[0].shape[0]
    err = max(err, max_abs_err(kernel(*main), lock_grant_ref(*main)))
    print(f"lock_grant: N={n_main} entries of a full-width ORTHRUS round: "
          f"bit-equal (max_abs_err {err})")
    for i, n in enumerate(sizes):
        args = random_sorted_entries(n, seed=i, device=device)
        e = max_abs_err(kernel(*args), lock_grant_ref(*args))
        keys, ts, kind, wh, rc = random_requests(n, n // 8, seed=i,
                                                 device=device)
        g1, c1 = ops.lock_grant(keys, ts, kind, wh, rc, num_records=n // 8,
                                block_n=1024)
        g0, c0, _ = grant_round(keys, ts, kind, wh, rc, n // 8)
        e = max(e, max_abs_err((g1, c1), (g0, c0)))
        print(f"lock_grant: random N={n}: sorted entries and full wrapper "
              f"bit-equal (max_abs_err {e})")
        err = max(err, e)
    if err:
        raise AssertionError(f"lock_grant disagrees with its plain version "
                             f"(max_abs_err {err})")
    # device time per call, from CUDA graph replays; the host-issued
    # rate beside it is what the eager step loop sees
    ms = graph_ms(lambda: ops.lock_grant_cuda(*main))
    plain_ms = graph_ms(lambda: lock_grant_ref(*main))
    print(f"lock_grant eager (host-issued) at N={n_main}: kernel wrapper "
          f"{eager_ms(lambda: ops.lock_grant_cuda(*main)):.6f} ms, plain "
          f"{eager_ms(lambda: lock_grant_ref(*main)):.6f} ms")
    # each input read once (keys, kind, rc: 4 B; wh_free: 1 B), each
    # output written once (grant: 1 B; req_pos, wbefore, op_pos: 4 B)
    n_bytes = n_main * (4 + 4 + 1 + 4 + 1 + 4 + 4 + 4)
    # per entry: 4 compares for the segment flag and kinds, 3 running
    # sums, the carry select, 6 for the grant test
    n_ops = n_main * 14
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    print(f"lock_grant device time at N={n_main}: kernel {ms:.6f} ms, "
          f"plain {plain_ms:.6f} ms, bound {max(bytes_ms, ops_ms):.9f} ms")
    return dict(
        name="lock_grant",
        route="cuda",
        source="src/repro_torch/kernels/lock_grant/csrc/lock_grant.cu",
        replaces="src/repro/kernels/lock_grant/kernel.py:84",
        launches=0,
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,
    )


def random_grouped_edges(n: int, seed: int, device):
    """Random kernel inputs grouped by dst: geometric runs, a few runs
    thousands of edges long (crossing 1,024-edge tiles), padding entries
    inside the list and a KEY_SENTINEL padding tail."""
    import numpy as np
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL

    rng = np.random.default_rng(seed)
    lens = rng.geometric(1 / 12, size=n)
    lens[rng.random(n) < 0.02] *= 150
    dst = np.repeat(np.arange(len(lens)), lens)[:n]
    dst = np.where(rng.random(n) < 0.05, KEY_SENTINEL, dst)
    dst[n - n // 16:] = KEY_SENTINEL
    ok = rng.random(n) < 0.7
    return (torch.as_tensor(dst, dtype=torch.int32, device=device),
            torch.as_tensor(ok, dtype=torch.bool, device=device))


def random_dependency_edges(n: int, n_units: int, seed: int, device):
    """Unsorted wrapper inputs: edges between random units, padding
    entries mixed in, and a random committed bitmap."""
    import numpy as np
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL

    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_units, n)
    dst = np.where(rng.random(n) < 0.1, KEY_SENTINEL, dst)
    src = rng.integers(0, n_units, n)
    done = rng.random(n_units) < 0.8

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=device)

    return t(dst, torch.int32), t(src, torch.int32), t(done, torch.bool)


def capture_scan(eng_kw, wl_kw, device, max_rounds: int = 1500):
    """The inputs (slot units, predecessor rows, their committed flags)
    of the readiness scan with the most live edges in a short run of one
    full-width batch cell."""
    from repro_torch.core.engine import EngineConfig, run_simulation
    from repro_torch.core.workloads import WorkloadConfig, make_workload
    from repro_torch.kernels.dep_wavefront import ops

    captured = []
    most = [-1]
    original = ops.dep_wavefront_rows

    def capture(*args):
        live = int((args[1] >= 0).sum())
        if live >= most[0]:
            most[0] = live
            captured[:] = [a.clone() for a in args]
        return original(*args)

    ops.dep_wavefront_rows = capture
    try:
        run_simulation(
            EngineConfig(**eng_kw, max_rounds=max_rounds, warmup_rounds=0,
                         chunk_rounds=max_rounds, target_commits=10**9,
                         kernel_impl="pallas"),
            make_workload(WorkloadConfig(**wl_kw)),
            device=device,
        )
    finally:
        ops.dep_wavefront_rows = original
    if not captured:
        raise AssertionError(f"{eng_kw}: the run made no readiness scan")
    return captured


def check_dep_wavefront(device, sizes=(40, 128, 768, 1000, 1024, 3000, 4096,
                                       65536, 1 << 20)) -> dict:
    """Phase 2: dep_wavefront against its plain version, bit-equal, on the
    scans of the four full-width batch cells and on random edges."""
    import torch

    from repro_torch.core.lockgrant import KEY_SENTINEL
    from repro_torch.kernels.dep_wavefront import ops
    from repro_torch.kernels.dep_wavefront.ref import dep_wavefront_ref

    kernel = ops.dep_wavefront_sorted
    err = 0
    shapes = {}
    for name, eng_kw, wl_kw in BATCH_CELLS:
        row_unit, preds, src_ok = capture_scan(eng_kw, wl_kw, device)
        dst = torch.where(preds >= 0, row_unit[:, None],
                          KEY_SENTINEL).reshape(-1)
        ok = src_ok.reshape(-1)
        e_cell = dst.shape[0]
        live = int((dst != KEY_SENTINEL).sum())
        e = max_abs_err(kernel(dst, ok), dep_wavefront_ref(dst, ok))
        dense = ((preds < 0) | src_ok).all(dim=1)
        e = max(e, max_abs_err((ops.dep_wavefront_rows(row_unit, preds,
                                                       src_ok),), (dense,)))
        print(f"dep_wavefront: E={e_cell} edges ({live} live, "
              f"T={preds.shape[0]} rows of P={preds.shape[1]}) of a "
              f"full-width {name} scan: bit-equal, the engine's row form "
              f"equal to the dense check (max_abs_err {e})")
        err = max(err, e)
        shapes[name] = (dst, ok, row_unit, preds, src_ok)
    for i, n in enumerate(sizes):
        args = random_grouped_edges(n, seed=i, device=device)
        e = max_abs_err(kernel(*args), dep_wavefront_ref(*args))
        n_units = max(n // 8, 2)
        edst, esrc, done = random_dependency_edges(n, n_units, seed=i,
                                                   device=device)
        got = ops.dep_wavefront_ready(edst, esrc, done, num_txns=n_units,
                                      block_n=1024)
        plain = ops.dep_wavefront_ready(edst.cpu(), esrc.cpu(), done.cpu(),
                                        num_txns=n_units, block_n=1024)
        live_e = edst != KEY_SENTINEL
        oracle = torch.ones(n_units + 1, dtype=torch.int32, device=device)
        oracle.scatter_reduce_(
            0, torch.where(live_e, edst, n_units).long(),
            done[esrc.long()].to(torch.int32), "amin", include_self=True)
        e = max(e, max_abs_err((got,), (plain.to(device),)),
                max_abs_err((got,), (oracle[:n_units] > 0,)))
        print(f"dep_wavefront: random E={n}: grouped edges and the whole "
              f"wrapper ({n_units} units) bit-equal (max_abs_err {e})")
        err = max(err, e)
    if err:
        raise AssertionError(f"dep_wavefront disagrees with its plain version "
                             f"(max_abs_err {err})")
    # device time at every main-path shape; the JSON row takes the largest
    for name, (dst, ok, row_unit, preds, src_ok) in shapes.items():
        ms = graph_ms(lambda: ops.dep_wavefront_cuda(dst, ok))
        plain_ms = graph_ms(lambda: dep_wavefront_ref(dst, ok))
        rows_ms = graph_ms(
            lambda: ops.dep_wavefront_rows(row_unit, preds, src_ok))
        dense_ms = graph_ms(lambda: ((preds < 0) | src_ok).all(dim=1))
        print(f"dep_wavefront device time at E={dst.shape[0]} ({name}): "
              f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms; the engine's "
              f"stage 4: kernel path (rows) {rows_ms:.6f} ms, plain path "
              f"(dense) {dense_ms:.6f} ms")
        shapes[name] += (ms, plain_ms)
    name = max(shapes, key=lambda k: shapes[k][0].shape[0])
    dst, ok, _, _, _, ms, plain_ms = shapes[name]
    e_main = dst.shape[0]
    print(f"dep_wavefront eager (host-issued) at E={e_main}: kernel wrapper "
          f"{eager_ms(lambda: ops.dep_wavefront_cuda(dst, ok)):.6f} ms, plain "
          f"{eager_ms(lambda: dep_wavefront_ref(dst, ok)):.6f} ms")
    # each input read once (dst: 4 B, src_ok: 1 B), each output written
    # once (miss, pos: 4 B each)
    n_bytes = e_main * (4 + 1 + 4 + 4)
    # per edge: the segment flag and the padding test, the miss test, two
    # running sums, the carry select
    n_ops = e_main * 6
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    print(f"dep_wavefront at E={e_main} ({name}): kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, bound {max(bytes_ms, ops_ms):.9f} ms")
    return dict(
        name="dep_wavefront",
        route="cuda",
        source="src/repro_torch/kernels/dep_wavefront/csrc/dep_wavefront.cu",
        replaces="src/repro/kernels/dep_wavefront/kernel.py:75",
        launches=0,
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,
    )


def replay_goldens(device) -> None:
    """Phase 3: the golden fixtures, bit-exactly, on ``device``."""
    from repro_torch.core.engine import EngineConfig, run_simulation
    from repro_torch.core.workloads import WorkloadConfig, make_workload

    for name in GOLDEN_CELLS:
        g = json.loads((GOLDEN / f"{name}.json").read_text())
        cfg = EngineConfig(**g["engine"], **g["sim"])
        t0 = time.time()
        res = run_simulation(cfg, make_workload(WorkloadConfig(**g["workload"])),
                             device=device)
        got = fingerprint(res)
        if got != g["trace"]:
            diff = {k: (got[k], g["trace"].get(k)) for k in got
                    if got[k] != g["trace"].get(k)}
            raise AssertionError(f"golden {name} diverged: {diff}")
        print(f"golden {name}: bit-exact ({time.time() - t0:.3f} s)")


def run_cell(name, eng_kw, workload, device, **extra):
    from repro_torch.core.engine import EngineConfig, run_simulation

    cfg = EngineConfig(**eng_kw, **SIM_FULL, **extra)
    t0 = time.time()
    res = run_simulation(cfg, workload, device=device)
    wall = time.time() - t0
    steps = res.raw["steps_executed"]
    rounds = res.raw["rounds_total"]
    for v in (res.throughput_txn_s, *res.breakdown.values()):
        if v != v or abs(v) == float("inf"):
            raise AssertionError(f"{name}: non-finite result {v}")
    if res.commits <= 0 or res.aborts_deadlock != 0:
        raise AssertionError(f"{name}: {res.commits} commits, "
                             f"{res.aborts_deadlock} deadlock aborts")
    print(f"{name}: commits {res.commits}, simulated throughput_txn_s "
          f"{res.throughput_txn_s}, steps_executed {steps}, rounds "
          f"{rounds}, wall {wall:.3f} s, rounds/wall-s {rounds / wall:.1f}, "
          f"steps/wall-s {steps / wall:.1f}")
    return res


def make_full_workload(wl_kw):
    from repro_torch.core.workloads import WorkloadConfig, make_workload

    t0 = time.time()
    wl = make_workload(WorkloadConfig(**wl_kw))
    print(f"workload: YCSB {wl_kw} made in {time.time() - t0:.3f} s")
    return wl


def reset_launches() -> None:
    from repro_torch.kernels.dep_wavefront import ops as dw_ops
    from repro_torch.kernels.lock_grant import ops as lg_ops

    lg_ops.launches = 0
    dw_ops.launches = 0


def main_path_slice1(device) -> int:
    """Phase 4: orthrus and deadlock_free at the paper's width through
    ``run_simulation``. Returns the lock_grant launches of the path."""
    from repro_torch.kernels.lock_grant import ops

    wl = make_full_workload(YCSB_FULL)
    reset_launches()
    res_k = run_cell("orthrus kernel_impl=auto", ORTHRUS_FULL, wl, device)
    launches = ops.launches
    print(f"orthrus kernel_impl=auto: lock_grant launches {launches}, "
          f"steps_executed {res_k.raw['steps_executed']}")
    if launches <= 0 or launches != res_k.raw["steps_executed"]:
        raise AssertionError("the ORTHRUS run did not launch lock_grant "
                             "once per step")
    res_j = run_cell("orthrus kernel_impl=jnp (plain)", ORTHRUS_FULL, wl,
                     device, kernel_impl="jnp")
    run_cell("deadlock_free", DF_FULL, wl, device)
    if ops.launches != launches:
        raise AssertionError("a plain-path run launched lock_grant")
    if fingerprint(res_k, True) != fingerprint(res_j, True):
        raise AssertionError("kernel and plain ORTHRUS runs diverged")
    print("orthrus: kernel and plain fingerprints identical (metrics incl.)")
    profile_steps("orthrus", ORTHRUS_FULL, wl, device)
    profile_steps("orthrus plain", dict(ORTHRUS_FULL, kernel_impl="jnp"), wl,
                  device)
    profile_steps("deadlock_free", DF_FULL, wl, device)
    return launches


def main_path_slice2(device) -> int:
    """Phase 5: the batch-planned engine at the paper's width through
    ``run_simulation``. Returns the dep_wavefront launches of the path."""
    from repro_torch.kernels.dep_wavefront import ops

    workloads = {name: make_full_workload(wl_kw)
                 for name, _eng_kw, wl_kw in BATCH_CELLS}
    reset_launches()
    total = 0
    results = {}
    for name, eng_kw, _wl_kw in BATCH_CELLS:
        for impl in ("auto", "jnp"):
            before = ops.launches
            res = run_cell(f"{name} kernel_impl={impl}", eng_kw,
                           workloads[name], device, kernel_impl=impl)
            n = ops.launches - before
            steps = res.raw["steps_executed"]
            extra = {k: res.raw[k] for k in ("pipe_adm", "pipe_commits")
                     if k in res.raw}
            print(f"{name} kernel_impl={impl}: dep_wavefront launches {n}, "
                  f"steps_executed {steps} {extra}")
            if n != (steps if impl == "auto" else 0) or steps <= 0:
                raise AssertionError(f"{name} kernel_impl={impl}: {n} "
                                     f"dep_wavefront launches in {steps} "
                                     f"steps")
            total += n
            results[impl] = res
        if fingerprint(results["auto"], True) != fingerprint(
                results["jnp"], True):
            raise AssertionError(f"kernel and plain {name} runs diverged")
        print(f"{name}: kernel and plain fingerprints identical "
              f"(metrics incl.)")
    if total != ops.launches:
        raise AssertionError("dep_wavefront launched outside the runs")
    profile_steps("dgcc", DGCC_FULL, workloads["dgcc"], device, warm=300)
    profile_steps("dgcc plain", dict(DGCC_FULL, kernel_impl="jnp"),
                  workloads["dgcc"], device, warm=300)
    profile_steps("quecc_frag_pipe", QUECC_FRAG_PIPE_FULL,
                  workloads["quecc_frag_pipe"], device, warm=300)
    return total


def profile_steps(name, eng_kw, workload, device, warm: int = 100,
                  timed: int = 200, profiled: int = 20) -> None:
    """Where a full-width step's time goes: wall ms per step as the host
    loop runs it (one read of ``r`` per step), and under torch.profiler
    the CUDA kernels per step, their device ms per step, and the top
    kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.core.convert import plan_from_numpy

    cfg = engine.EngineConfig(**eng_kw, **SIM_FULL)
    plan = engine.make_plan(cfg, workload)
    meta = engine.plan_meta(cfg, plan)
    p = plan_from_numpy(engine.plan_device(cfg, plan), device)
    batch = cfg.is_batch_planned
    if batch:
        s = engine._batch_state0(cfg, plan, cfg.n_slots, device)
        step = engine.make_batch_step(cfg, meta, device)
    else:
        s = engine._state0(cfg, plan.num_records, cfg.n_slots,
                           meta.max_keys, device)
        step = engine.make_step(cfg, meta, device)
    r_end = torch.tensor(SIM_FULL["max_rounds"], dtype=torch.int32,
                         device=device)

    def run(n):
        nonlocal s
        for _ in range(n):
            s = step(p, s if batch else engine.rebase_enq(s), r_end)
            int(s["r"])

    run(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(timed)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / timed * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(profiled)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    n_kernels = sum(e.count for e in kern) / profiled
    dev_ms = sum(e.self_device_time_total for e in kern) / profiled / 1e3
    if n_kernels <= 0:
        raise AssertionError(f"{name}: the profiler saw no CUDA kernel")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    print(f"profile {name} (rounds {int(s['r'])}): wall {wall_ms:.4f} ms/step, "
          f"{n_kernels:.1f} CUDA kernels/step, device {dev_ms:.4f} ms/step, "
          f"device busy share {dev_ms / wall_ms:.4f}; top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / profiled:.1f} us"
                      for e in top))


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    """Phase 1: every kernel's library, one nvcc per source, together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.dep_wavefront import ops as dw_ops
    from repro_torch.kernels.lock_grant import ops as lg_ops

    t0 = time.time()
    with ThreadPoolExecutor() as pool:
        for f in [pool.submit(o._library) for o in (lg_ops, dw_ops)]:
            f.result()
    for name in ("lock_grant", "dep_wavefront"):
        secs, log = _build.BUILD_LOG.get(name, (0.0, "(cached)"))
        print(f"build: {name}.cu in {secs:.3f} s\n{log.strip()}")
    print(f"build: both kernels built and loaded in {time.time() - t0:.3f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.kernels  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    power = gpu_name_and_power()
    print(power)

    t_all = time.time()

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        print(f"phase {name}: {time.time() - t0:.3f} s")
        return out

    phase("build", build_kernels)
    rows = [phase("kernels: lock_grant", check_lock_grant, device),
            phase("kernels: dep_wavefront", check_dep_wavefront, device)]
    phase("goldens", replay_goldens, device)
    rows[0]["launches"] = phase("main path, slice 1", main_path_slice1,
                                device)
    rows[1]["launches"] = phase("main path, slice 2", main_path_slice2,
                                device)
    print(f"all phases: {time.time() - t_all:.3f} s")

    print(json.dumps({"kernels": rows}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
