"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Set-up builds the kernels (the port's ``nvcc`` libraries are cached
under ``build/`` in the checkout), draws the cell's inputs from the
seed with the benchmark's own generator, builds the port's side of the
cell and makes whole warm-up calls for ``WARM_UP_S`` (at least one; the
first captures the cell's CUDA graphs into the port's runner cache);
only the cell's own shapes are warmed.

The window (``--trace 0``) runs whole calls back to back and closes at
the end of the first call that ends past ``--seconds``; every call
simulates the same deterministic cell. ``sim_rounds_per_s`` is the
simulated rounds of all the window's calls over the window's wall time,
first call's start to last call's end; ``setup_s`` is the process's
start to the window's start.

The traced run (``--trace 1``) makes one whole call under the profiler,
split into the port's planning and its host loop as ``run_simulation``
splits it; the per-layer readers take their numbers from that trace,
from the harness's clock around each layer and from the port's
counters.

After the window the peak memory is read, the port's cached graphs are
dropped and the reference simulates the same inputs; each call's
fingerprint is held to it (``check``).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

from simbench import check, spec
from simbench import trace as trace_lib

# What the harness pins for every run: the defaults of the port's sweep
# loop, so that the environment cannot change the path measured.
PINNED_ENV = {
    "REPRO_SWEEP_DEVICES": "auto",
    "REPRO_SWEEP_PIPELINE": "1",
    "REPRO_SWEEP_EARLY_EXIT": "1",
    "REPRO_SWEEP_RUNNER_CACHE": "256",
}
# One host thread for the libraries' pools (the port plans with numpy and
# drives the card from one thread): idle pools that spin share the
# machine's few cores with the thread that waits on every step.
HOST_THREADS_ENV = {
    "OMP_NUM_THREADS": "1",
    "OPENBLAS_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
}
# Set-up ends with whole calls until this long has passed, at least one:
# the first builds and captures, the next few settle the host's caches.
WARM_UP_S = 3.0


def pin_environment(root: Path) -> dict:
    """Pin the sweep loop's settings and the host's thread pools, and
    keep every cache that a build or compile could write at fixed paths
    inside the checkout. Called before numpy or torch is imported."""
    env = {**PINNED_ENV, **HOST_THREADS_ENV}
    cache = root / "build" / "simbench"
    env["TRITON_CACHE_DIR"] = str(cache / "triton")
    env["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    env["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ.update(env)
    return env


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(cell: spec.Cell, seed: int) -> dict:
    """The cell's workload arrays, drawn from ``seed`` by the generator
    its configuration names."""
    gen = spec.load_module(spec.HERE / "generators"
                           / f"{cell.config['generator']}.py",
                           f"simbench_gen_{cell.config['generator']}")
    params = {**cell.config["workload"], **cell.traffic["workload"]}
    return gen.make(params, seed & ((1 << 64) - 1))


def entry_module(cell: spec.Cell):
    name = cell.traffic["entry"]
    return spec.load_module(spec.HERE / "entries" / f"{name}.py",
                            f"simbench_entry_{name}")


def run_window(program, seconds: float, device) -> tuple[list, list]:
    """Whole calls until one ends past ``seconds``: (results per call,
    (start, end) per call on the host's clock)."""
    results, times = [], []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        results.append(program.call())
        _sync(device)
        b = time.perf_counter()
        times.append((a, b))
        if b - t0 >= seconds:
            return results, times


def run_traced(program, device) -> tuple[list, dict, trace_lib.Trace]:
    """One whole call under the profiler, and its trace.

    The profiler is stopped with ``torch.autograd._disable_profiler``,
    which returns the raw events, and not through its context manager,
    whose exit (in some releases) turns every event into a Python object
    first: minutes for the millions of kernel records (CUPTI reports each
    kernel node of a graph replay) of a lock-table cell's call."""
    import torch
    from torch.autograd import profiler as autograd_profiler

    spans: dict = {}
    cuda = torch.device(device).type == "cuda"
    prof = autograd_profiler.profile(use_device="cuda" if cuda else None,
                                     use_kineto=True)
    _sync(device)
    prof._prepare_trace()
    prof._start_trace()
    try:
        with autograd_profiler.record_function(trace_lib.WINDOW):
            results = program.traced_call(spans)
            _sync(device)
    finally:
        t0 = time.perf_counter()
        raw = torch.autograd._disable_profiler()
        spans["trace_stop_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = trace_lib.read(raw)
    spans["trace_read_s"] = time.perf_counter() - t0
    return [results], spans, tr


def device_info(device, chips: int) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))


def free_program(device) -> None:
    """Drop the port's cached runners (their graphs and buffers), so the
    reference runs on a card that holds none of the program's state."""
    import gc

    import torch

    from repro_torch.core import sweep

    sweep._evict_to(0)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """One run of ``cell``; returns the result line's object."""
    inputs = make_inputs(cell, seed)
    entry = entry_module(cell)
    program = entry.Program(cell.config, cell.traffic, inputs, device)
    warm = []
    t0 = time.perf_counter()
    while not warm or time.perf_counter() - t0 < WARM_UP_S:
        a = time.perf_counter()
        program.call()  # the first builds the kernels, captures the graphs
        _sync(device)
        warm.append(time.perf_counter() - a)
    log("simbench: warm-up calls " + ", ".join(f"{w:.3f}" for w in warm)
        + " s")

    window_start = time.perf_counter()
    setup_s = window_start - t_start
    metrics: dict = {}
    breakdown = None
    dev_extra: dict = {}
    if not trace:
        results, times = run_window(program, seconds, device)
        wall = times[-1][1] - times[0][0]
        rounds = sum(r.raw["rounds_total"] for call in results for r in call)
        values = {"sim_rounds_per_s": rounds / wall, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m.name] = {"value": values[m.name], "unit": m.unit}
        log(f"simbench: window {wall:.3f} s, {len(results)} calls, "
            f"{rounds} simulated rounds; calls "
            + ", ".join(f"{b - a:.3f}" for a, b in times) + " s")
    else:
        results, spans, tr = run_traced(program, device)
        busy = tr.busy_s()
        dev_extra = {"busy_s": busy, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        flat = [r for call in results for r in call]
        ctx = dict(results=flat, spans=spans, trace=tr,
                   steps=sum(r.raw["steps_executed"] for r in flat),
                   shapes=program.shapes())
        for m in cell.per_layer:
            v = m.reader.read(ctx)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        log(f"simbench: traced window {tr.window_s:.3f} s, "
            f"{ctx['steps']} steps, device busy "
            f"{busy:.3f} s, {len(tr.device)} device activities, "
            f"profiler stopped in "
            f"{spans['trace_stop_s']:.3f} s, trace read in "
            f"{spans['trace_read_s']:.3f} s")
    info = device_info(device, cell.chips)
    got = [[check.fingerprint(r) for r in call] for call in results]
    program = None
    free_program(device)

    t0 = time.perf_counter()
    want = entry.reference(cell.config, cell.traffic, inputs, device)
    log(f"simbench: reference {time.perf_counter() - t0:.3f} s")
    compared = check.compare(got, want)
    failed = compared["calls_differing"][0]
    out = {
        "correct": check.within(compared),
        "attempted": len(results),
        "failed": failed,
        "metrics": metrics,
        "device": {**info, **dev_extra},
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in compared.items()}
    return out


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, and the
    result as the last line of standard output."""
    for k, c in result["compared"].items():
        log(f"compared {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
