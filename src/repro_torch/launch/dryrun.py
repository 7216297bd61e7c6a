"""Multi-pod dry run: trace every (arch x shape x mesh) cell with no
allocation, and price it at the H100's peaks (the port of
``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--multi-pod | --both-meshes] [--out DIR] [--smoke]

For each cell this shows that the distribution config is coherent on the
production mesh (16 x 16 ("data", "model") a pod; 2 x 16 x 16 with
"pod") with no device allocation: params, optimizer state, batch and
cache are ``meta`` tensors, placed as DTensors by the sharding rules on
a ``DeviceMesh`` over a ``fake`` process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once), in a process of its own for each mesh. The step is the sharded
train step (``launch.train``'s parts), a prefill or a decode step, run
as rank 0 under ``launch.roofline.DeviceCounter`` (``run_cell`` says how
a deep model and microbatches are counted). Artifacts (FLOPs,
collective bytes, HBM traffic, the roofline terms) are written as JSON
to ``--out``, by default under the system's temp directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import (
    SHAPES,
    applicable_shapes,
    get_config,
    get_smoke_config,
    list_archs,
)
from repro_torch.launch.mesh import Mesh, process_mesh
from repro_torch.launch.roofline import (
    DeviceCounter,
    analyze_counts,
    local_bytes,
    over_repeats,
    roofline_report,
)
from repro_torch.models import model as M
from repro_torch.models import param_axes
from repro_torch.optim import (
    OptConfig,
    init_opt_state,
    opt_state_axes,
    opt_update,
)
from repro_torch.sharding import ctx
from repro_torch.sharding import policies as SH
from repro_torch.train import TrainConfig
from repro_torch.train.train_step import _split_micro, loss_and_grads

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def fake_mesh(shape, axes) -> Mesh:
    """A process mesh over a ``fake`` process group of prod(shape) ranks,
    this process rank 0 (one process group a process: call once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return process_mesh(shape, axes)


def train_config(cfg, shape, mesh: Mesh) -> TrainConfig:
    """The JAX package's production knobs: microbatch to ~8k tokens a
    device a microbatch; big models use factored bf16 optimizer state."""
    dp = 16 if "pod" not in mesh.shape else 16 * mesh.shape["pod"]
    local_tokens = shape.global_batch * shape.seq_len // dp
    micro = (max(1, min(8, local_tokens // 8192)) if shape.kind == "train"
             else 1)
    while shape.global_batch % (micro * dp) and micro > 1:
        micro //= 2
    big = cfg.param_count() > 100e9
    return TrainConfig(
        microbatches=micro,
        opt=OptConfig(name="adafactor" if big else "adamw",
                      state_dtype="bfloat16" if big else "float32"))


def build_cell(arch: str, shape_name: str, mesh: Mesh, smoke=False,
               tcfg: TrainConfig | None = None, mcfg_override=None,
               rules_override: dict | None = None):
    """Returns (fn, args, rules, meta, cfg, tcfg) for one cell; args are
    DTensors on ``meta``, and ``fn(counter, *args)`` runs the step. A
    train step with microbatches runs one microbatch's forward and
    backward and counts it ``microbatches`` times (each is the same
    work on the same shapes), then the update."""
    cfg = mcfg_override or (get_smoke_config(arch) if smoke
                            else get_config(arch))
    shape = SHAPES[shape_name]
    tcfg = tcfg or train_config(cfg, shape, mesh)
    rules = SH.rules_for(cfg, shape.kind, shape.global_batch, mesh)
    rules.update(rules_override or {})
    abs_params = M.abstract_params(cfg)
    params = SH.distribute(abs_params,
                           SH.params_sharding(cfg, mesh, rules, abs_params))
    specs = M.input_specs(cfg, shape)

    if shape.kind == "train":
        abs_opt = init_opt_state(tcfg.opt, abs_params)
        o_shard = SH.tree_sharding(
            opt_state_axes(tcfg.opt, param_axes(cfg), abs_params), abs_opt,
            mesh, rules)
        opt = SH.distribute(abs_opt, o_shard)
        batch = SH.distribute(specs["batch"], SH.batch_sharding(
            mesh, rules, specs["batch"]))

        def fn(counter, params, opt, batch):
            n = tcfg.microbatches
            if n > 1:
                mb = pytree.tree_map(lambda x: x[0],
                                     _split_micro(batch, n))
                before = counter.counts()
                loss, grads = loss_and_grads(cfg, tcfg, params, mb)
                counter.add(_minus(counter.counts(), before), n - 1)
                grads = pytree.tree_map(lambda g: g.float(), grads)
            else:
                loss, grads = loss_and_grads(cfg, tcfg, params, batch)
            params, opt, om = opt_update(tcfg.opt, grads, opt, params)
            return params, opt, {"loss": loss, **om}

        args = (params, opt, batch)
    elif shape.kind == "prefill":
        inputs = SH.distribute(specs, SH.batch_sharding(mesh, rules, specs))

        def fn(_counter, params, tokens, extras=None):
            return M.prefill(params, cfg, tokens, extras)

        args = (params, inputs["tokens"]) + (
            (inputs["extras"],) if "extras" in inputs else ())
    else:  # decode
        cache = SH.distribute(specs["cache"], SH.cache_sharding(
            cfg, mesh, rules, specs["cache"]))
        token = SH.distribute(specs["token"], SH.batch_sharding(
            mesh, rules, {"t": specs["token"]})["t"])

        def fn(_counter, params, cache, token):
            return M.decode_step(params, cfg, cache, token)

        args = (params, cache, token)

    return fn, args, rules, cell_meta(arch, shape_name, cfg, smoke), cfg, tcfg


def cell_meta(arch, shape_name, cfg, smoke=False) -> dict:
    """The reference's per-cell metadata (no tracing)."""
    shape = SHAPES[shape_name]
    return dict(
        arch=arch,
        shape=shape_name,
        kind=shape.kind,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        pattern_repeats=cfg.pattern_repeats,
        smoke=smoke,
    )


def _minus(a: dict, b: dict) -> dict:
    return {k: v - b.get(k, 0) for k, v in a.items()}


def _trace(arch, shape_name, mesh, smoke, tcfg, cfg, rules_override):
    """One rank's counts and byte totals of one cell at ``cfg``."""
    from torch.distributed.tensor.experimental import implicit_replication

    fn, args, rules, _meta, _cfg, _t = build_cell(
        arch, shape_name, mesh, smoke=smoke, tcfg=tcfg, mcfg_override=cfg,
        rules_override=rules_override)
    counter = DeviceCounter()
    with implicit_replication(), ctx.use(mesh, rules), counter:
        out = fn(counter, *args)
    leaves = [t for t in pytree.tree_leaves((args, out))
              if isinstance(t, torch.Tensor)]
    if any(t.device.type != "meta" for t in leaves):
        raise RuntimeError(f"{arch} x {shape_name}: a tensor off meta")
    return {**counter.counts(), "param_bytes": local_bytes(args[0]),
            "arg_bytes": local_bytes(args), "out_bytes": local_bytes(out)}


def run_cell(arch, shape_name, mesh: Mesh, mesh_name, smoke=False,
             outdir=None, tcfg=None, mcfg_override=None, tag="",
             rules_override=None):
    """Trace one cell as rank 0 and return its analysis.

    A model of more than 2 pattern repeats is traced at 1 and 2 and
    counted over all of them (``launch.roofline.over_repeats``)."""
    t0 = time.time()
    cfg = mcfg_override or (get_smoke_config(arch) if smoke
                            else get_config(arch))
    shape = SHAPES[shape_name]
    tcfg = tcfg or train_config(cfg, shape, mesh)
    c = over_repeats(
        lambda r: _trace(arch, shape_name, mesh, smoke, tcfg,
                         dataclasses.replace(cfg, pattern_repeats=r),
                         rules_override), cfg.pattern_repeats)
    counter = DeviceCounter()
    counter.add(c)
    ana = analyze_counts(counter, cell_meta(arch, shape_name, cfg, smoke),
                         chips=mesh.size,
                         param_bytes=int(c["param_bytes"]),
                         arg_bytes=int(c["arg_bytes"]),
                         out_bytes=int(c["out_bytes"]))
    ana["microbatches"] = tcfg.microbatches
    ana["trace_seconds"] = round(time.time() - t0, 1)
    ana["mesh"] = mesh_name
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_name}{tag}.json"
        with open(os.path.join(outdir, fname), "w") as f:
            json.dump(ana, f, indent=1, default=str)
    return ana


def _cells(args):
    archs = [args.arch] if args.arch else list(list_archs())
    for arch in archs:
        shapes = applicable_shapes(get_config(arch))
        if args.shape:
            shapes = [args.shape] if args.shape in shapes else []
            if not shapes:
                print(f"SKIP {arch} {args.shape}: inapplicable "
                      f"(full-attention arch, long_500k needs sub-quadratic)")
        for shape_name in shapes:
            yield arch, shape_name


def _run_mesh(args, mesh_name) -> list[tuple[str, str]]:
    """Every cell on one mesh, in this process (its fake group)."""
    mesh = fake_mesh(*MESHES[mesh_name])
    results, analyses = [], []
    for arch, shape_name in _cells(args):
        cell = f"{arch} x {shape_name} x {mesh_name}"
        try:
            ana = run_cell(arch, shape_name, mesh, mesh_name,
                           smoke=args.smoke, outdir=args.out)
            print(f"OK   {cell}: {ana['hbm_bytes_per_device'] / 2**30:.2f} "
                  f"GiB/dev, {ana['total_flops']:.3e} flops, "
                  f"coll {ana['collective_bytes'] / 2**30:.2f} GiB, "
                  f"{ana['trace_seconds']}s", flush=True)
            results.append((cell, "OK"))
            analyses.append(ana)
        except Exception as e:  # noqa: BLE001 - a cell's failure is reported
            print(f"FAIL {cell}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            results.append((cell, f"FAIL {e}"))
    if analyses:
        print(roofline_report(analyses), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_torch_dryrun"))
    ap.add_argument("--mesh", choices=tuple(MESHES), default=None,
                    help=argparse.SUPPRESS)  # one mesh, in this process
    args = ap.parse_args(argv)

    if args.mesh:
        results = _run_mesh(args, args.mesh)
        n_ok = sum(1 for _, s in results if s == "OK")
        print(f"MESH {args.mesh} {n_ok}/{len(results)}", flush=True)
        return 0 if n_ok == len(results) else 1

    names = []
    if args.both_meshes or not args.multi_pod:
        names.append("pod1")
    if args.both_meshes or args.multi_pod:
        names.append("pod2")
    # a fake process group a mesh, each in a process of its own
    rest = [a for a in (argv if argv is not None else sys.argv[1:])
            if a not in ("--multi-pod", "--both-meshes")]
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                               "--mesh", name] + rest)
             for name in names]
    rcs = [p.wait() for p in procs]
    print(f"\n{len(names)} meshes, "
          f"{'all cells OK' if not any(rcs) else 'some cells FAILED'}")
    return 1 if any(rcs) else 0


if __name__ == "__main__":
    raise SystemExit(main())
