"""End-to-end training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 20 --batch 8 --seq 64 --ckpt-dir <dir>
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b  # GPU
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --smoke --device cpu --data 2 --model 2  # gloo, 4 ranks

Wires together: config -> mesh -> params and optimizer state on the
device -> deterministic data pipeline -> train step (per-layer remat,
microbatching) -> async checkpointing, resumed from the newest committed
step of ``--ckpt-dir``.

On a one-device mesh (``--data``/``--model`` axes as tensor dimensions
of one device) the whole global batch trains on ``--device``. Under an
initialised process group (``torchrun``: ``WORLD_SIZE`` > 1; NCCL on
cards, gloo on the CPU) the mesh is a ``DeviceMesh`` and the trainer is
the JAX package's sharded one in DTensor form: params and optimizer
state are DTensors placed by the sharding rules (``embed`` over
``data``, heads, MLP and vocab over ``model``, experts over ``model``),
each rank's rows of the global batch make one DTensor sharded over
``pod`` x ``data``, and the step runs under the sharding context
(``sharding.ctx``), so the models' constraints take effect and the
kernels run on local shards. DTensor's backward gives the gradients
already reduced over the mesh. Every rank joins a checkpoint's gather;
rank 0 writes it.

Weights are random, from seed 0 as the JAX launcher's. For
llama-3.2-vision, llama4-maverick and whisper the stub frontends'
outputs come from seed 0 too (``models.model.random_extras``), as the
serving launcher makes them: the JAX launcher passes none.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.mesh import Mesh, make_mesh_for
from repro_torch.models import model as M
from repro_torch.models import param_axes
from repro_torch.optim import OptConfig, init_opt_state, opt_state_axes
from repro_torch.sharding import ctx
from repro_torch.sharding import policies as SH
from repro_torch.train import TrainConfig, make_train_step


def data_shard(mesh: Mesh) -> tuple[int, int]:
    """(number of data-parallel shards, this process's index): one shard
    a (pod, data) position in the process form, one in all otherwise."""
    if mesh.form != "process":
        return 1, 0
    dm = mesh.device_mesh
    pod = mesh.shape.get("pod", 1)
    data = mesh.shape.get("data", 1)
    p = dm.get_local_rank("pod") if "pod" in mesh.shape else 0
    d = dm.get_local_rank("data") if "data" in mesh.shape else 0
    return pod * data, p * data + d


def token_pipeline(cfg, mesh: Mesh, batch: int, seq: int,
                   seed: int = 0) -> TokenPipeline:
    """This process's rows of the global batch of ``batch`` x ``seq``."""
    n, i = data_shard(mesh)
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    global_batch=batch, seq_len=seq,
                                    seed=seed, num_hosts=n, host_index=i))


def build_trainer(arch, mesh: Mesh, *, smoke=True, batch=8, seq=64,
                  microbatches=1, lr=1e-3, mcfg=None, device=None,
                  kernel_impl="auto", opt: OptConfig | None = None):
    """Returns (cfg, init, run_step, device): ``init()`` the fresh state
    {"params", "opt"} on ``device``; ``run_step(state, batch)`` one train
    step on a pipeline batch (numpy ``tokens``/``targets``, this
    process's rows), returning (state, {"loss", "grad_norm"}) with the
    metrics as plain tensors.

    Under a process mesh the state is DTensors (the module's docstring).
    ``device`` defaults to the mesh's (one device, or this rank's), and
    to "cuda" for an abstract mesh. ``opt`` defaults to AdamW at ``lr``,
    as the JAX launcher's; the loss is taken whole (``loss_chunk`` 0)."""
    cfg = mcfg or (get_smoke_config(arch) if smoke else get_config(arch))
    if device is None:
        device = mesh.device if mesh.devices else "cuda"
    device = torch.device(device)
    n_shards, _ = data_shard(mesh)
    if batch % n_shards:
        raise ValueError(f"global batch {batch} over {n_shards} data shards")
    tcfg = TrainConfig(microbatches=microbatches, loss_chunk=0,
                       opt=opt or OptConfig(name="adamw", lr=lr))
    extras = M.random_extras(cfg, batch // n_shards, 0, device)
    step_impl = make_train_step(cfg, tcfg, kernel_impl=kernel_impl)
    sharded = mesh.form == "process"
    if sharded:
        rules = SH.rules_for(cfg, "train", batch, mesh)
        abs_params = M.abstract_params(cfg)
        p_shard = SH.params_sharding(cfg, mesh, rules, abs_params)
        o_shard = SH.tree_sharding(
            opt_state_axes(tcfg.opt, param_axes(cfg), abs_params),
            init_opt_state(tcfg.opt, abs_params), mesh, rules)

    def init():
        params = M.init_params(cfg, 0, device)
        state = {"params": params, "opt": init_opt_state(tcfg.opt, params)}
        if sharded:
            state = {"params": SH.distribute(state["params"], p_shard),
                     "opt": SH.distribute(state["opt"], o_shard)}
        return state

    def global_batch(b):
        """This rank's rows as one DTensor batch over (pod, data)."""
        from torch.distributed.tensor import DTensor

        def leaf(t):
            shape = (t.shape[0] * n_shards,) + tuple(t.shape[1:])
            sh = SH.batch_sharding(mesh, rules, {"x": (shape, t.dtype)})
            return DTensor.from_local(t, mesh.device_mesh,
                                      sh["x"].placements(), run_check=False)

        return pytree.tree_map(leaf, b)

    def run_step(state, batch_):
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in batch_.items()}
        if extras:
            b["extras"] = extras
        if not sharded:
            params, opt_state, metrics = step_impl(state["params"],
                                                   state["opt"], b)
            return {"params": params, "opt": opt_state}, metrics
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import (
            implicit_replication,
        )

        with implicit_replication(), ctx.use(mesh, rules):
            params, opt_state, metrics = step_impl(
                state["params"], state["opt"], global_batch(b))
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return {"params": params, "opt": opt_state}, metrics

    return cfg, init, run_step, device


def _process_group(device: str) -> None:
    """Join the process group ``torchrun`` describes (``WORLD_SIZE`` > 1)."""
    import torch.distributed as dist

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=list_archs())
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-interval", type=int, default=10)
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--model", type=int, default=1, help="model-axis size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    multi = int(os.environ.get("WORLD_SIZE", 1)) > 1
    if multi:
        _process_group(args.device)
    mesh = make_mesh_for(None if multi else args.device, data=args.data,
                         model=args.model)
    cfg, init, run_step, device = build_trainer(
        args.arch, mesh, smoke=args.smoke, batch=args.batch, seq=args.seq,
        microbatches=args.microbatches, lr=args.lr)
    pipe = token_pipeline(cfg, mesh, args.batch, args.seq)
    ckpt = Checkpointer(args.ckpt_dir, interval=args.ckpt_interval)
    state = init()
    found_step, restored = ckpt.restore_latest(state, device)
    if found_step is not None:
        state = restored
        print(f"resumed from step {found_step}")
        start = found_step + 1
    else:
        start = 0

    for step in range(start, args.steps):
        t0 = time.time()
        state, metrics = run_step(state, pipe.batch(step))
        loss = float(metrics["loss"])
        ckpt.maybe_save(step, state)
        print(f"step {step:5d} loss {loss:8.4f} "
              f"gnorm {float(metrics['grad_norm']):8.3f} "
              f"{time.time() - t0:6.2f}s")
    ckpt.wait()
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
