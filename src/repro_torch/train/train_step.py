"""Training step: microbatched grad accumulation + optimizer update (the
port of ``repro.train.train_step``).

The step is a plain function of (params, opt_state, batch) on dicts of
tensors. Each microbatch's gradient comes from ``loss_fn`` under
per-layer remat (``models.transformer.forward``) through
``torch.autograd.grad``; with several microbatches they accumulate in
f32 and are divided by their number, and so is the loss; with one they
stay in the params' dtype, as ``jax.value_and_grad`` leaves them.

Params that are DTensors (``launch.train`` under a process mesh) give
DTensor gradients that autograd has already reduced over the mesh (a
partial sum where a param is replicated over ranks that saw different
rows); each is redistributed to its param's placements.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF
from repro_torch.optim import OptConfig, opt_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat_policy: str = "nothing"  # 'nothing' | 'dots' | 'dots_no_batch'
    loss_chunk: int = 512  # chunked CE loss (0 = whole sequence)
    opt: OptConfig = OptConfig()


def _split_micro(batch, n):
    """[B, ...] -> [n, B / n, ...]: microbatch i is rows i B/n .. (i + 1)
    B/n - 1, as on one device. A DTensor sharded along its rows is
    gathered whole along them first and its microbatches are then
    sharded along their own rows: the MoE plans its capacity and its aux
    loss per microbatch, so only the same grouping of rows gives the
    same loss."""
    def f(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        if isinstance(x, DTensor) and any(p.is_shard(0)
                                          for p in x.placements):
            whole = [Replicate() if p.is_shard(0) else p
                     for p in x.placements]
            pl = [Shard(p.dim + 1) if p.is_shard() else p
                  for p in x.placements]
            x = x.redistribute(x.device_mesh, whole)
            x = x.reshape((n, b // n) + tuple(x.shape[1:]))
            return x.redistribute(x.device_mesh, pl)
        return x.reshape((n, b // n) + tuple(x.shape[1:]))

    return pytree.tree_map(f, batch)


def _placed_like(g, p):
    """A DTensor gradient with its param's placements."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(mcfg: ModelConfig, tcfg: TrainConfig, params, batch, *,
                   kernel_impl="auto"):
    """(loss, grads) of one (micro)batch: ``loss_fn`` under remat, and
    its gradient in each param's dtype (zeros for a param the forward
    does not read, as ``jax.grad`` gives)."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, _ = TF.loss_fn(pytree.tree_unflatten(leaves, spec), mcfg,
                             batch, remat=True,
                             remat_policy=tcfg.remat_policy,
                             loss_chunk=tcfg.loss_chunk,
                             kernel_impl=kernel_impl)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
             for g, p in zip(grads, flat)]
    return loss.detach(), pytree.tree_unflatten(grads, spec)


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, *,
                    kernel_impl="auto"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``."""

    def train_step(params, opt_state, batch):
        if tcfg.microbatches > 1:
            micro = _split_micro(batch, tcfg.microbatches)
            gsum, lsum = None, None
            for i in range(tcfg.microbatches):
                mb = pytree.tree_map(lambda x, i=i: x[i], micro)
                loss, g = loss_and_grads(mcfg, tcfg, params, mb,
                                         kernel_impl=kernel_impl)
                if gsum is None:
                    gsum = pytree.tree_map(lambda a: a.float(), g)
                    lsum = loss
                else:
                    gsum = pytree.tree_map(lambda a, b: a + b.float(),
                                           gsum, g)
                    lsum = lsum + loss
            grads = pytree.tree_map(lambda a: a / tcfg.microbatches, gsum)
            loss = lsum / tcfg.microbatches
        else:
            loss, grads = loss_and_grads(mcfg, tcfg, params, batch,
                                         kernel_impl=kernel_impl)
        params, opt_state, om = opt_update(tcfg.opt, grads, opt_state,
                                           params)
        return params, opt_state, {"loss": loss, **om}

    return train_step
