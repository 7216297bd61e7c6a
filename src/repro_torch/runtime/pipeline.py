"""Pipeline parallelism: GPipe over a "stage" mesh axis (the port of
``repro.runtime.pipeline``).

Each stage owns one contiguous block of layers (stage-stacked params: a
leading dimension S on every leaf); microbatches stream through the
stages with one hop a tick. The schedule runs M + S - 1 ticks (a bubble
of S - 1) and the last stage emits microbatch t - (S - 1) at tick t.
Autograd differentiates through the schedule, so the backward pass is
the reverse pipeline: GPipe.

Two forms, as ``core.distributed`` has them:

* **one device** (``launch.mesh.one_device_mesh``): the stage axis is
  the leading dimension of the in-flight activations; a tick applies
  each stage's ``stage_fn`` to its own slice of the params, and the hop
  is a roll along that dimension.
* **process** (``launch.mesh.process_mesh``, one rank a stage): a hop is
  a point-to-point exchange (``batch_isend_irecv``, so gloo cannot
  deadlock) in an autograd Function whose backward sends the gradient to
  the previous stage; the outputs are replicated from the last stage by
  a broadcast whose backward hands the gradient to the last stage alone
  (the JAX package's ``psum`` of the masked outputs: an ``all_reduce``
  there would multiply it by S).

Only the (stage, tick) pairs that hold a microbatch run ``stage_fn`` (M
x S calls, not the reference's (M + S - 1) x S, whose extra calls feed
nothing that is emitted); the outputs are the same.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def _stage_params(params, s):
    return pytree.tree_map(lambda p: p[s], params)


def pipeline_forward(stage_fn, params, x_micro, *, mesh, axis: str = "stage"):
    """Run microbatches through the stage pipeline.

    Args:
      stage_fn: (stage_params, h) -> h, applied by every stage to its own
        slice of ``params`` (the leading stage dimension taken off).
      params: a tree with a leading dimension S on every leaf.
      x_micro: [M, mb, ...] microbatches.
      mesh: a mesh with ``axis`` (one-device or process form).

    Returns [M, mb, ...], the last stage's outputs (on every rank in the
    process form).
    """
    if mesh.form == "process":
        return _process_forward(stage_fn, params, x_micro, mesh, axis)
    S = mesh.shape[axis]
    M = x_micro.shape[0]
    buf = torch.zeros((S,) + tuple(x_micro.shape[1:]), dtype=x_micro.dtype,
                      device=x_micro.device)
    outs = []
    for t in range(M + S - 1):
        h = []
        for s in range(S):
            if not 0 <= t - s < M:
                h.append(torch.zeros_like(buf[s]))
                continue
            h_in = x_micro[t] if s == 0 else buf[s]
            h.append(stage_fn(_stage_params(params, s), h_in))
        h = torch.stack(h)
        if t >= S - 1:
            outs.append(h[S - 1])
        buf = torch.roll(h, 1, dims=0)  # stage s's output to stage s + 1
    return torch.stack(outs)


class _Hop(torch.autograd.Function):
    """Send ``h`` to the next stage, receive the previous stage's; the
    backward sends the received tensor's gradient back the same way."""

    @staticmethod
    def forward(ctx, h, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(h, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.prv, ctx.nxt, ctx.group), None, None, None


def _exchange(send, to, frm, group):
    import torch.distributed as dist

    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank (a broadcast). The backward
    gives the last stage the gradient of the one (replicated) output and
    every other rank zero; ``tail``, the last hop's output, ties each
    rank's schedule into the graph so every hop's backward runs, in the
    same order on every rank."""

    @staticmethod
    def forward(ctx, outs, tail, group, src, is_last):
        import torch.distributed as dist

        ctx.is_last = is_last
        ctx.save_for_backward(tail)
        y = outs.clone() if is_last else torch.empty_like(outs)
        dist.broadcast(y, src, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        (tail,) = ctx.saved_tensors
        return (g if ctx.is_last else torch.zeros_like(g),
                torch.zeros_like(tail), None, None, None)


def _process_forward(stage_fn, params, x_micro, mesh, axis):
    import torch.distributed as dist

    dm = mesh.device_mesh
    group = dm.get_group(axis)
    S = mesh.shape[axis]
    sid = dm.get_local_rank(axis)
    peer = [dist.get_global_rank(group, i) for i in range(S)]
    nxt, prv = peer[(sid + 1) % S], peer[(sid - 1) % S]
    M = x_micro.shape[0]
    p_local = _stage_params(params, sid)
    first = torch.tensor(sid == 0, device=x_micro.device)
    # under autograd every hop is in the graph from tick 0 on, on every
    # rank, so each rank runs all M + S - 1 hop backwards, in order
    buf = torch.zeros_like(x_micro[0]).requires_grad_(
        torch.is_grad_enabled())
    outs = []
    for t in range(M + S - 1):
        # stage 0 ingests microbatch t; the where keeps every hop in the
        # graph (its gradient there is zero)
        h_in = torch.where(first, x_micro[min(t, M - 1)], buf)
        if 0 <= t - sid < M:
            h = stage_fn(p_local, h_in)
        else:
            h = h_in * 0
        if sid == S - 1 and t >= S - 1:
            outs.append(h)
        buf = _Hop.apply(h, group, nxt, prv)
    outs = (torch.stack(outs) if outs
            else torch.zeros_like(x_micro))
    return _FromLast.apply(outs, buf, group, peer[S - 1], sid == S - 1)


def pipeline_loss_fn(stage_fn, loss_tail, *, mesh, axis="stage"):
    """A GPipe loss: the mean over microbatches of ``loss_tail(h,
    targets_mb)`` on the last stage's outputs, differentiable end to end
    (its backward is the reverse pipeline)."""

    def loss(params, x_micro, t_micro):
        outs = pipeline_forward(stage_fn, params, x_micro, mesh=mesh,
                                axis=axis)
        return torch.stack([loss_tail(h, t) for h, t in zip(outs, t_micro)]
                           ).mean()

    return loss
