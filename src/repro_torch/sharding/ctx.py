"""Ambient activation-sharding context (the port of
``repro.sharding.ctx``).

Model code annotates activations with logical axes through
``constrain(x, axes)``; a trainer installs a (mesh, rules) context with
``use``. Without a context, as on one card, it returns ``x`` unchanged.
Under a context whose mesh is ``DeviceMesh``-backed, a DTensor is
redistributed to the resolved placements; a plain tensor, or any tensor
under a mesh of another form, is returned unchanged.

``local_call`` is the boundary between DTensors and the kernels: the
CUDA wrappers take raw pointers, so a kernel (or, on the CPU, its plain
version) gets each rank's local shards, and its outputs come back as
DTensors with the placements the rules give. ``shard_index`` is which
shard of a dimension this rank holds, ``reduce_local`` a reduction of a
local tensor over mesh dimensions inside ``local_call``'s function,
``mean_last`` a mean along the last dimension; ``take_last`` a gather and
``logsumexp_last`` a log-sum-exp along the last dimension, both of which
keep that dimension on its shards where DTensor shards it.
"""

from __future__ import annotations

import contextlib

import torch

# the contexts in force, innermost last: one stack for the process, not a
# context variable, since autograd runs a CUDA backward (and a layer's
# remat recompute in it) on a thread of its own, which would see none
_STACK: list = []


@contextlib.contextmanager
def use(mesh, rules: dict):
    _STACK.append((mesh, rules))
    try:
        yield
    finally:
        _STACK.pop()


def active():
    return _STACK[-1] if _STACK else None


def _device_ctx():
    """(mesh, rules) of a context on a ``DeviceMesh``, else None."""
    ctx = active()
    if ctx is None or ctx[0].device_mesh is None:
        return None
    return ctx


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)



def constrain(x, axes: tuple):
    """Constrain x to logical axes (no-op without a context)."""
    ctx = _device_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    from repro_torch.sharding.policies import spec_for

    sh = spec_for(axes, tuple(x.shape), mesh, rules)
    return x.redistribute(mesh.device_mesh, sh.placements())


def shard_index(x, axes: tuple, dim: int) -> int:
    """Which shard of dimension ``dim`` this rank holds, for a tensor of
    x's shape and logical ``axes`` under the context: row-major over the
    mesh axes that dimension resolves to (0 where it resolves to none,
    or without a context)."""
    ctx = _device_ctx()
    if ctx is None:
        return 0
    mesh = ctx[0]
    idx = 0
    for a in _axes_of(x, axes, dim, ctx):
        idx = idx * mesh.shape[a] + mesh.device_mesh.get_local_rank(a)
    return idx


def placements(x, axes: tuple):
    """The placements ``axes`` resolve to for a tensor of x's shape (or
    for the shape x) under the context (None without one)."""
    ctx = _device_ctx()
    if ctx is None:
        return None
    mesh, rules = ctx
    from repro_torch.sharding.policies import spec_for

    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    return spec_for(axes, shape, mesh, rules).placements()


def _axes_of(x, axes, dim, ctx) -> tuple:
    mesh, rules = ctx
    from repro_torch.sharding.policies import spec_for

    entry = spec_for(axes, tuple(x.shape), mesh, rules).spec[dim]
    return entry if isinstance(entry, tuple) else ((entry,) if entry
                                                   else ())


def local_call(fn, args, in_axes, out_axes, contracted=()):
    """``fn(*args)`` on each rank's local shards.

    Without a context on a ``DeviceMesh``, or where no arg is a DTensor,
    this is ``fn(*args)`` itself. Otherwise each arg (a plain tensor
    counts as replicated) is redistributed to the placements its logical
    axes in ``in_axes`` resolve to under the rules (``spec_for``), and
    ``fn`` runs on the local tensors. Its outputs (a tensor, or a tuple
    of them with one entry of ``out_axes`` each) come back as DTensors
    placed by their logical axes in ``out_axes`` (None: replicated): an
    output dimension is sharded over the mesh axes that shard an arg's
    dimension of the same logical axis; over a mesh axis that shards an
    axis in ``contracted`` (one that ``fn`` sums over) the output is a
    partial sum, reduced here, once, in the dtype ``fn`` gave it (no
    ``Partial`` placement leaves this function: a partial sum left
    pending would be reduced again by each op that reads it, in that
    op's dtype); over any other axis it is replicated.

    Gradients: where some arg is sharded along a mesh axis, each rank's
    ``fn`` sees other rows (or heads) than its neighbours', so an arg
    replicated along that axis gets a partial sum there, which the
    backward of its redistribution reduces, once, in the gradient's
    dtype; one that is replicated along an axis no arg shards gets the
    same gradient on every rank, a replicated one. Slicing a replicated
    arg by rank inside ``fn`` (the query heads' own kv heads) is a case
    of the first kind."""
    ctx = _device_ctx()
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    if ctx is None:
        raise RuntimeError("a DTensor reached a kernel outside a sharding "
                           "context (sharding.ctx.use)")
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    dm = ctx[0].device_mesh
    placed, dts = [], []
    sharding = {}  # logical axis -> the mesh axes that shard it in an arg
    for a, axes in zip(args, in_axes, strict=True):
        want = placements(a, axes)
        if not is_dtensor(a):
            a = DTensor.from_local(a, dm, [Replicate()] * dm.ndim,
                                   run_check=False)
        dts.append(a.redistribute(dm, want))
        placed.append(want)
        for m, p in enumerate(want):
            if p.is_shard():
                sharding.setdefault(axes[p.dim], set()).add(m)
    split = [any(p[m].is_shard() for p in placed) for m in range(dm.ndim)]
    local = [a.to_local(grad_placements=tuple(
        Partial() if split[m] and isinstance(p, Replicate) else p
        for m, p in enumerate(want))) for a, want in zip(dts, placed)]
    outs = fn(*local)
    single = isinstance(outs, torch.Tensor)
    outs = (outs,) if single else tuple(outs)
    out_axes = (out_axes,) if single else tuple(out_axes)

    def out_placements(axes):
        pl = [Replicate()] * dm.ndim
        for d, name in enumerate(axes or ()):
            for m in sharding.get(name, ()) if name else ():
                pl[m] = Shard(d)
        for name in contracted:
            for m in sharding.get(name, ()):
                if isinstance(pl[m], Replicate):
                    pl[m] = Partial()
        return pl

    def wrap(o, axes):
        pl = out_placements(axes)
        dt = DTensor.from_local(o, dm, pl, run_check=False)
        if not any(p.is_partial() for p in pl):
            return dt
        # the partial sum reduced here, once, in the output's own dtype,
        # to where ``axes`` resolve
        want = placements(o, tuple(axes or (None,) * o.dim()))
        return dt.redistribute(dm, [w if p.is_partial() else p
                                    for p, w in zip(pl, want)])

    wrapped = tuple(wrap(o, axes) for o, axes in zip(outs, out_axes,
                                                     strict=True))
    return wrapped[0] if single else wrapped


def reduce_local(t, op: str, mesh_dims):
    """A rank's local tensor ``t`` reduced with ``op`` ("sum" or "max")
    over the given dimensions of the context's mesh, in t's dtype: the
    collective a function run by ``local_call`` makes itself, on a
    statistic its ranks must agree on before it goes on."""
    if not mesh_dims:
        return t
    from torch.distributed.tensor import DTensor, Partial, Replicate

    dm = _device_ctx()[0].device_mesh
    pl = [Partial(op) if m in mesh_dims else Replicate()
          for m in range(dm.ndim)]
    return DTensor.from_local(t, dm, pl, run_check=False).redistribute(
        dm, [Replicate()] * dm.ndim).to_local()


def _last_sharded(x) -> bool:
    return is_dtensor(x) and any(p.is_shard(x.dim() - 1)
                                 for p in x.placements)


def _rows(x, y):
    """y (a reduction of x over its last dimension) reduced over the
    shards of that dimension: placed as x's other dimensions are."""
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_shard(x.dim() - 1) else p
          for p in x.placements]
    return y.redistribute(x.device_mesh, pl)


class _RowSum(torch.autograd.Function):
    """``x.sum(-1, keepdim=True)`` of a DTensor sharded along its last
    dimension: each rank's sum reduced once, forward; backward, the
    gradient (a partial sum where the row's readers were sharded) reduced
    once as a row, then broadcast onto x's shards. Left to DTensor, that
    partial sum would travel with the broadcast and be reduce-scattered
    at x's full width."""

    @staticmethod
    def forward(fctx, x):
        fctx.spec = (x.device_mesh, tuple(x.placements), x.shape)
        return _rows(x, x.sum(-1, keepdim=True))

    @staticmethod
    def backward(fctx, g):
        from torch.distributed.tensor import Replicate

        mesh, pl, shape = fctx.spec
        rows = [Replicate() if p.is_shard(len(shape) - 1) else p for p in pl]
        return g.redistribute(mesh, rows).expand(shape).redistribute(mesh,
                                                                     pl)


def mean_last(x):
    """``torch.mean(x, -1, keepdim=True)``. A DTensor sharded along the
    last dimension reduces one number a row, once, forward and backward
    (``_RowSum``); DTensor's own mean there places the partial mean its
    own way, and its gradient comes back at x's full width."""
    if not _last_sharded(x):
        return torch.mean(x, dim=-1, keepdim=True)
    return _RowSum.apply(x) / x.shape[-1]


def logsumexp_last(x):
    """``torch.logsumexp(x, -1)``. A DTensor sharded along the last
    dimension takes it on its shards: each rank's max, reduced with max,
    then each rank's sum of ``exp(x - max)``, reduced with sum; the
    collectives move one number a row, never x (DTensor's own logsumexp
    gathers x whole along the shards). The max is a constant of the
    gradient, as in ``torch.logsumexp``."""
    if not _last_sharded(x):
        return torch.logsumexp(x, dim=-1)
    m = _rows(x, x.detach().amax(dim=-1))
    return torch.log(_rows(x, torch.exp(x - m[..., None]).sum(-1))) + m


def take_last(x, idx):
    """``x[..., idx]`` per position: ``torch.gather(x, -1, idx[..., None])``
    squeezed. A DTensor sharded along the last dimension takes it as a
    masked sum instead (one non-zero term a position, so the same value),
    which DTensor reduces over the shards: its gather over a sharded
    dimension cannot be reduced."""
    if _last_sharded(x):
        iota = torch.arange(x.shape[-1], device=x.device)
        return _rows(x, torch.where(iota == idx[..., None].long(), x,
                                    0.0).sum(-1))
    return torch.gather(x, -1, idx[..., None].long())[..., 0]
