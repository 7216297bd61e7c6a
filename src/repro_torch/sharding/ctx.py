"""Ambient activation-sharding context (the port of
``repro.sharding.ctx``).

Model code annotates activations with logical axes through
``constrain(x, axes)``; a trainer installs a (mesh, rules) context with
``use``. Without a context, as on one card, it returns ``x`` unchanged.
Under a context whose mesh is ``DeviceMesh``-backed, a DTensor is
redistributed to the resolved placements; a plain tensor, or any tensor
under a mesh of another form, is returned unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars

_CTX = contextvars.ContextVar("repro_torch_sharding_ctx", default=None)


@contextlib.contextmanager
def use(mesh, rules: dict):
    tok = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(tok)


def active():
    return _CTX.get()


def constrain(x, axes: tuple):
    """Constrain x to logical axes (no-op without a context)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    if mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.policies import spec_for

    sh = spec_for(axes, tuple(x.shape), mesh, rules)
    return x.redistribute(mesh.device_mesh, sh.placements())
