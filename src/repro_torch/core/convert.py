"""Carry plans and round states between numpy and the port's tensors.

A plan dict (``plan_device``) and a round state (``_state0`` or a
step's output, in the packed layout of ``engine`` or the legacy layout
of ``engine_legacy``) are dicts of arrays with the same keys and shapes
in ``repro.core`` and here, with one exception: the port's state arrays
of ``engine.DROP_ROW_ARRAYS`` (per record, per batch unit, per txn)
carry one extra last row for dropped writes. Both layouts name their
arrays alike, so these helpers add and strip that row in either, and
both packages can compute from one plan and one state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import DROP_ROW_ARRAYS


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    return torch.from_numpy(a.astype(np.int32)).to(device)


def plan_from_numpy(p: dict, device) -> dict[str, torch.Tensor]:
    """Plan arrays (numpy, int32 or bool) -> tensors on ``device``."""
    return {k: _tensor(v, device) for k, v in p.items()}


def state_from_numpy(s: dict, device) -> dict[str, torch.Tensor]:
    """A round state as numpy arrays in the reference's shapes -> the
    port's state on ``device`` (one more row, zero, on each array of
    ``DROP_ROW_ARRAYS``)."""
    out = {}
    for k, v in s.items():
        v = np.asarray(v)
        if k in DROP_ROW_ARRAYS:
            v = np.concatenate([v, np.zeros_like(v[:1])], axis=0)
        out[k] = _tensor(v, device)
    return out


def state_to_numpy(s: dict) -> dict[str, np.ndarray]:
    """The port's state -> numpy arrays in the reference's shapes."""
    out = {}
    for k, v in s.items():
        a = v.detach().cpu().numpy()
        out[k] = a[:-1] if k in DROP_ROW_ARRAYS else a
    return out
