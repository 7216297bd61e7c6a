"""Plain PyTorch version of the dep_wavefront kernel.

Contract: entries are dependency edges grouped by dependent unit
(``dst``: a transaction, or a per-(txn, lane) fragment); padding entries
carry ``dst == KEY_SENTINEL``. For each edge, prefix statistics of its
dst segment:

  miss[i]  inclusive count of edges so far in the segment whose source
           unit has NOT committed,
  pos[i]   inclusive count of edges so far in the segment.

A segment opens wherever ``dst`` changes, so the edges of a unit need to
be adjacent, not sorted. A unit is ready exactly when its segment's
total miss count is zero; the segment-total broadcast and the scatter
back to unit ids live in ``ops.py``.

``dep_wavefront_rows_ref`` is the batch engine's stage 4 over this
contract, the row kernel's: each slot row's edges in row order.
"""

from __future__ import annotations

import torch

from repro_torch.core.lockgrant import KEY_SENTINEL, seg_cumsum, segment_starts


def dep_wavefront_ref(dst, src_ok):
    """Edges grouped by dst (int32[E]); ``src_ok`` bool[E].

    Returns (miss int32[E], pos int32[E]).
    """
    active = dst != KEY_SENTINEL
    seg_start = segment_starts(dst) | ~active
    miss = seg_cumsum((active & ~src_ok).to(torch.int32), seg_start)
    pos = seg_cumsum(active.to(torch.int32), seg_start)
    return miss, pos


def dep_wavefront_rows_ref(row_unit, preds, done):
    """bool [T]: no edge of row t misses.

    Row t holds unit ``row_unit[t]`` and its predecessor units
    ``preds[t]`` (int32 [T, P], P >= 1, -1 = none); ``done`` is the
    committed flag per unit (a predecessor past its end reads its last
    flag). The T*P edges go to the scan in row order, dst = the row's
    unit (KEY_SENTINEL where the pred is -1), src_ok = ``done[pred]``; a
    row passes where no edge of it has a miss so far in its segment.
    A segment joins two rows only when they hold the same unit, so on
    the engine's rows (rows of one unit are identical) this is the dense
    check ``((preds < 0) | done[preds]).all(1)``.
    """
    src_ok = done[torch.clamp(preds, 0, done.shape[0] - 1).long()]
    edge_dst = torch.where(preds >= 0, row_unit[:, None], KEY_SENTINEL)
    miss, _pos = dep_wavefront_ref(edge_dst.reshape(-1), src_ok.reshape(-1))
    return miss.view(preds.shape).amax(dim=1) == 0
