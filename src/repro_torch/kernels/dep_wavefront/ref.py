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
