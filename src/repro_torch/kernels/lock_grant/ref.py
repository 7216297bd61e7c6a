"""Plain PyTorch version of the lock_grant kernel.

The kernel contract is the sequential part of
``repro_torch.core.lockgrant.segmented_grant``: over entries sorted by
(key, enq), per-entry prefix statistics within each key segment and the
grant decision. The segment totals (contender counts) are parallel and
live in ``ops.py``.
"""

from __future__ import annotations

from repro_torch.core.lockgrant import (
    REQ_NONE,
    REQ_READ,
    REQ_WRITE,
    seg_cumsum,
    segment_starts,
)


def lock_grant_ref(keys, kind, wh_free, rc):
    """Entries sorted by (key, enq).

    Returns (grant bool[N], req_pos int32[N], writes_before int32[N],
    op_pos int32[N]).
    """
    active = kind != REQ_NONE
    is_w = active & (kind == REQ_WRITE)
    is_r = active & (kind == REQ_READ)
    is_req = is_w | is_r

    seg_start = segment_starts(keys) | ~active
    req_pos = seg_cumsum(is_req.int(), seg_start)
    w_incl = seg_cumsum(is_w.int(), seg_start)
    writes_before = w_incl - is_w.int()
    op_pos = seg_cumsum(active.int(), seg_start)

    grant_read = is_r & wh_free & (writes_before == 0)
    grant_write = is_w & wh_free & (rc == 0) & (req_pos == 1)
    return (grant_read | grant_write) & active, req_pos, writes_before, op_pos
