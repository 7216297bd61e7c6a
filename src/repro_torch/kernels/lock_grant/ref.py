"""Plain PyTorch versions of the lock_grant kernels.

``lock_grant_ref`` is the kernel contract, the sequential part of
``repro_torch.core.lockgrant.segmented_grant``: over entries sorted by
(key, enq), per-entry prefix statistics within each key segment and the
grant decision. The segment totals (contender counts) are parallel and
live in ``ops.py``.

``lock_grant_step_ref`` is the engine's whole grant decision of one
ORTHRUS round (stage 7 of ``repro_torch.core.engine.make_step``), the
fused kernel's contract: entry kinds and keys, the lock-table gathers,
the stable sort by (key, enq), the segmented grant, the unsort and the
re-entrant grant.
"""

from __future__ import annotations

import torch

from repro_torch.core.lockgrant import (
    KEY_SENTINEL,
    REQ_NONE,
    REQ_READ,
    REQ_RELEASE,
    REQ_WRITE,
    gather_holders,
    lex_order,
    seg_cumsum,
    segment_starts,
)
from repro_torch.core.workloads import MODE_WRITE


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


def lock_grant_step_ref(keys, modes, pend2d, rel_entries, enq, wh, rc,
                        num_records):
    """The grant of every entry of one ORTHRUS round, bool [T, K].

    ``keys``, ``modes`` and ``enq`` are int32 [T, K], ``pend2d`` (a
    pending request) and ``rel_entries`` (a release) bool [T, K]; ``wh``
    and ``rc`` the lock table's write holders and read counts (at least
    ``num_records`` entries). A pending entry requests its key (a write
    where its mode is ``MODE_WRITE``), a release entry only contends;
    the others are inactive and keyed KEY_SENTINEL. Keys at or past
    ``num_records`` read as write-held with no readers. Entry t*K + k
    belongs to slot t, which holds its record's write lock re-entrantly.
    """
    T, K = keys.shape
    dev = keys.device
    kind = torch.where(
        pend2d,
        torch.where(modes == MODE_WRITE, REQ_WRITE, REQ_READ),
        torch.where(rel_entries, REQ_RELEASE, REQ_NONE),
    ).to(torch.int32).reshape(-1)
    key = torch.where(pend2d | rel_entries, keys, KEY_SENTINEL).reshape(-1)
    wh_free, rcv = gather_holders(key, wh, rc, num_records)
    order = lex_order(key, enq.reshape(-1))
    g_sorted = lock_grant_ref(key[order], kind[order], wh_free[order],
                              rcv[order])[0]
    grant = torch.empty_like(g_sorted)
    grant[order] = g_sorted  # unsort
    # re-entrant grants bypass the FIFO
    safe = torch.clamp(key, 0, num_records - 1).long()
    slot = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(K)
    self_grant = (pend2d.reshape(-1) & (key < num_records)
                  & (wh[safe] == slot))
    return (grant | self_grant).view(T, K)
