"""Segmented FIFO lock-grant primitive, in PyTorch.

Given the outstanding lock requests of one round, decide which are
granted, honoring

  * FIFO fairness per record (older enqueue stamp first: reads behind a
    waiting write are not granted),
  * read sharing (several reads granted together),
  * write exclusivity (a write is granted only when it is the oldest
    waiter and the record has no read holders),

and report per-request contender counts (lock-table operations on the
same record this round), which drive the coherence cost model.

``segmented_grant`` works on **pre-sorted** request arrays and is the
plain version of the hand-written lock_grant kernel
(``repro_torch.kernels.lock_grant``); ``sorted_grant`` is its grant
decision alone; ``grant_round`` sorts and unsorts.

Entry kinds: ``REQ_READ`` / ``REQ_WRITE`` are grantable requests;
``REQ_RELEASE`` entries count as contenders only and are never granted.

All values are int32 (every cumulative sum passes ``dtype=torch.int32``);
sort permutations are int64, PyTorch's index type.
"""

from __future__ import annotations

import torch

REQ_READ = 0
REQ_WRITE = 1
REQ_RELEASE = 2
REQ_NONE = 3  # inactive slot (padding)

KEY_SENTINEL = 2**31 - 1
I32_MIN = -(2**31)
I32_MAX = 2**31 - 1


def lex_order(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Indices sorting by (primary, secondary), both int32, stable.

    One stable sort on the packed int64 ``(primary << 32) |
    (secondary - INT32_MIN)``: the same permutation as a two-key stable
    sort (ties in both keys keep their original order).
    """
    packed = (primary.to(torch.int64) << 32) | (
        secondary.to(torch.int64) - I32_MIN
    )
    return torch.sort(packed, stable=True).indices


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation via scatter (no second sort)."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return inv


def segment_starts(keys: torch.Tensor) -> torch.Tensor:
    """bool[N]: entry i opens a run of equal keys (entry 0 always does)."""
    start = torch.ones_like(keys, dtype=torch.bool)
    start[1:] = keys[1:] != keys[:-1]
    return start


def seg_cumsum(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented int32 cumsum of ``x`` along the sorted order
    (``seg_start[0]`` must be True)."""
    total = torch.cumsum(x, 0, dtype=torch.int32)
    base = torch.cummax(
        torch.where(seg_start, total - x, I32_MIN), 0
    ).values
    return total - base


def sorted_grant(keys, kind, wh_free, rc):
    """bool[N] grant decisions over requests sorted by (key, ts): the
    grant output of ``segmented_grant`` alone, without segment totals."""
    active = kind != REQ_NONE
    is_write_req = kind == REQ_WRITE
    is_read_req = kind == REQ_READ
    seg_start = segment_starts(keys) | ~active
    req_pos_incl = seg_cumsum((is_write_req | is_read_req).to(torch.int32),
                              seg_start)
    w_i32 = is_write_req.to(torch.int32)
    writes_before = seg_cumsum(w_i32, seg_start) - w_i32

    grant_read = is_read_req & wh_free & (writes_before == 0)
    grant_write = is_write_req & wh_free & (rc == 0) & (req_pos_incl == 1)
    return grant_read | grant_write


def segmented_grant(keys, ts, kind, wh_free, rc, weight=None):
    """Grant decisions over requests sorted by (key, ts).

    Args:
      keys:    int32[N] record ids, sorted ascending; KEY_SENTINEL = padding.
      ts:      int32[N] enqueue stamps, ascending within each key segment.
      kind:    int32[N] REQ_* entry kind.
      wh_free: bool[N]  per entry: record has no write holder.
      rc:      int32[N] per entry: record's current read-holder count.
      weight:  optional int32[N] per-entry weight to segment-sum.

    Returns (grant bool[N], contenders int32[N], wsum int32[N]).
    """
    del ts  # the order already encodes it
    grant = sorted_grant(keys, kind, wh_free, rc)
    active = kind != REQ_NONE
    seg_start = segment_starts(keys) | ~active
    seg_id = torch.cumsum(seg_start, 0, dtype=torch.int32) - 1

    contenders = _segment_broadcast_last(
        seg_cumsum(active.to(torch.int32), seg_start), seg_id
    )
    if weight is None:
        wsum = torch.zeros_like(contenders)
    else:
        wsum = _segment_broadcast_last(seg_cumsum(weight, seg_start), seg_id)
    return grant, torch.where(active, contenders, 0), wsum


def _segment_broadcast_last(inclusive, seg_id):
    """Broadcast each segment's last inclusive value to all its members."""
    n = inclusive.shape[0]
    last_of_seg = torch.ones_like(seg_id, dtype=torch.bool)
    last_of_seg[:-1] = seg_id[1:] != seg_id[:-1]
    idx = torch.where(last_of_seg, seg_id, n - 1).to(torch.int64)
    seg_last_val = torch.zeros_like(inclusive).scatter_reduce_(
        0, idx, torch.where(last_of_seg, inclusive, 0), "amax",
        include_self=True,
    )
    return seg_last_val[seg_id.to(torch.int64)]


def segment_sum_sorted(keys_sorted, weight_sorted):
    """Per-entry segment sum of ``weight_sorted`` over runs of equal
    ``keys_sorted`` (already sorted)."""
    seg_start = segment_starts(keys_sorted)
    seg_id = torch.cumsum(seg_start, 0, dtype=torch.int32) - 1
    return _segment_broadcast_last(
        seg_cumsum(weight_sorted, seg_start), seg_id
    )


def gather_holders(keys, write_holder, read_count, num_records):
    """Per-entry (wh_free, rc) from the lock table; keys >= num_records
    (padding) read as a write-held record with no readers."""
    safe = torch.clamp(keys, 0, num_records - 1).to(torch.int64)
    in_range = keys < num_records
    wh_free = (write_holder[safe] == -1) & in_range
    rc = torch.where(in_range, read_count[safe], 0)
    return wh_free, rc


def grant_round(keys, ts, kind, write_holder, read_count, num_records,
                weight=None):
    """Engine-facing grant pass: sorts, decides, unsorts.

    Returns (grant, contenders, wsum) in the original request order.
    """
    wh_free, rc = gather_holders(keys, write_holder, read_count, num_records)
    order = lex_order(keys, ts)
    inv = inverse_permutation(order)
    w = None if weight is None else weight[order]
    g, c, ws = segmented_grant(
        keys[order], ts[order], kind[order], wh_free[order], rc[order], w
    )
    return g[inv], c[inv], ws[inv]
