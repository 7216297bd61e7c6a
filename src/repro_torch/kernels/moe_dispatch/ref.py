"""Plain PyTorch version of the moe_dispatch kernel.

The port of the JAX oracle ``dispatch_positions_ref``. Over expert ids
sorted by (expert, arrival), -1 marking padding: each entry's 0-based
position within its run of equal ids (-1 for padding) and the capacity
keep-mask ``(e >= 0) & (pos < capacity)``. Positions count runs, so the
result is defined on any input, sorted or not. ``dispatch_slots_ref`` adds
each entry's slot in the dispatch table: the kernel's whole output.
"""

from __future__ import annotations

import torch

_I32_MIN = -(2**31)


def dispatch_positions_ref(experts_sorted, capacity):
    """experts_sorted: int32[N] (-1 = padding). Returns (pos int32[N],
    keep bool[N])."""
    e = experts_sorted
    active = e >= 0
    seg_start = torch.ones_like(active)
    seg_start[1:] = e[1:] != e[:-1]
    seg_start |= ~active
    ones = active.to(torch.int32)
    total = torch.cumsum(ones, 0, dtype=torch.int32)
    base = torch.cummax(torch.where(seg_start, total - ones, _I32_MIN),
                        0).values
    pos = total - base - 1  # 0-based within the run
    return pos, active & (pos < capacity)


def dispatch_slots_ref(experts_sorted, capacity, num_experts):
    """(pos, keep, slot int32[N]): a kept entry's slot is ``e * capacity +
    pos``, the others' ``num_experts * capacity`` (the drop row)."""
    pos, keep = dispatch_positions_ref(experts_sorted, capacity)
    return pos, keep, torch.where(keep, experts_sorted * capacity + pos,
                                  num_experts * capacity)
