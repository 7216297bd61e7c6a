"""Plain PyTorch versions of the moe_dispatch kernels (B3).

``dispatch_positions_ref`` is the port of the JAX oracle
``dispatch_positions_ref``, the sorted form's contract. Over expert ids
sorted by (expert, arrival), -1 marking padding: each entry's 0-based
position within its run of equal ids (-1 for padding) and the capacity
keep-mask ``(e >= 0) & (pos < capacity)``. Positions count runs, so the
result is defined on any input, sorted or not. ``dispatch_slots_ref``
adds each entry's slot in the dispatch table: the sorted form's whole
output.

``moe_dispatch_plan_ref`` is the fused plan's plain version, the port of
``repro.models.moe.plan_dispatch``: ``route`` (jax.lax.top_k's order),
a stable sort of the (token, choice) entries by expert,
``dispatch_slots_ref``, the scatters into the dispatch table and the
``routed_share`` histogram. JAX's out-of-range scatters
(``mode="drop"``) become writes into one extra drop row that is sliced
off: torch raises on such an index, and CUDA device-asserts.
``moe_dispatch_plan_grouped_ref`` is the grouped form's: one such plan
per group of a [G, n, E] input (the JAX package vmaps ``plan_dispatch``
over the groups), with each group's integer count per expert.
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


def route(router_probs, top_k):
    """Each token's top-k experts [N, k] and their weights, by
    ``jax.lax.top_k``'s rule: larger first, equal values by lower index
    (a stable descending sort; ``torch.topk`` orders ties otherwise). The
    weights are renormalised by their sum in choice order, at least 1e-9,
    with one division."""
    vals, idx = torch.sort(router_probs, dim=-1, descending=True,
                           stable=True)
    w, eidx = vals[:, :top_k], idx[:, :top_k]
    total = w[:, 0]
    for j in range(1, top_k):
        total = total + w[:, j]
    return w / torch.clamp(total, min=1e-9)[:, None], eidx


def routed_count(eidx, num_experts):
    """int32[E]: the routed entries per expert, a histogram by
    ``index_add_`` (``bincount`` would sync the host)."""
    ee = eidx.reshape(-1)
    count = torch.zeros(num_experts, dtype=torch.int32, device=ee.device)
    return count.index_add_(0, ee, torch.ones(ee.shape[0], dtype=torch.int32,
                                              device=ee.device))


def routed_share(eidx, num_experts):
    """f32[E]: the share of the N*k routed entries that go to each expert:
    ``routed_count`` (exact in f32) over N*k by one IEEE division (a
    Python divisor would be multiplied in by its reciprocal on the
    card)."""
    return routed_count(eidx, num_experts).float() / torch.full(
        (), eidx.numel(), dtype=torch.float32, device=eidx.device)


def sorted_plan(router_probs, top_k, capacity, slots):
    """The dispatch plan by the sorted route: ``route``, a stable sort of
    the entries by expert, ``slots(experts_sorted, capacity, E)`` for each
    entry's slot (``dispatch_slots_ref``, or the sorted-form kernel), the
    scatters and the load. Returns the plan as ``moe_dispatch_plan_ref``
    does."""
    E = router_probs.shape[1]
    dev = router_probs.device
    w, eidx = route(router_probs, top_k)
    ee = eidx.reshape(-1).to(torch.int32)
    ee_s, order = torch.sort(ee, stable=True)
    _pos, _keep, slot = slots(ee_s, capacity, E)
    slot = slot.long()
    n_slots = E * capacity
    slot_token = torch.full((n_slots + 1,), -1, dtype=torch.int32,
                            device=dev)
    slot_token.scatter_(0, slot, (order // top_k).to(torch.int32))
    slot_weight = torch.zeros(n_slots + 1, dtype=torch.float32, device=dev)
    slot_weight.scatter_(0, slot, w.reshape(-1)[order])
    return {"slot_token": slot_token[:n_slots],
            "slot_weight": slot_weight[:n_slots],
            "load": routed_share(eidx, E)}


def moe_dispatch_plan_ref(router_probs, top_k, capacity):
    """The canonical-order dispatch plan. router_probs f32[N, E] ->
    {"slot_token": int32[E*C], the token feeding each expert slot (-1
    empty); "slot_weight": f32[E*C], its combine weight (0 empty);
    "load": f32[E], the share of routed entries per expert}."""
    return sorted_plan(router_probs, top_k, capacity, dispatch_slots_ref)


def moe_dispatch_plan_grouped_ref(router_probs, top_k, capacity):
    """G independent plans. router_probs f32[G, n, E] -> {"slot_token":
    int32[G, E*C] (group-local token indices, -1 empty), "slot_weight":
    f32[G, E*C], "load": f32[G, E] (each group's share), "count":
    int32[G, E] (each group's routed entries per expert)}."""
    E = router_probs.shape[2]
    plans = [moe_dispatch_plan_ref(p, top_k, capacity) for p in router_probs]
    out = {f: torch.stack([plan[f] for plan in plans])
           for f in ("slot_token", "slot_weight", "load")}
    out["count"] = torch.stack([routed_count(route(p, top_k)[1], E)
                                for p in router_probs])
    return out
