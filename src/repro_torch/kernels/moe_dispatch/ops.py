"""Wrappers of the moe_dispatch kernels (B3).

``moe_dispatch_plan(router_probs, top_k=, capacity=)`` is the main
path's form: the whole dispatch plan (top-k routing, each entry's
position within its expert, the [experts * capacity] dispatch table and
the load) from the router probabilities. For CUDA tensors it is one
launch of the fused kernel (``csrc/moe_dispatch.cu``,
``moe_dispatch_plan_kernel``); for CPU tensors its plain version
(``ref.moe_dispatch_plan_ref``, which is
``repro_torch.models.moe.plan_dispatch``). Given probabilities [G, n, E]
it plans G groups independently (per-shard dispatch), still in one
launch (the plain version: ``ref.moe_dispatch_plan_grouped_ref``). It
takes up to ``MAX_EXPERTS`` experts and ``MAX_TOP_K`` choices and raises
above them: there is no other route on the card.

``dispatch_positions(experts_sorted, capacity, num_experts)`` is the
TPU kernel's own contract, the sorted form, (pos, keep) plus each
entry's dispatch slot (``moe_dispatch_kernel``; for CPU tensors
``ref.dispatch_slots_ref``). ``moe_dispatch_chain`` is the plan the
sorted form used to sit in: route, sort, the sorted form, scatters and
histogram, one eager kernel each. Neither is on the main path;
chip_smoke.py holds and times them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, device_guard, reject_dtensors
from repro_torch.kernels.moe_dispatch.ref import (
    dispatch_slots_ref,
    moe_dispatch_plan_grouped_ref,
    moe_dispatch_plan_ref,
    sorted_plan,
)

SOURCES = [Path(__file__).resolve().parent / "csrc" / "moe_dispatch.cu"]

# the fused plan's limits (kMaxExperts, kMaxTopK in the source)
MAX_EXPERTS = 256
MAX_TOP_K = 8

# Kernel launches since the last reset (``launches = 0``): both forms; a
# grouped plan is one launch.
launches = 0

_LIB: ctypes.CDLL | None = None
_I32_MAX = 2**31 - 1


def _library() -> ctypes.CDLL:
    """The built kernel library (built at the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("moe_dispatch", SOURCES)
        fn = lib.moe_dispatch_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.moe_dispatch_plan_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(experts_sorted, capacity, num_experts):
    e = experts_sorted
    reject_dtensors("moe_dispatch", experts=e)
    if e.dtype != torch.int32:
        raise TypeError(f"moe_dispatch: experts are {e.dtype}, want int32")
    if e.dim() != 1:
        raise ValueError(f"moe_dispatch: experts have shape {tuple(e.shape)}")
    if (capacity < 0 or num_experts < 0 or e.shape[0] > _I32_MAX
            or num_experts * capacity > _I32_MAX):
        raise ValueError(f"moe_dispatch: {e.shape[0]} entries, "
                         f"{num_experts} experts x capacity {capacity}: "
                         f"out of int32 range")


def dispatch_positions_cuda(experts_sorted, capacity, num_experts):
    """Launch the sorted form (a CUDA tensor). Same outputs as
    :func:`dispatch_positions`."""
    global launches
    e = experts_sorted
    _check(e, capacity, num_experts)
    if e.device.type != "cuda":
        raise ValueError(f"moe_dispatch: experts on {e.device}, want CUDA")
    if not e.is_contiguous():
        raise ValueError("moe_dispatch: experts are not contiguous")
    n = e.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=e.device)
    keep = torch.empty(n, dtype=torch.bool, device=e.device)
    slot = torch.empty(n, dtype=torch.int32, device=e.device)
    with device_guard(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        err = _library().moe_dispatch_launch(
            e.data_ptr(), pos.data_ptr(), keep.data_ptr(), slot.data_ptr(), n,
            capacity, num_experts * capacity, stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_dispatch kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return pos, keep, slot


def dispatch_positions(experts_sorted, capacity, num_experts):
    """(pos int32[N], keep bool[N], slot int32[N]) over expert ids sorted
    by (expert, arrival), -1 = padding: a kept entry's slot is ``e *
    capacity + pos``, the others' ``num_experts * capacity`` (the drop
    row). The sorted form for a CUDA tensor, the plain version for a CPU
    tensor."""
    if experts_sorted.device.type != "cpu":
        return dispatch_positions_cuda(experts_sorted, capacity, num_experts)
    _check(experts_sorted, capacity, num_experts)
    return dispatch_slots_ref(experts_sorted, capacity, num_experts)


def _check_plan(router_probs, top_k, capacity):
    p = router_probs
    reject_dtensors("moe_dispatch_plan", probabilities=p)
    if p.dtype != torch.float32:
        raise TypeError(f"moe_dispatch_plan: probabilities are {p.dtype}, "
                        f"want float32")
    if p.dim() not in (2, 3):
        raise ValueError(f"moe_dispatch_plan: probabilities have shape "
                         f"{tuple(p.shape)}, want [tokens, experts] or "
                         f"[groups, tokens, experts]")
    if not p.is_contiguous():
        raise ValueError("moe_dispatch_plan: probabilities are not "
                         "contiguous")
    n, E = p.shape[-2:]
    if p.dim() == 3 and not 1 <= p.shape[0] <= _I32_MAX // 8:
        raise ValueError(f"moe_dispatch_plan: {p.shape[0]} groups")
    if E > MAX_EXPERTS:
        raise ValueError(f"moe_dispatch_plan: {E} experts, the kernel takes "
                         f"at most {MAX_EXPERTS}")
    if not 1 <= top_k <= min(E, MAX_TOP_K):
        raise ValueError(f"moe_dispatch_plan: top_k {top_k} of {E} experts "
                         f"(1 .. {MAX_TOP_K})")
    if capacity < 0 or n * top_k > _I32_MAX or E * capacity > _I32_MAX:
        raise ValueError(f"moe_dispatch_plan: {n} tokens x top_k {top_k}, "
                         f"{E} experts x capacity {capacity}: out of int32 "
                         f"range")


def moe_dispatch_plan_cuda(router_probs, *, top_k, capacity):
    """Launch the fused plan (a CUDA tensor): one kernel, no other, for
    one plan or G grouped ones. Same outputs as
    :func:`moe_dispatch_plan`."""
    global launches
    p = router_probs
    _check_plan(p, top_k, capacity)
    if p.device.type != "cuda":
        raise ValueError(f"moe_dispatch_plan: probabilities on {p.device}, "
                         f"want CUDA")
    grouped = p.dim() == 3
    G = p.shape[0] if grouped else 1
    n, E = p.shape[-2:]
    lead = (G,) if grouped else ()
    slot_token = torch.empty(lead + (E * capacity,), dtype=torch.int32,
                             device=p.device)
    slot_weight = torch.empty(lead + (E * capacity,), dtype=torch.float32,
                              device=p.device)
    load = torch.empty(lead + (E,), dtype=torch.float32, device=p.device)
    count = (torch.empty((G, E), dtype=torch.int32, device=p.device)
             if grouped else None)
    # a group's rows start n * E * 4 bytes apart: 16-byte aligned with E
    vec4 = E % 4 == 0 and p.data_ptr() % 16 == 0
    with device_guard(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = _library().moe_dispatch_plan_launch(
            p.data_ptr(), slot_token.data_ptr(), slot_weight.data_ptr(),
            load.data_ptr(), count.data_ptr() if grouped else None, G, n, E,
            top_k, capacity, int(vec4), stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_dispatch_plan kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    plan = {"slot_token": slot_token, "slot_weight": slot_weight,
            "load": load}
    if grouped:
        plan["count"] = count
    return plan


def moe_dispatch_plan(router_probs, *, top_k, capacity):
    """The canonical-order dispatch plan. router_probs f32[N, E],
    contiguous -> {"slot_token": int32[E*C], the token feeding each
    expert slot (-1 empty); "slot_weight": f32[E*C], its combine weight
    (0 empty); "load": f32[E], the share of routed entries per expert}.
    Grouped, router_probs f32[G, n, E] -> G independent plans of n
    tokens: "slot_token" [G, E*C] (group-local indices), "slot_weight"
    [G, E*C], "load" [G, E] (the group's share) and "count": int32[G, E],
    the group's routed entries per expert. The fused kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if router_probs.device.type != "cpu":
        return moe_dispatch_plan_cuda(router_probs, top_k=top_k,
                                      capacity=capacity)
    _check_plan(router_probs, top_k, capacity)
    if router_probs.dim() == 3:
        return moe_dispatch_plan_grouped_ref(router_probs, top_k, capacity)
    return moe_dispatch_plan_ref(router_probs, top_k, capacity)


def moe_dispatch_chain(router_probs, *, top_k, capacity):
    """The plan as eager kernels around the sorted form (on a CUDA
    tensor): route, sort, ``dispatch_positions``, scatters, histogram.
    Held and timed against the fused launch; not on the main path."""
    return sorted_plan(router_probs, top_k, capacity, dispatch_positions)
