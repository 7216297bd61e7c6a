"""Wrapper of the moe_dispatch kernel (B3).

``dispatch_positions(experts_sorted, capacity, num_experts)`` is the
kernel's contract, (pos, keep), plus each entry's dispatch slot. For
CUDA tensors it launches the CUDA kernel (``csrc/moe_dispatch.cu``), for
CPU tensors it runs the plain version (``ref.py``).

``moe_dispatch_plan`` is the dispatch plan: top-k routing, a stable sort
into the canonical (expert, arrival) order, the slots from B3, then the
scatters into the [experts * capacity] dispatch table. With ``plain`` the
slots come from B3's plain version on any device: that is
``repro_torch.models.moe.plan_dispatch``. JAX's out-of-range scatters
(``mode="drop"``) become writes into one extra drop row that is sliced
off: torch raises on such an index, and CUDA device-asserts.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, device_guard
from repro_torch.kernels.moe_dispatch.ref import dispatch_slots_ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "moe_dispatch.cu"]

# Kernel launches since the last reset (``launches = 0``).
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
        _LIB = lib
    return _LIB


def _check(experts_sorted, capacity, num_experts):
    e = experts_sorted
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
    """Launch the kernel (a CUDA tensor). Same outputs as
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
    row). The kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if experts_sorted.device.type != "cpu":
        return dispatch_positions_cuda(experts_sorted, capacity, num_experts)
    _check(experts_sorted, capacity, num_experts)
    return dispatch_slots_ref(experts_sorted, capacity, num_experts)


def route(router_probs, top_k):
    """Each token's top-k experts [N, k] and their weights, renormalised
    to sum to 1 (at least 1e-9 before the division)."""
    w, eidx = torch.topk(router_probs, top_k)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), eidx


def routed_share(eidx, num_experts):
    """f32[E]: the share of the N*k routed entries that go to each expert
    (a histogram by ``index_add_``: ``bincount`` would sync the host)."""
    ee = eidx.reshape(-1)
    load = torch.zeros(num_experts, dtype=torch.float32, device=ee.device)
    load.index_add_(0, ee, torch.ones(ee.shape[0], dtype=torch.float32,
                                      device=ee.device))
    return load / ee.shape[0]


def moe_dispatch_plan(router_probs, *, top_k, capacity, plain=False):
    """The canonical-order dispatch plan. router_probs f32[N, E] ->
    {"slot_token": int32[E*C], the token feeding each expert slot (-1
    empty); "slot_weight": f32[E*C], its combine weight; "load": f32[E],
    the share of routed entries per expert}. The slots come from
    ``dispatch_positions`` (B3 on the card), or with ``plain`` from its
    plain version."""
    E = router_probs.shape[1]
    dev = router_probs.device
    w, eidx = route(router_probs, top_k)
    ee = eidx.reshape(-1).to(torch.int32)
    ee_s, order = torch.sort(ee, stable=True)
    slots = dispatch_slots_ref if plain else dispatch_positions
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
            "load": routed_share(ee, E)}
