"""Wrapper of the lock_grant kernel.

``lock_grant`` pads, gathers the lock table, sorts by (key, enq), runs
the segmented grant over the sorted entries, broadcasts segment totals
(contender counts) and unsorts, so callers see the contract of
``repro_torch.core.lockgrant.grant_round``. The segmented grant is the
CUDA kernel (``csrc/lock_grant.cu``) for a CUDA tensor and its plain
version (``ref.py``) for a CPU tensor.

The engine sorts its entries itself and calls ``lock_grant_sorted``; it
needs neither the padding nor the contender counts.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.lockgrant import (
    KEY_SENTINEL,
    REQ_NONE,
    _segment_broadcast_last,
    gather_holders,
    inverse_permutation,
    lex_order,
    segment_starts,
)
from repro_torch.kernels import _build, device_guard
from repro_torch.kernels.lock_grant.ref import lock_grant_ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "lock_grant.cu"]

# Kernel launches since the last reset (``launches = 0``).
launches = 0


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built kernel library (built at the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("lock_grant", SOURCES)
        fn = lib.lock_grant_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def lock_grant_cuda(keys, kind, wh_free, rc):
    """Launch the kernel on sorted entries (all CUDA tensors).

    Same outputs as :func:`lock_grant_ref`."""
    global launches
    n = keys.shape[0]
    dev = keys.device
    for name, t, dt in (("keys", keys, torch.int32),
                        ("kind", kind, torch.int32),
                        ("wh_free", wh_free, torch.bool),
                        ("rc", rc, torch.int32)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"lock_grant: {name} on {t.device}, want {dev}")
        if t.dtype != dt:
            raise TypeError(f"lock_grant: {name} is {t.dtype}, want {dt}")
        if t.shape != (n,):
            raise ValueError(f"lock_grant: {name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"lock_grant: {name} is not contiguous")
    if n >= 2**31:
        raise ValueError(f"lock_grant: {n} entries exceed int32 indexing")
    grant = torch.empty(n, dtype=torch.bool, device=dev)
    req_pos = torch.empty(n, dtype=torch.int32, device=dev)
    wbefore = torch.empty(n, dtype=torch.int32, device=dev)
    op_pos = torch.empty(n, dtype=torch.int32, device=dev)
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().lock_grant_launch(
            keys.data_ptr(), kind.data_ptr(), wh_free.data_ptr(), rc.data_ptr(),
            grant.data_ptr(), req_pos.data_ptr(), wbefore.data_ptr(),
            op_pos.data_ptr(), n, stream,
        )
    if err != 0:
        raise RuntimeError(f"lock_grant kernel launch failed: CUDA error {err}")
    launches += 1
    return grant, req_pos, wbefore, op_pos


def lock_grant_sorted(keys, kind, wh_free, rc):
    """The segmented grant over sorted entries: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if keys.device.type == "cpu":
        return lock_grant_ref(keys, kind, wh_free, rc)
    return lock_grant_cuda(keys, kind, wh_free, rc)


def lock_grant(keys, ts, kind, write_holder, read_count, *, num_records,
               block_n=1024):
    """Twin of ``core.lockgrant.grant_round``: (grant, contenders).

    ``block_n`` (a power of two, 64 to 1024) is the padding granule of the
    entry list, as in the TPU wrapper; the results do not depend on it.
    """
    n = keys.shape[0]
    pad = (-n) % block_n
    if pad:
        dev = keys.device
        keys = torch.cat([keys, torch.full((pad,), KEY_SENTINEL,
                                           dtype=keys.dtype, device=dev)])
        ts = torch.cat([ts, torch.zeros(pad, dtype=ts.dtype, device=dev)])
        kind = torch.cat([kind, torch.full((pad,), REQ_NONE,
                                           dtype=kind.dtype, device=dev)])
    wh_free, rc = gather_holders(keys, write_holder, read_count, num_records)
    order = lex_order(keys, ts)
    inv = inverse_permutation(order)
    ks = keys[order]
    kinds = kind[order]
    grant, _req_pos, _wbefore, op_pos = lock_grant_sorted(
        ks, kinds, wh_free[order], rc[order]
    )
    active = kinds != REQ_NONE
    seg_start = segment_starts(ks) | ~active
    seg_id = torch.cumsum(seg_start, 0, dtype=torch.int32) - 1
    contenders = torch.where(active, _segment_broadcast_last(op_pos, seg_id), 0)
    return grant[inv][:n], contenders[inv][:n]
