"""Wrappers of the lock_grant kernels (B1).

``lock_grant_step`` is the engine's form: the whole grant decision of one
ORTHRUS round, in entry order, from the round's [T, K] keys, modes,
pending and release masks and stamps and the lock table. For CUDA
tensors it is one launch of the fused kernel (``csrc/lock_grant.cu``,
``lock_grant_step_kernel``), for up to ``STEP_CAPACITY`` entries; for CPU
tensors its plain version (``ref.lock_grant_step_ref``). The engine
checks the static shapes and allocates the output once
(``step_output``) and passes it as ``out``; a call with ``out`` then
checks only the tensors' devices.

``lock_grant_sorted`` is the kernel's own contract, the segmented grant
over entries sorted by (key, enq) (``lock_grant_kernel``, any N); the
engine calls it between its own sort and unsort above the fused form's
capacity. ``lock_grant`` pads, gathers the lock table, sorts, runs it,
broadcasts segment totals (contender counts) and unsorts, so callers see
the contract of ``repro_torch.core.lockgrant.grant_round``.

The earlier design (``csrc/lock_grant_tile.cu``: one thread an entry,
1,024-entry tiles in series) is reached only through the private
``_lock_grant_tile``, and an empty launch of the same build through
``_launch_floor``; chip_smoke.py times them beside the kernels. Neither
counts in ``launches``.
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
from repro_torch.kernels.lock_grant.ref import (
    lock_grant_ref,
    lock_grant_step_ref,
)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / "lock_grant.cu"]
TILE_SOURCES = [CSRC / "lock_grant_tile.cu"]

# entries (T * K) of one launch of the fused form (kStepCap in the source)
STEP_CAPACITY = 4096

# Kernel launches since the last reset (``launches = 0``): both forms.
launches = 0

_LIB: ctypes.CDLL | None = None
_TILE_LIB: ctypes.CDLL | None = None
_P, _I = ctypes.c_void_p, ctypes.c_int


def _library() -> ctypes.CDLL:
    """The kernels' library (built at the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("lock_grant", SOURCES)
        lib.lock_grant_launch.argtypes = [_P] * 8 + [_I, _P]
        lib.lock_grant_step_launch.argtypes = [_P] * 7 + [_I] * 3 + [_P]
        lib.lock_grant_empty_launch.argtypes = [_I, _P]
        lib.lock_grant_step_capacity.argtypes = []
        for fn in ("lock_grant_launch", "lock_grant_step_launch",
                   "lock_grant_empty_launch", "lock_grant_step_capacity"):
            getattr(lib, fn).restype = ctypes.c_int
        if lib.lock_grant_step_capacity() != STEP_CAPACITY:
            raise RuntimeError("lock_grant: the built kernel's capacity is "
                               f"{lib.lock_grant_step_capacity()}, not "
                               f"{STEP_CAPACITY}")
        _LIB = lib
    return _LIB


def _tile_library() -> ctypes.CDLL:
    """The earlier design's library (built at the first call)."""
    global _TILE_LIB
    if _TILE_LIB is None:
        lib = _build.load("lock_grant_tile", TILE_SOURCES)
        lib.lock_grant_tile_launch.argtypes = [_P] * 8 + [_I, _P]
        lib.lock_grant_tile_launch.restype = ctypes.c_int
        _TILE_LIB = lib
    return _TILE_LIB


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check(name, t, dev, dtype, shape):
    if t.device != dev or dev.type != "cuda":
        raise ValueError(f"lock_grant: {name} on {t.device}, want {dev}")
    if t.dtype != dtype:
        raise TypeError(f"lock_grant: {name} is {t.dtype}, want {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"lock_grant: {name} has shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"lock_grant: {name} is not contiguous")


def _sorted_launch(entry, keys, kind, wh_free, rc):
    """Check the sorted-form inputs, allocate its outputs and call the C
    ``entry()`` returns under their device."""
    n = keys.shape[0]
    dev = keys.device
    for name, t, dt in (("keys", keys, torch.int32),
                        ("kind", kind, torch.int32),
                        ("wh_free", wh_free, torch.bool),
                        ("rc", rc, torch.int32)):
        _check(name, t, dev, dt, (n,))
    if n >= 2**31:
        raise ValueError(f"lock_grant: {n} entries exceed int32 indexing")
    grant = torch.empty(n, dtype=torch.bool, device=dev)
    req_pos, wbefore, op_pos = (torch.empty(n, dtype=torch.int32, device=dev)
                                for _ in range(3))
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry()(
            keys.data_ptr(), kind.data_ptr(), wh_free.data_ptr(),
            rc.data_ptr(), grant.data_ptr(), req_pos.data_ptr(),
            wbefore.data_ptr(), op_pos.data_ptr(), n, stream,
        )
    _raise_on(err, "lock_grant")
    return grant, req_pos, wbefore, op_pos


def lock_grant_cuda(keys, kind, wh_free, rc):
    """Launch the sorted-form kernel (CUDA tensors). Same outputs as
    :func:`lock_grant_ref`."""
    global launches
    out = _sorted_launch(lambda: _library().lock_grant_launch,
                         keys, kind, wh_free, rc)
    launches += 1
    return out


def _lock_grant_tile(keys, kind, wh_free, rc):
    """The earlier design (``csrc/lock_grant_tile.cu``), timed beside the
    kernel. Not counted in ``launches``; no path of the port calls it."""
    return _sorted_launch(lambda: _tile_library().lock_grant_tile_launch,
                          keys, kind, wh_free, rc)


def lock_grant_sorted(keys, kind, wh_free, rc):
    """The segmented grant over sorted entries: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if keys.device.type == "cpu":
        return lock_grant_ref(keys, kind, wh_free, rc)
    return lock_grant_cuda(keys, kind, wh_free, rc)


def step_output(T, K, num_records, device) -> torch.Tensor:
    """The fused form's output for [T, K] rounds over a table of
    ``num_records`` records on ``device``, its static shapes checked:
    what the engine builds once and passes as ``out``."""
    if T < 1 or K < 1 or T * K > STEP_CAPACITY:
        raise ValueError(f"lock_grant_step: T * K = {T} * {K} entries, want "
                         f"1 .. {STEP_CAPACITY}")
    if not 1 <= num_records < 2**31:
        raise ValueError(f"lock_grant_step: {num_records} records")
    return torch.empty((T, K), dtype=torch.bool, device=device)


def lock_grant_step_cuda(keys, modes, pend2d, rel_entries, enq, wh, rc,
                         num_records, *, out=None):
    """Launch the fused kernel (CUDA tensors): :func:`lock_grant_step_ref`
    in one launch. Release entries take no part in it: they are never
    granted and count in neither the requests nor the writes before an
    entry. With ``out`` (from :func:`step_output` for these shapes) only
    the devices are checked; without it everything is, and the output is
    allocated."""
    global launches
    if out is None:
        dev = keys.device
        T, K = keys.shape
        for name, t, dt in (("keys", keys, torch.int32),
                            ("modes", modes, torch.int32),
                            ("pend2d", pend2d, torch.bool),
                            ("rel_entries", rel_entries, torch.bool),
                            ("enq", enq, torch.int32)):
            _check(name, t, dev, dt, (T, K))
        for name, t in (("wh", wh), ("rc", rc)):
            _check(name, t, dev, torch.int32, None)
            if t.dim() != 1 or t.shape[0] < num_records:
                raise ValueError(f"lock_grant_step: {name} has shape "
                                 f"{tuple(t.shape)}, want at least "
                                 f"{num_records} entries")
        out = step_output(T, K, num_records, dev)
    else:
        dev = out.device
        for t in (keys, modes, pend2d, enq, wh, rc):
            if t.device != dev:
                raise ValueError(f"lock_grant_step: a tensor on {t.device}, "
                                 f"the output on {dev}")
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().lock_grant_step_launch(
            keys.data_ptr(), modes.data_ptr(), pend2d.data_ptr(),
            enq.data_ptr(), wh.data_ptr(), rc.data_ptr(), out.data_ptr(),
            out.numel(), out.shape[1], num_records, stream,
        )
    _raise_on(err, "lock_grant_step")
    launches += 1
    return out


def lock_grant_step(keys, modes, pend2d, rel_entries, enq, wh, rc,
                    num_records, *, out=None):
    """The engine's grant decision of one ORTHRUS round, bool [T, K]: the
    fused kernel for CUDA tensors, the plain version for CPU tensors."""
    if keys.device.type == "cpu":
        return lock_grant_step_ref(keys, modes, pend2d, rel_entries, enq, wh,
                                   rc, num_records)
    return lock_grant_step_cuda(keys, modes, pend2d, rel_entries, enq, wh, rc,
                                num_records, out=out)


def _launch_floor(device, threads=1024) -> None:
    """An empty one-block launch from the kernels' library, the launch
    floor chip_smoke.py times beside them. Not counted in ``launches``."""
    dev = torch.device(device)
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().lock_grant_empty_launch(threads, stream)
    _raise_on(err, "lock_grant_empty")


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
