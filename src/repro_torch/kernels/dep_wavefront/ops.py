"""Wrappers of the dep_wavefront kernels (B2).

``dep_wavefront_rows`` is the engine's form, the batch engine's stage 4
in one launch: from the slots' units, their predecessor rows and the
committed flags, whether every predecessor of each row has committed
(``csrc/dep_wavefront.cu``, ``dep_wavefront_rows_kernel``, for CUDA
tensors; ``ref.dep_wavefront_rows_ref`` for CPU tensors). The engine
checks the static shapes and allocates the output once (``rows_output``)
and passes it as ``out``; a call with ``out`` then checks only the
tensors' devices.

``dep_wavefront_ready`` keeps the TPU wrapper's whole contract: given a
batch's dependency edges and the committed bitmap, which units have
every predecessor committed? It pads, gathers ``done``, sorts the edges
by dst, runs the segmented scan (``dep_wavefront_sorted``: the kernel's
own contract, ``dep_wavefront_kernel``, any E), broadcasts segment
totals and scatters them to units. ``dep_wavefront_frag_ready`` adds the
fragment commit join (``frag_commit_barrier``).

The earlier design (``csrc/dep_wavefront_tile.cu``: one thread an edge,
1,024-edge tiles in series) is reached only through the private
``_dep_wavefront_tile``, and an empty launch of the same build through
``_launch_floor``; chip_smoke.py times them beside the kernels. Neither
counts in ``launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.lockgrant import (
    I32_MAX,
    KEY_SENTINEL,
    _segment_broadcast_last,
    segment_starts,
)
from repro_torch.kernels import _build, device_guard
from repro_torch.kernels.dep_wavefront.ref import (
    dep_wavefront_ref,
    dep_wavefront_rows_ref,
)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / "dep_wavefront.cu"]
TILE_SOURCES = [CSRC / "dep_wavefront_tile.cu"]

# Kernel launches since the last reset (``launches = 0``): both forms.
launches = 0

_LIB: ctypes.CDLL | None = None
_TILE_LIB: ctypes.CDLL | None = None
_P, _I = ctypes.c_void_p, ctypes.c_int


def _library() -> ctypes.CDLL:
    """The kernels' library (built at the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("dep_wavefront", SOURCES)
        lib.dep_wavefront_launch.argtypes = [_P] * 4 + [_I, _P]
        lib.dep_wavefront_rows_launch.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        lib.dep_wavefront_empty_launch.argtypes = [_I, _P]
        for fn in ("dep_wavefront_launch", "dep_wavefront_rows_launch",
                   "dep_wavefront_empty_launch"):
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _tile_library() -> ctypes.CDLL:
    """The earlier design's library (built at the first call)."""
    global _TILE_LIB
    if _TILE_LIB is None:
        lib = _build.load("dep_wavefront_tile", TILE_SOURCES)
        lib.dep_wavefront_tile_launch.argtypes = [_P] * 4 + [_I, _P]
        lib.dep_wavefront_tile_launch.restype = ctypes.c_int
        _TILE_LIB = lib
    return _TILE_LIB


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check(name, t, dev, dtype, shape):
    if t.device != dev or dev.type != "cuda":
        raise ValueError(f"dep_wavefront: {name} on {t.device}, want {dev}")
    if t.dtype != dtype:
        raise TypeError(f"dep_wavefront: {name} is {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"dep_wavefront: {name} has shape "
                         f"{tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"dep_wavefront: {name} is not contiguous")


def _grouped_launch(entry, dst, src_ok):
    """Check the grouped-edge inputs, allocate the outputs and call the C
    ``entry()`` returns under their device."""
    n = dst.shape[0]
    dev = dst.device
    _check("dst", dst, dev, torch.int32, (n,))
    _check("src_ok", src_ok, dev, torch.bool, (n,))
    if n >= 2**31:
        raise ValueError(f"dep_wavefront: {n} edges exceed int32 indexing")
    miss = torch.empty(n, dtype=torch.int32, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry()(dst.data_ptr(), src_ok.data_ptr(), miss.data_ptr(),
                      pos.data_ptr(), n, stream)
    _raise_on(err, "dep_wavefront")
    return miss, pos


def dep_wavefront_cuda(dst, src_ok):
    """Launch the grouped-edge kernel (CUDA tensors). Same outputs as
    :func:`dep_wavefront_ref`."""
    global launches
    out = _grouped_launch(lambda: _library().dep_wavefront_launch, dst,
                          src_ok)
    launches += 1
    return out


def _dep_wavefront_tile(dst, src_ok):
    """The earlier design (``csrc/dep_wavefront_tile.cu``), timed beside
    the kernel. Not counted in ``launches``; no path of the port calls
    it."""
    return _grouped_launch(lambda: _tile_library().dep_wavefront_tile_launch,
                           dst, src_ok)


def dep_wavefront_sorted(dst, src_ok):
    """The segmented scan over edges grouped by dst: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if dst.device.type == "cpu":
        return dep_wavefront_ref(dst, src_ok)
    return dep_wavefront_cuda(dst, src_ok)


def rows_output(T, P, n_done, device) -> torch.Tensor:
    """The row form's output for T rows of P predecessors over ``n_done``
    committed flags on ``device``, its static shapes checked: what the
    engine builds once and passes as ``out``."""
    if T < 1 or P < 1 or n_done < 1 or T * P >= 2**31 or n_done >= 2**31:
        raise ValueError(f"dep_wavefront_rows: T = {T}, P = {P}, "
                         f"{n_done} flags")
    return torch.empty(T, dtype=torch.bool, device=device)


def dep_wavefront_rows_cuda(row_unit, preds, done, *, out=None):
    """Launch the row kernel (CUDA tensors): :func:`dep_wavefront_rows_ref`
    in one launch. With ``out`` (from :func:`rows_output` for these
    shapes) only the devices are checked; without it everything is, and
    the output is allocated."""
    global launches
    if out is None:
        dev = row_unit.device
        if preds.dim() != 2:
            raise ValueError(f"dep_wavefront_rows: preds has shape "
                             f"{tuple(preds.shape)}, want [T, P]")
        T, P = preds.shape
        _check("row_unit", row_unit, dev, torch.int32, (T,))
        _check("preds", preds, dev, torch.int32, (T, P))
        _check("done", done, dev, torch.bool, (done.shape[0],))
        out = rows_output(T, P, done.shape[0], dev)
    else:
        dev = out.device
        for t in (row_unit, preds, done):
            if t.device != dev:
                raise ValueError(f"dep_wavefront_rows: a tensor on "
                                 f"{t.device}, the output on {dev}")
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().dep_wavefront_rows_launch(
            row_unit.data_ptr(), preds.data_ptr(), done.data_ptr(),
            out.data_ptr(), out.shape[0], preds.shape[1], done.shape[0],
            stream,
        )
    _raise_on(err, "dep_wavefront_rows")
    launches += 1
    return out


def dep_wavefront_rows(row_unit, preds, done, *, out=None):
    """The engine's stage 4, bool [T]: row t's unit has every predecessor
    committed. The row kernel for CUDA tensors, the plain version for CPU
    tensors.

    Row t holds unit ``row_unit[t]`` and its predecessors ``preds[t]``
    (int32 [T, P], -1 = none); ``done`` is the committed flag per unit.
    The edges go to the scan grouped by row, with no sort: a segment
    opens wherever dst changes, so it joins two rows only when they hold
    the same unit, whose rows are identical and get the same verdict;
    ``miss`` never falls within a segment, so "no edge of the row
    misses" is the unit's readiness, and equals the dense check
    ``((preds < 0) | done[preds]).all(1)``.
    """
    if row_unit.device.type == "cpu":
        return dep_wavefront_rows_ref(row_unit, preds, done)
    return dep_wavefront_rows_cuda(row_unit, preds, done, out=out)


def _launch_floor(device, threads=1024) -> None:
    """An empty one-block launch from the kernels' library, the launch
    floor chip_smoke.py times beside them. Not counted in ``launches``."""
    dev = torch.device(device)
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().dep_wavefront_empty_launch(threads, stream)
    _raise_on(err, "dep_wavefront_empty")


def dep_wavefront_ready(edge_dst, edge_src, done, *, num_txns, block_n=1024):
    """ready[u] = every dependency edge into u has a committed source.

    Twin of the TPU wrapper: ``edge_dst`` int32[E] (KEY_SENTINEL =
    padding), ``edge_src`` int32[E], ``done`` bool over units (indices
    clamped to ``num_txns - 1``). Returns bool[num_txns]; units with no
    edges are ready. ``block_n`` is the padding granule of the edge list
    (the TPU grid's block); the result does not depend on it.
    """
    dev = edge_dst.device
    pad = (-edge_dst.shape[0]) % block_n
    if pad:
        edge_dst = torch.cat([edge_dst, torch.full(
            (pad,), KEY_SENTINEL, dtype=edge_dst.dtype, device=dev)])
        edge_src = torch.cat([edge_src, torch.zeros(
            pad, dtype=edge_src.dtype, device=dev)])
    src_ok = done[torch.clamp(edge_src, 0, num_txns - 1).long()] | (
        edge_dst == KEY_SENTINEL
    )
    ds, order = torch.sort(edge_dst, stable=True)
    miss, _pos = dep_wavefront_sorted(ds, src_ok[order])
    # segment-total miss from the kernel's prefix counts
    active = ds != KEY_SENTINEL
    seg_start = segment_starts(ds) | ~active
    seg_id = torch.cumsum(seg_start, 0, dtype=torch.int32) - 1
    total_miss = _segment_broadcast_last(miss, seg_id)
    # scatter-min to units; row num_txns takes the dropped entries
    idx = torch.where(active & (ds < num_txns), ds, num_txns).long()
    ready = torch.ones(num_txns + 1, dtype=torch.int32, device=dev)
    ready.scatter_reduce_(0, idx, (total_miss == 0).to(torch.int32), "amin",
                          include_self=True)
    return ready[:num_txns] > 0


def frag_commit_barrier(frag_done, frag_txn, *, num_txns):
    """txn_done[t] = every fragment of transaction t is done (vacuously
    true for a transaction with no fragment)."""
    seg_min = torch.full((num_txns,), I32_MAX, dtype=torch.int32,
                         device=frag_done.device)
    seg_min.scatter_reduce_(0, frag_txn.long(), frag_done.to(torch.int32),
                            "amin", include_self=True)
    return seg_min > 0


def dep_wavefront_frag_ready(edge_dst, edge_src, frag_done, frag_txn, *,
                             num_frags, num_txns, block_n=1024):
    """Fragment-granular scheduler round: ``(frag_ready bool[num_frags],
    txn_done bool[num_txns])``."""
    frag_ready = dep_wavefront_ready(edge_dst, edge_src, frag_done,
                                     num_txns=num_frags, block_n=block_n)
    txn_done = frag_commit_barrier(frag_done, frag_txn, num_txns=num_txns)
    return frag_ready, txn_done
