"""Wrappers of the dep_wavefront kernel.

``dep_wavefront_ready`` keeps the TPU wrapper's whole contract: given a
batch's dependency edges and the committed bitmap, which units have
every predecessor committed? It pads, gathers ``done``, sorts the edges
by dst, runs the segmented scan, broadcasts segment totals and scatters
them to units. ``dep_wavefront_frag_ready`` adds the fragment commit
join (``frag_commit_barrier``). The segmented scan is the CUDA kernel
(``csrc/dep_wavefront.cu``) for a CUDA tensor and its plain version
(``ref.py``) for a CPU tensor.

The engine calls ``dep_wavefront_rows``: its edges are already grouped
by slot row, so it needs neither the sort nor the scatter.
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
from repro_torch.kernels.dep_wavefront.ref import dep_wavefront_ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "dep_wavefront.cu"]

# Kernel launches since the last reset (``launches = 0``).
launches = 0


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built kernel library (built at the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("dep_wavefront", SOURCES)
        fn = lib.dep_wavefront_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def dep_wavefront_cuda(dst, src_ok):
    """Launch the kernel on edges grouped by dst (CUDA tensors).

    Same outputs as :func:`dep_wavefront_ref`."""
    global launches
    n = dst.shape[0]
    dev = dst.device
    for name, t, dt in (("dst", dst, torch.int32),
                        ("src_ok", src_ok, torch.bool)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"dep_wavefront: {name} on {t.device}, want {dev}")
        if t.dtype != dt:
            raise TypeError(f"dep_wavefront: {name} is {t.dtype}, want {dt}")
        if t.shape != (n,):
            raise ValueError(
                f"dep_wavefront: {name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"dep_wavefront: {name} is not contiguous")
    if n >= 2**31:
        raise ValueError(f"dep_wavefront: {n} edges exceed int32 indexing")
    miss = torch.empty(n, dtype=torch.int32, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().dep_wavefront_launch(
            dst.data_ptr(), src_ok.data_ptr(), miss.data_ptr(), pos.data_ptr(),
            n, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dep_wavefront kernel launch failed: CUDA error {err}")
    launches += 1
    return miss, pos


def dep_wavefront_sorted(dst, src_ok):
    """The segmented scan over edges grouped by dst: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if dst.device.type == "cpu":
        return dep_wavefront_ref(dst, src_ok)
    return dep_wavefront_cuda(dst, src_ok)


def dep_wavefront_rows(row_unit, preds, src_ok):
    """The engine's form: bool[T], row t's unit has every predecessor
    committed.

    Row t holds unit ``row_unit[t]`` and its predecessor row ``preds[t]``
    (int32[T, P], -1 = none); ``src_ok[t, j]`` says whether ``preds[t,
    j]`` has committed. The edges go to the scan grouped by row, with no
    sort: a segment opens wherever dst changes, so it joins two rows only
    when they hold the same unit, whose rows are identical and get the
    same verdict; ``miss`` never falls within a segment, so "no edge of
    the row misses" is the unit's readiness.

    The per-row ``amax`` over ``miss`` makes this form equal to the dense
    check ``((preds < 0) | src_ok).all(1)``: the segments the kernel
    counts do not change the verdict, and ``pos`` is unused. A fused
    stage-4 kernel (gather ``done[preds]``, scan, write the row verdict
    in one launch) would drop the ``where``, the ``amax``, the compare
    and the ``pos`` store.
    """
    edge_dst = torch.where(preds >= 0, row_unit[:, None], KEY_SENTINEL)
    miss, _pos = dep_wavefront_sorted(edge_dst.reshape(-1),
                                      src_ok.reshape(-1))
    return miss.view(preds.shape).amax(dim=1) == 0


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
