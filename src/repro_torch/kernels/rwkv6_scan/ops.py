"""Wrapper of the rwkv6_scan kernel (B5).

``rwkv6_scan(r, k, v, w, u, state0, state_out=None)`` takes the TPU
wrapper's layout: r, k, v, w [B,H,S,hd], u [H,hd], state0 [B,H,hd,hd],
all float32, and returns ``(o [B,H,S,hd], state [B,H,hd,hd])``. For CUDA
tensors it launches the CUDA kernel (``csrc/rwkv6_scan.cu``: a register
tile of the state per thread, the output sums reduced once per chunk);
for CPU tensors it runs the plain version (``ref.py``). Both paths take
the same arguments and raise on the same bad ones.

r, k, v and w may be strided views whose last dim is contiguous (the
model passes ``x.transpose(1, 2)`` of its [B,S,H,hd] projections), and o
comes back as such a view of a [B,S,H,hd] tensor. Any S >= 1; hd in
``HEAD_DIMS``. With ``state_out`` (it may be ``state0`` itself, as for
the decode cache) the final state is written there and returned.

The earlier design (``csrc/rwkv6_scan_chain.cu``: one column of hd / 4
rows a thread, the output sums on each step's chain) is reached only
through the private ``_rwkv6_scan_chain``, and the new kernel's other
built tiles through ``_rwkv6_scan_tile``; chip_smoke.py times them
against the kernel. No path of the port calls either, and neither counts
in ``launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, device_guard, reject_dtensors
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / "rwkv6_scan.cu"]
CHAIN_SOURCES = [CSRC / "rwkv6_scan_chain.cu"]

HEAD_DIMS = (16, 32, 64, 128)
# the kernel's defaults: (rows, columns) of the register tile, columns a
# block, and steps a chunk, for a prefill and for a decode step (S <= 4;
# 4 x 2 tiles at hd = 16)
TILE, CHUNK = (4, 2, 16), 32
DECODE_TILE, DECODE_CHUNK = (4, 4, 16), 4
# the instances built at hd = 64 for the sweep: these tiles at CHUNK and
# DECODE_CHUNK, and TILE at SWEEP_CHUNKS
SWEEP_TILES = ((4, 2, 16), (4, 4, 16), (8, 1, 16), (2, 4, 16), (8, 2, 16),
               (2, 2, 16), (4, 1, 16), (4, 2, 8))
SWEEP_CHUNKS = (16, 64)

# Kernel launches since the last reset (``launches = 0``).
launches = 0

_LIB: ctypes.CDLL | None = None
_CHAIN_LIB: ctypes.CDLL | None = None
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
_TAIL = [ctypes.c_void_p, ctypes.c_void_p]  # strides, stream


def _library() -> ctypes.CDLL:
    """The kernel's library (built at the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("rwkv6_scan", SOURCES)
        lib.rwkv6_scan_launch.argtypes = _ARGTYPES + _TAIL
        lib.rwkv6_scan_tile_launch.argtypes = (_ARGTYPES
                                               + [ctypes.c_int] * 4 + _TAIL)
        lib.rwkv6_scan_launch.restype = ctypes.c_int
        lib.rwkv6_scan_tile_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _chain_library() -> ctypes.CDLL:
    """The earlier design's library (built at the first call)."""
    global _CHAIN_LIB
    if _CHAIN_LIB is None:
        lib = _build.load("rwkv6_scan_chain", CHAIN_SOURCES)
        lib.rwkv6_scan_chain_launch.argtypes = _ARGTYPES + _TAIL
        lib.rwkv6_scan_chain_launch.restype = ctypes.c_int
        _CHAIN_LIB = lib
    return _CHAIN_LIB


def _check(r, k, v, w, u, state0, state_out):
    """Raise on arguments the kernel does not take; returns (B, H, S, hd)."""
    reject_dtensors("rwkv6_scan", r=r, k=k, v=v, w=w, u=u, state0=state0,
                    state_out=state_out)
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: r must be [B, H, S, hd], got "
                         f"{tuple(r.shape)}")
    B, H, S, D = r.shape
    named = dict(r=r, k=k, v=v, w=w, u=u, state0=state0)
    if state_out is not None:
        named["state_out"] = state_out
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan: {name} is {t.dtype}, not float32")
        if t.device != r.device:
            raise ValueError(f"rwkv6_scan: {name} on {t.device}, r on "
                             f"{r.device}")
    for name in ("k", "v", "w"):
        if named[name].shape != r.shape:
            raise ValueError(f"rwkv6_scan: {name} {tuple(named[name].shape)}"
                             f", r {tuple(r.shape)}")
    if u.shape != (H, D):
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)}, want {(H, D)}")
    for name in ("state0", "state_out"):
        t = named.get(name)
        if t is not None and t.shape != (B, H, D, D):
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)}, want "
                             f"{(B, H, D, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head_dim {D} not in {HEAD_DIMS}")
    if S < 1 or B < 1 or H < 1:
        raise ValueError(f"rwkv6_scan: empty input {tuple(r.shape)}")
    if B * H >= 2**31:
        raise ValueError(f"rwkv6_scan: B * H = {B * H} blocks too many")
    for name, t in named.items():
        if name in ("r", "k", "v", "w"):
            ok = t.stride(3) == 1 and all(s % 4 == 0 for s in t.stride()[:3])
            what = "a contiguous last dim and strides of multiples of 4"
        else:
            ok = t.is_contiguous()
            what = "contiguous"
        if not ok or t.data_ptr() % 16:
            raise ValueError(f"rwkv6_scan: {name} (strides {t.stride()}) is "
                             f"not {what}, 16-byte aligned")
    return B, H, S, D


def _launch(r, k, v, w, u, state0, state_out, entry, *extra):
    """Check, allocate o (and the state if ``state_out`` is None) and
    call the C entry point that ``entry()`` returns under r's device,
    with ``extra`` before the strides. Returns (o, state)."""
    B, H, S, D = _check(r, k, v, w, u, state0, state_out)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: tensors on {r.device}, want a CUDA "
                         f"device")
    o = torch.empty((B, S, H, D), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    if state_out is None:
        state_out = torch.empty_like(state0)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (r, k, v, w, o) for s in t.stride()[:3]))
    with device_guard(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = entry()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            state0.data_ptr(), o.data_ptr(), state_out.data_ptr(), B, H, S, D,
            *extra, strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    return o, state_out


def rwkv6_scan_cuda(r, k, v, w, u, state0, *, state_out=None):
    """Launch the kernel (CUDA tensors). Same result as
    :func:`rwkv6_scan_ref`, summed in another order."""
    global launches
    out = _launch(r, k, v, w, u, state0, state_out,
                  lambda: _library().rwkv6_scan_launch)
    launches += 1
    return out


def _rwkv6_scan_tile(r, k, v, w, u, state0, *, state_out=None, tile=TILE,
                     chunk=CHUNK):
    """The kernel at a chosen instance: ``tile`` (rows, columns of the
    register tile, columns a block) and ``chunk`` steps a chunk, one of
    those built (the defaults at every hd; at hd = 64 the sweep's).
    Not counted in ``launches``."""
    return _launch(r, k, v, w, u, state0, state_out,
                   lambda: _library().rwkv6_scan_tile_launch, *tile, chunk)


def _rwkv6_scan_chain(r, k, v, w, u, state0, *, state_out=None):
    """The earlier design (``csrc/rwkv6_scan_chain.cu``), timed beside
    the kernel. Not counted in ``launches``; no path of the port calls
    it."""
    return _launch(r, k, v, w, u, state0, state_out,
                   lambda: _chain_library().rwkv6_scan_chain_launch)


def rwkv6_scan(r, k, v, w, u, state0, *, state_out=None):
    """The WKV recurrence: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if r.device.type == "cpu":
        _check(r, k, v, w, u, state0, state_out)
        o, state = rwkv6_scan_ref(r, k, v, w, u, state0)
        if state_out is not None:
            state = state_out.copy_(state)
        return o, state
    return rwkv6_scan_cuda(r, k, v, w, u, state0, state_out=state_out)
