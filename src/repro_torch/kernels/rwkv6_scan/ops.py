"""Wrapper of the rwkv6_scan kernel (B5).

``rwkv6_scan(r, k, v, w, u, state0, state_out=None)`` takes the TPU
wrapper's layout: r, k, v, w [B,H,S,hd], u [H,hd], state0 [B,H,hd,hd],
all float32, and returns ``(o [B,H,S,hd], state [B,H,hd,hd])``. For CUDA
tensors it launches the CUDA kernel (``csrc/rwkv6_scan.cu``); for CPU
tensors it runs the plain version (``ref.py``). Both paths take the same
arguments and raise on the same bad ones.

r, k, v and w may be strided views whose last dim is contiguous (the
model passes ``x.transpose(1, 2)`` of its [B,S,H,hd] projections), and o
comes back as such a view of a [B,S,H,hd] tensor. Any S >= 1; hd in
``HEAD_DIMS``. With ``state_out`` (it may be ``state0`` itself, as for
the decode cache) the final state is written there and returned.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, device_guard
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"]

HEAD_DIMS = (16, 32, 64, 128)

# Kernel launches since the last reset (``launches = 0``).
launches = 0

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built kernel library (built at the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("rwkv6_scan", SOURCES)
        fn = lib.rwkv6_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(r, k, v, w, u, state0, state_out):
    """Raise on arguments the kernel does not take; returns (B, H, S, hd)."""
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


def rwkv6_scan_cuda(r, k, v, w, u, state0, *, state_out=None):
    """Launch the kernel (CUDA tensors). Same result as
    :func:`rwkv6_scan_ref`, summed in another order."""
    global launches
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
        err = _library().rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            state0.data_ptr(), o.data_ptr(), state_out.data_ptr(), B, H, S, D,
            strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return o, state_out


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
