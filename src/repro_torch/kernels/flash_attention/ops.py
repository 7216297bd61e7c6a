"""Wrapper of the flash_attention kernel (B4).

``flash_attention(q, k, v, kind=, window=)`` takes the model's layout,
q [B,S,Hq,d] and k/v [B,T,Hkv,d], as the TPU wrapper does, and returns
[B,S,Hq,d] in q's type. For CUDA tensors it launches the CUDA kernel
(``csrc/flash_attention.cu``), which reads that layout directly: no GQA
repeat and no transpose. For CPU tensors it runs the plain version
(``ref.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]

KINDS = {"full": 0, "swa": 1, "chunked": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
Q_TILE = 64  # query rows per block (the kernel's BQ)

# Kernel launches since the last reset (``launches = 0``).
launches = 0

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built kernel library (built at the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention", SOURCES)
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def flash_attention_cuda(q, k, v, *, kind="full", window=0):
    """Launch the kernel (CUDA tensors). Same result as
    :func:`flash_attention_ref`, for S <= T (every query sees its own
    key)."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S|T, H, d]")
    B, S, HQ, D = q.shape
    T, HKV = k.shape[1], k.shape[2]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"flash_attention: {name} on {t.device}, want "
                             f"one CUDA device")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not contiguous and "
                             f"16-byte aligned")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: {q.dtype} not in float32, bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if HKV == 0 or HQ % HKV:
        raise ValueError(f"flash_attention: {HQ} query heads over {HKV} KV "
                         f"heads")
    if kind not in KINDS:
        raise ValueError(f"flash_attention: kind {kind!r} not in "
                         f"{tuple(KINDS)}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if S > T:
        raise ValueError(f"flash_attention: {S} queries over {T} keys")
    if B * HQ >= 2**31 or -(-S // Q_TILE) > 65535:
        raise ValueError(f"flash_attention: grid too large for B={B}, "
                         f"Hq={HQ}, S={S}")
    o = torch.empty_like(q)
    if S == 0 or B * HQ == 0:
        return o
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, T, HQ, HKV, D, DTYPES[q.dtype], KINDS[kind], window, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return o


def flash_attention(q, k, v, *, kind="full", window=0):
    """Attention over the model's layout: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kind=kind, window=window)
    return flash_attention_cuda(q, k, v, kind=kind, window=window)
