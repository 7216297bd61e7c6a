"""Wrapper of the flash_attention kernel (B4).

``flash_attention(q, k, v, kind=, window=)`` takes the model's layout,
q [B,S,Hq,d] and k/v [B,T,Hkv,d], as the TPU wrapper does, and returns
[B,S,Hq,d] in q's type. For CUDA tensors it launches a CUDA kernel that
reads that layout directly (no GQA repeat, no transpose), chosen by
dtype:

  bfloat16 (the main path's type) — the tensor-core kernel,
            ``csrc/flash_attention_tc.cu`` (wgmma, TMA-fed K/V ring);
  float32  — the CUDA-core kernel, ``csrc/flash_attention.cu``: TF32
            tensor cores keep about three decimal digits and cannot meet
            f32's 3e-5.

The CUDA-core kernel's bf16 instance is reached only through the private
``_flash_attention_simt``, which chip_smoke.py times as the earlier
design; no path picks it. For CPU tensors the plain version (``ref.py``)
runs.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, device_guard, reject_dtensors
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / "flash_attention_tc.cu"]  # bf16, tensor cores
SIMT_SOURCES = [CSRC / "flash_attention.cu"]  # f32 (and bf16), CUDA cores

KINDS = {"full": 0, "swa": 1, "chunked": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
Q_TILE = 64  # query rows per block (per consumer warpgroup on tensor cores)
# the tensor-core entry's own return codes beside cudaError_t's
TC_ERRORS = {1001: "cuTensorMapEncodeTiled not found in libcuda.so.1",
             1002: "a TMA tensor map was refused"}

# Kernel launches since the last reset (``launches = 0``).
launches = 0

_LIB: ctypes.CDLL | None = None
_SIMT_LIB: ctypes.CDLL | None = None
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    """The tensor-core kernel's library (built at the first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention", SOURCES)
        fn = lib.flash_attention_tc_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _simt_library() -> ctypes.CDLL:
    """The CUDA-core kernel's library (built at the first call)."""
    global _SIMT_LIB
    if _SIMT_LIB is None:
        lib = _build.load("flash_attention_simt", SIMT_SOURCES)
        fn = lib.flash_attention_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _SIMT_LIB = lib
    return _SIMT_LIB


def _check(q, k, v, kind, window):
    """Raise on arguments the kernels do not take; (B, S, T, Hq, Hkv, d)."""
    reject_dtensors("flash_attention", q=q, k=k, v=v)
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
    return B, S, T, HQ, HKV, D


def _launch(q, k, v, kind, window, *, simt=False, heads_per_block=0):
    """Check, allocate o and launch under q's device: the CUDA-core
    kernel with ``simt``, else the tensor-core one with
    ``heads_per_block`` query heads of a KV head in a block (0: the
    kernel's own choice, two where they pair up and the launch is bound
    by its total work rather than its heaviest query tile, else one).
    (o, whether a kernel was launched)."""
    B, S, T, HQ, HKV, D = _check(q, k, v, kind, window)
    o = torch.empty_like(q)
    if S == 0 or B * HQ == 0:
        return o, False
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, T,
            HQ, HKV, D)
    with device_guard(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if simt:
            err = _simt_library().flash_attention_launch(
                *args, DTYPES[q.dtype], KINDS[kind], window, stream)
        else:
            err = _library().flash_attention_tc_launch(
                *args, KINDS[kind], window, heads_per_block, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{TC_ERRORS.get(err, f'CUDA error {err}')}")
    return o, True


def flash_attention_cuda(q, k, v, *, kind="full", window=0):
    """Launch the kernel for q's dtype (CUDA tensors): bf16 on the tensor
    cores, f32 on the CUDA cores. Same result as
    :func:`flash_attention_ref`, for S <= T (every query sees its own
    key)."""
    global launches
    o, launched = _launch(q, k, v, kind, window,
                          simt=q.dtype != torch.bfloat16)
    launches += launched
    return o


def _flash_attention_tc(q, k, v, *, kind="full", window=0,
                        heads_per_block=1):
    """The tensor-core kernel with a chosen head packing, 1 or 2
    (chip_smoke.py times the two against each other). Not counted in
    ``launches``."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: the tensor-core kernel takes "
                        f"bfloat16, not {q.dtype}")
    return _launch(q, k, v, kind, window,
                   heads_per_block=heads_per_block)[0]


def _flash_attention_simt(q, k, v, *, kind="full", window=0):
    """The CUDA-core kernel at q's dtype, bf16 included: the earlier
    design, timed beside the tensor-core kernel. Not counted in
    ``launches``; no path of the port calls it."""
    return _launch(q, k, v, kind, window, simt=True)[0]


def flash_attention(q, k, v, *, kind="full", window=0):
    """Attention over the model's layout: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        reject_dtensors("flash_attention", q=q, k=k, v=v)
        return flash_attention_ref(q, k, v, kind=kind, window=window)
    return flash_attention_cuda(q, k, v, kind=kind, window=window)
