"""Build the hand-written CUDA kernels at first use and load them.

Each kernel's ``csrc/*.cu`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C entry point, which
:func:`load` opens with ``ctypes``. The library lands in
``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of its sources and flags, so an edited source rebuilds and an
unchanged one is built once per checkout. A missing ``nvcc`` or a
failed build raises: the kernels have no silent substitute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# per library: (seconds the build took, nvcc's output incl. -Xptxas -v)
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch cannot be built"
    )


def load(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>`` from ``sources``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} (exit {proc.returncode}):\n{log}"
            )
        os.replace(tmp, out)
        BUILD_LOG[name] = (secs, log)
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
