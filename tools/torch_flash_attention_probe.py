#!/usr/bin/env python3
"""Quick check of kernel B4 on one NVIDIA GPU, in about a minute.

    python3 tools/torch_flash_attention_probe.py

Builds B4's two libraries (the bf16 tensor-core kernel and the f32
CUDA-core one) and prints nvcc's -Xptxas -v report and the HGMMA count
of the tensor-core library's SASS; holds the bf16 kernel to its plain
version (2e-2 or one bf16 unit of the output, whichever is larger) at 76
shapes: d = 32, 64, 128, 256 x six layouts (S = 1 .. 200, ragged T,
1 to 4 query heads per KV head) x three kinds, plus gemma3-1b's and
mixtral-8x22b's prefill layouts; and times the kernel, its earlier
CUDA-core design and F.scaled_dot_product_attention once each at those
two models' shapes (random inputs; chip_smoke.py times them in turns on
real activations). Exits non-zero if a shape disagrees.
"""

import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

LAYOUTS = ((1, 64, 64, 2, 1), (1, 64, 64, 1, 1), (2, 200, 200, 4, 2),
           (1, 100, 160, 3, 1), (1, 1, 1, 2, 1), (1, 7, 7, 2, 2))
KINDS = (("full", 0), ("swa", 48), ("chunked", 48))


def check(dev, B, S, T, HQ, HKV, D, kind, window, seed=0) -> bool:
    """The kernel against its plain version on unit-normal bf16 inputs."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((B, S, HQ, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, T, HKV, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, T, HKV, D), generator=g, device=dev).bfloat16()
    label = f"B={B} S={S} T={T} H={HQ}/{HKV} d={D} {kind} {window}"
    try:
        got = ops.flash_attention_cuda(q, k, v, kind=kind, window=window)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        print(f"FAIL launch {label}: {exc}")
        return False
    want = flash_attention_ref(q, k, v, kind=kind, window=window).float()
    diff = (got.float() - want).abs()
    tol = torch.clamp(cs.bf16_ulp(want), min=cs.FA_TOL["bfloat16"])
    ratio = float((diff / tol).max())
    ok = ratio <= 1 and bool(torch.isfinite(got).all())
    print(("ok  " if ok else "BAD ") + f"{label}: err "
          f"{float(diff.max()):.4g} ratio {ratio:.3g}")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), cs.gpu_name_and_power())
    t0 = time.time()
    try:
        ops._library()
    finally:
        for name, (secs, log) in _build.BUILD_LOG.items():
            print(f"== build {name} {secs:.1f}s\n{log}")
    ops._simt_library()
    print("built", time.time() - t0)
    lib = Path(ops._library()._name)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        print("HGMMA count", sass.count("HGMMA"), "lines",
              len(sass.splitlines()))

    bad = 0
    for D in (32, 64, 128, 256):
        for B, S, T, HQ, HKV in LAYOUTS:
            for kind, window in KINDS:
                bad += not check(dev, B, S, T, HQ, HKV, D, kind, window)
    bad += not check(dev, 1, 2048, 2048, 4, 1, 256, "full", 0)
    bad += not check(dev, 1, 2048, 2048, 4, 1, 256, "swa", 512)
    bad += not check(dev, 1, 3000, 3000, 48, 8, 128, "swa", 4096)
    bad += not check(dev, 1, 2900, 3000, 48, 8, 128, "swa", 4096)
    print("BAD", bad)

    for label, (B, S, HQ, HKV, D), kind, window in (
            ("gemma global", (1, 2048, 4, 1, 256), "full", 0),
            ("gemma swa", (1, 2048, 4, 1, 256), "swa", 512),
            ("mixtral", (1, 3000, 48, 8, 128), "swa", 4096)):
        q, k, v = cs.random_attention(B, S, HQ, HKV, D, torch.bfloat16, S,
                                      dev)
        tc = cs.graph_ms(lambda: ops.flash_attention_cuda(
            q, k, v, kind=kind, window=window), repeats=10, samples=11)
        simt = cs.graph_ms(lambda: ops._flash_attention_simt(
            q, k, v, kind=kind, window=window), repeats=10, samples=11)
        sdpa, how = cs.sdpa_call(q, k, v, kind, window)
        sd = cs.graph_ms(sdpa, repeats=10, samples=11)
        bound = cs.attention_bound(q, k, kind, window)[0]
        print(f"TIME {label}: tc {tc:.6f} simt {simt:.6f} sdpa({how}) "
              f"{sd:.6f} bound {bound:.6f} tc/sdpa {tc / sd:.3f} simt/tc "
              f"{simt / tc:.2f}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
