#!/usr/bin/env python3
"""Quick check of kernel B5 on one NVIDIA GPU, in about a minute.

    python3 tools/torch_rwkv6_scan_probe.py

Builds B5's two libraries (the kernel, rwkv6_scan.cu, and its earlier
design, rwkv6_scan_chain.cu) and prints nvcc's -Xptxas -v report per
instance (it fails on a spill); holds both designs, and the kernel's
sweep instances, to the plain version (chip_smoke.py's RWKV_TOL) at
random shapes: every hd, S across the chunk edges (1 .. 65), B·H = 1 and
256, the state written in place and not, the model's strided views; and
times both designs once, and the sweep's instances, at rwkv6-1.6b's
prefill layer (B 1, H 32, S 3,000, hd 64) and decode step (B 8, S 1),
random inputs (chip_smoke.py times them in turns on real activations).
Exits non-zero if a shape disagrees.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402

LENGTHS = (1, 3, 4, 5, 31, 32, 33, 65)
BH = ((1, 1), (8, 32))


def designs():
    """(label, launcher) of every instance the probe holds and times."""
    out = [("kernel", ops.rwkv6_scan_cuda),
           ("earlier design", ops._rwkv6_scan_chain)]
    for tile in ops.SWEEP_TILES:
        for chunk in (ops.DECODE_CHUNK, ops.CHUNK):
            out.append((f"tile {tile} chunk {chunk}",
                        lambda *a, tile=tile, chunk=chunk, **kw:
                        ops._rwkv6_scan_tile(*a, tile=tile, chunk=chunk,
                                             **kw)))
    for chunk in ops.SWEEP_CHUNKS:
        out.append((f"tile {ops.TILE} chunk {chunk}",
                    lambda *a, chunk=chunk, **kw:
                    ops._rwkv6_scan_tile(*a, chunk=chunk, **kw)))
    return out


def check(fn, label, args, in_place) -> bool:
    """``fn`` against the plain version, o and the final state."""
    s_in = args[5].clone()
    try:
        got = fn(*args[:5], s_in, state_out=s_in if in_place else None)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        print(f"FAIL launch {label}: {exc}")
        return False
    want = rwkv6_scan_ref(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ok = err <= cs.RWKV_TOL and all(bool(torch.isfinite(g).all())
                                    for g in got)
    if in_place and got[1].data_ptr() != s_in.data_ptr():
        ok = False
    if not ok:
        print(f"BAD {label}: err {err:.4g}")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), cs.gpu_name_and_power())
    t0 = time.time()
    bad = n = 0
    try:
        ops._library()
        ops._chain_library()
    finally:
        try:
            cs.rwkv6_scan_build_report()
        except AssertionError as exc:  # a spill: report it, hold and time
            print(f"BAD {exc}")
            bad += 1
    print(f"built in {time.time() - t0:.1f} s")

    for label, fn in designs()[:2]:
        for D in ops.HEAD_DIMS:
            for B, H in BH:
                for S in LENGTHS:
                    for in_place in (False, True):
                        args = cs.random_scan(B, H, S, D, S + D + B * H, dev,
                                              views=in_place)
                        n += 1
                        bad += not check(fn, f"{label} B={B} H={H} S={S} "
                                         f"hd={D} in place {in_place}",
                                         args, in_place)
    for label, fn in designs()[2:]:
        for B, H in BH:
            for S in (1, 5, 33, 130):
                n += 1
                bad += not check(fn, f"{label} B={B} H={H} S={S}",
                                 cs.random_scan(B, H, S, 64, S + B, dev),
                                 True)
    print(f"held {n} cases, {bad} bad")

    for shape_label, (B, S) in (("prefill", (1, 3000)), ("decode", (8, 1))):
        args = cs.random_scan(B, 32, S, 64, S, dev)
        bound = cs.scan_bound(args[0])[0]
        for label, fn in designs():
            ms = cs.graph_ms(lambda: fn(*args), repeats=20 if S > 1 else 100,
                             samples=5 if S > 1 else 21)
            print(f"TIME {shape_label} {label}: {ms:.6f} ms, bound "
                  f"{bound:.6f}, {bound / ms:.4f} of it")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
