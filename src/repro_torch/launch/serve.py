"""Serving launcher: planned continuous batching over one model.

  PYTHONPATH=src python -m repro_torch.launch.serve              # smoke, GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b

``--arch`` takes every arch of the JAX package. ``--smoke`` (the
default) runs the arch's reduced config, ``--no-smoke`` its full
published config, after checking that its weights and the serving cache
(``--slots`` x ``--cache-len``) fit the card's free memory
(mixtral-8x22b's 281 GB and llama4-maverick's 795 GB do not: one card
serves them cut in depth, as ``chip_smoke.py`` does). Weights are
random, from ``--seed``, and so are the prompts (4-16 tokens, as the JAX
launcher's) and, for llama-3.2-vision, llama4-maverick and whisper, the
stub frontends' outputs that every prefill takes (``vision_embeds``,
llama4's early-fusion prefix, ``audio_frames``; the JAX launcher passes
none, so its early-fusion prefix is never fused and the other two archs
fail there).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs import (
    ModelConfig,
    get_config,
    get_smoke_config,
    list_archs,
)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_dispatch import ops as md_ops
from repro_torch.kernels.rwkv6_scan import ops as rw_ops
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeConfig, ServingEngine


def check_fits(cfg: ModelConfig, free_bytes: int, slots: int = 0,
               cache_len: int = 0) -> None:
    """Raise before allocating if ``cfg``'s weights and a serving cache of
    ``slots`` x ``cache_len`` exceed ``free_bytes`` of device memory."""
    weights = cfg.param_count() * getattr(torch, cfg.dtype).itemsize
    cache = 0
    if slots:
        spec = M.cache_spec(cfg, slots, cache_len)
        cache = sum(math.prod(shape) * dtype.itemsize
                    for entry in spec["layers"]
                    for shape, dtype in entry.values())
    if weights + cache > free_bytes:
        raise RuntimeError(
            f"{cfg.name}: {weights / 1e9:.1f} GB of {cfg.dtype} weights and "
            f"{cache / 1e9:.1f} GB of cache, {free_bytes / 1e9:.1f} GB free "
            f"on the card: one card cannot hold it; serving it whole comes "
            f"with the four-card distribution slice (ROADMAP Queue 1, item "
            f"11)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=list_archs())
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if torch.device(args.device).type == "cuda":
        check_fits(cfg, torch.cuda.mem_get_info(args.device)[0], args.slots,
                   args.cache_len)
    params = M.init_params(cfg, args.seed, args.device)
    engine = ServingEngine(
        cfg,
        ServeConfig(batch_slots=args.slots, cache_len=args.cache_len),
        params, device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(
                2, cfg.vocab_size, size=rng.integers(4, 17)
            ).astype(np.int32),
            max_new_tokens=args.max_new,
        )
        for i in range(args.requests)
    ]
    extras = M.random_extras(cfg, 1, args.seed, args.device)
    fa_ops.launches = rw_ops.launches = md_ops.launches = 0
    t0 = time.perf_counter()
    done = engine.run(reqs, extras)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt {len(r.prompt)} -> {len(r.output)} tokens")
    st = engine.stats
    print(f"{len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total/max(dt,1e-9):.1f} tok/s) on {args.device}")
    print(f"prefill {st['prefill_s'] / max(st['prefills'], 1) * 1e3:.3f} ms "
          f"per request ({st['prefills']}), decode "
          f"{st['decode_s'] / max(st['decode_steps'], 1) * 1e3:.3f} ms per "
          f"step ({st['decode_steps']}), flash_attention launches "
          f"{fa_ops.launches}, rwkv6_scan launches {rw_ops.launches}, "
          f"moe_dispatch launches {md_ops.launches}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
