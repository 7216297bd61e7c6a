"""Serve a small model with batched requests through the PyTorch port's
planned continuous-batching engine (P1 planner/executor split + P2 slot
planning).

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

The port's counterpart of examples/serve_lm.py, on the CUDA card unless
``--device cpu`` is given (without a card the default raises). On the
card each MoE layer plans its dispatch with kernel B3 (moe_dispatch) in
every prefill and decode step, and each prefill's attention is kernel B4
(flash_attention).
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeConfig, ServingEngine

ARCH = "mixtral-8x22b"  # MoE serving, planned dispatch
SERVE = ServeConfig(batch_slots=4, cache_len=96)
N_REQUESTS, MAX_NEW = 10, 12


def make_requests(cfg, n: int = N_REQUESTS, seed: int = 7) -> list:
    """``n`` requests of 4-19 random prompt tokens (numpy, ``seed``) and
    MAX_NEW new tokens each."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            rid=i,
            prompt=rng.integers(2, cfg.vocab_size,
                                size=int(rng.integers(4, 20)))
            .astype(np.int32),
            max_new_tokens=MAX_NEW,
        )
        for i in range(n)
    ]


def serve(cfg, params, device, requests, kernel_impl: str = "auto") -> tuple:
    """Serve ``requests`` through SERVE's slots and print each one and the
    summary. Returns the finished requests and the engine's ``stats``."""
    engine = ServingEngine(cfg, SERVE, params, device=device,
                           kernel_impl=kernel_impl)
    t0 = time.time()
    done = engine.run(requests)
    dt = time.time() - t0
    total = sum(len(r.output) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid:2d}: prompt {len(r.prompt):2d} tokens -> "
              f"{len(r.output):2d} generated")
    print(f"\n{len(done)} requests, {total} tokens, {dt:.1f}s "
          f"({total/max(dt, 1e-9):.1f} tok/s) — "
          f"{len(requests)} requests through {SERVE.batch_slots} slots: "
          f"continuous batching with planned admission")
    return done, engine.stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(ARCH)
    params = M.init_params(cfg, 0, device)
    done, _ = serve(cfg, params, device, make_requests(cfg))
    assert len(done) == N_REQUESTS
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
