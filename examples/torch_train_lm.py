"""End-to-end training on the PyTorch port: train a reduced gemma3 for a
few hundred steps on the deterministic pipeline, with checkpoint/restart
in the middle to demonstrate exactly-once recovery.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

The port's counterpart of examples/train_lm.py, on the CUDA card unless
``--device cpu`` is given (without a card the default raises). On the
card each self-attention layer runs kernel B4 (flash_attention) twice a
step, in the forward and in its remat recompute; its backward is the
plain version's.
"""

import argparse
import shutil
import tempfile

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.engine import resolve_device
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.train import build_trainer

CKPT_INTERVAL = 50


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def train(args, *, interval: int = CKPT_INTERVAL, mcfg=None, state=None,
          checkpointer=Checkpointer) -> dict:
    """Train ``args.steps`` steps on ``args.device``, checkpointing every
    ``interval`` steps, and at step ``args.steps // 2`` drop the live
    state and resume from the latest checkpoint. ``mcfg`` replaces the
    arch's SMOKE config, ``state`` the fresh initial state, and
    ``checkpointer`` the checkpoint manager's class. Returns the first
    and last losses, every loss and the step resumed from."""
    device = resolve_device(args.device)
    mesh = make_mesh_for(device, data=1, model=1)
    cfg, init, run_step, device = build_trainer(
        args.arch, mesh, smoke=True, batch=args.batch, seq=args.seq,
        lr=3e-3, mcfg=mcfg, device=device)
    pipe = TokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size, global_batch=args.batch,
                   seq_len=args.seq)
    )
    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_")
    ckpt = checkpointer(ckpt_dir, interval=interval)

    state = init() if state is None else state
    losses, found = [], None
    for step in range(args.steps):
        state, m = run_step(state, pipe.batch(step))
        losses.append(float(m["loss"]))
        ckpt.maybe_save(step, state)
        if step % 20 == 0:
            print(f"step {step:4d} loss {losses[-1]:.4f}")
        if step == args.steps // 2:
            # simulate a crash + restart from the latest checkpoint
            ckpt.wait()
            found, restored = ckpt.restore_latest(state, device)
            if found is not None:
                state = restored
                print(f"-- simulated failure; resumed from step {found} --")
    ckpt.wait()
    first, last = losses[0], losses[-1]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(first=first, last=last, losses=losses, resumed_from=found)


def main(argv=None) -> int:
    out = train(parse_args(argv))
    assert out["last"] < out["first"], (
        "training should reduce loss on the synthetic data")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
