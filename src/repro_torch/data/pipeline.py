"""Deterministic, resumable, host-sharded token pipeline (the port's own
copy of ``repro.data.pipeline``: the same numpy counter-mode generator,
so its batches equal the JAX package's bit for bit; they are numpy
arrays, and the launcher moves them to the device).

Batches are a pure function of (seed, step, host_index) — a counter-mode
hash of the global step, so:

  * resume after failure = set the step counter (no iterator state to
    checkpoint beyond one integer),
  * elastic rescale = each host slices its rows of the same global batch
    (changing host counts never changes the data a given step sees),
  * straggler-free: there is no shared queue to contend on — the data
    plane follows the paper's P2 principle (every access statically
    planned ahead) so ingestion never serializes on coordination.

The generator is synthetic (hash-mixed tokens with a repeating-ngram
structure so cross-entropy is learnable); a real deployment swaps
``_tokens_for`` for an indexed corpus read with the same counter contract.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts

    def _tokens_for(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rows = np.arange(
            cfg.host_index * self.local_batch,
            (cfg.host_index + 1) * self.local_batch,
            dtype=np.uint64,
        )
        # counter-mode: mix (seed, step, row, col) through splitmix64
        cols = np.arange(cfg.seq_len + 1, dtype=np.uint64)
        seed_mix = np.uint64((cfg.seed * 0x9E3779B97F4A7C15) % (1 << 64))
        with np.errstate(over="ignore"):
            x = (
                seed_mix
                + (np.uint64(step) << np.uint64(20))
                + (rows[:, None] << np.uint64(40))
                + cols[None, :]
            )
        z = x
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        toks = (z % np.uint64(cfg.vocab_size)).astype(np.int32)
        # learnable structure: every 4th token repeats its predecessor
        toks[:, 3::4] = toks[:, 2::4]
        return toks

    def batch(self, step: int) -> dict:
        toks = self._tokens_for(step)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def state(self, step: int) -> dict:
        return {"step": step, "seed": self.cfg.seed}
