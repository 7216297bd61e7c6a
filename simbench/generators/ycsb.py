"""The YCSB workload generator (paper Appendix A), frozen here so that the
benchmark draws its inputs itself and hands the same arrays to the port
and to the reference.

A copy of the port's ``repro_torch.core.workloads.ycsb_workload`` and the
YCSB fields of its ``WorkloadConfig``. Each transaction runs
``ops_per_txn`` operations on records drawn from ``num_records``;
``hot_per_txn`` of them (drawn first, distinct within a transaction) on
the hot set, records ``0 .. num_hot - 1``, the rest uniformly on the
others. Arrays (N transactions, K operations): ``keys`` int32[N, K] in
acquisition order, hot records first; ``modes`` int32[N, K] (0 read, 1
write); ``nkeys`` int32[N]; ``part`` int32[N, K] (key modulo
``num_partitions``); ``exec_ops`` int32[N]; ``ollp`` and ``ollp_miss``
bool[N] (no reconnaissance in YCSB).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MODE_READ = 0
MODE_WRITE = 1


@dataclasses.dataclass(frozen=True)
class YcsbConfig:
    num_txns: int = 1 << 15
    num_records: int = 10_000_000
    ops_per_txn: int = 10
    num_hot: int = 64  # hot-set size; 0 = uniform (low contention)
    hot_per_txn: int = 2
    read_only: bool = False
    # Partition placement: None = unconstrained, k = k partitions a txn.
    partitions_per_txn: int | None = None
    num_partitions: int = 16
    # Fraction of txns forced multi-partition (None disables the mix),
    # each spanning ``multipart_span`` partitions.
    multipart_frac: float | None = None
    multipart_span: int = 2


def generate(cfg: YcsbConfig, seed: int) -> dict:
    """The workload of ``cfg`` drawn from ``seed``: a dict of the arrays
    of the module docstring and ``num_records``."""
    rng = np.random.default_rng(seed)
    n, k = cfg.num_txns, cfg.ops_per_txn
    nh = min(cfg.num_hot, cfg.num_records) if cfg.num_hot else 0
    n_hot_ops = min(cfg.hot_per_txn, k) if nh > 0 else 0
    n_cold_ops = k - n_hot_ops

    # Choose the partition set per txn (partition of key x is x % P).
    P = cfg.num_partitions
    if cfg.multipart_frac is not None:
        span = max(min(cfg.multipart_span, P), 1)
        ppt = np.where(rng.random(n) < cfg.multipart_frac, span, 1)
    elif cfg.partitions_per_txn is not None:
        ppt = np.full(n, cfg.partitions_per_txn, np.int64)
    else:
        ppt = None  # unconstrained

    def draw_in_partitions(count: int, lo: int, hi: int, parts: np.ndarray):
        """Draw `count` keys per txn from [lo, hi), key % P in txn's parts."""
        # parts: [n, max_ppt] with -1 padding; assign op j to parts[j % ppt].
        j = np.arange(count)[None, :]
        pidx = j % ppt[:, None]
        p = np.take_along_axis(parts, pidx, axis=1)
        span = (hi - lo + P - 1) // P
        x = rng.integers(0, span, size=(n, count))
        keys = lo + x * P + ((p - lo) % P)
        # wrap overflow back into range (rare edge at the top of the range)
        keys = np.where(keys >= hi, lo + ((keys - lo) % max(hi - lo, 1)), keys)
        return keys

    if ppt is not None:
        max_ppt = int(ppt.max())
        parts = np.full((n, max_ppt), -1, np.int64)
        for i_p in range(max_ppt):
            need = ppt > i_p
            draw = rng.integers(0, P, size=n)
            if i_p > 0:  # distinct partitions within a txn
                prev = parts[:, :i_p]
                for _ in range(8):
                    clash = (draw[:, None] == prev).any(axis=1)
                    if not clash.any():
                        break
                    draw = np.where(clash, rng.integers(0, P, size=n), draw)
            parts[:, i_p] = np.where(need, draw, parts[:, i_p])
        hot = (
            draw_in_partitions(n_hot_ops, 0, nh, parts)
            if n_hot_ops
            else np.zeros((n, 0), np.int64)
        )
        cold = draw_in_partitions(n_cold_ops, max(nh, 1), cfg.num_records, parts)
    else:
        if n_hot_ops:
            if nh >= 2:
                a = rng.integers(0, nh, size=(n, n_hot_ops))
                # make hot picks within a txn distinct
                for _ in range(8):
                    dup = a[:, 0] == a[:, 1] if n_hot_ops >= 2 else np.zeros(n, bool)
                    if not dup.any():
                        break
                    a[dup, 1] = rng.integers(0, nh, size=int(dup.sum()))
                hot = a
            else:
                hot = np.zeros((n, n_hot_ops), np.int64)
        else:
            hot = np.zeros((n, 0), np.int64)
        cold = rng.integers(max(nh, 1), cfg.num_records, size=(n, n_cold_ops))

    # Hot records first: the paper acquires hot locks before cold ones.
    keys = np.concatenate([hot, cold], axis=1).astype(np.int32)
    modes = np.full((n, k), MODE_READ if cfg.read_only else MODE_WRITE, np.int32)
    nkeys = np.full(n, k, np.int32)
    part = (keys % P).astype(np.int32)
    return dict(
        keys=keys,
        modes=modes,
        nkeys=nkeys,
        part=part,
        exec_ops=np.full(n, k, np.int32),
        ollp=np.zeros(n, bool),
        ollp_miss=np.zeros(n, bool),
        num_records=cfg.num_records,
    )


def make(params: dict, seed: int) -> dict:
    """The generator's entry for the harness: ``params`` are
    :class:`YcsbConfig`'s fields."""
    return generate(YcsbConfig(**params), seed)
