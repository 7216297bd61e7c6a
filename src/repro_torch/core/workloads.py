"""Workload generators for the ORTHRUS engine (paper §4 + Appendix A).

All generation is host-side numpy with deterministic seeds; the engine
consumes fixed arrays (the paper runs one-shot stored procedures — the full
transaction is known at submission, which is what makes planned data access
possible).

Emitted arrays (N = num_txns, K = max lock ops per txn):
  keys   int32[N, K]  record ids to lock, in *acquisition order* for dynamic
                      protocols (contended records first, as in the paper's
                      high-contention experiments); KEY_SENTINEL pads.
  modes  int32[N, K]  0 = read lock, 1 = write lock.
  nkeys  int32[N]     lock ops per txn.
  part   int32[N, K]  partition-relevant id per key (YCSB: the key itself;
                      TPC-C: the warehouse id — the paper partitions CC
                      threads by warehouse_id).
  exec_ops int32[N]   executable ops (>= nkeys when some reads need no lock,
                      e.g. TPC-C Item reads).
  ollp   bool[N]      txn needs OLLP reconnaissance (read/write set is
                      data-dependent: Payment customer-by-last-name).
  ollp_miss bool[N]   the OLLP access estimate will be wrong on the first
                      attempt (forces abort + corrected retry).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lockgrant import KEY_SENTINEL

MODE_READ = 0
MODE_WRITE = 1


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    kind: str = "ycsb"  # 'ycsb' | 'tpcc'
    num_txns: int = 1 << 15
    seed: int = 0
    # Batch-epoch size for batch-planned protocols (dgcc / quecc): how many
    # transactions the planner groups into one dependency-graph / queue
    # batch. Larger epochs amortize planning and widen wavefronts but add
    # batching latency.
    batch_epoch: int = 512

    # --- YCSB (Appendix A): 10M x 1KB records, 10 ops/txn ---
    num_records: int = 10_000_000
    ops_per_txn: int = 10
    num_hot: int = 64  # hot-set size; 0 = uniform (low contention)
    hot_per_txn: int = 2
    read_only: bool = False
    # Partition placement (Appendix A): None = unconstrained ('random'),
    # 1 = 'single partition', 2 = 'dual partition', k = k partitions.
    partitions_per_txn: int | None = None
    num_partitions: int = 16
    # Fig 7: fraction of txns forced multi-partition; the rest are
    # single-partition. None disables the mix. ``multipart_span`` sets
    # how many partitions the multi-partition txns touch (default 2, as
    # in the paper's dual-partition placement) — the knob the
    # fragment-granular batch engine is measured against: each spanned
    # partition becomes an independently schedulable fragment.
    multipart_frac: float | None = None
    multipart_span: int = 2

    # --- TPC-C (paper §4.4): NewOrder + Payment 50/50 ---
    num_warehouses: int = 16
    districts_per_wh: int = 10
    customers_per_district: int = 3000
    stock_per_wh: int = 100_000
    remote_payment_frac: float = 0.15
    remote_item_prob: float = 0.01  # per NewOrder item => ~10% remote txns
    payment_by_name_frac: float = 0.60
    ollp_miss_prob: float = 0.01


@dataclasses.dataclass
class Workload:
    cfg: WorkloadConfig
    keys: np.ndarray
    modes: np.ndarray
    nkeys: np.ndarray
    part: np.ndarray
    exec_ops: np.ndarray
    ollp: np.ndarray
    ollp_miss: np.ndarray
    num_records: int

    @property
    def max_keys(self) -> int:
        return self.keys.shape[1]


def epoch_arrival_schedule(
    pattern: str,
    interval_rounds: int,
    period_epochs: int,
    burst_on_epochs: int = 0,
) -> tuple[np.ndarray, int]:
    """Deterministic arrival rounds of one period's epochs under a bursty
    arrival process (the engine's open-arrival schedules; consumed by
    ``engine.plan_device`` and stamped into per-txn arrival rounds so
    event leaping wakes exactly at bursts).

    Returns ``(sched, period_rounds)``: ``sched[e]`` is the arrival
    round of epoch ``e`` within one period of ``period_epochs`` epochs,
    monotone non-decreasing with ``sched[0] == 0``; the pattern repeats
    every ``period_rounds`` rounds. Every pattern offers the same
    average load as a uniform arrival at ``interval_rounds`` — only the
    shape changes:

      * ``uniform`` — epoch ``e`` at ``e * interval`` (the fixed-rate
        reference; the engine keeps its closed form for this case).
      * ``burst`` — on/off: all ``period_epochs`` epochs arrive inside
        the first ``burst_on_epochs`` intervals of the period, then
        silence until the period ends.
      * ``diurnal`` — square wave: the first half of the period's
        epochs arrive at double rate (``interval // 2`` spacing), the
        second half at the complementary low rate.

    >>> sched, per = epoch_arrival_schedule("uniform", 10, 4)
    >>> sched.tolist(), per
    ([0, 10, 20, 30], 40)
    >>> sched, per = epoch_arrival_schedule("burst", 10, 4, burst_on_epochs=2)
    >>> sched.tolist(), per
    ([0, 0, 10, 10], 40)
    >>> sched, per = epoch_arrival_schedule("diurnal", 10, 6)
    >>> sched.tolist(), per
    ([0, 5, 10, 15, 30, 45], 60)
    """
    iv = int(interval_rounds)
    P = int(period_epochs)
    assert iv > 0 and P > 0, (interval_rounds, period_epochs)
    period = P * iv
    if pattern == "uniform":
        sched = np.arange(P, dtype=np.int64) * iv
    elif pattern == "burst":
        on = int(burst_on_epochs)
        assert 0 < on <= P, (burst_on_epochs, period_epochs)
        # P epochs spread uniformly over the first `on` intervals
        sched = (np.arange(P, dtype=np.int64) * on // P) * iv
    elif pattern == "diurnal":
        h1 = P - P // 2  # fast half (ceil)
        h2 = P // 2
        fast = np.arange(h1, dtype=np.int64) * (iv // 2)
        start = h1 * (iv // 2)
        spacing2 = (period - start) // max(h2, 1)
        slow = start + np.arange(h2, dtype=np.int64) * spacing2
        sched = np.concatenate([fast, slow])
    else:
        raise ValueError(f"unknown arrival pattern: {pattern}")
    assert (np.diff(sched) >= 0).all() and sched[0] == 0
    assert sched[-1] < period
    return sched, period


def make_workload(cfg: WorkloadConfig) -> Workload:
    if cfg.kind == "ycsb":
        return ycsb_workload(cfg)
    if cfg.kind == "tpcc":
        return tpcc_workload(cfg)
    raise ValueError(f"unknown workload kind: {cfg.kind}")


# --------------------------------------------------------------------------
# YCSB
# --------------------------------------------------------------------------
def ycsb_workload(cfg: WorkloadConfig) -> Workload:
    rng = np.random.default_rng(cfg.seed)
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
    return Workload(
        cfg=cfg,
        keys=keys,
        modes=modes,
        nkeys=nkeys,
        part=part,
        exec_ops=np.full(n, k, np.int32),
        ollp=np.zeros(n, bool),
        ollp_miss=np.zeros(n, bool),
        num_records=cfg.num_records,
    )


# --------------------------------------------------------------------------
# TPC-C (NewOrder + Payment, 50/50)
# --------------------------------------------------------------------------
def tpcc_layout(cfg: WorkloadConfig):
    """Key-space layout rooted at the Warehouse table."""
    W, D, C, S = (
        cfg.num_warehouses,
        cfg.districts_per_wh,
        cfg.customers_per_district,
        cfg.stock_per_wh,
    )
    wh_base = 0
    di_base = W
    cu_base = di_base + W * D
    st_base = cu_base + W * D * C
    total = st_base + W * S
    return wh_base, di_base, cu_base, st_base, total


def tpcc_workload(cfg: WorkloadConfig) -> Workload:
    rng = np.random.default_rng(cfg.seed)
    n = cfg.num_txns
    W, D, C, S = (
        cfg.num_warehouses,
        cfg.districts_per_wh,
        cfg.customers_per_district,
        cfg.stock_per_wh,
    )
    wh_base, di_base, cu_base, st_base, total = tpcc_layout(cfg)

    K = 12  # NewOrder: 1 wh read + 1 district write + 10 stock writes
    keys = np.full((n, K), int(KEY_SENTINEL), np.int64)
    modes = np.zeros((n, K), np.int32)
    part = np.zeros((n, K), np.int32)  # warehouse id per key
    nkeys = np.zeros(n, np.int32)
    exec_ops = np.zeros(n, np.int32)
    ollp = np.zeros(n, bool)
    ollp_miss = np.zeros(n, bool)

    is_payment = rng.random(n) < 0.5
    w = rng.integers(0, W, size=n)
    d = rng.integers(0, D, size=n)

    # ---- Payment: W(write, HOT), D(write), C(write; 15% remote wh) ----
    pay = np.where(is_payment)[0]
    npay = len(pay)
    cw = w[pay].copy()
    remote = rng.random(npay) < cfg.remote_payment_frac
    if W > 1:
        cw_r = rng.integers(0, W, size=npay)
        # remote customer warehouse must differ from home warehouse
        for _ in range(8):
            clash = remote & (cw_r == w[pay])
            if not clash.any():
                break
            cw_r = np.where(clash, rng.integers(0, W, size=npay), cw_r)
        cw = np.where(remote, cw_r, cw)
    cd = rng.integers(0, D, size=npay)
    cc = rng.integers(0, C, size=npay)
    keys[pay, 0] = wh_base + w[pay]
    keys[pay, 1] = di_base + w[pay] * D + d[pay]
    keys[pay, 2] = cu_base + (cw * D + cd) * C + cc
    modes[pay, 0:3] = MODE_WRITE
    part[pay, 0] = w[pay]
    part[pay, 1] = w[pay]
    part[pay, 2] = cw
    nkeys[pay] = 3
    exec_ops[pay] = 3
    byname = rng.random(npay) < cfg.payment_by_name_frac
    ollp[pay] = byname
    ollp_miss[pay] = byname & (rng.random(npay) < cfg.ollp_miss_prob)

    # ---- NewOrder: W(read), D(write, next_o_id), 10x Stock(write) ----
    new = np.where(~is_payment)[0]
    nnew = len(new)
    keys[new, 0] = wh_base + w[new]
    modes[new, 0] = MODE_READ
    part[new, 0] = w[new]
    keys[new, 1] = di_base + w[new] * D + d[new]
    modes[new, 1] = MODE_WRITE
    part[new, 1] = w[new]
    items = 10
    sw = np.repeat(w[new][:, None], items, axis=1)
    if W > 1:
        rem = rng.random((nnew, items)) < cfg.remote_item_prob
        sw_r = rng.integers(0, W, size=(nnew, items))
        for _ in range(8):
            clash = rem & (sw_r == sw)
            if not clash.any():
                break
            sw_r = np.where(clash, rng.integers(0, W, size=(nnew, items)), sw_r)
        sw = np.where(rem, sw_r, sw)
    si = rng.integers(0, S, size=(nnew, items))
    keys[new, 2 : 2 + items] = st_base + sw * S + si
    modes[new, 2 : 2 + items] = MODE_WRITE
    part[new, 2 : 2 + items] = sw
    nkeys[new] = 2 + items
    # +10 Item reads execute without locks (read-only table, paper §4.4)
    exec_ops[new] = 2 + items + items

    return Workload(
        cfg=cfg,
        keys=keys.astype(np.int32),
        modes=modes,
        nkeys=nkeys,
        part=part.astype(np.int32),
        exec_ops=exec_ops,
        ollp=ollp,
        ollp_miss=ollp_miss,
        num_records=int(total),
    )
