"""The plain reference engine: the round step of every lock-table
protocol and of the batch-planned ``dgcc`` in its pre-packed form.

A frozen copy of the port's ``repro_torch.core.engine_legacy`` (the
per-slot [T] / [T, K] state the engine used before its packed [T, F]
rewrite, the plain sorted grant and the dense wavefront check) and of
the plain grant primitives of ``repro_torch.core.lockgrant``. It runs
no hand-written kernel and imports nothing of the port, so it can
judge the port's packed engine, its CUDA kernels B1 and B2 and its
host loop. Two additions over the frozen step: each slot carries the
round its transaction was admitted (``arrive``) and every commit adds
its latency to the log-bucketed histogram ``lat_hist``, as the packed
engine's metrics layer does under closed-loop admission.

Do not optimize or refactor this module: its value is that it does not
change with the program it judges.
"""

from __future__ import annotations

import dataclasses

import torch

I32 = torch.int32

MODE_READ = 0
MODE_WRITE = 1

REQ_READ = 0
REQ_WRITE = 1
REQ_RELEASE = 2
REQ_NONE = 3  # inactive slot (padding)

KEY_SENTINEL = 2**31 - 1
I32_MIN = -(2**31)
I32_MAX = 2**31 - 1
_IMAX = I32_MAX

# Phases
EMPTY, INIT, ACQ, MSG, READY, EXEC, REL, BACKOFF = range(8)
# Sharer-heat epoch length (rounds) for the coherence model.
EPOCH_BITS = 12
# Lane-time categories (paper Fig 10 breakdown)
CAT_IDLE, CAT_EXEC, CAT_LOCK, CAT_WAIT, CAT_DL, CAT_MSG = range(6)
NCAT = 6
# Log buckets of the commit-latency histogram: bucket b holds the
# latencies with b powers of two (1, 2, 4, ...) at or below them.
LAT_BUCKETS = 24


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Cycle costs of the simulated multicore machine (the
    configuration file's ``cost`` block)."""

    cycles_per_round: int = 500
    clock_ghz: float = 2.0
    lock_op_cycles: int = 500
    coherence_cycles_per_sharer: int = 300
    waitdie_check_cycles: int = 100
    waitfor_maintain_cycles: int = 200
    dreadlocks_spin_cycles: int = 300
    abort_backoff_rounds: int = 4
    msg_hop_cycles: int = 500
    cc_op_cycles: int = 150
    batch_plan_cycles_per_op: int = 100
    dep_check_cycles: int = 40
    exec_op_cycles: int = 1200
    txn_fixed_cycles: int = 1500
    recon_cycles: int = 1500
    partition_lock_cycles: int = 150
    shared_index_penalty_cycles: int = 600

    def rounds(self, cycles):
        return (cycles + self.cycles_per_round - 1) // self.cycles_per_round

    @property
    def round_seconds(self) -> float:
        return self.cycles_per_round / (self.clock_ghz * 1e9)

    @property
    def cc_keys_per_round(self) -> int:
        return max(1, self.cycles_per_round // self.cc_op_cycles)

    @property
    def msg_hop_rounds(self) -> int:
        return int(self.rounds(self.msg_hop_cycles))


@dataclasses.dataclass(frozen=True)
class Config:
    """What the step and the host loop read of a configuration."""

    protocol: str
    n_exec: int
    n_cc: int = 0
    window: int = 1
    split_index: bool = False
    event_leap: bool = True
    max_rounds: int = 60_000
    warmup_rounds: int = 4_000
    chunk_rounds: int = 4_000
    target_commits: int = 50_000
    cost: CostModel = CostModel()

    @property
    def n_slots(self) -> int:
        return self.n_exec * self.window

    @property
    def is_orthrus(self) -> bool:
        return self.protocol == "orthrus"

    @property
    def is_batch_planned(self) -> bool:
        return self.protocol in ("dgcc", "quecc", "scheduled")

    @property
    def is_dynamic_2pl(self) -> bool:
        return self.protocol.startswith("twopl")

    @property
    def deadlock_scheme(self) -> str:
        return {
            "twopl_waitdie": "waitdie",
            "twopl_waitfor": "waitfor",
            "twopl_dreadlocks": "dreadlocks",
        }.get(self.protocol, "none")


@dataclasses.dataclass(frozen=True)
class Meta:
    """Shapes of a plan."""

    n_txns: int
    max_keys: int
    num_records: int
    lane_cols: int = 0
    num_batches: int = 0


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for an int index tensor of any shape, 0-d included."""
    return x.index_select(0, i.reshape(-1)).reshape(i.shape)


def lex_order(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Indices sorting by (primary, secondary), both int32, stable.

    One stable sort on the packed int64 ``(primary << 32) |
    (secondary - INT32_MIN)``: the same permutation as a two-key stable
    sort (ties in both keys keep their original order).
    """
    packed = (primary.to(torch.int64) << 32) | (
        secondary.to(torch.int64) - I32_MIN
    )
    return torch.sort(packed, stable=True).indices


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation via scatter (no second sort)."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return inv


def segment_starts(keys: torch.Tensor) -> torch.Tensor:
    """bool[N]: entry i opens a run of equal keys (entry 0 always does)."""
    start = torch.ones_like(keys, dtype=torch.bool)
    start[1:] = keys[1:] != keys[:-1]
    return start


def seg_cumsum(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented int32 cumsum of ``x`` along the sorted order
    (``seg_start[0]`` must be True)."""
    total = torch.cumsum(x, 0, dtype=torch.int32)
    base = torch.cummax(
        torch.where(seg_start, total - x, I32_MIN), 0
    ).values
    return total - base


def sorted_grant(keys, kind, wh_free, rc):
    """bool[N] grant decisions over requests sorted by (key, ts): the
    grant output of ``segmented_grant`` alone, without segment totals."""
    active = kind != REQ_NONE
    is_write_req = kind == REQ_WRITE
    is_read_req = kind == REQ_READ
    seg_start = segment_starts(keys) | ~active
    req_pos_incl = seg_cumsum((is_write_req | is_read_req).to(torch.int32),
                              seg_start)
    w_i32 = is_write_req.to(torch.int32)
    writes_before = seg_cumsum(w_i32, seg_start) - w_i32

    grant_read = is_read_req & wh_free & (writes_before == 0)
    grant_write = is_write_req & wh_free & (rc == 0) & (req_pos_incl == 1)
    return grant_read | grant_write


def segmented_grant(keys, ts, kind, wh_free, rc, weight=None):
    """Grant decisions over requests sorted by (key, ts).

    Args:
      keys:    int32[N] record ids, sorted ascending; KEY_SENTINEL = padding.
      ts:      int32[N] enqueue stamps, ascending within each key segment.
      kind:    int32[N] REQ_* entry kind.
      wh_free: bool[N]  per entry: record has no write holder.
      rc:      int32[N] per entry: record's current read-holder count.
      weight:  optional int32[N] per-entry weight to segment-sum.

    Returns (grant bool[N], contenders int32[N], wsum int32[N]).
    """
    del ts  # the order already encodes it
    grant = sorted_grant(keys, kind, wh_free, rc)
    active = kind != REQ_NONE
    seg_start = segment_starts(keys) | ~active
    seg_id = torch.cumsum(seg_start, 0, dtype=torch.int32) - 1

    contenders = _segment_broadcast_last(
        seg_cumsum(active.to(torch.int32), seg_start), seg_id
    )
    if weight is None:
        wsum = torch.zeros_like(contenders)
    else:
        wsum = _segment_broadcast_last(seg_cumsum(weight, seg_start), seg_id)
    return grant, torch.where(active, contenders, 0), wsum


def _segment_broadcast_last(inclusive, seg_id):
    """Broadcast each segment's last inclusive value to all its members."""
    n = inclusive.shape[0]
    last_of_seg = torch.ones_like(seg_id, dtype=torch.bool)
    last_of_seg[:-1] = seg_id[1:] != seg_id[:-1]
    idx = torch.where(last_of_seg, seg_id, n - 1).to(torch.int64)
    seg_last_val = torch.zeros_like(inclusive).scatter_reduce_(
        0, idx, torch.where(last_of_seg, inclusive, 0), "amax",
        include_self=True,
    )
    return seg_last_val[seg_id.to(torch.int64)]


def segment_sum_sorted(keys_sorted, weight_sorted):
    """Per-entry segment sum of ``weight_sorted`` over runs of equal
    ``keys_sorted`` (already sorted)."""
    seg_start = segment_starts(keys_sorted)
    seg_id = torch.cumsum(seg_start, 0, dtype=torch.int32) - 1
    return _segment_broadcast_last(
        seg_cumsum(weight_sorted, seg_start), seg_id
    )



def state0(cfg: Config, num_records: int, T: int, K: int,
            device: torch.device | str = "cuda") -> dict:
    """Initial round state, with the extra dropped-write row on every
    per-record array."""
    R = num_records
    dev = torch.device(device)

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    b = torch.bool
    # packed per-record cost-model state:
    #   heat[:, 0] = ep, heat[:, 1] = cnt_cur, heat[:, 2] = cnt_prev
    #   line[:, 0] = lnf (line-free round), line[:, 1] = last_lane
    heat = z(R + 1, 3)
    heat[:, 0] = -10
    line = z(R + 1, 2)
    line[:, 1] = -1
    return dict(
        r=z(),
        next_txn=z(),
        enq_ctr=torch.ones((), dtype=I32, device=dev),
        tid=full((T,), -1),
        widx=z(T),
        lane_ctr=z(T),
        ts=z(T),
        phase=z(T),
        committing=z(T, dtype=b),
        busy_until=z(T),
        busy_kind=z(T),
        kptr=z(T),
        attempt=z(T),
        want=z(T, K, dtype=b),
        granted=z(T, K, dtype=b),
        enq=z(T, K),
        adm_done=z(T, K, dtype=b),
        rel_done=z(T, K, dtype=b),
        ccptr=z(T),
        msg_arrive=z(T),
        msg_stage=z(T),
        release_at=z(T),
        waited=z(T, dtype=b),
        dl_debt=z(T),
        reach=z(T, T, dtype=b),
        wh=full((R + 1,), -1),
        rc=z(R + 1),
        heat=heat,
        line=line,
        commits=z(),
        aborts_dl=z(),
        aborts_ollp=z(),
        wasted=z(),
        cat=z(NCAT),
        steps=z(),
        arrive=z(T),
        lat_hist=z(LAT_BUCKETS),
    )


def make_step(cfg: Config, meta: Meta,
              device: torch.device | str = "cuda"):
    """Build the single-round transition for this config and plan shape.

    Returns ``step(p, s, r_end)``: ``p`` the plan tensors
    (``engine.plan_device``), ``s`` the round state, ``r_end`` the
    exclusive chunk bound (an int32 0-d tensor) that event leaps are
    clamped to. The step returns a new state dict and updates ``wh``,
    ``rc``, ``heat`` and ``line`` in place.
    """
    dev = torch.device(device)
    cm = cfg.cost
    T, K = cfg.n_slots, meta.max_keys
    R = meta.num_records
    N = meta.n_txns
    W = cfg.window
    n_cc = max(cfg.n_cc, 1)
    cap_keys = cm.cc_keys_per_round  # per CC lane per round, in key-ops
    has_lane_stream = meta.lane_cols > 0

    slot_ids = torch.arange(T, dtype=I32, device=dev)
    lane_of = slot_ids // W
    kk = torch.arange(K, dtype=I32, device=dev)
    holder = slot_ids[:, None].expand(T, K)
    ent_slot = holder.reshape(-1)
    lane2d = lane_of[:, None].expand(T, K)
    ent_iota = torch.arange(T * K, dtype=I32, device=dev)
    ones_tk = torch.ones(T * K, dtype=I32, device=dev)
    neg_ones_tk = torch.full((T * K,), -1, dtype=I32, device=dev)
    ones_t = torch.ones(T, dtype=I32, device=dev)
    ones_lanes = torch.ones(cfg.n_exec, dtype=I32, device=dev)
    own = torch.eye(T, dtype=torch.bool, device=dev)
    c = {v: torch.tensor(v, dtype=I32, device=dev)
         for v in (0, 1, EMPTY, INIT, ACQ, MSG, READY, EXEC, REL, BACKOFF,
                   CAT_IDLE, CAT_EXEC, CAT_LOCK, CAT_WAIT, CAT_DL, CAT_MSG,
                   REQ_READ, REQ_WRITE, REQ_RELEASE, REQ_NONE, KEY_SENTINEL,
                   I32_MIN, _IMAX, -1)}
    lat_pow2 = 2 ** torch.arange(LAT_BUCKETS - 1, dtype=I32, device=dev)

    lock_op_cycles = (
        cm.partition_lock_cycles
        if cfg.protocol == "partitioned_store"
        else cm.lock_op_cycles
    )
    # Shared-index cache penalty (paper §4.3): partitioned-store and SPLIT
    # variants probe thread-local indexes; everyone else shares one index.
    shared_index = cfg.protocol != "partitioned_store" and not cfg.split_index
    exec_cycles_per_op = cm.exec_op_cycles + (
        cm.shared_index_penalty_cycles if shared_index else 0
    )
    dl = cfg.deadlock_scheme
    dl_wait_cycles = {
        "waitfor": cm.waitfor_maintain_cycles,
        "dreadlocks": cm.dreadlocks_spin_cycles,
    }.get(dl, 0)

    def rounds_of(cyc):
        return (cyc + cm.cycles_per_round - 1) // cm.cycles_per_round

    def take(a, col):
        """jnp.take_along_axis(a, min(col, K - 1)[:, None], 1)[:, 0]."""
        return torch.gather(a, 1, torch.clamp(col, max=K - 1).long()[:, None]
                            ).squeeze(1)

    def lane_stream_at(lane_stream, lane_ctr):
        """lane_stream[slot_ids, lane_ctr % M]; slots past the stream's
        rows read its last row (the reference's gather clamps)."""
        rows = torch.clamp(slot_ids, max=lane_stream.shape[0] - 1).long()
        return lane_stream[rows, (lane_ctr % meta.lane_cols).long()]

    def lane_any(x):
        """jax.ops.segment_max of a bool [T] over the lanes (each lane is
        W consecutive slots)."""
        return x.view(cfg.n_exec, W).any(dim=1)

    def step(p, s, r_end):
        s = dict(s)
        r = s["r"]
        wkeys = p["keys"]
        wmodes = p["modes"]
        wpart = p["part"]
        wnkeys = p["nkeys"]
        wexec = p["exec_ops"]
        wollp = p["ollp"]
        wmiss = p["ollp_miss"]
        lane_stream = p["lane_stream"] if has_lane_stream else None

        def gather_txn():
            """Per-slot workload arrays for the currently-loaded txns."""
            widx = torch.where(s["tid"] >= 0, s["widx"] % N, c[0]).long()
            return (
                wkeys[widx],
                wmodes[widx],
                wpart[widx] % n_cc,
                wnkeys[widx],
                wexec[widx],
                wollp[widx],
                wmiss[widx],
            )

        free = s["busy_until"] <= r

        # ------------------------------------------------ 1. new admissions
        empty = s["phase"] == EMPTY
        if lane_stream is None:
            rank = torch.cumsum(empty, 0, dtype=I32) - 1
            new_tid = s["next_txn"] + rank
            adm = empty
            s["widx"] = torch.where(adm, new_tid % N, s["widx"])
            s["next_txn"] = s["next_txn"] + empty.sum(dtype=I32)
        else:
            # H-Store routing: each worker lane pulls the next txn homed to
            # its partition (lanes with no homed txns stay idle).
            widx = lane_stream_at(lane_stream, s["lane_ctr"])
            adm = empty & (widx >= 0)
            new_tid = s["lane_ctr"] * T + slot_ids
            s["widx"] = torch.where(adm, widx, s["widx"])
            s["lane_ctr"] = torch.where(adm, s["lane_ctr"] + 1, s["lane_ctr"])
            s["next_txn"] = s["next_txn"] + adm.sum(dtype=I32)
        s["tid"] = torch.where(adm, new_tid, s["tid"])
        s["arrive"] = torch.where(adm, r, s["arrive"])
        s["ts"] = torch.where(adm, new_tid, s["ts"])
        s["attempt"] = torch.where(adm, c[0], s["attempt"])
        # re-gather for freshly admitted slots
        keys, modes, ccids, nkeys, execops, ollp, miss = gather_txn()
        kvalid = kk[None, :] < nkeys[:, None]
        init_busy = rounds_of(
            cm.txn_fixed_cycles + torch.where(ollp, cm.recon_cycles, c[0])
        )
        s["phase"] = torch.where(adm, c[INIT], s["phase"])
        s["busy_until"] = torch.where(adm, r + init_busy, s["busy_until"])
        s["busy_kind"] = torch.where(adm, c[CAT_LOCK], s["busy_kind"])
        for f in ("want", "granted", "adm_done", "rel_done"):
            s[f] = s[f] & ~adm[:, None]
        s["kptr"] = torch.where(adm, c[0], s["kptr"])
        s["ccptr"] = torch.where(adm, c[0], s["ccptr"])
        s["waited"] = s["waited"] & ~adm

        # ------------------------------------------------ 2. backoff -> retry
        retry = (s["phase"] == BACKOFF) & free
        s["phase"] = torch.where(retry, c[INIT], s["phase"])
        s["busy_until"] = torch.where(
            retry, r + rounds_of(cm.txn_fixed_cycles), s["busy_until"]
        )
        s["busy_kind"] = torch.where(retry, c[CAT_LOCK], s["busy_kind"])
        for f in ("want", "granted", "adm_done", "rel_done"):
            s[f] = s[f] & ~retry[:, None]
        s["kptr"] = torch.where(retry, c[0], s["kptr"])
        s["ccptr"] = torch.where(retry, c[0], s["ccptr"])
        s["attempt"] = torch.where(retry, s["attempt"] + 1, s["attempt"])
        s["waited"] = s["waited"] & ~retry

        free = s["busy_until"] <= r

        # ------------------------------------------------ 3. INIT -> acquire
        start = (s["phase"] == INIT) & free & (s["tid"] >= 0)
        if cfg.is_orthrus:
            s["phase"] = torch.where(start, c[MSG], s["phase"])
            s["msg_stage"] = torch.where(start, c[0], s["msg_stage"])
            s["msg_arrive"] = torch.where(
                start, r + cm.msg_hop_rounds, s["msg_arrive"]
            )
        else:
            s["phase"] = torch.where(start, c[ACQ], s["phase"])

        # ------------------------------------------------ 4. ORTHRUS CC work
        if cfg.is_orthrus:
            # -- admission of acquire-messages and release-messages, bounded
            #    by each CC lane's per-round key-op capacity, in ts order.
            in_cur_group = (
                (kk[None, :] >= s["ccptr"][:, None])
                & kvalid
                & (ccids == take(ccids, s["ccptr"])[:, None])
            )
            acq_cand = (
                (s["phase"] == MSG)
                & (s["msg_stage"] == 0)
                & (s["msg_arrive"] <= r)
            )
            acq_keys = acq_cand[:, None] & in_cur_group & ~s["adm_done"]
            rel_cand = (s["phase"] == REL) & (s["release_at"] <= r)
            rel_keys = rel_cand[:, None] & s["granted"] & ~s["rel_done"]
            # Rank every active entry within its CC lane by (ts, key slot)
            # — the admission order — with a [T] slot sort plus per-CC
            # prefix counts.
            act2d = acq_keys | rel_keys  # [T, K]
            cc_act = torch.where(act2d, ccids, n_cc)
            cnt_tc = torch.zeros(T * (n_cc + 1), dtype=I32, device=dev)
            cnt_tc.index_add_(
                0, (holder * (n_cc + 1) + cc_act).reshape(-1), ones_tk
            )
            cnt_tc = cnt_tc.view(T, n_cc + 1)
            slot_order = torch.sort(s["ts"], stable=True).indices  # ts unique
            cnt_sorted = cnt_tc[slot_order]
            excl_sorted = torch.cumsum(cnt_sorted, 0, dtype=I32) - cnt_sorted
            excl = torch.zeros_like(excl_sorted)
            excl[slot_order] = excl_sorted
            base_rank = torch.gather(excl, 1, cc_act.long())
            same_cc_earlier = (
                (cc_act[:, :, None] == cc_act[:, None, :])
                & act2d[:, None, :]
                & (kk[None, None, :] < kk[None, :, None])
            )
            within = same_cc_earlier.sum(-1, dtype=I32)
            seg_pos2d = base_rank + within + 1  # 1-based within CC lane
            proc2d = (seg_pos2d <= cap_keys) & act2d
            s["adm_done"] = s["adm_done"] | (proc2d & acq_keys)
            # group fully admitted -> requests live in the CC's lock table
            grp_all = (s["adm_done"] | ~in_cur_group).all(dim=1)
            admit_now = acq_cand & grp_all
            new_want = admit_now[:, None] & in_cur_group
            s["phase"] = torch.where(admit_now, c[ACQ], s["phase"])
            # release processing
            do_rel = proc2d & rel_keys
            rel_k = torch.where(do_rel, keys, c[0])
            is_wr = do_rel & (modes == MODE_WRITE)
            s["wh"].index_fill_(
                0, torch.where(is_wr, rel_k, R).reshape(-1).long(), -1)
            is_rd = do_rel & (modes == MODE_READ)
            s["rc"].index_add_(
                0, torch.where(is_rd, rel_k, R).reshape(-1), neg_ones_tk)
            s["rel_done"] = s["rel_done"] | do_rel
            s["granted"] = s["granted"] & ~do_rel
        else:
            new_want = torch.zeros((T, K), dtype=torch.bool, device=dev)

        # ------------------------------------------------ 5. shared releases
        rel_entries = torch.zeros((T, K), dtype=torch.bool, device=dev)
        if not cfg.is_orthrus:
            rel_now = (s["phase"] == REL) & (s["release_at"] <= r)
            rel_entries = rel_now[:, None] & s["granted"]
            rel_k = torch.where(rel_entries, keys, c[0])
            is_wr = rel_entries & (modes == MODE_WRITE)
            s["wh"].index_fill_(
                0, torch.where(is_wr, rel_k, R).reshape(-1).long(), -1)
            is_rd = rel_entries & (modes == MODE_READ)
            s["rc"].index_add_(
                0, torch.where(is_rd, rel_k, R).reshape(-1), neg_ones_tk)
            s["granted"] = s["granted"] & ~rel_entries

        # ------------------------------------------------ 6. requests: want
        if cfg.is_orthrus:
            s["want"] = s["want"] | new_want
            want_new = new_want
        else:
            # 2PL/DF/pstore: single in-flight request at kptr when ACQ & free
            at_k = kk[None, :] == s["kptr"][:, None]
            need = (
                ((s["phase"] == ACQ) & free)[:, None]
                & at_k
                & kvalid
                & ~s["granted"]
                & ~s["want"]
            )
            want_new = need
            s["want"] = s["want"] | need

        # assign enqueue order stamps to new queue entries
        flat_new = want_new.reshape(-1)
        new_rank = torch.cumsum(flat_new, 0, dtype=I32) - 1
        enq_val = (s["enq_ctr"] + new_rank).view(T, K)
        s["enq"] = torch.where(want_new, enq_val, s["enq"])
        n_new = flat_new.sum(dtype=I32)

        # ------------------------------------------------ 7. grant pass
        # Requests are live only while their slot is acquiring.
        pend = s["want"] & ~s["granted"] & (s["phase"] == ACQ)[:, None]
        ent_kind = torch.where(
            pend,
            torch.where(modes == MODE_WRITE, c[REQ_WRITE], c[REQ_READ]),
            torch.where(rel_entries, c[REQ_RELEASE], c[REQ_NONE]),
        ).reshape(-1)
        ent_key = torch.where(
            pend | rel_entries, keys, c[KEY_SENTINEL]
        ).reshape(-1)
        rel_enq = (s["enq_ctr"] + n_new) + ent_iota
        ent_enq = torch.where(
            rel_entries, rel_enq.view(T, K), s["enq"]
        ).reshape(-1)
        s["enq_ctr"] = s["enq_ctr"] + n_new + rel_entries.sum(dtype=I32)

        safe = torch.clamp(ent_key, max=R - 1).long()
        in_rng = ent_key < R
        wh_ent = s["wh"][safe]
        wh_free = (wh_ent == -1) & in_rng
        rcv = torch.where(in_rng, s["rc"][safe], c[0])
        newop2d = want_new | rel_entries  # fresh lock-table ops this round
        order = lex_order(ent_key, ent_enq)
        inv = inverse_permutation(order)
        g_sorted, cont_sorted, new_sorted = segmented_grant(
            ent_key[order],
            ent_enq[order],
            ent_kind[order],
            wh_free[order],
            rcv[order],
            weight=newop2d.reshape(-1).to(I32)[order],
        )
        grant = g_sorted[inv].view(T, K)
        # re-entrant grants bypass the FIFO: a slot re-requesting a key it
        # already write-holds is granted immediately
        self_grant = (
            (ent_kind != REQ_NONE)
            & (ent_kind != REQ_RELEASE)
            & in_rng
            & (wh_ent == ent_slot)
        )
        grant = grant | self_grant.view(T, K)
        contend = cont_sorted[inv].view(T, K)
        new_in_seg = new_sorted[inv].view(T, K)

        # apply grants to the lock table
        gk = torch.where(grant, keys, c[0])
        g_wr = grant & (modes == MODE_WRITE)
        g_rd = grant & (modes == MODE_READ)
        s["wh"][torch.where(g_wr, gk, R).reshape(-1).long()] = ent_slot
        s["rc"].index_add_(
            0, torch.where(g_rd, gk, R).reshape(-1), ones_tk)
        s["granted"] = s["granted"] | grant

        # ------------------------------------------------ 8. deadlock logic
        # (runs before cost charging so a wait-die "die" probe — a read of
        # the holder's timestamp — costs latency but does not occupy the
        # record's meta-data line the way a queue mutation does)
        abort_dl = torch.zeros(T, dtype=torch.bool, device=dev)
        if dl != "none":
            waitkey = torch.where(
                (s["phase"] == ACQ)
                & take(s["want"] & ~s["granted"], s["kptr"]),
                take(keys, s["kptr"]),
                c[KEY_SENTINEL],
            )
            waiting = waitkey != KEY_SENTINEL
            mymode = take(modes, s["kptr"])
            # adj[t,u]: t waits on a lock u holds in a conflicting mode
            key_eq = keys[None, :, :] == waitkey[:, None, None]  # [t,u,k]
            conflict = (mymode[:, None, None] == MODE_WRITE) | (
                modes[None, :, :] == MODE_WRITE
            )
            adj = (
                (key_eq & s["granted"][None, :, :] & conflict).any(-1)
                & waiting[:, None]
                & (slot_ids[None, :] != slot_ids[:, None])
                & (s["tid"][None, :] >= 0)
            )
            if dl == "waitdie":
                # a waiter dies whenever its wait-for edge points at an
                # older holder, re-checked on every holder change; the
                # "die" probe is costed as latency only in stage 9
                newly_waiting = waiting & ~s["waited"]
                older_holder = (
                    adj & (s["ts"][None, :] < s["ts"][:, None])
                ).any(-1)
                abort_dl = older_holder & waiting
                s["dl_debt"] = s["dl_debt"] + torch.where(
                    newly_waiting, cm.waitdie_check_cycles, c[0]
                )
            else:
                # one propagation step per round (dreadlocks-style
                # digests); the bool product is an OR of ANDs
                reach = own | (adj[:, :, None] & s["reach"][None]).any(1)
                s["reach"] = torch.where(waiting[:, None], reach, own)
                reach_t = s["reach"].t()
                in_cycle = (adj & reach_t).any(-1)  # holder reaches me
                # abort the youngest member of the detected cycle; waitfor
                # and dreadlocks are logically equivalent detectors (paper
                # §4.1) and differ only in their cost constants
                scc = s["reach"] & reach_t
                scc_ts_max = torch.where(
                    scc & in_cycle[None, :], s["ts"][None, :], c[-1]
                ).amax(dim=1)
                abort_dl = in_cycle & (s["ts"] >= scc_ts_max)
                s["dl_debt"] = s["dl_debt"] + torch.where(
                    waiting, dl_wait_cycles, c[0]
                )
            s["waited"] = waiting
            # convert deadlock-handling debt into lane busy time
            debt_rounds = s["dl_debt"] // cm.cycles_per_round
            has_debt = debt_rounds > 0
            s["busy_until"] = torch.where(
                has_debt, torch.maximum(s["busy_until"], r) + debt_rounds,
                s["busy_until"],
            )
            s["busy_kind"] = torch.where(has_debt, c[CAT_DL], s["busy_kind"])
            s["dl_debt"] = s["dl_debt"] % cm.cycles_per_round

            abort_dl = abort_dl & waiting
            s["aborts_dl"] = s["aborts_dl"] + abort_dl.sum(dtype=I32)
            s["wasted"] = s["wasted"] + torch.where(
                abort_dl, s["kptr"], c[0]).sum(dtype=I32)
            s["phase"] = torch.where(abort_dl, c[REL], s["phase"])
            s["committing"] = s["committing"] & ~abort_dl
            s["release_at"] = torch.where(abort_dl, r, s["release_at"])
            s["want"] = s["want"] & ~abort_dl[:, None]

        # ------------------------------------------------ 9. line-cost model
        # Coherence physics for shared lock tables (paper §2.1): each
        # record's CC meta-data line is a serially-reusable resource.
        # ORTHRUS CC lanes are exempt: single-owner meta-data.
        if not cfg.is_orthrus:
            newop = newop2d  # fresh lock-table ops this round: reqs+releases
            mutate = newop & ~abort_dl[:, None]  # dies don't enqueue
            e = r >> EPOCH_BITS
            opk_r = torch.clamp(torch.where(newop, keys, c[0]), max=R - 1
                                ).long()
            heat_k = s["heat"][opk_r]  # [T, K, 3] = (ep, cnt_cur, cnt_prev)
            ep_k = heat_k[..., 0]
            cur_k = heat_k[..., 1]
            prev_k = heat_k[..., 2]
            line_k = s["line"][opk_r]  # [T, K, 2] = (lnf, last_lane)
            sharers = torch.where(
                ep_k == e,
                torch.maximum(prev_k, cur_k),
                torch.where(ep_k == e - 1, cur_k, c[0]),
            )
            remote = line_k[..., 1] != lane2d
            coh = torch.where(
                remote,
                cm.coherence_cycles_per_sharer
                * torch.clamp(sharers, 1, cfg.n_exec - 1),
                c[0],
            )
            if dl == "dreadlocks":
                # waiters spin on the holders' digests: each op pays extra
                # coherence proportional to the current queue (§4.4.1)
                coh = coh + cm.dreadlocks_spin_cycles * torch.clamp(
                    contend - 1, min=0
                )
            dur = rounds_of(lock_op_cycles + coh)
            lnf_cur = line_k[..., 0]
            backlog = torch.clamp(
                torch.where(mutate, lnf_cur - r, c[0]), min=0)
            charge = torch.where(newop, backlog + dur, c[0]).sum(
                dim=1, dtype=I32)
            # occupancy: same-round queue mutations serialize on the line;
            # per-key mutation count, reusing the grant pass's sort
            mut_in_seg = segment_sum_sorted(
                ent_key[order],
                mutate.reshape(-1).to(I32)[order],
            )[inv].view(T, K)
            occupy = torch.where(mutate, mut_in_seg * dur, c[0])
            tgt = torch.maximum(lnf_cur, r) + occupy
            opk_heat = torch.where(newop, opk_r, R).reshape(-1)
            # lnf only at mutating entries (INT32_MIN is the max identity);
            # last_lane at every fresh op. Heat values are per-key
            # identical, so a duplicate-index set is idempotent.
            line_upd = torch.stack(
                [torch.where(mutate, tgt, c[I32_MIN]), lane2d], dim=-1
            ).reshape(-1, 2)
            s["line"].scatter_reduce_(
                0, opk_heat[:, None].expand(-1, 2), line_upd, "amax",
                include_self=True,
            )
            new_prev = torch.where(
                ep_k == e, prev_k, torch.where(ep_k == e - 1, cur_k, c[0])
            )
            new_cur = torch.where(ep_k == e, cur_k, c[0]) + new_in_seg
            heat_upd = torch.stack(
                [e.expand(T, K), new_cur, new_prev], dim=-1
            ).reshape(-1, 3)
            s["heat"][opk_heat] = heat_upd
            charged = charge > 0
            s["busy_until"] = torch.where(
                charged, torch.maximum(s["busy_until"], r) + charge,
                s["busy_until"],
            )
            s["busy_kind"] = torch.where(charged, c[CAT_LOCK], s["busy_kind"])

        # ------------------------------------------------ 10. transitions
        free = s["busy_until"] <= r
        exec_rounds_one = rounds_of(exec_cycles_per_op)

        if cfg.is_dynamic_2pl:
            cur_granted = take(s["granted"], s["kptr"])
            go = (s["phase"] == ACQ) & free & cur_granted & ~abort_dl
            last = go & (s["kptr"] + 1 >= nkeys)
            extra = torch.clamp(execops - nkeys, min=0)
            add = torch.where(
                go,
                exec_rounds_one
                + torch.where(last, extra * exec_rounds_one, c[0]),
                c[0],
            )
            s["busy_until"] = torch.where(
                go, torch.maximum(s["busy_until"], r) + add, s["busy_until"]
            )
            s["busy_kind"] = torch.where(go, c[CAT_EXEC], s["busy_kind"])
            s["kptr"] = torch.where(go, s["kptr"] + 1, s["kptr"])
            s["phase"] = torch.where(last, c[EXEC], s["phase"])
        elif cfg.protocol in ("deadlock_free", "partitioned_store"):
            cur_granted = take(s["granted"], s["kptr"])
            go = (s["phase"] == ACQ) & free & cur_granted
            s["kptr"] = torch.where(go, s["kptr"] + 1, s["kptr"])
            alldone = go & (s["kptr"] >= nkeys)
            s["phase"] = torch.where(alldone, c[EXEC], s["phase"])
            s["busy_until"] = torch.where(
                alldone,
                torch.maximum(s["busy_until"], r) + execops * exec_rounds_one,
                s["busy_until"],
            )
            s["busy_kind"] = torch.where(alldone, c[CAT_EXEC], s["busy_kind"])
        else:  # orthrus
            in_cur_group = (
                (kk[None, :] >= s["ccptr"][:, None])
                & kvalid
                & (ccids == take(ccids, s["ccptr"])[:, None])
            )
            grp_done = (
                (s["phase"] == ACQ)
                & (s["granted"] | ~in_cur_group).all(dim=1)
            )
            nxt = torch.where(
                (kk[None, :] >= s["ccptr"][:, None]) & kvalid & ~in_cur_group,
                kk[None, :],
                K,
            ).amin(dim=1)
            more = grp_done & (nxt < K)
            s["ccptr"] = torch.where(more, nxt, s["ccptr"])
            s["adm_done"] = s["adm_done"] & ~more[:, None]
            s["phase"] = torch.where(grp_done, c[MSG], s["phase"])
            s["msg_stage"] = torch.where(
                grp_done, torch.where(more, c[0], c[1]), s["msg_stage"])
            s["msg_arrive"] = torch.where(
                grp_done, r + cm.msg_hop_rounds, s["msg_arrive"]
            )
            # response arrives -> READY
            resp = (
                (s["phase"] == MSG) & (s["msg_stage"] == 1)
                & (s["msg_arrive"] <= r)
            )
            s["phase"] = torch.where(resp, c[READY], s["phase"])
            # exec-lane scheduling: oldest READY per idle lane starts
            lane_busy = (
                ((s["phase"] == EXEC) & ~free).to(I32)
                .view(cfg.n_exec, W).sum(dim=1, dtype=I32)
            )
            ready = s["phase"] == READY
            ready_ts = torch.where(ready, s["ts"], c[_IMAX])
            lane_min = ready_ts.view(cfg.n_exec, W).amin(dim=1)
            lane_idx = lane_of.long()
            startx = (
                ready
                & (ready_ts == lane_min[lane_idx])
                & (lane_busy[lane_idx] == 0)
            )
            # break ties (same ts impossible — tids unique) -> safe
            s["phase"] = torch.where(startx, c[EXEC], s["phase"])
            s["busy_until"] = torch.where(
                startx, r + execops * exec_rounds_one, s["busy_until"]
            )
            s["busy_kind"] = torch.where(startx, c[CAT_EXEC], s["busy_kind"])

        # EXEC finished -> release (commit, or OLLP-miss abort+retry)
        free = s["busy_until"] <= r
        fin = (s["phase"] == EXEC) & free
        is_miss = fin & miss & (s["attempt"] == 0)
        s["aborts_ollp"] = s["aborts_ollp"] + is_miss.sum(dtype=I32)
        s["wasted"] = s["wasted"] + torch.where(is_miss, execops, c[0]).sum(
            dtype=I32)
        s["phase"] = torch.where(fin, c[REL], s["phase"])
        s["committing"] = torch.where(fin, ~is_miss, s["committing"])
        rel_delay = cm.msg_hop_rounds if cfg.is_orthrus else 0
        s["release_at"] = torch.where(fin, r + rel_delay, s["release_at"])
        s["rel_done"] = s["rel_done"] & ~fin[:, None]
        s["want"] = s["want"] & ~fin[:, None]

        # REL complete -> EMPTY (commit) or BACKOFF (retry). A slot leaves
        # only after every lock it held has actually been released.
        rel_done_all = (
            (s["phase"] == REL)
            & (s["release_at"] <= r)
            & ~s["granted"].any(dim=1)
        )
        com = rel_done_all & s["committing"]
        s["commits"] = s["commits"] + com.sum(dtype=I32)
        lat = r - s["arrive"]
        lat_b = (lat[:, None] >= lat_pow2[None, :]).sum(dim=1, dtype=I32)
        s["lat_hist"] = s["lat_hist"].index_add(
            0, torch.where(com, lat_b, c[0]), com.to(I32))
        s["phase"] = torch.where(
            rel_done_all, torch.where(s["committing"], c[EMPTY], c[BACKOFF]),
            s["phase"],
        )
        s["tid"] = torch.where(com, c[-1], s["tid"])
        s["busy_until"] = torch.where(
            rel_done_all & ~s["committing"],
            r + cm.abort_backoff_rounds,
            s["busy_until"],
        )
        s["want"] = s["want"] & ~rel_done_all[:, None]

        # ------------------------------------------------ 11. lane accounting
        busy = s["busy_until"] > r
        slot_cat = torch.where(
            busy,
            s["busy_kind"],
            torch.where(
                (s["phase"] == ACQ) & (s["want"] & ~s["granted"]).any(dim=1),
                c[CAT_WAIT],
                torch.where(
                    (s["phase"] == MSG) | (s["phase"] == READY)
                    | (s["phase"] == REL),
                    c[CAT_MSG],
                    c[CAT_IDLE],
                ),
            ),
        )
        if cfg.is_orthrus:
            # a lane is "exec" if its running slot is busy executing; else
            # classify by the most advanced outstanding slot state
            lane_cat = torch.where(
                lane_any(busy & (slot_cat == CAT_EXEC)),
                c[CAT_EXEC],
                torch.where(
                    lane_any(slot_cat == CAT_WAIT), c[CAT_WAIT],
                    torch.where(lane_any(slot_cat == CAT_MSG), c[CAT_MSG],
                                c[CAT_IDLE]),
                ),
            )
            cat_counts = torch.zeros(NCAT, dtype=I32, device=dev).index_add_(
                0, lane_cat, ones_lanes)
        else:
            cat_counts = torch.zeros(NCAT, dtype=I32, device=dev).index_add_(
                0, slot_cat, ones_t)

        # ------------------------------------------------ 12. event leap
        # Advance straight to the next round at which any slot can act.
        # Every skipped round is provably a no-op, and the post-transition
        # lane state (`cat_counts`) persists unchanged through the gap.
        if cfg.event_leap:
            ph = s["phase"]
            busy2 = s["busy_until"] > r
            free2 = ~busy2
            # future per-slot timers; a busy expiry is always an event
            cand = torch.where(busy2, s["busy_until"], c[_IMAX])
            # admission, release processing and message arrival ignore the
            # busy timer, so their timers are tracked unconditionally
            cand = torch.minimum(cand, torch.where(
                (ph == MSG) & (s["msg_arrive"] > r), s["msg_arrive"],
                c[_IMAX]))
            cand = torch.minimum(cand, torch.where(
                (ph == REL) & (s["release_at"] > r), s["release_at"],
                c[_IMAX]))
            if lane_stream is None:
                can_adm = True
            else:
                can_adm = lane_stream_at(lane_stream, s["lane_ctr"]) >= 0
            act_next = (
                ((ph == EMPTY) & can_adm)
                | ((ph == MSG) & (s["msg_arrive"] <= r))
                | ((ph == REL) & (s["release_at"] <= r))
                | (free2 & ((ph == INIT) | (ph == BACKOFF)))
            )
            if cfg.is_orthrus:
                # a READY slot starts the round its lane goes idle
                lane_exec_busy = lane_any((ph == EXEC) & busy2)
                act_next = act_next | (
                    (ph == READY) & ~lane_exec_busy[lane_of.long()]
                )
            else:
                # an acquiring slot with no pending request places its next
                # one immediately; a blocked waiter is woken by its
                # holder's release timer
                blocked = take(s["want"] & ~s["granted"], s["kptr"])
                act_next = act_next | ((ph == ACQ) & free2 & ~blocked)
            if dl in ("waitfor", "dreadlocks"):
                # graph detectors evolve every waiting round: stay dense
                # while any slot waits
                act_next = act_next | s["waited"].any()
            cand = torch.where(act_next, r + 1, cand)
            nxt = torch.minimum(torch.maximum(cand.min(), r + 1), r_end)
        else:
            nxt = r + 1
        leap = nxt - r
        s["cat"] = s["cat"] + cat_counts * leap
        s["steps"] = s["steps"] + 1
        s["r"] = nxt
        return s

    return step


def batch_state0(cfg: Config, plan, T: int,
                 device: torch.device | str = "cuda") -> dict:
    """Initial state of the batch engine, with the extra dropped-write
    row on ``done``; ``plan`` is ``reference.plan.BatchPlan``."""
    dev = torch.device(device)
    N = plan.n_txns

    def scalar(v):
        return torch.tensor(int(v), dtype=I32, device=dev)

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return dict(
        r=z(),
        next_txn=z(),
        cur_batch=z(),
        bpos=z(),
        batch_left=scalar(plan.batch_size[0]),
        plan_fin=scalar(plan.plan_rounds[0]),
        done=z(N + 1, dtype=torch.bool),
        tid=torch.full((T,), -1, dtype=I32, device=dev),
        widx=z(T),
        ts=z(T),
        phase=z(T),
        busy_until=z(T),
        busy_kind=z(T),
        msg_arrive=z(T),
        commits=z(),
        aborts_dl=z(),
        aborts_ollp=z(),
        wasted=z(),
        cat=z(NCAT),
        steps=z(),
        arrive=z(T),
        lat_hist=z(LAT_BUCKETS),
    )


def make_batch_step(cfg: Config, meta: Meta,
                    device: torch.device | str = "cuda"):
    """Single-round transition for the batch-planned protocols (dgcc /
    quecc): lock-free execution over a precomputed dependency schedule.

    Returns ``step(p, s, r_end)`` with the contract of :func:`make_step`
    (``done`` is updated in place). The round loop performs only (a)
    batch-boundary bookkeeping, (b) admission of the current batch's
    transactions to exec-lane slots, and (c) the wavefront-eligibility
    check "all planned predecessors committed" in its dense-gather form.
    There is no lock table, no deadlock logic, and no abort path.
    """
    dev = torch.device(device)
    cm = cfg.cost
    T = cfg.n_slots
    N = meta.n_txns
    W = cfg.window
    NB = meta.num_batches

    lane_idx = (torch.arange(T, dtype=I32, device=dev) // W).long()
    ones_lanes = torch.ones(cfg.n_exec, dtype=I32, device=dev)
    c = {v: torch.tensor(v, dtype=I32, device=dev)
         for v in (0, INIT, MSG, READY, EXEC, EMPTY, CAT_IDLE, CAT_EXEC,
                   CAT_LOCK, CAT_WAIT, CAT_MSG, _IMAX, -1)}
    lat_pow2 = 2 ** torch.arange(LAT_BUCKETS - 1, dtype=I32, device=dev)
    shared_index = not cfg.split_index
    exec_cycles_per_op = cm.exec_op_cycles + (
        cm.shared_index_penalty_cycles if shared_index else 0
    )

    def rounds_of(cyc):
        return (cyc + cm.cycles_per_round - 1) // cm.cycles_per_round

    exec_rounds_one = rounds_of(exec_cycles_per_op)

    def lane_any(x):
        return x.view(cfg.n_exec, W).any(dim=1)

    def step(p, s, r_end):
        s = dict(s)
        r = s["r"]
        wexec = p["exec_ops"]
        wnpred = p["npred"]
        pred_pad = p["pred_pad"]  # [N, P]
        batch_of = p["batch_of"]  # [N]
        bstart = p["batch_start"]  # [NB]
        bsize = p["batch_size"]
        plan_rounds = p["plan_rounds"]  # [NB]
        done = s["done"]  # [N + 1], updated in place

        # -------------------------------------------- 1. batch rollover
        # When every transaction of the current batch has committed, open
        # the next one. Planning is pipelined: planners started on the
        # next batch the moment they finished this one, so the new
        # batch's plan-ready round advances by its own planning span.
        adv = s["batch_left"] == 0
        new_b = torch.where(adv, (s["cur_batch"] + 1) % NB, s["cur_batch"])
        done[:N].masked_fill_(adv & (batch_of == new_b), False)
        s["bpos"] = torch.where(adv, _at(bstart, new_b), s["bpos"])
        s["batch_left"] = torch.where(adv, _at(bsize, new_b),
                                      s["batch_left"])
        s["plan_fin"] = torch.where(
            adv, s["plan_fin"] + _at(plan_rounds, new_b), s["plan_fin"]
        )
        s["cur_batch"] = new_b

        # -------------------------------------------- 2. admission
        # Empty slots pull the next positions of the current batch, in
        # the planner's serial order, once the batch's plan is ready.
        empty = s["phase"] == EMPTY
        rank = torch.cumsum(empty, 0, dtype=I32) - 1
        pos = s["bpos"] + rank
        bend = _at(bstart, s["cur_batch"]) + _at(bsize, s["cur_batch"])
        adm = empty & (pos < bend) & (r >= s["plan_fin"])
        s["widx"] = torch.where(adm, pos, s["widx"])
        new_tid = s["next_txn"] + rank
        s["tid"] = torch.where(adm, new_tid, s["tid"])
        s["arrive"] = torch.where(adm, r, s["arrive"])
        s["ts"] = torch.where(adm, new_tid, s["ts"])
        n_adm = adm.sum(dtype=I32)
        s["bpos"] = s["bpos"] + n_adm
        s["next_txn"] = s["next_txn"] + n_adm
        widx = s["widx"].long()
        npred_t = wnpred[widx]
        init_busy = rounds_of(
            cm.txn_fixed_cycles + npred_t * cm.dep_check_cycles
        )
        s["phase"] = torch.where(adm, c[INIT], s["phase"])
        s["busy_until"] = torch.where(adm, r + init_busy, s["busy_until"])
        s["busy_kind"] = torch.where(adm, c[CAT_LOCK], s["busy_kind"])

        # -------------------------------------------- 3. INIT -> MSG
        # The exec lane fetches its next planned entry from the scheduler
        # queue: one SPSC hop (functional separation, as in ORTHRUS).
        free = s["busy_until"] <= r
        start = (s["phase"] == INIT) & free & (s["tid"] >= 0)
        s["phase"] = torch.where(start, c[MSG], s["phase"])
        s["msg_arrive"] = torch.where(
            start, r + cm.msg_hop_rounds, s["msg_arrive"]
        )
        got = (s["phase"] == MSG) & (s["msg_arrive"] <= r)
        s["phase"] = torch.where(got, c[READY], s["phase"])

        # -------------------------------------------- 4. wavefront check
        # "All planned predecessors committed" in dense per-slot form.
        def dep_clear():
            preds = pred_pad[widx]  # [T, P]
            return ((preds < 0) | done[torch.clamp(preds, min=0).long()]
                    ).all(dim=1)

        ready = (s["phase"] == READY) & dep_clear()

        # -------------------------------------------- 5. lane scheduling
        busy = s["busy_until"] > r
        lane_busy = lane_any((s["phase"] == EXEC) & busy)
        ready_ts = torch.where(ready, s["ts"], c[_IMAX])
        lane_min = ready_ts.view(cfg.n_exec, W).amin(dim=1)
        startx = (
            ready
            & (ready_ts == lane_min[lane_idx])
            & ~lane_busy[lane_idx]
        )
        exec_t = wexec[widx]
        s["phase"] = torch.where(startx, c[EXEC], s["phase"])
        s["busy_until"] = torch.where(
            startx, r + exec_t * exec_rounds_one, s["busy_until"]
        )
        s["busy_kind"] = torch.where(startx, c[CAT_EXEC], s["busy_kind"])

        # -------------------------------------------- 6. commit
        # No locks to release and no abort path: planned execution is
        # conflict-free by construction.
        free = s["busy_until"] <= r
        fin = (s["phase"] == EXEC) & free
        done.index_fill_(0, torch.where(fin, s["widx"], N).long(), True)
        ncom = fin.sum(dtype=I32)
        s["commits"] = s["commits"] + ncom
        lat = r - s["arrive"]
        lat_b = (lat[:, None] >= lat_pow2[None, :]).sum(dim=1, dtype=I32)
        s["lat_hist"] = s["lat_hist"].index_add(
            0, torch.where(fin, lat_b, c[0]), fin.to(I32))
        s["batch_left"] = s["batch_left"] - ncom
        s["phase"] = torch.where(fin, c[EMPTY], s["phase"])
        s["tid"] = torch.where(fin, c[-1], s["tid"])

        # -------------------------------------------- 7. lane accounting
        busy2 = s["busy_until"] > r
        slot_cat = torch.where(
            busy2,
            s["busy_kind"],
            torch.where(
                s["phase"] == MSG,
                c[CAT_MSG],
                torch.where(s["phase"] == READY, c[CAT_WAIT], c[CAT_IDLE]),
            ),
        )
        lane_cat = torch.where(
            lane_any(busy2 & (slot_cat == CAT_EXEC)),
            c[CAT_EXEC],
            torch.where(
                lane_any(slot_cat == CAT_WAIT), c[CAT_WAIT],
                torch.where(lane_any(slot_cat == CAT_MSG), c[CAT_MSG],
                            c[CAT_IDLE]),
            ),
        )
        cat_counts = torch.zeros(NCAT, dtype=I32, device=dev).index_add_(
            0, lane_cat, ones_lanes)

        # -------------------------------------------- 8. event leap
        # Timers: busy_until (init dep-check spans, exec, pred commits),
        # msg_arrive, and the scalar admission gate (plan_fin / batch
        # rollover). A dep-blocked READY slot is woken by its predecessor's
        # commit; a dep-clear READY slot starts the round its lane goes
        # idle.
        if cfg.event_leap:
            ph = s["phase"]
            busy3 = s["busy_until"] > r
            free3 = ~busy3
            cand = torch.where(busy3, s["busy_until"], c[_IMAX])
            cand = torch.minimum(cand, torch.where(
                (ph == MSG) & (s["msg_arrive"] > r), s["msg_arrive"],
                c[_IMAX]))
            act_next = (
                (free3 & (ph == INIT))
                | ((ph == MSG) & (s["msg_arrive"] <= r))
            )
            lane_exec_busy = lane_any((ph == EXEC) & busy3)
            act_next = act_next | (
                (ph == READY) & dep_clear() & ~lane_exec_busy[lane_idx]
            )
            cand = torch.where(act_next, r + 1, cand)
            # admission is a scalar event: the next batch opens the round
            # after batch_left hits zero; within a batch, empty slots admit
            # once plan_fin has passed and positions remain
            bend2 = _at(bstart, s["cur_batch"]) + _at(bsize, s["cur_batch"])
            adm_evt = torch.where(
                s["batch_left"] == 0,
                r + 1,
                torch.where(
                    s["bpos"] < bend2,
                    torch.maximum(s["plan_fin"], r + 1),
                    c[_IMAX],
                ),
            )
            adm_evt = torch.where((ph == EMPTY).any(), adm_evt, c[_IMAX])
            nxt = torch.minimum(
                torch.maximum(torch.minimum(cand.min(), adm_evt), r + 1),
                r_end,
            )
        else:
            nxt = r + 1
        leap = nxt - r
        s["cat"] = s["cat"] + cat_counts * leap
        s["steps"] = s["steps"] + 1
        s["r"] = nxt
        return s

    return step
