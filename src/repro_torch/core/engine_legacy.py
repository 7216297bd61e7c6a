"""The frozen pre-packed step builders (``ENGINE_VERSION`` "2-event-leap")
in PyTorch: the differential-conformance oracle of the packed engine.

The port of ``repro.core.engine_legacy``, bit for bit. The round state
is the per-slot dict of [T] / [T, K] arrays that the engine used before
its packed [T, F] state-matrix rewrite. ``EngineConfig(state_layout=
"legacy")`` routes ``repro_torch.core.sweep`` to these builders, so a
legacy run and a packed run of one cell can be held to each other on
any device: the two share no step code, and this one launches no
kernel (its grant is the plain sorted scan, its wait-for graph the
dense [T, T, K] comparison; ``EngineConfig`` allows the legacy layout
only with ``kernel_impl="auto"`` and ``release_path="csr"``).

Do not optimize or refactor this module: its value is that it does not
change. It imports the layout-independent constants and helpers from
``repro_torch.core.engine`` and ``repro_torch.core.lockgrant``.

As in the packed port, the per-record arrays ``wh``, ``rc``, ``heat``
and ``line`` and the batch engine's ``done`` carry one extra last row
for the reference's dropped writes (``engine.DROP_ROW_ARRAYS``), and
the step updates them in place. The step reads nothing on the host, so
a CUDA graph can capture it.
"""

from __future__ import annotations

import torch

from repro_torch.core import planner as planner_lib
from repro_torch.core.engine import (
    ACQ,
    BACKOFF,
    CAT_DL,
    CAT_EXEC,
    CAT_IDLE,
    CAT_LOCK,
    CAT_MSG,
    CAT_WAIT,
    EMPTY,
    EPOCH_BITS,
    EXEC,
    I32,
    INIT,
    MSG,
    NCAT,
    READY,
    REL,
    EngineConfig,
    PlanMeta,
    _at,
    _batch_plan_rounds,
    _IMAX,
)
from repro_torch.core.lockgrant import (
    I32_MIN,
    KEY_SENTINEL,
    REQ_NONE,
    REQ_READ,
    REQ_RELEASE,
    REQ_WRITE,
    inverse_permutation,
    lex_order,
    segment_sum_sorted,
    segmented_grant,
)
from repro_torch.core.workloads import MODE_READ, MODE_WRITE


def _state0(cfg: EngineConfig, num_records: int, T: int, K: int,
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
    )


def make_step(cfg: EngineConfig, meta: PlanMeta,
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


def _batch_state0(cfg: EngineConfig, plan: planner_lib.Plan, T: int,
                  device: torch.device | str = "cuda") -> dict:
    """Initial state of the batch engine, with the extra dropped-write
    row on ``done``."""
    dev = torch.device(device)
    sched = plan.sched
    N = sched.n_txns

    def scalar(v):
        return torch.tensor(int(v), dtype=I32, device=dev)

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return dict(
        r=z(),
        next_txn=z(),
        cur_batch=z(),
        bpos=z(),
        batch_left=scalar(sched.batch_size[0]),
        plan_fin=scalar(_batch_plan_rounds(cfg, plan)[0]),
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
    )


def make_batch_step(cfg: EngineConfig, meta: PlanMeta,
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
