"""Distributed ORTHRUS: partitioned CC and explicit message passing, in
PyTorch (the port of ``repro.core.distributed``, bit for bit).

Mapping (paper -> mesh), as in the reference:
  CC thread            -> one CC shard per position of the ``cc`` axis,
                          owning a disjoint key range (single-owner lock
                          tables, P1)
  exec thread          -> a block of execution lanes beside each shard
  SPSC message queues  -> fixed-capacity all-to-all request and response
                          buffers; a request that overflows retries next
                          round
  deadlock-free plan   -> each lane acquires its pre-sorted keys in
                          canonical order, one at a time (P2)

The round body works on S local shards at once, every per-shard tensor
with a leading [S] dimension, and moves its messages through one
exchange with two backends (``_route``):

* **one-device form** (a ``Mesh`` of ``launch.mesh``'s one-device form):
  S = n_cc on one device, and the all-to-all of [n_src, n_dst, CAP, F]
  buffers is a transpose to [n_dst, n_src, CAP, F], each receiver's
  inbox the senders' blocks in sender order;
* **process form** (a ``DeviceMesh``-backed mesh): S = 1 a rank, and the
  exchange is ``torch.distributed.all_to_all_single`` on int32 (gloo on
  the CPU, NCCL across cards).

The grant stage is the lock_grant kernel's contract (B1's sorted form):
a round's requests of all local shards are sorted once by (global key,
lane), granted in one call of ``kernels.lock_grant.ops.lock_grant_sorted``
(where ``use_kernel`` holds; ``core.lockgrant.sorted_grant`` otherwise)
and unsorted. One sort serves every shard because a shard's inbox holds
only keys it owns (owner = key // keys_per_shard) and a lane sends at
most one message a round: the key segments, and the order within them,
are those of the reference's per-shard ``lex_order``.

On a CUDA device the one-device form runs its rounds as replays of a
counted CUDA graph (``core.graphs``; ``ROUNDS_PER_REPLAY`` rounds each,
the remainder one more graph) and reads the commits once at the end; on the CPU, and
in the process form, the loop is eager. Nothing is read on the host
inside a round.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graphs import CountedGraph
from repro_torch.core.lockgrant import (
    KEY_SENTINEL,
    REQ_NONE,
    REQ_READ,
    REQ_RELEASE,
    REQ_WRITE,
    lex_order,
    sorted_grant,
)
from repro_torch.kernels import use_kernel

# per-lane phases
D_ACQ, D_EXEC, D_REL, D_DONE = 0, 1, 2, 3

I32 = torch.int32
ROUNDS_PER_REPLAY = 8


@dataclasses.dataclass(frozen=True)
class DistConfig:
    lanes_per_shard: int = 16  # exec lanes per CC shard
    keys_per_txn: int = 4
    rounds: int = 256
    exec_rounds: int = 3
    msg_cap: int = 64  # all-to-all buffer slots per peer pair
    keys_per_shard: int = 4096


def _route(buf: torch.Tensor, group=None) -> torch.Tensor:
    """The all-to-all of [S, n_peers, CAP, F] message buffers (explicit
    queues): out[d, s] = buf[s, d]. Without a group the S shards are the
    whole axis on one device (a transpose); with one, S = 1 and each
    peer block goes to its rank."""
    if group is None:
        return buf.transpose(0, 1).contiguous()
    import torch.distributed as dist

    out = torch.empty_like(buf)
    dist.all_to_all_single(out.view(-1), buf.contiguous().view(-1),
                           group=group)
    return out


def compact_indices(mask: torch.Tensor, size: int) -> torch.Tensor:
    """int32 [S, size]: each row's indices where ``mask`` holds, ascending,
    then -1 (``jnp.nonzero(row, size=size, fill_value=-1)[0]`` per row),
    at a fixed size: a cumulative sum and a scatter, no host read."""
    S, n = mask.shape
    pos = torch.cumsum(mask, 1, dtype=I32) - 1
    idx = torch.where(mask & (pos < size), pos, size).long()
    src = torch.arange(n, dtype=I32, device=mask.device).expand(S, n)
    out = torch.full((S, size + 1), -1, dtype=I32, device=mask.device)
    return out.scatter_(1, idx, src)[:, :size]


def _run_starts(v: torch.Tensor) -> torch.Tensor:
    """bool [S, n]: v[:, j] opens a run of equal values along the row."""
    return torch.cat([torch.ones_like(v[:, :1], dtype=torch.bool),
                      v[:, 1:] != v[:, :-1]], 1)


def _pos_in_run(start: torch.Tensor, iota: torch.Tensor) -> torch.Tensor:
    """Each entry's position within its run (``start`` opens a run)."""
    return iota - torch.cummax(torch.where(start, iota, 0), 1).values


def initial_state(cfg: DistConfig, S: int, device) -> dict:
    """The S local shards' state; ``wh`` and ``rc`` carry a drop column at
    ``keys_per_shard`` (the reference's scatters drop that index)."""
    L, K, RK = cfg.lanes_per_shard, cfg.keys_per_txn, cfg.keys_per_shard

    def z(*shape, dtype=I32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return dict(
        kptr=z(S, L),
        phase=z(S, L, fill=D_ACQ),
        granted=z(S, L, K, dtype=torch.bool),
        busy=z(S, L),
        pending=z(S, L, dtype=torch.bool),
        wh=z(S, RK + 1, fill=-1),
        rc=z(S, RK + 1),
        commits=z(S),
    )


def make_round(cfg: DistConfig, n_cc: int, me: torch.Tensor, keys, modes,
               *, kernel: bool, group=None):
    """``round_(s)``: one round of the S = len(me) local shards, applied
    to the state dict ``s`` in place. ``keys``/``modes`` int32 [S, L, K]
    (each lane's keys sorted: canonical order). Constants are built here,
    so a round copies nothing from the host and can be captured."""
    L, K, RK, CAP = (cfg.lanes_per_shard, cfg.keys_per_txn,
                     cfg.keys_per_shard, cfg.msg_cap)
    N = n_cc * CAP
    dev = keys.device
    S = me.shape[0]
    iota_l = torch.arange(L, dtype=I32, device=dev)
    iota_k = torch.arange(K, dtype=I32, device=dev)
    iota_n = torch.arange(N, dtype=I32, device=dev)
    lane_gid = me[:, None] * L + iota_l
    me_key = me[:, None] * RK
    me_lane = me[:, None] * L
    c_read, c_write, c_release, c_none = (
        torch.tensor(v, dtype=I32, device=dev)
        for v in (REQ_READ, REQ_WRITE, REQ_RELEASE, REQ_NONE))
    if kernel:
        from repro_torch.kernels.lock_grant.ops import lock_grant_sorted

        def grant_sorted(k, kind, whf, rcv):
            return lock_grant_sorted(k, kind, whf, rcv)[0]
    else:
        grant_sorted = sorted_grant

    def at_kptr(t, ptr):
        return t.gather(2, ptr.long()[..., None])[..., 0]

    def round_(s):
        kptr, phase, busy = s["kptr"], s["phase"], s["busy"]
        granted, pending = s["granted"], s["pending"]
        wh, rc = s["wh"], s["rc"]

        # -- 1. outgoing request messages (acquire or release)
        kp = torch.clamp(kptr, max=K - 1)
        cur_key = at_kptr(keys, kp)
        cur_mode = at_kptr(modes, kp)
        want_acq = (phase == D_ACQ) & ~pending & (busy <= 0) & (kptr < K)
        rel_now = (phase == D_REL) & (busy <= 0)
        owner_acq = torch.div(cur_key, RK, rounding_mode="floor")
        # releases go one held key a round (the first held)
        rel_ptr = torch.argmax(granted.to(I32), 2)
        rel_key = at_kptr(keys, rel_ptr)
        send_rel = rel_now & granted.any(2)
        owner = torch.where(send_rel,
                            torch.div(rel_key, RK, rounding_mode="floor"),
                            owner_acq)
        kind = torch.where(send_rel, c_release,
                           torch.where(cur_mode == 1, c_write, c_read))
        key_out = torch.where(send_rel, rel_key, cur_key)
        active = want_acq | send_rel

        # pack into per-peer buffers (capacity CAP; overflow retries)
        dest = torch.where(active, owner, n_cc)
        order = lex_order(dest, lane_gid)
        o_sorted = dest.gather(1, order)
        posn = _pos_in_run(_run_starts(o_sorted), iota_l)
        fits = (posn < CAP) & (o_sorted < n_cc)
        slot = torch.where(fits, o_sorted * CAP + posn, N).long()
        src = torch.stack([key_out.gather(1, order), kind.gather(1, order),
                           lane_gid.gather(1, order)], 2)
        msg = torch.full((S, N + 1, 3), -1, dtype=I32, device=dev)
        msg.scatter_(1, slot[..., None].expand(S, L, 3), src)
        sent = torch.zeros_like(fits).scatter_(1, order, fits)
        pending |= sent & want_acq
        # releases: the key is released locally once the message is away
        rel_sent = sent & send_rel
        granted &= ~(rel_sent[..., None] & (iota_k == rel_ptr[..., None]))

        inbox = _route(msg[:, :N].reshape(S, n_cc, CAP, 3),
                       group).reshape(S, N, 3)

        # -- 2. CC work: release, then grant, on the local key range
        in_key, in_kind, in_lane = inbox.unbind(2)
        in_active = in_key >= 0
        local_key = torch.where(in_active, in_key - me_key, RK)
        is_rel = in_active & (in_kind == REQ_RELEASE)
        relk = torch.where(is_rel, local_key, RK)
        # a write release clears wh; any other release decrements rc
        wh_rel = is_rel & (
            wh.gather(1, torch.clamp(relk, max=RK - 1).long()) == in_lane)
        wh.scatter_(1, torch.where(wh_rel, relk, RK).long(), -1)
        rc_rel = is_rel & ~wh_rel
        rc.scatter_add_(1, torch.where(rc_rel, relk, RK).long(),
                        -rc_rel.to(I32))

        is_req = in_active & ((in_kind == REQ_READ) | (in_kind == REQ_WRITE))
        safe = torch.clamp(torch.where(is_req, local_key, RK - 1),
                           max=RK - 1).long()
        whf = (wh.gather(1, safe) == -1) & is_req
        rcv = torch.where(is_req, rc.gather(1, safe), 0)
        # every local shard's requests in one grant: sorted by (global
        # key, lane); a shard's keys are its own range
        gkey = torch.where(is_req, in_key, KEY_SENTINEL).reshape(-1)
        lanes = in_lane.reshape(-1)
        ordg = lex_order(gkey, lanes)
        g_sorted = grant_sorted(
            gkey[ordg], torch.where(is_req, in_kind, c_none).reshape(-1)[ordg],
            whf.reshape(-1)[ordg], rcv.reshape(-1)[ordg])
        grant = torch.empty_like(g_sorted).scatter_(
            0, ordg, g_sorted).reshape(S, N)
        gk = torch.where(grant, local_key, RK)
        g_wr = grant & (in_kind == REQ_WRITE)
        wh.scatter_(1, torch.where(g_wr, gk, RK).long(), in_lane)
        g_rd = grant & (in_kind == REQ_READ)
        rc.scatter_add_(1, torch.where(g_rd, gk, RK).long(), g_rd.to(I32))

        # -- 3. response messages back to the requesting lanes
        gi = compact_indices(grant, N)
        ok = gi >= 0
        gsafe = torch.clamp(gi, min=0).long()
        peer = torch.where(
            ok, torch.div(in_lane.gather(1, gsafe), L, rounding_mode="floor"),
            n_cc)
        ordp = lex_order(peer, gi)
        p_sorted = peer.gather(1, ordp)
        posp = _pos_in_run(_run_starts(p_sorted), iota_n)
        fitp = (posp < CAP) & (p_sorted < n_cc)
        sidx = torch.where(fitp, p_sorted * CAP + posp, N).long()
        gsel = gi.gather(1, ordp)
        sel_ok = gsel >= 0
        gsel_safe = torch.clamp(gsel, min=0).long()
        payload = torch.stack([
            torch.where(sel_ok, in_lane.gather(1, gsel_safe), -1),
            torch.where(sel_ok, in_key.gather(1, gsel_safe), -1)], 2)
        resp = torch.full((S, N + 1, 2), -1, dtype=I32, device=dev)
        resp.scatter_(1, sidx[..., None].expand(S, N, 2), payload)
        back = _route(resp[:, :N].reshape(S, n_cc, CAP, 2),
                      group).reshape(S, N, 2)

        # -- 4. apply grant responses to the local lanes
        r_lane = back[..., 0]
        r_ok = r_lane >= 0
        local_lane = torch.where(r_ok, r_lane - me_lane, L).long()
        got = torch.zeros((S, L + 1), dtype=torch.bool, device=dev)
        got = got.scatter_(1, local_lane, True)[:, :L]
        granted |= got[..., None] & (iota_k == kptr[..., None])
        pending &= ~got
        kptr.copy_(torch.where(got, kptr + 1, kptr))
        alldone = (phase == D_ACQ) & (kptr >= K)
        phase.copy_(torch.where(alldone, D_EXEC, phase))
        busy.copy_(torch.where(alldone, cfg.exec_rounds, busy))

        # -- 5. execution / commit bookkeeping
        busy.copy_(torch.clamp(busy - 1, min=0))
        fin = (phase == D_EXEC) & (busy <= 0)
        phase.copy_(torch.where(fin, D_REL, phase))
        done = (phase == D_REL) & ~granted.any(2) & ~pending
        s["commits"] += done.sum(1, dtype=I32)
        # recycle the lane with a fresh (same-plan) txn
        phase.copy_(torch.where(done, D_ACQ, phase))
        kptr.copy_(torch.where(done, 0, kptr))

    return round_


def round_graph(round_, state: dict, k: int, device) -> CountedGraph:
    """``k`` rounds captured as one counted CUDA graph over ``state``'s
    buffers; the warm-up round runs on a scratch copy."""

    def body():
        for _ in range(k):
            round_(state)

    return CountedGraph(
        lambda: round_({n: v.clone() for n, v in state.items()}), body,
        device)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I32)
    return torch.from_numpy(np.asarray(x, dtype=np.int32)).to(device)


def make_engine(mesh, cfg: DistConfig, *, kernel_impl: str = "auto"):
    """``fn(keys, modes)`` -> int32 [n_cc] per-shard commits after
    ``cfg.rounds`` rounds (the reference's ``out_specs=P("cc")``), on the
    mesh's device. keys/modes: [n_cc * lanes_per_shard, K] planned txns
    (each row's keys sorted), numpy or tensors. The backend follows the
    mesh: a one-device mesh runs every shard there, a process mesh one
    shard a rank (each rank passes the whole array and keeps its rows)."""
    n_cc = mesh.shape["cc"]
    L, K = cfg.lanes_per_shard, cfg.keys_per_txn
    device = mesh.device
    kernel = use_kernel(kernel_impl, device)
    if mesh.form == "process":
        group = mesh.device_mesh.get_group("cc")
        me_i = mesh.device_mesh.get_local_rank("cc")
        rows = slice(me_i * L, (me_i + 1) * L)
        shards = [me_i]
    elif mesh.form == "one_device":
        group, rows, shards = None, slice(None), list(range(n_cc))
    else:
        raise ValueError(f"distributed ORTHRUS runs on a one-device or a "
                         f"process mesh, not a {mesh.form} one")
    S = len(shards)

    def fn(keys, modes):
        k = _as_tensor(keys, device)[rows].reshape(S, L, K).contiguous()
        m = _as_tensor(modes, device)[rows].reshape(S, L, K).contiguous()
        me = torch.tensor(shards, dtype=I32, device=device)
        state = initial_state(cfg, S, device)
        round_ = make_round(cfg, n_cc, me, k, m, kernel=kernel, group=group)
        if device.type == "cuda" and group is None and cfg.rounds > 0:
            per = min(ROUNDS_PER_REPLAY, cfg.rounds)
            graph = round_graph(round_, state, per, device)
            for _ in range(cfg.rounds // per):
                graph.replay()
            if cfg.rounds % per:
                rest = round_graph(round_, state, cfg.rounds % per, device)
                rest.replay()
        else:
            for _ in range(cfg.rounds):
                round_(state)
        commits = state["commits"]
        if group is None:
            return commits
        import torch.distributed as dist

        parts = [torch.empty_like(commits) for _ in range(n_cc)]
        dist.all_gather(parts, commits, group=group)
        return torch.cat(parts)

    return fn


def run_distributed(mesh, cfg: DistConfig, keys, modes, *,
                    kernel_impl: str = "auto") -> int:
    """keys/modes: [n_cc * lanes_per_shard, K] planned (sorted) txns.
    Returns the total commits."""
    commits = make_engine(mesh, cfg, kernel_impl=kernel_impl)(keys, modes)
    return int(commits.sum())
