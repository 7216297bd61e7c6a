"""Batch dependency-graph planning: the DGCC / QueCC protocol family.

The paper's two principles — functional separation (P1) and advance
planning (P2) — are pushed furthest by systems that plan *entire batches*
instead of single transactions:

  - DGCC (Yao et al., arXiv 1503.03642) builds, per batch, the conflict
    graph over transactions and executes it as *wavefronts*: topological
    layers of mutually conflict-free transactions. Execution needs no lock
    table at all — only "are my predecessors committed?" checks.
  - QueCC (Qadah & Sadoghi, Middleware'18 / arXiv 1910.10350) partitions
    the key space across planner lanes and materializes, per batch, one
    totally-ordered *execution queue* per lane; a transaction runs when it
    reaches the head of every queue it participates in. The execution
    phase is completely lock-free and deterministic.

This module is the host-side planner for both: vectorized numpy that takes
a planned batch (keys/modes per transaction) and emits a
:class:`BatchSchedule` — intra-batch dependency edges, wavefront levels,
and (for QueCC) per-lane queue position stamps. The engine's batch round
loop (``engine.make_batch_step``) consumes the schedule and performs the
per-round readiness check with the same segmented primitive the
``dep_wavefront`` Pallas kernel implements on device.

Dependency-edge construction (``conflict_edges``) uses last-writer chains
per key: sort all (txn, key, mode) accesses by (batch, key, txn) and emit

  - a RAW/WAW edge from each access to the last *write* before it on the
    same key (covers read-after-write and the write-after-write chain),
  - a WAR edge from each *read* to the next write after it on the key.

Every conflicting pair inside a batch is then connected by a directed path
(write chains are totally ordered; readers hang off the chain in both
directions), so longest-path levels are conflict-free — property-tested in
``tests/test_core_depgraph.py``. Edge count is <= 2 ops per access, so the
graph stays linear in batch size even on hot keys.

QueCC edges (``queue_edges``) are coarser: each transaction depends on its
immediate predecessor in every per-lane queue it touches (lane of key k =
``part(k) % n_lanes``). Per-lane chains are total orders, so the same
transitive argument applies at lane granularity.

Cluster scheduling (``kind="cluster"``) sits between the two: the
`scheduled` family (Prasaad et al., arXiv 1810.01997) does not build a
dependency DAG at all — it unions the conflict edges into
conflict-connected components (``cluster_components_np``) and serializes
each component as one admission-order chain, so every transaction has at
most one predecessor (the previous member of its cluster) and
cross-cluster transactions stay fully concurrent. Correctness is by the
same argument as DGCC's: conflicting txns share a component, the chain is
a total order over it, and the chain order is the submission order.

Fragment granularity (``fragments=True``): a *fragment* is one
transaction's work on one planner lane — the unit QueCC actually chains
through its per-lane queues and DGCC's record-action graph decomposes
into. The schedule then additionally carries a fragment table (owning
txn, lane, key count, wavefront level) and a fragment-level dependency
graph, with a per-txn fragment count for the engine's
commit-when-all-fragments-done join. Every key lives on exactly one
lane, so record-level conflict edges always connect fragments of the
*same* lane, and QueCC queue chains are fragment chains by construction
— a multi-partition transaction's fragments have independent
predecessor sets and can run in different rounds on different exec
lanes. Fragments are numbered in admission order (batch-major,
level-major, txn-minor), which guarantees every admitted fragment's
predecessors were admitted before it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lockgrant import KEY_SENTINEL
from repro_torch.core.workloads import MODE_WRITE

_I64 = np.int64


@dataclasses.dataclass
class BatchSchedule:
    """Engine-ready batch plan for dgcc / quecc.

    All ``N`` indices are positions in the planned workload array (the
    serial order the planner fixes); batches are contiguous runs of
    ``batch_epoch`` transactions.
    """

    n_txns: int
    batch_epoch: int
    batch_of: np.ndarray  # int32[N] batch id of each txn
    batch_start: np.ndarray  # int32[NB] first txn of each batch
    batch_size: np.ndarray  # int32[NB]
    plan_ops: np.ndarray  # int32[NB] key-ops planned per batch (cost model)
    level: np.ndarray  # int32[N] wavefront level within the batch
    npred: np.ndarray  # int32[N] in-degree (direct dependencies)
    edge_dst: np.ndarray  # int32[E] dependent txn, sorted ascending
    edge_src: np.ndarray  # int32[E] dependency txn (same batch, src < dst)
    pred_pad: np.ndarray  # int32[N, P] direct predecessors, -1 padded
    # QueCC only: per-(txn, lane) queue membership with position stamps.
    queue_txn: np.ndarray | None = None  # int32[Q]
    queue_lane: np.ndarray | None = None  # int32[Q]
    queue_pos: np.ndarray | None = None  # int32[Q] 0-based within the queue
    # Scheduled family only (``kind="cluster"``): batch-local dense
    # cluster id per txn (numbered by smallest member), the execution
    # lane its cluster queue drains on, per-batch cluster counts, and
    # the conflict edges the clusterer *scanned* to union components
    # (the cost-model work term — the executed chain edges above are a
    # subset, one per non-head cluster member).
    cluster_of: np.ndarray | None = None  # int32[N]
    cluster_lane: np.ndarray | None = None  # int32[N] cluster % n_lanes
    batch_nclusters: np.ndarray | None = None  # int32[NB]
    scan_edges: np.ndarray | None = None  # int64[NB] edges scanned
    # Fragment granularity (``fragments=True``): fragment f is txn
    # ``frag_txn[f]``'s work on lane ``frag_lane[f]``; ids are admission
    # order — sorted by (batch, level, txn, lane), so predecessors
    # always precede their dependents.
    frag_txn: np.ndarray | None = None  # int32[F]
    frag_lane: np.ndarray | None = None  # int32[F]
    frag_nkeys: np.ndarray | None = None  # int32[F] planned key-ops
    frag_first: np.ndarray | None = None  # bool[F] holds txn's first key
    frag_level: np.ndarray | None = None  # int32[F] wavefront level
    frag_npred: np.ndarray | None = None  # int32[F]
    frag_edge_dst: np.ndarray | None = None  # int32[EF], sorted ascending
    frag_edge_src: np.ndarray | None = None  # int32[EF]
    frag_pred_pad: np.ndarray | None = None  # int32[F, PF], -1 padded
    txn_nfrags: np.ndarray | None = None  # int32[N] commit-barrier width
    batch_fstart: np.ndarray | None = None  # int32[NB] first fragment
    batch_fsize: np.ndarray | None = None  # int32[NB]
    lvl0_fcount: np.ndarray | None = None  # int32[NB] level-0 prefix len

    @property
    def num_batches(self) -> int:
        return len(self.batch_start)

    def edges_per_batch(self) -> np.ndarray:
        """int64[NB]: dependency edges planned into each batch.

        Edges never cross batches (both edge builders segment on the
        batch id), so an edge's batch is its dependent's batch. This is
        the conflict-graph size term of the planner-lane throughput
        model (``CostModel.planner_batch_cycles``): a high-contention
        batch has long last-writer chains and therefore more planner
        work per transaction than a uniform one.
        """
        return np.bincount(
            self.batch_of[self.edge_dst], minlength=self.num_batches
        ).astype(np.int64)

    def frag_edges_per_batch(self) -> np.ndarray:
        """int64[NB]: fragment-granular dependency edges per batch
        (requires ``fragments=True`` at build time)."""
        assert self.frag_edge_dst is not None, (
            "schedule built without fragments"
        )
        return np.bincount(
            self.batch_of[self.frag_txn[self.frag_edge_dst]],
            minlength=self.num_batches,
        ).astype(np.int64)

    @property
    def n_levels(self) -> int:
        return int(self.level.max()) + 1 if self.n_txns else 0

    @property
    def n_frags(self) -> int:
        assert self.frag_txn is not None, "schedule built without fragments"
        return len(self.frag_txn)


# ---------------------------------------------------------------------------
# segmented prefix helpers (host-side numpy, fully vectorized)
# ---------------------------------------------------------------------------
def _seg_last_true_before(seg_start: np.ndarray, flag: np.ndarray):
    """For each position i, index of the last ``flag`` position strictly
    before i within i's segment, or -1.

    ``seg_start`` marks segment beginnings over an array sorted so that
    each segment is contiguous.
    """
    m = len(seg_start)
    if m == 0:
        return np.full(0, -1, _I64)
    idx = np.arange(m, dtype=_I64)
    seg_id = np.cumsum(seg_start, dtype=_I64) - 1
    # Monotone score: segment base dominates anything from earlier segments.
    score = seg_id * (m + 1) + np.where(flag, idx + 1, 0)
    acc = np.maximum.accumulate(score)
    acc_excl = np.concatenate([[_I64(-1)], acc[:-1]])
    rel = acc_excl - seg_id * (m + 1)
    valid = rel > 0  # a flagged position exists before i in this segment
    return np.where(valid, rel - 1, -1)


def _seg_next_true_after(seg_start: np.ndarray, flag: np.ndarray):
    """Mirror of ``_seg_last_true_before`` looking forward in the segment."""
    m = len(seg_start)
    if m == 0:
        return np.full(0, -1, _I64)
    # Segment starts of the reversed array are the segment *ends*.
    seg_end = np.concatenate([seg_start[1:], [True]])
    rev = _seg_last_true_before(seg_end[::-1], flag[::-1])
    return np.where(rev >= 0, m - 1 - rev, -1)[::-1]


def _dedupe_edges(dst: np.ndarray, src: np.ndarray):
    """Unique (dst, src) pairs with self-edges removed, sorted by dst."""
    keep = (dst >= 0) & (src >= 0) & (dst != src)
    dst, src = dst[keep], src[keep]
    packed = dst.astype(_I64) << 32 | src.astype(_I64)
    packed = np.unique(packed)
    return (packed >> 32).astype(np.int32), (packed & 0xFFFFFFFF).astype(
        np.int32
    )


# ---------------------------------------------------------------------------
# edge builders
# ---------------------------------------------------------------------------
def _flatten_ops(keys, nkeys, *cols):
    """Flatten padded [N, K] access arrays to the valid entries.

    Returns ``(txn, key, *cols_flattened)`` — one row per planned
    access, every extra ``cols`` array flattened by the same mask.
    """
    n, k = keys.shape
    valid = (np.arange(k)[None, :] < nkeys[:, None]) & (
        keys != int(KEY_SENTINEL)
    )
    txn = np.broadcast_to(np.arange(n, dtype=_I64)[:, None], (n, k))[valid]
    return (txn, keys[valid].astype(_I64)) + tuple(c[valid] for c in cols)


def _lane_of(part_flat, n_lanes: int):
    """Planner lane of an access: ``part % n_lanes``. The single
    definition of fragment/queue identity — ``queue_edges`` chains and
    ``build_fragments`` partitions by exactly this value."""
    return part_flat.astype(_I64) % max(n_lanes, 1)


def _conflict_chain_edges(owner, key, mode, batch):
    """Last-writer-chain edges between access *owners* inside a batch.

    ``owner`` is the schedulable unit of each flattened access — txn id
    for whole-transaction granularity, fragment id for fragment
    granularity. Owner ids must ascend with the planner's serial order
    on every key (true for txns, and for fragments because a key lives
    on exactly one lane and fragment ids are txn-major)."""
    order = np.lexsort((owner, key, batch))
    own_s, key_s, batch_s = owner[order], key[order], batch[order]
    is_write = mode[order] == MODE_WRITE
    seg_start = np.concatenate(
        [[True], (key_s[1:] != key_s[:-1]) | (batch_s[1:] != batch_s[:-1])]
    )
    # RAW / WAW: access -> last write before it on the key.
    lastw = _seg_last_true_before(seg_start, is_write)
    e1_dst = np.where(lastw >= 0, own_s, -1)
    e1_src = np.where(lastw >= 0, own_s[np.maximum(lastw, 0)], -1)
    # WAR: read -> next write after it on the key (that write depends on us).
    nextw = _seg_next_true_after(seg_start, is_write)
    war = (nextw >= 0) & ~is_write
    e2_dst = np.where(war, own_s[np.maximum(nextw, 0)], -1)
    e2_src = np.where(war, own_s, -1)
    return _dedupe_edges(
        np.concatenate([e1_dst, e2_dst]), np.concatenate([e1_src, e2_src])
    )


def conflict_edges(keys, modes, nkeys, batch_of):
    """DGCC record-level conflict edges (dst depends on src; src < dst)."""
    txn, key, mode = _flatten_ops(keys, nkeys, modes)
    return _conflict_chain_edges(txn, key, mode, batch_of[txn].astype(_I64))


def queue_edges(keys, part, nkeys, batch_of, n_lanes: int):
    """QueCC per-lane queue chains.

    Returns (edge_dst, edge_src, queue_txn, queue_lane, queue_pos): each
    transaction depends on the transaction immediately before it in every
    per-(batch, lane) execution queue it belongs to.
    """
    txn, _key, lane_part = _flatten_ops(keys, nkeys, part)
    lane = _lane_of(lane_part, n_lanes)
    # dedupe (txn, lane) memberships
    packed = np.unique(txn << 32 | lane)
    txn_u = (packed >> 32).astype(_I64)
    lane_u = (packed & 0xFFFFFFFF).astype(_I64)
    batch_u = batch_of[txn_u].astype(_I64)
    order = np.lexsort((txn_u, lane_u, batch_u))
    txn_s, lane_s, batch_s = txn_u[order], lane_u[order], batch_u[order]
    seg_start = np.concatenate(
        [[True], (lane_s[1:] != lane_s[:-1]) | (batch_s[1:] != batch_s[:-1])]
    )
    # chain: previous queue member
    prev = np.where(seg_start, -1, np.concatenate([[-1], txn_s[:-1]]))
    dst, src = _dedupe_edges(
        np.where(prev >= 0, txn_s, -1), prev
    )
    # queue position stamps (0-based within each (batch, lane) queue)
    seg_id = np.cumsum(seg_start) - 1
    first_idx = np.where(seg_start)[0]
    pos = np.arange(len(txn_s), dtype=_I64) - first_idx[seg_id]
    return (
        dst,
        src,
        txn_s.astype(np.int32),
        lane_s.astype(np.int32),
        pos.astype(np.int32),
    )


def cluster_components_np(n: int, edge_dst, edge_src):
    """Smallest member id of each txn's conflict-connected component.

    Vectorized union-find equivalent: min-label propagation across the
    edge list with pointer-jumping compression between sweeps. Batches
    are independent subgraphs (edges never cross batches), so one call
    labels them all. ``cost_model.cluster_components`` is the
    pure-python oracle this is pinned against.
    """
    label = np.arange(n, dtype=_I64)
    if len(edge_dst) == 0:
        return label
    dst = np.asarray(edge_dst, _I64)
    src = np.asarray(edge_src, _I64)
    while True:
        prev = label.copy()
        m = np.minimum(label[dst], label[src])
        np.minimum.at(label, dst, m)
        np.minimum.at(label, src, m)
        while True:
            nxt = label[label]
            if np.array_equal(nxt, label):
                break
            label = nxt
        if np.array_equal(label, prev):
            return label


def cluster_edges(keys, modes, nkeys, batch_of, n_batches: int,
                  n_lanes: int):
    """Scheduled-family cluster chains (Prasaad et al., 1810.01997).

    Builds the full record-level conflict graph, unions it into
    conflict-connected components, and chains each component's members
    in admission (id) order — so ``npred <= 1`` everywhere, within-
    cluster txns serialize in submission order, and cross-cluster txns
    never wait on each other. Returns ``(edge_dst, edge_src,
    cluster_of, cluster_lane, batch_nclusters, scan_edges)``; cluster
    ids are batch-local and numbered by smallest member, lanes are
    ``cluster_of % n_lanes``.
    """
    n = keys.shape[0]
    if n == 0:
        z32 = np.zeros(0, np.int32)
        znb = np.zeros(n_batches, np.int32)
        return z32, z32, z32, z32, znb, znb.astype(_I64)
    cdst, csrc = conflict_edges(keys, modes, nkeys, batch_of)
    scan_edges = np.bincount(
        batch_of[cdst].astype(_I64), minlength=n_batches
    ).astype(_I64)
    root = cluster_components_np(n, cdst, csrc)
    # batch-local dense cluster ids, numbered by smallest member (the
    # root *is* the min member, so first-appearance order = root order)
    is_head = root == np.arange(n, dtype=_I64)
    cum = np.cumsum(is_head)
    gid = cum[root] - 1  # global dense id
    # first txn of each batch (roots never cross batches, so the head
    # count strictly before it localizes gid to the batch)
    batch_start = np.searchsorted(batch_of, np.arange(n_batches))
    heads_before = cum[batch_start] - is_head[batch_start]
    cluster_of = (gid - heads_before[batch_of]).astype(np.int32)
    cluster_lane = (cluster_of % max(n_lanes, 1)).astype(np.int32)
    batch_nclusters = np.bincount(
        batch_of[is_head].astype(_I64), minlength=n_batches
    ).astype(np.int32)
    # chain each component in id order: stable sort groups members
    # ascending within their root group
    order = np.argsort(root, kind="stable").astype(_I64)
    r_s = root[order]
    seg_start = np.concatenate([[True], r_s[1:] != r_s[:-1]])
    prev = np.where(seg_start, _I64(-1), np.concatenate([[_I64(-1)], order[:-1]]))
    edge_dst, edge_src = _dedupe_edges(
        np.where(prev >= 0, order, -1), prev
    )
    return (
        edge_dst, edge_src, cluster_of, cluster_lane, batch_nclusters,
        scan_edges,
    )


# ---------------------------------------------------------------------------
# fragments: (txn, lane) units + fragment-level dependency graph
# ---------------------------------------------------------------------------
def build_fragments(
    keys, modes, part, nkeys, batch_of, n_batches: int, n_lanes: int,
    kind: str,
) -> dict:
    """Fragment table + fragment-granular dependency graph.

    A fragment is one transaction's planned work on one lane
    (``lane = part % n_lanes``). Returned fragment ids are *admission
    order* — sorted by (batch, level, txn, lane) — so a fragment's
    predecessors always carry smaller ids (levels strictly ascend along
    edges), which the engine relies on: an admitted fragment's
    predecessors are already admitted or committed, and the pipelined
    level-0 prefix of each batch is contiguous.

    kind = 'conflict': record-level last-writer chains between the
    fragments owning the accesses (every key lives on one lane, so
    these edges never cross lanes). kind = 'lane': QueCC queue chains —
    each fragment depends on the previous fragment in its per-(batch,
    lane) execution queue.
    """
    n = keys.shape[0]
    txn, key, mode, lane_part = _flatten_ops(keys, nkeys, modes, part)
    lane = _lane_of(lane_part, n_lanes)
    packed = np.unique(txn << 32 | lane)
    # every txn owns >= 1 fragment (the commit barrier needs a non-zero
    # fragment count): txns with an empty access set get one on lane 0
    nfrags = np.bincount(packed >> 32, minlength=n)
    empty_txns = np.where(nfrags == 0)[0].astype(_I64)
    if len(empty_txns):
        packed = np.unique(np.concatenate([packed, empty_txns << 32]))
    ftxn = (packed >> 32).astype(np.int64)
    flane = (packed & 0xFFFFFFFF).astype(np.int64)
    F = len(packed)
    facc = np.searchsorted(packed, txn << 32 | lane)  # fragment per access
    fnkeys = np.bincount(facc, minlength=F)
    txn_nfrags = np.bincount(ftxn, minlength=n)
    # the fragment holding each txn's first planned key carries the
    # txn's non-keyed executable ops (e.g. TPC-C Item reads)
    ffirst = np.zeros(F, bool)
    if len(txn):
        _u, first_idx = np.unique(txn, return_index=True)
        ffirst[facc[first_idx]] = True
    if len(empty_txns):
        ffirst[np.searchsorted(packed, empty_txns << 32)] = True
    fbatch = batch_of[ftxn].astype(_I64)

    if kind == "conflict":
        e_dst, e_src = _conflict_chain_edges(
            facc.astype(_I64), key, mode, batch_of[txn].astype(_I64)
        )
    elif kind == "lane":
        # queue chain: previous fragment in the (batch, lane) queue.
        # Fragment ids are txn-major, so plain id order is queue order.
        # Placeholder fragments of empty txns never enter a queue (they
        # run immediately, commit-only).
        rid = np.where(fnkeys > 0)[0].astype(_I64)
        order = np.lexsort((ftxn[rid], flane[rid], fbatch[rid]))
        f_s = rid[order]
        if len(f_s):
            lane_s, batch_s = flane[f_s], fbatch[f_s]
            seg_start = np.concatenate(
                [[True],
                 (lane_s[1:] != lane_s[:-1]) | (batch_s[1:] != batch_s[:-1])]
            )
            prev = np.where(seg_start, -1, np.concatenate([[-1], f_s[:-1]]))
            e_dst, e_src = _dedupe_edges(
                np.where(prev >= 0, f_s, -1), prev
            )
        else:
            e_dst = e_src = np.zeros(0, np.int32)
    else:
        raise ValueError(f"unknown schedule kind: {kind}")

    level = wavefront_levels(F, e_dst, e_src)
    # admission order: batch-major, level-major, txn-minor
    perm = np.lexsort((flane, ftxn, level, fbatch))
    newid = np.empty(F, _I64)
    newid[perm] = np.arange(F, dtype=_I64)
    e_dst, e_src = _dedupe_edges(newid[e_dst], newid[e_src])
    pred_pad, npred = _pred_pad(F, e_dst, e_src)
    fbatch_s = fbatch[perm]
    level_s = level[perm].astype(np.int32)
    batch_fstart = np.searchsorted(fbatch_s, np.arange(n_batches)).astype(
        np.int32
    )
    batch_fsize = np.diff(np.concatenate([batch_fstart, [F]])).astype(
        np.int32
    )
    lvl0_fcount = np.bincount(
        fbatch_s[level_s == 0], minlength=n_batches
    ).astype(np.int32)
    return dict(
        frag_txn=ftxn[perm].astype(np.int32),
        frag_lane=flane[perm].astype(np.int32),
        frag_nkeys=fnkeys[perm].astype(np.int32),
        frag_first=ffirst[perm],
        frag_level=level_s,
        frag_npred=npred,
        frag_edge_dst=e_dst,
        frag_edge_src=e_src,
        frag_pred_pad=pred_pad,
        txn_nfrags=txn_nfrags.astype(np.int32),
        batch_fstart=batch_fstart,
        batch_fsize=batch_fsize,
        lvl0_fcount=lvl0_fcount,
    )


# ---------------------------------------------------------------------------
# wavefront levels (vectorized Kahn over all batches at once)
# ---------------------------------------------------------------------------
def wavefront_levels(n_txns: int, edge_dst, edge_src):
    """Longest-path level per transaction (0 = no uncommitted predecessor).

    Batches are independent subgraphs, so one Kahn sweep levels them all
    simultaneously; iteration count = deepest batch's level count.
    """
    level = np.zeros(n_txns, np.int32)
    remaining = np.bincount(edge_dst, minlength=n_txns).astype(np.int64)
    if len(edge_dst) == 0:
        return level
    by_src = np.argsort(edge_src, kind="stable")
    src_sorted = edge_src[by_src]
    dst_by_src = edge_dst[by_src]
    src_ptr = np.searchsorted(src_sorted, np.arange(n_txns + 1))
    frontier = np.where(remaining == 0)[0]
    lvl = 0
    while frontier.size:
        level[frontier] = lvl
        starts, ends = src_ptr[frontier], src_ptr[frontier + 1]
        counts = ends - starts
        total = int(counts.sum())
        if total == 0:
            break
        base = np.repeat(starts, counts)
        offs = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        dsts = dst_by_src[base + offs]
        np.subtract.at(remaining, dsts, 1)
        frontier = np.unique(dsts[remaining[dsts] == 0])
        lvl += 1
    assert (remaining == 0).all(), "dependency graph has a cycle"
    return level


def _pred_pad(n_txns: int, edge_dst, edge_src):
    """Dense [N, P] direct-predecessor table (-1 padded), P = max in-degree.

    This is the layout the engine's jitted round loop gathers from; it is
    exactly the CSR edge list the ``dep_wavefront`` kernel consumes, padded
    square (equivalence is property-tested).
    """
    npred = np.bincount(edge_dst, minlength=n_txns).astype(np.int32)
    p = max(int(npred.max()) if len(edge_dst) else 0, 1)
    pad = np.full((n_txns, p), -1, np.int32)
    if len(edge_dst):
        # edge_dst is sorted; position within its run:
        first = np.searchsorted(edge_dst, edge_dst)
        col = np.arange(len(edge_dst)) - first
        pad[edge_dst, col] = edge_src
    return pad, npred


# ---------------------------------------------------------------------------
# schedule construction
# ---------------------------------------------------------------------------
def build_schedule(
    keys,
    modes,
    part,
    nkeys,
    batch_epoch: int,
    *,
    kind: str = "conflict",
    n_lanes: int = 1,
    fragments: bool = False,
) -> BatchSchedule:
    """Plan a workload into batches and build its dependency schedule.

    kind = 'conflict' (DGCC record-level graph), 'lane' (QueCC per-lane
    queues over ``n_lanes`` planner lanes), or 'cluster' (the scheduled
    family's union-find component chains over ``n_lanes`` *execution*
    lanes — see :func:`cluster_edges`; fragments do not apply).
    ``fragments=True`` additionally builds the fragment table and
    fragment-granular graph (see :func:`build_fragments`) for the
    engine's per-lane fragment execution mode.
    """
    n = keys.shape[0]
    b = max(int(batch_epoch), 1)
    batch_of = (np.arange(n, dtype=np.int64) // b).astype(np.int32)
    nb = int(batch_of[-1]) + 1 if n else 0
    batch_start = (np.arange(nb, dtype=np.int64) * b).astype(np.int32)
    batch_size = np.minimum(b, n - batch_start).astype(np.int32)
    plan_ops = np.bincount(batch_of, weights=nkeys, minlength=nb).astype(
        np.int32
    )

    queue_txn = queue_lane = queue_pos = None
    cluster_kw = {}
    if kind == "conflict":
        edge_dst, edge_src = conflict_edges(keys, modes, nkeys, batch_of)
    elif kind == "lane":
        edge_dst, edge_src, queue_txn, queue_lane, queue_pos = queue_edges(
            keys, part, nkeys, batch_of, n_lanes
        )
    elif kind == "cluster":
        assert not fragments, "cluster scheduling is txn-granular"
        (edge_dst, edge_src, cluster_of, cluster_lane, batch_nclusters,
         scan_edges) = cluster_edges(
            keys, modes, nkeys, batch_of, nb, n_lanes
        )
        cluster_kw = dict(
            cluster_of=cluster_of, cluster_lane=cluster_lane,
            batch_nclusters=batch_nclusters, scan_edges=scan_edges,
        )
    else:
        raise ValueError(f"unknown schedule kind: {kind}")

    level = wavefront_levels(n, edge_dst, edge_src)
    pred_pad, npred = _pred_pad(n, edge_dst, edge_src)
    frag_kw = (
        build_fragments(
            keys, modes, part, nkeys, batch_of, nb, n_lanes, kind
        )
        if fragments
        else {}
    )
    return BatchSchedule(
        **frag_kw,
        **cluster_kw,
        n_txns=n,
        batch_epoch=b,
        batch_of=batch_of,
        batch_start=batch_start,
        batch_size=batch_size,
        plan_ops=plan_ops,
        level=level,
        npred=npred,
        edge_dst=edge_dst,
        edge_src=edge_src,
        pred_pad=pred_pad,
        queue_txn=queue_txn,
        queue_lane=queue_lane,
        queue_pos=queue_pos,
    )


# ---------------------------------------------------------------------------
# host-side oracle
# ---------------------------------------------------------------------------
def simulate_wavefronts(sched: BatchSchedule) -> np.ndarray:
    """Commit order of an idealized wavefront execution (batch-major,
    level-major, txn-minor).

    The deadlock-free oracle: every transaction commits exactly once, in an
    order equivalent to the serial order the planner fixed. Tests compare
    the engine's committed set against this.
    """
    return np.lexsort(
        (
            np.arange(sched.n_txns),
            sched.level,
            sched.batch_of,
        )
    ).astype(np.int32)
