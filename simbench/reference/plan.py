"""The plain reference planners: from a generated workload to the arrays
the reference step reads, written out again in loops that follow the
paper's definitions, independent of the port's vectorized planner.

* ``orthrus``: each transaction's keys in (CC lane, key) order, the CC
  lane of a key its partition id modulo ``n_cc``; then the record ids
  remapped to dense ids in a power-of-two lock table.
* ``deadlock_free``: each transaction's keys in ascending order, remapped
  the same way; the dynamic-2PL protocols keep program order and clear
  the OLLP flags.
* ``dgcc``: program order, split into batches of ``batch_epoch``; inside a
  batch, an access depends on the last earlier write of its record, and
  a write on every read of its record since that write (read-after-write,
  write-after-write and write-after-read), a transaction never on
  itself. Each batch's planning takes ``batch_plan_cycles_per_op`` a
  key-op plus ``recon_cycles`` a reconnaissance, shared by ``n_cc``
  planner lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from simbench.reference.engine import KEY_SENTINEL, MODE_WRITE, Config, Meta


@dataclasses.dataclass
class LockPlan:
    """What the lock-table step reads (``p``) and its shapes."""

    p: dict
    meta: Meta


@dataclasses.dataclass
class BatchPlan:
    """What the batch step reads (``p``), its shapes, and the per-batch
    sizes and planning rounds its initial state takes."""

    p: dict
    meta: Meta
    n_txns: int
    batch_size: np.ndarray
    plan_rounds: np.ndarray


def _key_order(keys: np.ndarray, sort_key) -> np.ndarray:
    """Per row, the column order that sorts by ``sort_key(row, col)``,
    ties in column order."""
    n, k = keys.shape
    order = np.empty((n, k), np.int64)
    for i in range(n):
        order[i] = sorted(range(k), key=lambda j: (sort_key(i, j), j))
    return order


def _compact(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """Record ids -> dense ids in ascending order of the ids, padding kept
    as the sentinel; the table is padded to a power of two of at least
    1.25 times the records used (and at least 16)."""
    live = keys != KEY_SENTINEL
    uniq = np.unique(keys[live])
    dense = np.where(live, np.searchsorted(uniq, keys), KEY_SENTINEL)
    num = max(len(uniq), 1)
    r_pad = max(16, 1 << (num + (num >> 2) - 1).bit_length())
    return dense.astype(np.int32), r_pad


def _lock_plan(w: dict, order, clear_ollp: bool) -> LockPlan:
    take = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
    keys, r_pad = _compact(take(w["keys"]))
    n = keys.shape[0]
    ollp = np.zeros(n, bool) if clear_ollp else w["ollp"]
    miss = np.zeros(n, bool) if clear_ollp else w["ollp_miss"]
    p = dict(
        keys=keys,
        modes=take(w["modes"]).astype(np.int32),
        part=take(w["part"]).astype(np.int32),
        nkeys=w["nkeys"].astype(np.int32),
        exec_ops=w["exec_ops"].astype(np.int32),
        ollp=ollp,
        ollp_miss=miss,
    )
    return LockPlan(p, Meta(n_txns=n, max_keys=keys.shape[1],
                            num_records=r_pad))


def plan_lock_table(cfg: Config, w: dict) -> LockPlan:
    keys = w["keys"]
    n, k = keys.shape
    if cfg.protocol == "orthrus":
        n_cc = cfg.n_cc

        def sort_key(i, j):
            if keys[i, j] == KEY_SENTINEL:
                return (1 << 62, 0)
            return (int(w["part"][i, j]) % n_cc, int(keys[i, j]))

        return _lock_plan(w, _key_order(keys, sort_key), clear_ollp=False)
    if cfg.protocol == "deadlock_free":
        return _lock_plan(
            w, _key_order(keys, lambda i, j: int(keys[i, j])),
            clear_ollp=False)
    if cfg.is_dynamic_2pl:
        order = np.broadcast_to(np.arange(k), (n, k))
        return _lock_plan(w, order, clear_ollp=True)
    raise ValueError(f"the reference plans no {cfg.protocol!r}")


def conflict_preds(keys, modes, nkeys, batch_epoch: int) -> list[set]:
    """Each transaction's direct predecessors in its batch."""
    n = keys.shape[0]
    preds: list[set] = [set() for _ in range(n)]
    last_write: dict = {}
    readers: dict = {}
    for i in range(n):
        if i % batch_epoch == 0:  # a new batch: no edge crosses batches
            last_write, readers = {}, {}
        for j in range(int(nkeys[i])):
            key = int(keys[i, j])
            if key == KEY_SENTINEL:
                continue
            w = last_write.get(key)
            if w is not None and w != i:
                preds[i].add(w)
            if int(modes[i, j]) == MODE_WRITE:
                for rd in readers.pop(key, ()):
                    if rd != i:
                        preds[i].add(rd)
                last_write[key] = i
            else:
                readers.setdefault(key, []).append(i)
    return preds


def plan_dgcc(cfg: Config, w: dict, batch_epoch: int) -> BatchPlan:
    keys, modes, nkeys = w["keys"], w["modes"], w["nkeys"]
    n = keys.shape[0]
    preds = conflict_preds(keys, modes, nkeys, batch_epoch)
    npred = np.array([len(x) for x in preds], np.int32)
    width = max(int(npred.max()) if n else 0, 1)
    pred_pad = np.full((n, width), -1, np.int32)
    for i, ps in enumerate(preds):
        pred_pad[i, :len(ps)] = sorted(ps)
    nb = -(-n // batch_epoch)
    batch_of = (np.arange(n) // batch_epoch).astype(np.int32)
    batch_start = (np.arange(nb) * batch_epoch).astype(np.int32)
    batch_size = np.minimum(batch_epoch, n - batch_start).astype(np.int32)
    cm = cfg.cost
    plan_rounds = np.zeros(nb, np.int32)
    for b in range(nb):
        rows = slice(int(batch_start[b]), int(batch_start[b] + batch_size[b]))
        ops = int(nkeys[rows].sum())
        recon = int(w["ollp"][rows].sum())
        cycles = (ops * cm.batch_plan_cycles_per_op
                  + recon * cm.recon_cycles) // max(cfg.n_cc, 1)
        plan_rounds[b] = cm.rounds(cycles)
    p = dict(
        exec_ops=w["exec_ops"].astype(np.int32),
        npred=npred,
        pred_pad=pred_pad,
        batch_of=batch_of,
        batch_start=batch_start,
        batch_size=batch_size,
        plan_rounds=plan_rounds,
    )
    meta = Meta(n_txns=n, max_keys=keys.shape[1], num_records=w["num_records"],
                num_batches=nb)
    return BatchPlan(p, meta, n, batch_size, plan_rounds)


def make_plan(cfg: Config, w: dict, batch_epoch: int):
    """The reference's plan of workload ``w`` (a dict of the generated
    arrays) for ``cfg``'s protocol."""
    if cfg.protocol == "dgcc":
        return plan_dgcc(cfg, w, batch_epoch)
    return plan_lock_table(cfg, w)
