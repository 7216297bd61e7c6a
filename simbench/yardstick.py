"""The yardstick the per-layer readers measure against: the chip's peaks
and the least bytes each hand-written kernel of the simulator must move
at the shapes of its launch. Frozen here, so that a change to a kernel
cannot move its own roofline.

The peaks are NVIDIA's data-sheet figures for one H100 SXM at its full
700 W power limit (dense rates).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def lock_grant_step_bytes(n_slots: int, max_keys: int) -> int:
    """B1, ``lock_grant_step_kernel``: the fused grant pass of one round
    over the T x K lock entries reads each entry's key, mode, stamp and
    pending flag (13 B) and writes its grant (1 B). The table gathers of
    the pending entries (8 B each) depend on the round and are left out,
    so this is a lower bound on the bytes of every launch."""
    return n_slots * max_keys * (13 + 1)


def dep_wavefront_rows_bytes(n_slots: int, pred_width: int) -> int:
    """B2, ``dep_wavefront_rows_kernel``: the row form of the wavefront
    check reads each slot's P predecessor ids (4 B each) and its unit
    (4 B) and writes its verdict (1 B). The committed flags gathered for
    live edges (1 B each) depend on the round and are left out, so this
    is a lower bound on the bytes of every launch."""
    return n_slots * pred_width * 4 + n_slots * 4 + n_slots


def least_seconds(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S
