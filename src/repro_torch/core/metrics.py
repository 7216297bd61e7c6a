"""Host-side metrics layer: latency histograms and queue trajectories.

The engine carries two kinds of in-simulation observability state (see
``repro_torch.core.engine``):

  * a log-bucketed commit-latency histogram ``lat_hist`` ([LAT_BUCKETS]
    int32 counter): each committing transaction scatter-adds into the
    bucket of its latency ``commit_round - arrive_round``, where the
    arrival round is stamped in the ``C_ARRIVE`` / ``BC_ARRIVE`` slot
    row at admission (the txn's *epoch arrival* round under open
    arrival, so queueing delay is part of the latency — the quantity
    that produces the fig16 hockey-stick — and the admission round
    under closed loop);
  * queue-depth trajectories ``q_depth`` / ``q_inflight``
    ([QDEPTH_SAMPLES] int32): admission backlog (arrived-but-unadmitted
    transactions; open arrival only) and occupied exec slots, sampled
    on a fixed round grid so cells of any round budget share one state
    shape.

Bucketing is exact integer arithmetic — bucket ``b`` of latency ``L``
is the number of powers of two ``<= L`` (bucket 0 holds {0}, bucket b
holds [2^(b-1), 2^b - 1], the last bucket is open-ended) — so the
histogram is bit-identical between the dense and event-leaping loops
and between vmapped and serial execution. Everything in this module is
plain numpy on host-side counter snapshots.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# Log-bucket count for the commit-latency histogram. 24 buckets cover
# latencies up to 2^22 rounds open-ended — beyond any simulated budget.
LAT_BUCKETS = 24

# Fixed per-cell sample count for the queue-depth grid. The sample
# *interval* is a traced per-cell scalar (ceil(max_rounds / S)), so
# cells that differ only in round budget still share one compiled
# runner and one state shape.
QDEPTH_SAMPLES = 512

# Extended Fig-10 breakdown category order: the engine's exec-lane
# categories plus the planner-lane busy fraction.
BREAKDOWN_EXT_NAMES = (
    "idle", "exec", "lock", "wait", "deadlock", "msg", "plan",
)


def bucket_edges() -> np.ndarray:
    """Lower edge (inclusive, in rounds) of each histogram bucket."""
    edges = np.concatenate(
        [[0], 2 ** np.arange(LAT_BUCKETS - 1, dtype=np.int64)]
    )
    return edges


def bucket_index(lat) -> np.ndarray:
    """Bucket of each latency value — the host mirror of the engine's
    in-round scatter index (count of powers of two <= lat).

    >>> bucket_index([0, 1, 2, 3, 4, 7, 8, 1023, 1024]).tolist()
    [0, 1, 2, 2, 3, 3, 4, 10, 11]
    """
    lat = np.asarray(lat, np.int64)
    pows = 2 ** np.arange(LAT_BUCKETS - 1, dtype=np.int64)
    return (lat[..., None] >= pows).sum(axis=-1)


def percentile_from_hist(hist, q: float) -> int:
    """The q-quantile latency from a bucketed histogram, reported as the
    lower edge of the bucket containing the quantile rank.

    The rank is ``ceil(q * total)`` (1-based), i.e. the smallest latency
    with at least a ``q`` fraction of commits at or below it — the
    inverted-CDF definition, which is exact (no interpolation) so the
    result is reproducible bit-for-bit from the integer counters.

    >>> percentile_from_hist([0, 10, 0, 0, 90], 0.5)
    8
    >>> percentile_from_hist([0, 10, 0, 0, 90], 0.05)
    1
    >>> percentile_from_hist([5], 0.99)
    0
    >>> percentile_from_hist(np.zeros(4), 0.5)
    0
    """
    hist = np.asarray(hist, np.int64)
    total = int(hist.sum())
    if total <= 0:
        return 0
    rank = max(int(np.ceil(q * total)), 1)
    b = int(np.searchsorted(np.cumsum(hist), rank))
    edges = np.concatenate(
        [[0], 2 ** np.arange(len(hist) - 1, dtype=np.int64)]
    )
    return int(edges[min(b, len(hist) - 1)])


@dataclasses.dataclass
class Metrics:
    """Structured per-cell metrics, assembled host-side by
    ``repro_torch.core.sweep`` from the measured (warmup-subtracted) counter
    snapshots. Latencies are in rounds; multiply by
    ``CostModel.round_seconds`` for wall-clock."""

    lat_hist: np.ndarray  # [LAT_BUCKETS] commit-latency histogram
    lat_edges: np.ndarray  # [LAT_BUCKETS] bucket lower edges (rounds)
    p50: int  # bucketed percentile latencies (rounds)
    p99: int
    p999: int
    q_grid: np.ndarray  # [QDEPTH_SAMPLES] sample rounds
    q_depth: np.ndarray  # [S] admission backlog at each sample round
    q_inflight: np.ndarray  # [S] occupied exec slots at each sample round
    # Fig-10 breakdown extended with the planner-lane category:
    # fractions over (n_exec + n_planner_lanes) lane-rounds.
    breakdown_ext: dict[str, float]
    # Goodput split under the overload-robustness layer (all counts over
    # the measurement window): committed <= admitted <= offered.
    # ``offered`` is the arrival schedule's output (== admitted under a
    # closed loop); ``admitted`` excludes queue-side policy drops
    # (rejected / shed); ``timedout`` / ``sacrificed`` are
    # admitted-but-given-up transactions. All zero when the layer is off.
    committed: int = 0
    admitted: int = 0
    offered: int = 0
    rejected: int = 0
    shed: int = 0
    timedout: int = 0
    sacrificed: int = 0

    @property
    def goodput_frac(self) -> float:
        """Committed fraction of offered load (1.0 when nothing was
        offered — closed loop with no commits yet)."""
        return self.committed / self.offered if self.offered > 0 else 1.0

    def summary_row(self) -> dict[str, Any]:
        """JSON-friendly scalar digest for benchmark result rows."""
        row = dict(
            p50_rounds=self.p50,
            p99_rounds=self.p99,
            p999_rounds=self.p999,
            backlog_max=int(np.max(self.q_depth, initial=0)),
            breakdown_ext={k: float(v)
                           for k, v in self.breakdown_ext.items()},
        )
        if self.offered > 0:
            # emitted only for open-arrival cells, so pre-layer result
            # rows (and their cached benchmark hashes) keep their shape
            row.update(
                offered=self.offered,
                admitted=self.admitted,
                committed=self.committed,
                goodput_frac=round(self.goodput_frac, 6),
                rejected=self.rejected,
                shed=self.shed,
                timedout=self.timedout,
                sacrificed=self.sacrificed,
            )
        return row


def build_metrics(
    lat_hist,
    q_depth,
    q_inflight,
    q_grid,
    breakdown: dict[str, float],
    exec_lane_rounds: int,
    plan_busy_rounds: int,
    plan_lane_rounds: int,
    committed: int = 0,
    admitted: int = 0,
    offered: int = 0,
    rejected: int = 0,
    shed: int = 0,
    timedout: int = 0,
    sacrificed: int = 0,
) -> Metrics:
    """Assemble a :class:`Metrics` record from measured counters.

    ``breakdown`` is the engine's exec-lane fraction dict (fractions of
    ``exec_lane_rounds``); the extended breakdown renormalizes it over
    exec *and* planner lane-rounds and adds the round-granular
    planner-busy fraction (planner idle time folds into ``idle``), so
    the fractions still sum to 1.
    """
    lat_hist = np.asarray(lat_hist, np.int64)
    denom = max(exec_lane_rounds + plan_lane_rounds, 1)
    ext = {
        k: v * exec_lane_rounds / denom for k, v in breakdown.items()
    }
    ext["plan"] = plan_busy_rounds / denom
    ext["idle"] = ext.get("idle", 0.0) + (
        plan_lane_rounds - plan_busy_rounds
    ) / denom
    return Metrics(
        lat_hist=lat_hist,
        lat_edges=bucket_edges(),
        p50=percentile_from_hist(lat_hist, 0.50),
        p99=percentile_from_hist(lat_hist, 0.99),
        p999=percentile_from_hist(lat_hist, 0.999),
        q_grid=np.asarray(q_grid, np.int64),
        q_depth=np.asarray(q_depth, np.int64),
        q_inflight=np.asarray(q_inflight, np.int64),
        breakdown_ext=ext,
        committed=int(committed),
        admitted=int(admitted),
        offered=int(offered),
        rejected=int(rejected),
        shed=int(shed),
        timedout=int(timedout),
        sacrificed=int(sacrificed),
    )
