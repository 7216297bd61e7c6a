"""How ``correct`` is decided: the fingerprint of every result the window's
calls produced, held to the plain reference's fingerprint of the same
inputs. The simulator's results are exact, so every limit is 0.

The numbers compared, each the largest gap over the calls: the
counters one by one (commits, aborts by cause, wasted ops, rounds
measured and in all, steps executed, commits in all, admissions), the
simulated seconds and throughput, the largest gap of the six breakdown
fractions and of the latency histogram's buckets, and the number of
calls whose fingerprint differs in any field or that gave no result.
"""

from __future__ import annotations

SCALARS = ("commits", "aborts_deadlock", "aborts_ollp", "wasted_ops",
           "rounds", "rounds_total", "steps_executed", "total_commits",
           "next_txn", "sim_seconds", "throughput_txn_s")
GROUPS = ("breakdown", "lat_hist")


def fingerprint(res) -> dict:
    """The port's ``SimResult`` in the reference's fields."""
    fp = dict(
        commits=res.commits,
        aborts_deadlock=res.aborts_deadlock,
        aborts_ollp=res.aborts_ollp,
        wasted_ops=res.wasted_ops,
        rounds=res.rounds,
        sim_seconds=res.sim_seconds,
        throughput_txn_s=res.throughput_txn_s,
        total_commits=res.raw["total_commits"],
        next_txn=res.raw["next_txn"],
        rounds_total=res.raw["rounds_total"],
        steps_executed=res.raw["steps_executed"],
    )
    for k, v in res.breakdown.items():
        fp[f"breakdown.{k}"] = v
    if res.metrics is not None:
        for k, v in enumerate(res.metrics.lat_hist):
            fp[f"lat_hist.{k}"] = int(v)
    return fp


def compare(got: list[list[dict] | None], want: list[dict]) -> dict:
    """``got``: per call, the fingerprints it returned (None if it raised);
    ``want``: the reference's. Returns {name: [gap, limit]}, the calls
    that differ last."""
    gaps = {k: 0.0 for k in SCALARS + GROUPS}
    differing = 0
    for call in got:
        if call is None or len(call) != len(want):
            differing += 1
            continue
        bad = False
        for fp, ref in zip(call, want):
            if fp.keys() != ref.keys():
                bad = True
            for k in fp.keys() & ref.keys():
                gap = abs(fp[k] - ref[k])
                group = k.split(".", 1)[0]
                name = group if group in GROUPS else k
                gaps[name] = max(gaps[name], gap)
                bad = bad or gap != 0
        differing += bad
    out = {k: [v, 0] for k, v in gaps.items()}
    out["calls_differing"] = [differing, 0]
    return out


def within(compared: dict) -> bool:
    return all(v <= lim for v, lim in compared.values())
