"""Open-loop arrival schedules: a copy of the port's ``loadgen.build_schedule``
and ``schedule_digest``, held here so the yardstick does not move with the
program, and the order a run's seed gives them.

``build_schedule`` is a pure function of its arguments (one seeded
``np.random.default_rng`` draws gaps, sizes and labels).  A cell builds
its base schedule once from the seed in its traffic file, so every run
offers the same multiset of gaps, request sizes and labels;
``reorder`` then shuffles the gaps and the requests with the run's seed.
Runs on different seeds differ in order, not in work.
"""

from __future__ import annotations

import hashlib
from collections import namedtuple
from typing import Optional, Sequence

import numpy as np

ARRIVALS = ("poisson", "bursty")

# one scheduled arrival: offset (seconds from run start), client label,
# query rows
ScheduledRequest = namedtuple("ScheduledRequest", "t label rows")


def build_schedule(
    *,
    seed: int,
    duration_s: float,
    rate_qps: float,
    arrival: str = "poisson",
    request_rows: Sequence[int] = (16, 64, 256),
    row_weights: Optional[Sequence[float]] = None,
    labels: Sequence[str] = ("tenant-a", "tenant-b"),
    burst_factor: float = 8.0,
    burst_fraction: float = 0.125,
    burst_period_s: float = 1.0,
) -> list:
    """Deterministic open-loop arrival schedule (see module docstring).

    Returns a time-sorted list of ``ScheduledRequest`` covering
    ``[0, duration_s)``.  ``rate_qps`` is the mean REQUEST rate (not
    rows/s).  The identical argument tuple yields the identical
    schedule — tier-1 pins this via ``schedule_digest``.
    """
    if arrival not in ARRIVALS:
        raise ValueError(f"arrival must be one of {ARRIVALS}, got {arrival!r}")
    if duration_s <= 0 or rate_qps <= 0:
        raise ValueError(
            f"duration_s and rate_qps must be > 0, got "
            f"{duration_s!r}/{rate_qps!r}"
        )
    if not labels:
        raise ValueError("labels must be non-empty")
    rows_arr = [int(r) for r in request_rows]
    if not rows_arr or any(r < 1 for r in rows_arr):
        raise ValueError(
            f"request_rows must be positive ints, got {request_rows!r}"
        )
    if row_weights is not None:
        w = np.asarray(row_weights, dtype=np.float64)
        if w.shape != (len(rows_arr),) or (w < 0).any() or w.sum() <= 0:
            raise ValueError(
                "row_weights must be non-negative, same length as "
                "request_rows, with a positive sum"
            )
        w = w / w.sum()
    else:
        w = None
    if arrival == "bursty":
        if not 0 < burst_fraction < 1:
            raise ValueError(
                f"burst_fraction must be in (0, 1), got {burst_fraction!r}"
            )
        if burst_factor * burst_fraction > 1:
            raise ValueError(
                "burst_factor * burst_fraction must be <= 1 so the OFF "
                f"phase keeps a non-negative rate, got "
                f"{burst_factor!r} * {burst_fraction!r} (== 1 means ALL "
                "traffic arrives in the burst window)"
            )
        if burst_period_s <= 0:
            raise ValueError(
                f"burst_period_s must be > 0, got {burst_period_s!r}"
            )

    rng = np.random.default_rng(seed)
    times = []
    if arrival == "poisson":
        t = 0.0
        while True:
            t += rng.exponential(1.0 / rate_qps)
            if t >= duration_s:
                break
            times.append(t)
    else:  # bursty: mean-preserving on/off duty cycle, Poisson within
        on_rate = rate_qps * burst_factor
        off_rate = rate_qps * (1.0 - burst_factor * burst_fraction) / (
            1.0 - burst_fraction
        )
        on_len = burst_period_s * burst_fraction
        t = 0.0
        while t < duration_s:
            phase = t % burst_period_s
            in_on = phase < on_len
            rate = on_rate if in_on else off_rate
            phase_end = t + ((on_len - phase) if in_on
                             else (burst_period_s - phase))
            t += rng.exponential(1.0 / rate) if rate > 0 else (
                phase_end - t
            )
            if rate > 0 and t < min(phase_end, duration_s):
                times.append(t)
            elif t >= phase_end:
                t = phase_end  # carry into the next phase, no arrival
    out = []
    for t in times:
        rows = rows_arr[int(rng.choice(len(rows_arr), p=w))]
        label = labels[int(rng.integers(len(labels)))]
        out.append(ScheduledRequest(float(t), str(label), int(rows)))
    return out


def schedule_digest(schedule) -> str:
    """SHA-256 over the canonical text of a schedule — the determinism
    pin: identical seed+params ⇒ identical digest (tier-1 asserts it),
    and the digest rides in the ``topk_slo`` record so two records are
    comparable only when their arrival schedules actually matched."""
    h = hashlib.sha256()
    for r in schedule:
        h.update(f"{r.t:.9f}|{r.label}|{r.rows}\n".encode())
    return h.hexdigest()



def reorder(schedule, seed: int) -> list:
    """The same requests in another order: the gaps between arrivals and
    the (label, rows) pairs each permuted by ``seed``; the arrival times
    are the permuted gaps' running sum, so the last arrival and the count
    are those of ``schedule``."""
    if not schedule:
        return []
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5C4ED]))
    t = np.array([r.t for r in schedule], dtype=np.float64)
    gaps = np.diff(np.concatenate([[0.0], t]))
    times = np.cumsum(gaps[rng.permutation(len(gaps))])
    reqs = [schedule[i] for i in rng.permutation(len(schedule))]
    return [ScheduledRequest(float(tt), r.label, r.rows)
            for tt, r in zip(times, reqs)]
