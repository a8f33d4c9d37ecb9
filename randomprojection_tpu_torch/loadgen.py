"""Open-loop load generator for the serving tier (a copy of the reference's
``randomprojection_tpu/loadgen.py``; the port imports nothing of that
package).

Closed-loop clients (``topk-bench``) submit, wait and submit again, so a
slow server slows its own offered load and queueing never shows.  Here
requests land when a seeded schedule says, whether or not the server kept
up, with mixed request sizes and fixed client labels; the result is the
``topk_slo`` record of per-label p50/p90/p99/p99.9 tables.

``build_schedule(seed, ...)`` is a pure function of its arguments (one
seeded ``np.random.default_rng`` draws gaps, sizes and labels), pinned by
``schedule_digest``.  Arrivals:

- ``poisson``: exponential gaps at ``rate_qps`` requests a second;
- ``bursty``: a deterministic on/off cycle (period ``burst_period_s``,
  on-fraction ``burst_fraction``), the ON phase at ``burst_factor`` times
  the mean-preserving base rate and the OFF phase at the rest, Poisson
  within each phase.

``run`` drives any server with ``submit(codes, label=)`` returning a
Future.  If the one submitting thread falls behind the schedule by more
than 0.25 s (``max_lag_s``) the record is flagged ``open_loop_suspect``.
Backpressure rejects (``RuntimeError`` from ``submit``) are counted per
label.  Latency runs from each request's due time (the run's start plus
its schedule time, so a late submitter counts against the requests it
delays) to completion through ``Future.add_done_callback``, so the
quantiles are exact order statistics.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import namedtuple
from typing import Optional, Sequence

import numpy as np

from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS

__all__ = [
    "ScheduledRequest",
    "ARRIVALS",
    "build_schedule",
    "schedule_digest",
    "slo_table",
    "run",
]

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


def _percentiles(values: Sequence[float]) -> dict:
    """Exact order-statistic quantiles (linear interpolation) of
    client-observed latencies, in milliseconds."""
    a = np.sort(np.asarray(list(values), dtype=np.float64))
    out = {}
    for q, key in ((50, "p50_ms"), (90, "p90_ms"), (99, "p99_ms"),
                   (99.9, "p99.9_ms")):
        out[key] = round(np.percentile(a, q) * 1e3, 3) if a.size else None
    out["mean_ms"] = round(a.mean() * 1e3, 3) if a.size else None
    out["max_ms"] = round(a.max() * 1e3, 3) if a.size else None
    return out


def slo_table(latencies_s: Sequence[float], *, rows: int = 0,
              rejects: int = 0) -> dict:
    """One SLO table row: exact p50/p90/p99/p99.9 (+mean/max) over the
    given latencies plus count/rows/rejects — the per-label unit of the
    ``topk_slo`` record."""
    out = {"count": len(latencies_s), "rows": int(rows),
           "rejects": int(rejects)}
    out.update(_percentiles(latencies_s))
    return out


def run(server, schedule, *, code_bytes: int, seed: int = 0,
        warmup_rows: int = 0,
        probe_policy: Optional[dict] = None) -> dict:
    """Drive ``server`` through ``schedule`` open-loop and return the
    ``topk_slo`` record (see module docstring).

    Query codes are drawn from one seeded pool (``seed`` — independent
    of the schedule's seed stream so changing the corpus draw cannot
    silently change arrival times); each request slices distinct rows
    so a device call cache cannot serve repeats.  ``warmup_rows > 0``
    issues one unmeasured blocking request first (compile warmup).

    ``probe_policy`` (label → probes) is RECORDED per label in the SLO
    table so mixed quality classes stay attributable — routing itself
    lives in the server (``TopKServer(probe_policy=...)``); pass the
    same dict to both.
    """
    total_rows = sum(r.rows for r in schedule)
    if total_rows == 0:
        raise ValueError("empty schedule")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0DE5]))
    pool = rng.integers(
        0, 256, size=(total_rows, int(code_bytes)), dtype=np.uint8
    )
    if warmup_rows > 0:
        server.query(
            rng.integers(0, 256, size=(warmup_rows, int(code_bytes)),
                         dtype=np.uint8)
        )

    done_lock = threading.Lock()
    lat_by_label: dict = {}
    rows_by_label: dict = {}
    rejects_by_label: dict = {}
    errors = 0
    done_count = 0
    pending = []
    max_lag = 0.0
    t0 = time.perf_counter()
    offset = 0
    for req in schedule:
        now = time.perf_counter() - t0
        delay = req.t - now
        if delay > 0:
            time.sleep(delay)
        else:
            max_lag = max(max_lag, -delay)
        codes = pool[offset:offset + req.rows]
        offset += req.rows
        # latency runs from the request's due time, so a late submitter
        # counts against the requests it delays
        t_due = t0 + req.t
        try:
            fut = server.submit(codes, label=req.label)
        except RuntimeError:
            # backpressure shed (queue full / server closed): the SLO
            # story for this label includes who got rejected
            with done_lock:
                rejects_by_label[req.label] = (
                    rejects_by_label.get(req.label, 0) + 1
                )
            continue

        def _on_done(f, label=req.label, rows=req.rows, t_due=t_due):
            nonlocal errors, done_count
            lat = time.perf_counter() - t_due
            # f is already done when the callback runs, so f.exception()
            # below cannot block under the lock
            with done_lock:
                done_count += 1
                if f.exception() is not None:
                    errors += 1
                else:
                    lat_by_label.setdefault(label, []).append(lat)
                    rows_by_label[label] = (
                        rows_by_label.get(label, 0) + rows
                    )

        fut.add_done_callback(_on_done)
        pending.append(fut)
    # the offered-load window ends when the LAST request was submitted —
    # the drain below measures completion, and under overload completion
    # can run many times longer than the schedule: offered_qps computed
    # over drain-inclusive wall would understate the one number the
    # open-loop design exists to hold constant
    submit_elapsed = time.perf_counter() - t0
    for fut in pending:
        # block until every future resolved (results/errors land in the
        # callbacks, not here)
        fut.exception()
    # Future.set_result wakes waiters BEFORE it runs done-callbacks, so
    # the drain above can return while the dispatcher is still inside
    # the last _on_done — aggregating then would drop tail samples from
    # the very statistics this record exists to pin.  Wait for every
    # callback to have actually run.
    wait_deadline = time.monotonic() + 60.0
    while time.monotonic() < wait_deadline:
        with done_lock:
            if done_count >= len(pending):
                break
        time.sleep(0.001)
    else:  # pragma: no cover — a callback never ran (interpreter bug)
        raise RuntimeError(
            f"loadgen: only {done_count}/{len(pending)} completion "
            "callbacks ran within 60s"
        )
    elapsed = time.perf_counter() - t0

    all_lats: list = []
    labels_out = {}
    for label in sorted(
        set(lat_by_label) | set(rejects_by_label)
    ):
        lats = lat_by_label.get(label, [])
        all_lats.extend(lats)
        labels_out[label] = slo_table(
            lats, rows=rows_by_label.get(label, 0),
            rejects=rejects_by_label.get(label, 0),
        )
        if probe_policy is not None:
            # None = the server's default probes served this label
            labels_out[label]["probes"] = probe_policy.get(label)
    n_rejects = sum(rejects_by_label.values())
    record = {
        "metric": "topk_slo",
        "requests": len(schedule),
        "rows": int(total_rows),
        "elapsed_s": round(elapsed, 4),
        "submit_elapsed_s": round(submit_elapsed, 4),
        "offered_qps": round(len(schedule) / submit_elapsed, 2),
        "served_qps": round(
            (len(schedule) - n_rejects) / elapsed, 2
        ),
        "rejects": int(n_rejects),
        "errors": int(errors),
        "max_lag_s": round(max_lag, 4),
        # an open-loop claim is honest only while the submitter kept up:
        # one coalescing delay of lag is tolerated, beyond that flag it
        "open_loop_suspect": bool(max_lag > 0.25),
        "schedule_sha256": schedule_digest(schedule),
        "labels": labels_out,
        "total": slo_table(
            all_lats,
            rows=sum(t["rows"] for t in labels_out.values()),
            rejects=n_rejects,
        ),
        "server": server.stats(),
    }
    if telemetry.enabled():
        telemetry.emit(
            EVENTS.LOADGEN_RUN, requests=len(schedule),
            rows=int(total_rows), rejects=int(n_rejects),
            errors=int(errors), elapsed_s=round(elapsed, 4),
            max_lag_s=round(max_lag, 4),
            schedule_sha256=record["schedule_sha256"],
        )
    return record
