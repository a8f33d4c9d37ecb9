"""Per-batch critical-path attribution over the telemetry span stream, and
the doctor's text views.

A copy of ``randomprojection_tpu/utils/trace_report.py`` (the port imports
nothing of that package): ``build_report`` with the degraded-event audit
and the health-verdict names it counts, ``render_report`` (the doctor's
text), and ``build_postmortem``/``render_postmortem`` over a flight-recorder
dump.  Given the same file each returns the reference's dict or text.  Within each batch trace (a root span named
``batch`` and its child stages across threads) every instant of the root
interval is attributed to exactly one covering child stage (ties to the
earliest-started span) or, uncovered, to the **bubble**; stage fractions
and the bubble sum to 100% of batch wall by construction.
"""

from __future__ import annotations

from typing import Optional

from randomprojection_tpu_torch.utils.telemetry import (
    EVENTS,
    MetricsRegistry,
    quantiles_from_buckets,
    read_events,
    registered_event,
)

__all__ = [
    "build_report",
    "render_report",
    "build_postmortem",
    "render_postmortem",
    "DEGRADED_EVENTS",
    "HEALTH_VERDICT_EVENTS",
]

# health-plane verdict events: each carries a firing/cleared
# ``status`` lifecycle; the doctor folds them into a per-detector
# transition count plus the set of keys still firing at end-of-log —
# the post-hoc twin of ``doctor --live``'s verdict view
HEALTH_VERDICT_EVENTS = (
    EVENTS.HEALTH_SLO_BURN,
    EVENTS.HEALTH_STALL,
    EVENTS.HEALTH_QUEUE_PINNED,
    EVENTS.HEALTH_DEGRADED_SPIKE,
)

# event names that mark a degraded execution path; the audit reports a
# count for each even when zero, so "nothing degraded" is an explicit
# statement, not an absence.  Names come from the central registry
# (telemetry.EVENTS).  The doctor keeps the reference's watch list, so it
# reads a reference JSONL the same way; the port itself never emits the
# kernel-ladder events in it.
# rplint: allow[RP14] — the port never emits the reference's kernel-ladder events (ROADMAP standing divergences "No VMEM-OOM ladders" and "No scan or dense route on a card index"); the doctor keeps watching them for reference logs
DEGRADED_EVENTS = (
    EVENTS.BACKEND_VMEM_OOM_RETRY,
    EVENTS.KERNEL_DMA_FALLBACK,
    EVENTS.SIMHASH_TOPK_DENSE_FALLBACK,
    EVENTS.SIMHASH_TOPK_BLOCK_CLAMP,
    EVENTS.TOPK_KERNEL_VMEM_RETRY,
    EVENTS.TOPK_KERNEL_SCAN_FALLBACK,
    EVENTS.STREAM_PREFETCH_ERROR,
    EVENTS.STREAM_PREFETCH_SHUTDOWN_TIMEOUT,
    EVENTS.STREAM_STAGED_ERROR,
    EVENTS.STREAM_STAGED_SHUTDOWN_TIMEOUT,
    EVENTS.SERVE_TOPK_ERROR,
    EVENTS.RECOVER_CHECKSUM_MISMATCH,
    # live plane: a subscriber overflowing its bounded queue means
    # the live view lost events — degraded observability, on the audit
    EVENTS.TELEMETRY_SUBSCRIBER_DROPPED,
    # LSH candidate tier: a tile whose candidate set was too
    # dense/starved served through the exact scan instead — correct but
    # sublinear no more, so the fallback rate belongs on the audit
    EVENTS.INDEX_LSH_FALLBACK,
    # tiered residency: a cold chunk served through the
    # synchronous-fetch rung (upload failure, budget race, worker
    # error) stayed bit-identical but lost the overlap — the rate
    # belongs on the audit
    EVENTS.INDEX_TIER_FALLBACK,
)


class _Span:
    __slots__ = ("name", "trace_id", "parent_id", "t0", "t1")

    def __init__(self, name, trace_id, parent_id, t0, t1):
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = t1


def _attribute(root: _Span, children: list):
    """Sweep the root interval: every elementary sub-interval goes to the
    earliest-started covering child (one stage per instant — fractions
    stay additive) or to the bubble.  Returns
    ``(stage_seconds, bubble_seconds, batch_wall_seconds)``."""
    t0, t1 = root.t0, root.t1
    ivals = []
    for c in children:
        s, e = max(c.t0, t0), min(c.t1, t1)
        if e > s:
            ivals.append((s, e, c.name, c.t0))
    bounds = sorted({t0, t1, *(s for s, _, _, _ in ivals),
                     *(e for _, e, _, _ in ivals)})
    stage_s: dict = {}
    bubble = 0.0
    for a, b in zip(bounds, bounds[1:]):
        active = [iv for iv in ivals if iv[0] <= a and iv[1] >= b]
        if active:
            winner = min(active, key=lambda iv: (iv[3], iv[2]))[2]
            stage_s[winner] = stage_s.get(winner, 0.0) + (b - a)
        else:
            bubble += b - a
    return stage_s, bubble, t1 - t0


def build_report(path: str) -> dict:
    """Reconstruct per-batch timelines from a telemetry JSONL file and
    return the critical-path report (plain-JSON dict).

    Tolerates everything a crashed run leaves behind: a torn final line
    (skipped by the reader), ``span_start``s with no end (counted as
    orphans, excluded from attribution), span events missing their ids
    (counted as malformed, skipped), traces whose root was lost, and
    files with no spans at all (flat v1 logs — the report then carries
    only the event counts and the audit).

    Single streaming pass: a trace is attributed and dropped the moment
    its ROOT span ends (children always end before the root in the
    pipeline's trace shape), so memory is bounded by in-flight traces
    plus whatever a crash orphaned — a multi-GB event log never has to
    fit in host memory, matching ``read_events``' own O(1) contract."""
    starts: dict = {}          # span_id -> span_start event (unclosed)
    children_of: dict = {}     # trace_id -> [completed child _Span]
    event_counts: dict = {}
    orphan_ends = 0
    malformed_spans = 0
    complete_spans = 0
    hash_python = 0
    n_events = 0
    queue_n = 0
    queue_max = 0
    queue_sum = 0.0
    queue_capacity: Optional[int] = None

    stage_total: dict = {}
    bubble_total = 0.0
    wall_total = 0.0
    n_batches = 0
    incomplete = 0
    empty_roots = 0
    t_min, t_max = None, None
    child_wall = 0.0
    recover_resumes: list = []
    orphan_chunks = 0
    topk_dispatches = 0
    topk_queries = 0
    xform_dispatches = {"dma": 0, "single": 0}
    xform_rows = {"dma": 0, "single": 0}
    xform_fused_calls = 0
    xform_fused_rows = 0
    xform_fused_steps = 0
    shard_tiles = 0
    shard_fanout = 0
    shard_merges = 0
    shard_merge_wall = 0.0
    shard_batches = 0
    shard_batch_rows = 0
    shard_replicas: set = set()
    # per-request serving latency: folded into the same fixed
    # log2 buckets the registry histograms use, keyed "<server>" and
    # "<server>[label]" — O(1) memory however long the run, quantiles
    # extracted at the end by the shared bucket math
    lat_hists: dict = {}
    loadgen_runs: list = []
    # health plane: per-detector firing/cleared transition counts,
    # the per-key last-seen status (what was STILL firing when the log
    # ended), flight-recorder dumps, and the per-subscriber drop tally
    # the live-plane overflow events carry
    health_counts: dict = {}       # event -> {"firing": n, "cleared": n}
    health_last: dict = {}         # (event, key) -> last status
    flight_dumps: list = []
    subscriber_drops: dict = {}    # subscriber name -> dropped total
    # LSH candidate tier: per-tile candidate generation,
    # fallback reasons, bucket-build folds
    lsh_tiles = 0
    lsh_queries = 0
    lsh_probes = 0
    lsh_candidates = 0
    lsh_frac_sum = 0.0
    lsh_fallbacks: dict = {}
    lsh_builds = 0
    lsh_build_rows = 0
    # device-fused probe tier
    lsh_dev_tiles = 0
    lsh_dev_uploads = 0
    lsh_dev_upload_bytes = 0
    lsh_adaptive_tiles = 0
    lsh_adaptive_queries = 0
    lsh_adaptive_rounds = 0
    lsh_adaptive_probes_sum = 0.0
    lsh_adaptive_early = 0
    lsh_adaptive_budget = 0
    # tiered residency: per-tile hot/cold row split, the cold
    # fetch ledger (wall, overlapped share, per-fetch walls for p99),
    # promotion/demotion churn, and the degraded sync-fallback reasons
    tier_tiles = 0
    tier_hot_rows = 0
    tier_cold_rows = 0
    tier_fetches = 0
    tier_fetch_rows = 0
    tier_fetch_bytes = 0
    tier_fetch_wall = 0.0
    tier_overlap_wall = 0.0
    tier_sync_fetches = 0
    tier_fetch_walls: list = []
    tier_promotions = 0
    tier_evictions = 0
    tier_evict_wall = 0.0
    tier_fallbacks: dict = {}

    def _lat_observe(key: str, seconds: float) -> None:
        h = lat_hists.setdefault(key, {"sum": 0.0, "count": 0,
                                       "buckets": {}})
        h["sum"] += seconds
        h["count"] += 1
        b = MetricsRegistry._bucket(seconds)
        h["buckets"][b] = h["buckets"].get(b, 0) + 1

    for e in read_events(path):
        n_events += 1
        name = e["event"]
        event_counts[name] = event_counts.get(name, 0) + 1
        if name == EVENTS.SPAN_START:
            if "span_id" not in e or "trace_id" not in e:
                malformed_spans += 1
                continue
            starts[e["span_id"]] = e
        elif name == EVENTS.SPAN_END:
            if "span_id" not in e:
                malformed_spans += 1
                continue
            s = starts.pop(e["span_id"], None)
            if s is None:
                orphan_ends += 1
                continue
            complete_spans += 1
            t0 = s["ts"]
            # prefer the monotonic duration over wall-clock subtraction:
            # ts comes from time.time(), dur_s from perf_counter
            t1 = t0 + e.get("dur_s", max(e["ts"] - t0, 0.0))
            trace_id = s["trace_id"]
            if s.get("parent_id") is not None:
                children_of.setdefault(trace_id, []).append(
                    _Span(s["name"], trace_id, s["parent_id"], t0, t1)
                )
                continue
            # a ROOT ended: finalize its trace now and drop the buffers
            children = children_of.pop(trace_id, [])
            if e.get("empty"):
                # iter_traced's end-of-stream probe: production began but
                # there was no next batch — a healthy artifact, not an
                # incomplete batch
                empty_roots += 1
                continue
            if e.get("error") or e.get("abandoned"):
                incomplete += 1
                continue
            root = _Span(s["name"], trace_id, None, t0, t1)
            n_batches += 1
            t_min = root.t0 if t_min is None else min(t_min, root.t0)
            t_max = root.t1 if t_max is None else max(t_max, root.t1)
            child_wall += sum(c.t1 - c.t0 for c in children)
            stage_s, bubble, wall = _attribute(root, children)
            for k, v in stage_s.items():
                stage_total[k] = stage_total.get(k, 0.0) + v
            bubble_total += bubble
            wall_total += wall
        elif name in (
            EVENTS.STREAM_PREFETCH_DELIVER, EVENTS.STREAM_STAGED_DELIVER
        ):
            d = e.get("queue_depth", 0)
            queue_n += 1
            queue_max = max(queue_max, d)
            queue_sum += d
            if queue_capacity is None:
                queue_capacity = e.get("capacity")
        elif name == EVENTS.HASH_BATCH and e.get("path") == "python":
            hash_python += 1
        elif name == EVENTS.RECOVER_RESUME:
            # a durable ingest resumed from its committed cursor: the
            # replayed row range is the crash's footprint, on the record
            recover_resumes.append({
                "rows_done": e.get("rows_done"),
                "replay_rows": e.get("replay_rows"),
            })
        elif name == EVENTS.RECOVER_ORPHAN_CHUNK:
            orphan_chunks += 1
        elif name == EVENTS.KERNEL_DMA_DISPATCH:
            # fused transform-kernel host dispatches: which
            # route (manual double-buffered DMA vs the single-buffered
            # automatic tiling) served how many rows — the doctor's view
            # of whether the default DMA path is actually the one running
            route = e.get("path") if e.get("path") in xform_dispatches \
                else "single"
            xform_dispatches[route] += 1
            xform_rows[route] += e.get("rows", 0) or 0
        elif name == EVENTS.BACKEND_DISPATCH_FUSED:
            # multi-step dispatch fusion: K row-blocks chained through
            # one traced dispatch — call-boundary gaps amortize by 1/K
            xform_fused_calls += 1
            xform_fused_rows += e.get("rows", 0) or 0
            xform_fused_steps += e.get("steps", 0) or 0
        elif name == EVENTS.TOPK_KERNEL_DISPATCH:
            # fused serving-kernel dispatches (one per query tile per
            # chunk): the doctor's view of how much top-k traffic the
            # kernel path actually served
            topk_dispatches += 1
            topk_queries += e.get("queries", 0) or 0
        elif name == EVENTS.SHARD_TOPK_TILE:
            # sharded-tier fanout: one event per query tile, carrying
            # how many shard devices the tile was dispatched across
            shard_tiles += 1
            shard_fanout += e.get("shards", 0) or 0
        elif name == EVENTS.SHARD_MERGE:
            shard_merges += 1
            shard_merge_wall += e.get("wall_s", 0.0) or 0.0
        elif name == EVENTS.SERVE_SHARD_BATCH:
            # replica-routed coalesced dispatches from ShardedTopKServer
            shard_batches += 1
            shard_batch_rows += e.get("rows", 0) or 0
            if e.get("replica") is not None:
                shard_replicas.add(e["replica"])
        elif name == EVENTS.SERVE_LATENCY_REQUEST:
            # per-request enqueue→complete stamps from the serving tier
            total = e.get("total_s")
            if isinstance(total, (int, float)):
                server = str(e.get("server") or "topk")
                _lat_observe(server, total)
                if e.get("label") is not None:
                    _lat_observe(f"{server}[{e['label']}]", total)
        elif name == EVENTS.INDEX_LSH_DISPATCH:
            # one LSH-served query tile: how many buckets were probed
            # and what fraction of the corpus the re-rank touched — the
            # doctor's view of whether retrieval is actually sublinear.
            # Bucket lookups = queries x bands x probes, matching the
            # index.lsh.probe_buckets registry counter exactly
            lsh_tiles += 1
            lsh_queries += e.get("queries", 0) or 0
            lsh_probes += (
                (e.get("queries", 0) or 0)
                * (e.get("probes", 0) or 0)
                * (e.get("bands", 0) or 0)
            )
            lsh_candidates += e.get("candidates", 0) or 0
            lsh_frac_sum += e.get("candidate_fraction", 0.0) or 0.0
        elif name == EVENTS.INDEX_LSH_DEVICE_DISPATCH:
            # device-fused tile: same tile accounting as the
            # host probe path — the split between the two shows how
            # much of retrieval runs without the host CSR-walk hop
            lsh_tiles += 1
            lsh_dev_tiles += 1
            lsh_queries += e.get("queries", 0) or 0
            lsh_probes += (
                (e.get("queries", 0) or 0)
                * (e.get("probes", 0) or 0)
                * (e.get("bands", 0) or 0)
            )
            lsh_candidates += e.get("candidates", 0) or 0
            lsh_frac_sum += e.get("candidate_fraction", 0.0) or 0.0
        elif name == EVENTS.INDEX_LSH_ADAPTIVE:
            # adaptive tile: counts as a device tile; the per-query
            # probe escalation summary aggregates separately
            lsh_tiles += 1
            lsh_dev_tiles += 1
            lsh_queries += e.get("queries", 0) or 0
            lsh_candidates += e.get("candidates", 0) or 0
            lsh_frac_sum += e.get("candidate_fraction", 0.0) or 0.0
            lsh_adaptive_tiles += 1
            lsh_adaptive_queries += e.get("queries", 0) or 0
            lsh_adaptive_rounds += e.get("rounds", 0) or 0
            lsh_adaptive_probes_sum += (
                (e.get("probes_used_mean", 0.0) or 0.0)
                * (e.get("queries", 0) or 0)
            )
            lsh_adaptive_early += e.get("early_exits", 0) or 0
            lsh_adaptive_budget += e.get("budget_stops", 0) or 0
        elif name == EVENTS.INDEX_LSH_DEVICE_UPLOAD:
            lsh_dev_uploads += 1
            lsh_dev_upload_bytes += e.get("bytes", 0) or 0
        elif name == EVENTS.INDEX_LSH_FALLBACK:
            reason = str(e.get("reason") or "unknown")
            lsh_fallbacks[reason] = lsh_fallbacks.get(reason, 0) + 1
        elif name == EVENTS.INDEX_LSH_BUILD:
            lsh_builds += 1
            lsh_build_rows += e.get("rows", 0) or 0
        elif name == EVENTS.INDEX_TIER_HIT:
            # one tile served by a tiered index: how many candidate rows
            # sat in HBM vs the cold tier — the doctor's hot-hit ratio
            tier_tiles += 1
            tier_hot_rows += e.get("hot_rows", 0) or 0
            tier_cold_rows += e.get("cold_rows", 0) or 0
        elif name == EVENTS.INDEX_TIER_FETCH:
            # one cold H2D upload; promote=True means the background
            # worker re-admitted a chunk (churn), not a serving fetch
            if e.get("promote"):
                tier_promotions += 1
            else:
                tier_fetches += 1
                tier_fetch_rows += e.get("rows", 0) or 0
                tier_fetch_bytes += e.get("bytes", 0) or 0
                w = e.get("wall_s", 0.0) or 0.0
                tier_fetch_wall += w
                tier_fetch_walls.append(w)
                tier_overlap_wall += e.get("overlap_s", 0.0) or 0.0
                if e.get("sync"):
                    tier_sync_fetches += 1
        elif name == EVENTS.INDEX_TIER_EVICT:
            tier_evictions += 1
            tier_evict_wall += e.get("wall_s", 0.0) or 0.0
        elif name == EVENTS.INDEX_TIER_FALLBACK:
            reason = str(e.get("reason") or "unknown")
            tier_fallbacks[reason] = tier_fallbacks.get(reason, 0) + 1
        elif name in HEALTH_VERDICT_EVENTS:
            status = str(e.get("status") or "firing")
            d = health_counts.setdefault(name, {"firing": 0, "cleared": 0})
            d[status] = d.get(status, 0) + 1
            health_last[(name, str(e.get("key")))] = status
        elif name == EVENTS.HEALTH_FLIGHT_DUMP:
            flight_dumps.append({
                "reason": e.get("reason"),
                "path": e.get("path"),
                "events": e.get("events"),
            })
        elif name == EVENTS.TELEMETRY_SUBSCRIBER_DROPPED:
            # the rate-limited overflow report names its subscriber and
            # carries the running total — keep the max (totals are
            # monotonic per subscriber) so the audit says WHO overran
            sub = str(e.get("subscriber") or "?")
            total = e.get("dropped_total", e.get("dropped", 0)) or 0
            subscriber_drops[sub] = max(subscriber_drops.get(sub, 0),
                                        int(total))
        elif name == EVENTS.LOADGEN_RUN:
            loadgen_runs.append({
                "requests": e.get("requests"),
                "rows": e.get("rows"),
                "rejects": e.get("rejects"),
                "errors": e.get("errors"),
                "elapsed_s": e.get("elapsed_s"),
                "max_lag_s": e.get("max_lag_s"),
                "schedule_sha256": e.get("schedule_sha256"),
            })

    # traces whose root never ended: their buffered children are orphaned
    # work of a crashed run — count the traces as incomplete
    incomplete += len(children_of)

    stages = {
        name: {
            "wall_s": round(secs, 6),
            "pct": round(100.0 * secs / wall_total, 2) if wall_total else 0.0,
        }
        for name, secs in sorted(stage_total.items())
    }
    elapsed = (t_max - t_min) if (t_min is not None) else 0.0
    overlap = (
        max(0.0, 1.0 - elapsed / child_wall) if child_wall > 0 else 0.0
    )
    degraded = {name: event_counts.get(name, 0) for name in DEGRADED_EVENTS}
    degraded["hash.batch[path=python]"] = hash_python
    # emitter/consumer drift guard: event names this registry version
    # does not know (an emitter ahead of the registry, a file from a
    # newer build, or a stray literal that dodged the lint) — surfaced
    # in the degraded-event audit rather than silently counted
    unregistered = {
        name: c
        for name, c in sorted(event_counts.items())
        if not registered_event(name)
    }
    queue = None
    if queue_n:
        queue = {
            "samples": queue_n,
            "max": queue_max,
            "mean": round(queue_sum / queue_n, 3),
            "capacity": queue_capacity,
        }
    return {
        "file": path,
        "events": n_events,
        "event_counts": dict(sorted(event_counts.items())),
        "spans": {
            "complete": complete_spans,
            "orphan_starts": len(starts),
            "orphan_ends": orphan_ends,
            "malformed": malformed_spans,
        },
        "traces": {
            "batches": n_batches,
            "incomplete": incomplete,
            "empty": empty_roots,
        },
        "batch": {
            "wall_s": round(wall_total, 6),
            "stages": stages,
            "bubble": {
                "wall_s": round(bubble_total, 6),
                "pct": (
                    round(100.0 * bubble_total / wall_total, 2)
                    if wall_total else 0.0
                ),
            },
        },
        "pipeline": {
            "elapsed_s": round(elapsed, 6),
            "stage_wall_s": round(child_wall, 6),
            "overlap_ratio_est": round(overlap, 3),
        },
        "queue_depth": queue,
        "transform": (
            {
                "kernel_dispatches": dict(xform_dispatches),
                "kernel_rows": dict(xform_rows),
                **(
                    {
                        "fused_dispatch_calls": xform_fused_calls,
                        "fused_dispatch_rows": xform_fused_rows,
                        "fused_dispatch_mean_steps": round(
                            xform_fused_steps / xform_fused_calls, 2
                        ),
                    }
                    if xform_fused_calls
                    else {}
                ),
            }
            if (any(xform_dispatches.values()) or xform_fused_calls)
            else None
        ),
        "serving": (
            {
                "topk_kernel_dispatches": topk_dispatches,
                "topk_kernel_queries": topk_queries,
                **(
                    {
                        "shard_tiles": shard_tiles,
                        "shard_dispatches": shard_fanout,
                        "shard_merges": shard_merges,
                        "shard_merge_wall_s": round(shard_merge_wall, 6),
                    }
                    if shard_tiles
                    else {}
                ),
                **(
                    {
                        "shard_batches": shard_batches,
                        "shard_batch_rows": shard_batch_rows,
                        "shard_replicas_used": sorted(shard_replicas),
                    }
                    if shard_batches
                    else {}
                ),
            }
            if (topk_dispatches or shard_tiles or shard_batches)
            else None
        ),
        "candidate_generation": (
            {
                "lsh_tiles": lsh_tiles,
                "lsh_queries": lsh_queries,
                "probed_buckets_per_tile": (
                    round(lsh_probes / lsh_tiles, 2) if lsh_tiles else 0.0
                ),
                "candidates": lsh_candidates,
                "candidate_fraction_mean": (
                    round(lsh_frac_sum / lsh_tiles, 6) if lsh_tiles
                    else None
                ),
                "fallbacks": dict(sorted(lsh_fallbacks.items())),
                "fallback_rate": (
                    round(
                        sum(lsh_fallbacks.values())
                        / (lsh_tiles + sum(lsh_fallbacks.values())),
                        4,
                    )
                    if (lsh_tiles or lsh_fallbacks)
                    else None
                ),
                "builds": lsh_builds,
                "build_rows": lsh_build_rows,
                "device_tiles": lsh_dev_tiles,
                "device_uploads": lsh_dev_uploads,
                "device_upload_bytes": lsh_dev_upload_bytes,
                "adaptive": (
                    {
                        "tiles": lsh_adaptive_tiles,
                        "rounds": lsh_adaptive_rounds,
                        "probes_used_mean": (
                            round(
                                lsh_adaptive_probes_sum
                                / max(lsh_adaptive_queries, 1),
                                3,
                            )
                        ),
                        "early_exits": lsh_adaptive_early,
                        "budget_stops": lsh_adaptive_budget,
                    }
                    if lsh_adaptive_tiles
                    else None
                ),
            }
            if (lsh_tiles or lsh_fallbacks or lsh_builds)
            else None
        ),
        "residency": (
            {
                "tiles": tier_tiles,
                "hot_rows": tier_hot_rows,
                "cold_rows": tier_cold_rows,
                "hot_hit_ratio": (
                    round(
                        tier_hot_rows / (tier_hot_rows + tier_cold_rows), 4
                    )
                    if (tier_hot_rows + tier_cold_rows)
                    else None
                ),
                "cold_fetches": tier_fetches,
                "cold_fetch_rows": tier_fetch_rows,
                "cold_fetch_bytes": tier_fetch_bytes,
                "cold_fetch_wall_s": round(tier_fetch_wall, 6),
                # the share of fetch wall that rode UNDER the hot-tier
                # kernel (the overlap the tier exists to buy)
                "cold_fetch_overlapped_s": round(tier_overlap_wall, 6),
                # nearest-rank p99: index ceil(0.99 n) - 1, exact over
                # the full per-fetch wall list (doctor runs offline, so
                # no bucket estimate needed here)
                "cold_fetch_p99_s": (
                    round(
                        sorted(tier_fetch_walls)[
                            (99 * len(tier_fetch_walls) + 99) // 100 - 1
                        ],
                        6,
                    )
                    if tier_fetch_walls
                    else None
                ),
                "sync_fetches": tier_sync_fetches,
                "promotions": tier_promotions,
                "demotions": tier_evictions,
                "demotion_wall_s": round(tier_evict_wall, 6),
                "fallbacks": dict(sorted(tier_fallbacks.items())),
            }
            if (tier_tiles or tier_fetches or tier_evictions
                or tier_promotions or tier_fallbacks)
            else None
        ),
        "latency": (
            {
                key: quantiles_from_buckets(
                    {str(b): c for b, c in h["buckets"].items()},
                    h["count"], h["sum"],
                )
                for key, h in sorted(lat_hists.items())
            }
            if lat_hists
            else None
        ),
        "loadgen": loadgen_runs or None,
        "health": (
            {
                "verdicts": {
                    name: dict(c)
                    for name, c in sorted(health_counts.items())
                },
                "still_firing": sorted(
                    f"{ev} {key}"
                    for (ev, key), st in health_last.items()
                    if st == "firing"
                ),
                "flight_dumps": flight_dumps,
            }
            if (health_counts or flight_dumps)
            else None
        ),
        "subscriber_drops": (
            dict(sorted(subscriber_drops.items()))
            if subscriber_drops else None
        ),
        "degraded": degraded,
        "unregistered_events": unregistered,
        "recovery": (
            {
                "resumes": recover_resumes,
                "orphan_chunks_swept": orphan_chunks,
            }
            if (recover_resumes or orphan_chunks)
            else None
        ),
    }


def _bar(pct: float, width: int = 28) -> str:
    n = int(round(pct / 100.0 * width))
    return "#" * n + "." * (width - n)


def render_report(report: dict) -> str:
    """Human-readable doctor view: stage waterfall, bubble, pipeline
    overlap, queue depth, degraded-event audit, and (when the caller
    attached one — see ``cli.cmd_doctor``) the regression-tripwire
    status."""
    lines = []
    tr = report["traces"]
    sp = report["spans"]
    lines.append(
        f"run doctor: {report['file']} — {report['events']} events, "
        f"{tr['batches']} batch traces"
        + (f" ({tr['incomplete']} incomplete)" if tr["incomplete"] else "")
        + (
            f", {sp['orphan_starts']} orphaned span(s)"
            if sp["orphan_starts"] else ""
        )
    )
    b = report["batch"]
    if tr["batches"]:
        lines.append("")
        lines.append(
            f"per-batch critical path (% of {b['wall_s']:.4f}s total "
            "batch wall):"
        )
        rows = list(b["stages"].items()) + [("(bubble)", b["bubble"])]
        for name, d in rows:
            lines.append(
                f"  {name:<14} {_bar(d['pct'])} {d['pct']:6.2f}%  "
                f"{d['wall_s']:.4f}s"
            )
        total_pct = sum(d["pct"] for _, d in rows)
        lines.append(f"  {'':14} stages + bubble = {total_pct:.1f}% of "
                     "batch wall")
        p = report["pipeline"]
        lines.append("")
        lines.append(
            f"pipeline: elapsed {p['elapsed_s']:.4f}s over "
            f"{p['stage_wall_s']:.4f}s summed stage wall -> overlap ratio "
            f"~{p['overlap_ratio_est']:.3f}"
        )
    else:
        lines.append("")
        lines.append(
            "no complete batch traces (flat v1 log, or the run died before "
            "any batch committed) — audit below still applies"
        )
    q = report.get("queue_depth")
    if q:
        lines.append(
            f"prefetch queue: {q['samples']} samples, depth max {q['max']}"
            f"/mean {q['mean']}"
            + (f" (capacity {q['capacity']})" if q.get("capacity") else "")
        )
    xf = report.get("transform")
    if xf:
        kd, kr = xf["kernel_dispatches"], xf["kernel_rows"]
        lines.append(
            f"transform kernel: {kd['dma']} DMA dispatch(es) "
            f"({kr['dma']} rows), {kd['single']} single-buffered "
            f"({kr['single']} rows)"
        )
        if xf.get("fused_dispatch_calls"):
            lines.append(
                f"  dispatch fusion: {xf['fused_dispatch_calls']} chained "
                f"call(s), {xf['fused_dispatch_rows']} rows, mean "
                f"{xf['fused_dispatch_mean_steps']} steps/call"
            )
    sv = report.get("serving")
    if sv:
        lines.append(
            f"serving: {sv['topk_kernel_dispatches']} fused top-k kernel "
            f"dispatch(es), {sv['topk_kernel_queries']} query rows"
        )
        if sv.get("shard_tiles"):
            lines.append(
                f"  sharded tier: {sv['shard_tiles']} tile(s) fanned over "
                f"{sv['shard_dispatches']} shard dispatch(es), "
                f"{sv['shard_merges']} cross-shard merge(s) "
                f"({sv['shard_merge_wall_s']:.4f}s merge wall)"
            )
        if sv.get("shard_batches"):
            reps = sv.get("shard_replicas_used") or []
            lines.append(
                f"  replica routing: {sv['shard_batches']} coalesced "
                f"batch(es), {sv['shard_batch_rows']} rows over "
                f"{len(reps)} replica(s)"
            )
    cg = report.get("candidate_generation")
    if cg:
        lines.append("")
        lines.append("candidate generation (multi-probe LSH):")
        frac = cg.get("candidate_fraction_mean")
        lines.append(
            f"  {cg['lsh_tiles']} LSH tile(s), {cg['lsh_queries']} query "
            f"rows, mean {cg['probed_buckets_per_tile']} probed "
            f"buckets/tile"
        )
        lines.append(
            f"  candidates re-ranked: {cg['candidates']}"
            + (
                f" (mean {100.0 * frac:.2f}% of the live corpus per tile)"
                if frac is not None else ""
            )
        )
        if cg.get("device_tiles"):
            lines.append(
                f"  device-fused probe tiles: {cg['device_tiles']} "
                f"({cg.get('device_uploads', 0)} CSR upload(s), "
                f"{cg.get('device_upload_bytes', 0)} bytes)"
            )
        ad = cg.get("adaptive")
        if ad:
            lines.append(
                f"  adaptive probing: {ad['tiles']} tile(s), "
                f"{ad['rounds']} round(s), mean {ad['probes_used_mean']} "
                f"probes/query, {ad['early_exits']} early exit(s), "
                f"{ad['budget_stops']} budget stop(s)"
            )
        fb = cg.get("fallbacks") or {}
        if fb:
            detail = ", ".join(f"{k} {v}" for k, v in fb.items())
            lines.append(
                f"  fallbacks to the exact path: {sum(fb.values())} "
                f"({detail}; rate {cg['fallback_rate']})"
            )
        else:
            lines.append("  fallbacks to the exact path: none")
        if cg.get("builds"):
            lines.append(
                f"  bucket builds: {cg['builds']} fold(s), "
                f"{cg['build_rows']} rows"
            )
    rs = report.get("residency")
    if rs:
        lines.append("")
        lines.append("residency (tiered hot/cold corpus, r21):")
        ratio = rs.get("hot_hit_ratio")
        lines.append(
            f"  {rs['tiles']} tiered tile(s): {rs['hot_rows']} hot row(s) "
            f"/ {rs['cold_rows']} cold row(s)"
            + (f" — hot-hit ratio {ratio:.4f}" if ratio is not None else "")
        )
        if rs.get("cold_fetches"):
            p99 = rs.get("cold_fetch_p99_s")
            lines.append(
                f"  cold fetches: {rs['cold_fetches']} "
                f"({rs['cold_fetch_rows']} rows, "
                f"{rs['cold_fetch_bytes']} bytes) — wall "
                f"{rs['cold_fetch_wall_s']:.4f}s, overlapped "
                f"{rs['cold_fetch_overlapped_s']:.4f}s under the hot "
                f"kernel"
                + (f", p99 {p99 * 1e3:.2f}ms" if p99 is not None else "")
                + (
                    f", {rs['sync_fetches']} synchronous"
                    if rs.get("sync_fetches") else ""
                )
            )
        if rs.get("promotions") or rs.get("demotions"):
            lines.append(
                f"  churn: {rs['promotions']} promotion(s), "
                f"{rs['demotions']} demotion(s) "
                f"({rs['demotion_wall_s']:.4f}s demotion wall, all "
                "background)"
            )
        fb = rs.get("fallbacks") or {}
        if fb:
            detail = ", ".join(f"{k} {v}" for k, v in fb.items())
            lines.append(
                f"  degraded sync fallbacks: {sum(fb.values())} ({detail})"
            )
        else:
            lines.append("  degraded sync fallbacks: none")
    lat = report.get("latency")
    if lat:
        lines.append("")
        lines.append(
            "serve latency (enqueue→complete, per server / [label]; "
            "bucket-estimated quantiles, exact count/mean):"
        )
        for key, q in lat.items():
            qtxt = "  ".join(
                f"{p}={q[p] * 1e3:.2f}ms" if q[p] is not None else f"{p}=-"
                for p in ("p50", "p90", "p99", "p99.9")
            )
            lines.append(
                f"  {key:<24} n={q['count']:<7} "
                f"mean={q['mean'] * 1e3:.2f}ms  {qtxt}"
            )
    lg = report.get("loadgen")
    if lg:
        lines.append("")
        lines.append("loadgen (open-loop) runs:")
        for r in lg:
            lines.append(
                f"  {r['requests']} requests / {r['rows']} rows in "
                f"{r['elapsed_s']}s — rejects {r['rejects']}, errors "
                f"{r['errors']}, max submit lag {r['max_lag_s']}s, "
                f"schedule {str(r['schedule_sha256'])[:12]}"
            )
    hp = report.get("health")
    if hp:
        lines.append("")
        lines.append("health verdicts (r20 detectors):")
        for name, c in hp["verdicts"].items():
            lines.append(
                f"  {name:<28} fired {c.get('firing', 0)}x, "
                f"cleared {c.get('cleared', 0)}x"
            )
        if hp["still_firing"]:
            lines.append(
                "  STILL FIRING at end of log: "
                + ", ".join(hp["still_firing"])
            )
        for d in hp["flight_dumps"]:
            lines.append(
                f"  flight dump: {d['path']} ({d['reason']}, "
                f"{d['events']} ring events)"
            )
    lines.append("")
    lines.append("degraded-event audit:")
    worst = [(k, v) for k, v in report["degraded"].items() if v]
    for k, v in report["degraded"].items():
        lines.append(f"  {k:<36} {v}")
    subs = report.get("subscriber_drops")
    if subs:
        # which observer overran its bounded queue, not just how often
        # the overflow report fired
        for sub, n in subs.items():
            lines.append(f"    subscriber[{sub}] dropped {n}")
    lines.append(
        "  -> " + (
            "DEGRADED paths taken: " + ", ".join(k for k, _ in worst)
            if worst else "no degraded paths recorded"
        )
    )
    rec = report.get("recovery")
    if rec:
        lines.append("")
        lines.append("crash recovery:")
        for r in rec["resumes"]:
            lines.append(
                f"  resumed at rows_done={r['rows_done']} "
                f"(replayed {r['replay_rows']} uncommitted rows)"
            )
        if rec["orphan_chunks_swept"]:
            lines.append(
                f"  {rec['orphan_chunks_swept']} orphan spill file(s) "
                "swept (uncommitted chunk writes from the crash)"
            )
    unreg = report.get("unregistered_events")
    if unreg:
        lines.append(
            "  WARNING: event name(s) not in the telemetry.EVENTS "
            "registry this report was built against:"
        )
        for k, v in sorted(unreg.items()):
            lines.append(f"    {k:<34} {v}")
    tw = report.get("tripwire")
    if tw is not None:
        lines.append("")
        if tw.get("error"):
            lines.append(f"regression tripwire: unavailable ({tw['error']})")
        else:
            regs = tw.get("regressions")
            vs = tw.get("regressions_vs")
            if regs:
                lines.append(
                    f"regression tripwire ({tw['baseline']}): "
                    f"{len(regs)} recorded vs {vs}:"
                )
                for r in regs:
                    lines.append(
                        f"  {r['metric']}: {r['previous']} -> {r['current']} "
                        f"(-{r['drop_pct']}%)"
                    )
            elif tw.get("regressions_skipped"):
                lines.append(
                    f"regression tripwire ({tw['baseline']}): skipped — "
                    f"{tw['regressions_skipped']}"
                )
            elif regs == [] and vs:
                # the tripwire actually RAN in that round and compared
                # clean against a named baseline
                lines.append(
                    f"regression tripwire ({tw['baseline']}): no >10% "
                    f"drops recorded vs {vs}"
                )
            else:
                # record predates the tripwire (no verdict on file): say
                # so — never report a comparison that was never computed
                lines.append(
                    f"regression tripwire ({tw['baseline']}): no verdict "
                    "recorded in that round's record"
                )
    return "\n".join(lines) + "\n"


# -- flight-recorder postmortem -----------------------------------------------


def build_postmortem(dump: dict) -> dict:
    """Reconstruct the final seconds from a ``FlightRecorder`` dump
    (the JSON ``telemetry.FlightRecorder.dump`` writes): last-known
    per-stage activity, spans in flight at death, the detectors firing
    at death, and a counter digest.  Raises ``ValueError`` on a file
    that is not a flight-recorder dump — the doctor must never render
    a confident postmortem from the wrong artifact."""
    if dump.get("format") != "rp-flight-recorder":
        raise ValueError(
            "not a flight-recorder dump (format="
            f"{dump.get('format')!r}, want 'rp-flight-recorder')"
        )
    death_ts = dump.get("ts")
    events = dump.get("events") or []
    stages: dict = {}        # stage -> {"last_ts", "events"}
    open_spans: dict = {}    # span_id -> span_start record
    window_t0 = None
    for e in events:
        if not isinstance(e, dict):
            continue
        ts = e.get("ts")
        if isinstance(ts, (int, float)):
            window_t0 = ts if window_t0 is None else min(window_t0, ts)
        name = e.get("event")
        if name in (EVENTS.SPAN_START, EVENTS.SPAN_END):
            stage = str(e.get("name"))
            st = stages.setdefault(stage, {"last_ts": None, "events": 0})
            st["events"] += 1
            if isinstance(ts, (int, float)):
                st["last_ts"] = ts if st["last_ts"] is None else max(
                    st["last_ts"], ts
                )
            sid = e.get("span_id")
            if sid is not None:
                if name == EVENTS.SPAN_START:
                    open_spans[sid] = e
                else:
                    open_spans.pop(sid, None)

    def _age(ts):
        if ts is None or not isinstance(death_ts, (int, float)):
            return None
        return round(death_ts - ts, 3)

    stage_rows = [
        {
            "stage": stage,
            "events": st["events"],
            "last_ts": st["last_ts"],
            "age_s": _age(st["last_ts"]),
        }
        for stage, st in sorted(
            stages.items(),
            key=lambda kv: kv[1]["last_ts"] or 0.0,
            reverse=True,
        )
    ]
    # "the stage active at death": most-recently-heartbeating stage,
    # preferring one with a span still OPEN in the ring window
    last_active = None
    open_stages = {str(s.get("name")) for s in open_spans.values()}
    for row in stage_rows:
        if row["stage"] in open_stages:
            last_active = row["stage"]
            break
    if last_active is None and stage_rows:
        last_active = stage_rows[0]["stage"]
    in_flight = [
        {
            "name": str(s.get("name")),
            "trace_id": s.get("trace_id"),
            "span_id": s.get("span_id"),
            "age_s": _age(s.get("ts")),
        }
        for s in sorted(
            open_spans.values(), key=lambda s: s.get("ts") or 0.0
        )
    ]
    tail = [
        {"event": e.get("event"), "age_s": _age(e.get("ts"))}
        for e in events[-10:]
        if isinstance(e, dict)
    ]
    counters = {}
    snap = dump.get("counters") or {}
    for k, v in sorted((snap.get("counters") or {}).items()):
        if v:
            counters[k] = v
    health = dump.get("health")
    return {
        "format": dump.get("format"),
        "v": dump.get("v"),
        "pid": dump.get("pid"),
        "reason": dump.get("reason"),
        "death_ts": death_ts,
        "ring": {
            "events": len(events),
            "capacity": dump.get("capacity"),
            "window_s": (
                round(death_ts - window_t0, 3)
                if (window_t0 is not None
                    and isinstance(death_ts, (int, float)))
                else None
            ),
        },
        "last_active_stage": last_active,
        "stages": stage_rows,
        "in_flight": in_flight,
        "firing": health if isinstance(health, list) else [],
        "health_error": (
            health.get("error") if isinstance(health, dict) else None
        ),
        "tail": tail,
        "counters": counters,
    }


def render_postmortem(pm: dict) -> str:
    """Human-readable postmortem (``cli doctor --postmortem``)."""
    lines = [
        f"flight-recorder postmortem: pid {pm['pid']}, "
        f"reason {pm['reason']!r}",
        f"  ring: {pm['ring']['events']} events"
        + (
            f" over the final {pm['ring']['window_s']}s"
            if pm["ring"]["window_s"] is not None else ""
        )
        + f" (capacity {pm['ring']['capacity']})",
    ]
    if pm["last_active_stage"]:
        lines.append(f"  last active stage: {pm['last_active_stage']}")
    if pm["stages"]:
        lines.append("")
        lines.append("last-known per-stage activity (age at death):")
        for row in pm["stages"]:
            age = row["age_s"]
            lines.append(
                f"  {row['stage']:<18} x{row['events']:<6}"
                + (f" last {age:.3f}s before death" if age is not None
                   else " (no timestamp)")
            )
    if pm["in_flight"]:
        lines.append("")
        lines.append("spans in flight at death:")
        for s in pm["in_flight"]:
            lines.append(
                f"  {s['name']:<18} trace {str(s['trace_id'])[:12]}"
                + (f"  open {s['age_s']:.3f}s" if s["age_s"] is not None
                   else "")
            )
    if pm["firing"]:
        lines.append("")
        lines.append("detectors firing at death:")
        for v in pm["firing"]:
            lines.append(
                f"  {v.get('detector', '?'):<28} key={v.get('key')}"
                + ("  [critical]" if v.get("critical") else "")
            )
    elif pm.get("health_error"):
        lines.append("")
        lines.append(
            f"  (health snapshot failed at dump: {pm['health_error']})"
        )
    if pm["tail"]:
        lines.append("")
        lines.append("final events:")
        for e in pm["tail"]:
            lines.append(
                f"  {str(e['event']):<34}"
                + (f" {e['age_s']:.3f}s before death"
                   if e["age_s"] is not None else "")
            )
    if pm["counters"]:
        lines.append("")
        lines.append("nonzero counters at death:")
        for k, v in pm["counters"].items():
            lines.append(f"  {k:<44} {v:g}")
    return "\n".join(lines) + "\n"
