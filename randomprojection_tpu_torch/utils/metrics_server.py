"""Scrapeable live-metrics HTTP endpoint (a copy of the reference's
``randomprojection_tpu/utils/metrics_server.py``; the port imports nothing
of that package).

- **MetricsServer** — a stdlib ``ThreadingHTTPServer`` bound to
  ``host:port`` (``port=0`` = ephemeral, read ``.port`` back) on one
  daemon thread (``rp-torch-metrics-server``), serving ``GET /metrics``:
  the OpenMetrics exposition (``telemetry.to_openmetrics``) of the
  process-wide registry, every snapshot source registered with
  ``add_source`` (a stream's ``StreamStats`` registry) and, with an
  ``aggregator`` (``telemetry.LiveAggregator``), its rolling-window
  gauges.  With a ``health`` engine, ``GET /health`` answers 200 while
  ``ok()`` and 503 while a critical detector fires.  ``close()`` shuts
  the listener down and joins the thread.  A scrape failure never reaches
  the serving process.
- **fetch_metrics / parse_openmetrics** — the scrape client
  (``doctor --live``): the text over HTTP, parsed into ``{name: value}``
  and ``{name: {label_sig: value}}``.
- **render_live / live_snapshot_json** — the refreshing terminal view
  ``doctor --live`` prints (queue depth, live stage walls, serve-latency
  quantiles, health verdicts, degraded-counter rates), or one JSON line a
  poll.

The CLI's ``--metrics-port PORT`` starts a ``MetricsServer`` with a
subscribed ``LiveAggregator`` for the duration of a command.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional, Tuple

from randomprojection_tpu_torch.utils import telemetry

__all__ = [
    "MetricsServer",
    "fetch_metrics",
    "parse_openmetrics",
    "render_live",
    "live_snapshot_json",
]


class MetricsServer:
    """Background HTTP server exposing ``GET /metrics`` (and ``/``) as
    an OpenMetrics text exposition of the process registry + registered
    sources + the live aggregator window (see module docstring).

    ``sources`` / ``add_source`` take zero-arg callables returning
    ``MetricsRegistry.snapshot()``-shaped dicts, evaluated at scrape
    time — a source that raises is skipped for that scrape (the
    endpoint must keep answering while a stream is tearing down).

    With a ``health`` engine attached (anything exposing ``ok()`` and
    ``active()`` — ``health.HealthEngine``), the server also answers
    ``GET /health``: 200 while ``ok()``, 503 while any critical
    detector fires, JSON body listing the active verdicts either way —
    the ops-probe surface a load balancer or systemd watchdog polls.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 aggregator=None, sources=None, health=None,
                 start: bool = True):
        self.host = host
        self._requested_port = int(port)
        self.aggregator = aggregator
        self.health = health
        self._lock = threading.Lock()
        self._sources: List[Callable[[], dict]] = list(sources or ())
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- exposition ----------------------------------------------------------

    def add_source(self, fn: Callable[[], dict]) -> None:
        """Register an extra snapshot source (e.g. a ``StreamStats``
        registry's ``.snapshot`` bound method) for every future
        scrape."""
        with self._lock:
            self._sources.append(fn)

    def remove_source(self, fn: Callable[[], dict]) -> None:
        with self._lock:
            try:
                self._sources.remove(fn)
            except ValueError:
                pass

    def exposition(self) -> str:
        """The OpenMetrics text a scrape returns right now."""
        with self._lock:
            sources = list(self._sources)
        snaps = [telemetry.registry().snapshot()]
        for fn in sources:
            try:
                snaps.append(fn())
            except Exception:
                # a torn-down stream's source must not kill the scrape;
                # count it so a permanently-broken source is visible
                telemetry.registry().counter_inc(
                    "metrics.server.source_errors"
                )
        agg = self.aggregator
        if agg is not None:
            try:
                snaps.append(agg.registry_snapshot())
            except Exception:
                telemetry.registry().counter_inc(
                    "metrics.server.source_errors"
                )
        return telemetry.to_openmetrics(*snaps)

    def health_response(self) -> Tuple[int, str]:
        """``(status, json_body)`` for ``GET /health``: 503 while any
        critical detector fires, 200 otherwise.  With no engine
        attached the endpoint stays honest — 200, ``attached: false``
        (the probe learns the plane is up but ungraded)."""
        eng = self.health
        if eng is None:
            return 200, json.dumps(
                {"ok": True, "attached": False, "active": []}
            )
        ok = bool(eng.ok())
        return (200 if ok else 503), json.dumps(
            {"ok": ok, "attached": True, "active": eng.active()},
            sort_keys=True, default=str,
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MetricsServer":
        if self._thread is not None:
            raise RuntimeError("MetricsServer already started")
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path == "/health":
                    try:
                        status, body_text = server.health_response()
                    except Exception:
                        # an engine mid-teardown must not kill the
                        # probe; 500 = plane up, grading broken
                        telemetry.registry().counter_inc(
                            "metrics.server.render_errors"
                        )
                        self.send_response(500)
                        self.end_headers()
                        return
                    body = body_text.encode("utf-8")
                    self.send_response(status)
                    self.send_header(
                        "Content-Type", "application/json; charset=utf-8"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    body = server.exposition().encode("utf-8")
                except Exception:
                    # the scrape must answer SOMETHING; a 500 tells the
                    # poller the plane is up but the render broke
                    telemetry.registry().counter_inc(
                        "metrics.server.render_errors"
                    )
                    self.send_response(500)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler
        )
        # connection handler threads must not pin a dying process
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="rp-torch-metrics-server", daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        """The BOUND port (meaningful after ``start`` — with
        ``port=0`` this is the ephemeral port the OS picked)."""
        if self._httpd is None:
            return self._requested_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        """Stop the listener and join the serving thread.  Idempotent."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- scrape client (doctor --live) -------------------------------------------


def fetch_metrics(host: str, port: int, timeout: float = 5.0) -> str:
    """One HTTP scrape of ``http://host:port/metrics``; returns the raw
    exposition text (raises ``OSError``/``urllib.error.URLError`` on an
    unreachable endpoint — the caller renders the failure)."""
    from urllib.request import urlopen

    with urlopen(f"http://{host}:{port}/metrics", timeout=timeout) as r:
        return r.read().decode("utf-8")


def parse_openmetrics(text: str) -> Tuple[Dict[str, float], Dict[str, dict]]:
    """Parse an OpenMetrics text exposition (the dialect
    ``to_openmetrics`` writes) into ``(plain, labeled)``:

    - ``plain``: ``{name: value}`` for unlabeled samples;
    - ``labeled``: ``{name: {label_sig: value}}`` for labeled samples
      (``label_sig`` is the raw ``key="value",...`` text between the
      braces — enough for the live doctor's quantile/bucket views
      without a full PromQL parser).
    """
    plain: Dict[str, float] = {}
    labeled: Dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            continue
        try:
            value = float(value_part)
        except ValueError:
            continue
        if "{" in name_part and name_part.endswith("}"):
            name, _, rest = name_part.partition("{")
            labeled.setdefault(name, {})[rest[:-1]] = value
        else:
            plain[name_part] = value
    return plain, labeled


# -- live terminal view ------------------------------------------------------


def _rate_lines(plain: Dict[str, float], prev: Optional[Dict[str, float]],
                interval_s: float) -> List[str]:
    """Counter deltas/s between two polls for the degraded/reject
    counters the doctor audits post-hoc."""
    watch = (
        "rp_backend_vmem_oom_retries_total",
        "rp_kernel_dma_fallbacks_total",
        "rp_simhash_topk_dense_fallbacks_total",
        "rp_simhash_topk_scan_fallbacks_total",
        "rp_serve_topk_rejects_total",
        "rp_serve_topk_errors_total",
        "rp_telemetry_subscriber_dropped_total",
        "rp_telemetry_subscriber_errors_total",
    )
    # per-subscriber drop counters: the aggregate above
    # cannot say WHICH observer is chronically overrun, so surface every
    # rp_telemetry_subscriber_<name>_dropped_total as its own rate line
    per_sub = tuple(sorted(
        name for name in plain
        if name.startswith("rp_telemetry_subscriber_")
        and name.endswith("_dropped_total")
        and name != "rp_telemetry_subscriber_dropped_total"
    ))
    out = []
    for name in watch + per_sub:
        cur = plain.get(name)
        if cur is None:
            continue
        if prev is None or interval_s <= 0:
            out.append(f"  {name:<44} {cur:.0f} total")
        else:
            delta = cur - prev.get(name, 0.0)
            out.append(
                f"  {name:<44} {cur:.0f} total  "
                f"(+{delta / interval_s:.2f}/s)"
            )
    return out


def _health_lines(plain: Dict[str, float]) -> List[str]:
    """Active health-verdict gauges (``rp_health_*_firing``, mirrored
    by ``health.HealthEngine`` each tick) for the live view."""
    out = []
    for name in sorted(plain):
        if not (name.startswith("rp_health_") and name.endswith("_firing")):
            continue
        n = plain[name]
        detector = name[len("rp_health_"):-len("_firing")]
        state = f"FIRING x{n:.0f}" if n else "ok"
        out.append(f"  {detector:<24} {state}")
    return out


def render_live(plain: Dict[str, float], labeled: Dict[str, dict],
                prev: Optional[Dict[str, float]] = None, *,
                interval_s: float = 0.0, endpoint: str = "",
                poll: int = 0) -> str:
    """Render one poll of a live scrape as the refreshing terminal view
    ``cli doctor --live`` prints: queue depth, live span window, serve-
    latency quantiles, degraded-counter rates."""
    lines = [
        f"live doctor: {endpoint} — poll #{poll}"
        + (f" (every {interval_s:g}s)" if interval_s else "")
    ]
    depth = plain.get("rp_live_queue_depth",
                      plain.get("rp_stream_queue_depth"))
    if depth is not None:
        cap = plain.get("rp_live_queue_capacity")
        age = plain.get("rp_live_queue_depth_age_s")
        mean = plain.get("rp_live_queue_depth_mean")
        lines.append(
            "queue depth: "
            f"{depth:.0f}"
            + (f"/{cap:.0f}" if cap is not None else "")
            + (f", window mean {mean:.2f}" if mean is not None else "")
            + (f", last sample {age:.1f}s ago" if age is not None else "")
        )
    stages = sorted(
        (name[len("rp_live_span_"):-len("_wall_s")], v)
        for name, v in plain.items()
        if name.startswith("rp_live_span_") and name.endswith("_wall_s")
    )
    if stages:
        lines.append("live span window (summed wall):")
        for sname, wall in stages:
            cnt = plain.get(f"rp_live_span_{sname}_count")
            lines.append(
                f"  {sname:<18} {wall:8.4f}s"
                + (f"  x{cnt:.0f}" if cnt is not None else "")
            )
    lat = sorted(
        (name, qs) for name, qs in labeled.items()
        if "latency" in name and name.endswith("_quantile")
    )
    if lat:
        lines.append("serve latency quantiles:")
        for name, qs in lat:
            short = name[len("rp_"):-len("_seconds_quantile")]
            by_q = {}
            for sig, v in qs.items():
                q = sig.split("=", 1)[-1].strip('"')
                by_q[q] = v
            lines.append(
                f"  {short:<34} "
                + "  ".join(
                    f"p{float(q) * 100:g}={by_q[q] * 1e3:.2f}ms"
                    for q in sorted(by_q, key=float)
                )
            )
    health = _health_lines(plain)
    if health:
        lines.append("health verdicts:")
        lines.extend(health)
    rates = _rate_lines(plain, prev, interval_s)
    if rates:
        lines.append("degraded counters:")
        lines.extend(rates)
    if len(lines) == 1:
        lines.append("(no live metrics yet — is anything running?)")
    return "\n".join(lines) + "\n"


def live_snapshot_json(plain: Dict[str, float],
                       labeled: Dict[str, dict]) -> str:
    """One poll as a JSON line (``doctor --live --json``)."""
    return json.dumps({"metrics": plain, "labeled": labeled},
                      sort_keys=True)
