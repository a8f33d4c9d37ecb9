"""Prove the live observability plane end to end on a device (a copy of
the reference's ``randomprojection_tpu/utils/live_smoke.py``):

    python -m randomprojection_tpu_torch.utils.live_smoke [--device cpu]

Runs ``stream-bench --metrics-port 0 --device DEV`` (the CLI's path: the
flag subscribes a ``LiveAggregator`` and starts the HTTP endpoint) on a
worker thread, and scrapes ``/metrics`` over real HTTP while the bench is
still streaming.  It passes only when one mid-run scrape is a valid
OpenMetrics exposition with histogram ``_bucket{le=...}`` lines,
``_quantile{quantile=...}`` summary lines and a nonzero span-derived live
gauge (``rp_live_span_*_wall_s``): spans flowed emitter → subscriber queue
→ dispatch thread → rolling window → exposition with no JSONL file.

Exit 0 on success (prints ``live-smoke OK``), 1 with diagnostics
otherwise; with no card and no ``--device cpu`` it exits naming the card.
"""

from __future__ import annotations

import sys
import threading
import time

__all__ = ["main"]

_BENCH_ARGS = [
    "stream-bench", "--rows", "600000", "--d", "256", "--k", "32",
    "--batch-rows", "8192", "--prefetch-batches", "2", "--metrics-port", "0",
]


def _validate(text: str) -> dict:
    """Predicate bundle over one scrape; returns the check dict (all
    True = the smoke's mid-run scrape is good)."""
    from randomprojection_tpu_torch.utils.metrics_server import parse_openmetrics

    plain, labeled = parse_openmetrics(text)
    live_span_nonzero = any(
        name.startswith("rp_live_span_") and name.endswith("_wall_s")
        and value > 0
        for name, value in plain.items()
    )
    return {
        "eof_terminated": text.endswith("# EOF\n"),
        "parses": bool(plain) or bool(labeled),
        "histogram_buckets": any(
            name.endswith("_bucket") for name in labeled
        ),
        "quantile_lines": any(
            name.endswith("_quantile") for name in labeled
        ),
        "live_span_gauge_nonzero": live_span_nonzero,
    }


def main(argv=None) -> int:
    import argparse

    from randomprojection_tpu_torch import cli
    from randomprojection_tpu_torch.backends.torch_backend import (
        resolve_device,
    )
    from randomprojection_tpu_torch.utils.metrics_server import fetch_metrics

    p = argparse.ArgumentParser(
        prog="python -m randomprojection_tpu_torch.utils.live_smoke")
    p.add_argument("--device", default=None,
                   help="'cuda' (default: the card; exits without one) or "
                        "'cpu'")
    a = p.parse_args(argv)
    try:
        device = str(resolve_device(a.device, how="--device cpu"))
    except RuntimeError as e:
        raise SystemExit(str(e))
    bench_err: list = []

    def bench():
        try:
            cli.main([*_BENCH_ARGS, "--device", device])
        except BaseException as e:  # surfaced after join, below
            bench_err.append(e)

    good: dict = {}
    last_checks: dict = {}
    scrapes = 0
    t = threading.Thread(target=bench, name="rp-torch-live-smoke-bench",
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            server = cli._METRICS_SERVER
            if server is None:
                if not t.is_alive() and scrapes == 0:
                    break  # bench died before the endpoint came up
                time.sleep(0.02)
                continue
            try:
                port = server.port
                text = fetch_metrics("127.0.0.1", port, timeout=5.0)
            except OSError:
                # the run (and its endpoint) just ended — stop scraping
                if not t.is_alive():
                    break
                time.sleep(0.02)
                continue
            scrapes += 1
            checks = _validate(text)
            last_checks = checks
            if all(checks.values()):
                good = checks
                break
            time.sleep(0.05)
    finally:
        # bounded: a wedged stream-bench (the daemon thread never
        # exiting) must fail the smoke loudly, not hang it
        t.join(timeout=60.0)
    if t.is_alive():
        print(
            "live-smoke FAIL: stream-bench wedged — its thread is "
            "still alive 60s after the scrape deadline",
            file=sys.stderr,
        )
        return 1
    if bench_err:
        print(f"live-smoke FAIL: stream-bench raised: {bench_err[0]!r}",
              file=sys.stderr)
        return 1
    if not good:
        detail = (
            f"last scrape's checks: {last_checks}"
            if scrapes
            else "endpoint never answered — did --metrics-port start?"
        )
        print(
            f"live-smoke FAIL: no mid-run scrape satisfied every check "
            f"({scrapes} scrape(s) taken; {detail})",
            file=sys.stderr,
        )
        return 1
    print(
        f"live-smoke OK: mid-run HTTP scrape is valid OpenMetrics with "
        f"histogram buckets + quantile summaries and a nonzero "
        f"span-derived live gauge ({scrapes} scrape(s))"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
