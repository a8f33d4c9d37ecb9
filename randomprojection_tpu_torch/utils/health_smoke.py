"""Prove the health plane end to end on a device (a copy of the
reference's ``randomprojection_tpu/utils/health_smoke.py``):

    python -m randomprojection_tpu_torch.utils.health_smoke [--device cpu]

Three scenarios, all through real surfaces (the CLI's flags, real HTTP, a
real subprocess kill); no detector is driven by hand:

1. **SLO burn-rate fires and clears**: ``loadgen --health`` on the device
   with a latency target every request misses and a ``--settle`` window:
   ``GET /health`` answers 503 mid-run and 200 again during the settle,
   and the ``--telemetry-jsonl`` file carries ``health.slo_burn``'s
   ``firing`` and ``cleared``.
2. **An induced stall trips the watchdog**: an in-process ``HealthEngine``
   with a 1 s stall timeout watches a stage that heartbeats while the
   queue depth sits pinned, then goes silent: ``health.stall`` fires
   within the timeout (plus tick slack) and dumps the attached
   ``FlightRecorder``.
3. **SIGTERM leaves a postmortem**: a ``stream-bench --flight-dump``
   subprocess on the device is killed with SIGTERM mid-run: it dies by
   the signal, the dump parses, and ``doctor --postmortem`` names a real
   stage as last active.

Exit 0 on success (prints ``health-smoke OK``), 1 with per-scenario
diagnostics otherwise; with no card and no ``--device cpu`` it exits
naming the card.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

__all__ = ["main"]

# the stages a port stream's batch trace carries (``read`` since the CLI's
# stream-bench passes ``stats=``)
_STAGES = ("read", "hash", "enqueue_wait", "h2d", "dispatch", "d2h", "batch")


def _get_health(port: int) -> tuple:
    """``(status, body_dict)`` for one ``GET /health`` probe."""
    url = f"http://127.0.0.1:{port}/health"
    try:
        with urllib.request.urlopen(url, timeout=5.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _scenario_burn(tmp: str, device: str) -> list:
    """Scenario 1: loadgen overload ⇒ 503 + firing, settle ⇒ 200 +
    cleared.  Returns a list of failure strings (empty = pass)."""
    from randomprojection_tpu_torch import cli
    from randomprojection_tpu_torch.utils.telemetry import EVENTS, read_events

    jsonl = os.path.join(tmp, "burn_telemetry.jsonl")
    args = [
        "loadgen", "--rate", "150", "--duration", "2",
        "--index-codes", "2048", "--code-bytes", "16", "--m", "4",
        "--request-rows", "8,16", "--metrics-port", "0",
        # 0.001 ms p99 target: every request violates ⇒ burn = 1/budget;
        # short windows so the settle window is long enough to clear
        "--health", "0.001,fast=1,slow=2.5,tick=0.1,stall=30",
        "--settle", "6", "--telemetry-jsonl", jsonl, "--device", device,
    ]
    err: list = []

    def run():
        try:
            cli.main(list(args))
        except BaseException as e:  # surfaced after join, below
            err.append(f"loadgen raised: {e!r}")

    saw_503 = False
    saw_200_after = False
    t = threading.Thread(target=run, name="rp-torch-health-smoke-loadgen",
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline and t.is_alive():
        server = cli._METRICS_SERVER
        if server is None:
            time.sleep(0.02)
            continue
        try:
            code, _ = _get_health(server.port)
        except OSError:
            time.sleep(0.05)
            continue
        if code == 503:
            saw_503 = True
        elif code == 200 and saw_503:
            saw_200_after = True
            break
        time.sleep(0.1)
    t.join(timeout=60.0)
    fails = list(err)
    if t.is_alive():
        return fails + ["loadgen wedged: thread alive after 60s join"]
    if not saw_503:
        fails.append(
            "GET /health never answered 503 while every request "
            "violated the 0.001ms target"
        )
    if saw_503 and not saw_200_after:
        fails.append(
            "GET /health never recovered to 200 during the --settle "
            "window"
        )
    statuses = set()
    if os.path.exists(jsonl):
        for e in read_events(jsonl):
            if e.get("event") == EVENTS.HEALTH_SLO_BURN:
                statuses.add(e.get("status"))
    if "firing" not in statuses or "cleared" not in statuses:
        fails.append(
            f"telemetry JSONL carries health.slo_burn statuses "
            f"{sorted(statuses)}, want both 'firing' and 'cleared'"
        )
    return fails


def _scenario_stall(tmp: str, device: str) -> list:
    """Scenario 2: heartbeat then silence with a pinned queue ⇒
    ``health.stall`` within the configured timeout, and a watchdog-trip
    flight dump."""
    from randomprojection_tpu_torch.utils import health, telemetry
    from randomprojection_tpu_torch.utils.telemetry import EVENTS

    dump_path = os.path.join(tmp, "stall_dump.json")
    timeout_s = 1.0
    recorder = telemetry.FlightRecorder()
    rec_sub = telemetry.subscribe(recorder, name="flight-recorder")
    try:
        recorder.install(dump_path, signals=(), on_exception=False)
        engine = health.HealthEngine(
            slo=health.parse_slo_spec(f"stall={timeout_s},tick=0.1"),
            recorder=recorder,
        ).start()
    except BaseException:
        # a failed downstream acquire must not leak the already-live
        # subscription (its dispatch thread would pin the process)
        telemetry.unsubscribe(rec_sub)
        raise
    recorder.attach_health(engine.active)
    fails: list = []
    try:
        # the stage heartbeats while the queue-depth signal pins at
        # capacity... then everything goes silent (the wedge)
        for _ in range(5):
            with telemetry.span("hash"):
                pass
            telemetry.emit(
                EVENTS.STREAM_PREFETCH_DELIVER, queue_depth=2, capacity=2
            )
            time.sleep(0.02)
        silent_t0 = time.monotonic()
        fired_at = None
        while time.monotonic() - silent_t0 < timeout_s * 4 + 2.0:
            if any(
                v["detector"] == EVENTS.HEALTH_STALL
                for v in engine.active()
            ):
                fired_at = time.monotonic() - silent_t0
                break
            time.sleep(0.05)
        if fired_at is None:
            fails.append(
                f"health.stall never fired within "
                f"{timeout_s * 4 + 2.0:.1f}s of silence"
            )
        elif fired_at < timeout_s:
            fails.append(
                f"health.stall fired after only {fired_at:.2f}s of "
                f"silence — before the {timeout_s}s timeout"
            )
        # the watchdog trip must have dumped the flight recorder
        t0 = time.monotonic()
        while not os.path.exists(dump_path) and time.monotonic() - t0 < 5:
            time.sleep(0.05)
        if not os.path.exists(dump_path):
            fails.append("watchdog trip left no flight-recorder dump")
        else:
            with open(dump_path) as f:
                dump = json.load(f)
            if not str(dump.get("reason", "")).startswith("watchdog:"):
                fails.append(
                    f"dump reason {dump.get('reason')!r} is not a "
                    "watchdog trip"
                )
    finally:
        engine.close()
        recorder.uninstall()
        telemetry.unsubscribe(rec_sub)
    return fails


def _scenario_sigterm(tmp: str, device: str) -> list:
    """Scenario 3: SIGTERM a real ``stream-bench --flight-dump`` run on
    ``device``, then render the dump with ``doctor --postmortem``."""
    from randomprojection_tpu_torch import cli

    dump_path = os.path.join(tmp, "sigterm_dump.json")
    jsonl = os.path.join(tmp, "sigterm_telemetry.jsonl")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "randomprojection_tpu_torch",
            "stream-bench", "--rows", "80000000", "--d", "256", "--k", "32",
            "--batch-rows", "8192", "--device", device,
            "--prefetch-batches", "2", "--flight-dump", dump_path,
            "--telemetry-jsonl", jsonl,
        ],
        env=_child_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    fails: list = []
    try:
        # wait until the pipeline is demonstrably mid-flight (span
        # events on the JSONL), then kill
        t0 = time.monotonic()
        while time.monotonic() - t0 < 60:
            if proc.poll() is not None:
                return [
                    f"stream-bench exited rc={proc.returncode} before "
                    "the kill — rows too low to stay busy?"
                ]
            if os.path.exists(jsonl) and os.path.getsize(jsonl) > 4096:
                break
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return ["stream-bench did not die within 30s of SIGTERM"]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != -signal.SIGTERM:
        # the handler must re-raise so the exit code stays the
        # signal's, not a clean 0 that would fool a supervisor
        fails.append(f"exit code {rc}, want SIGTERM death (-15)")
    if not os.path.exists(dump_path):
        return fails + ["SIGTERM left no flight-recorder dump"]
    with open(dump_path) as f:
        dump = json.load(f)
    if not str(dump.get("reason", "")).startswith("signal:"):
        fails.append(
            f"dump reason {dump.get('reason')!r}, want 'signal:SIGTERM'"
        )
    # the doctor face: render through the real CLI and check it names
    # a real pipeline stage as last-active
    from io import StringIO

    buf = StringIO()
    stdout, sys.stdout = sys.stdout, buf
    try:
        cli.main(["doctor", "--postmortem", dump_path])
    except BaseException as e:
        fails.append(f"doctor --postmortem raised: {e!r}")
    finally:
        sys.stdout = stdout
    text = buf.getvalue()
    known_stages = _STAGES
    named = None
    for line in text.splitlines():
        if line.startswith("  last active stage:"):
            named = line.split(":", 1)[1].strip()
    if named not in known_stages:
        fails.append(
            f"doctor --postmortem named last-active stage {named!r}, "
            f"want one of {known_stages}"
        )
    return fails


def _child_env() -> dict:
    """The environment of a child ``python -m randomprojection_tpu_torch``:
    this process's, with the package's root on ``PYTHONPATH``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p
    )
    return env


def main(argv=None) -> int:
    import argparse

    from randomprojection_tpu_torch.backends.torch_backend import (
        resolve_device,
    )

    p = argparse.ArgumentParser(
        prog="python -m randomprojection_tpu_torch.utils.health_smoke")
    p.add_argument("--device", default=None,
                   help="'cuda' (default: the card; exits without one) or "
                        "'cpu'")
    a = p.parse_args(argv)
    try:
        device = str(resolve_device(a.device, how="--device cpu"))
    except RuntimeError as e:
        raise SystemExit(str(e))
    failures: dict = {}
    with tempfile.TemporaryDirectory(prefix="rp_health_smoke_") as tmp:
        for name, fn in (
            ("slo-burn-rate", _scenario_burn),
            ("stall-watchdog", _scenario_stall),
            ("sigterm-postmortem", _scenario_sigterm),
        ):
            fails = fn(tmp, device)
            if fails:
                failures[name] = fails
    if failures:
        for name, fails in failures.items():
            for f in fails:
                print(f"health-smoke FAIL [{name}]: {f}",
                      file=sys.stderr)
        return 1
    print(
        "health-smoke OK: SLO burn-rate fired and cleared over real "
        "HTTP (503→200) with both lifecycle events on the JSONL, an "
        "induced stall tripped the watchdog inside its timeout and "
        "dumped the flight recorder, and a SIGTERM'd stream-bench left "
        "a postmortem the doctor renders with the last-active stage"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
