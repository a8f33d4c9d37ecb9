"""One run of one cell: set-up, the measured window, the check, the line.

A cell is ``workloads/<cell>.json``: its configuration (``configs/``), its
traffic (``traffic/``), the driver that runs it (``drivers/<driver>.py``)
and its chips.  A per-layer metric is an entry of ``BENCHMARK.json``'s
``per_layer`` and a reader, ``metrics/<metric>.py`` or, for a metric
split by the end-to-end metric it moves (``device_idle_pct.rows``), the
reader of its first part (``metrics/device_idle_pct.py``).  All are found
by name, so a later cell, configuration or metric is new files and an
entry, and a cell reads only the metrics whose entry names it.

A driver module holds ``E2E`` (its end-to-end metrics and their units)
and ``Driver(ctx)`` with ``setup()``, ``window(seconds)`` (returns the
end-to-end values and sets ``attempted``/``failed``), ``release()`` (frees
the program's state), ``check()`` (the comparison with the plain
reference: a list of ``(name, value, limit)``, each correct when value <=
limit) and ``close()``.  What the traced window collects for the
per-layer readers goes into ``ctx.layer``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "randomprojection_tpu")


class NoChip(RuntimeError):
    """The cell's chips are not there."""


def load(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def names(kind: str, suffix: str = ".json") -> list:
    """The names of every file of one kind (the cells, the metrics...)."""
    return sorted(p.name[:-len(suffix)] for p in (ROOT / kind).glob(
        f"*{suffix}") if not p.name.startswith("_"))


def benchmark() -> dict:
    """``BENCHMARK.json``, beside this folder at the checkout's root."""
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def per_layer(cell: str, e2e) -> list:
    """The cell's per-layer entries of ``BENCHMARK.json``: each whose
    ``workloads`` names the cell, or, without that key, whose ``moves`` is
    among the cell's end-to-end metrics ``e2e``."""
    return [m for m in benchmark()["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def metric_module(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else the
    reader of the name's first part (``device_idle_pct.rows`` →
    ``metrics/device_idle_pct.py``)."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.is_file():
        path = ROOT / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"rpbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules) -> list:
    """Top-level names among ``modules`` (compared whole) that a run must
    not have loaded."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


class Context:
    """What a driver is given: the cell, its configuration and traffic,
    the run's seed, the device, and ``layer`` for the traced window."""

    def __init__(self, cell: str, seed: int, device, trace: bool,
                 overrides: dict = None):
        overrides = overrides or {}
        self.cell = cell
        self.workload = {**load("workloads", cell),
                         **overrides.get("workload", {})}
        self.config = {**load("configs", self.workload["config"]),
                       **overrides.get("config", {})}
        self.traffic = {**load("traffic", self.workload["traffic"]),
                        **overrides.get("traffic", {})}
        self.seed = int(seed)
        self.device = device
        self.trace = bool(trace)
        #: the window's length (the traced window's with a trace)
        self.seconds = None
        self.layer: dict = {}

    @staticmethod
    def log(msg: str) -> None:
        print(f"[rpbench] {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_info(device, chips: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, overrides: dict = None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).
    ``device=None`` takes the card and raises ``NoChip`` without the
    cell's chips; tests pass a CPU device and small ``overrides``."""
    import torch

    ctx = Context(cell, seed, device, trace, overrides)
    chips = int(ctx.workload.get("chips", 1))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoChip(
                f"cell {cell} needs {chips} CUDA card(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = ctx.device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    if trace:
        seconds = min(seconds, float(ctx.workload.get("trace_seconds",
                                                      seconds)))
    ctx.seconds = seconds
    mod = importlib.import_module(f"rpbench.drivers.{ctx.workload['driver']}")
    drv = mod.Driver(ctx)
    try:
        drv.setup()
        # set-up's garbage collected now, so no full collection it causes
        # lands in the window
        gc.collect()
        _sync(device)
        setup_s = time.perf_counter() - t_start
        ctx.log(f"set-up {setup_s:.3f} s")
        if trace:
            from rpbench import trace as tr

            with tr.profiled() as held:
                with tr.span("window"):
                    e2e = drv.window(seconds)
                    _sync(device)
            red = tr.reduce(held.prof)
            ctx.layer["trace"] = red
        else:
            e2e = drv.window(seconds)
            _sync(device)
        dev_info = _device_info(device, chips)
        drv.release()
        checks = drv.check()
    finally:
        drv.close()
    correct = all(v <= lim for _n, v, lim in checks)
    if trace:
        metrics = {}
        for entry in per_layer(cell, mod.E2E):
            val = metric_module(entry["name"]).read(ctx)
            if val is not None:
                metrics[entry["name"]] = {"value": val, "unit": entry["unit"]}
        if red is not None:
            dev_info["busy_s"] = red["busy_s"]
            dev_info["window_s"] = red["window_s"]
    else:
        metrics = {name: {"value": e2e[name], "unit": unit}
                   for name, unit in mod.E2E.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    out = {"correct": bool(correct), "attempted": int(drv.attempted),
           "failed": int(drv.failed), "metrics": metrics, "device": dev_info}
    if trace and red is not None:
        from rpbench import trace as tr

        out["breakdown"] = tr.breakdown(red)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out
