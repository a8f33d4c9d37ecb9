"""The port's benchmark: one run of one cell on the card.

    python rpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's log on standard error, then each number compared with
the plain reference beside its limit, and as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``
last.  Exit codes: 0 a result was printed; 2 bad arguments; 3 the cell's
cards are missing; 4 JAX or the JAX package was loaded; 5 the program
(``randomprojection_tpu_torch``) is missing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches at fixed paths inside the checkout, so only a checkout's first
    run builds (the port's kernels build into its own ``build/torch_kernels``
    there)."""
    cache = CHECKOUT / "build" / "rpbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    from rpbench import harness

    if args.workload not in harness.names("workloads"):
        print(f"unknown workload {args.workload!r}; cells: "
              f"{', '.join(harness.names('workloads'))}", file=sys.stderr)
        return 2
    try:
        import randomprojection_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 5
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START)
    except harness.NoChip as e:
        print(str(e), file=sys.stderr)
        return 3
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print(f"modules that must not load were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
