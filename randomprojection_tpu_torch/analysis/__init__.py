"""Static analysis for the port's hand-enforced contracts (rplint).

The streaming and serving stack is held together by conventions that
only code review would otherwise enforce: spans must always be ended,
queues must be bounded, threads must be joined on every shutdown path,
hot paths must not block on host syncs (not even one call away),
``non_blocking`` copies must be ordered by an event before their data
is read, emitted event names must stay in agreement with
``telemetry.EVENTS`` / ``trace_report`` / the docs, and broad
``except`` handlers must not swallow errors silently.

``rplint`` turns those conventions into rules (RP00–RP14, see
``rplint.RULES``): ``cfg.py`` builds statement-level CFGs, lexical lock
regions, thread-role discovery and a one-level intra-package call
index; ``flowrules.py`` implements the path-sensitive rules (RP07
asynchronous-copy discipline, RP08 thread/queue protocol, RP09
interprocedural host-sync, RP10 cross-thread shared-state races, RP11
lock-order deadlocks, RP12 resource lifecycle, RP13 durable commits,
RP14 degraded paths) on top; ``rplint.py`` keeps the per-line rules,
the pragma grammar, and the CLI.  It is the port's own copy of the
reference package's linter, with the same rule ids, pragma grammar,
exit codes, ``--json`` record and SARIF output.  Each finding is
suppressible per line with an inline pragma carrying a reason::

    # rplint: allow[RP03] — d2h already started at dispatch

Entry point: ``python -m randomprojection_tpu_torch lint`` (runs over
the package and must exit 0 — exit 1 means findings, exit 2 an internal
error, never silent success off a partial run; ``--baseline JSON``
fails only on findings not in a prior ``--json`` record,
``--update-baseline`` rewrites it, ``--sarif PATH`` writes SARIF 2.1.0,
``--jobs N`` fans the files out over processes), and the library
surface below for programmatic use.  Pure stdlib — importing this
package pulls in neither torch nor JAX nor the reference package.
"""

from randomprojection_tpu_torch.analysis.rplint import (
    RULES,
    Finding,
    check_registry_drift,
    diff_baseline,
    lint_package,
    lint_source,
    load_event_registry,
    main,
    to_sarif,
)

__all__ = [
    "RULES",
    "Finding",
    "check_registry_drift",
    "diff_baseline",
    "lint_package",
    "lint_source",
    "load_event_registry",
    "main",
    "to_sarif",
]
