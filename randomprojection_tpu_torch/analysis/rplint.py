"""rplint — AST-based invariant checker for the port's contracts.

Generic linters cannot see the contracts the streaming and serving
pipeline relies on (a ``start_span`` with no exception-safe ``end_span``
is legal Python; an unbounded ``queue.Queue()`` is idiomatic; a
``non_blocking`` copy with no event behind it runs fine until a reader
races it); this checker encodes them as project rules over the stdlib
``ast``.  It is the port's own copy of the reference package's linter:
the same rules, pragma grammar, exit codes, ``--json`` record, SARIF
output and baseline workflow, pointed at this package and taught its
idioms.  A shared CFG/call-graph substrate (``analysis/cfg.py``) feeds
the path-sensitive rules (``analysis/flowrules.py``); the per-line rules
live here.

- **RP01 span-balance** — a ``start_span`` whose handle neither escapes
  its function (returned / yielded / stored / passed on, e.g. through a
  pipeline queue) nor is closed by an ``end_span`` inside a ``finally``
  or ``except`` block leaks its span on the error path; and the
  ``span_start``/``span_end`` event pair may be emitted by
  ``utils/telemetry.py`` ONLY — hand-rolled span events bypass id
  allocation and corrupt trace reconstruction.
- **RP02 event-registry drift** — every statically-resolvable event
  name passed to ``emit()`` must be a member of ``telemetry.EVENTS``
  (f-string and ``FAMILY``-constant-anchored names must extend a
  registered ``FAMILIES`` prefix), and every registry member must be
  either consumed by ``utils/trace_report.py`` or documented in the
  repository's docs/ARCHITECTURE.md (the port's ``EVENTS`` equal the
  reference's, so one document serves both).  Names built dynamically
  are reported as ``unresolvable-emit`` *informational* findings — they
  never fail the lint, but ``--json`` counts them.
- **RP03 host-sync-in-hot-path** — inside loop bodies of the hot
  modules (``HOT_MODULES``), no host sync: torch's ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``
  and an event's or stream's ``.synchronize()``, ``np.asarray`` and
  ``float()``-on-expression (the reference's ``.block_until_ready`` and
  ``jax.device_get`` stay known and never match the port).  A
  per-iteration host sync serializes the card's work with the copy to
  the host.  (Lexically scoped to loops: the commit-point fetch a
  pipeline performs once per batch *outside* any loop is the design.)
- **RP04 thread hygiene** — every ``threading.Thread`` is constructed
  with an explicit ``daemon=`` and its module contains a ``.join(``;
  every ``queue.Queue()`` is constructed with a bound.
- **RP05 determinism** — inside ``ops/``: no ``time.time()``, no global
  ``random.*``, no legacy ``np.random.<fn>`` calls (Generator
  construction is allowed), no ``torch.manual_seed`` and no
  ``torch.rand``/``randn``/``randint``/``randperm``/``bernoulli``/
  ``normal`` without a ``generator=`` — RNG and clocks are threaded
  explicitly so kernels stay replayable.
- **RP06 silent-swallow** — broad ``except`` handlers (bare /
  ``Exception`` / ``BaseException``) in the pipeline/serving modules
  must re-raise, emit telemetry, or close the active span.
- **RP07 asynchronous-copy discipline** (flow-sensitive;
  ``ASYNC_COPY_MODULES``) — a ``non_blocking`` copy reaches a CUDA
  event's ``.record`` on every path out of its function (unless its
  tensor leaves inside a ``StagedBatch``); a ``StagedBatch``'s
  ``.tensor`` is read only after its ``.wait()``; the pinned host
  buffer of a device-to-host copy is read only after a
  ``.synchronize()`` that dominates the read.  The rule keeps the
  reference's id; the reference's Pallas DMA legs and its VMEM-budget
  cross-check have nothing to check here (the kernels' shared memory
  is allocated in ``csrc/*.cu``, outside any Python AST).
- **RP08 thread/queue protocol** (flow-sensitive) — every thread
  started in a function is joined on *every* path out of it (early
  returns, raises, try/finally modeled); threads stored on ``self`` are
  joined by the class, reachably from its close-like method; a
  shutdown-sentinel enqueue is unconditionally reachable from
  ``close()`` (only closed-flag idempotence guards may skip it); and no
  cursor commit dominates its batch's ``yield`` (ack-after-yield).
- **RP09 interprocedural host-sync** (hot modules) — RP03 one call
  deeper: a loop-body call resolved one level through the package
  (same-module defs, ``self.`` methods, ``from randomprojection_tpu_torch
  ... import`` names) whose callee performs an unsuppressed host sync is
  reported at the call site.
- **RP10 shared-state races** (concurrency modules) — thread roles
  derive from RP08's discovery (one role per ``Thread(target=…)``
  entry point plus the constructing "main" role, subclass hooks joining
  their base class's roles through the package index); per-role
  ``self.``-attribute read/write sets fold transitively one call level
  at a time with the lock context of each call site, and a cross-role
  write/write or read/write pair is a finding unless every access path
  holds the same lock, the value crosses roles only through the
  object's own method calls (the ``queue.Queue`` handoff), or every
  write dominates every ``.start()`` (init-only, by dominator query).
  Lock-holding classes and module globals *without* thread roles get
  the lock-consistency leg instead: state touched under a lock must
  hold it on every post-init access.
- **RP11 lock-order deadlocks** (concurrency modules) — the
  lock-acquisition ordering graph (nested ``with``-lock regions, one
  call level deep) must be acyclic, and no blocking call
  (``queue.put``, ``.join``, ``future.result``) may run while a lock is
  held.
- **RP12 resource lifecycle** (all modules) — RP01's span-balance
  engine generalized to paired acquire/release protocols: a telemetry
  subscription, ``MetricsServer``, ``HealthEngine``, ``open()`` handle,
  ``np.memmap``, or ``mkdtemp`` temp dir bound to a local must be
  released on every path out of the acquiring function (escaping
  handles exempt, ``if x is not None:`` release guards understood), and
  a later acquire outside any try while an earlier handle is live is
  flagged: if it raises, the earlier handle leaks.
- **RP13 durable-commit discipline** (durable/tiering/telemetry/
  streaming + the linter's own baseline writer) — every artifact landing
  goes tmp→flush→fsync→``os.replace`` (a raw ``open(final_path, "w")``
  is a finding), the manifest replace is dominated by every chunk/spill
  write of the same commit (manifest-committed-LAST by dominator query),
  and a directory fsync is reachable after the replace (helpers whose
  callers fsync the directory are exempt).
- **RP14 degraded-path audit** (kernel/LSH/tiering ladders) — every
  fallback rung (broad except that continues) reachably emits an event
  that ``trace_report.DEGRADED_EVENTS`` consumes or calls a
  degraded-rung recorder; classified rungs memoize their degraded key
  (the ``_NO_*_KEYS`` convention, CFG-reachability checked so the
  post-success ``.add()`` after a ladder loop counts); fallback counters
  need an adjacent event emit; and — the RP02-style reverse leg — every
  ``DEGRADED_EVENTS`` member must exist in the registry and be emitted
  somewhere outside trace_report.

Suppression pragma (same line as the finding, the line directly above
it, or any physical line of the same logical statement — so pragmas on
continuation lines work)::

    # rplint: allow[RP03] — d2h already started at dispatch
    # rplint: allow[RP04,RP06] — reason covering both rules

The reason is mandatory; a pragma that does not parse, names an unknown
rule, or omits the reason is itself reported (RP00) and suppresses
nothing.  A well-formed pragma that suppresses *nothing* — because the
code it excused has been edited away — is reported as a **stale
pragma** (RP00) when every rule it names was actually evaluated for
the file, so dead suppressions cannot accumulate.

Exit codes (``python -m randomprojection_tpu_torch lint`` inherits
them): **0** no unsuppressed finding, **1** findings, **2** internal
error (unreadable input, malformed baseline, analysis crash) — a partial
run can never report success.  ``--json`` emits the stable findings
schema (``rplint`` version, rule id, path, line, message, severity,
pragma state) — the reference's record, key for key, so either
package's ``diff_baseline`` reads the other's.  ``--baseline <json>``
diffs against a prior ``--json`` record and fails only on NEW findings
(matched on rule+path+message, so line drift never re-flags a baselined
finding).

The analysis prefers missing an exotic violation over flagging correct
code, because every false positive costs a pragma in the tree forever.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import dataclasses
import io
import json
import multiprocessing
import os
import re
import sys
import time
import tokenize
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from randomprojection_tpu_torch.analysis import flowrules
from randomprojection_tpu_torch.analysis.cfg import (
    PackageIndex,
    dotted as _dotted,
    index_module,
    parents_map as _parents,
)

__all__ = [
    "RULES",
    "Finding",
    "EventRegistry",
    "load_event_registry",
    "check_registry_drift",
    "load_degraded_events",
    "check_degraded_drift",
    "diff_baseline",
    "lint_source",
    "lint_package",
    "package_root",
    "to_sarif",
    "main",
]

RULES = {
    "RP00": "pragma hygiene: rplint pragmas parse as "
            "`# rplint: allow[RPxx] — <reason>` with known rules and a "
            "reason, and a pragma that suppresses nothing is stale",
    "RP01": "span-balance: start_span handles escape or end in a "
            "finally/except; span_* events are emitted only by "
            "utils/telemetry.py",
    "RP02": "event-registry drift: emitted event names live in "
            "telemetry.EVENTS, and every registry entry is consumed by "
            "trace_report.py or documented in ARCHITECTURE.md "
            "(dynamically-built names are counted as unresolvable-emit "
            "informational findings)",
    "RP03": "host-sync-in-hot-path: no .item() / .tolist() / .cpu() / "
            ".numpy() / torch.cuda.synchronize() / event or stream "
            ".synchronize() / np.asarray / float()-on-expression inside "
            "loop bodies of the hot modules",
    "RP04": "thread hygiene: threading.Thread has explicit daemon= and a "
            ".join( in the module; queue.Queue is bounded",
    "RP05": "determinism: no time.time(), global random.*, legacy "
            "np.random.<fn>, torch.manual_seed, or torch.rand/randn/"
            "randint/randperm/bernoulli/normal without generator= inside "
            "ops/",
    "RP06": "silent-swallow: broad except handlers in pipeline modules "
            "re-raise, emit telemetry, or close the span",
    "RP07": "asynchronous-copy discipline: a non_blocking .to()/.copy_() "
            "reaches a CUDA event record on every path out of its "
            "function unless its tensor leaves inside a StagedBatch; a "
            "StagedBatch's .tensor is read only after its .wait(); a "
            "device-to-host copy's pinned host buffer is read only after "
            "a dominating .synchronize().  (The reference's VMEM-budget "
            "leg is dropped: the port's kernels allocate shared memory "
            "inside csrc/*.cu, which no Python AST sees, and plan_project/"
            "plan_fused/plan_probe size it from the shape.)",
    "RP08": "thread/queue protocol: threads join on every shutdown path, "
            "close() reaches the shutdown sentinel unconditionally, and "
            "no cursor commit dominates its batch's yield",
    "RP09": "interprocedural host-sync: hot-module loops must not call a "
            "package helper (one level deep) that performs a host sync",
    "RP10": "shared-state races: state shared across thread roles needs "
            "a common lock on every access path, a queue handoff, or "
            "init-only writes that dominate the thread start",
    "RP11": "lock-order deadlocks: the lock-acquisition ordering graph "
            "must be acyclic, and no blocking call (queue.put / .join / "
            "future.result) may run while a lock is held",
    "RP12": "resource lifecycle: subscriptions, MetricsServer, "
            "HealthEngine, open()/np.memmap handles and mkdtemp dirs are "
            "released on every path out of the acquiring function, and "
            "no unprotected later acquire can leak an earlier live "
            "handle",
    "RP13": "durable-commit discipline: artifact writes go tmp→flush→"
            "fsync→os.replace, the manifest is committed last (dominated "
            "by every chunk/spill write), and a directory fsync is "
            "reachable after the replace",
    "RP14": "degraded-path audit: every fallback rung emits a "
            "DEGRADED_EVENTS-consumed event or calls a recorder, "
            "classified rungs memoize their degraded key, fallback "
            "counters sit next to their emit, and every DEGRADED_EVENTS "
            "member is registered and emitted somewhere",
}

# -- rule scoping (paths are package-relative, '/'-separated) ----------------
# Each module is the reference's own under the port's name:
# backends/jax_backend.py is backends/torch_backend.py, and
# ops/pallas_kernels.py is ops/fused_kernels.py.

TELEMETRY_MODULE = "utils/telemetry.py"
TRACE_REPORT_MODULE = "utils/trace_report.py"
ARCHITECTURE_DOC = os.path.join("docs", "ARCHITECTURE.md")
# RP03/RP09: the modules whose loops are the streamed/serving hot sections
HOT_MODULES = (
    "streaming.py",
    "backends/torch_backend.py",
    "ops/fused_kernels.py",
    "ops/topk_kernels.py",
    "models/sketch.py",
    "serving/sharded_index.py",
    "serving/server.py",
    # the live plane: the scrape handler runs while the pipeline serves,
    # and the loadgen submit loop IS an open-loop latency measurement —
    # a hidden host sync in either falsifies what they observe
    "utils/metrics_server.py",
    "loadgen.py",
    # the LSH candidate tier: probe + gather + re-rank is a serving hot
    # loop — a hidden host sync there re-serializes the dispatch/d2h
    # overlap the tier inherits from query_topk
    "ann/lsh.py",
    # the device probe path: the probe→gather→re-rank kernels run per
    # serving tile — a host sync here IS the host hop they remove
    "ops/probe_kernels.py",
    # the health plane: the engine's event fold + tick loop run for the
    # whole process lifetime beside the serving path — a host sync or
    # swallowed error there silently blinds every detector
    "utils/health.py",
    # tiered residency: the stager/gather/fetch path runs per serving
    # tile — a hidden host sync there re-serializes the cold-upload/
    # hot-kernel overlap the tier exists to provide
    "tiering.py",
)
# RP06: modules on the pipeline/serving path where a swallowed error
# strands a stream, a future, or a telemetry file
PIPELINE_MODULES = HOT_MODULES + (
    "ops/hashing.py",
    "utils/observability.py",
    TELEMETRY_MODULE,
    # the bench harness carries the transform-route knobs its records
    # depend on, and the doctor is the consumer of the kernel.dma.*
    # route records — a swallowed error in either silently falsifies a
    # measurement
    "benchmark.py",
    TRACE_REPORT_MODULE,
)
DETERMINISM_PREFIXES = ("ops/",)
# RP07: the modules that queue non_blocking copies between host and card
# or hand StagedBatch carriers on — the reference's Pallas kernel
# modules under their port names, plus the staging module, the stream's
# d2h fetch and the serving index's uploads
ASYNC_COPY_MODULES = (
    "ops/fused_kernels.py",
    "ops/topk_kernels.py",
    "ops/probe_kernels.py",
    "ops/staging.py",
    "backends/torch_backend.py",
    "models/sketch.py",
    "streaming.py",
    "tiering.py",
)
# RP10/RP11: the modules where threads and locks meet — the four
# thread/queue substrates (PrefetchSource + StagedIngestSource,
# TopKServer, ShardedTopKServer) plus the lock-holding telemetry,
# sharded-index and hashing modules
CONCURRENCY_MODULES = (
    "streaming.py",
    "models/sketch.py",
    "serving/server.py",
    "serving/sharded_index.py",
    "utils/telemetry.py",
    "ops/hashing.py",
    # the live plane: subscriber dispatch threads (telemetry, above),
    # the metrics HTTP serving thread, and loadgen's completion-callback
    # lock
    "utils/metrics_server.py",
    "loadgen.py",
    # the health plane: the engine lock is taken by both the subscriber
    # dispatch thread (event fold) and the tick thread (evaluate) — the
    # emit-outside-lock contract is exactly what RP10/RP11 police
    "utils/health.py",
    # tiered residency: the manager lock is taken by serving threads
    # (admission, access accounting) and the promotion/demotion worker
    # (residency swaps) — emit-outside-lock and never-put-under-lock are
    # exactly its correctness story
    "tiering.py",
)
# RP13: the modules that land durable artifacts — the snapshot/spill
# writers, the flight-recorder dump, the stream cursor, and the linter's
# own baseline/SARIF writer (it must practice the commit idiom it
# preaches)
RP13_MODULES = (
    "durable.py",
    "tiering.py",
    "utils/telemetry.py",
    "streaming.py",
    "analysis/rplint.py",
)
# RP14: the ladder modules whose fallback rungs the doctor must be able
# to see — the kernel ladders, the LSH probe ladder, the residency tier
# ladder, and the serving-side fallbacks
RP14_MODULES = (
    "ops/fused_kernels.py",
    "ops/topk_kernels.py",
    "ops/probe_kernels.py",
    "ann/lsh.py",
    "tiering.py",
    "models/sketch.py",
    "backends/torch_backend.py",
)
# RP05: Generator-construction surface of np.random that stays legal
RNG_FACTORY_OK = frozenset(
    {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
     "MT19937", "bit_generator"}
)
# RP05: torch's global-RNG draws (flagged unless given generator=) and
# its global seeders (always flagged)
TORCH_RNG_DRAWS = frozenset(
    {"rand", "randn", "randint", "randperm", "bernoulli", "normal"}
)
TORCH_SEEDERS = frozenset({"manual_seed", "manual_seed_all", "seed"})
# RP06: a handler containing a call to one of these has routed the error
# somewhere observable (record_vmem_oom_retry is the reference's shared
# degraded-retry recorder; note_fallback is the tiered residency layer's
# — it emits index.tier.fallback AND bumps the fallback counter)
RP06_MITIGATORS = frozenset(
    {"emit", "counter_inc", "end_span", "record_vmem_oom_retry",
     "note_fallback"}
)

_PRAGMA_RE = re.compile(r"#\s*rplint:\s*(.*)$")
_ALLOW_RE = re.compile(
    r"^allow\[([A-Za-z0-9_,\s]+)\]\s*(?:[—–]|--|-)\s*(\S.*)$"
)


@dataclasses.dataclass
class Finding:
    """One lint finding; ``suppressed`` marks a pragma'd (accepted)
    violation, ``reason`` carries the pragma's justification,
    ``severity`` is ``"error"`` (fails the lint) or ``"info"``
    (reported and counted, never fatal — the unresolvable-emit
    class)."""

    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""
    severity: str = "error"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "suppressed": self.suppressed,
            "reason": self.reason,
            "severity": self.severity,
        }

    def render(self) -> str:
        sup = "  [suppressed: %s]" % self.reason if self.suppressed else ""
        sev = " (info)" if self.severity == "info" else ""
        return f"{self.path}:{self.line}: {self.rule}{sev} {self.message}{sup}"


# -- pragma scanning ---------------------------------------------------------


@dataclasses.dataclass
class _Pragma:
    """One well-formed allow pragma: the comment's physical line, the
    rules it names, the mandatory reason, and whether it ended up
    suppressing anything (stale detection)."""

    line: int
    rules: Set[str]
    reason: str
    matched: bool = False


def _scan_pragmas(
    src: str, relpath: str
) -> Tuple[Dict[int, List[_Pragma]], List[Finding], List[_Pragma]]:
    """``{physical line: [pragmas attached there]}`` plus RP00 findings
    for malformed pragmas and the flat pragma list (for stale
    detection).  Comment tokens only — a pragma-shaped string literal
    is never a pragma.  A pragma on any physical line of a multi-line
    logical statement attaches to every line of that statement, so
    findings anchored at the statement's first line are suppressible
    from a continuation line."""
    allows: Dict[int, List[_Pragma]] = {}
    pragmas: List[_Pragma] = []
    findings: List[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        return allows, findings, pragmas  # ast.parse reported the syntax

    def parse(tok) -> Optional[_Pragma]:
        m = _PRAGMA_RE.search(tok.string)
        if m is None:
            return None
        line = tok.start[0]
        am = _ALLOW_RE.match(m.group(1).strip())
        if am is None:
            findings.append(Finding(
                "RP00", relpath, line,
                "unparseable rplint pragma (grammar: "
                "`# rplint: allow[RPxx] — <reason>`, reason required)",
            ))
            return None
        rules = {r.strip().upper() for r in am.group(1).split(",")
                 if r.strip()}
        unknown = sorted(rules - set(RULES))
        if unknown:
            # the whole pragma is void, including any known rules it
            # also names — a malformed pragma suppresses NOTHING, so a
            # typo can never silently accept a violation
            findings.append(Finding(
                "RP00", relpath, line,
                f"pragma names unknown rule(s): {', '.join(unknown)} — "
                "the pragma suppresses nothing",
            ))
            return None
        if not rules:
            return None
        return _Pragma(line, rules, am.group(2).strip())

    def register(p: _Pragma, lines) -> None:
        for ln in lines:
            lst = allows.setdefault(ln, [])
            if p not in lst:
                lst.append(p)

    span_start: Optional[int] = None
    pending: List[_Pragma] = []
    for tok in tokens:
        tt = tok.type
        if tt == tokenize.COMMENT:
            p = parse(tok)
            if p is not None:
                pragmas.append(p)
                register(p, [p.line])
                if span_start is not None:
                    pending.append(p)
            continue
        if tt == tokenize.NEWLINE:
            if span_start is not None and pending:
                # logical line ends: a pragma anywhere in it covers the
                # whole statement's physical span
                for p in pending:
                    register(p, range(span_start, tok.start[0] + 1))
            span_start = None
            pending = []
            continue
        if tt in (tokenize.NL, tokenize.INDENT, tokenize.DEDENT,
                  tokenize.ENDMARKER):
            continue
        if span_start is None:
            span_start = tok.start[0]
    return allows, findings, pragmas


# -- small AST helpers -------------------------------------------------------


def _callee(call: ast.Call) -> str:
    """Last path component of the callee ('emit' for telemetry.emit)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _own_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """Nodes lexically owned by ``scope``: its subtree minus the bodies
    of nested function definitions (each nested def owns its own)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, _FUNC_NODES + (ast.Lambda,)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _scopes(tree: ast.Module) -> List[ast.AST]:
    """The module plus every (possibly nested) function definition."""
    return [tree] + [
        n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)
    ]


def _imports_name(tree: ast.Module, module_suffix: str, name: str) -> bool:
    """True when ``from <...module_suffix> import <name>`` appears."""
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module and (
            n.module == module_suffix
            or n.module.endswith("." + module_suffix)
        ):
            if any(a.name == name for a in n.names):
                return True
    return False


def _is_emit_call(call: ast.Call, *, in_telemetry: bool,
                  emit_imported: bool) -> bool:
    """A call of the package's ``emit()``: ``telemetry.emit(...)``, a
    directly-imported ``emit(...)``, or (inside telemetry.py itself) the
    module-level ``emit(...)``.  ``TelemetryLog.emit``/arbitrary
    ``x.emit`` methods don't count — the registry governs the
    process-wide event stream, not every method named emit."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "emit":
        base = _dotted(f.value)
        return base == "telemetry" or base.endswith(".telemetry")
    if isinstance(f, ast.Name) and f.id == "emit":
        return emit_imported or in_telemetry
    return False


# -- the event registry (RP02) -----------------------------------------------


@dataclasses.dataclass
class EventRegistry:
    """Statically-parsed view of ``telemetry.EVENTS``: constant name →
    event string (families excluded), family prefixes, the source line
    of each constant (so drift findings anchor to the registry), and
    the family constant names (``*_FAMILY``) so a
    ``EVENTS.X_FAMILY + suffix`` concatenation resolves as a family
    extension."""

    events: Dict[str, str]
    families: Tuple[str, ...]
    lines: Dict[str, int]
    family_attrs: Dict[str, str] = dataclasses.field(default_factory=dict)

    def knows(self, name: str) -> bool:
        return name in self.events.values() or any(
            name.startswith(f) for f in self.families
        )


def load_event_registry(telemetry_src: str) -> Optional[EventRegistry]:
    """Parse the ``EVENTS`` class out of telemetry.py source (static —
    the linter never imports the package it checks)."""
    try:
        tree = ast.parse(telemetry_src)
    except SyntaxError:
        return None
    cls = next(
        (n for n in ast.walk(tree)
         if isinstance(n, ast.ClassDef) and n.name == "EVENTS"),
        None,
    )
    if cls is None:
        return None
    events: Dict[str, str] = {}
    lines: Dict[str, int] = {}
    families: List[str] = []
    family_attrs: Dict[str, str] = {}
    for stmt in cls.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            continue
        attr = stmt.targets[0].id
        if attr == "FAMILIES" and isinstance(stmt.value, ast.Tuple):
            families.extend(
                e.value for e in stmt.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            )
            continue
        if not (isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)):
            continue
        if attr.endswith("_FAMILY"):
            families.append(stmt.value.value)
            family_attrs[attr] = stmt.value.value
            continue
        events[attr] = stmt.value.value
        lines[attr] = stmt.lineno
    return EventRegistry(events, tuple(dict.fromkeys(families)), lines,
                         family_attrs)


def check_registry_drift(
    registry: EventRegistry,
    consumer_text: str,
    doc_text: str,
    telemetry_relpath: str = TELEMETRY_MODULE,
) -> List[Finding]:
    """RP02, registry side: every entry must be consumed by trace_report
    (by literal value or ``EVENTS.<NAME>`` reference) or documented in
    ARCHITECTURE.md — an event nobody reads and nobody documents is
    dead weight drifting away from reality."""
    findings = []
    for attr, value in sorted(registry.events.items()):
        consumed = (
            value in consumer_text or f"EVENTS.{attr}" in consumer_text
        )
        documented = value in doc_text
        if not (consumed or documented):
            findings.append(Finding(
                "RP02", telemetry_relpath,
                registry.lines.get(attr, 1),
                f"registry event {value!r} ({attr}) is neither consumed "
                "by trace_report.py nor documented in ARCHITECTURE.md",
            ))
    return findings


# -- the degraded-events contract (RP14, reverse leg) ------------------------


def load_degraded_events(consumer_text: str) -> Tuple[Set[str], int]:
    """Parse trace_report's ``DEGRADED_EVENTS = (EVENTS.X, ...)`` tuple
    into the attr-name set RP14's emit matching consumes, plus the
    assignment's line (so reverse-leg findings anchor there).  Returns
    ``(set(), 1)`` when the consumer is missing or unparsable — RP14's
    forward leg then accepts any ``EVENTS.*`` emit."""
    try:
        tree = ast.parse(consumer_text)
    except SyntaxError:
        return set(), 1
    for n in ast.walk(tree):
        if not isinstance(n, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "DEGRADED_EVENTS"
                   for t in n.targets):
            continue
        attrs = {
            sub.attr for sub in ast.walk(n.value)
            if isinstance(sub, ast.Attribute)
            and _dotted(sub.value).split(".")[-1] == "EVENTS"
        }
        return attrs, n.lineno
    return set(), 1


def check_degraded_drift(
    degraded: Set[str],
    degraded_line: int,
    registry: EventRegistry,
    sources: Sequence[Tuple[str, str]],
    consumer_relpath: str = TRACE_REPORT_MODULE,
) -> List[Finding]:
    """RP14, reverse leg (the RP02 shape): every DEGRADED_EVENTS member
    must exist in the telemetry registry AND be emitted by some module
    other than trace_report — a consumed-but-never-produced degraded
    event means the doctor watches a signal nothing can raise."""
    findings: List[Finding] = []
    for attr in sorted(degraded):
        if attr not in registry.events and attr not in registry.family_attrs:
            findings.append(Finding(
                "RP14", consumer_relpath, degraded_line,
                f"DEGRADED_EVENTS names EVENTS.{attr}, which is not a "
                "telemetry registry member — the doctor consumes an "
                "event that cannot exist",
            ))
            continue
        pat = re.compile(rf"EVENTS\.{re.escape(attr)}\b")
        if not any(
            pat.search(src) for rel, src in sources
            if rel != consumer_relpath
        ):
            findings.append(Finding(
                "RP14", consumer_relpath, degraded_line,
                f"DEGRADED_EVENTS names EVENTS.{attr}, but no module "
                "outside trace_report emits it — the doctor watches a "
                "degraded signal nothing raises",
            ))
    return findings


# -- rules -------------------------------------------------------------------


def _rule_rp01(tree: ast.Module, relpath: str,
               parents: Dict[ast.AST, ast.AST],
               emit_imported: bool) -> List[Finding]:
    out: List[Finding] = []
    in_telemetry = relpath == TELEMETRY_MODULE

    if not in_telemetry:
        for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
            if not _is_emit_call(call, in_telemetry=False,
                                 emit_imported=emit_imported):
                continue
            a0 = call.args[0] if call.args else None
            if (isinstance(a0, ast.Constant) and isinstance(a0.value, str)
                    and a0.value.startswith("span_")):
                out.append(Finding(
                    "RP01", relpath, call.lineno,
                    f"emit of span event {a0.value!r} outside "
                    "utils/telemetry.py — use span()/start_span()/"
                    "end_span(), never hand-rolled span events",
                ))

    for scope in _scopes(tree):
        own = list(_own_nodes(scope))
        starts = [
            n for n in own
            if isinstance(n, ast.Call) and _callee(n) == "start_span"
        ]
        if not starts:
            continue
        protected = _has_protected_end(own)
        for call in starts:
            if _start_span_ok(call, own, parents, protected):
                continue
            out.append(Finding(
                "RP01", relpath, call.lineno,
                "start_span handle neither escapes this function nor is "
                "closed by an end_span inside a finally/except — the span "
                "leaks on the error path; use the span() context manager "
                "or end it in a finally",
            ))
    return out


def _has_protected_end(own: Sequence[ast.AST]) -> bool:
    """An ``end_span`` call inside a ``finally`` or ``except`` of this
    scope (exception-safe close)."""
    for n in own:
        if not isinstance(n, ast.Try):
            continue
        regions = list(n.finalbody)
        for h in n.handlers:
            regions.extend(h.body)
        for stmt in regions:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) and _callee(sub) == "end_span":
                    return True
    return False


def _start_span_ok(call: ast.Call, own: Sequence[ast.AST],
                   parents: Dict[ast.AST, ast.AST],
                   protected: bool) -> bool:
    p = parents.get(call)
    # handle used directly: returned/yielded, element of a container, or
    # argument of another call — it escapes, the receiver owns ending it
    if isinstance(p, (ast.Return, ast.Yield, ast.Tuple, ast.List,
                      ast.keyword)):
        return True
    if isinstance(p, ast.Call) and p is not call:
        return True
    if isinstance(p, ast.Assign) and len(p.targets) == 1:
        tgt = p.targets[0]
        if isinstance(tgt, (ast.Attribute, ast.Subscript)):
            return True  # stored on an object: lifecycle escapes
        if isinstance(tgt, ast.Name):
            return protected or _name_escapes(own, tgt.id)
    # bare expression statement: the handle is discarded — nothing can
    # ever end this span, protected ends elsewhere notwithstanding
    return False


def _name_escapes(own: Sequence[ast.AST], name: str) -> bool:
    """The bound handle leaves the scope: returned/yielded, placed in a
    container, stored through an attribute/subscript, or passed to a
    call that may own it (activate_span/end_span/trace_fields read the
    span without taking ownership and don't count)."""
    non_owning = {"end_span", "activate_span", "trace_fields"}

    def contains(sub: ast.AST) -> bool:
        return any(
            isinstance(x, ast.Name) and x.id == name
            for x in ast.walk(sub)
        )

    for n in own:
        if isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)):
            if n.value is not None and contains(n.value):
                return True
        elif isinstance(n, (ast.Tuple, ast.List, ast.Set)):
            if any(isinstance(e, ast.Name) and e.id == name
                   for e in n.elts):
                return True
        elif isinstance(n, ast.Call) and _callee(n) not in non_owning:
            if any(contains(a) for a in n.args) or any(
                contains(k.value) for k in n.keywords
            ):
                return True
        elif isinstance(n, ast.Assign):
            if contains(n.value) and any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in n.targets
            ):
                return True
    return False


def _rule_rp02(tree: ast.Module, relpath: str,
               registry: Optional[EventRegistry],
               emit_imported: bool) -> List[Finding]:
    if registry is None:
        return []
    out: List[Finding] = []
    in_telemetry = relpath == TELEMETRY_MODULE

    def unresolvable(call: ast.Call, kind: str) -> Finding:
        return Finding(
            "RP02", relpath, call.lineno,
            f"unresolvable-emit: event name built dynamically ({kind}) "
            "— not statically checkable against telemetry.EVENTS; "
            "prefer an EVENTS constant or a FAMILY-anchored name",
            severity="info",
        )

    for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
        if not _is_emit_call(call, in_telemetry=in_telemetry,
                             emit_imported=emit_imported):
            continue
        a0 = call.args[0] if call.args else None
        if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
            if not registry.knows(a0.value):
                out.append(Finding(
                    "RP02", relpath, call.lineno,
                    f"emit of event {a0.value!r} not registered in "
                    "telemetry.EVENTS — add it to the registry (and "
                    "consume or document it)",
                ))
        elif isinstance(a0, ast.Attribute):
            base = _dotted(a0.value)
            if base == "EVENTS" or base.endswith(".EVENTS"):
                if a0.attr not in registry.events and (
                    a0.attr not in registry.family_attrs
                ):
                    out.append(Finding(
                        "RP02", relpath, call.lineno,
                        f"emit references unknown registry constant "
                        f"EVENTS.{a0.attr}",
                    ))
            else:
                # some other object's attribute: a dynamic name
                out.append(unresolvable(call, "attribute of a variable"))
        elif isinstance(a0, ast.JoinedStr):
            prefix = ""
            for part in a0.values:
                if isinstance(part, ast.Constant) and isinstance(
                    part.value, str
                ):
                    prefix += part.value
                else:
                    break
            if not any(prefix.startswith(f) for f in registry.families):
                out.append(Finding(
                    "RP02", relpath, call.lineno,
                    f"f-string event name (static prefix {prefix!r}) does "
                    "not extend any registered EVENTS.FAMILIES prefix",
                ))
        elif isinstance(a0, ast.BinOp) and isinstance(a0.op, ast.Add):
            left = a0.left
            l_base = _dotted(left.value) if isinstance(
                left, ast.Attribute) else ""
            if isinstance(left, ast.Attribute) and (
                l_base == "EVENTS" or l_base.endswith(".EVENTS")
            ) and left.attr in registry.family_attrs:
                pass  # EVENTS.<X>_FAMILY + suffix: a family extension
            elif isinstance(left, ast.Constant) and isinstance(
                left.value, str
            ):
                if not any(left.value.startswith(f)
                           for f in registry.families):
                    out.append(Finding(
                        "RP02", relpath, call.lineno,
                        f"concatenated event name (static prefix "
                        f"{left.value!r}) does not extend any registered "
                        "EVENTS.FAMILIES prefix",
                    ))
            else:
                out.append(unresolvable(call, "string concatenation"))
        elif a0 is not None:
            kind = type(a0).__name__
            out.append(unresolvable(
                call, {"Name": "a variable", "Call": "a call result"}.get(
                    kind, kind)
            ))
    return out


def _rule_rp03(tree: ast.Module, relpath: str) -> List[Finding]:
    out: List[Finding] = []
    seen: set = set()
    loops = [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.For, ast.While, ast.AsyncFor))
    ]
    for loop in loops:
        for n in ast.walk(loop):
            if not isinstance(n, ast.Call) or id(n) in seen:
                continue
            what = flowrules.host_sync_what(n)
            if what is not None:
                seen.add(id(n))
                # the reference's advice for its own syncs, the port's
                # overlap idiom for torch's
                how = ("a pinned non_blocking copy with an event, waited "
                       "one batch behind" if what in flowrules.TORCH_SYNCS else
                       "copy_to_host_async + materialize one behind")
                out.append(Finding(
                    "RP03", relpath, n.lineno,
                    f"{what} inside a loop body of a hot module blocks "
                    f"on a host sync every iteration — overlap the fetch "
                    f"({how}) or hoist it out of the loop",
                ))
    return out


def _rule_rp04(tree: ast.Module, relpath: str,
               rp08_covered: Optional[Set[int]] = None) -> List[Finding]:
    out: List[Finding] = []
    rp08_covered = rp08_covered or set()
    thread_imported = _imports_name(tree, "threading", "Thread")
    queue_imported = any(
        _imports_name(tree, "queue", n) for n in ("Queue", "LifoQueue")
    )
    has_join = False
    threads: List[ast.Call] = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if isinstance(f, ast.Attribute) and f.attr == "join":
            # "sep".join(...) is string plumbing, not thread hygiene
            if not (isinstance(f.value, ast.Constant)
                    and isinstance(f.value.value, str)):
                has_join = True
        is_thread = (
            isinstance(f, ast.Attribute) and f.attr == "Thread"
            and _dotted(f.value).split(".")[-1] == "threading"
        ) or (
            isinstance(f, ast.Name) and f.id == "Thread" and thread_imported
        )
        if is_thread:
            threads.append(n)
            if not any(k.arg == "daemon" for k in n.keywords):
                out.append(Finding(
                    "RP04", relpath, n.lineno,
                    "threading.Thread constructed without an explicit "
                    "daemon= — decide (and document) whether this thread "
                    "may outlive interpreter shutdown",
                ))
        is_simple = (
            isinstance(f, ast.Attribute) and f.attr == "SimpleQueue"
            and _dotted(f.value).split(".")[-1] in ("queue", "_queue")
        ) or (
            isinstance(f, ast.Name) and f.id == "SimpleQueue"
            and _imports_name(tree, "queue", "SimpleQueue")
        )
        if is_simple:
            # SimpleQueue takes no maxsize at all — it is unbounded by
            # construction, invisible to the maxsize heuristic below
            out.append(Finding(
                "RP04", relpath, n.lineno,
                "queue.SimpleQueue() is unbounded by construction (it "
                "accepts no maxsize) — a stalled consumer grows it "
                "without limit; use queue.Queue(maxsize=...) instead",
            ))
        is_queue = (
            isinstance(f, ast.Attribute) and f.attr in ("Queue", "LifoQueue")
            and _dotted(f.value).split(".")[-1] in ("queue", "_queue")
        ) or (
            isinstance(f, ast.Name) and f.id in ("Queue", "LifoQueue")
            and queue_imported
        )
        if is_queue:
            bound = None
            if n.args:
                bound = n.args[0]
            for k in n.keywords:
                if k.arg == "maxsize":
                    bound = k.value
            # Python treats ANY maxsize <= 0 as unbounded: catch the
            # literal 0 and the negated-literal (-1) spellings alike
            val = None
            if isinstance(bound, ast.Constant) and isinstance(
                bound.value, (int, float)
            ):
                val = bound.value
            elif (isinstance(bound, ast.UnaryOp)
                    and isinstance(bound.op, ast.USub)
                    and isinstance(bound.operand, ast.Constant)
                    and isinstance(bound.operand.value, (int, float))):
                val = -bound.operand.value
            if bound is None or (val is not None and val <= 0):
                out.append(Finding(
                    "RP04", relpath, n.lineno,
                    "unbounded queue.Queue() — a stalled consumer grows "
                    "it without limit; construct with a maxsize bound",
                ))
    if threads and not has_join:
        for n in threads:
            if n.lineno in rp08_covered:
                # RP08's flow-sensitive join check already covers this
                # thread (flagged or passed) — one bug, one report
                continue
            out.append(Finding(
                "RP04", relpath, n.lineno,
                "threading.Thread constructed but no .join( appears in "
                "this module — threads must be joined (bounded) on "
                "shutdown",
            ))
    return out


def _rule_rp05(tree: ast.Module, relpath: str) -> List[Finding]:
    out: List[Finding] = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call) or not isinstance(
            n.func, ast.Attribute
        ):
            continue
        base = _dotted(n.func.value)
        attr = n.func.attr
        if base in ("time", "_time") and attr == "time":
            out.append(Finding(
                "RP05", relpath, n.lineno,
                "time.time() in ops/ — wall clocks don't belong in "
                "kernel bodies; take timestamps at the call site or use "
                "perf_counter in instrumentation",
            ))
        elif base == "random":
            out.append(Finding(
                "RP05", relpath, n.lineno,
                f"global random.{attr}() in ops/ — RNG must be threaded "
                "explicitly (np.random.Generator / jax key)",
            ))
        elif base in ("np.random", "numpy.random") and (
            attr not in RNG_FACTORY_OK
        ):
            out.append(Finding(
                "RP05", relpath, n.lineno,
                f"legacy np.random.{attr}() in ops/ mutates hidden "
                "global state — pass an np.random.Generator instead",
            ))
        elif base in ("torch", "torch.cuda") and attr in TORCH_SEEDERS:
            out.append(Finding(
                "RP05", relpath, n.lineno,
                f"{base}.{attr}() in ops/ reseeds torch's global RNG — "
                "draw from an explicit torch.Generator instead",
            ))
        elif base == "torch" and attr in TORCH_RNG_DRAWS and not any(
            k.arg == "generator" for k in n.keywords
        ):
            out.append(Finding(
                "RP05", relpath, n.lineno,
                f"torch.{attr}() without generator= in ops/ draws from "
                "torch's hidden global RNG — pass a torch.Generator",
            ))
    return out


def _rule_rp06(tree: ast.Module, relpath: str) -> List[Finding]:
    out: List[Finding] = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.ExceptHandler):
            continue
        t = n.type
        broad = t is None or (
            isinstance(t, (ast.Name, ast.Attribute))
            and _dotted(t).split(".")[-1] in ("Exception", "BaseException")
        )
        if not broad:
            continue
        handled = False
        for stmt in n.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Raise):
                    handled = True
                elif isinstance(sub, ast.Call) and (
                    _callee(sub) in RP06_MITIGATORS
                ):
                    handled = True
        if not handled:
            out.append(Finding(
                "RP06", relpath, n.lineno,
                "broad except handler swallows the error silently — "
                "re-raise, emit a telemetry event/counter, or close the "
                "span as errored",
            ))
    return out


# -- engine ------------------------------------------------------------------


def lint_source(src: str, relpath: str, *,
                registry: Optional[EventRegistry] = None,
                index: Optional[PackageIndex] = None,
                tree: Optional[ast.Module] = None,
                degraded: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one module's source.  ``relpath`` is the package-relative
    path ('/'-separated) the rule scoping keys on; tests lint fixture
    text under virtual relpaths to exercise module-scoped rules.
    ``index`` (built by ``lint_package``) enables RP09's cross-module
    call resolution; without it RP09 resolves same-file calls only.
    ``tree`` is an optional pre-parsed AST of ``src`` (``lint_package``
    passes the one it already built for the index, so targets parse
    once per run).  ``degraded`` is trace_report's parsed
    DEGRADED_EVENTS attr set for RP14's emit matching; without it any
    ``EVENTS.*`` emit satisfies a rung (the fixture path)."""
    relpath = relpath.replace(os.sep, "/")
    if tree is None:
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            return [Finding(
                "RP00", relpath, e.lineno or 1, f"syntax error: {e.msg}"
            )]
    allows, findings, pragmas = _scan_pragmas(src, relpath)
    parents = _parents(tree)
    emit_imported = _imports_name(tree, "telemetry", "emit")
    # rules actually evaluated for this file — a pragma naming only
    # rules that never ran here cannot be judged stale
    evaluated: Set[str] = {"RP01", "RP04", "RP08", "RP12"}
    findings += _rule_rp01(tree, relpath, parents, emit_imported)
    findings += [
        Finding("RP12", relpath, ln, msg)
        for ln, msg in flowrules.rule_rp12(tree)
    ]
    if registry is not None:
        evaluated.add("RP02")
    findings += _rule_rp02(tree, relpath, registry, emit_imported)
    if relpath in HOT_MODULES:
        evaluated.add("RP03")
        findings += _rule_rp03(tree, relpath)
    # RP08 runs before RP04 so its flow-checked threads can stand the
    # per-line no-join heuristic down (one bug, one report)
    rp08_out, rp08_covered = flowrules.rule_rp08(tree)
    findings += [
        Finding("RP08", relpath, ln, msg) for ln, msg in rp08_out
    ]
    findings += _rule_rp04(tree, relpath, rp08_covered)
    if relpath.startswith(DETERMINISM_PREFIXES):
        evaluated.add("RP05")
        findings += _rule_rp05(tree, relpath)
    if relpath in PIPELINE_MODULES:
        evaluated.add("RP06")
        findings += _rule_rp06(tree, relpath)
    if relpath in ASYNC_COPY_MODULES:
        evaluated.add("RP07")
        findings += [
            Finding("RP07", relpath, ln, msg)
            for ln, msg in flowrules.rule_rp07(tree)
        ]
    if relpath in HOT_MODULES:
        evaluated.add("RP09")
        sup = {
            ln: set().union(*(p.rules for p in ps))
            for ln, ps in allows.items()
        }
        findings += [
            Finding("RP09", relpath, ln, msg)
            for ln, msg in flowrules.rule_rp09(
                tree, relpath, index=index, suppressed=sup
            )
        ]
    if relpath in CONCURRENCY_MODULES:
        evaluated.update(("RP10", "RP11"))
        findings += [
            Finding("RP10", relpath, ln, msg)
            for ln, msg in flowrules.rule_rp10(tree, relpath, index=index)
        ]
        findings += [
            Finding("RP11", relpath, ln, msg)
            for ln, msg in flowrules.rule_rp11(tree, relpath, index=index)
        ]
    if relpath in RP13_MODULES:
        evaluated.add("RP13")
        findings += [
            Finding("RP13", relpath, ln, msg)
            for ln, msg in flowrules.rule_rp13(tree)
        ]
    if relpath in RP14_MODULES:
        evaluated.add("RP14")
        findings += [
            Finding("RP14", relpath, ln, msg)
            for ln, msg in flowrules.rule_rp14(tree, degraded=degraded)
        ]
    for f in findings:
        if f.rule == "RP00" or f.severity != "error":
            continue  # pragma hygiene / info findings aren't suppressible
        for ln in (f.line, f.line - 1):
            for p in allows.get(ln, []):
                if f.rule in p.rules:
                    f.suppressed = True
                    f.reason = p.reason
                    p.matched = True
                    break
            if f.suppressed:
                break
    for p in pragmas:
        if p.matched or not p.rules <= evaluated:
            continue
        findings.append(Finding(
            "RP00", relpath, p.line,
            f"stale pragma: allow[{','.join(sorted(p.rules))}] "
            "suppresses no finding at this site — the violation it "
            "covered is gone; remove the pragma",
        ))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def package_root() -> str:
    """The installed ``randomprojection_tpu_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_package_files(root: str) -> List[str]:
    rels: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__"
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                rels.append(rel.replace(os.sep, "/"))
    return rels


def _read(path: str) -> str:
    """Tolerant read for OPTIONAL analysis inputs (the doc, the
    consumer text): missing files stand a rule down, never crash."""
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ""


def _read_strict(path: str) -> str:
    """Strict read for the lint TARGETS themselves: an unreadable file
    must abort the run (internal error, exit 2), not silently shrink it
    — a partial run must never report 'clean'."""
    with open(path, encoding="utf-8") as f:
        return f.read()


def _build_index(
    sources: Sequence[Tuple[str, str]],
) -> Tuple[PackageIndex, Dict[str, ast.Module]]:
    """RP09's one-level call-resolution index over the lint targets
    (``(relpath, source)`` pairs): parsed trees plus each file's
    pragma-suppressed lines (a sync the owning file justified does not
    propagate to its callers).  Also returns the parsed trees so
    ``lint_package`` parses each target exactly once."""
    idx = PackageIndex()
    trees: Dict[str, ast.Module] = {}
    for rel, src in sources:
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue  # the per-file lint reports the syntax error
        trees[rel] = tree
        allows, _f, _p = _scan_pragmas(src, rel)
        sup = {
            ln: set().union(*(p.rules for p in ps))
            for ln, ps in allows.items()
        }
        idx.add(index_module(rel, tree, sup))
    return idx, trees


def _suppress_drift(drift: List[Finding],
                    sources: Dict[str, str]) -> List[Finding]:
    """Pragma suppression for the package-wide legs (registry drift,
    RP14's reverse leg), whose findings ``lint_source`` never sees: a
    pragma in the anchoring file, on the finding's line or the one
    above, suppresses them as it would a per-file finding.  Such a
    pragma in trace_report.py naming RP14, a rule ``lint_source`` does
    not evaluate there, is stale (RP00) when it suppresses nothing."""
    out = list(drift)
    for rel in sorted({f.path for f in drift} | {TRACE_REPORT_MODULE}):
        src = sources.get(rel)
        if src is None:
            continue
        allows, _bad, pragmas = _scan_pragmas(src, rel)
        for f in drift:
            if f.path != rel:
                continue
            for p in allows.get(f.line, []) + allows.get(f.line - 1, []):
                if f.rule in p.rules:
                    f.suppressed, f.reason, p.matched = True, p.reason, True
                    break
        if rel != TRACE_REPORT_MODULE:
            continue
        for p in pragmas:
            if "RP14" in p.rules and not p.matched:
                out.append(Finding(
                    "RP00", rel, p.line,
                    f"stale pragma: allow[{','.join(sorted(p.rules))}] "
                    "suppresses no finding at this site — the violation it "
                    "covered is gone; remove the pragma",
                ))
    return out


_POOL_STATE: dict = {}


def _pool_init(sources: Sequence[Tuple[str, str]],
               registry: Optional[EventRegistry],
               degraded: Optional[Set[str]]) -> None:
    """ProcessPool initializer: each worker builds the cross-module
    index once, then lints the rels it is handed."""
    index, trees = _build_index(sources)
    _POOL_STATE.update(
        sources=dict(sources), registry=registry, degraded=degraded,
        index=index, trees=trees,
    )


def _pool_lint(rel: str) -> List[Finding]:
    s = _POOL_STATE
    return lint_source(
        s["sources"][rel], rel, registry=s["registry"], index=s["index"],
        tree=s["trees"].get(rel), degraded=s["degraded"],
    )


def default_jobs() -> int:
    """Default lint parallelism: ``min(8, cpu)`` — the package is ~45
    files, so more workers than that just pay fork+reindex cost."""
    return min(8, os.cpu_count() or 1)


def lint_package(root: Optional[str] = None,
                 files: Optional[Sequence[str]] = None,
                 jobs: Optional[int] = None) -> dict:
    """Lint the package tree (or an explicit file list) and return the
    stable findings record the CLI serializes with ``--json``:
    ``{rplint, root, files, findings[], counts, suppressed,
    unresolvable_emits, wall_s, ok}`` — rule id / path / line /
    message / severity / pragma state per finding.  ``jobs`` > 1 fans
    the per-file passes out over a process pool (finding order stays
    deterministic: results are folded in file order, and each file's
    findings are sorted).  Raises on unreadable lint targets (the CLI
    maps that to exit code 2)."""
    t0 = time.monotonic()
    root = os.path.abspath(root or package_root())
    registry = load_event_registry(
        _read(os.path.join(root, TELEMETRY_MODULE.replace("/", os.sep)))
    )
    consumer = _read(
        os.path.join(root, TRACE_REPORT_MODULE.replace("/", os.sep))
    )
    degraded_attrs, degraded_line = load_degraded_events(consumer)
    degraded = degraded_attrs or None
    if files is None:
        rels = iter_package_files(root)
        paths = [(os.path.join(root, r.replace("/", os.sep)), r)
                 for r in rels]
        run_drift = True
    else:
        paths = []
        for p in files:
            ap = os.path.abspath(p)
            rel = os.path.relpath(ap, root)
            if rel.startswith(".."):
                rel = os.path.basename(ap)
            paths.append((ap, rel.replace(os.sep, "/")))
        run_drift = False
    sources = [(rel, _read_strict(abspath)) for abspath, rel in paths]
    findings: List[Finding] = []
    njobs = default_jobs() if jobs is None else max(1, jobs)
    if njobs > 1 and len(sources) > 1:
        # spawned workers: a fork of a process that runs threads (a
        # test runner, a serving process) may copy a held lock
        with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(njobs, len(sources)),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_pool_init,
            initargs=(sources, registry, degraded),
        ) as pool:
            # map() yields in submission order: per-file findings fold
            # back deterministically no matter which worker ran them
            for batch in pool.map(_pool_lint, [rel for rel, _ in sources]):
                findings += batch
    else:
        index, trees = _build_index(sources)
        for rel, src in sources:
            findings += lint_source(src, rel, registry=registry,
                                    index=index, tree=trees.get(rel),
                                    degraded=degraded)
    doc_path = os.path.join(os.path.dirname(root), ARCHITECTURE_DOC)
    drift: List[Finding] = []
    if run_drift and registry is not None and os.path.exists(doc_path):
        # the drift check is a repo-time gate: an installed package
        # ships without docs/ (pyproject packages only the code), and
        # flagging every documented-only event there would fail a
        # correct tree.  The repo checkout always has the doc (and the
        # tier-1 suite asserts the check runs there).
        drift += check_registry_drift(registry, consumer, _read(doc_path))
    if run_drift and registry is not None:
        # RP14 reverse leg needs the whole package in view (like the
        # registry drift check): a degraded event nobody emits
        drift += check_degraded_drift(
            degraded_attrs, degraded_line, registry, sources
        )
        findings += _suppress_drift(drift, dict(sources))
    active = [f for f in findings
              if not f.suppressed and f.severity == "error"]
    counts: Dict[str, int] = {}
    for f in active:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "rplint": 4,
        "root": root,
        "files": len(paths),
        "findings": [f.to_dict() for f in findings],
        "counts": dict(sorted(counts.items())),
        "suppressed": len([f for f in findings if f.suppressed]),
        "unresolvable_emits": len(
            [f for f in findings if f.severity == "info"]
        ),
        "wall_s": round(time.monotonic() - t0, 3),
        "ok": not active,
    }


_SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"


def to_sarif(report: dict) -> dict:
    """Render a ``lint_package`` record as a SARIF 2.1.0 log, so CI
    runners and editors can annotate findings inline.  Mapping:
    ``severity`` ``error`` → level ``error``, ``info`` → ``note``;
    pragma-suppressed findings carry an ``inSource`` suppression with
    the pragma's reason as justification (SARIF viewers hide them by
    default but keep the audit trail)."""
    results = []
    for f in report["findings"]:
        res = {
            "ruleId": f["rule"],
            "level": "note" if f["severity"] == "info" else "error",
            "message": {"text": f["message"]},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f["path"]},
                    "region": {"startLine": max(1, int(f["line"]))},
                },
            }],
        }
        if f["suppressed"]:
            res["suppressions"] = [{
                "kind": "inSource",
                "justification": f["reason"],
            }]
        results.append(res)
    return {
        "version": "2.1.0",
        "$schema": _SARIF_SCHEMA,
        "runs": [{
            "tool": {"driver": {
                "name": "rplint",
                "version": str(report["rplint"]),
                "rules": [
                    {"id": rid, "shortDescription": {"text": RULES[rid]}}
                    for rid in sorted(RULES)
                ],
            }},
            "results": results,
        }],
    }


def diff_baseline(report: dict, baseline: dict) -> dict:
    """Diff a fresh lint record against a prior ``--json`` record.
    Findings match on ``(rule, path, message)`` — NOT line — so code
    motion above a baselined finding never re-flags it.  Returns
    ``{matched, new[], stale, ok}``: ``new`` are the findings to fail
    on, ``stale`` counts baseline entries the tree no longer produces
    (time to re-tighten the baseline)."""

    def active(fs) -> List[dict]:
        return [
            f for f in fs
            if not f.get("suppressed")
            and f.get("severity", "error") == "error"
        ]

    budget: Dict[Tuple[str, str, str], int] = {}
    for f in active(baseline.get("findings", [])):
        k = (f["rule"], f["path"], f["message"])
        budget[k] = budget.get(k, 0) + 1
    matched = 0
    new: List[dict] = []
    for f in active(report["findings"]):
        k = (f["rule"], f["path"], f["message"])
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            matched += 1
        else:
            new.append(f)
    stale = sum(v for v in budget.values() if v > 0)
    return {"matched": matched, "new": new, "stale": stale,
            "ok": not new}


def _fsync_dir(path: str) -> None:
    """Best-effort parent-directory fsync after an ``os.replace`` (the
    rename itself can be lost on crash without it); tolerant because
    some filesystems refuse O_RDONLY directory opens."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_json_atomic(path: str, obj: dict) -> None:
    """The commit idiom RP13 enforces, practiced by the linter's own
    artifact writers: tmp sibling → flush → fsync → ``os.replace`` →
    directory fsync."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI face (``python -m randomprojection_tpu_torch lint`` delegates
    here).  Exit codes: **0** no
    unsuppressed finding (none outside the baseline, when one is
    given), **1** findings, **2** internal error (analysis crash,
    unreadable target, malformed baseline) — a partial run never
    reports success."""
    ap = argparse.ArgumentParser(
        prog="rplint",
        description="AST-based invariant checks for this repo's "
                    "pipeline contracts (rules RP01-RP14; see "
                    "randomprojection_tpu_torch/analysis/rplint.py)",
    )
    ap.add_argument("paths", nargs="*",
                    help="files to lint (default: the whole installed "
                         "package, plus the registry drift check)")
    ap.add_argument("--json", action="store_true",
                    help="emit the stable findings record as one JSON "
                         "object (includes suppressed and informational "
                         "findings, marked)")
    ap.add_argument("--root", default=None,
                    help="package root to resolve rule scoping against "
                         "(default: the installed package)")
    ap.add_argument("--baseline", default=None, metavar="JSON",
                    help="a prior `lint --json` record: fail only on "
                         "findings NOT in it (matched on rule+path+"
                         "message, so line drift never re-flags) — lets "
                         "strict rules land without blocking unrelated "
                         "work")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the --baseline file in place with the "
                         "fresh lint record: stale entries are pruned, "
                         "current findings become the accepted baseline "
                         "(exit 0) — the workflow for accepting intended "
                         "new findings instead of hand-editing JSON")
    ap.add_argument("--sarif", default=None, metavar="PATH",
                    help="also write the findings as a SARIF 2.1.0 log "
                         "to PATH, so CI and editors can annotate them "
                         "inline")
    ap.add_argument("--jobs", type=int, default=None, metavar="N",
                    help="fan the per-file rule passes out over N "
                         "processes (default: min(8, cpu)); finding "
                         "order stays deterministic, 1 disables the "
                         "pool")
    args = ap.parse_args(argv)
    updated: Optional[dict] = None
    try:
        if args.update_baseline and args.baseline is None:
            raise ValueError("--update-baseline requires --baseline PATH")
        report = lint_package(args.root, files=args.paths or None,
                              jobs=args.jobs)
        if args.baseline is not None:
            if args.update_baseline and not os.path.exists(args.baseline):
                base: dict = {"findings": []}  # first write starts empty
            else:
                with open(args.baseline, encoding="utf-8") as f:
                    base = json.load(f)
            if not isinstance(base, dict) or not isinstance(
                base.get("findings"), list
            ):
                raise ValueError(
                    f"{args.baseline} is not a lint --json record "
                    "(no findings list)"
                )
            report["baseline"] = diff_baseline(report, base)
            if args.update_baseline:
                fresh = {k: v for k, v in report.items() if k != "baseline"}
                _write_json_atomic(args.baseline, fresh)
                updated = {
                    "path": args.baseline,
                    "accepted_new": len(report["baseline"]["new"]),
                    "pruned_stale": report["baseline"]["stale"],
                }
                report["baseline_updated"] = updated
        if args.sarif is not None:
            _write_json_atomic(args.sarif, to_sarif(report))
    except Exception as e:
        # never exit 0 off a crashed/partial run
        print(f"rplint: internal error: {e}", file=sys.stderr)
        return 2
    ok = report["baseline"]["ok"] if "baseline" in report else report["ok"]
    if updated is not None:
        ok = True  # the update IS the acceptance of the new findings
    if args.json:
        print(json.dumps(report))
        return 0 if ok else 1
    if "baseline" in report:
        shown = [Finding(**f) for f in report["baseline"]["new"]]
    else:
        shown = [
            Finding(**f) for f in report["findings"]
            if not f["suppressed"] and f["severity"] == "error"
        ]
    for f in shown:
        print(f.render())
    status = "clean" if ok else "%d finding(s)" % len(shown)
    extras = [
        f"{report['files']} file(s)",
        f"{report['suppressed']} suppressed finding(s)",
    ]
    if report["unresolvable_emits"]:
        extras.append(
            f"{report['unresolvable_emits']} unresolvable emit name(s)"
        )
    if "baseline" in report:
        b = report["baseline"]
        extras.append(
            f"baseline: {b['matched']} matched, {b['stale']} stale"
        )
    if updated is not None:
        status = "baseline updated"
        extras.append(
            f"{updated['path']} rewritten ({updated['accepted_new']} new "
            f"finding(s) accepted, {updated['pruned_stale']} stale "
            "entr(ies) pruned)"
        )
    print(f"rplint: {status} — " + ", ".join(extras))
    return 0 if ok else 1


if __name__ == "__main__":  # pragma: no cover — python -m convenience
    raise SystemExit(main())
