"""Flow-sensitive rplint rules RP07-RP14.

Built on the ``cfg`` substrate.  Each rule function returns plain
``(line, message)`` pairs; ``rplint.py`` wraps them into findings,
applies pragma suppression, and owns scoping (which modules each rule
runs on).  The rules are the reference linter's, with RP07 rewritten for
the port's asynchronous copies and the host-sync detector taught
torch's syncs.

- **RP07 asynchronous-copy discipline** — the port's copies between host
  and card are ``non_blocking`` copies ordered by CUDA events
  (``ops/staging.py``'s ``StagedBatch``, the tier's uploads, the
  stream's pinned d2h).  Three legs, each a CFG query over one
  function: (a) a ``non_blocking=True`` copy (``.to(...)`` or
  ``.copy_(...)``) reaches an event's ``.record(...)`` on every path
  out of its function, unless its tensor leaves inside a
  ``StagedBatch``; (b) a ``StagedBatch`` bound from ``stage_upload`` /
  ``StagedBatch(...)`` is ``.wait()``-ed before its ``.tensor`` is
  read (the wait dominates the read); (c) the pinned host destination
  of a device-to-host ``non_blocking`` copy is read only where a
  ``.synchronize()`` dominates the read.  The reference's Pallas legs
  (slot algebra, VMEM budget) have no counterpart: the kernels' shared
  memory is allocated inside ``csrc/*.cu``, which no Python AST sees,
  and ``plan_project``/``plan_fused``/``plan_probe`` size it from the
  shape.
- **RP08 thread/queue protocol** — every thread started in a function
  is joined on every path out of it (early returns, explicit raises and
  try/finally modeled); threads stored on ``self`` are joined by the
  class, reachable from its close-like method; a shutdown sentinel is
  enqueued unconditionally from ``close()`` (only closed-flag guards
  may skip it); and no cursor commit dominates its batch's ``yield``
  (the ack-after-yield contract).
- **RP09 interprocedural host-sync** — a host sync hidden one call away
  from a hot loop: loop-body calls resolve one level through the
  package index, and a callee containing an unsuppressed host sync
  (``host_sync_what``: torch's ``.item()`` / ``.tolist()`` / ``.cpu()``
  / ``.numpy()`` / ``.synchronize()``, ``np.asarray``,
  ``float()``-on-expression, and the reference's JAX names) is
  reported at the call site.
- **RP10 shared-state races** — thread *roles* are derived
  from RP08's thread discovery (each ``Thread(target=...)`` entry point
  plus the constructing "main" role); per-role ``self.``-attribute
  read/write sets are computed transitively one call level at a time
  through the package index (lock context folding through each call
  site), and any attribute with a cross-role write/write or read/write
  pair is flagged unless every access path holds the *same* lock
  (``with self._lock:`` regions on the CFG), the value crosses roles
  only through the attribute's own method calls (the ``queue.Queue``
  put/get handoff — the object's methods own their synchronization), or
  every write dominates every thread ``.start()`` call (init-only
  state, via the dominator query).  Classes (and module globals) with
  no thread roles still get the lock-*consistency* leg: state touched
  under a lock somewhere must hold that lock on every post-init access.
- **RP11 lock-order deadlock lint** — the lock-acquisition
  ordering graph (nested ``with``-lock regions, including one call
  level through the package index) must be acyclic, and no blocking
  call (``queue.put`` / ``.join`` / ``future.result``) may run while a
  lock is held.
- **RP12 resource lifecycle** — RP01's span-balance engine
  generalized into a paired-acquire/release protocol checker: a
  telemetry subscription, ``MetricsServer``, ``HealthEngine``,
  ``open()`` handle, ``np.memmap``, or ``mkdtemp`` temp dir bound to a
  local name must be released on every path out of the acquiring
  function (``exit_reachable_without`` on the CFG, guard facts
  synthesized for ``if x is not None:``-style release guards), and no
  second acquire may run outside an exception-protected region while
  an earlier handle is still unreleased.  Escaping handles (returned,
  yielded, stored on an object, packed into a container, passed to an
  owning callee, or captured by a nested function) are exempt, like
  RP01/RP08.
- **RP13 durable-commit discipline** — every ``os.replace``
  landing a snapshot/artifact must be preceded by flush+fsync on all
  paths, a raw ``open(final_path, "w")`` write (no tmp→replace) is a
  finding, the manifest replace must be dominated by every chunk/spill
  write in the same commit (manifest-committed-LAST, via the dominator
  query, with conditional writes promoted to their enclosing
  ``if``/loop headers), and a directory fsync must be reachable after
  the replace (helper functions whose callers fsync the directory are
  exempt).
- **RP14 degraded-path audit** — every fallback rung (a
  broad ``except`` whose body is more than a bare re-raise) must
  reachably emit a ``DEGRADED_EVENTS``-consumed telemetry event or
  call a degraded-rung recorder; classified-failure rungs (those that
  re-raise unrecognized errors) must memoize the degraded key (the
  ``_NO_*_KEYS`` convention — the ``.add()`` may sit after the ladder
  loop, so reachability is CFG-checked, not lexical); and a
  ``counter_inc("*fallback*")`` without an adjacent degraded-event
  emit in the same block is flagged.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from randomprojection_tpu_torch.analysis.cfg import (
    CFG,
    ModuleInfo,
    _traverse as _reachable,
    PackageIndex,
    build_cfg,
    dominators,
    dotted as _dotted,
    exit_reachable_without,
    index_module,
    lock_regions,
    node_reachable_without,
    parents_map as _parents_map,
    shallow_walk,
    thread_entries,
)

__all__ = [
    "host_sync_what",
    "rule_rp07",
    "rule_rp08",
    "rule_rp09",
    "rule_rp10",
    "rule_rp11",
    "rule_rp12",
    "rule_rp13",
    "rule_rp14",
]

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


# -- the host-sync detector (shared by RP03 and RP09) ------------------------

_HOST_SYNCS = {"asarray": ("np", "numpy"), "device_get": ("jax",)}
# torch's host syncs: a method that hands a card tensor's values to the
# host (or waits for the card) blocks until every kernel queued before it
# has run.  ``.synchronize()`` covers ``torch.cuda.synchronize()`` and an
# event's or a stream's own.
_TORCH_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")
# what ``host_sync_what`` calls torch's syncs (RP03 words its advice by it)
TORCH_SYNCS = frozenset(
    {f".{m}()" for m in _TORCH_SYNC_METHODS} | {"torch.cuda.synchronize()"}
)


def host_sync_what(call: ast.Call) -> Optional[str]:
    """Human-readable description of the host sync this call performs,
    or None.  The single definition both the syntactic rule (RP03) and
    the interprocedural rule (RP09) share, so the two can never drift
    on what counts as a sync."""
    f = call.func
    if isinstance(f, ast.Attribute):
        bases = _HOST_SYNCS.get(f.attr)
        if bases and isinstance(f.value, ast.Name) and f.value.id in bases:
            return f"{f.value.id}.{f.attr}"
        if f.attr == "block_until_ready":
            return ".block_until_ready()"
        if f.attr in _TORCH_SYNC_METHODS and not call.args \
                and not call.keywords:
            if f.attr == "synchronize" and _dotted(f.value) == "torch.cuda":
                return "torch.cuda.synchronize()"
            return f".{f.attr}()"
    elif isinstance(f, ast.Name) and f.id == "float" and call.args:
        # float(scalar_name) is fine; float(<expression>) on an array
        # element/reduction forces a device sync
        if not isinstance(call.args[0], (ast.Name, ast.Constant)):
            return "float() on an expression"
    return None


# -- RP07: asynchronous-copy discipline --------------------------------------


def _kw_true(call: ast.Call, name: str) -> bool:
    return any(k.arg == name and isinstance(k.value, ast.Constant)
               and k.value.value is True for k in call.keywords)


def _async_copy(call: ast.Call) -> bool:
    """``x.to(..., non_blocking=True)`` or ``dst.copy_(src,
    non_blocking=True)``."""
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr in ("to", "copy_")
            and _kw_true(call, "non_blocking"))


def _pinned_alloc(value: ast.AST) -> bool:
    """A host allocation in pinned memory: ``torch.empty(...,
    pin_memory=True)`` (any factory) or ``<tensor>.pin_memory()``."""
    return isinstance(value, ast.Call) and (
        _kw_true(value, "pin_memory")
        or (isinstance(value.func, ast.Attribute)
            and value.func.attr == "pin_memory")
    )


def _to_host(call: ast.Call) -> bool:
    """``x.to("cpu", non_blocking=True)`` (or ``device="cpu"``)."""
    args = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def _carrier_call(call: ast.AST) -> bool:
    """A call building the port's staged carrier (``StagedBatch(...)``
    or ``stage_upload(...)``, which returns one)."""
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else "")
    return name in ("StagedBatch", "stage_upload")


def _names_in(node: ast.AST) -> Set[str]:
    return {x.id for x in ast.walk(node) if isinstance(x, ast.Name)}


def _rp07_function(func: ast.AST, out: List[Tuple[int, str]]) -> None:
    cfg = build_cfg(func)
    copies: List[Tuple[int, ast.Call, Optional[str]]] = []
    records: Set[int] = set()
    syncs: Set[int] = set()
    carriers: Set[str] = set()     # names bound to a StagedBatch
    pinned: Set[str] = set()       # names bound to a pinned host tensor
    staged_args: Set[str] = set()  # names handed to StagedBatch(...)
    for node in cfg.nodes:
        for sub in shallow_walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                tgt = sub.targets[0].id
                if _carrier_call(sub.value):
                    carriers.add(tgt)
                if _pinned_alloc(sub.value):
                    pinned.add(tgt)
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if _carrier_call(sub):
                for a in list(sub.args) + [k.value for k in sub.keywords]:
                    staged_args |= _names_in(a)
            if not isinstance(f, ast.Attribute):
                continue
            if f.attr in ("record", "record_event"):
                records.add(node.idx)
            elif f.attr == "synchronize":
                syncs.add(node.idx)
            if _async_copy(sub):
                # the tensor the copy lands in: the receiver of copy_,
                # the bound target of an assigned .to(...)
                dst = None
                if f.attr == "copy_" and isinstance(f.value, ast.Name):
                    dst = f.value.id
                elif isinstance(node.stmt, ast.Assign) and \
                        node.stmt.value is sub and len(
                            node.stmt.targets) == 1 and isinstance(
                            node.stmt.targets[0], ast.Name):
                    dst = node.stmt.targets[0].id
                copies.append((node.idx, sub, dst))
    dom = None
    # (a) every non_blocking copy reaches an event record on all paths
    for node_idx, call, dst in copies:
        if dst in staged_args or any(
            _carrier_call(x) and call in set(ast.walk(x))
            for x in shallow_walk(cfg.nodes[node_idx])
        ):
            continue  # the tensor leaves inside a StagedBatch
        if exit_reachable_without(cfg, node_idx, records):
            out.append((
                call.lineno,
                "non_blocking copy can reach the function exit without "
                "an event recorded behind it — nothing can wait for "
                "this copy alone; record a CUDA event after it (or hand "
                "the tensor on inside a StagedBatch)",
            ))
    # (b) StagedBatch.tensor is read only after .wait()
    waits = {
        node.idx for node in cfg.nodes for sub in shallow_walk(node)
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
        and sub.func.attr == "wait" and isinstance(sub.func.value, ast.Name)
        and sub.func.value.id in carriers
    }
    for node in cfg.nodes:
        for sub in shallow_walk(node):
            if not (isinstance(sub, ast.Attribute) and sub.attr == "tensor"
                    and isinstance(sub.ctx, ast.Load)):
                continue
            inline = _carrier_call(sub.value)
            if not inline and not (isinstance(sub.value, ast.Name)
                                   and sub.value.id in carriers):
                continue
            if dom is None:
                dom = dominators(cfg)
            if inline or not (waits & dom[node.idx]) or node.idx in waits:
                out.append((
                    sub.lineno,
                    "StagedBatch.tensor read before the batch's .wait() "
                    "— the copy stream's upload may still be running "
                    "and the consumer's stream has not been ordered "
                    "behind it; read it through .wait()",
                ))
    # (c) the pinned host destination of a d2h copy is read only after a
    # synchronize() that dominates the read
    for node_idx, call, dst in copies:
        f = call.func
        if f.attr == "copy_":
            host = dst if dst in pinned else None
        else:
            host = dst if _to_host(call) else None
        if host is None:
            continue
        after = {node_idx} | _reachable(cfg, node_idx, set(), frozenset())
        for node in cfg.nodes:
            if node.idx not in after or node.idx == node_idx:
                continue
            if not _reads_name(node, host):
                continue
            if dom is None:
                dom = dominators(cfg)
            if not (syncs & dom[node.idx] & after):
                out.append((
                    node.stmt.lineno,
                    f"host buffer {host!r} of a non_blocking d2h copy is "
                    "read before a synchronize() that dominates the read "
                    "— the copy may still be in flight; synchronize its "
                    "event first",
                ))
                break


def _reads_name(node, name: str) -> bool:
    """The node reads the tensor bound to ``name``'s data: a method call
    on it, a subscript, an operand or an argument.  A bare alias or
    store (``y = host``, ``self._y = host``, ``return host``) hands the
    buffer on and is not a read; whoever holds it then owns the wait."""
    stmt = node.stmt
    if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Name):
        return False
    if isinstance(stmt, ast.Return) and isinstance(stmt.value, ast.Name):
        return False
    for sub in shallow_walk(node):
        if isinstance(sub, ast.Name) and sub.id == name and isinstance(
                sub.ctx, ast.Load):
            return True
    return False


def rule_rp07(tree: ast.Module) -> List[Tuple[int, str]]:
    """Asynchronous-copy discipline over every function of a module (see
    the module docstring)."""
    out: List[Tuple[int, str]] = []
    for func in (n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)):
        if any(isinstance(n, ast.Call) and (
                _async_copy(n) or _carrier_call(n))
               for n in ast.walk(func)) or any(
                isinstance(n, ast.Attribute) and n.attr == "tensor"
                for n in ast.walk(func)):
            _rp07_function(func, out)
    out.sort()
    return out


# -- RP08: thread/queue protocol ---------------------------------------------


def _is_thread_call(call: ast.Call, thread_imported: bool) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "Thread":
        return _dotted(f.value).split(".")[-1] == "threading"
    return isinstance(f, ast.Name) and f.id == "Thread" and thread_imported


def _contains_thread_call(node: ast.AST, thread_imported: bool) -> bool:
    return any(
        isinstance(n, ast.Call) and _is_thread_call(n, thread_imported)
        for n in ast.walk(node)
    )


def _scopes(tree: ast.Module) -> List[ast.AST]:
    return [n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)]


def _name_escapes_scope(func: ast.AST, name: str) -> bool:
    """The thread (or thread collection) bound to ``name`` leaves this
    function — returned/yielded, stored on an object, or passed to a
    call other than its own start/join — so join responsibility
    escapes with it."""
    for n in ast.walk(func):
        if isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)):
            v = getattr(n, "value", None)
            if v is not None and any(
                isinstance(x, ast.Name) and x.id == name
                for x in ast.walk(v)
            ):
                return True
        elif isinstance(n, ast.Assign):
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in n.targets) and any(
                isinstance(x, ast.Name) and x.id == name
                for x in ast.walk(n.value)
            ):
                return True
        elif isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in (
                "start", "join", "is_alive", "append",
            ):
                continue
            for a in list(n.args) + [k.value for k in n.keywords]:
                if any(isinstance(x, ast.Name) and x.id == name
                       for x in ast.walk(a)):
                    return True
    return False


def _thread_call_lines(node: ast.AST, thread_imported: bool) -> Set[int]:
    """Linenos of every ``Thread(...)`` construction inside ``node`` —
    the lines RP04's per-line findings anchor to, so RP08 coverage can
    be matched back for the one-bug-one-report dedupe."""
    return {
        n.lineno
        for n in ast.walk(node)
        if isinstance(n, ast.Call) and _is_thread_call(n, thread_imported)
    }


def _rp08_function(func: ast.AST, thread_imported: bool,
                   out: List[Tuple[int, str]],
                   covered: Set[int]) -> None:
    cfg = build_cfg(func)

    # thread variables and collections (name -> contents for closure);
    # cons_lines: thread name -> Thread() construction linenos
    threads: Set[str] = set()
    contents: Dict[str, Set[str]] = {}
    cons_lines: Dict[str, Set[int]] = {}
    for node in cfg.nodes:
        for sub in shallow_walk(node):
            # append-built pools: pool.append(t) makes pool a thread
            # collection containing t (the canonical accumulate-then-
            # join-in-finally idiom)
            if isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute
            ) and sub.func.attr == "append" and isinstance(
                sub.func.value, ast.Name
            ) and sub.args and isinstance(sub.args[0], ast.Name) and \
                    sub.args[0].id in threads:
                coll = sub.func.value.id
                threads.add(coll)
                contents.setdefault(coll, set()).add(sub.args[0].id)
                continue
            if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                    and isinstance(sub.targets[0], ast.Name)):
                continue
            tgt = sub.targets[0].id
            v = sub.value
            if isinstance(v, ast.Call) and _is_thread_call(
                v, thread_imported
            ):
                threads.add(tgt)
                cons_lines.setdefault(tgt, set()).add(v.lineno)
            elif isinstance(v, (ast.ListComp, ast.GeneratorExp)) and \
                    _contains_thread_call(v, thread_imported):
                threads.add(tgt)
                cons_lines.setdefault(tgt, set()).update(
                    _thread_call_lines(v, thread_imported)
                )
            elif isinstance(v, (ast.Tuple, ast.List)):
                inner: Set[str] = set()
                for e in v.elts:
                    if isinstance(e, ast.Starred) and isinstance(
                        e.value, ast.Name
                    ):
                        inner.add(e.value.id)
                    elif isinstance(e, ast.Name):
                        inner.add(e.id)
                if inner & threads or any(i in contents for i in inner):
                    threads.add(tgt)
                    contents[tgt] = inner
    if not threads:
        return

    def covers(join_target: str) -> Set[str]:
        seen = {join_target}
        stack = [join_target]
        while stack:
            t = stack.pop()
            for c in contents.get(t, ()):
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return seen

    # events: direct x.start()/x.join(), and for-loops iterating a
    # thread collection whose body starts/joins the loop variable (the
    # event is the loop header: a zero-trip loop means zero threads, so
    # the header IS the collection-wide event)
    starts: List[Tuple[int, str, int]] = []   # (node, target, line)
    joins: List[Tuple[int, str]] = []         # (node, target)
    for node in cfg.nodes:
        stmt = node.stmt
        if node.kind == "loop" and isinstance(stmt, ast.For) and \
                isinstance(stmt.iter, ast.Name) and isinstance(
                    stmt.target, ast.Name) and stmt.iter.id in threads:
            lv, coll = stmt.target.id, stmt.iter.id
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute
                ) and isinstance(sub.func.value, ast.Name) and \
                        sub.func.value.id == lv:
                    if sub.func.attr == "start":
                        starts.append((node.idx, coll, stmt.lineno))
                    elif sub.func.attr == "join":
                        joins.append((node.idx, coll))
            continue
        for sub in shallow_walk(node):
            if isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute
            ) and isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id in threads:
                if sub.func.attr == "start":
                    starts.append((node.idx, sub.func.value.id, sub.lineno))
                elif sub.func.attr == "join":
                    joins.append((node.idx, sub.func.value.id))

    for node_idx, target, line in starts:
        if _name_escapes_scope(func, target):
            continue  # ownership (and join duty) left this function
        # this thread's join protocol is flow-checked here — RP04's
        # per-line no-join heuristic would be a duplicate report
        for name in covers(target):
            covered.update(cons_lines.get(name, ()))
        join_nodes = {n for n, jt in joins if target in covers(jt)}
        if not join_nodes:
            out.append((
                line,
                f"thread {target!r} is started but never joined in "
                "this function (and does not escape it) — join it on "
                "the shutdown path, bounded",
            ))
        elif exit_reachable_without(cfg, node_idx, join_nodes):
            out.append((
                line,
                f"thread {target!r} is not joined on every path from "
                "its start() to the function exit (an early return, "
                "break or raise path skips the join) — join in a "
                "finally",
            ))


_CLOSE_METHODS = ("close", "shutdown", "stop", "__exit__", "__del__")
_CLOSED_GUARD_MARKERS = ("closed", "stop", "shutdown", "done")


def _rp08_class(cls: ast.ClassDef, thread_imported: bool,
                out: List[Tuple[int, str]],
                covered: Set[int]) -> None:
    # attribute-held threads: self.X = threading.Thread(...)
    attr_threads: Dict[str, int] = {}
    attr_cons: Dict[str, int] = {}
    for n in ast.walk(cls):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Attribute) and isinstance(
                    n.targets[0].value, ast.Name) and \
                n.targets[0].value.id == "self" and isinstance(
                    n.value, ast.Call) and _is_thread_call(
                    n.value, thread_imported):
            attr_threads[n.targets[0].attr] = n.lineno
            attr_cons[n.targets[0].attr] = n.value.lineno
    methods = {m.name: m for m in cls.body if isinstance(m, _FUNC_NODES)}
    close_like = [methods[m] for m in _CLOSE_METHODS if m in methods]

    def attr_calls(scope: ast.AST, attr: str) -> Set[str]:
        return {
            n.func.attr
            for n in ast.walk(scope)
            if isinstance(n, ast.Call) and isinstance(
                n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Attribute)
            and n.func.value.attr == attr
            and isinstance(n.func.value.value, ast.Name)
            and n.func.value.value.id == "self"
        }

    for attr, line in attr_threads.items():
        if "start" not in attr_calls(cls, attr):
            continue
        covered.add(attr_cons[attr])  # flow-checked: dedupe RP04's no-join
        if "join" not in attr_calls(cls, attr):
            out.append((
                line,
                f"self.{attr} thread is started but the class never "
                f"joins it — a shutdown path (one of "
                f"{'/'.join(_CLOSE_METHODS[:3])}) must join",
            ))
            continue
        if close_like:
            reach = list(close_like)
            # one level of self-method calls from the close-like methods
            for m in close_like:
                for n in ast.walk(m):
                    if isinstance(n, ast.Call) and isinstance(
                        n.func, ast.Attribute
                    ) and isinstance(n.func.value, ast.Name) and \
                            n.func.value.id == "self" and \
                            n.func.attr in methods:
                        reach.append(methods[n.func.attr])
            if not any("join" in attr_calls(m, attr) for m in reach):
                out.append((
                    line,
                    f"self.{attr} thread's join is not reachable from "
                    f"the class's close-like method(s) — the shutdown "
                    "path never waits for the thread",
                ))

    # shutdown sentinel: enqueued unconditionally from close()
    sentinels = {
        n.targets[0].id
        for n in cls.body
        if isinstance(n, ast.Assign) and len(n.targets) == 1
        and isinstance(n.targets[0], ast.Name)
        and isinstance(n.value, ast.Call)
        and isinstance(n.value.func, ast.Name)
        and n.value.func.id == "object"
    }
    if not sentinels:
        return
    close = next((methods[m] for m in ("close", "shutdown", "stop")
                  if m in methods), None)
    if close is None:
        return
    cfg = build_cfg(close)
    put_nodes: Set[int] = set()
    for node in cfg.nodes:
        for sub in shallow_walk(node):
            if isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute
            ) and sub.func.attr in ("put", "put_nowait"):
                refs = any(
                    isinstance(x, ast.Attribute) and x.attr in sentinels
                    for a in sub.args for x in ast.walk(a)
                )
                if refs:
                    put_nodes.add(node.idx)
    if not put_nodes:
        out.append((
            close.lineno,
            f"{close.name}() never enqueues the shutdown sentinel "
            f"({'/'.join(sorted(sentinels))}) — the dispatcher is never "
            "told to drain and stop",
        ))
        return
    # exits that skip the put must be idempotence guards (a return
    # governed by a closed/stopped-flag test), nothing else
    allowed_exits: Set[int] = set()
    for node in cfg.nodes:
        if isinstance(node.stmt, ast.Return) and node.kind == "stmt":
            if any(pol and any(m in dump.lower()
                               for m in _CLOSED_GUARD_MARKERS)
                   for dump, pol in node.facts):
                allowed_exits.add(node.idx)
    if exit_reachable_without(cfg, cfg.entry, put_nodes | allowed_exits,
                              frozenset()):
        out.append((
            close.lineno,
            f"{close.name}() can exit without enqueueing the shutdown "
            "sentinel on a path that is not a closed-flag guard — the "
            "sentinel enqueue must be unconditional",
        ))


def _rp08_ack_after_yield(func: ast.AST,
                          out: List[Tuple[int, str]]) -> None:
    cfg = build_cfg(func)
    commits: List[int] = []
    yields: List[int] = []
    for node in cfg.nodes:
        for sub in shallow_walk(node):
            if isinstance(sub, ast.Assign) and any(
                isinstance(t, ast.Attribute) and t.attr == "rows_done"
                for t in sub.targets
            ):
                commits.append(node.idx)
            elif isinstance(sub, (ast.Yield, ast.YieldFrom)):
                yields.append(node.idx)
    if not commits or not yields:
        return
    dom = dominators(cfg)
    for c in commits:
        if any(c in dom[y] for y in yields):
            out.append((
                cfg.nodes[c].stmt.lineno,
                "cursor commit dominates its batch's yield — the "
                "cursor advances before the consumer has acknowledged "
                "the batch (ack-after-yield contract): a crash in the "
                "consumer would silently drop the row range on resume",
            ))


def rule_rp08(tree: ast.Module) -> Tuple[List[Tuple[int, str]], Set[int]]:
    """Thread/queue protocol over one module (see module docstring).

    Returns ``(findings, covered)`` where ``covered`` is the set of
    ``Thread(...)`` construction linenos whose join protocol this rule
    actually flow-checked (started, non-escaping threads — flagged OR
    passed).  RP04's per-line no-join heuristic stands down on those
    lines so one missing join never reports twice."""
    out: List[Tuple[int, str]] = []
    covered: Set[int] = set()
    thread_imported = any(
        isinstance(n, ast.ImportFrom) and n.module
        and n.module.endswith("threading")
        and any(a.name == "Thread" for a in n.names)
        for n in ast.walk(tree)
    )
    for func in _scopes(tree):
        _rp08_function(func, thread_imported, out, covered)
        _rp08_ack_after_yield(func, out)
    for n in ast.walk(tree):
        if isinstance(n, ast.ClassDef):
            _rp08_class(n, thread_imported, out, covered)
    return out, covered


# -- RP09: interprocedural host-sync -----------------------------------------


def _own_nodes(scope: ast.AST):
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, _FUNC_NODES + (ast.Lambda,)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _callee_syncs(callee: ast.AST, suppressed: Dict[int, Set[str]]
                  ) -> List[Tuple[int, str]]:
    """Unsuppressed host syncs lexically owned by ``callee`` (nested
    defs excluded: they do not run when the callee does)."""
    out = []
    for n in _own_nodes(callee):
        if isinstance(n, ast.Call):
            what = host_sync_what(n)
            if what is None:
                continue
            rules = suppressed.get(n.lineno, set()) | suppressed.get(
                n.lineno - 1, set()
            )
            if "RP03" in rules or "RP09" in rules:
                continue  # the owning file already justified this sync
            out.append((n.lineno, what))
    return out


def rule_rp09(tree: ast.Module, relpath: str,
              index: Optional[PackageIndex] = None,
              suppressed: Optional[Dict[int, Set[str]]] = None
              ) -> List[Tuple[int, str]]:
    """Interprocedural host-sync: loop bodies in a hot module calling
    (one level of) package functions that perform a host sync.  The
    finding anchors at the call site — that is where the hot loop pays
    the stall, and where a pragma belongs if the overlap is real.  A
    caller-provided ``index`` is never mutated; its entry for this
    module (same source, indexed once by ``lint_package``) is reused."""
    idx = index if index is not None else PackageIndex()
    self_info = idx.modules.get(relpath) if index is not None else None
    if self_info is None:
        self_info = index_module(relpath, tree, suppressed)
    parents = _parents_map(tree)

    def enclosing(node: ast.AST, kinds) -> Optional[ast.AST]:
        p = parents.get(node)
        while p is not None and not isinstance(p, kinds):
            p = parents.get(p)
        return p

    out: List[Tuple[int, str]] = []
    seen: Set[Tuple[int, str]] = set()
    loops = [n for n in ast.walk(tree)
             if isinstance(n, (ast.For, ast.While, ast.AsyncFor))]
    for loop in loops:
        encl_func = enclosing(loop, _FUNC_NODES)
        cls = enclosing(loop, (ast.ClassDef,))
        cls_name = cls.name if cls is not None else None
        for n in ast.walk(loop):
            if not isinstance(n, ast.Call) or host_sync_what(n) is not None:
                continue  # direct syncs are RP03's finding, not RP09's
            resolved = idx.resolve(n, self_info, cls_name)
            if resolved is None:
                continue
            owner, callee, display = resolved
            if callee is encl_func:
                continue  # recursion: the loop IS the callee
            syncs = _callee_syncs(callee, owner.suppressed)
            if not syncs:
                continue
            key = (n.lineno, display)
            if key in seen:
                continue
            seen.add(key)
            sline, what = syncs[0]
            where = (f"{owner.relpath}:{sline}"
                     if owner.relpath != relpath else f"line {sline}")
            out.append((
                n.lineno,
                f"call to {display}() inside a hot-module loop reaches "
                f"a host sync ({what} at {where}) — the helper blocks "
                "the loop on d2h every iteration; overlap the fetch or "
                "hoist the call",
            ))
    return out


# -- RP10: cross-thread shared-state races -----------------------------------


@dataclasses.dataclass
class _Access:
    """One data access of a shared name: ``kind`` is ``read``/``write``
    for the binding itself and ``call`` for a method call *on* the
    bound object (``self._q.put(...)``) — call accesses are the
    object's own synchronization concern (the queue.Queue handoff
    exemption) and never participate in conflicts; ``init`` marks a
    write proven to happen before any thread publication."""

    name: str
    kind: str
    role: str
    locks: frozenset
    line: int
    fn: str
    relpath: str
    init: bool = False


def _fn_params(fn: ast.AST) -> Set[str]:
    a = fn.args
    names = {x.arg for x in a.args + a.posonlyargs + a.kwonlyargs}
    if a.vararg is not None:
        names.add(a.vararg.arg)
    if a.kwarg is not None:
        names.add(a.kwarg.arg)
    return names


def _scan_self(func: ast.AST, parents: Dict[ast.AST, ast.AST],
               relpath: str, method_names: Set[str]):
    """``self.``-attribute data accesses of one function (with the
    locks lexically held at each), plus its resolvable call edges:
    ``("self", name, locks, line)`` for same-class method calls and
    ``("name", name, locks, line)`` for bare-name calls.  A direct
    ``self.x(...)`` call where ``x`` is NOT a class method is a *read*
    of a stored callable, not a call edge."""
    regions = lock_regions(func)
    accs: List[_Access] = []
    calls: List[Tuple[str, str, frozenset, int]] = []
    for n in _own_nodes(func):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            calls.append((
                "name", n.func.id,
                frozenset(regions.held.get(id(n), ())), n.lineno,
            ))
            continue
        if not (isinstance(n, ast.Attribute) and isinstance(
                n.value, ast.Name) and n.value.id == "self"):
            continue
        locks = frozenset(regions.held.get(id(n), ()))
        p = parents.get(n)
        if isinstance(n.ctx, (ast.Store, ast.Del)):
            kind = "write"
        elif isinstance(p, ast.Call) and p.func is n:
            if n.attr in method_names:
                calls.append(("self", n.attr, locks, n.lineno))
                continue
            kind = "read"  # stored callable: self.prepare(batch)
        elif isinstance(p, ast.Attribute):
            gp = parents.get(p)
            kind = (
                "call"
                if isinstance(gp, ast.Call) and gp.func is p
                else "read"
            )
        elif isinstance(p, ast.Subscript) and p.value is n and isinstance(
            p.ctx, (ast.Store, ast.Del)
        ):
            kind = "write"  # container mutation: self._tallies[k] = v
        else:
            kind = "read"
        accs.append(_Access(
            n.attr, kind, "", locks, n.lineno,
            getattr(func, "name", "<module>"), relpath,
        ))
    return accs, calls


def _resolve_bare(name: str, func: ast.AST,
                  parents: Dict[ast.AST, ast.AST],
                  mod: ModuleInfo) -> Optional[ast.AST]:
    """A bare-name callee, preferring lexical proximity: nested defs of
    ``func``, then of its enclosing functions, then module-level defs."""
    scope: Optional[ast.AST] = func
    while scope is not None:
        if isinstance(scope, _FUNC_NODES):
            for stmt in ast.walk(scope):
                if isinstance(stmt, _FUNC_NODES) and stmt is not scope \
                        and stmt.name == name:
                    return stmt
        scope = parents.get(scope)
    if name in mod.funcs:
        return mod.funcs[name]
    return mod.nested.get(name)


def _merged_methods(cls: ast.ClassDef, mod: ModuleInfo,
                    index: PackageIndex
                    ) -> Tuple[Dict[str, Tuple[ast.AST, str]],
                               List[Tuple[ast.AST, str]]]:
    """The class's method table over one level of package-resolvable
    bases (same-module classes and ``from randomprojection_tpu_torch...
    import`` names; derived definitions win) — so a subclass's hook
    methods join the thread roles its base class constructs.  Also
    returns the *shadowed* base definitions: an overridden base
    ``__init__`` still runs through ``super().__init__()``, so thread
    entry points constructed there must stay discoverable."""
    out: Dict[str, Tuple[ast.AST, str]] = {}
    shadowed: List[Tuple[ast.AST, str]] = []
    for base in cls.bases:
        if not isinstance(base, ast.Name):
            continue
        target = mod.imports.get(base.id)
        if target is not None:
            other = index.modules.get(target[0])
            if other is not None:
                for (cname, mname), fn in other.methods.items():
                    if cname == target[1]:
                        out[mname] = (fn, other.relpath)
        else:
            for (cname, mname), fn in mod.methods.items():
                if cname == base.id:
                    out[mname] = (fn, mod.relpath)
    for (cname, mname), fn in mod.methods.items():
        if cname == cls.name:
            prev = out.get(mname)
            if prev is not None:
                shadowed.append(prev)
            out[mname] = (fn, mod.relpath)
    return out, shadowed


def _publication_nodes(cfg: CFG) -> Set[int]:
    """CFG nodes of ``__init__`` that may publish ``self`` to a thread:
    any ``.start()`` call, and ``super().__init__(...)`` (the base
    constructor may start threads of its own)."""
    pubs: Set[int] = set()
    for node in cfg.nodes:
        for sub in shallow_walk(node):
            if not (isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute)):
                continue
            if sub.func.attr == "start":
                pubs.add(node.idx)
            elif sub.func.attr == "__init__" and isinstance(
                sub.func.value, ast.Call
            ) and isinstance(sub.func.value.func, ast.Name) and \
                    sub.func.value.func.id == "super":
                pubs.add(node.idx)
    return pubs


def _mark_init_writes(init_fn: ast.AST, accs: List[_Access]) -> None:
    """Mark writes in ``__init__`` that dominate every thread
    publication point (``.start()`` / ``super().__init__``) on its CFG
    as init-only: they happen-before the thread exists, so they can
    never race it."""
    cfg = build_cfg(init_fn)
    node_of: Dict[int, int] = {}
    for node in cfg.nodes:
        for sub in shallow_walk(node):
            node_of.setdefault(id(sub), node.idx)
    pubs = _publication_nodes(cfg)
    dom = dominators(cfg) if pubs else None
    by_line: Dict[int, List[int]] = {}
    for node in cfg.nodes:
        for sub in shallow_walk(node):
            if isinstance(sub, ast.Attribute) and isinstance(
                sub.value, ast.Name
            ) and sub.value.id == "self":
                by_line.setdefault(sub.lineno, []).append(node.idx)
    for a in accs:
        if a.kind != "write" or a.fn != "__init__":
            continue
        nodes = by_line.get(a.line, [])
        if not nodes:
            continue
        if dom is None:
            a.init = True  # no publication in __init__: trivially before
        else:
            a.init = all(
                any(n in dom[p] for n in nodes) for p in pubs
            )


_HANDOFF_NOTE = (
    "protect every access path with the same lock, hand the value "
    "across roles through a queue.Queue, or write it only before the "
    "thread starts"
)


def _report_conflicts(accs: List[_Access], has_roles: bool, relpath: str,
                      what: str, out: List[Tuple[int, str]]) -> None:
    """Conflict detection over one shared name's accesses.  With thread
    roles: a race is a *cross-role pair* with at least one write and no
    lock in common — judged pairwise, because same-role accesses run on
    one thread and can never race each other (an unlocked read on the
    writer's own thread must not fail a properly locked cross-role
    pair).  Without roles (no thread constructed here): the
    lock-*consistency* leg — state touched under a lock somewhere must
    hold that lock everywhere it is accessed."""
    post = [a for a in accs if a.kind in ("read", "write") and not a.init]
    writes = [a for a in post if a.kind == "write"]
    if not writes:
        return
    post.sort(key=lambda a: (a.line, a.kind))
    if has_roles:
        pairs = [
            (a, b)
            for i, a in enumerate(post) for b in post[i + 1:]
            if a.role != b.role
            and ("write" in (a.kind, b.kind))
            and not (a.locks & b.locks)
        ]
        if not pairs:
            return
        involved: List[_Access] = []
        seen: Set[int] = set()
        for a, b in pairs:
            for x in (a, b):
                if id(x) not in seen:
                    seen.add(id(x))
                    involved.append(x)
        involved.sort(key=lambda a: a.line)
        anchor = next((a for a in involved if a.relpath == relpath), None)
        if anchor is None:
            return  # conflict lives entirely in the base module's file
        mate = None
        for a, b in pairs:
            if a is anchor or b is anchor:
                m = b if a is anchor else a
                if mate is None or m.line < mate.line:
                    mate = m
        w = anchor if anchor.kind == "write" else mate
        other = mate if w is anchor else anchor
        out.append((
            anchor.line,
            f"{what} is written by role {w.role!r} ({w.fn}, line "
            f"{w.line}) and {'written' if other.kind == 'write' else 'read'}"
            f" by role {other.role!r} ({other.fn}, line {other.line}) "
            f"with no common lock — {_HANDOFF_NOTE}",
        ))
    else:
        common = frozenset.intersection(*(a.locks for a in post))
        if common:
            return
        locked = [a for a in post if a.locks]
        if not locked:
            return  # no lock basis to judge a thread-free class against
        bare = next((a for a in post if not a.locks
                     and a.relpath == relpath), None)
        if bare is None:
            return
        lock_disp = sorted(locked[0].locks)[0]
        out.append((
            bare.line,
            f"{what} is locked inconsistently: accessed under "
            f"{lock_disp} ({locked[0].fn}, line {locked[0].line}) but "
            f"{bare.kind} without it here ({bare.fn}) — every post-init "
            "access must hold the same lock",
        ))


def _class_rp10(cls: ast.ClassDef, mod: ModuleInfo, index: PackageIndex,
                parents_of: Dict[str, Dict[ast.AST, ast.AST]],
                out: List[Tuple[int, str]]) -> None:
    methods, shadowed = _merged_methods(cls, mod, index)
    method_names = set(methods)

    def parents_for(rel: str) -> Dict[ast.AST, ast.AST]:
        if rel not in parents_of:
            info = index.modules.get(rel)
            parents_of[rel] = _parents_map(
                info.tree if info is not None else mod.tree
            )
        return parents_of[rel]

    # thread entry points over the merged method bodies — and the
    # shadowed base bodies (super().__init__() still runs them), with
    # the target resolved against the MERGED table so a derived
    # override of the entry point wins
    rel_of = {id(f): r for _m, (f, r) in methods.items()}
    entries: List[Tuple[str, ast.AST, str]] = []
    entry_ids: Set[int] = set()
    scan = [(fn, rel) for _m, (fn, rel) in sorted(methods.items())]
    scan += shadowed
    mdefs = {m: f for m, (f, _r) in methods.items()}
    for fn, rel in scan:
        nested = {
            n.name: n for n in ast.walk(fn)
            if isinstance(n, _FUNC_NODES) and n is not fn
        }
        for role, entry, _line in thread_entries(fn, mdefs, nested):
            if id(entry) in entry_ids:
                continue
            entry_ids.add(id(entry))
            entries.append((role, entry, rel_of.get(id(entry), rel)))

    def fold(seeds: List[Tuple[ast.AST, str]], role: str
             ) -> Tuple[List[_Access], Set[int]]:
        """Transitive access collection, one call level at a time
        through the resolvable call edges; the locks held at each call
        site fold into the callee's access contexts."""
        accs: List[_Access] = []
        reached: Set[int] = set()
        visited: Set[Tuple[int, frozenset]] = set()
        stack = [(fn, rel, frozenset()) for fn, rel in seeds]
        while stack:
            fn, rel, ctx = stack.pop()
            key = (id(fn), ctx)
            if key in visited:
                continue
            visited.add(key)
            reached.add(id(fn))
            a, calls = _scan_self(fn, parents_for(rel), rel, method_names)
            for acc in a:
                acc = dataclasses.replace(
                    acc, role=role, locks=acc.locks | ctx
                )
                accs.append(acc)
            for ckind, cname, clocks, _cline in calls:
                tgt: Optional[Tuple[ast.AST, str]] = None
                if ckind == "self":
                    m = methods.get(cname)
                    if m is not None:
                        tgt = m
                else:
                    t = _resolve_bare(cname, fn, parents_for(rel),
                                      index.modules.get(rel, mod))
                    if t is not None:
                        tgt = (t, rel)
                if tgt is not None:
                    stack.append((tgt[0], tgt[1], ctx | clocks))
        return accs, reached

    role_accs: List[_Access] = []
    thread_reached: Set[int] = set()
    for role, entry, rel in entries:
        accs, reached = fold([(entry, rel)], role)
        role_accs += accs
        thread_reached |= reached

    has_roles = bool(entries)
    if has_roles:
        main_seeds = [
            (fn, rel) for _m, (fn, rel) in sorted(methods.items())
            if id(fn) not in thread_reached
        ]
        accs, _ = fold(main_seeds, "main")
        role_accs += accs
    else:
        # lock-consistency leg: per-method accesses, no role folding
        for _m, (fn, rel) in sorted(methods.items()):
            a, _calls = _scan_self(fn, parents_for(rel), rel, method_names)
            role_accs += [dataclasses.replace(x, role="main") for x in a]

    init = methods.get("__init__")
    if init is not None:
        _mark_init_writes(init[0], role_accs)

    by_attr: Dict[str, List[_Access]] = {}
    for a in role_accs:
        by_attr.setdefault(a.name, []).append(a)
    for attr in sorted(by_attr):
        _report_conflicts(
            by_attr[attr], has_roles, mod.relpath,
            f"shared attribute self.{attr} of {cls.name}", out,
        )


def _module_rp10(tree: ast.Module, relpath: str,
                 out: List[Tuple[int, str]]) -> None:
    """Module-global leg: names rebound through ``global`` declarations
    get the lock-consistency check across every function that touches
    them (the ``_RUN_TOKEN``/``_SPAN_SEQ`` class of state)."""
    gnames: Set[str] = set()
    funcs = [n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)]
    for fn in funcs:
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Global):
                gnames.update(stmt.names)
    for g in sorted(gnames):
        accs: List[_Access] = []
        for fn in funcs:
            if g in _fn_params(fn):
                continue
            declared = any(
                isinstance(s, ast.Global) and g in s.names
                for s in ast.walk(fn)
            )
            stores = any(
                isinstance(n, ast.Name) and n.id == g
                and isinstance(n.ctx, (ast.Store, ast.Del))
                for n in _own_nodes(fn)
            )
            if stores and not declared:
                continue  # local shadow, not the module global
            regions = lock_regions(fn)
            for n in _own_nodes(fn):
                if isinstance(n, ast.Name) and n.id == g:
                    kind = (
                        "write"
                        if isinstance(n.ctx, (ast.Store, ast.Del))
                        else "read"
                    )
                    accs.append(_Access(
                        g, kind, "main",
                        frozenset(regions.held.get(id(n), ())),
                        n.lineno, fn.name, relpath,
                    ))
        _report_conflicts(accs, False, relpath, f"module global {g}", out)


def rule_rp10(tree: ast.Module, relpath: str,
              index: Optional[PackageIndex] = None
              ) -> List[Tuple[int, str]]:
    """Cross-thread shared-state races over one module (see the module
    docstring).  ``index`` (built by ``lint_package``) lets a subclass
    in one file join the thread roles its base class constructs in
    another; without it, roles resolve within the file only."""
    idx = index if index is not None else PackageIndex()
    if relpath not in idx.modules:
        idx = PackageIndex(dict(idx.modules))
        idx.add(index_module(relpath, tree))
    mod = idx.modules[relpath]
    parents_of: Dict[str, Dict[ast.AST, ast.AST]] = {}
    out: List[Tuple[int, str]] = []
    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef):
            _class_rp10(stmt, mod, idx, parents_of, out)
    _module_rp10(tree, relpath, out)
    out.sort()
    return out


# -- RP11: lock-order deadlock lint ------------------------------------------

_BLOCKING_CALLS = {
    "put": "a full queue blocks the producer inside the critical "
           "section",
    "join": "the joined thread may need this very lock to finish",
    "result": "the future's worker may need this very lock to complete",
}


def _blocking_what(call: ast.Call) -> Optional[str]:
    """The blocking-call class this call belongs to, with the string /
    path ``join`` idioms excluded.  A thread join's only positional
    argument is a numeric timeout — any other positional shape
    (``sep.join(parts)``, ``"".join(x for ...)``) is a string join."""
    f = call.func
    if not isinstance(f, ast.Attribute) or f.attr not in _BLOCKING_CALLS:
        return None
    if f.attr == "join":
        if isinstance(f.value, ast.Constant):
            return None  # "sep".join(...)
        base = _dotted(f.value)
        if "path" in base.split("."):
            return None  # os.path.join and friends
        if call.args and not (
            len(call.args) == 1
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, (int, float))
        ):
            return None  # iterable positional: a string join
    return f.attr


def _sccs(edges: Set[Tuple[str, str]]) -> List[Set[str]]:
    """Strongly connected components (iterative Tarjan) of the lock
    graph; only components that can deadlock (size > 1, or a self
    edge) are returned."""
    adj: Dict[str, List[str]] = {}
    nodes: Set[str] = set()
    for a, b in sorted(edges):
        adj.setdefault(a, []).append(b)
        nodes.add(a)
        nodes.add(b)
    idx: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(adj.get(root, ())))]
        idx[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in idx:
                    idx[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                if w in on:
                    low[v] = min(low[v], idx[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == idx[v]:
                comp: Set[str] = set()
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.add(w)
                    if w == v:
                        break
                if len(comp) > 1 or (v, v) in edges:
                    out.append(comp)

    for n in sorted(nodes):
        if n not in idx:
            strongconnect(n)
    return out


def rule_rp11(tree: ast.Module, relpath: str,
              index: Optional[PackageIndex] = None
              ) -> List[Tuple[int, str]]:
    """Lock-order deadlock lint: build the lock-acquisition ordering
    graph (nested ``with``-lock regions, plus acquisitions one call
    level away through the package index), flag cycles, and flag
    blocking calls (``.put``/``.join``/``.result``) made while any lock
    is held."""
    idx = index if index is not None else PackageIndex()
    self_info = idx.modules.get(relpath)
    if self_info is None:
        self_info = index_module(relpath, tree)
    parents = _parents_map(tree)

    def encl_class(node: ast.AST) -> Optional[str]:
        p = parents.get(node)
        while p is not None and not isinstance(p, ast.ClassDef):
            p = parents.get(p)
        return p.name if isinstance(p, ast.ClassDef) else None

    method_class = {
        id(fn): cname for (cname, _m), fn in self_info.methods.items()
    }

    def qual(name: str, cls: Optional[str]) -> str:
        # self.X locks are per-instance: scope them by class so two
        # classes' self._lock never alias in the order graph
        if name.startswith("self.") and cls is not None:
            return f"{cls}.{name[len('self.'):]}"
        return name

    # locks constructed as threading.RLock(): re-entering one is legal,
    # so self-edges on them are not findings (order cycles still are)
    reentrant: Set[str] = set()
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.value, ast.Call)):
            continue
        f = n.value.func
        cname = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else ""
        )
        if cname != "RLock":
            continue
        tgt = n.targets[0]
        if isinstance(tgt, ast.Attribute) and isinstance(
            tgt.value, ast.Name
        ) and tgt.value.id == "self":
            reentrant.add(qual(f"self.{tgt.attr}", encl_class(n)))
        elif isinstance(tgt, ast.Name):
            reentrant.add(tgt.id)

    edges: Dict[Tuple[str, str], int] = {}  # (src, dst) -> earliest line
    blocking: List[Tuple[int, str, str, str]] = []

    def note_edge(a: str, b: str, line: int) -> None:
        prev = edges.get((a, b))
        if prev is None or line < prev:
            edges[(a, b)] = line

    for fn in _scopes(tree):
        cls = encl_class(fn)
        regions = lock_regions(fn)
        for name, line, held in regions.acquisitions:
            lid = qual(name, cls)
            for h in held:
                note_edge(qual(h, cls), lid, line)
        for n in _own_nodes(fn):
            if not isinstance(n, ast.Call):
                continue
            held = regions.held.get(id(n), ())
            if not held:
                continue
            what = _blocking_what(n)
            if what is not None:
                blocking.append((
                    n.lineno, what, qual(held[-1], cls), "",
                ))
                continue
            resolved = idx.resolve(n, self_info, cls)
            if resolved is None:
                continue
            owner, callee, display = resolved
            callee_cls = method_class.get(id(callee)) if (
                owner.relpath == relpath
            ) else None
            sub_regions = lock_regions(callee)
            for name2, _line2, _held2 in sub_regions.acquisitions:
                lid2 = qual(name2, callee_cls)
                for h in held:
                    note_edge(qual(h, cls), lid2, n.lineno)
            for sub in _own_nodes(callee):
                if isinstance(sub, ast.Call):
                    w = _blocking_what(sub)
                    if w is not None:
                        blocking.append((
                            n.lineno, w, qual(held[-1], cls),
                            display,
                        ))
                        break

    out: List[Tuple[int, str]] = []
    edge_set = set(edges)
    for comp in _sccs(edge_set):
        comp_edges = [
            (line, a, b) for (a, b), line in edges.items()
            if a in comp and b in comp
        ]
        line = min(l for l, _a, _b in comp_edges)
        if len(comp) == 1:
            lock = next(iter(comp))
            if lock in reentrant:
                continue  # threading.RLock: re-entry is legal
            out.append((
                line,
                f"lock {lock} is re-acquired while already held "
                "— threading.Lock is not reentrant; this deadlocks "
                "immediately",
            ))
            continue
        names = sorted(comp)
        out.append((
            line,
            "lock-order cycle: " + " -> ".join(names + [names[0]]) +
            " — these locks are acquired in conflicting orders on "
            "different paths; two threads interleaving them deadlock",
        ))
    for line, what, lock, via in blocking:
        reach = f"call to {via}() reaches " if via else ""
        out.append((
            line,
            f"{reach}blocking .{what}() while holding lock {lock} — "
            f"{_BLOCKING_CALLS[what]}; move the blocking call outside "
            "the lock region",
        ))
    out.sort()
    return out


# -- shared call-shape primitives for RP12-RP14 ------------------------------


def _call_last(call: ast.Call) -> str:
    """Last component of the callee name ('' when dynamic)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _call_base(call: ast.Call) -> str:
    """Last component of the callee's receiver ('' for bare names)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return _dotted(f.value).split(".")[-1]
    return ""


# -- RP12: resource lifecycle ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Resource:
    """One paired-acquire/release protocol RP12 enforces."""

    what: str
    close_attrs: Tuple[str, ...]      # x.<attr>() releases the handle
    release_callees: Tuple[str, ...]  # <callee>(x, ...) releases it
    advice: str


_RP12_SUBSCRIPTION = _Resource(
    "telemetry subscription", ("close",), ("unsubscribe",),
    "unsubscribe it (or close the Subscription) in a finally",
)
_RP12_METRICS = _Resource(
    "MetricsServer", ("close", "shutdown"), (),
    "close() it in a finally or use it as a context manager",
)
_RP12_HEALTH = _Resource(
    "HealthEngine", ("close",), (),
    "close() it in a finally",
)
_RP12_OPEN = _Resource(
    "open() handle", ("close",), (),
    "use a with block or close() it in a finally",
)
_RP12_MEMMAP = _Resource(
    "np.memmap handle", ("close",), (),
    "close the underlying mmap (handle._mmap.close()) or hand the "
    "handle to an owner",
)
_RP12_TMPDIR = _Resource(
    "mkdtemp temp dir", (), ("rmtree",),
    "shutil.rmtree() it in a finally",
)

#: Passing a handle to one of these callees is the *release*, not an
#: ownership transfer — it must not exempt the acquire as an escape.
_RP12_NON_OWNING_CALLEES = frozenset({"unsubscribe", "rmtree"})


def _rp12_acquire(value: ast.AST) -> Optional[Tuple[ast.Call, _Resource]]:
    """The tracked acquire call inside an Assign value, unwrapping
    ``a if c else b`` / ``a or b`` alternatives and the
    ``Ctor(...).start()`` chained form (``.start()`` returns self)."""
    if isinstance(value, ast.IfExp):
        return _rp12_acquire(value.body) or _rp12_acquire(value.orelse)
    if isinstance(value, ast.BoolOp):
        for v in value.values:
            m = _rp12_acquire(v)
            if m is not None:
                return m
        return None
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    if (isinstance(f, ast.Attribute) and f.attr == "start"
            and isinstance(f.value, ast.Call)):
        return _rp12_acquire(f.value)
    name, base = _call_last(value), _call_base(value)
    if name == "subscribe" and (isinstance(f, ast.Name)
                                or base == "telemetry"):
        return value, _RP12_SUBSCRIPTION
    if name == "MetricsServer":
        return value, _RP12_METRICS
    if name == "HealthEngine":
        return value, _RP12_HEALTH
    if name == "open" and isinstance(f, ast.Name):
        return value, _RP12_OPEN
    if name == "memmap" and base in ("np", "numpy"):
        return value, _RP12_MEMMAP
    if name == "mkdtemp":
        return value, _RP12_TMPDIR
    return None


def _rp12_guard_facts(name: str) -> frozenset:
    """Branch facts consistent with ``name`` holding a live handle, so
    ``if x is not None: x.close()``-style guarded releases count: the
    pruned paths are exactly the ones with nothing to release."""
    def dump(expr: str) -> str:
        return ast.dump(ast.parse(expr, mode="eval").body)

    return frozenset({
        (dump(f"{name} is not None"), True),
        (dump(f"{name} is None"), False),
        (dump(name), True),
    })


def _rp12_aliases(value: ast.AST) -> Iterator[str]:
    """Names the assigned expression may directly BE (so ``y = x``
    aliases but ``data = x.read()`` — a derived value — does not)."""
    if isinstance(value, ast.Name):
        yield value.id
    elif isinstance(value, ast.IfExp):
        yield from _rp12_aliases(value.body)
        yield from _rp12_aliases(value.orelse)
    elif isinstance(value, ast.BoolOp):
        for v in value.values:
            yield from _rp12_aliases(v)
    elif isinstance(value, ast.NamedExpr):
        yield from _rp12_aliases(value.value)


def _rp12_escapes(func: ast.AST, name: str, res: _Resource) -> bool:
    """The handle outlives (or is owned beyond) this function: it is
    returned/yielded, packed into a container, re-bound (aliased or
    stored on an object — another owner can release it), passed to a
    callee that is not the paired release, or captured by a nested
    def/lambda."""
    def contains(sub: ast.AST) -> bool:
        return any(isinstance(x, ast.Name) and x.id == name
                   for x in ast.walk(sub))

    for n in _own_nodes(func):
        if isinstance(n, ast.Return):
            if n.value is not None and contains(n.value):
                return True
        elif isinstance(n, (ast.Yield, ast.YieldFrom)):
            if n.value is not None and contains(n.value):
                return True
        elif isinstance(n, (ast.Tuple, ast.List, ast.Set)):
            if any(isinstance(e, ast.Name) and e.id == name
                   for e in n.elts):
                return True
        elif isinstance(n, ast.Dict):
            vals = list(n.keys) + list(n.values)
            if any(isinstance(v, ast.Name) and v.id == name
                   for v in vals if v is not None):
                return True
        elif isinstance(n, ast.Call):
            if (_call_last(n) in res.release_callees
                    or _call_last(n) in _RP12_NON_OWNING_CALLEES):
                continue
            if any(contains(a) for a in n.args) or any(
                    contains(k.value) for k in n.keywords):
                return True
        elif isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if n.value is not None and name in _rp12_aliases(n.value):
                return True
        elif isinstance(n, (ast.Global, ast.Nonlocal)):
            if name in n.names:
                return True
    for nd in ast.walk(func):
        if nd is not func and isinstance(nd, _FUNC_NODES + (ast.Lambda,)):
            if any(isinstance(x, ast.Name) and x.id == name
                   for x in ast.walk(nd)):
                return True
    return False


def _rp12_release_nodes(cfg: CFG, name: str, res: _Resource) -> Set[int]:
    """CFG nodes that release the handle: ``x.close()``-style calls
    (receiver rooted at ``x``, so ``x._mmap.close()`` counts),
    ``unsubscribe(x)``-style release callees, ``del x``, and
    ``with x:`` / ``with closing(x):`` headers."""
    rel: Set[int] = set()
    for node in cfg.nodes:
        st = node.stmt
        if st is None:
            continue
        if isinstance(st, ast.Delete) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in st.targets):
            rel.add(node.idx)
            continue
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                ce = item.context_expr
                if isinstance(ce, ast.Name) and ce.id == name:
                    rel.add(node.idx)
                elif (isinstance(ce, ast.Call) and ce.args
                      and isinstance(ce.args[0], ast.Name)
                      and ce.args[0].id == name):
                    rel.add(node.idx)
        for sub in shallow_walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if (isinstance(f, ast.Attribute) and f.attr in res.close_attrs
                    and _dotted(f.value).split(".")[0] == name):
                rel.add(node.idx)
            elif _call_last(sub) in res.release_callees and any(
                    isinstance(a, ast.Name) and a.id == name
                    for a in sub.args):
                rel.add(node.idx)
    return rel


def _rp12_reach(cfg: CFG, start: int, targets: Set[int],
                blocked: Set[int], facts: frozenset) -> bool:
    """``node_reachable_without`` that ignores the start node's own
    exception edge: if the acquire statement itself raises, the handle
    was never bound — only exceptions *after* the bind can leak it."""
    seen: Set[int] = set()
    stack: List[int] = []
    for s, fact in cfg.nodes[start].succs:
        if cfg.nodes[s].kind == "anchor":
            continue
        if s in blocked:
            continue
        if fact is not None and (fact[0], not fact[1]) in facts:
            continue
        if s not in seen:
            seen.add(s)
            stack.append(s)
    while stack:
        n = stack.pop()
        for s, fact in cfg.nodes[n].succs:
            if s in seen or s in blocked:
                continue
            if fact is not None and (fact[0], not fact[1]) in facts:
                continue
            seen.add(s)
            stack.append(s)
    return bool(targets & seen)


def rule_rp12(tree: ast.Module) -> List[Tuple[int, str]]:
    """Resource lifecycle: paired acquire/release on every path, plus
    the acquire-ordering leg (a later acquire outside any try while
    an earlier handle is live leaks the earlier handle if it raises)."""
    out: List[Tuple[int, str]] = []
    for func in (n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)):
        _rp12_function(func, out)
    out.sort()
    return out


def _rp12_function(func: ast.AST, out: List[Tuple[int, str]]) -> None:
    cfg = build_cfg(func)
    acquires = []
    for node in cfg.nodes:
        st = node.stmt
        if node.kind != "stmt" or not isinstance(st, ast.Assign):
            continue
        if len(st.targets) != 1 or not isinstance(st.targets[0], ast.Name):
            continue  # attribute/tuple targets: the owner releases it
        m = _rp12_acquire(st.value)
        if m is not None:
            acquires.append((node.idx, st.lineno, st.targets[0].id, m[1]))
    if not acquires:
        return
    acquires.sort(key=lambda a: a[1])
    balanced = []
    for idx, line, name, res in acquires:
        if _rp12_escapes(func, name, res):
            continue
        rel = _rp12_release_nodes(cfg, name, res)
        facts = cfg.nodes[idx].facts | _rp12_guard_facts(name)
        if _rp12_reach(cfg, idx, {cfg.exit}, rel, facts):
            out.append((
                line,
                f"{res.what} {name!r} is not released on every path out "
                f"of {getattr(func, 'name', '<fn>')}() — {res.advice}; "
                "escaping handles (returned/stored/passed to an owner) "
                "are exempt",
            ))
        else:
            balanced.append((idx, line, name, res, rel, facts))
    for b_idx, b_line, b_name, b_res in acquires:
        node = cfg.nodes[b_idx]
        if any(cfg.nodes[s].kind == "anchor" for s, _ in node.succs):
            continue  # exception-protected: the handler owns cleanup
        for a_idx, a_line, a_name, _a_res, rel, facts in balanced:
            if a_idx == b_idx or a_line >= b_line:
                continue
            if _rp12_reach(cfg, a_idx, {b_idx}, rel, facts):
                out.append((
                    b_line,
                    f"{b_res.what} {b_name!r} is acquired while "
                    f"{a_name!r} (line {a_line}) is still unreleased and "
                    "this statement is not exception-protected — if this "
                    f"acquire raises, {a_name!r} leaks; release it in an "
                    "except before re-raising, or move this acquire under "
                    "the existing try",
                ))
                break


# -- RP13: durable-commit discipline -----------------------------------------

_RP13_MANIFEST_CALLEES = ("_commit_manifest", "_write_manifest")
_RP13_ARTIFACT_CALLEES = ("_write_npy_atomic", "_spill_chunk")
_RP13_WRITE_MODES = ("w", "wb", "x", "xb", "w+", "wb+", "w+b", "x+b")
_RP13_DIRFSYNC_RE = re.compile(r"fsync\w*dir|dir\w*fsync", re.I)


def _rp13_carriers(tree: ast.Module) -> Set[str]:
    """Module function names whose body reaches a directory-fsync
    (``_fsync_dir``-shaped name), transitively within the module, so a
    call to ``_commit_manifest`` counts as the caller's dir fsync."""
    fns = {n.name: n for n in ast.walk(tree)
           if isinstance(n, _FUNC_NODES)}
    carriers = {
        name for name, fn in fns.items()
        if _RP13_DIRFSYNC_RE.search(name) or any(
            isinstance(sub, ast.Call)
            and _RP13_DIRFSYNC_RE.search(_call_last(sub))
            for sub in ast.walk(fn)
        )
    }
    changed = True
    while changed:
        changed = False
        for name, fn in fns.items():
            if name in carriers:
                continue
            if any(isinstance(sub, ast.Call)
                   and _call_last(sub) in carriers
                   for sub in ast.walk(fn)):
                carriers.add(name)
                changed = True
    return carriers


def _rp13_is_dirfsync(call: ast.Call, carriers: Set[str]) -> bool:
    name = _call_last(call)
    return bool(_RP13_DIRFSYNC_RE.search(name)) or name in carriers


def _rp13_tmp_path(path_arg: ast.AST, replaces: List[ast.Call]) -> bool:
    """The opened path is a tmp staging path: it textually names a tmp,
    or it is the *source* of some ``os.replace`` in the same function
    (matched by name or by expression shape)."""
    if isinstance(path_arg, ast.Name) and "tmp" in path_arg.id.lower():
        return True
    for sub in ast.walk(path_arg):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            low = sub.value.lower()
            if "tmp" in low or ".partial" in low:
                return True
    want = ast.dump(path_arg)
    for r in replaces:
        if not r.args:
            continue
        src = r.args[0]
        if isinstance(path_arg, ast.Name) and isinstance(src, ast.Name):
            if path_arg.id == src.id:
                return True
        elif ast.dump(src) == want:
            return True
    return False


def rule_rp13(tree: ast.Module) -> List[Tuple[int, str]]:
    """Durable-commit discipline: tmp→flush→fsync→``os.replace`` for
    every artifact landing, manifest committed last (dominator query),
    and a directory fsync reachable after the replace."""
    out: List[Tuple[int, str]] = []
    carriers = _rp13_carriers(tree)
    fns = [n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)]
    cfgs: Dict[int, CFG] = {}

    def cfg_of(fn: ast.AST) -> CFG:
        c = cfgs.get(id(fn))
        if c is None:
            c = cfgs[id(fn)] = build_cfg(fn)
        return c

    for func in fns:
        _rp13_function(func, tree, fns, carriers, cfg_of, out)
    out.sort()
    return out


def _rp13_caller_fsyncs_dir(func_name: str, fns, carriers, cfg_of) -> bool:
    """Some same-module caller of ``func_name`` has a directory fsync
    reachable after the call site — the helper delegates durability of
    the parent directory to its callers (the ``_write_npy_atomic``
    pattern: ``save_index`` commits the manifest, whose commit fsyncs
    the directory)."""
    for g in fns:
        cfg_g = cfg_of(g)
        call_nodes, dir_nodes = set(), set()
        for node in cfg_g.nodes:
            for sub in shallow_walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                if _call_last(sub) == func_name:
                    call_nodes.add(node.idx)
                if _rp13_is_dirfsync(sub, carriers):
                    dir_nodes.add(node.idx)
        for c in call_nodes:
            if node_reachable_without(cfg_g, c, dir_nodes, set()):
                return True
    return False


def _rp13_function(func, tree, fns, carriers, cfg_of, out) -> None:
    cfg = cfg_of(func)
    replace_nodes: Dict[int, ast.Call] = {}
    fsync_nodes: Set[int] = set()
    flush_nodes: Set[int] = set()
    dirfsync_nodes: Set[int] = set()
    manifest_nodes: Dict[int, int] = {}
    artifact_nodes: Dict[int, int] = {}
    opens: List[Tuple[int, ast.Call]] = []
    for node in cfg.nodes:
        for sub in shallow_walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name, base = _call_last(sub), _call_base(sub)
            if name == "replace" and base == "os":
                replace_nodes[node.idx] = sub
            elif name == "fsync" and base == "os":
                fsync_nodes.add(node.idx)
            elif name == "flush":
                flush_nodes.add(node.idx)
            if _rp13_is_dirfsync(sub, carriers):
                dirfsync_nodes.add(node.idx)
            if name in _RP13_MANIFEST_CALLEES:
                manifest_nodes[node.idx] = sub.lineno
            elif name in _RP13_ARTIFACT_CALLEES:
                artifact_nodes[node.idx] = sub.lineno
            if isinstance(sub.func, ast.Name) and sub.func.id == "open":
                opens.append((node.idx, sub))

    replaces = list(replace_nodes.values())

    # leg B: raw write to a final path (no tmp→replace staging)
    for _idx, sub in opens:
        mode = None
        if len(sub.args) >= 2 and isinstance(sub.args[1], ast.Constant):
            mode = sub.args[1].value
        for k in sub.keywords:
            if k.arg == "mode" and isinstance(k.value, ast.Constant):
                mode = k.value.value
        if not (isinstance(mode, str) and mode in _RP13_WRITE_MODES):
            continue
        if not sub.args:
            continue
        if _rp13_tmp_path(sub.args[0], replaces):
            continue
        out.append((
            sub.lineno,
            f"raw open(..., {mode!r}) writes the final path in place — "
            "a crash mid-write leaves a torn artifact; write a tmp "
            "sibling, flush+fsync it, then os.replace onto the final "
            "path",
        ))

    # legs A and D: per os.replace
    for r_idx, rcall in replace_nodes.items():
        missing = []
        if node_reachable_without(cfg, cfg.entry, {r_idx}, flush_nodes):
            missing.append("a flush")
        if node_reachable_without(cfg, cfg.entry, {r_idx}, fsync_nodes):
            missing.append("an os.fsync")
        if missing:
            out.append((
                rcall.lineno,
                "os.replace is reachable without "
                + " or ".join(missing)
                + " on the staged tmp file — a crash after the rename "
                "can publish an artifact whose bytes never hit disk; "
                "flush+fsync the tmp handle before replacing",
            ))
            continue
        if not node_reachable_without(cfg, r_idx, dirfsync_nodes, set()):
            fname = getattr(func, "name", "")
            if _rp13_caller_fsyncs_dir(fname, fns, carriers, cfg_of):
                continue
            out.append((
                rcall.lineno,
                "no directory fsync is reachable after this os.replace "
                "— the rename itself can be lost on crash; fsync the "
                "parent directory (or delegate to a caller that does)",
            ))

    # leg C: manifest committed LAST (dominated by every artifact write)
    if manifest_nodes and artifact_nodes:
        dom = dominators(cfg)
        parents = _parents_map(func)
        header_of = {
            id(node.stmt): node.idx
            for node in cfg.nodes
            if node.kind in ("branch", "loop") and node.stmt is not None
        }

        def promote(a_idx: int) -> int:
            # a write under an if/loop is represented by its outermost
            # enclosing header: the header is on every path even when
            # the conditional write is skipped (zero-trip loops,
            # nothing-to-spill branches)
            cur = a_idx
            p = parents.get(cfg.nodes[a_idx].stmt)
            while p is not None and not isinstance(p, _FUNC_NODES):
                if (isinstance(p, (ast.If, ast.For, ast.While))
                        and id(p) in header_of):
                    cur = header_of[id(p)]
                p = parents.get(p)
            return cur

        for m_idx, m_line in manifest_nodes.items():
            for a_idx, a_line in artifact_nodes.items():
                if promote(a_idx) not in dom[m_idx]:
                    out.append((
                        m_line,
                        "manifest commit is not dominated by the "
                        f"chunk/spill write at line {a_line} — the "
                        "manifest must be replaced LAST, after every "
                        "artifact it names is durable, or recovery "
                        "reads a manifest pointing at missing bytes",
                    ))
                    break


# -- RP14: degraded-path audit -----------------------------------------------

_RP14_RECORDERS = (
    "note_fallback", "record_vmem_oom_retry", "record_dma_fallback",
)
_RP14_MEMO_RE = re.compile(r"no_\w*keys$|degraded", re.I)


def _rp14_degraded_emit(call: ast.Call, degraded: Optional[Set[str]]
                        ) -> Optional[str]:
    """What this call reports to the degraded-path plane: an
    ``EVENTS.<X>`` emit with X consumed by trace_report's
    DEGRADED_EVENTS (any EVENTS attr when ``degraded`` is None), or a
    recorder helper; None when it reports nothing."""
    name = _call_last(call)
    if name in _RP14_RECORDERS:
        return name
    if name == "emit" and call.args:
        a0 = call.args[0]
        if isinstance(a0, ast.Attribute):
            base = _dotted(a0.value)
            if base == "EVENTS" or base.endswith(".EVENTS"):
                if degraded is None or a0.attr in degraded:
                    return f"EVENTS.{a0.attr}"
    return None


def _rp14_memo_add(sub: ast.AST) -> bool:
    return (isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "add"
            and bool(_RP14_MEMO_RE.search(
                _dotted(sub.func.value).split(".")[-1])))


def rule_rp14(tree: ast.Module,
              degraded: Optional[Set[str]] = None
              ) -> List[Tuple[int, str]]:
    """Degraded-path audit: every fallback rung (broad except whose
    body is more than a bare re-raise) must reachably emit a
    DEGRADED_EVENTS-consumed event or call a recorder; classified
    rungs must memoize the degraded key (``_NO_*_KEYS`` / ``*degraded``
    add, CFG-reachable from the handler); and a
    fallback counter without an adjacent emit is flagged."""
    out: List[Tuple[int, str]] = []
    parents = _parents_map(tree)

    def enclosing_func(n: ast.AST) -> Optional[ast.AST]:
        p = parents.get(n)
        while p is not None and not isinstance(p, _FUNC_NODES):
            p = parents.get(p)
        return p

    for func in (n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)):
        cfg: Optional[CFG] = None
        for h in (n for n in ast.walk(func)
                  if isinstance(n, ast.ExceptHandler)):
            if enclosing_func(h) is not func:
                continue
            t = h.type
            broad = t is None or (
                isinstance(t, (ast.Name, ast.Attribute))
                and _dotted(t).split(".")[-1] in ("Exception",
                                                  "BaseException"))
            if not broad:
                continue
            if len(h.body) == 1 and isinstance(h.body[0], ast.Raise):
                continue  # a bare re-raise is not a rung
            emits = [
                e for e in (
                    _rp14_degraded_emit(sub, degraded)
                    for sub in ast.walk(h) if isinstance(sub, ast.Call))
                if e is not None
            ]
            if not emits:
                out.append((
                    h.lineno,
                    "fallback rung (broad except that continues) never "
                    "emits a DEGRADED_EVENTS-consumed telemetry event "
                    "or calls a degraded-rung recorder ("
                    + "/".join(_RP14_RECORDERS)
                    + ") — trace_report's doctor cannot see this "
                    "degradation",
                ))
                continue
            classified = any(isinstance(s, ast.Raise) for s in ast.walk(h))
            if not classified:
                continue
            if any(_rp14_memo_add(sub) for sub in ast.walk(h)):
                continue
            if cfg is None:
                cfg = build_cfg(func)
            h_nodes = {
                node.idx for node in cfg.nodes
                if node.stmt is h.body[0]
            }
            memo_nodes = {
                node.idx for node in cfg.nodes
                if any(_rp14_memo_add(sub) for sub in shallow_walk(node))
            }
            reachable = any(
                node_reachable_without(cfg, hn, memo_nodes, set(),
                                       frozenset())
                for hn in h_nodes
            )
            if not reachable:
                out.append((
                    h.lineno,
                    "classified-failure rung re-raises unrecognized "
                    "errors but never memoizes the degraded key — no "
                    "`_NO_*_KEYS`-style / `*degraded` .add() is "
                    "reachable from the handler, so every later call "
                    "re-pays the failed attempt (the r6 convention)",
                ))

    # counter-fallback adjacency: a fallback counter must sit next to
    # the event emit in one of its own enclosing statement blocks
    # (climbing stops at the function boundary, and block scans never
    # descend into nested defs — another function's emit is not
    # adjacency)
    def block_of(node: ast.AST):
        child, p = node, parents.get(node)
        while p is not None:
            if isinstance(child, ast.stmt):
                for field in ("body", "orelse", "finalbody"):
                    blk = getattr(p, field, None)
                    if isinstance(blk, list) and child in blk:
                        return p, blk
            child, p = p, parents.get(p)
        return None, None

    def block_emits(blk) -> bool:
        for st in blk:
            for sub in [st, *_own_nodes(st)]:
                if isinstance(sub, ast.Call) and (
                        _rp14_degraded_emit(sub, degraded) is not None):
                    return True
        return False

    for c in (sub for sub in ast.walk(tree) if isinstance(sub, ast.Call)):
        if not (_call_last(c) == "counter_inc" and c.args
                and isinstance(c.args[0], ast.Constant)
                and isinstance(c.args[0].value, str)
                and "fallback" in c.args[0].value):
            continue
        covered = False
        node: ast.AST = c
        while True:
            owner, blk = block_of(node)
            if blk is None:
                break
            if block_emits(blk):
                covered = True
                break
            if owner is None or isinstance(owner, _FUNC_NODES):
                break
            node = owner
        if not covered:
            out.append((
                c.lineno,
                "fallback counter incremented without an adjacent "
                "degraded-event emit in the same block — counters "
                "aggregate but the doctor's timeline needs the event; "
                "emit the matching EVENTS.* alongside",
            ))
    out.sort()
    return out
