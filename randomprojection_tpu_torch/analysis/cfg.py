"""Flow-analysis substrate for rplint: CFG + call resolution.

The per-line rules are AST pattern checks; the contracts of the
asynchronous copies, the thread shutdown paths and the helper-hidden
host syncs are properties of *paths*, not lines.  This module grows the
checker into a small framework the flow-sensitive rules
(``flowrules.py``) build on:

- **Statement-level CFG** (``build_cfg``): one node per executable
  statement plus synthetic entry/exit; edges model ``if``/``for``/
  ``while``/``try``-``finally``/``return``/``raise``/``break``/
  ``continue``.  Branch edges carry the branch condition (an
  ``ast.dump`` of the test plus polarity), and every node records the
  conditions governing it, so path queries can prune branches that
  contradict the conditions a statement already executes under (two
  ``if masked:`` blocks in one kernel body are the same world — a path
  taking the first and skipping the second is infeasible and must not
  produce a finding).
- **Path queries**: ``exit_reachable_without`` ("can the function exit
  from here without passing one of these nodes?" — the all-paths
  primitive behind the copy-event and thread-join rules) and
  ``dominators`` (the ack-after-yield rule is exactly "no cursor commit
  dominates its batch's yield").
- **Call resolution** (``PackageIndex``): a one-level intra-package
  call graph — module-level defs, same-file nested defs, ``self.``
  methods, and ``from randomprojection_tpu_torch.x import f``-style imports
  resolved against the package file set — so RP09 can see a host sync
  one call away from a hot loop without whole-program analysis.

Pure stdlib, shared with ``rplint.py``'s static-only contract: nothing
here imports the code under analysis.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

__all__ = [
    "CFG",
    "Node",
    "build_cfg",
    "exit_reachable_without",
    "node_reachable_without",
    "dominators",
    "shallow_walk",
    "dotted",
    "parents_map",
    "ModuleInfo",
    "PackageIndex",
    "index_module",
    "lock_name",
    "LockRegions",
    "lock_regions",
    "thread_entries",
]

# a branch condition: (ast.dump of the test expression, polarity)
Fact = Tuple[str, bool]

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _dump(node: ast.AST) -> str:
    return ast.dump(node)


def dotted(node: ast.AST) -> str:
    """Dotted-name string of a Name/Attribute chain ('' when dynamic).
    THE shared receiver-matching primitive — rplint's emit/Thread
    detection and flowrules' threading checks must agree on it."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def parents_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    """child AST node -> parent, for enclosing-scope lookups."""
    return {
        child: parent
        for parent in ast.walk(tree)
        for child in ast.iter_child_nodes(parent)
    }


@dataclasses.dataclass
class Node:
    """One CFG node.  ``stmt`` is the owning AST statement (None for the
    synthetic entry/exit), ``kind`` distinguishes how much of the
    statement's subtree belongs to this node (compound statements own
    only their header — their bodies are separate nodes), ``facts`` are
    the branch conditions this node executes under, and ``succs`` are
    ``(node index, edge fact)`` pairs."""

    idx: int
    stmt: Optional[ast.AST]
    kind: str  # entry|exit|stmt|branch|loop|anchor
    facts: frozenset
    succs: List[Tuple[int, Optional[Fact]]] = dataclasses.field(
        default_factory=list
    )


class CFG:
    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.entry = self._new(None, "entry", frozenset())
        self.exit = self._new(None, "exit", frozenset())

    def _new(self, stmt, kind: str, facts: frozenset) -> int:
        n = Node(len(self.nodes), stmt, kind, facts)
        self.nodes.append(n)
        return n.idx

    def edge(self, a: int, b: int, fact: Optional[Fact] = None) -> None:
        self.nodes[a].succs.append((b, fact))

    def preds(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in self.nodes]
        for n in self.nodes:
            for s, _ in n.succs:
                out[s].append(n.idx)
        return out


def shallow_walk(node: Node) -> Iterator[ast.AST]:
    """The AST nodes evaluated *at* this CFG node: the statement's own
    expressions, excluding bodies of compound statements (those are
    separate CFG nodes) and nested function/lambda/class definitions
    (those execute elsewhere, or not at all)."""
    stmt = node.stmt
    if stmt is None or node.kind in ("anchor", "entry", "exit"):
        return
    if isinstance(stmt, ast.If):
        yield from _walk_expr(stmt.test)
        return
    if isinstance(stmt, ast.While):
        yield from _walk_expr(stmt.test)
        return
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        yield from _walk_expr(stmt.target)
        yield from _walk_expr(stmt.iter)
        return
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            yield from _walk_expr(item.context_expr)
            if item.optional_vars is not None:
                yield from _walk_expr(item.optional_vars)
        return
    if isinstance(stmt, _FUNC_NODES + (ast.ClassDef,)):
        return
    yield from _walk_expr(stmt)


def _walk_expr(root: ast.AST) -> Iterator[ast.AST]:
    """Walk an expression/statement subtree without descending into
    nested function/lambda/class definitions or compound-statement
    bodies."""
    stack = [root]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, _FUNC_NODES + (ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)


class _Builder:
    """Recursive-descent CFG construction.  ``preds`` threading: every
    ``seq`` call receives the dangling ``(node, edge fact)`` frontier
    and returns the new frontier."""

    def __init__(self):
        self.cfg = CFG()
        # [header idx, [break node idxs], finally-depth at loop entry]
        self.loop_stack: List[List] = []
        self.exc_stack: List[int] = []    # innermost finally/handler anchors
        self.fin_stack: List[int] = []    # innermost FINALLY anchors only

    def connect(self, preds, node: int) -> None:
        for p, fact in preds:
            self.cfg.edge(p, node, fact)

    def seq(self, stmts: Sequence[ast.stmt], preds, facts: frozenset):
        for stmt in stmts:
            preds = self.one(stmt, preds, facts)
        return preds

    def one(self, stmt: ast.stmt, preds, facts):
        cfg = self.cfg
        if isinstance(stmt, ast.If):
            node = cfg._new(stmt, "branch", facts)
            self.connect(preds, node)
            d = _dump(stmt.test)
            t_out = self.seq(stmt.body, [(node, (d, True))],
                             facts | {(d, True)})
            if stmt.orelse:
                f_out = self.seq(stmt.orelse, [(node, (d, False))],
                                 facts | {(d, False)})
            else:
                f_out = [(node, (d, False))]
            return t_out + f_out
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            # NOTE: a while-loop's condition is re-evaluated every
            # iteration, so (unlike an `if` over a loop-invariant flag)
            # it must NOT become a persistent fact: a node inside the
            # body does reach the exit edge on a later iteration, and
            # pruning it would hide missing joins/waits whose escape
            # path is the normal loop exit.
            node = cfg._new(stmt, "loop", facts)
            self.connect(preds, node)
            self.loop_stack.append([node, [], len(self.fin_stack)])
            body_out = self.seq(stmt.body, [(node, None)], facts)
            _, breaks, _fd = self.loop_stack.pop()
            for p, fact in body_out:
                cfg.edge(p, node, fact)
            norm = [(node, None)]
            if stmt.orelse:
                norm = self.seq(stmt.orelse, norm, facts)
            return norm + [(b, None) for b in breaks]
        if isinstance(stmt, ast.Try):
            return self._try(stmt, preds, facts)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            node = cfg._new(stmt, "stmt", facts)
            self.connect(preds, node)
            return self.seq(stmt.body, [(node, None)], facts)
        if isinstance(stmt, ast.Return):
            # a return runs enclosing finally blocks, NOT except
            # handlers — route through the finally stack only
            node = cfg._new(stmt, "stmt", facts)
            self.connect(preds, node)
            cfg.edge(node, self.fin_stack[-1] if self.fin_stack else cfg.exit)
            return []
        if isinstance(stmt, ast.Raise):
            node = cfg._new(stmt, "stmt", facts)
            self.connect(preds, node)
            cfg.edge(node, self.exc_stack[-1] if self.exc_stack else cfg.exit)
            return []
        if isinstance(stmt, ast.Break):
            # break/continue run finally blocks entered SINCE the loop
            # (an enclosing try around the loop is not exited)
            node = cfg._new(stmt, "stmt", facts)
            self.connect(preds, node)
            if self.loop_stack:
                header, breaks, fin_depth = self.loop_stack[-1]
                if len(self.fin_stack) > fin_depth:
                    cfg.edge(node, self.fin_stack[-1])
                else:
                    breaks.append(node)
            return []
        if isinstance(stmt, ast.Continue):
            node = cfg._new(stmt, "stmt", facts)
            self.connect(preds, node)
            if self.loop_stack:
                header, _breaks, fin_depth = self.loop_stack[-1]
                if len(self.fin_stack) > fin_depth:
                    cfg.edge(node, self.fin_stack[-1])
                else:
                    cfg.edge(node, header)
            return []
        if isinstance(stmt, (*_FUNC_NODES, ast.ClassDef)):
            return preds  # a nested definition: not part of this flow
        node = cfg._new(stmt, "stmt", facts)
        self.connect(preds, node)
        return [(node, None)]

    def _try(self, stmt: ast.Try, preds, facts):
        cfg = self.cfg
        has_final = bool(stmt.finalbody)
        f_anchor = cfg._new(stmt, "anchor", facts) if has_final else None
        h_anchor = cfg._new(stmt, "anchor", facts) if stmt.handlers else None
        exc_target = h_anchor if h_anchor is not None else f_anchor
        if exc_target is not None:
            self.exc_stack.append(exc_target)
        if has_final:
            self.fin_stack.append(f_anchor)
        lo = len(cfg.nodes)
        body_out = self.seq(stmt.body, preds, facts)
        hi = len(cfg.nodes)
        if exc_target is not None:
            self.exc_stack.pop()
            # any statement in the try body may raise: conservative edge
            # from each to the handler/finally anchor
            for i in range(lo, hi):
                if cfg.nodes[i].kind in ("stmt", "branch", "loop"):
                    cfg.edge(i, exc_target)
        if stmt.orelse:
            body_out = self.seq(stmt.orelse, body_out, facts)
        handler_outs = []
        if stmt.handlers:
            if has_final:
                self.exc_stack.append(f_anchor)
            for h in stmt.handlers:
                handler_outs += self.seq(h.body, [(h_anchor, None)],
                                         facts)
            if has_final:
                self.exc_stack.pop()
        if has_final:
            self.fin_stack.pop()
        outs = body_out + handler_outs
        if has_final:
            self.connect(outs, f_anchor)
            # the finally runs on the exception path too; after it, the
            # exception propagates — model both continuations (normal
            # fall-through and propagation to the next anchor/exit)
            f_out = self.seq(stmt.finalbody, [(f_anchor, None)], facts)
            for p, fact in f_out:
                cfg.edge(p, self.exc_stack[-1] if self.exc_stack
                         else cfg.exit, fact)
            return f_out
        return outs


def build_cfg(func: ast.AST) -> CFG:
    """CFG of one function definition (or a module body)."""
    b = _Builder()
    body = func.body if hasattr(func, "body") else []
    out = b.seq(body, [(b.cfg.entry, None)], frozenset())
    b.connect(out, b.cfg.exit)
    return b.cfg


def _traverse(cfg: CFG, start: int, blocked: Set[int],
              facts: Optional[frozenset]) -> Set[int]:
    """Nodes reachable from ``start`` by at least one edge, without
    entering ``blocked``, skipping branch edges that contradict
    ``facts`` (the conditions the start node is already executing
    under).  ``start`` itself is in the result only when a cycle leads
    back to it."""
    if facts is None:
        facts = cfg.nodes[start].facts
    seen: Set[int] = set()
    stack = [start]
    while stack:
        n = stack.pop()
        for s, fact in cfg.nodes[n].succs:
            if s in seen or s in blocked:
                continue
            if fact is not None and (fact[0], not fact[1]) in facts:
                continue
            seen.add(s)
            stack.append(s)
    return seen


def exit_reachable_without(cfg: CFG, start: int, blocked: Set[int],
                           facts: Optional[frozenset] = None) -> bool:
    """True when some path from ``start`` reaches the function exit
    without passing through any ``blocked`` node — i.e. the blocked set
    does NOT cover every path out.  The all-paths primitive: "is this
    start waited/joined on all paths" is the negation."""
    return cfg.exit in _traverse(cfg, start, blocked, facts)


def node_reachable_without(cfg: CFG, start: int, targets: Set[int],
                           blocked: Set[int],
                           facts: Optional[frozenset] = None) -> bool:
    """True when any of ``targets`` is reachable from ``start`` without
    first passing through a ``blocked`` node."""
    return bool(targets & _traverse(cfg, start, blocked, facts))


def dominators(cfg: CFG) -> List[Set[int]]:
    """Classic iterative dominator sets (edge facts ignored).  Node d
    dominates n iff every path from entry to n passes through d."""
    n = len(cfg.nodes)
    preds = cfg.preds()
    full = set(range(n))
    dom: List[Set[int]] = [set(full) for _ in range(n)]
    dom[cfg.entry] = {cfg.entry}
    changed = True
    while changed:
        changed = False
        for i in range(n):
            if i == cfg.entry:
                continue
            ps = preds[i]
            new = set.intersection(*(dom[p] for p in ps)) if ps else set(full)
            new = new | {i}
            if new != dom[i]:
                dom[i] = new
                changed = True
    return dom


# -- lock regions (RP10/RP11 substrate) --------------------------------------


def lock_name(expr: ast.AST) -> Optional[str]:
    """Dotted name of a lock-like ``with`` context manager, else None.

    The heuristic: a *bare* Name/Attribute context manager
    (``with self._lock:``, ``with _SPAN_LOCK:``) is a synchronization
    primitive — locks, conditions and semaphores are the only common
    objects entered without a constructing call, while every other
    context manager (``open(...)``, ``span(...)``, ``Lock()``) reaches
    the ``with`` through a Call and is excluded."""
    if isinstance(expr, (ast.Name, ast.Attribute)):
        d = dotted(expr)
        return d or None
    return None


@dataclasses.dataclass
class LockRegions:
    """Lexical lock-region view of one function:

    - ``held``: ``id(ast node) -> tuple of lock names held`` where that
      node evaluates (outermost first).  Computed over ``with``-lock
      bodies; nested function definitions are excluded — their bodies
      run at their call sites, not inside the enclosing ``with``.
    - ``acquisitions``: every lock acquisition in the function as
      ``(lock name, line, locks already held at that point)`` — the
      raw edges of the lock-order graph.
    """

    held: Dict[int, Tuple[str, ...]]
    acquisitions: List[Tuple[str, int, Tuple[str, ...]]]


def lock_regions(func: ast.AST) -> LockRegions:
    """Per-node held-lock map + acquisition list for one function (or
    module) body.  Lexical: a ``with self._lock:`` region covers its
    body (and the later items of its own ``with`` statement — item k+1
    is acquired while item k is held), matching Python's guarantee that
    the lock is held exactly for the statement's suite."""
    held: Dict[int, Tuple[str, ...]] = {}
    acquisitions: List[Tuple[str, int, Tuple[str, ...]]] = []

    def visit(node: ast.AST, stack: Tuple[str, ...]) -> None:
        held[id(node)] = stack
        if isinstance(node, _FUNC_NODES + (ast.Lambda,)) and node is not func:
            return  # nested def: runs at its call site, not here
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = stack
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    held.setdefault(id(sub), inner)
                if item.optional_vars is not None:
                    for sub in ast.walk(item.optional_vars):
                        held.setdefault(id(sub), inner)
                name = lock_name(item.context_expr)
                if name is not None:
                    acquisitions.append(
                        (name, item.context_expr.lineno, inner)
                    )
                    inner = inner + (name,)
            for stmt in node.body:
                visit(stmt, inner)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, stack)

    body = getattr(func, "body", [])
    for stmt in body:
        visit(stmt, ())
    return LockRegions(held, acquisitions)


# -- thread roles (RP10 substrate) -------------------------------------------


def thread_entries(
    scope: ast.AST,
    methods: Dict[str, ast.AST],
    nested: Dict[str, ast.AST],
) -> List[Tuple[str, ast.AST, int]]:
    """Thread entry points constructed anywhere in ``scope``: every
    ``Thread(target=X)`` whose target resolves statically — ``self.m``
    against ``methods`` or a bare name against ``nested`` (nested defs /
    module functions).  Returns ``(role name, entry def, construction
    line)`` triples; each entry function is the root of one thread
    *role* (the code that runs on that thread), the constructing code
    being the implicit "main" role."""
    out: List[Tuple[str, ast.AST, int]] = []
    seen: Set[int] = set()
    for n in ast.walk(scope):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else ""
        )
        if name != "Thread":
            continue
        target = next(
            (k.value for k in n.keywords if k.arg == "target"), None
        )
        if target is None:
            continue
        entry: Optional[ast.AST] = None
        role = ""
        if isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name
        ) and target.value.id == "self":
            entry = methods.get(target.attr)
            role = f"self.{target.attr}"
        elif isinstance(target, ast.Name):
            entry = nested.get(target.id)
            role = target.id
        if entry is not None and id(entry) not in seen:
            seen.add(id(entry))
            out.append((role, entry, n.lineno))
    return out


# -- one-level intra-package call resolution ---------------------------------


@dataclasses.dataclass
class ModuleInfo:
    """Statically-indexed view of one package module for call
    resolution: module-level defs, (class, method) defs, every nested
    def by name, from-import aliases resolved to package-relative file
    paths, and the module's pragma-suppressed lines (so a host sync the
    owning file already suppressed with a reason does not propagate
    into RP09 findings at its callers)."""

    relpath: str
    tree: ast.Module
    funcs: Dict[str, ast.FunctionDef]
    methods: Dict[Tuple[str, str], ast.FunctionDef]
    nested: Dict[str, ast.FunctionDef]
    imports: Dict[str, Tuple[str, str]]  # alias -> (relpath, original name)
    suppressed: Dict[int, Set[str]]      # line -> rule ids allowed there


# the full package name: ``randomprojection_tpu`` is a prefix of it, and
# a module of that package is not one of this package's
_PKG = "randomprojection_tpu_torch"


def _import_relpath(module: Optional[str], level: int,
                    from_relpath: str) -> Optional[str]:
    """Package-relative file path of a ``from X import ...`` source, or
    None when it is not an intra-package module."""
    if level > 0:
        base = from_relpath.replace("\\", "/").rsplit("/", 1)
        parts = base[0].split("/") if len(base) == 2 else []
        parts = parts[: len(parts) - (level - 1)] if level > 1 else parts
        mod_parts = (module or "").split(".") if module else []
        return "/".join(parts + mod_parts) + ".py" if (
            parts or mod_parts
        ) else None
    if module and (module == _PKG or module.startswith(_PKG + ".")):
        rest = module[len(_PKG):].lstrip(".")
        return (rest.replace(".", "/") + ".py") if rest else None
    return None


def index_module(relpath: str, tree: ast.Module,
                 suppressed: Optional[Dict[int, Set[str]]] = None
                 ) -> ModuleInfo:
    funcs: Dict[str, ast.FunctionDef] = {}
    methods: Dict[Tuple[str, str], ast.FunctionDef] = {}
    nested: Dict[str, ast.FunctionDef] = {}
    imports: Dict[str, Tuple[str, str]] = {}
    for stmt in tree.body:
        if isinstance(stmt, _FUNC_NODES):
            funcs[stmt.name] = stmt
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, _FUNC_NODES):
                    methods[(stmt.name, sub.name)] = sub
    for n in ast.walk(tree):
        if isinstance(n, _FUNC_NODES):
            for sub in ast.walk(n):
                if isinstance(sub, _FUNC_NODES) and sub is not n:
                    nested.setdefault(sub.name, sub)
        elif isinstance(n, ast.ImportFrom):
            rel = _import_relpath(n.module, n.level, relpath)
            if rel is not None:
                for a in n.names:
                    imports[a.asname or a.name] = (rel, a.name)
    return ModuleInfo(relpath, tree, funcs, methods, nested, imports,
                      suppressed or {})


class PackageIndex:
    """All package modules, indexed for one-level call resolution."""

    def __init__(self, modules: Optional[Dict[str, ModuleInfo]] = None):
        self.modules: Dict[str, ModuleInfo] = modules or {}

    def add(self, info: ModuleInfo) -> None:
        self.modules[info.relpath] = info

    def resolve(self, call: ast.Call, mod: ModuleInfo,
                encl_class: Optional[str]
                ) -> Optional[Tuple[ModuleInfo, ast.FunctionDef, str]]:
        """Resolve a call one level: same-module defs (module-level,
        then nested), ``self.<m>`` against the enclosing class, then
        from-imported package functions.  Returns ``(owning module,
        def, display name)`` or None for anything unresolvable."""
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in mod.funcs:
                return mod, mod.funcs[f.id], f.id
            if f.id in mod.nested:
                return mod, mod.nested[f.id], f.id
            target = mod.imports.get(f.id)
            if target is not None:
                other = self.modules.get(target[0])
                if other is not None and target[1] in other.funcs:
                    return (other, other.funcs[target[1]],
                            f"{target[0]}:{target[1]}")
            return None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self":
            if encl_class is not None:
                m = mod.methods.get((encl_class, f.attr))
                if m is not None:
                    return mod, m, f"self.{f.attr}"
            return None
        return None
