"""Interprocedural layer of graftcheck: a whole-package call graph with
dataflow summaries (graftcheck v2).

The per-file checker is lexical by design — fast, zero deps — but
the multi-host runtime adds bug classes a single function
cannot witness: a rank-derived branch whose *callee three frames down*
runs a collective, a lock held across a method call that acquires
another lock in the opposite order elsewhere, a WAL append that fsyncs
under a lock taken by the HTTP poll path. This module gives the rules a
package-wide view while staying stdlib-only (``ast`` + dicts, no torch):

- :class:`CallGraph` — every function/method definition in the analyzed
  file set, with call sites resolved through ``self.`` dispatch, same-
  module calls, package imports (``from X import Y`` / ``import X``),
  attribute types inferred from ``self._a = ClassName(...)`` in
  ``__init__``, and local-variable construction (``r = Runner(...)``).
  Unresolvable calls keep their *terminal name* (the rightmost
  attribute) so name-keyed pattern sets still apply to them.
- Transitive **reach summaries** (:meth:`CallGraph.reach`) — the
  fixed-point closure of "calling this function eventually executes an
  op in <name set>" used for collectives and blocking operations. The
  summary carries a witness chain (``a -> b -> barrier``) so findings
  can explain the path.
- **Rank-taint dataflow** (:class:`TaintEngine`) — rank sources
  (``process_index()``, ``.rank`` / ``.is_primary``, ``DLPS_RANK`` env
  reads) propagated through local assignments, through *returns*
  (``is_primary()``-style predicates taint their callers), and through
  *call arguments* (a function that branches a collective on its
  parameter is divergent exactly when a caller passes it a rank fact).
- **Lock model** (:class:`LockModel`) — per-class lock attributes
  (``threading.Lock/RLock`` assigned in ``__init__``, ``Condition``
  aliases resolved), module-level locks, transitively-acquired lock
  sets per function, and the global lock-order edge graph the static
  deadlock rule runs a cycle search over.

Resolution is deliberately *best-effort and conservative*: a call the
graph cannot resolve contributes only its terminal name. That keeps the
engine sound for the gate (no crash on dynamic dispatch) at the cost of
missing exotic flows — the dynamic lockorder recorder and the runtime
tests stay the backstop for those.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# A function key: (pkg_path, qualname) where qualname is "func" or
# "Class.method". One entry per def, nested defs keyed "outer.<locals>.f"
# are skipped (they execute under their outer frame's findings anyway).
FuncKey = Tuple[str, str]


class FunctionUnit:
    """One analyzed function/method definition."""

    __slots__ = ("key", "node", "ctx", "class_name", "call_sites")

    def __init__(self, key: FuncKey, node, ctx, class_name: Optional[str]):
        self.key = key
        self.node = node
        self.ctx = ctx
        self.class_name = class_name
        # filled by CallGraph._resolve: [(call_node, resolved_key|None,
        # terminal_name)]
        self.call_sites: List[Tuple[ast.Call, Optional[FuncKey], str]] = []

    @property
    def pkg_path(self) -> str:
        return self.key[0]

    @property
    def qualname(self) -> str:
        return self.key[1]


def terminal_name(func: ast.AST) -> str:
    """The rightmost name of a call target — ``a.b.c()`` -> ``c``,
    ``f()`` -> ``f``. Name-keyed pattern sets match on this."""
    while isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _self_attr(node: ast.AST) -> str:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return ""


def _pkg_path_of_module(dotted: str, files: Dict[str, object]) -> Optional[str]:
    """Map a dotted import (``distributedlpsolver_tpu_torch.serve.journal`` or a
    relative remainder like ``serve.journal``) to a pkg_path present in
    the analyzed file set."""
    parts = dotted.split(".")
    if parts and parts[0] == "distributedlpsolver_tpu_torch":
        parts = parts[1:]
    if not parts:
        return None
    cand = "/".join(parts) + ".py"
    if cand in files:
        return cand
    cand_init = "/".join(parts) + "/__init__.py"
    if cand_init in files:
        return cand_init
    return None


class CallGraph:
    """Whole-file-set function index + resolved call sites + summaries."""

    def __init__(self, contexts: Sequence):
        # contexts: FileContext list (analysis.core). Keyed by pkg_path.
        self.files: Dict[str, object] = {c.pkg_path: c for c in contexts}
        self.functions: Dict[FuncKey, FunctionUnit] = {}
        # (pkg_path, ClassName) -> ClassDef
        self.classes: Dict[Tuple[str, str], ast.ClassDef] = {}
        # pkg_path -> {local name: ("mod", pkg_path2) | ("sym", pkg_path2, name)}
        self.imports: Dict[str, Dict[str, tuple]] = {}
        # (pkg_path, ClassName) -> {attr: (pkg_path2, ClassName2)}
        self.attr_types: Dict[Tuple[str, str], Dict[str, Tuple[str, str]]] = {}
        self._reach_cache: Dict[tuple, Dict[FuncKey, Tuple[str, ...]]] = {}
        for ctx in contexts:
            self._index_file(ctx)
        for ctx in contexts:
            self._infer_attr_types(ctx)
        for unit in self.functions.values():
            self._resolve_calls(unit)

    # -- indexing ----------------------------------------------------------

    def _index_file(self, ctx) -> None:
        imports: Dict[str, tuple] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    target = _pkg_path_of_module(alias.name, self.files)
                    if target:
                        imports[alias.asname or alias.name.split(".")[-1]] = (
                            "mod",
                            target,
                        )
            elif isinstance(node, ast.ImportFrom) and node.module:
                target = _pkg_path_of_module(node.module, self.files)
                for alias in node.names:
                    # ``from X import Y`` where Y is itself a module file
                    # (``from ...obs import trace as obs_trace``): the
                    # submodule interpretation wins over "symbol of X's
                    # __init__".
                    sub = _pkg_path_of_module(
                        f"{node.module}.{alias.name}", self.files
                    )
                    if sub:
                        imports[alias.asname or alias.name] = ("mod", sub)
                    elif target:
                        imports[alias.asname or alias.name] = (
                            "sym",
                            target,
                            alias.name,
                        )
        self.imports[ctx.pkg_path] = imports

        for node in ctx.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = (ctx.pkg_path, node.name)
                self.functions[key] = FunctionUnit(key, node, ctx, None)
                self._index_nested(ctx, node, node.name, None)
            elif isinstance(node, ast.ClassDef):
                self.classes[(ctx.pkg_path, node.name)] = node
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        key = (ctx.pkg_path, f"{node.name}.{sub.name}")
                        self.functions[key] = FunctionUnit(
                            key, sub, ctx, node.name
                        )
                        self._index_nested(
                            ctx, sub, f"{node.name}.{sub.name}", node.name
                        )

    def _index_nested(self, ctx, fn, qual: str, class_name) -> None:
        # Nested defs are analyzed as part of their enclosing unit for
        # dataflow, but indexed so `# holds:`-style lookups by line work.
        for sub in ast.walk(fn):
            if sub is fn:
                continue
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = (ctx.pkg_path, f"{qual}.<locals>.{sub.name}")
                self.functions.setdefault(
                    key, FunctionUnit(key, sub, ctx, class_name)
                )

    def _resolve_class_name(
        self, pkg_path: str, node: ast.AST
    ) -> Optional[Tuple[str, str]]:
        """``ClassName`` / ``mod.ClassName`` expression -> class key."""
        if isinstance(node, ast.Name):
            if (pkg_path, node.id) in self.classes:
                return (pkg_path, node.id)
            imp = self.imports.get(pkg_path, {}).get(node.id)
            if imp and imp[0] == "sym" and (imp[1], imp[2]) in self.classes:
                return (imp[1], imp[2])
        elif isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ):
            imp = self.imports.get(pkg_path, {}).get(node.value.id)
            if imp and imp[0] == "mod" and (imp[1], node.attr) in self.classes:
                return (imp[1], node.attr)
        return None

    def _infer_attr_types(self, ctx) -> None:
        """``self._a = ClassName(...)`` in ``__init__`` -> attr type."""
        for (pkg, cls_name), cls in list(self.classes.items()):
            if pkg != ctx.pkg_path:
                continue
            init = next(
                (
                    n
                    for n in cls.body
                    if isinstance(n, ast.FunctionDef) and n.name == "__init__"
                ),
                None,
            )
            if init is None:
                continue
            types: Dict[str, Tuple[str, str]] = {}
            for node in ast.walk(init):
                if not isinstance(node, ast.Assign):
                    continue
                if not (
                    isinstance(node.value, ast.Call)
                ):
                    continue
                target_cls = self._resolve_class_name(pkg, node.value.func)
                if target_cls is None:
                    continue
                for t in node.targets:
                    a = _self_attr(t)
                    if a:
                        types[a] = target_cls
            self.attr_types[(pkg, cls_name)] = types

    # -- call resolution ---------------------------------------------------

    def _local_instance_types(self, unit: FunctionUnit) -> Dict[str, Tuple[str, str]]:
        out: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(unit.node):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                cls = self._resolve_class_name(unit.pkg_path, node.value.func)
                if cls is None:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = cls
        return out

    def _resolve_calls(self, unit: FunctionUnit) -> None:
        pkg = unit.pkg_path
        imports = self.imports.get(pkg, {})
        local_types = self._local_instance_types(unit)
        for node in ast.walk(unit.node):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            resolved: Optional[FuncKey] = None
            if isinstance(func, ast.Name):
                if (pkg, func.id) in self.functions:
                    resolved = (pkg, func.id)
                else:
                    imp = imports.get(func.id)
                    if imp and imp[0] == "sym" and (imp[1], imp[2]) in self.functions:
                        resolved = (imp[1], imp[2])
                    elif imp and imp[0] == "sym" and (imp[1], imp[2]) in self.classes:
                        resolved = (imp[1], f"{imp[2]}.__init__")
                        if resolved not in self.functions:
                            resolved = None
            elif isinstance(func, ast.Attribute):
                base = func.value
                if isinstance(base, ast.Name) and base.id == "self":
                    if unit.class_name:
                        cand = (pkg, f"{unit.class_name}.{func.attr}")
                        if cand in self.functions:
                            resolved = cand
                elif _self_attr(base):
                    # self._attr.method() through the inferred attr type
                    if unit.class_name:
                        types = self.attr_types.get((pkg, unit.class_name), {})
                        owner = types.get(_self_attr(base))
                        if owner:
                            cand = (owner[0], f"{owner[1]}.{func.attr}")
                            if cand in self.functions:
                                resolved = cand
                elif isinstance(base, ast.Name):
                    imp = imports.get(base.id)
                    if imp and imp[0] == "mod":
                        cand = (imp[1], func.attr)
                        if cand in self.functions:
                            resolved = cand
                    elif base.id in local_types:
                        owner = local_types[base.id]
                        cand = (owner[0], f"{owner[1]}.{func.attr}")
                        if cand in self.functions:
                            resolved = cand
            unit.call_sites.append((node, resolved, terminal_name(func)))

    # -- transitive reach --------------------------------------------------

    def reach(self, names: Iterable[str]) -> Dict[FuncKey, Tuple[str, ...]]:
        """For every function, a witness chain (qualname, ..., op) iff
        calling it eventually executes a call whose terminal name is in
        ``names`` — () when it cannot. Fixed-point over the resolved
        graph; memoized per name set."""
        names_t = tuple(sorted(set(names)))
        cached = self._reach_cache.get(names_t)
        if cached is not None:
            return cached
        name_set = set(names_t)
        chains: Dict[FuncKey, Tuple[str, ...]] = {}
        # Direct hits first.
        for key, unit in self.functions.items():
            for call, resolved, term in unit.call_sites:
                if term in name_set:
                    chains[key] = (term,)
                    break
        changed = True
        while changed:
            changed = False
            for key, unit in self.functions.items():
                if key in chains:
                    continue
                for call, resolved, term in unit.call_sites:
                    if resolved is not None and resolved in chains:
                        if resolved == key:
                            continue
                        chains[key] = (resolved[1],) + chains[resolved]
                        changed = True
                        break
        out = {k: chains.get(k, ()) for k in self.functions}
        self._reach_cache[names_t] = out
        return out

    def call_reach(
        self,
        unit: FunctionUnit,
        call: ast.Call,
        resolved: Optional[FuncKey],
        term: str,
        names: Set[str],
        reach_map: Dict[FuncKey, Tuple[str, ...]],
    ) -> Tuple[str, ...]:
        """Witness chain for one call site (() = does not reach)."""
        if term in names:
            return (term,)
        if resolved is not None and reach_map.get(resolved):
            return (resolved[1],) + reach_map[resolved]
        return ()


# ---------------------------------------------------------------------------
# Rank-taint dataflow


def _match_rank_source(node: ast.AST, env_keys: Set[str]) -> bool:
    """Syntactic rank sources: ``process_index()`` calls, ``.rank`` /
    ``.is_primary`` attributes, and DLPS_RANK env reads."""
    if isinstance(node, ast.Call) and terminal_name(node.func) == "process_index":
        return True
    if isinstance(node, ast.Attribute) and node.attr in ("rank", "is_primary"):
        return True
    if isinstance(node, ast.Call) and terminal_name(node.func) == "get":
        for arg in node.args[:1]:
            if isinstance(arg, ast.Constant) and arg.value in env_keys:
                return True
    if isinstance(node, ast.Subscript):
        sl = node.slice
        if isinstance(sl, ast.Constant) and sl.value in env_keys:
            return True
    return False


class TaintEngine:
    """Rank-taint propagation: local assignments, returns, call args.

    ``rank_returns`` is the fixed-point set of functions whose return
    value derives from a rank source (``is_primary()``-style). A
    function's *local* taint pass seeds from syntactic sources plus
    calls into ``rank_returns``; optionally from named parameters (the
    call-argument propagation used by the divergence rule)."""

    def __init__(self, graph: CallGraph, env_keys: Iterable[str]):
        self.graph = graph
        self.env_keys = set(env_keys)
        self.rank_returns: Set[FuncKey] = self._fixed_point_returns()

    def _fixed_point_returns(self) -> Set[FuncKey]:
        tainted: Set[FuncKey] = set()
        changed = True
        while changed:
            changed = False
            for key, unit in self.graph.functions.items():
                if key in tainted:
                    continue
                names = self.tainted_names(unit, extra_tainted_fns=tainted)
                for node in ast.walk(unit.node):
                    if isinstance(node, ast.Return) and node.value is not None:
                        if self.expr_tainted(
                            node.value, names, extra_tainted_fns=tainted
                        ):
                            tainted.add(key)
                            changed = True
                            break
        return tainted

    def expr_tainted(
        self,
        expr: ast.AST,
        tainted_names: Set[str],
        extra_tainted_fns: Optional[Set[FuncKey]] = None,
    ) -> bool:
        fns = (
            extra_tainted_fns
            if extra_tainted_fns is not None
            else self.rank_returns
        )
        for node in ast.walk(expr):
            if _match_rank_source(node, self.env_keys):
                return True
            if isinstance(node, ast.Name) and node.id in tainted_names:
                return True
            if isinstance(node, ast.Call):
                term = terminal_name(node.func)
                for key in fns:
                    if key[1] == term or key[1].endswith("." + term):
                        return True
        return False

    def comp_rank_filters(
        self,
        unit: FunctionUnit,
        tainted_names: Set[str],
        extra_tainted_fns: Optional[Set[FuncKey]] = None,
    ) -> List[Tuple[ast.AST, ast.AST]]:
        """Comprehensions whose generator filters test a rank-derived
        value — ``[f(x) for x in xs if rank == 0]`` runs its element a
        different number of times per rank, the same divergence an
        ``if`` statement would carry, but invisible to any walker that
        only looks at ``ast.If``/``ast.While`` tests. Returns
        ``(comprehension, tainted_filter)`` pairs."""
        out: List[Tuple[ast.AST, ast.AST]] = []
        for node in ast.walk(unit.node):
            if not isinstance(
                node,
                (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp),
            ):
                continue
            for gen in node.generators:
                hit = None
                for cond in gen.ifs:
                    if self.expr_tainted(
                        cond, tainted_names, extra_tainted_fns
                    ):
                        hit = cond
                        break
                if hit is not None:
                    out.append((node, hit))
                    break
        return out

    def tainted_names(
        self,
        unit: FunctionUnit,
        seed_params: Iterable[str] = (),
        extra_tainted_fns: Optional[Set[FuncKey]] = None,
    ) -> Set[str]:
        """One forward pass over the unit's statements (in source order)
        collecting local names bound to rank-derived values."""
        names: Set[str] = set(seed_params)
        for node in ast.walk(unit.node):
            value = None
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AugAssign):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.NamedExpr):
                value, targets = node.value, [node.target]
            if value is None:
                continue
            if self.expr_tainted(value, names, extra_tainted_fns):
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            names.add(sub.id)
        return names


# ---------------------------------------------------------------------------
# Lock model


def _is_lock_ctor(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and terminal_name(node.func) in (
        "Lock",
        "RLock",
    )


class LockModel:
    """Lock inventory + acquisition summaries + the global order graph.

    Lock identity is ``ClassName.attr`` for instance locks (``self._x =
    threading.Lock()`` in ``__init__``; Conditions over a lock alias to
    it) and ``<pkg_path>:NAME`` for module-level locks. The identity is
    per *class*, not per instance — exactly the granularity a lock-order
    contract is written at.
    """

    def __init__(self, graph: CallGraph):
        self.graph = graph
        # (pkg_path, ClassName) -> {attr -> canonical lock name}
        self.class_locks: Dict[Tuple[str, str], Dict[str, str]] = {}
        # pkg_path -> {name -> canonical}
        self.module_locks: Dict[str, Dict[str, str]] = {}
        self._acquires: Dict[FuncKey, Set[str]] = {}
        self._edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._collect_locks()
        self._summarize()

    def _collect_locks(self) -> None:
        for (pkg, cls_name), cls in self.graph.classes.items():
            init = next(
                (
                    n
                    for n in cls.body
                    if isinstance(n, ast.FunctionDef) and n.name == "__init__"
                ),
                None,
            )
            locks: Dict[str, str] = {}
            if init is not None:
                aliases: Dict[str, str] = {}
                for node in ast.walk(init):
                    if not isinstance(node, ast.Assign):
                        continue
                    attrs = [
                        a for a in (_self_attr(t) for t in node.targets) if a
                    ]
                    if not attrs:
                        continue
                    if _is_lock_ctor(node.value):
                        for a in attrs:
                            locks[a] = f"{cls_name}.{a}"
                    elif (
                        isinstance(node.value, ast.Call)
                        and terminal_name(node.value.func) == "Condition"
                        and node.value.args
                    ):
                        base = _self_attr(node.value.args[0])
                        if base:
                            for a in attrs:
                                aliases[a] = base
                for a, base in aliases.items():
                    if base in locks:
                        locks[a] = locks[base]
            self.class_locks[(pkg, cls_name)] = locks
        for pkg_path, ctx in self.graph.files.items():
            mod: Dict[str, str] = {}
            for node in ctx.tree.body:
                if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            mod[t.id] = f"{pkg_path}:{t.id}"
            self.module_locks[pkg_path] = mod

    def lock_of_with_item(self, unit: FunctionUnit, expr: ast.AST) -> Optional[str]:
        """Canonical lock name for a ``with <expr>`` item, or None when
        the item is not a known lock (file handles, meshes, ...)."""
        attr = _self_attr(expr)
        if attr and unit.class_name:
            locks = self.class_locks.get((unit.pkg_path, unit.class_name), {})
            return locks.get(attr)
        if isinstance(expr, ast.Name):
            return self.module_locks.get(unit.pkg_path, {}).get(expr.id)
        # self._obj._lock style: resolve the attr type's lock
        if (
            isinstance(expr, ast.Attribute)
            and _self_attr(expr.value)
            and unit.class_name
        ):
            owner = self.graph.attr_types.get(
                (unit.pkg_path, unit.class_name), {}
            ).get(_self_attr(expr.value))
            if owner:
                return self.class_locks.get(owner, {}).get(expr.attr)
        return None

    def _direct_acquires(self, unit: FunctionUnit) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(unit.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lk = self.lock_of_with_item(unit, item.context_expr)
                    if lk:
                        out.add(lk)
        return out

    def _summarize(self) -> None:
        # Transitive acquired-locks per function (fixed point).
        acquires = {
            key: self._direct_acquires(unit)
            for key, unit in self.graph.functions.items()
        }
        changed = True
        while changed:
            changed = False
            for key, unit in self.graph.functions.items():
                for call, resolved, term in unit.call_sites:
                    if resolved is None or resolved == key:
                        continue
                    extra = acquires.get(resolved, set()) - acquires[key]
                    if extra:
                        acquires[key] |= extra
                        changed = True
        self._acquires = acquires

    def acquired_by(self, key: FuncKey) -> Set[str]:
        return self._acquires.get(key, set())

    def order_edges(self) -> Dict[Tuple[str, str], Tuple[str, int]]:
        """held-lock -> acquired-lock edges across the whole file set,
        each with one witness location (pkg_path, lineno). Includes
        edges through calls: holding A and calling a function that
        (transitively) takes B adds A -> B."""
        if self._edges:
            return self._edges
        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

        def record(a: str, b: str, pkg: str, line: int) -> None:
            if a != b and (a, b) not in edges:
                edges[(a, b)] = (pkg, line)

        for key, unit in self.graph.functions.items():
            # map each node to the set of locks held at it (lexical)
            for node in ast.walk(unit.node):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    inner = [
                        self.lock_of_with_item(unit, it.context_expr)
                        for it in node.items
                    ]
                    inner = [lk for lk in inner if lk]
                    if not inner:
                        continue
                    held = self._held_at(unit, node)
                    for a in held:
                        for b in inner:
                            record(a, b, unit.pkg_path, node.lineno)
                elif isinstance(node, ast.Call):
                    held = self._held_at(unit, node)
                    if not held:
                        continue
                    resolved = None
                    for c, r, t in unit.call_sites:
                        if c is node:
                            resolved = r
                            break
                    if resolved is None:
                        continue
                    for b in self.acquired_by(resolved):
                        for a in held:
                            record(a, b, unit.pkg_path, node.lineno)
        self._edges = edges
        return edges

    def _held_at(self, unit: FunctionUnit, node: ast.AST) -> Set[str]:
        """Locks lexically held at ``node`` inside ``unit`` (enclosing
        with-items, excluding the node itself), plus ``# holds:``."""
        held: Set[str] = set()
        ctx = unit.ctx
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                # only count the with if `node` is inside its BODY (not
                # one of its own context expressions)
                in_body = any(
                    self._node_within(node, stmt) for stmt in anc.body
                )
                if not in_body:
                    continue
                for item in anc.items:
                    lk = self.lock_of_with_item(unit, item.context_expr)
                    if lk:
                        held.add(lk)
            elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                held |= self._holds_annotation(unit, anc)
                break
        else:
            held |= self._holds_annotation(unit, unit.node)
        return held

    def _node_within(self, node: ast.AST, root: ast.AST) -> bool:
        if node is root:
            return True
        lo = getattr(root, "lineno", None)
        hi = getattr(root, "end_lineno", None)
        nl = getattr(node, "lineno", None)
        if lo is None or hi is None or nl is None:
            return False
        return lo <= nl <= hi

    def _holds_annotation(self, unit: FunctionUnit, fn) -> Set[str]:
        import re

        held: Set[str] = set()
        ctx = unit.ctx
        body_line = fn.body[0].lineno if fn.body else fn.lineno
        for line in range(fn.lineno, body_line):
            m = re.search(
                r"#\s*holds:\s*([A-Za-z_][A-Za-z0-9_]*)", ctx.line(line)
            )
            if m and unit.class_name:
                locks = self.class_locks.get(
                    (unit.pkg_path, unit.class_name), {}
                )
                lk = locks.get(m.group(1))
                if lk:
                    held.add(lk)
        return held

    def find_cycle(self) -> List[Tuple[str, str, str, int]]:
        """One lock-order cycle as [(lock_a, lock_b, pkg_path, line),
        ...] edges, or [] when the graph is acyclic."""
        edges = self.order_edges()
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[str, int] = {}
        path: List[str] = []

        def dfs(n: str) -> List[str]:
            color[n] = GRAY
            path.append(n)
            for m in sorted(graph.get(n, ())):
                c = color.get(m, WHITE)
                if c == GRAY:
                    return path[path.index(m):] + [m]
                if c == WHITE:
                    found = dfs(m)
                    if found:
                        return found
            path.pop()
            color[n] = BLACK
            return []

        for n in sorted(graph):
            if color.get(n, WHITE) == WHITE:
                cyc = dfs(n)
                if cyc:
                    out = []
                    for a, b in zip(cyc, cyc[1:]):
                        pkg, line = edges[(a, b)]
                        out.append((a, b, pkg, line))
                    return out
        return []
