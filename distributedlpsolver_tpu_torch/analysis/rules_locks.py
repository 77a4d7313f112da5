"""Lock-discipline rules: the ``# guarded-by:`` annotation convention,
plus the interprocedural deadlock families (graftcheck v2).

The serve dispatcher is a three-thread pipeline (scheduler → pack →
solve) sharing mutable state with submitters and introspection calls;
the metrics registry, tracer, and JSONL logger are written from all of
them. The repo's convention makes each shared attribute's lock explicit
at its birthplace:

    def __init__(self):
        self._results = []      # guarded-by: _lock
        self._wake = threading.Condition(self._lock)

and this rule verifies, lexically, that every later read or write of an
annotated attribute happens inside ``with self.<lock>`` (or a
``threading.Condition`` the checker saw constructed over that lock —
entering the condition acquires it). Methods whose *callers* hold the
lock declare it on the def line:

    def _is_idle(self):  # holds: _lock

``__init__`` is exempt: construction happens-before publication.

The ``guarded-by`` check is lexical by design. Since graftcheck v2 it
pairs with two *interprocedural* families built on the package call
graph (analysis/callgraph.py):

- ``lock-order`` — the static half of the dynamic lockorder recorder:
  every ``with self._a: ... self._m() ... with self._b`` path
  contributes a held→acquired edge (including edges through resolved
  calls, cross-class via inferred attribute types), and any cycle in
  the global edge graph is an ordering inversion that CAN deadlock,
  whether or not a run has hit it yet. Tests cross-check this graph
  against the edges the dynamic recorder observes on a live 3-thread
  SolveService drain.
- ``blocking-under-lock`` — a collective, HTTP round-trip, fsync,
  subprocess, sleep, or Future.result reached (transitively) while a
  known lock is held. A collective blocks until every RANK arrives;
  holding a lock across one turns a slow peer into a whole-process
  stall, and two such locks into a distributed deadlock. Deliberate
  seams (the slice dispatch-order lock, the WAL append) are sanctioned
  in :data:`analysis.config.BLOCKING_SANCTIONED`.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from distributedlpsolver_tpu_torch.analysis import config
from distributedlpsolver_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    ProjectContext,
    project_rule,
    rule,
)

_GUARDED = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")
_HOLDS = re.compile(r"#\s*holds:\s*([A-Za-z_][A-Za-z0-9_]*)")


def _self_attr(node: ast.AST) -> str:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return ""


def _collect_annotations(ctx: FileContext, init: ast.FunctionDef):
    """(guards, aliases) from a class's __init__: guards maps attr ->
    lock attr; aliases maps condition attr -> underlying lock attr
    (``self.C = threading.Condition(self.L)``)."""
    guards: Dict[str, str] = {}
    aliases: Dict[str, str] = {}
    for node in ast.walk(init):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        attrs = [a for a in (_self_attr(t) for t in targets) if a]
        if not attrs:
            continue
        m = _GUARDED.search(ctx.line(node.lineno))
        if m:
            for a in attrs:
                guards[a] = m.group(1)
        value = node.value
        if (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr == "Condition"
            and value.args
        ):
            base = _self_attr(value.args[0])
            if base:
                for a in attrs:
                    aliases[a] = base
    return guards, aliases


def _held_locks(ctx: FileContext, node: ast.AST, aliases: Dict[str, str]) -> Set[str]:
    """Lock attrs lexically held at ``node``: enclosing ``with
    self.<lock>`` items (conditions resolved through aliases) plus any
    ``# holds:`` annotation on an enclosing def."""
    held: Set[str] = set()
    chain = [node] + list(ctx.ancestors(node))
    for anc in chain:
        if isinstance(anc, ast.With):
            for item in anc.items:
                a = _self_attr(item.context_expr)
                if a:
                    held.add(aliases.get(a, a))
        elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for line in range(anc.lineno, anc.body[0].lineno):
                m = _HOLDS.search(ctx.line(line))
                if m:
                    lock = m.group(1)
                    held.add(aliases.get(lock, lock))
    return held


@rule(
    "guarded-by",
    "annotated shared attributes accessed only under their lock",
)
def check_guarded_by(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
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
        guards, aliases = _collect_annotations(ctx, init)
        if not guards:
            continue
        for method in cls.body:
            if (
                not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef))
                or method.name == "__init__"
            ):
                continue
            for node in ast.walk(method):
                attr = _self_attr(node)
                if attr not in guards:
                    continue
                lock = guards[attr]
                if lock in _held_locks(ctx, node, aliases):
                    continue
                kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
                out.append(
                    Finding(
                        rule="guarded-by",
                        path=ctx.path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"{kind} of {cls.name}.{attr} (guarded-by "
                            f"{lock}) outside `with self.{lock}` in "
                            f"{method.name}()"
                        ),
                    )
                )
    return out


# ---------------------------------------------------------------------------
# Interprocedural deadlock families (graftcheck v2)


def _blocking_sanctioned(key: Tuple[str, str]) -> bool:
    pkg, qual = key
    if (pkg, qual) in config.BLOCKING_SANCTIONED:
        return True
    head = qual.split(".", 1)[0]
    return (pkg, head) in config.BLOCKING_SANCTIONED


@project_rule(
    "lock-order",
    "the cross-method lock acquisition graph must stay acyclic",
)
def check_lock_order(project: ProjectContext) -> List[Finding]:
    cycle = project.locks.find_cycle()
    if not cycle:
        return []
    path_str = " -> ".join([a for a, _b, _p, _l in cycle] + [cycle[0][0]])
    sites = ", ".join(f"{a}->{b} at {p}:{l}" for a, b, p, l in cycle)
    pkg = cycle[0][2]
    ctx = project.by_path.get(pkg)
    return [
        Finding(
            rule="lock-order",
            path=ctx.path if ctx is not None else pkg,
            line=cycle[0][3],
            col=0,
            message=(
                f"lock-order cycle {path_str} ({sites}) — inconsistent "
                "acquisition order can deadlock; pick one global order "
                "(the dynamic lockorder recorder asserts the same "
                "invariant at runtime)"
            ),
        )
    ]


@project_rule(
    "blocking-under-lock",
    "no collective/IO/subprocess/sleep while a lock is held",
)
def check_blocking_under_lock(project: ProjectContext) -> List[Finding]:
    out: List[Finding] = []
    graph = project.graph
    locks = project.locks
    blocking = set(config.BLOCKING_CALLS)

    # Transitive blocking summaries, with sanctioned functions
    # contributing nothing (their blocking is their documented design;
    # callers do not inherit it).
    chains: Dict[Tuple[str, str], Tuple[str, ...]] = {}
    for key, unit in graph.functions.items():
        if _blocking_sanctioned(key):
            continue
        for call, resolved, term in unit.call_sites:
            if term in blocking and not (
                resolved is not None and _blocking_sanctioned(resolved)
            ):
                chains[key] = (term,)
                break
    changed = True
    while changed:
        changed = False
        for key, unit in graph.functions.items():
            if key in chains or _blocking_sanctioned(key):
                continue
            for call, resolved, term in unit.call_sites:
                if (
                    resolved is not None
                    and resolved != key
                    and resolved in chains
                ):
                    chains[key] = (resolved[1],) + chains[resolved]
                    changed = True
                    break

    for key, unit in graph.functions.items():
        if "<locals>" in key[1] or _blocking_sanctioned(key):
            continue
        for call, resolved, term in unit.call_sites:
            chain: Tuple[str, ...] = ()
            if term in blocking and not (
                resolved is not None and _blocking_sanctioned(resolved)
            ):
                chain = (term,)
            elif resolved is not None and chains.get(resolved):
                chain = (resolved[1],) + chains[resolved]
            if not chain:
                continue
            held = locks._held_at(unit, call)
            if not held:
                continue
            out.append(
                Finding(
                    rule="blocking-under-lock",
                    path=unit.ctx.path,
                    line=call.lineno,
                    col=call.col_offset,
                    message=(
                        f"blocking op `{' -> '.join(chain)}` while "
                        f"holding {', '.join(sorted(held))} in "
                        f"{key[1]}() — move the wait outside the lock "
                        "or sanction the seam in analysis/config."
                        "BLOCKING_SANCTIONED"
                    ),
                )
            )
    return out
