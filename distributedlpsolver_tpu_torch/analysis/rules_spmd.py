"""SPMD-discipline rules — the multi-host contract, statically gated.

The multi-host runtime makes the solver a multi-process SPMD system: every rank of a
world must execute a bit-identical program sequence, because the
collectives inside the compiled bucket programs block until EVERY rank
arrives and the jit caches must agree world-wide (distributed/world.py,
distributed/slice.py module docs). Three bug classes broke that
contract during landing, all statically detectable once the checker
can see across calls (analysis/callgraph.py):

- ``spmd-divergent-collective`` — a rank-derived value (``world.rank``,
  ``jax.process_index()``, ``.is_primary``, ``DLPS_RANK``) guarding a
  branch or early return on a path that reaches a collective or a
  bucket-program dispatch. One rank takes the branch, its peers do
  not, and the peers hang inside XLA forever. Taint propagates through
  assignments, through returns (an ``is_primary()``-style predicate
  taints its callers), and through call arguments (passing a rank fact
  into a function that branches a collective on its parameter). The
  deliberate rank-0-publish / follower-execute seams are sanctioned in
  :data:`analysis.config.SPMD_SANCTIONED`.
- ``spmd-unordered-dispatch`` — iteration order that differs across
  ranks feeding world-visible state: an unsorted ``os.listdir`` /
  ``glob`` scan (filesystem order is arbitrary), or a loop over a
  ``set`` (iteration order depends on the per-process hash seed)
  whose body publishes to a dispatch journal, JSONL stream, registry,
  or jit warm-up. Scans consumed order-insensitively (``sorted``,
  ``set``, ``len``, ``sum``...) are exempt.
- ``spmd-uncommitted-input`` — a bare ``jax.device_put(x)`` or
  ``jnp.asarray(x)`` result (committed to the *default device*)
  flowing into a ``mesh=``-taking program. On a single process that
  works by accident; on a multi-process mesh the program's sharding
  contract is broken at dispatch. Host data enters global programs
  only through the committed placers (``put_global`` /
  ``place_bucket`` / sharded ``device_put``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from distributedlpsolver_tpu_torch.analysis import config
from distributedlpsolver_tpu_torch.analysis.callgraph import terminal_name
from distributedlpsolver_tpu_torch.analysis.core import (
    Finding,
    ProjectContext,
    project_rule,
)

_SCAN_CALLS = {"listdir", "scandir", "glob", "iglob", "iterdir", "rglob"}


def _is_sanctioned(key: Tuple[str, str], table) -> bool:
    pkg, qual = key
    if (pkg, qual) in table:
        return True
    head = qual.split(".", 1)[0]
    return (pkg, head) in table


def _top_level_units(project: ProjectContext):
    """Units whose bodies are not already covered by an enclosing unit
    (nested ``<locals>`` defs are walked as part of their outer frame)."""
    for key, unit in project.graph.functions.items():
        if "<locals>" not in key[1]:
            yield key, unit


def _chain_str(chain) -> str:
    return " -> ".join(chain)


# ---------------------------------------------------------------------------
# spmd-divergent-collective


def _branch_terminates(body: List[ast.stmt]) -> bool:
    if not body:
        return False
    last = body[-1]
    return isinstance(last, (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _calls_in(node: ast.AST, site_map) -> list:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and id(sub) in site_map:
            out.append((sub,) + site_map[id(sub)])
    return out


@project_rule(
    "spmd-divergent-collective",
    "rank-derived branches must not guard paths into collectives",
)
def check_divergent_collective(project: ProjectContext) -> List[Finding]:
    out: List[Finding] = []
    graph = project.graph
    taint = project.taint
    reach = graph.reach(config.COLLECTIVE_CALLS)
    names_set = set(config.COLLECTIVE_CALLS)

    # Param sensitivity: functions that branch a collective path on one
    # of their own parameters — a caller passing a rank fact there
    # diverges just as hard as an inline branch.
    param_divergent: Dict[Tuple[str, str], Set[str]] = {}
    for key, unit in _top_level_units(project):
        # Only functions that can reach a collective at all.
        if not reach.get(key) and not any(
            t in names_set for _, _, t in unit.call_sites
        ):
            continue
        args = unit.node.args
        params = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
        sensitive: Set[str] = set()
        for p in params:
            if p == "self":
                continue
            seeded = taint.tainted_names(unit, seed_params=[p])
            for node in ast.walk(unit.node):
                if isinstance(node, (ast.If, ast.While)) and taint.expr_tainted(
                    node.test, seeded
                ):
                    sensitive.add(p)
                    break
        if sensitive:
            param_divergent[key] = sensitive

    for key, unit in _top_level_units(project):
        if _is_sanctioned(key, config.SPMD_SANCTIONED):
            continue
        site_map = {
            id(c): (r, t) for c, r, t in unit.call_sites
        }
        local_taint = taint.tainted_names(unit)

        def call_chain(call, resolved, term):
            return graph.call_reach(
                unit, call, resolved, term, names_set, reach
            )

        # Branches guarded by a rank-derived test.
        for node in ast.walk(unit.node):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            if not taint.expr_tainted(node.test, local_taint):
                continue
            guarded = list(node.body) + list(getattr(node, "orelse", []))
            hit = None
            for stmt in guarded:
                for call, resolved, term in _calls_in(stmt, site_map):
                    chain = call_chain(call, resolved, term)
                    if chain:
                        hit = chain
                        break
                if hit:
                    break
            if hit is None and _branch_terminates(node.body):
                # Early exit: the divergence is everything AFTER the
                # branch — one rank leaves, the others go on to the
                # collective.
                body_lo = node.body[0].lineno
                body_hi = node.body[-1].end_lineno or body_lo
                for call, resolved, term in _calls_in(unit.node, site_map):
                    if body_lo <= call.lineno <= body_hi:
                        continue
                    chain = call_chain(call, resolved, term)
                    if chain:
                        hit = chain
                        break
            if hit:
                out.append(
                    Finding(
                        rule="spmd-divergent-collective",
                        path=unit.ctx.path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"rank-derived branch in {key[1]}() guards a "
                            f"path reaching collective "
                            f"`{_chain_str(hit)}` — peers that skip the "
                            "branch hang in the collective (sanction "
                            "deliberate seams in analysis/config."
                            "SPMD_SANCTIONED)"
                        ),
                    )
                )

        # Comprehension filters guarded by a rank-derived test: the
        # element expression runs a different number of times per rank,
        # so a collective inside it diverges exactly like an ``if``
        # branch — but lives in a generator's ``ifs``, which the
        # statement walk above never visits.
        for comp, _cond in taint.comp_rank_filters(unit, local_taint):
            bodies = (
                [comp.key, comp.value]
                if isinstance(comp, ast.DictComp)
                else [comp.elt]
            )
            hit = None
            for body in bodies:
                for call, resolved, term in _calls_in(body, site_map):
                    chain = call_chain(call, resolved, term)
                    if chain:
                        hit = chain
                        break
                if hit:
                    break
            if hit:
                out.append(
                    Finding(
                        rule="spmd-divergent-collective",
                        path=unit.ctx.path,
                        line=comp.lineno,
                        col=comp.col_offset,
                        message=(
                            f"rank-derived comprehension filter in "
                            f"{key[1]}() gates collective "
                            f"`{_chain_str(hit)}` — ranks that filter "
                            "out the element skip the collective their "
                            "peers enter (sanction deliberate seams in "
                            "analysis/config.SPMD_SANCTIONED)"
                        ),
                    )
                )

        # Rank facts passed into param-sensitive callees.
        for call, resolved, term in unit.call_sites:
            if resolved is None or resolved not in param_divergent:
                continue
            callee = graph.functions[resolved]
            cargs = callee.node.args
            pos_params = [
                a.arg for a in cargs.posonlyargs + cargs.args
            ]
            if pos_params and pos_params[0] == "self":
                pos_params = pos_params[1:]
            passed: List[Tuple[str, ast.AST]] = []
            for i, a in enumerate(call.args):
                if i < len(pos_params):
                    passed.append((pos_params[i], a))
            for kw in call.keywords:
                if kw.arg:
                    passed.append((kw.arg, kw.value))
            for pname, expr in passed:
                if pname in param_divergent[resolved] and taint.expr_tainted(
                    expr, local_taint
                ):
                    out.append(
                        Finding(
                            rule="spmd-divergent-collective",
                            path=unit.ctx.path,
                            line=call.lineno,
                            col=call.col_offset,
                            message=(
                                f"rank-derived value passed as "
                                f"`{pname}` to {resolved[1]}(), which "
                                "branches a collective path on it — "
                                "the divergence just moved one call "
                                "down"
                            ),
                        )
                    )
    return out


# ---------------------------------------------------------------------------
# spmd-unordered-dispatch


def _order_safe(ctx, node: ast.Call) -> bool:
    """True when the scan's result is consumed order-insensitively: the
    call sits (transitively) inside a ``sorted(...)`` / ``set`` / ``len``
    / ``sum`` / ... consumer within the same expression."""
    cur = node
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.Call):
            fn = anc.func
            if (
                isinstance(fn, ast.Name)
                and fn.id in config.ORDER_SAFE_CONSUMERS
                and cur is not fn
            ):
                return True
        elif isinstance(anc, ast.stmt):
            return False
        cur = anc
    return False


def _set_bound_names(unit) -> Set[str]:
    """Local names bound to set values (literal, comp, or set()/
    frozenset() call) anywhere in the unit."""
    out: Set[str] = set()
    for node in ast.walk(unit.node):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        is_set = isinstance(v, (ast.Set, ast.SetComp)) or (
            isinstance(v, ast.Call)
            and isinstance(v.func, ast.Name)
            and v.func.id in ("set", "frozenset")
        )
        if not is_set:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


@project_rule(
    "spmd-unordered-dispatch",
    "world-visible iteration must not follow filesystem/set order",
)
def check_unordered_dispatch(project: ProjectContext) -> List[Finding]:
    out: List[Finding] = []
    graph = project.graph
    sink_names = set(config.ORDER_SINKS)
    reach = graph.reach(config.ORDER_SINKS)

    for key, unit in _top_level_units(project):
        site_map = {id(c): (r, t) for c, r, t in unit.call_sites}

        # (a) unsorted directory scans, package-wide: filesystem order
        # is arbitrary and differs across hosts.
        for node in ast.walk(unit.node):
            if (
                isinstance(node, ast.Call)
                and terminal_name(node.func) in _SCAN_CALLS
                and not _order_safe(unit.ctx, node)
            ):
                out.append(
                    Finding(
                        rule="spmd-unordered-dispatch",
                        path=unit.ctx.path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"unsorted `{terminal_name(node.func)}` scan "
                            f"in {key[1]}() — filesystem order is "
                            "arbitrary; wrap in sorted() (or an order-"
                            "insensitive consumer) before anything "
                            "world-visible iterates it"
                        ),
                    )
                )

        # (b) loops over set values whose body reaches an order sink.
        set_names = _set_bound_names(unit)
        for node in ast.walk(unit.node):
            if not isinstance(node, ast.For):
                continue
            it = node.iter
            over_set = (
                isinstance(it, (ast.Set, ast.SetComp))
                or (
                    isinstance(it, ast.Call)
                    and isinstance(it.func, ast.Name)
                    and it.func.id in ("set", "frozenset")
                )
                or (isinstance(it, ast.Name) and it.id in set_names)
            )
            if not over_set:
                continue
            hit = None
            for stmt in node.body:
                for call, resolved, term in _calls_in(stmt, site_map):
                    chain = graph.call_reach(
                        unit, call, resolved, term, sink_names, reach
                    )
                    if chain:
                        hit = chain
                        break
                if hit:
                    break
            if hit:
                out.append(
                    Finding(
                        rule="spmd-unordered-dispatch",
                        path=unit.ctx.path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"loop over a set in {key[1]}() publishes "
                            f"via `{_chain_str(hit)}` — set iteration "
                            "order depends on the per-process hash "
                            "seed; iterate a sorted() view"
                        ),
                    )
                )
    return out


# ---------------------------------------------------------------------------
# spmd-uncommitted-input


def _is_bare_put(node: ast.AST) -> bool:
    """``jax.device_put(x)`` (no sharding) or ``jnp.asarray(x)`` — a
    default-device commitment."""
    if not isinstance(node, ast.Call):
        return False
    term = terminal_name(node.func)
    if term == "device_put":
        return len(node.args) < 2 and not node.keywords
    if term == "asarray":
        return (
            isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "jnp"
        )
    return False


def _is_committed(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    term = terminal_name(node.func)
    if term in config.COMMITTED_PLACERS:
        return True
    return term == "device_put" and (len(node.args) >= 2 or bool(node.keywords))


def _mesh_sink(node: ast.Call) -> bool:
    term = terminal_name(node.func)
    for kw in node.keywords:
        if kw.arg == "mesh" and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None
        ):
            return True
    return term == "execute_dispatch" and bool(node.args)


def _mesh_none_guarded(ctx, node: ast.AST) -> bool:
    """True when ``node`` sits under an ``if`` whose test compares a
    ``mesh``-named value against None — the single-device fallback
    branch, where a bare default-device put is exactly right."""
    for anc in ctx.ancestors(node):
        if not isinstance(anc, ast.If):
            continue
        has_mesh = any(
            (isinstance(s, ast.Name) and "mesh" in s.id)
            or (isinstance(s, ast.Attribute) and "mesh" in s.attr)
            for s in ast.walk(anc.test)
        )
        has_none = any(
            isinstance(s, ast.Constant) and s.value is None
            for s in ast.walk(anc.test)
        )
        if has_mesh and has_none:
            return True
    return False


@project_rule(
    "spmd-uncommitted-input",
    "mesh programs take put_global/place_bucket-committed arrays only",
)
def check_uncommitted_input(project: ProjectContext) -> List[Finding]:
    out: List[Finding] = []
    for key, unit in _top_level_units(project):
        uncommitted: Set[str] = set()
        for node in ast.walk(unit.node):
            if not isinstance(node, ast.Assign):
                continue
            if _is_bare_put(node.value) and not _mesh_none_guarded(
                unit.ctx, node
            ):
                for t in node.targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            uncommitted.add(sub.id)
            elif _is_committed(node.value):
                for t in node.targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            uncommitted.discard(sub.id)
        for node in ast.walk(unit.node):
            if not (isinstance(node, ast.Call) and _mesh_sink(node)):
                continue
            exprs = list(node.args) + [
                kw.value for kw in node.keywords if kw.arg != "mesh"
            ]
            for expr in exprs:
                bad: Optional[str] = None
                if _is_bare_put(expr):
                    bad = terminal_name(expr.func)
                else:
                    for sub in ast.walk(expr):
                        if isinstance(sub, ast.Name) and sub.id in uncommitted:
                            bad = sub.id
                            break
                        if isinstance(sub, ast.Call):
                            break  # nested call results judged at their own site
                if bad:
                    out.append(
                        Finding(
                            rule="spmd-uncommitted-input",
                            path=unit.ctx.path,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"`{bad}` enters a mesh program in "
                                f"{key[1]}() without a committed "
                                "placement — default-device arrays "
                                "break the multi-process sharding "
                                "contract; route through put_global/"
                                "place_bucket (or device_put with an "
                                "explicit sharding)"
                            ),
                        )
                    )
                    break
    return out
