"""jit/recompile-hygiene rules.

The serving and solver layers stake their throughput on compiled-program
reuse (the zero-warm-recompile invariant): every device program
is built once per (shape, dtype, mesh) key and dispatched verbatim
forever after. The failure modes that break this are all host-side
Python and all statically visible:

- ``jit-nonhoisted`` — a ``jax.jit`` (or ``functools.partial(jax.jit,
  ...)``) *created inside a function body*. Each call builds a fresh
  wrapper with an empty trace cache, so the program recompiles (or at
  best re-traces against the XLA cache) on every invocation — the exact
  warm-recompile class the bucket cache exists to prevent. Hoist the
  wrapper to module level.
- ``jit-scalar-default`` — a jitted function parameter with a Python
  scalar default that is not declared static. A scalar default marks a
  host config knob; traced, it becomes a weak-typed 0-d array whose
  promotions differ from the array path and whose use in Python control
  flow fails only at trace time. Knobs are static by repo convention;
  values travel as arrays.
- ``jit-donate`` — the programs catalogued donate-eligible in
  analysis/config.DONATE_EXPECTED (per-call buffers dead after the
  call) must pass ``donate_argnums`` so the device reuses their buffers
  in place instead of doubling peak memory.
- ``host-sync`` — ``float()`` / ``np.asarray`` / ``.item()`` /
  ``block_until_ready`` inside the serve pack/solve thread bodies or
  the IPM driver loop (config.HOT_SCOPES). Each one is a device
  round-trip that serializes the pipeline; the sanctioned sync points
  carry explanatory suppression comments.
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from distributedlpsolver_tpu_torch.analysis import config
from distributedlpsolver_tpu_torch.analysis.core import FileContext, Finding, rule


def _is_jax_jit(node: ast.AST) -> bool:
    """``jax.jit`` attribute reference."""
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "jit"
        and isinstance(node.value, ast.Name)
        and node.value.id == "jax"
    )


def _is_partial_jit(call: ast.Call) -> bool:
    """``functools.partial(jax.jit, ...)`` / ``partial(jax.jit, ...)``."""
    fn = call.func
    named_partial = (
        isinstance(fn, ast.Attribute) and fn.attr == "partial"
    ) or (isinstance(fn, ast.Name) and fn.id == "partial")
    return named_partial and bool(call.args) and _is_jax_jit(call.args[0])


def _jit_wrappers(ctx: FileContext) -> Iterator[ast.Call]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and (
            _is_jax_jit(node.func) or _is_partial_jit(node)
        ):
            yield node


def _decorating(ctx: FileContext, node: ast.AST, fn: ast.FunctionDef) -> bool:
    """True if ``node`` lives inside one of ``fn``'s decorators (a
    decorator expression parents to the FunctionDef it decorates, but it
    executes in the *enclosing* scope)."""
    for dec in fn.decorator_list:
        for sub in ast.walk(dec):
            if sub is node:
                return True
    return False


def _executing_scope(ctx: FileContext, node: ast.AST):
    """The function whose *execution* runs ``node`` — skips FunctionDefs
    entered via their decorator list."""
    fn = ctx.enclosing_function(node)
    while fn is not None and _decorating(ctx, node, fn):
        fn = ctx.enclosing_function(fn)
    return fn


@rule(
    "jit-nonhoisted",
    "jax.jit wrappers must be created at module level, not per call",
)
def check_nonhoisted(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []

    def flag(node: ast.AST, scope: ast.FunctionDef) -> None:
        out.append(
            Finding(
                rule="jit-nonhoisted",
                path=ctx.path,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"jax.jit created inside {scope.name}(): the "
                    "wrapper's trace cache dies with each call — hoist "
                    "to module level (warm-recompile hazard)"
                ),
            )
        )

    for call in _jit_wrappers(ctx):
        fn = _executing_scope(ctx, call)
        if fn is not None:
            flag(call, fn)
    # Bare `@jax.jit` decorators on nested defs are not Call nodes but
    # run jax.jit once per enclosing call all the same.
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        outer = ctx.enclosing_function(node)
        if outer is None:
            continue
        for dec in node.decorator_list:
            if _is_jax_jit(dec):
                flag(dec, outer)
    return out


def _static_names(call: ast.Call) -> set:
    """Names/indices declared static in a jit(...) or partial(jax.jit,...)."""
    names: set = set()
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            for el in ast.walk(kw.value):
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    names.add(el.value)
        elif kw.arg == "static_argnums":
            for el in ast.walk(kw.value):
                if isinstance(el, ast.Constant) and isinstance(el.value, int):
                    names.add(el.value)
    return names


@rule(
    "jit-scalar-default",
    "jitted params with Python scalar defaults must be declared static",
)
def check_scalar_default(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        statics: set = set()
        jitted = False
        for dec in node.decorator_list:
            if _is_jax_jit(dec):
                jitted = True
            elif isinstance(dec, ast.Call) and (
                _is_jax_jit(dec.func) or _is_partial_jit(dec)
            ):
                jitted = True
                statics |= _static_names(dec)
        if not jitted:
            continue
        args = node.args.args
        defaults = node.args.defaults
        offset = len(args) - len(defaults)
        for i, default in enumerate(defaults):
            arg = args[offset + i]
            pos = offset + i
            if not (
                isinstance(default, ast.Constant)
                and isinstance(default.value, (int, float, bool))
                and not isinstance(default.value, type(None))
            ):
                continue
            if arg.arg in statics or pos in statics:
                continue
            out.append(
                Finding(
                    rule="jit-scalar-default",
                    path=ctx.path,
                    line=arg.lineno,
                    col=arg.col_offset,
                    message=(
                        f"param {arg.arg!r} of jitted {node.name}() has a "
                        f"Python scalar default ({default.value!r}) but is "
                        "not in static_argnames — a traced weak-typed "
                        "scalar knob (recompile/promotion hazard)"
                    ),
                )
            )
    return out


@rule(
    "jit-donate",
    "catalogued donate-eligible programs must pass donate_argnums",
)
def check_donate(ctx: FileContext) -> List[Finding]:
    expected = {
        fn_name: desc
        for (pkg, fn_name), desc in config.DONATE_EXPECTED.items()
        if pkg == ctx.pkg_path
    }
    if not expected:
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.FunctionDef) or node.name not in expected:
            continue
        donated = False
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and (
                _is_jax_jit(dec.func) or _is_partial_jit(dec)
            ):
                donated = any(
                    kw.arg in ("donate_argnums", "donate_argnames")
                    for kw in dec.keywords
                )
        if not donated:
            out.append(
                Finding(
                    rule="jit-donate",
                    path=ctx.path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"{node.name}() is donate-eligible "
                        f"({expected[node.name]}) but its jit passes no "
                        "donate_argnums — per-call buffers are copied, "
                        "not reused"
                    ),
                )
            )
    return out


def _qualname(ctx: FileContext, fn: ast.FunctionDef) -> str:
    parts = [fn.name]
    for anc in ctx.ancestors(fn):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            parts.append(anc.name)
    return ".".join(reversed(parts))


def _sync_call(node: ast.Call) -> str:
    """Describe the host-sync pattern a Call matches, or ''."""
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id == "float":
        # float(literal) is host arithmetic, not a device fetch
        if node.args and isinstance(node.args[0], ast.Constant):
            return ""
        return "float(...)"
    if isinstance(fn, ast.Attribute):
        if fn.attr == "item":
            return ".item()"
        if fn.attr == "block_until_ready":
            return "block_until_ready"
        if fn.attr in ("asarray", "array") and isinstance(fn.value, ast.Name) and (
            fn.value.id in ("np", "numpy")
        ):
            return f"np.{fn.attr}"
    return ""


@rule(
    "host-sync",
    "no device->host syncs inside serve pipeline threads / IPM loop",
)
def check_host_sync(ctx: FileContext) -> List[Finding]:
    hot = config.HOT_SCOPES.get(ctx.pkg_path)
    if not hot:
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        what = _sync_call(node)
        if not what:
            continue
        # Match the innermost enclosing hot function, closures included
        # (a sync inside a nested helper still runs on the hot thread).
        scope = None
        fn = ctx.enclosing_function(node)
        while fn is not None:
            if _qualname(ctx, fn) in hot:
                scope = fn
                break
            fn = ctx.enclosing_function(fn)
        if scope is None:
            continue
        out.append(
            Finding(
                rule="host-sync",
                path=ctx.path,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"{what} inside hot scope {_qualname(ctx, scope)} — a "
                    "host<->device sync that stalls the pipeline; move it "
                    "out of the loop or annotate the sanctioned sync point"
                ),
            )
        )
    return out
