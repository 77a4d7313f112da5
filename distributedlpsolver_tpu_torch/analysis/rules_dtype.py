"""dtype-discipline rules.

The solver's precision story is deliberate and layered: f64 iterates,
f32 factorizations under the two-phase schedule, f32-gram/f64c Schur
assembly, and the MXU panel kernels — each narrowing is a *scheduled*
decision with a measured error budget (ROUND5_NOTES). Two statically
visible ways that discipline erodes:

- ``dtype-explicit`` — a ``jnp.zeros``/``jnp.array``-family call in the
  device-math layers (config.DTYPE_SCOPE_DIRS) without an explicit
  dtype. The default depends on the x64 flag and on TPU quietly differs
  from the CPU test rig, so "whatever the default is" is exactly how a
  CPU-green/TPU-wrong buffer is born. ``*_like`` constructors and
  ``arange`` (index arithmetic) inherit deliberately and are exempt.
- ``dtype-narrow`` — an ``.astype(float32)`` (or ``jnp.float32(x)``)
  outside the sanctioned mixed-precision schedule modules
  (config.NARROW_SANCTIONED). Narrowing anywhere else silently spends
  precision the two-phase design never budgeted.
"""

from __future__ import annotations

import ast
from typing import List

from distributedlpsolver_tpu_torch.analysis import config
from distributedlpsolver_tpu_torch.analysis.core import FileContext, Finding, rule


def _jnp_call(node: ast.Call) -> str:
    """The constructor name for ``jnp.<name>(...)`` calls, else ''."""
    fn = node.func
    if (
        isinstance(fn, ast.Attribute)
        and isinstance(fn.value, ast.Name)
        and fn.value.id in ("jnp",)
    ):
        return fn.attr
    return ""


def _literalish(node: ast.AST) -> bool:
    """Python-literal-valued expressions whose array dtype is minted by
    the constructor: constants, list/tuple displays of them, and unary
    minus. Name/Attribute/Call inputs carry their own dtype."""
    if isinstance(node, ast.Constant):
        return not isinstance(node.value, str)
    if isinstance(node, ast.UnaryOp):
        return _literalish(node.operand)
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_literalish(el) for el in node.elts)
    return False


@rule(
    "dtype-explicit",
    "jnp constructors in ops/ipm/backends must pin an explicit dtype",
)
def check_dtype_explicit(ctx: FileContext) -> List[Finding]:
    if not ctx.in_dirs(*config.DTYPE_SCOPE_DIRS):
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _jnp_call(node)
        if name not in config.DTYPE_CONSTRUCTORS:
            continue
        if any(kw.arg == "dtype" for kw in node.keywords):
            continue
        dtype_pos = config.DTYPE_CONSTRUCTORS[name]
        if len(node.args) > dtype_pos:
            continue  # dtype given positionally (the repo's short form)
        # array/asarray inherit the input's dtype; the default only
        # kicks in for Python literals (where x64-flag dependence bites).
        if name in ("array", "asarray") and node.args and not _literalish(
            node.args[0]
        ):
            continue
        out.append(
            Finding(
                rule="dtype-explicit",
                path=ctx.path,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"jnp.{name}(...) without an explicit dtype — the "
                    "default is x64-flag- and platform-dependent; pin it"
                ),
            )
        )
    return out


_F32_NAMES = {"f32", "F32"}


def _is_float32(node: ast.AST) -> bool:
    """Expression that denotes float32: jnp/np.float32, the repo's f32
    alias, or the string literal."""
    if isinstance(node, ast.Attribute) and node.attr == "float32":
        return True
    if isinstance(node, ast.Name) and node.id in _F32_NAMES:
        return True
    if isinstance(node, ast.Constant) and node.value == "float32":
        return True
    return False


@rule(
    "dtype-narrow",
    "f64->f32 narrowing only inside sanctioned mixed-precision modules",
)
def check_dtype_narrow(ctx: FileContext) -> List[Finding]:
    if not ctx.in_dirs(*config.DTYPE_SCOPE_DIRS):
        return []
    if ctx.pkg_path in config.NARROW_SANCTIONED:
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        narrow = None
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr == "astype"
            and node.args
            and _is_float32(node.args[0])
        ):
            narrow = ".astype(float32)"
        elif (
            isinstance(fn, ast.Attribute)
            and fn.attr == "float32"
            and isinstance(fn.value, ast.Name)
            and fn.value.id in ("jnp",)
            and node.args
        ):
            narrow = "jnp.float32(...)"
        if narrow is None:
            continue
        out.append(
            Finding(
                rule="dtype-narrow",
                path=ctx.path,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"{narrow} in {ctx.pkg_path}, which is not a "
                    "sanctioned mixed-precision schedule module — "
                    "unbudgeted precision loss"
                ),
            )
        )
    return out
