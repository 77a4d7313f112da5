"""graftcheck framework: rule registry, suppressions, reporters.

The checker is deliberately stdlib-only (``ast`` + ``tokenize``-free
line scanning): it must run on CPU-only CI in well under a second with
no torch import, because its whole point is catching accelerator-hygiene
regressions *before* a run on the card is spent discovering them at runtime
(README "Static analysis").

A rule is a function ``rule(ctx) -> Iterable[Finding]`` registered with
:func:`rule`. ``ctx`` is a :class:`FileContext` carrying the parsed AST,
raw source lines, and the file's package-relative path (``pkg_path``) so
rules can scope themselves to ``ops/``, ``serve/service.py``, etc.
Repo-specific tuning (hot scopes, sanctioned modules, the JSONL field
catalogue) lives in :mod:`analysis.config`, keeping this module generic.

Suppressions
------------
``# graftcheck: disable=<rule>[,<rule>...]`` on a finding's line — or on
a standalone comment line directly above it — suppresses those rules
there (``disable=all`` suppresses every rule). The same directive on a
``def``/``class`` line suppresses within that whole definition.
``# graftcheck: disable-file=<rule>[,...]`` anywhere in a file (by
convention the top) suppresses file-wide. Suppressed findings are still
collected and reported (``suppressed: true`` in the JSON reporter) so
the deliberate-exception inventory stays visible; only unsuppressed
findings fail the gate.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_DIRECTIVE = re.compile(
    r"#\s*graftcheck:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\- ]+)"
)


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # as given to the checker (display path)
    line: int  # 1-indexed
    col: int  # 0-indexed
    message: str
    suppressed: bool = False

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}{tag}"


# ---------------------------------------------------------------------------
# Rule registry

_RULES: Dict[str, Tuple[Callable, str]] = {}
_PROJECT_RULES: Dict[str, Tuple[Callable, str]] = {}


def rule(name: str, doc: str):
    """Register a checker function under ``name`` (its gate identity and
    the token suppression comments name)."""

    def deco(fn):
        if name in _RULES or name in _PROJECT_RULES:
            raise ValueError(f"duplicate graftcheck rule {name!r}")
        _RULES[name] = (fn, doc)
        fn.rule_name = name
        return fn

    return deco


def project_rule(name: str, doc: str):
    """Register an *interprocedural* rule: ``fn(project) ->
    Iterable[Finding]`` over a :class:`ProjectContext` (whole analyzed
    file set + call graph) instead of one file. Project rules run once
    per check invocation; their findings are attributed to individual
    files and go through the same per-file suppression machinery."""

    def deco(fn):
        if name in _RULES or name in _PROJECT_RULES:
            raise ValueError(f"duplicate graftcheck rule {name!r}")
        _PROJECT_RULES[name] = (fn, doc)
        fn.rule_name = name
        return fn

    return deco


def all_rules() -> Dict[str, str]:
    """{rule name: one-line description} for --list-rules and docs."""
    _load_rules()
    merged = dict(_RULES)
    merged.update(_PROJECT_RULES)
    return {name: doc for name, (fn, doc) in sorted(merged.items())}


_loaded = False


def _load_rules() -> None:
    # Import-for-side-effect: each rules module populates the registry.
    global _loaded
    if _loaded:
        return
    from distributedlpsolver_tpu_torch.analysis import (  # noqa: F401
        rules_dtype,
        rules_jit,
        rules_locks,
        rules_schema,
        rules_spmd,
    )

    _loaded = True


# ---------------------------------------------------------------------------
# Per-file context

class FileContext:
    """Everything a rule needs about one file."""

    def __init__(self, path: str, source: str, pkg_path: Optional[str] = None):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # Path relative to the package root ("serve/service.py") — the
        # key rules scope on. Inferred from the real path; tests checking
        # fixture files pass ``pkg_path`` to emulate a package location.
        self.pkg_path = pkg_path if pkg_path is not None else _infer_pkg_path(path)
        # parent links let rules walk outward (enclosing With/FunctionDef)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def in_dirs(self, *dirs: str) -> bool:
        """True if the file lives under any of the given package dirs."""
        top = self.pkg_path.split("/", 1)[0]
        return top in dirs

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None


def _infer_pkg_path(path: str) -> str:
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    if "distributedlpsolver_tpu_torch" in parts:
        i = len(parts) - 1 - parts[::-1].index("distributedlpsolver_tpu_torch")
        return "/".join(parts[i + 1 :])
    return parts[-1]


# ---------------------------------------------------------------------------
# Whole-file-set context (graftcheck v2)

class ProjectContext:
    """Everything an interprocedural rule needs about the analyzed file
    set: the per-file contexts plus the lazily-built call graph, taint
    engine, and lock model (analysis/callgraph.py). A single fixture
    file checked via :func:`check_file` gets a degenerate one-file
    project — the same rules run, just with nothing to resolve across.
    """

    def __init__(self, contexts: Sequence[FileContext]):
        self.contexts = list(contexts)
        self.by_path: Dict[str, FileContext] = {
            c.pkg_path: c for c in self.contexts
        }
        self._graph = None
        self._taint = None
        self._locks = None

    @property
    def graph(self):
        if self._graph is None:
            from distributedlpsolver_tpu_torch.analysis.callgraph import CallGraph

            self._graph = CallGraph(self.contexts)
        return self._graph

    @property
    def taint(self):
        if self._taint is None:
            from distributedlpsolver_tpu_torch.analysis import config
            from distributedlpsolver_tpu_torch.analysis.callgraph import TaintEngine

            self._taint = TaintEngine(self.graph, config.RANK_ENV_KEYS)
        return self._taint

    @property
    def locks(self):
        if self._locks is None:
            from distributedlpsolver_tpu_torch.analysis.callgraph import LockModel

            self._locks = LockModel(self.graph)
        return self._locks


# ---------------------------------------------------------------------------
# Suppressions

class _Suppressions:
    def __init__(self, ctx: FileContext):
        self.file_wide: set = set()
        self.by_line: Dict[int, set] = {}
        for i, text in enumerate(ctx.lines, start=1):
            m = _DIRECTIVE.search(text)
            if not m:
                continue
            names = {t.strip() for t in m.group(2).split(",") if t.strip()}
            if m.group(1) == "disable-file":
                self.file_wide |= names
            else:
                self.by_line.setdefault(i, set()).update(names)
        # A directive on a def/class line covers the whole definition.
        self.spans: List[Tuple[int, int, set]] = []
        for node in ast.walk(ctx.tree):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                names = self.by_line.get(node.lineno)
                if names:
                    self.spans.append(
                        (node.lineno, node.end_lineno or node.lineno, names)
                    )
        self._lines = ctx.lines

    def covers(self, f: Finding) -> bool:
        def match(names: set) -> bool:
            return "all" in names or f.rule in names

        if match(self.file_wide):
            return True
        names = self.by_line.get(f.line)
        if names and match(names):
            return True
        # A standalone comment line directly above the finding.
        prev = self.by_line.get(f.line - 1)
        if (
            prev
            and match(prev)
            and f.line - 2 < len(self._lines)
            and self._lines[f.line - 2].lstrip().startswith("#")
        ):
            return True
        return any(
            lo <= f.line <= hi and match(names) for lo, hi, names in self.spans
        )


# ---------------------------------------------------------------------------
# Entry points

def _split_rule_names(rules: Optional[Sequence[str]]):
    """(file_rule_names, project_rule_names) with unknown-name check."""
    names = list(rules) if rules is not None else None
    if names is None:
        return list(_RULES), list(_PROJECT_RULES)
    unknown = [n for n in names if n not in _RULES and n not in _PROJECT_RULES]
    if unknown:
        raise ValueError(f"unknown graftcheck rule(s): {unknown}")
    return (
        [n for n in names if n in _RULES],
        [n for n in names if n in _PROJECT_RULES],
    )


def _run_rules(
    contexts: Sequence[FileContext],
    parse_errors: Sequence[Finding],
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """File rules per context + project rules once over the whole set,
    then suppressions per file. The shared tail of check_file/check_paths."""
    file_rules, project_rules = _split_rule_names(rules)
    findings: List[Finding] = list(parse_errors)
    for ctx in contexts:
        for name in file_rules:
            fn, _doc = _RULES[name]
            findings.extend(fn(ctx))
    if project_rules and contexts:
        project = ProjectContext(contexts)
        for name in project_rules:
            fn, _doc = _PROJECT_RULES[name]
            findings.extend(fn(project))
    by_display: Dict[str, FileContext] = {c.path: c for c in contexts}
    sups: Dict[str, _Suppressions] = {}
    for f in findings:
        ctx = by_display.get(f.path)
        if ctx is None:
            continue
        sup = sups.get(f.path)
        if sup is None:
            sup = sups[f.path] = _Suppressions(ctx)
        f.suppressed = sup.covers(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def check_file(
    path: str,
    source: Optional[str] = None,
    rules: Optional[Sequence[str]] = None,
    pkg_path: Optional[str] = None,
) -> List[Finding]:
    """Run ``rules`` (default: all registered) over one file — project
    rules see a one-file project. Returns every finding, suppressed ones
    flagged — callers filter."""
    _load_rules()
    if source is None:
        with open(path) as fh:
            source = fh.read()
    try:
        ctx = FileContext(path, source, pkg_path=pkg_path)
    except SyntaxError as e:
        return [
            Finding(
                rule="parse-error",
                path=path,
                line=e.lineno or 0,
                col=e.offset or 0,
                message=f"file does not parse: {e.msg}",
            )
        ]
    return _run_rules([ctx], [], rules=rules)


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs if d != "__pycache__" and not d.startswith(".")
                )
                out.extend(
                    os.path.join(root, f) for f in sorted(files) if f.endswith(".py")
                )
        else:
            out.append(p)
    return out


def check_paths(
    paths: Sequence[str], rules: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Run the suite over files and directories (recursed). All files
    are parsed up front so the interprocedural rules resolve calls
    across every file given in one project view."""
    _load_rules()
    contexts: List[FileContext] = []
    parse_errors: List[Finding] = []
    for path in iter_py_files(paths):
        with open(path) as fh:
            source = fh.read()
        try:
            contexts.append(FileContext(path, source))
        except SyntaxError as e:
            parse_errors.append(
                Finding(
                    rule="parse-error",
                    path=path,
                    line=e.lineno or 0,
                    col=e.offset or 0,
                    message=f"file does not parse: {e.msg}",
                )
            )
    return _run_rules(contexts, parse_errors, rules=rules)


# ---------------------------------------------------------------------------
# Findings baseline (incremental diff-gate)

def baseline_key(f: Finding) -> str:
    """Line-number-independent identity of a finding for baseline
    comparison: rule + package-relative path + message. Line numbers
    drift with every edit; the message (which names the symbol and the
    violated contract) is stable until the code actually changes."""
    parts = f.path.replace(os.sep, "/").split("/")
    if "distributedlpsolver_tpu_torch" in parts:
        i = len(parts) - 1 - parts[::-1].index("distributedlpsolver_tpu_torch")
        rel = "/".join(parts[i + 1 :])
    else:
        rel = parts[-1]
    return f"{f.rule}::{rel}::{f.message}"


def write_baseline(findings: Sequence[Finding]) -> str:
    """Serialize the unsuppressed findings as a committed baseline
    document (``cli check --write-baseline``)."""
    keys: Dict[str, int] = {}
    for f in findings:
        if not f.suppressed:
            k = baseline_key(f)
            keys[k] = keys.get(k, 0) + 1
    return json.dumps(
        {"schema": 1, "findings": keys},
        indent=2,
        sort_keys=True,
    )


def diff_baseline(
    findings: Sequence[Finding], baseline_doc: dict
) -> List[Finding]:
    """The unsuppressed findings NOT covered by the baseline — the
    diff-gate's failure set. A baseline entry covers as many findings of
    its key as it counted; the (N+1)-th is new."""
    budget = dict(baseline_doc.get("findings", {}))
    new: List[Finding] = []
    for f in findings:
        if f.suppressed:
            continue
        k = baseline_key(f)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            new.append(f)
    return new


# ---------------------------------------------------------------------------
# Reporters

def render_text(findings: Sequence[Finding], show_suppressed: bool = False) -> str:
    shown = [f for f in findings if show_suppressed or not f.suppressed]
    lines = [f.render() for f in shown]
    n_bad = sum(1 for f in findings if not f.suppressed)
    n_sup = len(findings) - n_bad
    lines.append(
        f"graftcheck: {n_bad} finding(s), {n_sup} suppressed"
    )
    return "\n".join(lines)


def render_json(findings: Sequence[Finding]) -> str:
    """Machine-readable gate output (``cli check --json``)."""
    return json.dumps(
        {
            "findings": [f.asdict() for f in findings if not f.suppressed],
            "suppressed": [f.asdict() for f in findings if f.suppressed],
            "counts": {
                "findings": sum(1 for f in findings if not f.suppressed),
                "suppressed": sum(1 for f in findings if f.suppressed),
            },
            "rules": all_rules(),
        },
        indent=2,
    )
