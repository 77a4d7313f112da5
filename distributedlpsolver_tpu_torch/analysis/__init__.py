"""graftcheck: the repo's static-analysis suite, wired into tier-1 as a
CI gate (``cli check distributedlpsolver_tpu_torch/`` must exit 0).

The torch package's copy of the JAX package's ``analysis/``: the same
rules, messages, directives and baseline schema, so one source gives
one list of findings under either suite. Package-relative paths and
dotted imports are read against ``distributedlpsolver_tpu_torch``; the
tables of ``config.py`` are the reference's, keyed by the same paths,
plus a block of the port's own entries.

Six rule families enforce the invariants the runtime tests can only
spot-check (README "Static analysis" has the catalogue and suppression
syntax):

- jit/recompile hygiene — ``jit-nonhoisted``, ``jit-scalar-default``,
  ``jit-donate``, ``host-sync`` (rules_jit)
- dtype discipline — ``dtype-explicit``, ``dtype-narrow`` (rules_dtype)
- lock discipline — ``guarded-by`` (rules_locks), paired with the
  dynamic :mod:`~distributedlpsolver_tpu_torch.analysis.lockorder` recorder
- static deadlock analysis — ``lock-order`` (cross-method acquisition
  cycles) and ``blocking-under-lock`` (rules_locks, graftcheck v2)
- SPMD discipline — ``spmd-divergent-collective``,
  ``spmd-unordered-dispatch``, ``spmd-uncommitted-input`` (rules_spmd,
  graftcheck v2): the multi-host every-rank-runs-the-same-programs
  contract of distributed/world.py, gated statically
- JSONL schema conformance — ``jsonl-fields``, ``jsonl-stamp``
  (rules_schema)

The v2 families are *interprocedural*: they run over a package-wide
call graph with taint/reach summaries (analysis/callgraph.py) exposed
to rules as a :class:`~distributedlpsolver_tpu_torch.analysis.core.
ProjectContext`. Still stdlib-only on purpose: the gate runs on CPU CI
in a few seconds, with no torch import.

Incremental gating: ``cli check --baseline <json>`` fails only on
findings not present in a committed baseline (``--write-baseline``
produces one), so downstream consumers get a cheap diff-gate; this
repo's own tier-1 gate runs against the empty committed baseline
(BASELINE_GRAFTCHECK_TORCH.json) — zero tolerated findings.
"""

from distributedlpsolver_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    ProjectContext,
    all_rules,
    baseline_key,
    check_file,
    check_paths,
    diff_baseline,
    iter_py_files,
    project_rule,
    render_json,
    render_text,
    rule,
    write_baseline,
)
from distributedlpsolver_tpu_torch.analysis.lockorder import (
    LockOrderRecorder,
    LockOrderViolation,
)

__all__ = [
    "FileContext",
    "Finding",
    "LockOrderRecorder",
    "LockOrderViolation",
    "ProjectContext",
    "all_rules",
    "baseline_key",
    "check_file",
    "check_paths",
    "diff_baseline",
    "iter_py_files",
    "project_rule",
    "render_json",
    "render_text",
    "rule",
    "write_baseline",
]
