"""graftcheck in the torch package (``distributedlpsolver_tpu_torch/analysis``,
``cli check``) against the JAX package's, on the CPU.

The port's suite gives the JAX suite's findings, field for field, on
every fixture of ``tests/graftcheck_fixtures/`` under the package paths
``tests/test_graftcheck.py`` checks it at, and the two CLIs print the
same ``--json`` over the fixtures directory. Then the twins of the
reference's families on the port's API: suppression semantics, the
dynamic lock-order recorder, the live 3-thread drain of the port's
SolveService and its static-vs-dynamic cross-check, the baseline
diff-gate, the stdlib-only contract, and the tier-1 gate over
``distributedlpsolver_tpu_torch/`` (zero findings, also against the
committed empty ``BASELINE_GRAFTCHECK_TORCH.json``). Last, the hazard the
gate's spmd findings pointed at: a request that a serving slice's rank 0
solves alone must enter none of the world's collectives.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import pytest

from distributedlpsolver_tpu import analysis as janalysis
from distributedlpsolver_tpu import cli as jcli
from distributedlpsolver_tpu_torch import cli
from distributedlpsolver_tpu_torch.analysis import (
    LockOrderRecorder,
    LockOrderViolation,
    all_rules,
    check_file,
    check_paths,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.check

_HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(_HERE)
_FIX = os.path.join(_HERE, "graftcheck_fixtures")
_PKG = os.path.join(ROOT, "distributedlpsolver_tpu_torch")
_BASELINE = os.path.join(ROOT, "BASELINE_GRAFTCHECK_TORCH.json")
SINGLE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}

# Fixture stem -> (the bad twin's package paths, the clean twin's): those
# tests/test_graftcheck.py checks it at. The first of each is the twin's
# own (bad yields findings there, clean none); the others are the non-hot,
# out-of-scope and sanctioned variants, held to parity alone.
_PAIRS = {
    "jit": (["backends/batched.py"], ["backends/batched.py"]),
    "host_sync": (["serve/service.py", "models/problem.py"], ["serve/service.py"]),
    "dtype": (["ipm/fx.py", "ops/chol_mxu.py", "serve/fx.py"], ["ipm/fx.py"]),
    "df32": (["ipm/fx.py", "ops/df32.py"], ["ops/df32.py", "ipm/fx.py"]),
    "sparse": (["ipm/fx.py", "ops/pcg.py"], ["ops/pcg.py", "ipm/fx.py"]),
    "locks": (["serve/fx.py"], ["serve/fx.py"]),
    "schema": (["serve/fx.py"], ["serve/fx.py"]),
    "journal": (["serve/fx.py"], ["serve/fx.py"]),
    "scenario": (["backends/scenario_fx.py"], ["backends/scenario_fx.py"]),
    "distsparse": (["backends/fx.py"], ["backends/fx.py"]),
    "multihost": (["distributed/fx.py"], ["distributed/fx.py"]),
    "elastic": (["serve/fx.py"], ["serve/fx.py"]),
    "tail": (["net/fx.py"], ["net/fx.py"]),
    "trace": (["net/fx.py"], ["net/fx.py"]),
    "spmd": (["distributed/fx.py"], ["distributed/fx.py"]),
    "deadlock": (["serve/fx.py"], ["serve/fx.py"]),
}
_CASES = [
    (f"fx_{stem}_{twin}.py", pkg, i == 0)
    for stem, twins in _PAIRS.items()
    for twin, pkgs in zip(("bad", "clean"), twins)
    for i, pkg in enumerate(pkgs)
]


def _rows(findings):
    return [(f.rule, f.line, f.col, f.message, f.suppressed) for f in findings]


def test_the_fixtures_are_the_pairs_checked():
    names = sorted(n for n in os.listdir(_FIX) if n.startswith("fx_"))
    assert names == sorted({name for name, _, _ in _CASES})
    assert len(_PAIRS) == 16


@pytest.mark.parametrize("name, pkg_path, own", _CASES)
def test_fixture_findings_equal_the_jax_suites(name, pkg_path, own):
    path = os.path.join(_FIX, name)
    ours = _rows(check_file(path, pkg_path=pkg_path))
    assert ours == _rows(janalysis.check_file(path, pkg_path=pkg_path))
    if own:
        gating = [r for r in ours if not r[4]]
        assert gating if name.endswith("_bad.py") else not gating, ours


def test_cli_json_over_the_fixtures_equals_the_jax_clis(capsys):
    rc = cli.main(["check", _FIX, "--json"])
    ours = json.loads(capsys.readouterr().out)
    jrc = jcli.main(["check", _FIX, "--json"])
    ref = json.loads(capsys.readouterr().out)
    assert rc == jrc == 1
    strip = lambda fs: [{k: v for k, v in f.items() if k != "path"} for f in fs]
    assert strip(ours["findings"]) == strip(ref["findings"])
    assert strip(ours["suppressed"]) == strip(ref["suppressed"])
    assert ours["counts"] == ref["counts"] and ours["counts"]["findings"] > 0
    assert ours["rules"] == ref["rules"]
    # The same files in the same order.
    assert [os.path.basename(f["path"]) for f in ours["findings"]] == [
        os.path.basename(f["path"]) for f in ref["findings"]
    ]


class TestSuppressions:
    SRC = "import jax.numpy as jnp\n\ndef f():\n    return jnp.zeros((2, 2))%s\n"

    def _check(self, src):
        return check_file("fx.py", source=src, pkg_path="ops/fx.py")

    def test_line_directive_suppresses(self):
        fs = self._check(self.SRC % "  # graftcheck: disable=dtype-explicit")
        assert [f.rule for f in fs] == ["dtype-explicit"]
        assert fs[0].suppressed  # still reported, marked suppressed

    def test_disable_all(self):
        fs = self._check(self.SRC % "  # graftcheck: disable=all")
        assert fs[0].suppressed

    def test_other_rule_does_not_suppress(self):
        fs = self._check(self.SRC % "  # graftcheck: disable=host-sync")
        assert not fs[0].suppressed

    def test_preceding_comment_line_suppresses(self):
        src = (
            "import jax.numpy as jnp\n\ndef f():\n"
            "    # graftcheck: disable=dtype-explicit (twin test)\n"
            "    return jnp.zeros((2, 2))\n"
        )
        assert self._check(src)[0].suppressed

    def test_def_line_directive_covers_body(self):
        src = (
            "import jax.numpy as jnp\n\n"
            "def f():  # graftcheck: disable=dtype-explicit\n"
            "    a = jnp.zeros((2, 2))\n"
            "    return a, jnp.ones(3)\n"
        )
        fs = self._check(src)
        assert len(fs) == 2 and all(f.suppressed for f in fs)

    def test_file_wide_directive(self):
        fs = self._check("# graftcheck: disable-file=dtype-explicit\n" + self.SRC % "")
        assert fs[0].suppressed

    def test_unsuppressed_without_directive(self):
        assert [f.suppressed for f in self._check(self.SRC % "")] == [False]

    def test_unknown_rule_rejected(self):
        with pytest.raises(ValueError, match="unknown graftcheck rule"):
            check_file("fx.py", source="x = 1\n", rules=["no-such-rule"])


class TestLockOrderRecorder:
    def test_consistent_order_passes(self):
        rec = LockOrderRecorder()
        a = rec.wrap(threading.Lock(), "a")
        b = rec.wrap(threading.Lock(), "b")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert ("a", "b") in rec.edges()
        rec.check()

    def test_inversion_detected(self):
        rec = LockOrderRecorder()
        a = rec.wrap(threading.Lock(), "a")
        b = rec.wrap(threading.Lock(), "b")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        with pytest.raises(LockOrderViolation, match="a -> b -> a|b -> a -> b"):
            rec.check()

    def test_condition_compatible(self):
        rec = LockOrderRecorder()
        lk = rec.wrap(threading.Lock(), "svc")
        cond = threading.Condition(lk)
        hit = []

        def waiter():
            with cond:
                cond.wait_for(lambda: hit, timeout=5.0)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            hit.append(1)
            cond.notify_all()
        t.join(5.0)
        assert not t.is_alive()
        rec.check()


def _drained_service_edges(tmp_path, names, seeds):
    """Wrap the live locks of a 3-thread SolveService on the CPU under
    ``names``, drain ``seeds`` requests through scheduler -> pack ->
    solve, and return the recorder."""
    from distributedlpsolver_tpu_torch.models import random_dense_lp
    from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry
    from distributedlpsolver_tpu_torch.obs.trace import Tracer
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService

    rec = LockOrderRecorder()
    svc = SolveService(
        ServiceConfig(batch=4, flush_s=0.02),
        metrics=MetricsRegistry(),
        tracer=Tracer(str(tmp_path / "trace.json")),
        auto_start=False,
        device="cpu",
    )
    # _wake/_idle are Conditions over _lock; rebuild them over the
    # wrapped lock so every acquisition path records.
    svc._lock = rec.wrap(svc._lock, names["service"])
    svc._wake = threading.Condition(svc._lock)
    svc._idle = threading.Condition(svc._lock)
    svc._span_lock = rec.wrap(svc._span_lock, names["span"])
    svc._logger._lock = rec.wrap(svc._logger._lock, names["logger"])
    svc.metrics._lock = rec.wrap(svc.metrics._lock, names["metrics"])
    svc.tracer._lock = rec.wrap(svc.tracer._lock, names["tracer"])
    svc.start()
    try:
        futs = [svc.submit(random_dense_lp(6, 10, seed=s), name=f"r{s}") for s in seeds]
        assert svc.drain(timeout=120.0)
        assert all(f.result(timeout=5.0) is not None for f in futs)
    finally:
        svc.shutdown()
    return rec


@pytest.mark.serve
def test_lock_order_live_service_drain(tmp_path):
    """The live lock graph of the port's 3-thread service stays acyclic;
    the tracer emits under the service lock on every submit."""
    names = {"service": "service_lock", "span": "span_lock", "logger": "logger_lock",
             "metrics": "metrics_lock", "tracer": "tracer_lock"}
    rec = _drained_service_edges(tmp_path, names, range(8))
    assert ("service_lock", "tracer_lock") in rec.edges(), rec.edges()
    rec.check()


@pytest.mark.serve
def test_static_vs_dynamic_lock_order_cross_check(tmp_path):
    """The static lock-order graph of the port (its call graph, no
    execution) and the edges a live drain records agree: the union stays
    acyclic, and the service -> tracer nesting the drain observes is an
    edge the static analysis knew."""
    from distributedlpsolver_tpu_torch.analysis import iter_py_files
    from distributedlpsolver_tpu_torch.analysis.core import FileContext, ProjectContext

    contexts = []
    for p in iter_py_files([_PKG]):
        with open(p) as fh:
            contexts.append(FileContext(p, fh.read()))
    static_edges = set(ProjectContext(contexts).locks.order_edges())

    names = {"service": "SolveService._lock", "span": "SolveService._span_lock",
             "logger": "IterLogger._lock", "metrics": "MetricsRegistry._lock",
             "tracer": "Tracer._lock"}
    dynamic_edges = _drained_service_edges(tmp_path, names, range(6)).edges()
    assert ("SolveService._lock", "Tracer._lock") in dynamic_edges
    assert ("SolveService._lock", "Tracer._lock") in static_edges

    graph = {}
    for a, b in static_edges | dynamic_edges:
        graph.setdefault(a, set()).add(b)
    color = {}

    def dfs(n):
        color[n] = 1
        for m in sorted(graph.get(n, ())):
            if color.get(m) == 1:
                return [n, m]
            if m not in color and dfs(m):
                return [n, m]
        color[n] = 2
        return []

    for n in sorted(graph):
        if n not in color:
            assert not dfs(n), ("static+dynamic lock graphs disagree", static_edges, dynamic_edges)


class TestBaseline:
    """``check --baseline``: the incremental diff-gate."""

    BAD_ONE = "import jax\n\ndef f(v):\n    return jax.jit(lambda x: x + 1)(v)\n"
    BAD_TWO = BAD_ONE + "\ndef g(v):\n    return jax.jit(lambda x: x * 2)(v)\n"

    def test_known_findings_covered_new_ones_fail(self, tmp_path, capsys):
        bad = tmp_path / "fx.py"
        bad.write_text(self.BAD_ONE)
        base = tmp_path / "base.json"
        assert cli.main(["check", str(bad), "--write-baseline", str(base)]) == 0
        doc = json.loads(base.read_text())
        assert doc["schema"] == 1 and len(doc["findings"]) == 1
        assert cli.main(["check", str(bad), "--baseline", str(base)]) == 0
        bad.write_text(self.BAD_TWO)
        assert cli.main(["check", str(bad), "--baseline", str(base)]) == 1
        capsys.readouterr()

    def test_baseline_keys_are_line_number_independent(self, tmp_path, capsys):
        bad = tmp_path / "fx.py"
        bad.write_text(self.BAD_ONE)
        base = tmp_path / "base.json"
        assert cli.main(["check", str(bad), "--write-baseline", str(base)]) == 0
        bad.write_text("# pad\n# pad\n# pad\n" + self.BAD_ONE)
        assert cli.main(["check", str(bad), "--baseline", str(base)]) == 0
        capsys.readouterr()

    def test_unreadable_baseline_exits_2(self, tmp_path, capsys):
        ok = tmp_path / "fx.py"
        ok.write_text("x = 1\n")
        assert cli.main(["check", str(ok), "--baseline", str(tmp_path / "nope.json")]) == 2
        capsys.readouterr()

    def test_baseline_document_equals_the_jax_clis(self, tmp_path, capsys):
        bad = tmp_path / "fx.py"
        bad.write_text(self.BAD_TWO)
        a, b = tmp_path / "port.json", tmp_path / "ref.json"
        assert cli.main(["check", str(bad), "--write-baseline", str(a)]) == 0
        assert jcli.main(["check", str(bad), "--write-baseline", str(b)]) == 0
        assert a.read_bytes() == b.read_bytes()
        capsys.readouterr()


def test_analyzer_is_stdlib_only():
    """No module of the port's analysis/ imports anything outside the
    standard library and the port itself: no torch, numpy, jax or JAX
    package."""
    import ast

    std = set(sys.stdlib_module_names)
    adir = os.path.join(_PKG, "analysis")
    names = sorted(f for f in os.listdir(adir) if f.endswith(".py"))
    assert len(names) == 10
    for fname in names:
        with open(os.path.join(adir, fname)) as fh:
            tree = ast.parse(fh.read(), filename=fname)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".")[0]
                assert top == "distributedlpsolver_tpu_torch" or top in std, (fname, m)


def test_importing_the_analyzer_loads_no_framework():
    """The gate runs with no torch, numpy or JAX: the package's own
    ``__init__`` (which imports numpy) is stood in for by a bare module."""
    code = (
        "import sys, types\n"
        "pkg = types.ModuleType('distributedlpsolver_tpu_torch')\n"
        f"pkg.__path__ = [{_PKG!r}]\n"
        "sys.modules['distributedlpsolver_tpu_torch'] = pkg\n"
        "import distributedlpsolver_tpu_torch.analysis as a\n"
        f"fs = a.check_paths([{_FIX!r}])\n"
        "assert fs and a.all_rules()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'distributedlpsolver_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


class TestGate:
    """The tier-1 CI gate over the torch package."""

    def test_package_tree_is_clean(self):
        t0 = time.perf_counter()
        findings = check_paths([_PKG])
        elapsed = time.perf_counter() - t0
        bad = [f.render() for f in findings if not f.suppressed]
        assert bad == [], "unsuppressed graftcheck findings:\n" + "\n".join(bad)
        # The deliberate exceptions stay visible: the watchdog sync, the
        # serve demux floats, the header parse, the replicated-stats exits.
        sup = {(f.rule, os.path.relpath(f.path, _PKG)) for f in findings if f.suppressed}
        assert ("host-sync", os.path.join("ipm", "driver.py")) in sup
        assert ("host-sync", os.path.join("serve", "service.py")) in sup
        assert ("spmd-divergent-collective", os.path.join("ipm", "driver.py")) in sup
        assert elapsed < 45.0, f"graftcheck took {elapsed:.1f}s (budget 45s)"

    def test_gate_against_committed_empty_baseline(self, capsys):
        assert json.load(open(_BASELINE)) == {"findings": {}, "schema": 1}
        rc = cli.main(["check", _PKG, "--baseline", _BASELINE])
        out = capsys.readouterr().out
        assert rc == 0
        assert out.strip().splitlines()[-1].startswith("graftcheck: 0 finding(s), ")

    def test_cli_check_json_gate(self, capsys):
        rc = cli.main(["check", _PKG, "--json"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert out["counts"]["findings"] == 0 and out["counts"]["suppressed"] > 0
        assert set(out["rules"]) == set(all_rules()) == set(janalysis.all_rules())
        for name in ("spmd-divergent-collective", "spmd-unordered-dispatch",
                     "spmd-uncommitted-input", "lock-order", "blocking-under-lock"):
            assert name in out["rules"]
        assert all("rule" in f and "line" in f for f in out["suppressed"])
        artifact = os.environ.get("DLPS_CHECK_ARTIFACT_TORCH") or os.path.join(
            tempfile.gettempdir(), "graftcheck_report_torch.json"
        )
        with open(artifact, "w") as fh:
            json.dump(out, fh, indent=2)
        assert json.load(open(artifact))["counts"]["findings"] == 0

    def test_cli_check_nonzero_on_violation(self, tmp_path, capsys):
        bad = tmp_path / "fx.py"
        bad.write_text("import jax\n\ndef f(v):\n    return jax.jit(lambda x: x + 1)(v)\n")
        rc = cli.main(["check", str(bad)])
        out = capsys.readouterr().out
        assert rc == 1
        assert "jit-nonhoisted" in out

    def test_cli_check_unknown_rule_exit_2(self, capsys):
        assert cli.main(["check", _FIX, "--rules", "no-such-rule"]) == 2
        assert cli.main(["check", os.path.join(_FIX, "no_such_file.py")]) == 2
        capsys.readouterr()

    def test_cli_list_rules(self, capsys):
        assert cli.main(["check", "--list-rules"]) == 0
        out = capsys.readouterr().out
        for name in all_rules():
            assert name in out

    def test_module_entry_point_runs_the_gate(self):
        proc = subprocess.run(
            [sys.executable, "-m", "distributedlpsolver_tpu_torch", "check", "--list-rules"],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        assert "spmd-divergent-collective" in proc.stdout


# -- the hazard: a rank-0-alone solve on a serving slice ------------------------------


def _http(url, body=None, timeout=30.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except (urllib.error.URLError, OSError, ValueError):
        return -1, {}


def _wait(pred, timeout, what):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


def test_slice_rank0_solo_request_enters_no_world_collective(tmp_path):
    """``cli serve-slice --world-size 2`` on a gloo world: a general-form
    request (MPS text) takes the service's per-request path, which rank 0
    runs alone while rank 1 waits on the dispatch journal. The supervised
    solve there once entered the world's collectives (the broadcast of
    rank 0's checkpoint directory, the driver's checkpoint barrier) and
    hung the slice. It answers now, with the JAX package's verdict, and
    the slice goes on serving buckets through both ranks."""
    from distributedlpsolver_tpu.io import read_mps as jread_mps
    from distributedlpsolver_tpu.ipm import solve as jsolve
    from distributedlpsolver_tpu_torch.distributed.launcher import free_port

    mps = os.path.join(ROOT, "tests", "fixtures", "maximize.mps")
    ref = jsolve(jread_mps(mps), backend="cpu")
    port = free_port()
    work = tmp_path / "work"
    cmd = [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "serve-slice",
           "--world-size", "2", "--device", "cpu", "--pg-backend", "gloo", "--port", str(port),
           "--slice-workdir", str(work), "--batch", "4", "--flush-ms", "5"]
    log = open(tmp_path / "sup.log", "w")
    sup = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                           env={**os.environ, **SINGLE_THREAD}, cwd=ROOT)
    url = f"http://127.0.0.1:{port}"
    try:
        _wait(lambda: _http(url + "/healthz", timeout=2)[0] == 200, 120, "the slice came up")
        code, out = _http(url + "/v1/solve", {"m": 8, "n": 24, "seed": 0}, timeout=60)
        assert code == 200 and out["status"] == "optimal", out
        with open(mps) as fh:
            code, out = _http(url + "/v1/solve", {"mps_text": fh.read()}, timeout=60)
        assert code == 200, (code, out)
        assert out["status"] == ref.status.value == "optimal" and out["bucket"] is None
        assert abs(out["objective"] - ref.objective) <= 1e-6 * (1 + abs(ref.objective))
        # Rank 1 still replays every bucket dispatch after it.
        code, out = _http(url + "/v1/solve", {"m": 8, "n": 24, "seed": 1}, timeout=60)
        assert code == 200 and out["status"] == "optimal", out
        assert _http(url + "/quitquitquit", {})[0] == 200
        sup.wait(timeout=60)
        assert sup.returncode == 0
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait(timeout=30)
        for hb in work.glob("hb-gen*/rank*.hb"):  # no rank outlives the test
            try:
                os.kill(json.loads(hb.read_text())["pid"], signal.SIGKILL)
            except (OSError, ValueError):
                pass
        log.close()
