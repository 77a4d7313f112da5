"""The torch package's telemetry tools (``obs/report.py``, ``obs/agg.py``,
``utils/utilization.py``) against the JAX package's, on the CPU.

* ``report``: both analyzers give the same report (and the same text) on
  the same telemetry — a serve log, its request records and a metrics
  snapshot written by the port's service, and a driver log of the port.
* ``agg``: both merge the same per-process traces (the port's span tracer
  and a ``torch.profiler`` Chrome trace) into the same fleet trace and
  summary, parse Prometheus text alike, and build the same fleet view and
  reconciliation over a live port backend and router.
* ``utilization``: the same folding, against the H100's peaks.
* ``scripts/port_probe_trace.py --device cpu`` passes: one hedged
  request's trace connects spans across processes, and ``cli obs-agg``
  reconciles the plane.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from distributedlpsolver_tpu.obs import agg as jagg
from distributedlpsolver_tpu.obs import report as jreport
from distributedlpsolver_tpu.utils import utilization as jutil
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.net import NetConfig, SolveHTTPServer
from distributedlpsolver_tpu_torch.net.registry import BackendRegistry
from distributedlpsolver_tpu_torch.net.router import Router, RouterConfig, RouterHTTPServer
from distributedlpsolver_tpu_torch.obs import agg as tagg
from distributedlpsolver_tpu_torch.obs import report as treport
from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry
from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService
from distributedlpsolver_tpu_torch.utils import utilization as tutil
from distributedlpsolver_tpu_torch.utils.logging import stamp_record
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Child processes run torch single-threaded: the suite's workers already
# use every core, and a child's thread pool would only contend with them.
SINGLE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def telemetry(tmp_path_factory):
    """A serve log, request records, a metrics snapshot and a trace from
    the port's service, plus a solve log of its driver."""
    d = tmp_path_factory.mktemp("telemetry")
    paths = {k: str(d / f) for k, f in (
        ("serve_log", "serve.jsonl"), ("records", "records.jsonl"),
        ("metrics", "metrics.json"), ("trace", "serve.trace.json"),
        ("solve_log", "solve.jsonl"), ("profile", "profile.trace.json"))}
    reg = MetricsRegistry()
    cfg = ServiceConfig(batch=4, flush_s=0.01, log_jsonl=paths["serve_log"],
                        trace_path=paths["trace"])
    with SolveService(cfg, metrics=reg, device="cpu") as svc:
        futs = [svc.submit(p, tol=tol) for p, tol in
                tgen.sparse_request_stream(10, shapes=((6, 16), (8, 20)), seed=3)]
        futs += [svc.submit(tgen.random_dense_lp(8, 24, seed=k)) for k in range(6)]
        futs += [svc.submit(tgen.random_general_lp(6, 14, seed=1))]
        svc.drain(timeout=120)
        with open(paths["records"], "w") as fh:
            for f in futs:
                fh.write(json.dumps(stamp_record(f.result().record())) + "\n")
    with open(paths["metrics"], "w") as fh:
        json.dump(reg.snapshot(), fh)
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve

    solve(tgen.random_general_lp(10, 24, seed=2), backend=get_backend("cpu", device="cpu"),
          verbose=False, log_jsonl=paths["solve_log"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        a = torch.randn(64, 64, dtype=torch.float64)
        (a @ a.T).sum()
    prof.export_chrome_trace(paths["profile"])
    return paths


@pytest.mark.parametrize("files", [
    ("serve_log",), ("records",), ("metrics",), ("solve_log",),
    ("serve_log", "records", "metrics", "solve_log"),
])
def test_report_matches_the_jax_package(telemetry, files):
    paths = [telemetry[f] for f in files]
    ref = jreport.report_from_paths(paths)
    port = treport.report_from_paths(paths)
    assert port == ref
    assert treport.render(port) == jreport.render(ref)


def test_trace_merge_matches_the_jax_package(telemetry):
    sources = [("serve", telemetry["trace"]), ("profile", telemetry["profile"]),
               ("missing", telemetry["trace"] + ".absent")]
    ref, port = jagg.merge_traces(sources), tagg.merge_traces(sources)
    assert port == ref
    assert tagg.trace_summary(port) == jagg.trace_summary(ref)
    assert len(port["traceEvents"]) > 10 and port["otherData"]["merge_errors"]


def test_prometheus_parse_matches(telemetry):
    reg = MetricsRegistry()
    reg.counter("net_requests_total", labels={"code": "200"}).inc(3)
    reg.histogram("serve_total_ms").observe(2.5)
    text = reg.prometheus_text() if hasattr(reg, "prometheus_text") else None
    if text is None:
        path = telemetry["metrics"] + ".prom"
        reg.write_prometheus(path)
        text = open(path).read()
    assert tagg.parse_prometheus(text) == jagg.parse_prometheus(text)


def test_fleet_view_over_a_live_plane_matches(tmp_path):
    reg_path = str(tmp_path / "registry.json")
    mreg = MetricsRegistry()
    svc = SolveService(ServiceConfig(batch=4, flush_s=0.01, journal_dir=str(tmp_path / "j")),
                       metrics=mreg, device="cpu")
    front = SolveHTTPServer(svc, NetConfig(), metrics=mreg).start()
    BackendRegistry(reg_path, metrics=MetricsRegistry()).register(front.url)
    router = Router([], RouterConfig(poll_s=0.1, registry_path=reg_path),
                    metrics=MetricsRegistry()).start()
    rhttp = RouterHTTPServer(router).start()
    try:
        import urllib.request

        for k in range(4):
            req = urllib.request.Request(
                rhttp.url + "/v1/solve", data=json.dumps({"m": 8, "n": 24, "seed": k}).encode(),
                headers={"Content-Type": "application/json"})
            assert urllib.request.urlopen(req, timeout=60).status == 200
        views = [mod.fleet_view(registry_path=reg_path, routers=[rhttp.url])[0]
                 for mod in (jagg, tagg)]
    finally:
        rhttp.shutdown()
        router.shutdown()
        front.shutdown()
        svc.shutdown()
    strip = ("uptime_s", "idle", "latency", "ms", "age", "ts", "rps", "_s")

    def stable(doc):
        if isinstance(doc, dict):
            return {k: stable(v) for k, v in doc.items()
                    if not any(k.endswith(s) or k.startswith(s) for s in strip)}
        if isinstance(doc, list):
            return [stable(v) for v in doc]
        return doc

    assert stable(views[1]["reconciliation"]) == stable(views[0]["reconciliation"])
    assert views[1]["reconciliation"]["consistent"] is True
    assert set(views[1]) == set(views[0])
    assert views[1]["rollup"]["totals"]["backends"] == views[0]["rollup"]["totals"]["backends"] == 1
    assert tagg.render_text(views[1]).splitlines()[0] == jagg.render_text(views[0]).splitlines()[0]


def test_utilization_folds_against_the_h100_peaks():
    rows = [{"phase": 0, "mode": "f64", "iters": 20, "wall_s": 0.5},
            {"phase": 1, "mode": "f32", "iters": 10, "wall_s": 0.1},
            {"phase": 2, "mode": "pcg", "iters": 5, "wall_s": 0.2}]
    port = tutil.fold_utilization([dict(r) for r in rows], 2e9)
    ref = jutil.fold_utilization([dict(r) for r in rows], 2e9)
    for p, r in zip(port, ref):
        # The seed-rate share is the same budget; the peak is the card's.
        assert p.get("eff_flops_per_s") == r.get("eff_flops_per_s")
        assert p.get("pct_of_seed_rate") == r.get("pct_of_seed_rate")
    assert port[0]["pct_of_chip_peak"] == round(100 * 2e9 * 20 / 0.5 / 67e12, 2)
    assert port[1]["pct_of_chip_peak"] == round(100 * 2e9 * 10 / 0.1 / 67e12, 2)
    assert "pct_of_chip_peak" not in port[2] and "chip_peak_basis" not in port[0]


def test_port_probe_trace_passes_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "port_probe_trace.py"), "--device", "cpu",
         "--budget-s", "120"],
        capture_output=True, text=True, timeout=180, cwd=ROOT, env={**os.environ, **SINGLE_THREAD},
    )
    tail = "\n".join(proc.stdout.splitlines()[-30:])
    assert proc.returncode == 0, f"{tail}\n{proc.stderr[-2000:]}"
    assert "PASS" in proc.stdout
