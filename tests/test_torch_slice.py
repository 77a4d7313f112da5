"""The serving slice of the torch package (``distributed/slice.py``,
``cli serve-slice``) against the JAX package's, on the CPU.

The dispatch journal (ordering, atomic records, stop records, a lagging
reader's replay), ``execute_dispatch`` against the one-device bucket
engines, the slice runner behind a SolveService with a follower replaying
its journal, the ``bucket_probe`` world task over a gloo world of 2 (the
twin of the JAX package's ``tests/test_multihost.py::
test_bucket_zero_warm_recompile_across_processes``), ``cli serve-slice``
through a rank kill and the world's relaunch, and the twin of
``test_record_preserves_slice_fields``.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from distributedlpsolver_tpu.backends import batched as jbatched
from distributedlpsolver_tpu.ipm.config import SolverConfig as JaxConfig
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu_torch.backends import batched as tb
from distributedlpsolver_tpu_torch.backends import first_order as tfo
from distributedlpsolver_tpu_torch.distributed import slice as slice_lib
from distributedlpsolver_tpu_torch.distributed import world as world_lib
from distributedlpsolver_tpu_torch.distributed.launcher import free_port, run_world
from distributedlpsolver_tpu_torch.ipm import SolverConfig, Status
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models import random_request_stream
from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


@pytest.fixture
def world_of_one():
    """A world of this process alone, with no process group (CPU)."""
    w = world_lib.init_world(world_lib.WorldConfig(world_size=1, device="cpu"))
    try:
        yield w
    finally:
        w.close()


# -- the dispatch journal ------------------------------------------------------------


def test_control_plane_orders_replays_and_stops(tmp_path):
    cp = slice_lib.FileControlPlane(str(tmp_path / "ctrl"), poll_s=0.001)
    a = {"x": np.arange(6.0).reshape(2, 3), "m": np.array([True, False])}
    assert cp.publish({"kind": slice_lib.KIND_BUCKET, "n": 1}, a) == 0
    assert cp.publish({"kind": slice_lib.KIND_BUCKET, "n": 2}) == 1
    assert cp.publish_stop() == 2
    # Atomic renames: only finished records, no temporaries.
    assert sorted(os.listdir(cp.path)) == ["d00000000.npz", "d00000001.npz", "d00000002.npz"]
    # A reader that starts late (a lagging follower) replays the exact order.
    reader = slice_lib.FileControlPlane(cp.path, poll_s=0.001)
    seq, meta, arrays = reader.next_dispatch(-1)
    assert (seq, meta["n"]) == (0, 1)
    np.testing.assert_array_equal(arrays["x"], a["x"])
    assert arrays["m"].dtype == bool and arrays["m"].tolist() == [True, False]
    assert reader.next_dispatch(0)[1]["n"] == 2
    assert reader.next_dispatch(1)[1]["kind"] == slice_lib.KIND_STOP
    t0 = time.monotonic()
    assert reader.next_dispatch(2, timeout_s=0.05) is None
    assert time.monotonic() - t0 < 5.0


def test_canonical_config_drops_per_process_paths():
    cfg = slice_lib.canonical_bucket_config(SolverConfig(
        log_jsonl="/a", checkpoint_path="/b", checkpoint_every=3, verbose=True))
    assert (cfg.log_jsonl, cfg.checkpoint_path, cfg.checkpoint_every, cfg.verbose) == (
        None, None, 0, False)


@pytest.mark.parametrize("engine", ["ipm", "pdhg"])
def test_execute_dispatch_equals_the_bucket_engines(world_of_one, engine):
    B, m, n = 8, 10, 30
    batch = tgen.random_batched_lp(B, m, n, seed=4)
    active = np.array([True] * 6 + [False] * 2)
    tol = 1e-4 if engine == "pdhg" else 1e-8
    arrays = {"c": batch.c, "A": batch.A, "b": batch.b, "active": active}
    meta = {"kind": slice_lib.KIND_BUCKET, "tol": tol, "engine": engine, "max_iter": 0}
    cfg = SolverConfig()
    if engine == "pdhg":
        seeds = np.array([tfo.pdhg_seed(f"r{k}", B) for k in range(6)] + [6, 7])
        arrays["seeds"] = seeds
        ref = tfo.solve_pdhg_bucket(batch, active, cfg.replace(tol=tol), device="cpu", seeds=seeds)
    else:
        ref = tb.solve_bucket(batch, active, cfg.replace(tol=tol), device="cpu")
    r = slice_lib.execute_dispatch(world_of_one.mesh("batch"), cfg, meta, arrays)
    np.testing.assert_array_equal(r.x, ref.x)
    assert [s.value for s in r.status] == [s.value for s in ref.status]
    np.testing.assert_array_equal(r.iterations, ref.iterations)


def test_a_service_on_a_slice_runner_publishes_every_dispatch(world_of_one, tmp_path):
    """The service hands each dispatch (its cold-bucket warm-up too) to
    the runner, which publishes it before it executes; a follower
    replaying the journal executes the same dispatches, to the stop."""
    ctrl = str(tmp_path / "ctrl")
    runner = slice_lib.SliceRunner(world_of_one, slice_lib.FileControlPlane(ctrl),
                                   SolverConfig(verbose=True, log_jsonl=str(tmp_path / "x")))
    assert runner.solver_config.log_jsonl is None
    problems = list(random_request_stream(6, shapes=((8, 24),), seed=5))
    with SolveService(ServiceConfig(batch=4, flush_s=0.01), slice_runner=runner) as svc:
        assert svc.device.type == "cpu" and svc.mesh_devices == 1
        rs = [f.result(timeout=120) for f in [svc.submit(p) for p in problems]]
        assert svc.drain(timeout=120)
    assert all(r.status is Status.OPTIMAL for r in rs)
    assert runner.dispatches >= 2  # the warm-up and at least one real dispatch
    runner.stop()
    box = {}
    th = threading.Thread(target=lambda: box.update(n=slice_lib.follower_loop(
        world_of_one, slice_lib.FileControlPlane(ctrl), SolverConfig(), idle_timeout_s=60)))
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and box["n"] == runner.dispatches


# -- bucket_probe over a gloo world of 2 ----------------------------------------------


def test_bucket_zero_warm_recompile_across_processes(tmp_path):
    """Two dispatches of a warm bucket over a world of 2 build nothing the
    second time on any rank; the cache sizes agree world-wide; each rank
    solved its block of 4 lanes and both hold the whole bucket's bits,
    the one-process engine's; objectives at the JAX package's within
    1e-8."""
    res = run_world("bucket_probe", {"m": 8, "n": 24, "batch": 8, "tol": 1e-8}, world_size=2,
                    workdir=str(tmp_path / "bw"), device="cpu", timeout=240)
    cfg = SolverConfig(tol=1e-8, verbose=False)
    ref = [tb.solve_bucket(tgen.random_batched_lp(8, 8, 24, seed=s), np.ones(8, bool), cfg,
                           device="cpu") for s in (7, 8)]
    local = jbatched.solve_bucket(jgen.random_batched_lp(8, 8, 24, seed=7), np.ones(8, bool),
                                  JaxConfig(tol=1e-8, verbose=False))
    for rank, out in res.items():
        assert out["warm_recompiles"] == 0, (rank, out)
        assert len(set(out["bucket_cache_sizes"])) == 1
        assert out["lane_block"] == [4 * rank, 4 * rank + 4]
        np.testing.assert_allclose(out["objectives_first"], local.objective, rtol=1e-8,
                                   atol=1e-10)
        for d, r in zip(out["dispatches"], ref):
            assert d["status"] == [s.value for s in r.status]
            assert d["iterations"] == r.iterations.tolist()
            assert d["x_lane_sha256"] == [hashlib.sha256(np.ascontiguousarray(x).tobytes())
                                          .hexdigest() for x in r.x]
        first, second = out["dispatches"]
        assert first["programs_built"] == 1 and second["programs_built"] == 0
        assert second["graphs_captured"] == 0 and second["phase_report"]["executors"] == 2
    assert res[0]["dispatches"][1]["x_sha256"] == res[1]["dispatches"][1]["x_sha256"]


# -- cli serve-slice through a kill and a relaunch -------------------------------------


def _http(url, body=None, timeout=30.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except (urllib.error.URLError, OSError) as e:
        return 599, {"error": str(e)}


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


def test_serve_slice_survives_a_rank_kill(tmp_path):
    """``cli serve-slice --world-size 2`` on the CPU: answers through HTTP
    (each dispatch published and solved by both ranks), then a SIGKILL
    of rank 1 with acknowledged async requests: the world dies as a unit,
    the supervisor relaunches a world of one on the same port and
    journal and records ``world_reinit``; every acknowledged id resolves
    and no request is solved twice."""
    from distributedlpsolver_tpu_torch.net import chaos

    port = free_port()
    work, journal = tmp_path / "work", tmp_path / "journal"
    cmd = [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "serve-slice",
           "--world-size", "2", "--device", "cpu", "--pg-backend", "gloo", "--port", str(port),
           "--slice-workdir", str(work), "--journal-dir", str(journal), "--batch", "4",
           "--flush-ms", "5", "--registry", str(tmp_path / "reg.json"), "--slice-id", "s1"]
    env = {**os.environ, **SINGLE_THREAD}
    log = open(tmp_path / "sup.log", "w")
    sup = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    url = f"http://127.0.0.1:{port}"
    try:
        _wait(lambda: _http(url + "/healthz", timeout=2)[0] == 200, 120, "the slice came up")
        for k in range(3):
            code, out = _http(url + "/v1/solve", {"m": 8, "n": 24, "seed": k}, timeout=60)
            assert code == 200 and out["status"] == "optimal", out
        ctrl = [f for f in os.listdir(work / "ctrl-gen0") if f.endswith(".npz")]
        assert len(ctrl) >= 2  # the warm-up and the dispatches, published to rank 1
        ids = []
        for k in range(8):
            code, out = _http(url + "/v1/solve", {"m": 8, "n": 24, "seed": 20 + k, "async": True})
            assert code == 202, out
            ids.append(out["id"])
        pid = json.loads((work / "hb-gen0" / "rank1.hb").read_text())["pid"]
        os.kill(pid, signal.SIGKILL)
        _wait(lambda: (work / "world.jsonl").exists(), 120, "world_reinit")
        _wait(lambda: _http(url + "/healthz", timeout=2)[0] == 200, 120, "the relaunch came up")
        reinit = [json.loads(ln) for ln in (work / "world.jsonl").read_text().splitlines()]
        assert reinit[0]["event"] == "world_reinit" and reinit[0]["world_size"] == 1
        assert reinit[0]["generation"] == 1 and reinit[0]["recovery_overhead_s"] > 0
        for jid in ids:
            def done():
                code, out = _http(f"{url}/v1/solve/{jid}", timeout=10)
                return code == 200 and out.get("status") in ("optimal", "timeout")

            _wait(done, 120, f"{jid} resolved")
        assert chaos.journal_duplicate_solves(str(journal)) == 0
        reg = json.loads((tmp_path / "reg.json").read_text())["backends"]
        assert reg[url]["slice_id"] == "s1" and reg[url]["world_size"] == 1
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


def test_record_preserves_slice_fields(tmp_path):
    """A router observation push must not wipe the serving-side fields
    (slice_id / world_size / last_heartbeat_ts)."""
    from distributedlpsolver_tpu_torch.net.registry import BackendRegistry

    reg = BackendRegistry(str(tmp_path / "reg.json"))
    url = "http://127.0.0.1:2"
    reg.register(url, slice_id="sY", world_size=4)
    assert reg.record(url, ejected=True, fails=3, observed_ts=time.time() + 1)
    entry = reg.load()["backends"][url]
    assert entry["ejected"] is True
    assert entry["slice_id"] == "sY" and entry["world_size"] == 4
    assert entry["last_heartbeat_ts"] > 0
