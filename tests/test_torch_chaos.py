"""The torch package's crash-safe fabric (``net/chaos.py``,
``net/registry.py``) against the JAX package's, on the CPU.

* The seeded fault schedule, the load ramp, the duplicate-solve count of
  a journal and the shared registry's consistency rules are the same.
* Spawn, kill and relaunch: a ``cli serve-http --device cpu`` backend
  acknowledges async requests, is killed with SIGKILL mid-wave and
  relaunched with its command line; every id resolves ``optimal`` or
  ``timeout`` (never 404) and the journal holds zero duplicate solves.
* ``scripts/port_probe_chaos.py --device cpu`` passes (the reference
  probe's seeded schedule over 2 routers + 2 backends).
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from distributedlpsolver_tpu.net import chaos as jchaos
from distributedlpsolver_tpu.net.registry import BackendRegistry as JaxRegistryFile
from distributedlpsolver_tpu.obs.metrics import MetricsRegistry as JaxMetrics
from distributedlpsolver_tpu_torch.net import chaos as tchaos
from distributedlpsolver_tpu_torch.net.registry import BackendRegistry
from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Child processes run torch single-threaded: the suite's workers already
# use every core, and a child's thread pool would only contend with them.
SINGLE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


@pytest.mark.parametrize("seed", [0, 11, 12345])
def test_seeded_schedules_match(seed):
    ref = [(e.at_frac, e.kind, e.target) for e in jchaos.ChaosSchedule.seeded(seed).events]
    port = [(e.at_frac, e.kind, e.target) for e in tchaos.ChaosSchedule.seeded(seed).events]
    assert port == ref and len(ref) == 6
    sj, st = jchaos.ChaosSchedule.seeded(seed), tchaos.ChaosSchedule.seeded(seed)
    for frac in (0.05, 0.3, 0.6, 1.0):
        assert [e.kind for e in st.due(frac)] == [e.kind for e in sj.due(frac)]


def test_load_ramps_match():
    kw = dict(total=120, peak_rps=20.0, base_rps=2.0, up_frac=0.3, down_frac=0.25)
    rj, rt = jchaos.LoadRamp(**kw), tchaos.LoadRamp(**kw)
    assert [rt.rps_at(f / 20) for f in range(21)] == [rj.rps_at(f / 20) for f in range(21)]
    assert [rt.gap_s(i) for i in range(0, 120, 7)] == [rj.gap_s(i) for i in range(0, 120, 7)]


def test_duplicate_solve_counts_match(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "journal.jsonl"), "w") as fh:
        for jid, n in (("jx-1", 1), ("jx-2", 3), ("jx-3", 2)):
            for _ in range(n):
                fh.write(json.dumps({"j": "finished", "jid": jid}) + "\n")
        fh.write("garbage-line\n")
    assert tchaos.journal_duplicate_solves(d) == jchaos.journal_duplicate_solves(d) == 3
    assert tchaos.journal_duplicate_solves(str(tmp_path / "absent")) == 0


def _registry_trail(Registry, Metrics, path):
    r1 = Registry(str(path), writer_id="r1", metrics=Metrics())
    r2 = Registry(str(path), writer_id="r2", metrics=Metrics())
    t = 1_000_000.0
    out = []
    r1.ensure(["http://b1:1/", "http://b2:2"])
    out.append(sorted(r1.load()["backends"]))
    out.append(r1.record("http://b1:1", ejected=True, fails=3, observed_ts=t, ejected_at_ts=t))
    out.append(r2.record("http://b1:1", ejected=False, fails=0, observed_ts=t - 5.0))
    out.append(r2.record("http://b1:1", ejected=False, fails=0, observed_ts=t))
    out.append(r2.record("http://b1:1", ejected=False, fails=0, observed_ts=t + 1.0))
    r1.register("http://b3:3")
    entry = r1.load()["backends"]
    out.append({u: (e["ejected"], e["fails"]) for u, e in sorted(entry.items())})
    return out


def test_registry_rules_match(tmp_path):
    ref = _registry_trail(JaxRegistryFile, JaxMetrics, tmp_path / "j.json")
    port = _registry_trail(BackendRegistry, MetricsRegistry, tmp_path / "t.json")
    assert port == ref


def _http(url, body=None, timeout=30.0):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except Exception:
            return e.code, {}
    except (urllib.error.URLError, OSError) as e:
        return 599, {"error": str(e)}


def test_spawn_kill_relaunch_resolves_every_id_without_duplicate_solves(tmp_path, monkeypatch):
    for k, v in SINGLE_THREAD.items():
        monkeypatch.setenv(k, v)
    plane = tchaos.ChaosPlane(str(tmp_path), device="cpu")
    ladder = tmp_path / "ladder.json"
    ladder.write_text(json.dumps([{"m": 8, "n": 24, "batch": 4}]))
    try:
        be = plane.spawn_backend("backend", buckets_json=str(ladder),
                                 extra_flags=["--flush-ms", "400", "--batch", "4"])
        assert "--device" in be.cmd and be.cmd[be.cmd.index("--device") + 1] == "cpu"
        assert plane.wait_ready(be, 120)
        ids = []
        for k in range(12):
            code, out = _http(be.url + "/v1/solve", {"m": 8, "n": 24, "seed": k, "async": True})
            assert code == 202
            ids.append(out["id"])
        plane.kill9("backend")  # mid-wave: some acknowledged work is unfinished
        plane.restart("backend")
        verdicts = {}
        deadline = time.monotonic() + 120
        while len(verdicts) < len(ids):
            assert time.monotonic() < deadline, f"unresolved: {set(ids) - set(verdicts)}"
            for rid in ids:
                if rid in verdicts:
                    continue
                code, out = _http(be.url + f"/v1/solve/{rid}")
                assert code != 404, rid
                if code in (200, 504) and "status" in out:
                    verdicts[rid] = out["status"]
            time.sleep(0.05)
        assert set(verdicts.values()) <= {"optimal", "timeout"}
        assert tchaos.journal_duplicate_solves(be.journal_dir) == 0
    finally:
        plane.shutdown_all()


def test_port_probe_chaos_passes_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "port_probe_chaos.py"), "--device", "cpu",
         "--requests", "120", "--budget-s", "200"],
        capture_output=True, text=True, timeout=260, cwd=ROOT, env={**os.environ, **SINGLE_THREAD},
    )
    tail = "\n".join(proc.stdout.splitlines()[-30:])
    assert proc.returncode == 0, f"{tail}\n{proc.stderr[-2000:]}"
    assert "PASS" in proc.stdout
