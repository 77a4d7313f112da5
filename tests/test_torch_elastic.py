"""The torch package's autoscaler (``serve/elastic.py``) against the JAX
package's, on the CPU.

* Both ``ElasticController``s, fed the same seeded telemetry (queue load,
  reject rate, brownout stage, p99, pool liveness) on the same clock, move
  the same targets, spawn and drain for the same reasons and emit the same
  ``scale_out`` / ``scale_in`` / ``scale_veto`` events.
* ``cli elastic --device cpu --min-backends 1 --max-backends 2`` spawns a
  real ``cli serve-http --device cpu`` backend, scales out to two under a
  burst and back in to one when the burst ends; its spawned backends carry
  ``--device``.
"""

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

from distributedlpsolver_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from distributedlpsolver_tpu.serve import elastic as jel
from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry
from distributedlpsolver_tpu_torch.serve import elastic as tel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jel, JaxRegistry), "torch": (tel, MetricsRegistry)}
# Child processes run torch single-threaded: the suite's workers already
# use every core, and a child's thread pool would only contend with them.
SINGLE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def _decisions(pkg, seed, tmp_path, **cfg):
    mod, Registry = PKGS[pkg]
    log = tmp_path / f"{pkg}-{seed}.jsonl"
    kw = dict(registry_path=str(tmp_path / f"{pkg}-reg.json"), min_backends=1, max_backends=4,
              out_sustain_s=1.0, in_sustain_s=2.0, cooldown_s=1.5, flap_window_s=10.0,
              flap_max_actions=3, load_high=8.0, load_low=1.0, p99_high_ms=800.0,
              workdir=str(tmp_path), log_jsonl=str(log))
    kw.update(cfg)
    ctl = mod.ElasticController(mod.ElasticConfig(**kw), metrics=Registry())
    rng = np.random.default_rng(seed)
    pool = {"n": 1}
    calls = []

    def spawn(reason):
        calls.append(("spawn", reason))
        pool["n"] += 1

    def shrink(reason):
        calls.append(("drain", reason))
        pool["n"] -= 1

    ctl._spawn_one, ctl._shrink_one, ctl._reap = spawn, shrink, lambda: None
    ctl._last_action = -1e9
    t = 1000.0
    trail = []
    for step in range(80):
        t += 0.5
        phase = (step // 20) % 4  # ramp up, hold, ramp down, idle
        load = {0: 12.0, 1: 6.0, 2: 0.5, 3: 0.2}[phase] + float(rng.normal(0, 1.0))
        if rng.random() < 0.05 and pool["n"] > 1:
            pool["n"] -= 1  # a member died (kill -9)
        obs = dict(now=t, n_live=pool["n"], n_ready=pool["n"], mean_load=max(load, 0.0),
                   reject_rate=float(rng.random() < 0.1) * 2.0 if phase == 0 else 0.0,
                   brownout_stage=int(phase == 1 and rng.random() < 0.2),
                   p99_ms=float(rng.uniform(100, 1200)))
        ctl._observe = lambda obs=obs: obs
        ctl.step()
        trail.append((ctl.target(), pool["n"]))
    snap = ctl.metrics.snapshot()
    events = [{k: v for k, v in json.loads(ln).items() if k not in ("ts", "t_mono")}
              for ln in open(log)]
    return trail, calls, events, {k: v for k, v in snap.items() if k.startswith("elastic_")}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scale_decisions_match_the_jax_package(seed, tmp_path):
    ref = _decisions("jax", seed, tmp_path)
    port = _decisions("torch", seed, tmp_path)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    kinds = {e["event"] for e in ref[2]}
    assert {"scale_out", "scale_in"} <= kinds or "scale_veto" in kinds


def test_signal_reasons_match(tmp_path):
    out = {}
    for pkg, (mod, Registry) in PKGS.items():
        ctl = mod.ElasticController(mod.ElasticConfig(
            registry_path=str(tmp_path / f"{pkg}.json"), workdir=str(tmp_path),
            p99_high_ms=500.0), metrics=Registry())
        base = dict(now=0.0, n_live=1, n_ready=1, mean_load=2.0, reject_rate=0.0,
                    brownout_stage=0, p99_ms=None)
        cases = [dict(brownout_stage=2), dict(reject_rate=5.0), dict(mean_load=99.0),
                 dict(mean_load=99.0, n_ready=0), dict(p99_ms=900.0), dict(p99_ms=100.0), {}]
        out[pkg] = [ctl._signal_reason({**base, **c}) for c in cases]
    assert out["torch"] == out["jax"]


def test_inverted_bounds_are_refused(tmp_path):
    with pytest.raises(ValueError):
        tel.ElasticController(tel.ElasticConfig(registry_path=str(tmp_path / "r.json"),
                                                min_backends=3, max_backends=1),
                              metrics=MetricsRegistry())


def _events(path):
    try:
        return [json.loads(ln) for ln in open(path) if ln.strip()]
    except OSError:
        return []


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


def test_cli_elastic_scales_out_under_a_burst_and_back_in(tmp_path):
    reg = tmp_path / "registry.json"
    log = tmp_path / "elastic.jsonl"
    ladder = tmp_path / "ladder.json"
    ladder.write_text(json.dumps([{"m": 8, "n": 24, "batch": 4}]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "elastic", "--device", "cpu",
         "--registry", str(reg), "--min-backends", "1", "--max-backends", "2",
         "--poll-s", "0.2", "--load-high", "3", "--load-low", "1.0", "--out-sustain-s", "0.2",
         "--in-sustain-s", "1.0", "--cooldown-s", "0.5", "--workdir", str(tmp_path),
         "--buckets", str(ladder), "--backend-flag", "--flush-ms 200 --batch 4 --queue-depth 24",
         "--log-jsonl", str(log)],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env={**os.environ, **SINGLE_THREAD},
    )
    stop = threading.Event()
    try:
        def live_urls():
            try:
                doc = json.loads(reg.read_text())
            except (OSError, ValueError):
                return []
            return [u for u, e in doc.get("backends", {}).items() if not e.get("ejected")]

        _wait(lambda: len(live_urls()) >= 1, 90, "the first backend never registered")
        url = live_urls()[0].rstrip("/")

        def flood():
            k = 0
            while not stop.is_set():
                body = json.dumps({"m": 8, "n": 24, "seed": k, "async": True}).encode()
                req = urllib.request.Request(url + "/v1/solve", data=body,
                                             headers={"Content-Type": "application/json"})
                try:
                    urllib.request.urlopen(req, timeout=5).read()
                except (urllib.error.URLError, OSError):
                    pass
                k += 1

        threads = [threading.Thread(target=flood, daemon=True) for _ in range(4)]
        for t in threads:
            t.start()
        _wait(lambda: any(e["event"] == "scale_out" for e in _events(log)), 90, "no scale-out")
        _wait(lambda: len(live_urls()) >= 2, 90, "the second backend never registered")
        stop.set()
        for t in threads:
            t.join(timeout=10)
        _wait(lambda: any(e["event"] == "scale_in" for e in _events(log)), 120, "no scale-in")
    finally:
        stop.set()
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    outs = [e["reason"] for e in _events(log) if e["event"] == "scale_out"]
    assert outs[:2] == ["min_backends", "queue_depth"]
    ins = [e["reason"] for e in _events(log) if e["event"] == "scale_in"]
    assert ins[0] == "idle"
    logs = [p for p in os.listdir(tmp_path) if p.startswith("elastic-be") and p.endswith(".log")]
    assert len(logs) >= 2
