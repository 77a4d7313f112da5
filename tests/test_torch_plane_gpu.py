"""The network plane on the card: the torch health probe touches the
card, a ``cli serve-http`` backend serves a request from a bucket program
with K1's launches counted in its ``/statusz``, and ``--device cuda``
without a card raises instead of serving from the CPU.

Marked ``gpu``: the tests that need the card ask the ``cuda`` fixture,
which skips them where there is none. Run on a machine with a card with
``python -m pytest tests/test_torch_plane_gpu.py -m gpu``.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from distributedlpsolver_tpu_torch import cli
from distributedlpsolver_tpu_torch.net import NetConfig, SolveHTTPServer
from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService
from distributedlpsolver_tpu_torch.utils import accel

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except (urllib.error.URLError, OSError):
        return 599, {}


def test_the_health_probe_touches_the_card(cuda):
    assert accel.probe_device(cuda, deadline=10.0)
    healthy, unhealthy = accel.probe_devices([cuda], deadline=10.0)
    assert [d.type for d in healthy] == ["cuda"] and unhealthy == []
    svc = SolveService(ServiceConfig(batch=4, flush_s=0.01))
    front = SolveHTTPServer(svc, NetConfig()).start()
    try:
        code, h = _get(front.url + "/healthz")
        assert code == 200 and h["devices_healthy"] == 1 and h["device"].startswith("cuda")
    finally:
        front.shutdown()
        svc.shutdown()


def test_a_serve_http_backend_serves_from_a_bucket_program_with_k1_counted(cuda, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ladder = tmp_path / "ladder.json"
    ladder.write_text(json.dumps([{"m": 16, "n": 48, "batch": 4}]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "serve-http", "--port",
         str(port), "--buckets", str(ladder), "--warm-buckets", "--flush-ms", "10"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 300
        while _get(url + "/healthz")[0] != 200:
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        body = json.dumps({"m": 12, "n": 40, "seed": 3}).encode()
        req = urllib.request.Request(url + "/v1/solve", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        assert out["status"] == "optimal" and out["bucket"] == [16, 48, 4]
        code, st = _get(url + "/statusz")
        tot = st["stats"]["dispatch_totals"]
        assert st["stats"]["device"].startswith("cuda")
        assert tot["launches"] == 2 + tot["bodies"] and tot["launches"] > 2
        assert tot["captures"] == 0  # the warm-up captured the bucket's graph
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()


def test_device_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolveService(ServiceConfig(batch=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve-http", "--port", "0"])
