"""The torch package's CLI beyond ``solve``/``serve`` against the JAX
package's, on the CPU: each new subcommand's ``--json`` output carries the
reference's keys, files agree where both write them, every command that
touches a device takes ``--device`` (default ``cuda``, no fallback),
``serve-slice`` refuses several devices a rank, and ``check`` gates a bad
graftcheck fixture and passes its clean twin."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from distributedlpsolver_tpu import cli as jcli
from distributedlpsolver_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "maximize.mps")
# Child processes run torch single-threaded: the suite's workers already
# use every core, and a child's thread pool would only contend with them.
SINGLE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def _json_out(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cmd", ["serve-slice", "check"])
def test_unported_commands_name_their_items(cmd, capsys):
    """Both commands this test once found unported now run. ``serve-slice``
    (item 13) serves in ``test_torch_slice.py``; here its supervisor
    refuses several devices a rank before it launches anything, as a torch
    world runs one process per device. ``check`` (item 15) exits 1 on a
    bad graftcheck fixture and 0 on its clean twin
    (``test_torch_graftcheck.py`` holds it to the JAX package's)."""
    if cmd == "serve-slice":
        with pytest.raises(ValueError, match="one process per device"):
            cli.main([cmd, "--world-size", "2", "--local-devices", "2"])
        return
    fixtures = os.path.join(ROOT, "tests", "graftcheck_fixtures")
    assert cli.main([cmd, os.path.join(fixtures, "fx_jit_bad.py")]) == 1
    assert "jit-nonhoisted" in capsys.readouterr().out
    assert cli.main([cmd, os.path.join(fixtures, "fx_jit_clean.py")]) == 0
    assert capsys.readouterr().out.strip() == "graftcheck: 0 finding(s), 0 suppressed"


@pytest.mark.parametrize("kind", ["scenario"])
def test_generate_of_unported_generators_names_item_11(kind, tmp_path, capsys):
    """The generator this test once found unported (item 11, now ported):
    ``generate scenario`` at its defaults writes the JAX CLI's file byte
    for byte."""
    a, b = tmp_path / "port.mps", tmp_path / "ref.mps"
    assert cli.main(["generate", kind, str(a)]) == 0
    assert jcli.main(["generate", kind, str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("kind, m, n, extra", [
    ("dense", 6, 15, []), ("general", 7, 12, []),
    ("block", 5, 11, ["--blocks", "3", "--link", "4"]),
    ("scenario", 6, 10, ["--scenarios", "5"]),
])
def test_generate_writes_the_reference_file(kind, m, n, extra, tmp_path, capsys):
    a, b = tmp_path / "port.mps", tmp_path / "ref.mps"
    argv = ["--m", str(m), "--n", str(n), "--seed", "4"] + extra
    assert cli.main(["generate", kind, str(a)] + argv) == 0
    assert jcli.main(["generate", kind, str(b)] + argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(a), "X") == out[1].replace(str(b), "X")
    assert a.read_text() == b.read_text()


@pytest.mark.parametrize("cmd", ["solve", "serve", "serve-http", "elastic"])
def test_device_defaults_to_the_card(cmd):
    import argparse

    seen = {}

    def grab(args):
        seen.update(vars(args))
        return 0

    argv = {"solve": ["solve", FIXTURE], "serve": ["serve", "--requests", "-"],
            "serve-http": ["serve-http"], "elastic": ["elastic", "--registry", "r.json"]}[cmd]
    orig = argparse.ArgumentParser.parse_known_args

    def parse(self, args=None, namespace=None):
        ns, extra = orig(self, args, namespace)
        ns.fn = grab
        return ns, extra

    argparse.ArgumentParser.parse_known_args = parse
    try:
        cli.main(argv)
    finally:
        argparse.ArgumentParser.parse_known_args = orig
    assert seen["device"] == "cuda"


def test_solve_supervise_json_has_the_reference_keys(capsys, tmp_path):
    rc = cli.main(["solve", FIXTURE, "--device", "cpu", "--json", "--quiet", "--supervise",
                   "--step-timeout", "30", "--max-retries", "2",
                   "--metrics-path", str(tmp_path / "m.prom"),
                   "--trace-path", str(tmp_path / "t.json")])
    port = _json_out(capsys)
    rc_j = jcli.main(["solve", FIXTURE, "--json", "--quiet", "--supervise", "--step-timeout", "30",
                      "--max-retries", "2"])
    ref = _json_out(capsys)
    assert rc == rc_j == 0
    assert set(port) == set(ref)
    assert port["status"] == ref["status"] == "optimal"
    assert abs(port["objective"] - ref["objective"]) <= 1e-8 * (1 + abs(ref["objective"]))
    assert "ipm_iterations_total" in (tmp_path / "m.prom").read_text() or \
        (tmp_path / "m.prom").stat().st_size > 0
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]


def test_solve_profile_dir_writes_a_chrome_trace(tmp_path, capsys):
    d = tmp_path / "prof"
    rc = cli.main(["solve", FIXTURE, "--device", "cpu", "--backend", "cuda", "--json", "--quiet",
                   "--profile-dir", str(d)])
    assert rc == 0 and _json_out(capsys)["status"] == "optimal"
    traces = [f for f in os.listdir(d) if f.endswith(".json")]
    assert traces and json.load(open(d / traces[0]))["traceEvents"]


def test_report_and_autotune_json_have_the_reference_keys(tmp_path, capsys):
    log = tmp_path / "serve.jsonl"
    req = tmp_path / "req.jsonl"
    req.write_text("".join(json.dumps({"m": m, "n": n, "seed": k}) + "\n"
                           for k, (m, n) in enumerate([(6, 16), (8, 20), (12, 30)] * 3)))
    assert cli.main(["serve", "--requests", str(req), "--device", "cpu", "--batch", "4",
                     "--flush-ms", "5", "--log-jsonl", str(log)]) == 0
    capsys.readouterr()
    assert cli.main(["report", str(log), "--json"]) == 0
    port = _json_out(capsys)
    assert jcli.main(["report", str(log), "--json"]) == 0
    ref = _json_out(capsys)
    assert port == ref
    outs = []
    for c in (cli, jcli):
        assert c.main(["autotune", "--telemetry", str(log), "--out",
                       str(tmp_path / f"{c.__name__}.json"), "--batch", "4"]) == 0
        outs.append(_json_out(capsys))
    assert outs[0] == outs[1]
    assert (tmp_path / f"{cli.__name__}.json").read_text() == \
        (tmp_path / f"{jcli.__name__}.json").read_text()


def test_route_needs_backends_or_a_registry(capsys):
    assert cli.main(["route"]) == jcli.main(["route"]) == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except (urllib.error.URLError, OSError):
        return 599, {}


def test_serve_http_and_obs_agg_answer_with_the_reference_keys(tmp_path, capsys):
    """One ``cli serve-http --device cpu`` process of each package: the same
    keys on /healthz, /readyz, /statusz and a solve; then each package's
    ``cli obs-agg --json`` over the port's backend gives the same keys."""
    procs, urls = {}, {}
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **SINGLE_THREAD}
    for pkg in ("distributedlpsolver_tpu", "distributedlpsolver_tpu_torch"):
        port = _free_port()
        cmd = [sys.executable, "-m", f"{pkg}.cli", "serve-http", "--port", str(port),
               "--batch", "4", "--flush-ms", "10"]
        if pkg.endswith("torch"):
            cmd += ["--device", "cpu"]
        procs[pkg] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL)
        urls[pkg] = f"http://127.0.0.1:{port}"
    try:
        for pkg, url in urls.items():
            deadline = time.monotonic() + 120
            while _get(url + "/healthz")[0] != 200:
                assert procs[pkg].poll() is None and time.monotonic() < deadline, pkg
                time.sleep(0.1)
        got = {}
        for pkg, url in urls.items():
            body = json.dumps({"m": 8, "n": 24, "seed": 1}).encode()
            req = urllib.request.Request(url + "/v1/solve", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                solve = json.loads(r.read())
            got[pkg] = {p: _get(url + p) for p in ("/healthz", "/readyz", "/statusz")}
            got[pkg]["solve"] = (200, solve)
        ref, port = got["distributedlpsolver_tpu"], got["distributedlpsolver_tpu_torch"]
        for k in ref:
            assert port[k][0] == ref[k][0], k
            missing = set(ref[k][1]) - set(port[k][1])
            assert not missing, (k, missing)
        assert port["/healthz"][1]["devices_healthy"] == 1
        assert set(ref["/statusz"][1]["stats"]) <= set(port["/statusz"][1]["stats"])
        assert port["solve"][1]["status"] == ref["solve"][1]["status"] == "optimal"
        o, r = port["solve"][1]["objective"], ref["solve"][1]["objective"]
        assert abs(o - r) <= 1e-8 * (1 + abs(r))
        capsys.readouterr()
        turl = urls["distributedlpsolver_tpu_torch"]
        agg = []
        for c in (cli, jcli):
            assert c.main(["obs-agg", "--backend", turl, "--json"]) == 0
            agg.append(_json_out(capsys))
        assert set(agg[0]) == set(agg[1])
        assert agg[0]["reconciliation"]["consistent"] is True
    finally:
        for p in procs.values():
            p.terminate()
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
