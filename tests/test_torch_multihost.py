"""The port's multi-process world runtime on the CPU: the twins of the
JAX package's ``tests/test_multihost.py`` (the sharded solve over 2 and
4 processes against the single-process solve, and a rank kill ending in
a relaunched smaller world that resumes from the checkpoint).

Worlds of gloo processes on the CPU, launched through the port's
launcher. Waits are polls with deadlines, never fixed sleeps; the rank
kill's solve is paced (``pace_s``) so that the kill lands mid-solve.
"""

import hashlib
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from distributedlpsolver_tpu.ipm import solve as jsolve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.distributed.launcher import (
    SupervisorConfig,
    WorldSupervisor,
    run_world,
    worker_argv,
)
from distributedlpsolver_tpu_torch.ipm import solve
from distributedlpsolver_tpu_torch.models import random_dense_lp

pytestmark = pytest.mark.multihost


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def _references(m, n, seed):
    """The port's single-process solve and the JAX package's dense one."""
    ref = solve(random_dense_lp(m, n, seed=seed), backend=get_backend("cuda", device="cpu"),
                tol=1e-8)
    jref = jsolve(jgen.random_dense_lp(m, n, seed=seed), backend="dense", tol=1e-8)
    assert ref.status.value == jref.status.value == "optimal"
    return ref, jref


@pytest.mark.parametrize("world_size", [2, 4])
def test_sharded_solve_matches_single_process(tmp_path, world_size):
    m, n, seed = 32, 96, 5
    ref, jref = _references(m, n, seed)
    res = run_world("sharded_solve", {"m": m, "n": n, "seed": seed, "tol": 1e-8},
                    world_size=world_size, workdir=str(tmp_path), device="cpu", timeout=240)
    assert set(res) == set(range(world_size))
    for rank, out in res.items():
        assert out["status"] == "optimal", (rank, out)
        assert out["world_size"] == out["global_devices"] == world_size
        assert _rel(out["objective"], ref.objective) <= 1e-8, (rank, out["objective"])
        assert _rel(out["objective"], jref.objective) <= 1e-8, (rank, out["objective"])
    # Every rank ran the same steps on the same bits.
    assert len({out["iterations"] for out in res.values()}) == 1
    assert len({out["x_sha256"] for out in res.values()}) == 1


def _latest_hb(workdir, rank):
    gens = sorted((d for d in os.listdir(workdir) if d.startswith("hb-gen")),
                  key=lambda d: int(d[6:]))
    for d in reversed(gens):
        p = os.path.join(workdir, d, f"rank{rank}.hb")
        if os.path.exists(p):
            return p
    return None


def test_rank_kill_world_reinit_checkpoint_resume(tmp_path):
    """SIGKILL one rank of a 3-rank world mid-solve: the world dies as a
    unit (the survivors see the closed connection and exit 43), and the
    supervisor relaunches a 2-rank world that resumes from the
    checkpoint written by the 3-rank one and finishes OPTIMAL at the
    reference objective; the world_reinit event carries
    recovery_overhead_s."""
    m, n, seed = 32, 96, 11
    ref, _ = _references(m, n, seed)
    workdir = str(tmp_path / "sup")
    ckpt = str(tmp_path / "state.ckpt.npz")
    spec = {"m": m, "n": n, "seed": seed, "tol": 1e-8, "checkpoint": ckpt,
            "checkpoint_every": 2, "pace_s": 0.25}
    out_dir = os.path.join(workdir, "out")
    sup = WorldSupervisor(
        lambda generation, world_size, port: worker_argv("sharded_solve", spec, out_dir),
        world_size=3, workdir=workdir, device="cpu",
        config=SupervisorConfig(min_world=1, max_reforms=2,
                                log_jsonl=os.path.join(workdir, "world.jsonl")),
    )
    box = {}

    def _run():
        try:
            box["results"] = sup.run(timeout=240)
        except Exception as e:  # surfaced by the main thread's asserts
            box["error"] = e

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not (os.path.exists(ckpt) and _latest_hb(workdir, 1)):
        time.sleep(0.05)
    assert os.path.exists(ckpt), "no checkpoint appeared before the deadline"
    killed = False
    while time.monotonic() < deadline and not killed:
        try:
            with open(_latest_hb(workdir, 1)) as fh:
                os.kill(json.load(fh)["pid"], signal.SIGKILL)
            killed = True
        except (ProcessLookupError, OSError, ValueError):
            time.sleep(0.05)
    assert killed, "could not kill a live rank-1 process"
    t.join(timeout=240)
    assert not t.is_alive(), "supervision did not finish before the deadline"
    assert "error" not in box, box.get("error")
    results = box["results"]
    assert sorted(results) == [0, 1]  # the completing world: 3 - 1 lost
    for rank, out in results.items():
        assert out["status"] == "optimal", (rank, out)
        assert out["world_size"] == 2 and out["generation"] == 1
        assert _rel(out["objective"], ref.objective) <= 1e-8
    assert len({out["x_sha256"] for out in results.values()}) == 1
    assert sup.reinit_events and all(
        e["event"] == "world_reinit" and e["recovery_overhead_s"] >= 0.0 and e["world_size"] == 2
        for e in sup.reinit_events)
    with open(os.path.join(workdir, "world.jsonl")) as fh:
        assert any(json.loads(ln)["event"] == "world_reinit" for ln in fh)
    # The relaunched world resumed from the checkpoint (iteration 2 or
    # later): it ran fewer iterations than a solve from the start.
    assert 0 < results[0]["iterations"] < ref.iterations


def test_unported_world_tasks_fail_naming_their_items(tmp_path):
    """No world task is left unported: every task the JAX package's worker
    registers is registered here, by the reference's name, and none is a
    stand-in that fails naming a ROADMAP item (``scenario_lanes`` runs in
    ``test_torch_scenario_mesh.py``, ``bucket_probe`` in
    ``test_torch_slice.py``, ``sparse_rows`` below)."""
    from distributedlpsolver_tpu.distributed import worker as jworker
    from distributedlpsolver_tpu_torch.distributed import worker

    assert set(jworker.TASKS) <= set(worker.TASKS)
    for name in jworker.TASKS:
        fn = worker.TASKS[name]
        assert fn.__module__ == worker.__name__, name
        assert "not ported" not in (fn.__doc__ or ""), name
    assert not hasattr(worker, "_unported")
    assert worker.TASKS["scenario_lanes"].__name__ == "scenario_lanes"


def test_cli_solve_sharded_alone_and_in_a_world(tmp_path, capsys):
    """``cli solve --backend sharded``: a world of one in-process, and each
    rank of a launched 2-rank world joining it from the DLPS_* env; every
    answer the single-process one."""
    import sys

    from distributedlpsolver_tpu_torch import cli
    from distributedlpsolver_tpu_torch.distributed.launcher import launch_world
    from distributedlpsolver_tpu_torch.io.mps import write_mps

    path = str(tmp_path / "d.mps")
    write_mps(random_dense_lp(24, 64, seed=0), path)
    assert cli.main(["solve", path, "--backend", "sharded", "--device", "cpu", "--json",
                     "--quiet"]) == 0
    alone = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert alone["status"] == "optimal" and alone["backend"] == "sharded"
    argv = [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "solve", path,
            "--backend", "sharded", "--device", "cpu", "--json", "--quiet"]
    handle = launch_world(lambda rank: argv, 2, str(tmp_path / "w"), device="cpu")
    try:
        assert handle.wait(timeout=120) == {0: 0, 1: 0}, handle.tail_logs()
    finally:
        handle.kill_all()
    for p in handle.procs:
        with open(p.log_path) as fh:
            out = json.loads([ln for ln in fh if ln.startswith("{")][-1])
        assert out["status"] == "optimal" and out["iterations"] == alone["iterations"]
        assert _rel(out["objective"], alone["objective"]) <= 1e-8


class _FakeWorld:
    """Rank 0 of a world of two, with no process group and no heartbeats."""

    class cfg:
        heartbeat_dir = None
        heartbeat_ttl_s = 5.0

    world_size, rank = 2, 0

    def start_heartbeat(self):
        pass

    def close(self):
        pass

    def peer_staleness(self):
        return {}


@pytest.mark.parametrize("msg,peer_lost", [
    ("[gloo/transport/tcp/pair.cc:534] Connection closed by peer [127.0.0.1]:4242", True),
    ("[gloo/transport/tcp/pair.cc:598] Read error [127.0.0.1]:4242: Connection reset by peer",
     True),
    ("[gloo/transport/tcp/pair.cc:446] Write error [127.0.0.1]:4242: Broken pipe", True),
    ("NCCL error: unhandled cuda error, peer access is not supported between these devices",
     False),
    ("socket buffer too small for the requested tensor", False),
])
def test_only_a_closed_connection_counts_as_a_lost_peer(monkeypatch, tmp_path, msg, peer_lost):
    """A rank whose task fails with gloo's closed-connection error exits
    with the lost-peer code; any other RuntimeError, even one that names
    a peer or a socket, is the rank's own and propagates (exit code 1)."""
    from distributedlpsolver_tpu_torch.distributed import worker

    def failing(world, spec):
        raise RuntimeError(msg)

    def exit_now(code):
        raise SystemExit(code)

    monkeypatch.setitem(worker.TASKS, "failing", failing)
    monkeypatch.setattr(worker, "world_from_env", _FakeWorld)
    monkeypatch.setattr(worker.os, "_exit", exit_now)
    argv = ["--task", "failing", "--out", str(tmp_path)]
    if peer_lost:
        with pytest.raises(SystemExit) as e:
            worker.main(argv)
        assert e.value.code == worker.WORLD_PEER_LOST_EXIT
    else:
        with pytest.raises(RuntimeError, match=msg.split(",")[0]):
            worker.main(argv)


# The reference's sparse_rows instance (its ``test_sparse_rows_matches_single_process``).
_SPARSE_SPEC = {"scenarios": 6, "block_m": 24, "block_n": 36, "first_stage_n": 24, "seed": 3,
                "tol": 1e-8}


def _sparse_single():
    from distributedlpsolver_tpu_torch.models import storm_sparse_lp

    be = get_backend("sparse-iterative", device="cpu")
    r = solve(storm_sparse_lp(6, block_m=24, block_n=36, first_stage_n=24, seed=3),
              backend=be, tol=1e-8)
    assert r.status.value == "optimal"
    return r, be


def test_sparse_rows_matches_single_process(tmp_path):
    """The row-sharded tier over a gloo world of 2: each rank's ELL block,
    the normal matvec's n-vector sum and m-vector gather crossing the
    process boundary; every rank the single-process solve's status and IPM
    iterations and its objective within 1e-8, and the same x bits and CG
    count on both ranks."""
    ref, be1 = _sparse_single()
    whole = be1._op.nbytes()
    res = run_world("sparse_rows", {**_SPARSE_SPEC, "return_xy": True}, world_size=2,
                    workdir=str(tmp_path), device="cpu", timeout=240, retries=0)
    assert set(res) == {0, 1}
    m = 6 * 24
    assert [res[r]["rows"] for r in (0, 1)] == [[0, m // 2], [m // 2, m]]
    for rank, out in res.items():
        assert out["status"] == "optimal" and out["iterations"] == ref.iterations, (rank, out)
        assert out["shards"] == 2 and out["psum_per_iter"] == 1
        assert out["precond"] == "bordered" and out["pg_backend"] == "gloo"
        assert _rel(out["objective"], ref.objective) <= 1e-8
        x = np.asarray(out["x"])
        assert hashlib.sha256(x.tobytes()).hexdigest() == out["x_sha256"]
        assert out["operator_bytes_per_device"] < whole
    assert len({out["x_sha256"] for out in res.values()}) == 1
    assert len({out["cg_iters"] for out in res.values()}) == 1
    assert res[0]["cg_per_iteration"] == res[1]["cg_per_iteration"]


def test_sparse_rows_world_of_one_gives_the_single_device_bits(tmp_path):
    """A gloo world of one: the block is A and the collectives copy, so x
    is the single-process ``mesh=None`` solve's bit for bit, at the same
    IPM and CG iterations."""
    ref, be = _sparse_single()
    (out,) = run_world("sparse_rows", _SPARSE_SPEC, world_size=1, workdir=str(tmp_path),
                       device="cpu", timeout=240, retries=0).values()
    assert out["x_sha256"] == hashlib.sha256(ref.x.tobytes()).hexdigest()
    assert out["iterations"] == ref.iterations
    assert out["cg_iters"] == be.cg_report()["cg_iters"]
    assert out["shards"] == 1 and out["psum_per_iter"] == 0
