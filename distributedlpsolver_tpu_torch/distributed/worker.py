"""Rank entry for world tasks: ``python -m …distributed.worker``.

The counterpart of the JAX package's ``distributed/worker.py``. Every
rank of a launched world runs this entry with the same argv; the env
contract (``distributed/world.py``) tells it who it is. Each rank writes
its result JSON to ``<out>/rank<k>.json`` (atomic rename) so the
launcher can collect and cross-check the per-rank views.

Tasks:

``sharded_solve``
    One LP through the sharded backend over every rank of the world —
    the ``mpirun -np N`` analogue of the reference run: the per-iteration
    Schur all-reduce crosses the process boundary. ``instance`` is
    ``dense`` (``random_dense_lp(m, n, seed)``, the default), ``general``
    (``random_general_lp``) or ``storm`` (the bordered two-stage
    profile, densified at setup). ``checkpoint``/``checkpoint_every``
    exercise the host-canonical checkpoint that coordinator-level
    recovery resumes from; ``pace_s`` holds each rank that long after
    every iteration (a harness can then act mid-solve); ``stage_clock``
    times the step's parts (``backends/sharded.py``); ``hybrid: [dcn,
    ici]`` runs on ``make_hybrid_mesh(ici, dcn)`` (columns split over the
    inner axis, replicated over the outer). The result carries
    the solve's verdict, a SHA-256 of x's bytes (ranks must agree bit for
    bit), K1's launches on this rank, the phase rows and the setup parts;
    with ``return_xy`` also x and y, for a caller to check the answer
    against the problem itself.

``sharded_cases``
    ``sharded_solve`` over a list of specs (``cases``) in one world, so
    a test module pays one world start for several problems; a case with
    ``"check": "linops"`` returns the sharded ``LinOps`` at seeded
    vectors instead.

Not ported yet: ``bucket_probe`` (the batch-axis mesh, ROADMAP Queue 1
item 13b), ``sparse_rows`` and ``scenario_lanes`` (the row-sharded
tiers, item 13c).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Callable, Dict

from distributedlpsolver_tpu_torch.distributed.world import (
    WORLD_PEER_LOST_EXIT,
    World,
    world_from_env,
)

TASKS: Dict[str, Callable[[World, dict], dict]] = {}


def task(name: str):
    def deco(fn):
        TASKS[name] = fn
        return fn

    return deco


def _problem(spec: dict):
    from distributedlpsolver_tpu_torch.models.generators import (
        random_dense_lp,
        random_general_lp,
        storm_sparse_lp,
    )

    instance = spec.get("instance", "dense")
    seed = int(spec.get("seed", 0))
    if instance == "storm":
        return storm_sparse_lp(
            int(spec.get("scenarios", 8)),
            block_m=int(spec.get("block_m", 24)),
            block_n=int(spec.get("block_n", 36)),
            first_stage_n=int(spec.get("first_stage_n", 24)),
            seed=seed,
        )
    if instance == "general":
        return random_general_lp(int(spec.get("m", 20)), int(spec.get("n", 40)), seed=seed)
    if instance != "dense":
        raise ValueError(f"unknown instance {instance!r} (dense, general or storm)")
    return random_dense_lp(int(spec.get("m", 48)), int(spec.get("n", 128)), seed=seed)


@task("sharded_solve")
def sharded_solve(world: World, spec: dict) -> dict:
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.ipm.driver import SolveHooks
    from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq

    t0 = time.perf_counter()
    problem = _problem(spec)
    t_gen = time.perf_counter() - t0
    cfg = SolverConfig(
        tol=float(spec.get("tol", 1e-8)),
        max_iter=int(spec.get("max_iter", 200)),
        verbose=False,
        checkpoint_path=spec.get("checkpoint") or None,
        checkpoint_every=int(spec.get("checkpoint_every", 0)),
    )
    name = spec.get("backend", "sharded")
    kw = {}
    if spec.get("hybrid"):
        from distributedlpsolver_tpu_torch.parallel.mesh import make_hybrid_mesh

        dcn, ici = spec["hybrid"]
        kw["mesh"] = make_hybrid_mesh(ici, dcn)
    be = get_backend(name, device=world.device, **kw)
    if spec.get("stage_clock"):
        from distributedlpsolver_tpu_torch.backends.sharded import StageClock

        be.clock = StageClock(be.device)
    hooks = None
    pace = float(spec.get("pace_s", 0.0))
    if pace > 0:
        class _Pace(SolveHooks):
            def on_iterate(self, iteration, scalars):
                time.sleep(pace)

        hooks = _Pace()
    launches0 = normal_eq.launches
    t0 = time.perf_counter()
    result = solve(problem, backend=be, config=cfg, hooks=hooks)
    wall = time.perf_counter() - t0
    x = result.x
    out = {
        "status": result.status.value,
        "objective": result.objective,
        "iterations": result.iterations,
        "rel_gap": result.rel_gap,
        "pinf": result.pinf,
        "dinf": result.dinf,
        "wall_s": round(wall, 3),
        "solve_s": result.solve_time,
        "x_sha256": None if x is None else hashlib.sha256(x.tobytes()).hexdigest(),
        "k1_launches": normal_eq.launches - launches0,
        "phase_report": getattr(be, "phase_report", None),
        "setup": dict(getattr(be, "setup_report", {}), generate_s=t_gen),
    }
    if spec.get("return_xy") and x is not None:
        out["x"], out["y"] = x.tolist(), result.y.tolist()
    shard = getattr(be, "_A", None)
    if shard is not None:
        out["shard_shape"] = list(shard.shape)
    if getattr(be, "clock", None) is not None:
        out["stage_clock"] = be.clock.report()
    return out


def sharded_linops(world: World, spec: dict) -> dict:
    """The sharded ``LinOps`` of ``random_dense_lp(m, n, seed)``'s interior
    form at seeded vectors (``matvec``, ``rmatvec``, the regularized M of
    ``factorize`` and a ``solve``), for a test to hold against the dense
    ones on the same padded matrix."""
    import numpy as np
    import torch

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models import random_dense_lp, to_interior_form

    inf = to_interior_form(random_dense_lp(int(spec["m"]), int(spec["n"]), seed=int(spec["seed"])))
    be = get_backend("sharded", device=world.device)
    be.setup(inf, SolverConfig())
    m, n = be._shape
    rng = np.random.default_rng(int(spec.get("vec_seed", 0)))
    v, y, r = rng.standard_normal(n), rng.standard_normal(m), rng.standard_normal(m)
    d = rng.random(n) + 0.1
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=world.device)
    ops = be._ops()
    factors = ops.factorize(t(d))
    host = lambda a: a.detach().cpu().numpy().tolist()
    return {"n_padded": n, "cols": list(be._cols), "reg": be._reg,
            "ranks": world.allgather(world.rank), "v": v.tolist(),
            "y": y.tolist(), "r": r.tolist(), "d": d.tolist(),
            "matvec": host(ops.matvec(t(v))), "rmatvec": host(ops.rmatvec(t(y))),
            "M": host(factors[1]), "solve": host(ops.solve(factors, t(r)))}


@task("sharded_cases")
def sharded_cases(world: World, spec: dict) -> dict:
    """Each case of ``cases`` through ``sharded_solve``, or through
    :func:`sharded_linops` when it says ``"check": "linops"``."""
    return {"cases": [
        (sharded_linops if case.get("check") == "linops" else sharded_solve)(world, case)
        for case in spec["cases"]
    ]}


def _unported(name: str, item: str):
    def run(world: World, spec: dict) -> dict:
        raise NotImplementedError(
            f"world task {name!r} is not ported to the torch package yet "
            f"(ROADMAP Queue 1 item {item})"
        )

    return run


task("bucket_probe")(_unported("bucket_probe", "13b"))
task("sparse_rows")(_unported("sparse_rows", "13c"))
task("scenario_lanes")(_unported("scenario_lanes", "13c"))


def _write_result(out_dir: str, rank: int, payload: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rank{rank}.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


# gloo's TCP transport reports a peer's closed connection so: a read
# that hit EOF, or a read or write that the OS refused (ECONNRESET, EPIPE).
_CLOSED_CONNECTION = ("connection closed by peer", "connection reset by peer", "broken pipe")


def _peer_lost(world: World, err: BaseException) -> bool:
    """Whether a failed task saw a peer die: gloo reports a closed
    connection, or a peer's heartbeat is stale. Any other error is the
    rank's own and keeps its exit code."""
    msg = str(err).lower()
    if any(w in msg for w in _CLOSED_CONNECTION):
        return True
    stale = world.peer_staleness() if world.cfg.heartbeat_dir else {}
    return any(s > world.cfg.heartbeat_ttl_s for s in stale.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dlps-world-worker")
    ap.add_argument("--task", required=True, choices=sorted(TASKS))
    ap.add_argument("--spec-json", default="{}")
    ap.add_argument("--out", required=True, help="per-rank result dir")
    args = ap.parse_args(argv)

    world = world_from_env()
    world.start_heartbeat()
    try:
        spec = json.loads(args.spec_json)
        try:
            result = TASKS[args.task](world, spec)
        except RuntimeError as e:
            if (world.world_size > 1 and not isinstance(e, NotImplementedError)
                    and _peer_lost(world, e)):
                # The world is dead: leave deliberately, skipping the
                # teardown a collective with the dead peer would block.
                print(f"[world] rank {world.rank}: a peer died mid-collective ({e}); "
                      "exiting", file=sys.stderr, flush=True)
                os._exit(WORLD_PEER_LOST_EXIT)
            raise
        result.update(world.describe())
        # Completion barrier BEFORE results land: a rank must not
        # declare success while a peer can still fail the collective
        # program they shared.
        world.barrier("task-done")
        _write_result(args.out, world.rank, result)
    finally:
        world.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
