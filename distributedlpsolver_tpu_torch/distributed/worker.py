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
    inner axis, replicated over the outer); ``backend: "block"`` runs
    the block tier with its K axis over the world's mesh (``instance:
    "block"``: ``block_angular_lp(blocks, block_m, block_n, link, seed,
    sparse, density)``), ``backend: "scenario"`` the scenario tier with
    its lanes over it (``instance: "two_stage"``: ``two_stage_storm(
    scenarios, block_m, block_n, first_stage_n, first_stage_m, seed)``
    lowered), and ``backend: "pdlp"`` with ``mesh_shape: [R]`` the PDHG
    engine with A's columns over it (a caller in this process may hand the
    problem itself as ``problem``); ``mesh_shape``/``mesh_axis``,
    ``solve_mode``, ``segment_iters`` and ``fused_loop`` go into the
    solve's ``SolverConfig``, ``schedule_platform`` to the backend (the
    sharded PCG: ``solve_mode: "pcg"``, or ``schedule_platform: "tpu"``
    past the auto threshold). The result carries
    the solve's verdict, a SHA-256 of x's bytes (ranks must agree bit for
    bit), K1's launches on this rank (the batched lanes' and the f32 ones
    among them), the phase rows, the setup parts and, on a PCG schedule,
    the backend's ``cg_report()``;
    with ``return_xy`` also x and y, for a caller to check the answer
    against the problem itself.

``sharded_cases``
    ``sharded_solve`` over a list of specs (``cases``) in one world, so
    a test module pays one world start for several problems; a case with
    ``"check": "linops"`` returns the sharded ``LinOps`` at seeded
    vectors instead.

``bucket_probe``
    A serving bucket (``random_batched_lp(batch, m, n, seed)``) placed over
    the world's batch mesh and dispatched twice with different payloads
    (seeds ``seed`` and ``seed + 1``), each rank solving its lane block:
    the warm recompiles (0), ``bucket_cache_size()`` on every rank (they
    must agree world-wide), and per dispatch the lanes' statuses,
    iterations, objectives and SHA-256 of each lane's x, the programs
    built and graphs captured, the loop's accounting and the wall.

``supervised_solve``
    ``sharded_solve``'s problem through ``supervisor.supervised_solve``
    on every rank with the same fault plan (``faults``: ``kind``,
    ``iteration``, ``device_ids``, ``shard``, ``times``,
    ``hang_seconds``) and supervisor knobs; a rank the SHRINK rung
    excluded reports ``"left": true`` and its fault history. ``cases``
    runs several in one world. ``backend: "sparse-iterative"`` runs the
    row-sharded tier over the world's mesh (a storm ``instance``, say),
    ``backend: "block"`` the block tier (a block ``instance``). The result
    carries K1's launches on this rank over every attempt.

``sparse_rows``
    ``storm_sparse_lp(scenarios, block_m, block_n, first_stage_n, seed,
    t_nnz_per_row, w_nnz_per_row)`` through ``SparseIterativeBackend(mesh=
    world.mesh(axis="batch"))``: each rank holds its row block and runs the
    ELL kernel on it; the normal matvec's n-vector sum and m-vector gather
    cross the process boundary. The result carries the verdict, the CG
    report (``cg_iters``, ``shards``, ``psum_per_iter``, ``precond``), the
    most operand bytes on this rank (``max_operand_per_device``,
    ``operator_bytes_per_device``), the ELL
    kernel's launches on this rank, the setup by part, and SHA-256s of x's
    and y's bytes (ranks must agree bit for bit); with ``return_xy`` also
    x and y.

``scenario_lanes``
    ``two_stage_storm(scenarios, block_m=m, block_n=n, seed)`` (defaults
    8, 6, 14, 3) lowered, through ``ScenarioBackend(mesh=world.mesh(axis=
    "batch"))``: each rank holds its block of the padded lanes and runs K1
    on it; the sums of C and t and the dy rows cross the process boundary.
    A caller in this process may hand the problem itself as ``problem``.
    The result carries the verdict, SHA-256s of x's and y's bytes (ranks
    must agree bit for bit), the CG report, K1's launches on this rank, the
    lanes this rank holds and their bytes, the setup by part and the wall;
    with ``return_xy`` also x and y.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Callable, Dict

from distributedlpsolver_tpu_torch.distributed.world import (  # noqa: F401
    WORLD_PEER_LOST_EXIT,
    World,
    exit_on_peer_loss,
    world_from_env,
)

TASKS: Dict[str, Callable[[World, dict], dict]] = {}


def task(name: str):
    def deco(fn):
        TASKS[name] = fn
        return fn

    return deco


def _problem(spec: dict):
    """The LP a case names: a generator's (``instance``), or, from a caller
    in this process (a world of one), the problem object itself
    (``problem``)."""
    if spec.get("problem") is not None:
        return spec["problem"]
    from distributedlpsolver_tpu_torch.models.generators import (
        block_angular_lp,
        random_dense_lp,
        random_general_lp,
        storm_sparse_lp,
    )

    instance = spec.get("instance", "dense")
    seed = int(spec.get("seed", 0))
    if instance == "block":
        kw = {k: spec[k] for k in ("sparse", "density") if k in spec}
        return block_angular_lp(int(spec.get("blocks", 8)), int(spec.get("block_m", 10)),
                                int(spec.get("block_n", 24)), int(spec.get("link", 6)),
                                seed=seed, **kw)
    if instance == "storm":
        return storm_sparse_lp(
            int(spec.get("scenarios", 8)),
            block_m=int(spec.get("block_m", 24)),
            block_n=int(spec.get("block_n", 36)),
            first_stage_n=int(spec.get("first_stage_n", 24)),
            seed=seed,
            t_nnz_per_row=int(spec.get("t_nnz_per_row", 4)),
            w_nnz_per_row=int(spec.get("w_nnz_per_row", 6)),
        )
    if instance == "two_stage":
        from distributedlpsolver_tpu_torch.models.scenario import two_stage_storm

        return two_stage_storm(
            int(spec.get("scenarios", 8)), block_m=int(spec.get("block_m", 8)),
            block_n=int(spec.get("block_n", 12)), first_stage_n=int(spec.get("first_stage_n", 8)),
            first_stage_m=int(spec.get("first_stage_m", 2)), seed=seed,
        ).to_block_angular()
    if instance == "general":
        return random_general_lp(int(spec.get("m", 20)), int(spec.get("n", 40)), seed=seed)
    if instance != "dense":
        raise ValueError(
            f"unknown instance {instance!r} (dense, general, storm, block or two_stage)")
    return random_dense_lp(int(spec.get("m", 48)), int(spec.get("n", 128)), seed=seed)


def _world_mesh_kw(world: World, name: str) -> dict:
    """The mesh a backend takes at construction in a world: the row-sharded
    tier's rows, the scenario tier's lanes and the block tier's K axis ride
    the world's 1-D mesh (for those tiers ``mesh=None`` means one device).
    The sharded backend makes its own at setup, as pdlp does from a
    ``mesh_shape``."""
    from distributedlpsolver_tpu_torch.backends.base import backend_class
    from distributedlpsolver_tpu_torch.backends.block_angular import BlockAngularBackend
    from distributedlpsolver_tpu_torch.backends.scenario import ScenarioBackend
    from distributedlpsolver_tpu_torch.backends.sparse_iterative import SparseIterativeBackend

    cls = backend_class(name)
    if issubclass(cls, (SparseIterativeBackend, ScenarioBackend)):
        return {"mesh": world.mesh(axis="batch")}
    if issubclass(cls, BlockAngularBackend):
        return {"mesh": world.mesh(axis="blocks")}
    return {}


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
        mesh_shape=tuple(spec["mesh_shape"]) if spec.get("mesh_shape") else None,
        mesh_axis=spec.get("mesh_axis", "cols"),
        solve_mode=spec.get("solve_mode"),
        segment_iters=spec.get("segment_iters"),
        fused_loop=spec.get("fused_loop"),
    )
    name = spec.get("backend", "sharded")
    kw = {}
    if spec.get("schedule_platform"):
        kw["schedule_platform"] = spec["schedule_platform"]
    if spec.get("hybrid"):
        from distributedlpsolver_tpu_torch.parallel.mesh import make_hybrid_mesh

        dcn, ici = spec["hybrid"]
        kw["mesh"] = make_hybrid_mesh(ici, dcn)
    else:
        kw.update(_world_mesh_kw(world, name))
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
    launches0, batched0, f32_0 = (normal_eq.launches, normal_eq.launches_batched,
                                  normal_eq.launches_f32)
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
        "k1_launches_batched": normal_eq.launches_batched - batched0,
        "k1_launches_f32": normal_eq.launches_f32 - f32_0,
        "phase_report": getattr(be, "phase_report", None),
        "setup": dict(getattr(be, "setup_report", {}), generate_s=t_gen),
    }
    if spec.get("return_xy") and x is not None:
        out["x"], out["y"] = x.tolist(), result.y.tolist()
    shard = getattr(be, "_A", None)
    if shard is not None:
        out["shard_shape"] = list(shard.shape)
    member = getattr(be, "_parts", None)  # the block tier: this rank's one member
    if member and hasattr(member[0], "B_all"):
        out["shard_shape"] = list(member[0].B_all.shape)
        out["link_columns"] = int(member[0].L_cat.shape[1])
        out["layout"] = list(be.layout)
    if hasattr(be, "lane_ranges"):  # the scenario tier
        out.update(_scenario_fields(be, result))
    if getattr(be, "clock", None) is not None:
        out["stage_clock"] = be.clock.report()
    if getattr(be, "_pcg", False):  # the dense and sharded backends' PCG tally
        out["cg_report"] = be.cg_report()
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


@task("sparse_rows")
def sparse_rows(world: World, spec: dict) -> dict:
    from distributedlpsolver_tpu_torch.backends.sparse_iterative import SparseIterativeBackend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.ops.ell_spmv import ell_normal_diag, ell_spmv

    spec = {"instance": "storm", "scenarios": 6, "seed": 3, **spec}
    t0 = time.perf_counter()
    problem = _problem(spec)
    t_gen = time.perf_counter() - t0
    cfg = SolverConfig(tol=float(spec.get("tol", 1e-8)), max_iter=int(spec.get("max_iter", 200)),
                       verbose=False)
    be = SparseIterativeBackend(precond=spec.get("precond", "auto"),
                                mesh=world.mesh(axis="batch"))
    ell_spmv.launches = ell_spmv.launches_t = ell_normal_diag.launches = 0
    t0 = time.perf_counter()
    result = solve(problem, backend=be, config=cfg)
    wall = time.perf_counter() - t0
    rep = be.cg_report()
    x = result.x
    (lo, hi), = be._op.ranges
    out = {
        "status": result.status.value, "objective": result.objective,
        "iterations": result.iterations, "rel_gap": result.rel_gap, "pinf": result.pinf,
        "dinf": result.dinf, "wall_s": wall, "setup_s": result.setup_time,
        "solve_s": result.solve_time, "setup": dict(be.setup_report, generate_s=t_gen),
        "cg_iters": rep["cg_iters"], "cg_per_iteration": rep["cg_per_iteration"],
        "newton_solves": rep["newton_solves"], "host_syncs": rep["host_syncs"],
        "shards": rep["shards"], "psum_per_iter": rep["psum_per_iter"],
        "precond": rep["precond"],
        "rows": [lo, hi], "shape": list(be._op.shape),
        "max_operand_per_device": be.max_operand_nbytes(per_device=True),
        "max_operand": be.max_operand_nbytes(),
        "operator_bytes_per_device": be._op.nbytes_per_device(),
        "ell_launches": {"A·v": ell_spmv.launches, "Aᵀ·v": ell_spmv.launches_t,
                         "diag(A·D·Aᵀ)": ell_normal_diag.launches},
        "x_sha256": None if x is None else hashlib.sha256(x.tobytes()).hexdigest(),
        "y_sha256": None if x is None else hashlib.sha256(result.y.tobytes()).hexdigest(),
    }
    if spec.get("return_xy") and x is not None:
        out["x"], out["y"] = x.tolist(), result.y.tolist()
    return out


def _scenario_fields(be, result) -> dict:
    """A scenario solve's mesh fields: the lanes this rank holds and their
    bytes, the CG report and a SHA-256 of y's bytes."""
    rep = be.cg_report()
    y = result.y
    return {
        "lanes": [list(r) for r in be.lane_ranges], "member_bytes": be.member_nbytes(),
        "layout": dict(be.layout._asdict()), "cg_iters": rep["cg_iters"],
        "cg_per_iteration": rep["cg_per_iteration"], "newton_solves": rep["newton_solves"],
        "host_syncs": rep["host_syncs"],
        "y_sha256": None if y is None else hashlib.sha256(y.tobytes()).hexdigest(),
    }


@task("scenario_lanes")
def scenario_lanes(world: World, spec: dict) -> dict:
    from distributedlpsolver_tpu_torch.backends.scenario import ScenarioBackend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq

    spec = {"instance": "two_stage", "scenarios": 8, "block_m": spec.get("m", 6),
            "block_n": spec.get("n", 14), "seed": 3, **spec}
    t0 = time.perf_counter()
    problem = _problem(spec)
    t_gen = time.perf_counter() - t0
    cfg = SolverConfig(tol=float(spec.get("tol", 1e-8)), max_iter=int(spec.get("max_iter", 200)),
                       verbose=False)
    # The lane axis over the world's mesh: each rank its block of lanes.
    be = ScenarioBackend(mesh=world.mesh(axis="batch"))
    launches0 = normal_eq.launches
    t0 = time.perf_counter()
    result = solve(problem, backend=be, config=cfg)
    wall = time.perf_counter() - t0
    x = result.x
    out = {
        "status": result.status.value, "objective": result.objective,
        "iterations": result.iterations, "rel_gap": result.rel_gap, "pinf": result.pinf,
        "dinf": result.dinf, "wall_s": wall, "setup_s": result.setup_time,
        "solve_s": result.solve_time, "setup": dict(be.setup_report, generate_s=t_gen),
        "k1_launches": normal_eq.launches - launches0,
        "x_sha256": None if x is None else hashlib.sha256(x.tobytes()).hexdigest(),
        **_scenario_fields(be, result),
    }
    if spec.get("return_xy") and x is not None:
        out["x"], out["y"] = x.tolist(), result.y.tolist()
    return out


@task("sharded_cases")
def sharded_cases(world: World, spec: dict) -> dict:
    """Each case of ``cases`` through ``sharded_solve``, or through
    :func:`sharded_linops` when it says ``"check": "linops"``."""
    return {"cases": [
        (sharded_linops if case.get("check") == "linops" else sharded_solve)(world, case)
        for case in spec["cases"]
    ]}


@task("bucket_probe")
def bucket_probe(world: World, spec: dict) -> dict:
    import numpy as np

    from distributedlpsolver_tpu_torch.backends.batched import (
        bucket_cache_size,
        bucket_capture_count,
        place_bucket,
        solve_bucket,
    )
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models.generators import random_batched_lp

    m, n, B = int(spec.get("m", 8)), int(spec.get("n", 24)), int(spec.get("batch", 8))
    seed = int(spec.get("seed", 7))
    cfg = SolverConfig(tol=float(spec.get("tol", 1e-8)), verbose=False)
    mesh = world.mesh(axis="batch")
    active = np.ones(B, dtype=bool)
    dispatches, cache_after_first = [], 0
    for i, s in enumerate((seed, seed + 1)):
        batch = random_batched_lp(B, m, n, seed=s)
        size0, caps0 = bucket_cache_size(), bucket_capture_count()
        t0 = time.perf_counter()
        placed, act = place_bucket(batch, active, cfg, mesh=mesh)
        res = solve_bucket(placed, act, cfg, mesh=mesh)
        wall = time.perf_counter() - t0
        dispatches.append({
            "seed": s, "wall_s": wall, "solve_s": res.solve_time,
            "status": [st.value for st in res.status],
            "iterations": [int(v) for v in res.iterations],
            "objectives": [float(v) for v in res.objective],
            "x_sha256": hashlib.sha256(np.ascontiguousarray(res.x).tobytes()).hexdigest(),
            "x_lane_sha256": [hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()
                              for x in res.x],
            "programs_built": bucket_cache_size() - size0,
            "graphs_captured": bucket_capture_count() - caps0,
            "phase_report": res.phase_report[0],
        })
        if i == 0:
            cache_after_first = bucket_cache_size()
    # Cross-process zero-warm-recompile check: the cache must not have
    # grown on the SECOND dispatch on any rank, and every rank's total
    # must agree (a collective; raises on disagreement).
    sizes = world.agree(bucket_cache_size(), what="bucket_cache_size")
    return {
        "objectives_first": dispatches[0]["objectives"],
        "objectives_second": dispatches[1]["objectives"],
        "warm_recompiles": int(bucket_cache_size() - cache_after_first),
        "bucket_cache_sizes": sizes,
        "lane_block": list(mesh.lane_blocks(B)[0][1:]),
        "dispatches": dispatches,
    }


def _supervised_case(world: World, spec: dict) -> dict:
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.ipm.state import FaultKind
    from distributedlpsolver_tpu_torch.parallel import runtime
    from distributedlpsolver_tpu_torch.supervisor import (
        InjectedFault,
        ShrunkOut,
        SupervisorConfig,
        supervised_solve,
    )

    problem = _problem(spec)
    plan = [InjectedFault(FaultKind(f["kind"]), int(f["iteration"]),
                          device_ids=f.get("device_ids"), shard=f.get("shard"),
                          times=f.get("times", 1), hang_seconds=float(f.get("hang_seconds", 30.0)))
            for f in spec.get("faults", [])]
    sup = SupervisorConfig(fault_plan=plan or None, **spec.get("supervisor", {}))
    log = spec.get("log_jsonl")
    cfg = SolverConfig(tol=float(spec.get("tol", 1e-8)), max_iter=int(spec.get("max_iter", 200)),
                       verbose=False, log_jsonl=log.format(rank=world.rank) if log else None)
    from distributedlpsolver_tpu_torch.backends.base import backend_class
    from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq

    name = spec.get("backend", "sharded")
    be = backend_class(name)(device=world.device, **_world_mesh_kw(world, name))
    runtime.restore_devices()
    launches0, batched0, f32_0 = (normal_eq.launches, normal_eq.launches_batched,
                                  normal_eq.launches_f32)
    t0 = time.perf_counter()
    faults = lambda fs: [{"kind": f.kind.value, "iteration": f.iteration, "action": f.action,
                          "devices": list(f.devices), "backend": f.backend,
                          "recovery_overhead_s": f.recovery_overhead_s} for f in fs]
    try:
        r = supervised_solve(problem, backend=be, config=cfg, supervisor=sup)
    except ShrunkOut as e:
        return {"left": True, "faults": faults(e.faults), "wall_s": time.perf_counter() - t0}
    finally:
        runtime.restore_devices()
    out = {
        "left": False, "status": r.status.value, "objective": r.objective,
        "iterations": r.iterations, "backend": r.backend, "rel_gap": r.rel_gap,
        "pinf": r.pinf, "wall_s": time.perf_counter() - t0, "faults": faults(r.faults),
        "x_sha256": None if r.x is None else hashlib.sha256(r.x.tobytes()).hexdigest(),
        "k1_launches": normal_eq.launches - launches0,
        "k1_launches_batched": normal_eq.launches_batched - batched0,
    }
    if spec.get("return_xy") and r.x is not None:
        out["x"], out["y"] = r.x.tolist(), r.y.tolist()
    return out


@task("supervised_solve")
def supervised_solve_task(world: World, spec: dict) -> dict:
    """:func:`_supervised_case` of ``spec``, or of each of its ``cases``
    in one world."""
    cases = spec.get("cases", [spec])
    out = []
    for case in cases:
        out.append(_supervised_case(world, case))
        # A rank the shrink excluded waits here for the survivors, so the
        # next case starts on the whole world.
        world.barrier("case-done")
    return {"cases": out} if "cases" in spec else out[0]


def _write_result(out_dir: str, rank: int, payload: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rank{rank}.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


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
            exit_on_peer_loss(world, e)  # the world is dead: leave deliberately
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
