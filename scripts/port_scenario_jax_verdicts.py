#!/usr/bin/env python3
"""The JAX package's verdicts for the instances of ``chip_smoke.py``'s
scenario phase, on the CPU: status, IPM iterations, CG iterations (in all
and for each step, the starting point's first) and objective of its
``scenario`` backend, for

* ``main``: the tier's own family at a full bucket,
  ``two_stage_storm(1024, block_m=24, block_n=36, first_stage_n=24,
  first_stage_m=2, seed=1)`` lowered by ``to_block_angular()`` (24,578 ×
  36,888), through ``solve(p, backend="auto")``;
* ``storm8``: stormG2's blocks at K = 8, ``storm_sparse_lp(8, 528, 1259,
  121, seed=1, t_nnz_per_row=2, w_nnz_per_row=4)`` (4,224 × 10,193) with
  its ``bordered`` hint rewritten as ``two_stage`` (no first-stage rows),
  through ``auto``;
* ``cli_file``: the file of the JAX CLI's ``generate scenario --scenarios
  64 --m 24 --n 36`` solved by its ``cli solve`` with the default backend
  (no hint in the file: the detection pass routes it to ``scenario``),

each at tol 1e-8. ``chip_smoke.py`` pastes these values as constants
(``SCENARIO_JAX``). The last line printed is one JSON object, case name →
verdict.

    JAX_PLATFORMS=cpu python scripts/port_scenario_jax_verdicts.py

About 40 s for ``main`` and 45 s for ``storm8`` on an 8-core CPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def storm8():
    """stormG2's blocks at K = 8 with a ``two_stage`` hint (JAX package)."""
    from distributedlpsolver_tpu.models.generators import storm_sparse_lp

    p = storm_sparse_lp(8, 528, 1259, 121, seed=1, t_nnz_per_row=2, w_nnz_per_row=4)
    p.block_structure = dict(p.block_structure, kind="two_stage", first_stage_m=0)
    return p


@contextlib.contextmanager
def cg_steps():
    """Record the JAX scenario backend's CG iterations of each step (the
    starting point's, then each iteration's) from its solve report."""
    from distributedlpsolver_tpu.backends import scenario as scn

    steps = []
    orig = scn.ScenarioBackend.starting_point, scn.ScenarioBackend.iterate

    def counted(fn):
        def wrap(self, *a):
            before = scn.last_solve_report().get("cg_iters", 0.0)
            out = fn(self, *a)
            steps.append(int(scn.last_solve_report().get("cg_iters", 0.0) - before))
            return out

        return wrap

    scn.ScenarioBackend.starting_point = counted(orig[0])
    scn.ScenarioBackend.iterate = counted(orig[1])
    try:
        yield steps
    finally:
        scn.ScenarioBackend.starting_point, scn.ScenarioBackend.iterate = orig


def verdict(name: str) -> dict:
    from distributedlpsolver_tpu.backends import get_backend
    from distributedlpsolver_tpu.ipm import driver
    from distributedlpsolver_tpu.models.scenario import two_stage_storm

    if name == "main":
        p = two_stage_storm(1024, 24, 36, 24, 2, seed=1).to_block_angular()
    else:
        p = storm8()
    be = get_backend("auto")
    t0 = time.perf_counter()
    with cg_steps() as steps:
        r = driver.solve(p, backend=be, tol=1e-8)
    return {
        "backend": be.name, "status": r.status.value, "iterations": r.iterations,
        "objective": r.objective, "cg_iters": sum(steps), "cg_per_iteration": steps,
        "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf,
        "seconds": round(time.perf_counter() - t0, 1),
    }


def verdict_file() -> dict:
    from distributedlpsolver_tpu import cli

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scenario64.mps")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["generate", "scenario", path, "--scenarios", "64", "--m", "24", "--n", "36"])
        buf = io.StringIO()
        t0 = time.perf_counter()
        with cg_steps() as steps, contextlib.redirect_stdout(buf):
            rc = cli.main(["solve", path, "--json", "--quiet"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    return {"rc": rc, "backend": out["backend"], "status": out["status"],
            "iterations": out["iterations"], "objective": out["objective"],
            "cg_iters": sum(steps), "cg_per_iteration": steps,
            "seconds": round(time.perf_counter() - t0, 1)}


def main() -> int:
    out = {}
    for name in ("main", "storm8"):
        out[name] = verdict(name)
        print(name, json.dumps(out[name]), flush=True)
    out["cli_file"] = verdict_file()
    print("cli_file", json.dumps(out["cli_file"]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
