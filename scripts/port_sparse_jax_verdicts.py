#!/usr/bin/env python3
"""The JAX package's verdicts for the instances of ``chip_smoke.py``'s
sparse phase, on the CPU: status, IPM iterations, CG iterations, the
resolved preconditioner and the objective of its ``sparse-iterative``
backend, for

* the reference's own acceptance instance, ``storm_sparse_lp(320, 64, 96,
  64, seed=1)`` (20,480 × 30,784; ``tests/test_sparse.py``), at tol 1e-8
  and ``max_iter=200``;
* the ILDL case, ``netlib_sparse_lp(120, 220, seed=10)`` under
  ``precond="auto"`` (escalates from Jacobi to ILDL);
* the small storm instances of ``tests/test_torch_sparse_iterative.py``
  and the 2,048-row instance of the ladder check,
  ``storm_sparse_lp(32, 64, 96, 64, seed=1)``.

``chip_smoke.py`` pastes these values as constants (``SPARSE_JAX``). The
last line printed is one JSON object, case name → verdict.

    JAX_PLATFORMS=cpu python scripts/port_sparse_jax_verdicts.py [--skip-large]

About 70 s on an 8-core Intel Xeon, 45 s of it the 20,480-row instance
(``--skip-large`` leaves it out).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = {
    "storm_s": ("storm_sparse_lp", (8, 16, 24, 16), {"seed": 9}, {}),
    "storm_m": ("storm_sparse_lp", (12, 24, 32, 16), {"seed": 10}, {}),
    "storm_ladder": ("storm_sparse_lp", (32, 64, 96, 64), {"seed": 1}, {}),
    "ildl": ("netlib_sparse_lp", (120, 220), {"seed": 10}, {}),
    "acceptance_20k": ("storm_sparse_lp", (320, 64, 96, 64), {"seed": 1}, {"max_iter": 200}),
}


def verdict(name: str) -> dict:
    from distributedlpsolver_tpu.backends.base import get_backend
    from distributedlpsolver_tpu.ipm import driver
    from distributedlpsolver_tpu.models import generators

    gen, args, kw, solve_kw = CASES[name]
    p = getattr(generators, gen)(*args, **kw)
    be = get_backend("sparse-iterative")
    t0 = time.perf_counter()
    r = driver.solve(p, backend=be, tol=1e-8, **solve_kw)
    rep = be.cg_report()
    return {
        "status": r.status.value, "iterations": r.iterations, "cg_iters": rep["cg_iters"],
        "precond": rep["precond"], "objective": r.objective, "rel_gap": r.rel_gap,
        "pinf": r.pinf, "dinf": r.dinf, "seconds": round(time.perf_counter() - t0, 1),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-large", action="store_true", help="leave out the 20,480-row instance")
    args = ap.parse_args()
    out = {}
    for name in CASES:
        if args.skip_large and name == "acceptance_20k":
            continue
        out[name] = verdict(name)
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
