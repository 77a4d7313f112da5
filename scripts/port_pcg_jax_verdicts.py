#!/usr/bin/env python3
"""The JAX package's verdicts for the instances of ``chip_smoke.py``'s
``pcg`` phase, on the CPU: status, IPM iterations, objective, rel_gap,
pinf and dinf of its dense backend under ``solve_mode="pcg"`` at tol 1e-8
and ``max_iter=200``, and the run's best max(rel_gap, pinf, dinf) with its
iteration (the fused loop's stall exit fires only while that stays above
its patience floor, 1e3·tol), for

* ``random_dense_lp(60, 180, seed=0)`` on the fused loop, the host loop
  (``fused_loop=False``) and the segmented loop (``segment_iters=10``,
  the only route that takes the primal-row closure);
* ``random_dense_lp(512, 2560, seed=0)`` on the same three loops;
* ``random_dense_lp(2048, 10240, seed=0)`` (the port's main-path
  problem) on the fused loop.

``chip_smoke.py`` pastes these values as constants (``PCG_JAX``). Each
case prints one line as it ends; the last line printed is one JSON
object, case name → verdict.

    JAX_PLATFORMS=cpu python scripts/port_pcg_jax_verdicts.py [--skip-large] [--only NAME ...]

The small cases take seconds, the 512-row ones about 3 min together
and the 2,048-row case about 20 min (1,211 s) on 8 CPU cores
(``--skip-large`` leaves it out).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOOPS = {
    "fused": {},
    "host": {"fused_loop": False},
    "segmented": {"segment_iters": 10},
}

CASES = {
    **{f"small_{loop}": ((60, 180), kw) for loop, kw in LOOPS.items()},
    **{f"mid_{loop}": ((512, 2560), kw) for loop, kw in LOOPS.items()},
    "full_fused": ((2048, 10240), {}),
}


def verdict(name: str) -> dict:
    from distributedlpsolver_tpu.ipm import driver
    from distributedlpsolver_tpu.models import generators

    shape, kw = CASES[name]
    p = generators.random_dense_lp(*shape, seed=0)
    t0 = time.perf_counter()
    r = driver.solve(p, backend="tpu", tol=1e-8, max_iter=200, solve_mode="pcg", **kw)
    # The best max(rel_gap, pinf, dinf) of the run and where: the fused
    # loop's stall exit fires only while it stays above 1e3·tol.
    err = [max(h.rel_gap, h.pinf, h.dinf) for h in r.history]
    best = min(range(len(err)), key=err.__getitem__) if err else None
    return {
        "status": r.status.value, "iterations": r.iterations, "objective": r.objective,
        "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf,
        "min_err": None if best is None else err[best],
        "min_err_at": None if best is None else best + 1,
        "seconds": round(time.perf_counter() - t0, 1),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-large", action="store_true", help="leave out the 2,048-row case")
    ap.add_argument("--only", nargs="+", choices=sorted(CASES), help="run these cases alone")
    args = ap.parse_args()
    out = {}
    for name in args.only or CASES:
        if args.skip_large and name == "full_fused":
            continue
        out[name] = verdict(name)
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
