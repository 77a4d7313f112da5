#!/usr/bin/env python3
"""The JAX package's verdicts for the instances of ``chip_smoke.py``'s
``two_phase`` phase, on the CPU with the platform gate forced to
``"tpu"`` (``jax.default_backend`` patched, as the package's own tests
do) and ``use_pallas=False``, so that its dense backend runs the TPU's
two-phase schedule with phase 1 on the plain-XLA f32 branch. Each case
solves at tol 1e-8 and ``max_iter=200``:

* ``random_dense_lp(2048, 10240, seed=0)`` (the port's main-path problem)
  under the default ``factor_dtype="auto"``: on the segmented route (the
  TPU's auto), on ``segment_iters=0`` (the fused two-phase program) and
  on the host loop (``fused_loop=False``);
* the same problem with ``solve_mode="pcg"`` (the three-phase plan: f32,
  PCG to ``pcg_handoff_tol``, the f64 finish);
* ``random_dense_lp(4096, 20480, seed=0)``, where m·n ≥ 2²⁶ engages PCG
  on its own (``solve_mode=None``).

Each case prints one JSON line as it ends: status, iterations, the
iterations of each phase, objective, rel_gap, pinf, dinf, the run's best
max(rel_gap, pinf, dinf) and its iteration, and the seconds it took. The
JAX package keeps no phase report on the fused two-phase program (nor on
the host loop, which has no phases); there phase 1's iterations are the first iteration whose
rel_gap, pinf and dinf all reach its handoff tol, max(tol, phase1_tol)
(``phase1_exit``), which is where that program's phase 1 stops unless it
stalls first. The last line printed is one JSON object, case name →
verdict; ``chip_smoke.py`` pastes it as ``TWO_PHASE_JAX``.

    JAX_PLATFORMS=cpu python scripts/port_two_phase_jax_verdicts.py [--only NAME ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MAIN = (2048, 10240)
CASES = {
    "full_segmented": (MAIN, {}),
    "full_fused": (MAIN, {"segment_iters": 0}),
    "full_host": (MAIN, {"fused_loop": False}),
    "full_pcg": (MAIN, {"solve_mode": "pcg"}),
    "auto_pcg": ((4096, 20480), {}),
}
TOL, MAX_ITER, PHASE1_TOL = 1e-8, 200, 3e-5


def phase1_exit(history, tol: float) -> int | None:
    """The first iteration (1-based) whose rel_gap, pinf and dinf are all
    at or below ``tol``: where a two-phase phase 1 ends on convergence."""
    for i, h in enumerate(history):
        if max(h.rel_gap, h.pinf, h.dinf) <= tol:
            return i + 1
    return None


def verdict(name: str) -> dict:
    import jax

    jax.default_backend = lambda: "tpu"  # the platform gate, as the JAX tests force it
    from distributedlpsolver_tpu.backends.dense import DenseJaxBackend
    from distributedlpsolver_tpu.ipm import driver
    from distributedlpsolver_tpu.models import generators

    shape, kw = CASES[name]
    p = generators.random_dense_lp(*shape, seed=0)
    be = DenseJaxBackend()
    be.phase_report = None
    t0 = time.perf_counter()
    r = driver.solve(p, backend=be, tol=TOL, max_iter=MAX_ITER, use_pallas=False, **kw)
    seconds = time.perf_counter() - t0
    err = [max(h.rel_gap, h.pinf, h.dinf) for h in r.history]
    best = min(range(len(err)), key=err.__getitem__) if err else None
    if be.phase_report:
        phases = [{"mode": ph["mode"], "iters": ph["iters"]} for ph in be.phase_report]
    elif kw.get("fused_loop") is False:
        phases = None  # the host loop: an f32 start, then f64 iterations
    else:
        it1 = phase1_exit(r.history, max(TOL, PHASE1_TOL))
        phases = None if it1 is None else [
            {"mode": "f32", "iters": it1}, {"mode": "f64", "iters": r.iterations - it1}]
    return {
        "status": r.status.value, "iterations": r.iterations, "phases": phases,
        "two_phase": be._two_phase, "pcg": be._pcg,
        "objective": r.objective, "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf,
        "min_err": None if best is None else err[best],
        "min_err_at": None if best is None else best + 1,
        "seconds": round(seconds, 1),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=sorted(CASES), help="run these cases alone")
    args = ap.parse_args()
    out = {}
    for name in args.only or CASES:
        out[name] = verdict(name)
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
