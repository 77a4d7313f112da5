#!/usr/bin/env python3
"""The JAX package's verdicts for the forced-PCG instances of
``chip_smoke.py``'s ``sharded_pcg`` step, on the CPU: status, IPM
iterations, objective, rel_gap, pinf and dinf of its sharded backend
(``ShardedJaxBackend`` on a mesh of 8 virtual CPU devices, the
preconditioner's ``L⁻¹`` column-split by ``prec_sharding``) under
``solve_mode="pcg"`` at tol 1e-8 and ``max_iter=200``, for the reference's
own mesh instances — ``random_dense_lp(48, 120, seed=11)``
(``tests/test_dist_chol.py``), ``(48, 128, seed=4)`` and ``(64, 160,
seed=9)`` (``tests/test_pcg.py``) — each on the fused loop, the host loop
(``fused_loop=False``) and the segmented loop (``segment_iters=2``, the
only route that takes the primal-row closure).

``chip_smoke.py`` pastes these values as constants (``SHARDED_PCG_JAX``).
Each case prints one line as it ends; the last line printed is one JSON
object, case name → verdict.

    python scripts/port_sharded_pcg_jax_verdicts.py [--only NAME ...]

About a minute on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MESH = 8
INSTANCES = {"48x120s11": (48, 120, 11), "48x128s4": (48, 128, 4), "64x160s9": (64, 160, 9)}
LOOPS = {"fused": {}, "host": {"fused_loop": False}, "segmented": {"segment_iters": 2}}
CASES = {f"{inst}_{loop}": (shape, kw) for inst, shape in INSTANCES.items()
         for loop, kw in LOOPS.items()}


def verdict(name: str) -> dict:
    import jax

    from distributedlpsolver_tpu.backends.sharded import ShardedJaxBackend
    from distributedlpsolver_tpu.ipm import driver
    from distributedlpsolver_tpu.models import generators
    from distributedlpsolver_tpu.parallel import make_mesh

    (m, n, seed), kw = CASES[name]
    be = ShardedJaxBackend(mesh=make_mesh(devices=jax.devices()[:MESH]))
    t0 = time.perf_counter()
    r = driver.solve(generators.random_dense_lp(m, n, seed=seed), backend=be, tol=1e-8,
                     max_iter=200, solve_mode="pcg", **kw)
    if be._prec_shard is None:
        raise SystemExit(f"{name}: the JAX sharded backend took no column-split preconditioner")
    return {
        "status": r.status.value, "iterations": r.iterations, "objective": r.objective,
        "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf,
        "seconds": round(time.perf_counter() - t0, 1),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=sorted(CASES), help="run these cases alone")
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={MESH}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for name in args.only or CASES:
        out[name] = verdict(name)
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
