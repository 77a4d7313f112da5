#!/usr/bin/env python3
"""The JAX package's verdicts for the instances of ``chip_smoke.py``'s
block phase, on the CPU: status, IPM iterations and objective of its
``block`` backend on the single-phase f64 path it takes off the TPU (no
two-phase schedule, no panel Cholesky, the K axis in one group), for

* the pds-10 class, ``block_angular_lp(32, 432, 1400, 800, seed=0,
  sparse=True, density=0.005)`` (14,624 × 44,800, 275,950 nonzeros);
* the pds-20 class, ``block_angular_lp(64, 432, 1400, 1600, seed=0,
  sparse=True, density=0.005)`` (29,248 × 89,600),

each solved with its hint at tol 1e-8, and ``pds10_file``: the pds-10
class written to MPS by the JAX CLI's ``generate block`` writer and
solved by its ``cli solve`` with the default backend, ``auto``, routed
as on an accelerator (the file has no hint: presolve, then the detection
pass sends it to ``block``; on the CPU ``auto`` would take
``cpu-native``). ``chip_smoke.py`` pastes these values as constants
(``BLOCK_JAX``). The last line printed is one JSON object, case name →
verdict.

    JAX_PLATFORMS=cpu python scripts/port_block_jax_verdicts.py [--skip-large]

``--skip-large`` leaves the pds-20 class out (it holds ~5 GB and takes
minutes of an 8-core CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = {
    "pds10": (32, 432, 1400, 800),
    "pds20": (64, 432, 1400, 1600),
}


def verdict(name: str) -> dict:
    from distributedlpsolver_tpu.ipm import driver
    from distributedlpsolver_tpu.models.generators import block_angular_lp

    p = block_angular_lp(*CASES[name], seed=0, sparse=True, density=0.005)
    t0 = time.perf_counter()
    r = driver.solve(p, backend="block", tol=1e-8)
    return {
        "status": r.status.value, "iterations": r.iterations, "objective": r.objective,
        "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf,
        "seconds": round(time.perf_counter() - t0, 1),
    }


def verdict_file() -> dict:
    from distributedlpsolver_tpu import cli
    from distributedlpsolver_tpu.backends import auto
    from distributedlpsolver_tpu.io import write_mps
    from distributedlpsolver_tpu.models.generators import block_angular_lp

    route = auto.choose_backend_name
    auto.choose_backend_name = lambda inf, platform, detect=False: route(inf, "tpu", detect=detect)
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "pds10.mps")
            write_mps(block_angular_lp(*CASES["pds10"], seed=0, sparse=True, density=0.005), path)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["solve", path, "--json", "--quiet"])
    finally:
        auto.choose_backend_name = route
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    return {"rc": rc, "backend": out["backend"], "status": out["status"],
            "iterations": out["iterations"], "objective": out["objective"],
            "seconds": round(time.perf_counter() - t0, 1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-large", action="store_true", help="leave out the pds-20 class")
    args = ap.parse_args()
    out = {}
    for name in CASES:
        if args.skip_large and name == "pds20":
            continue
        out[name] = verdict(name)
        print(name, json.dumps(out[name]), flush=True)
    out["pds10_file"] = verdict_file()
    print("pds10_file", json.dumps(out["pds10_file"]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
