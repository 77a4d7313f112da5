#!/usr/bin/env python3
"""Host-clock time an iteration of the host backends (``cpu``,
``cpu-native``) in both packages, on request-sized problems.

The JAX package's host backends run its IPM core with ``xp=numpy``; the
port's run its torch core on CPU tensors (``backends/cpu.py``). Each
problem is solved once to warm up and then ``--repeat`` times, without
the supervisor (the serve solo path adds a per-iteration checkpoint and a
watchdog on top), and the best wall time over the iterations is printed
beside the host's CPU model and thread counts. CPU numbers, not card
numbers.

    JAX_PLATFORMS=cpu python scripts/port_time_host_backends.py [--repeat 3]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = [("random_dense_lp", (128, 512), 0), ("random_dense_lp", (96, 384), 1)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()

    import torch

    from distributedlpsolver_tpu.ipm import solve as jax_solve
    from distributedlpsolver_tpu.models import generators as jgen
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import generators as tgen
    from distributedlpsolver_tpu_torch.native import load

    print(f"host: {platform.processor() or platform.machine()} x{os.cpu_count()}, torch threads "
          f"{torch.get_num_threads()}, dlps_num_threads {load().dlps_num_threads()}")
    for fn, shape, seed in CASES:
        for backend in ("cpu", "cpu-native"):
            row = {"problem": f"{fn}{shape} seed {seed}", "backend": backend}
            for pkg, run, gen in (("jax", lambda p: jax_solve(p, backend=backend), jgen),
                                  ("port", lambda p: solve(p, backend=get_backend(backend)), tgen)):
                p = getattr(gen, fn)(*shape, seed=seed)
                r = run(p)  # warm-up
                best = min(_timed(run, p) for _ in range(args.repeat))
                row[pkg] = {"iterations": r.iterations, "ms": 1e3 * best,
                            "ms_per_iteration": 1e3 * best / max(r.iterations, 1)}
            print(json.dumps(row))
    return 0


def _timed(run, p) -> float:
    t0 = time.perf_counter()
    run(p)
    return time.perf_counter() - t0


if __name__ == "__main__":
    sys.exit(main())
