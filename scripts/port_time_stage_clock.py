#!/usr/bin/env python3
"""What the scenario tier's stage times cost on the card: warm solves of
the main path (``two_stage_storm(1024, 24, 36, 24, 2, seed=1)`` through
``ScenarioBackend``) with the stage clock's CUDA events on and off, in
``--pairs`` pairs whose order alternates (on first, then off first).

"Off" patches ``backends/scenario.py::_StageClock`` so that it records
nothing (``schur_ms``/``link_ms``/``solve_ms`` stay 0); x must be the
same bits either way. Prints one JSON line with each side's solve times,
medians and quartiles, the pairs each side won, the applications of a
solve, and the card's name and power limit.

    python scripts/port_time_stage_clock.py [--pairs 10]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def stage_clock_off(sc):
    saved = sc._StageClock.mark, sc._StageClock.add
    sc._StageClock.mark = lambda self: None
    sc._StageClock.add = lambda self, key, t0, t1: None
    try:
        yield
    finally:
        sc._StageClock.mark, sc._StageClock.add = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_time_stage_clock: no CUDA device")
        return 2
    from distributedlpsolver_tpu_torch.backends import scenario as sc
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import two_stage_storm

    p = two_stage_storm(1024, 24, 36, 24, 2, seed=1).to_block_angular()

    def one(on):
        with contextlib.nullcontext() if on else stage_clock_off(sc):
            r = solve(p, backend=sc.ScenarioBackend(), tol=1e-8)
        return r, sc.last_solve_report()

    ref, rep = one(True)  # warm-up: kernels built, library handles made
    times = {True: [], False: []}
    for i in range(args.pairs):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            r, rep_i = one(on)
            if not np.array_equal(r.x, ref.x) or r.iterations != ref.iterations:
                raise SystemExit(f"x or iterations differ with the stage clock {'on' if on else 'off'}")
            if (rep_i["schur_ms"] > 0) != on:
                raise SystemExit("the stage clock's switch did not take")
            times[on].append(r.solve_time)

    def quart(v):
        q = statistics.quantiles(v, n=4)
        return {"median": statistics.median(v), "q1": q[0], "q3": q[2]}

    on, off = quart(times[True]), quart(times[False])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "problem": p.name, "iterations": ref.iterations, "applications": rep["solves"],
        "solve_s_on": times[True], "solve_s_off": times[False], "on": on, "off": off,
        "pairs_off_faster": sum(b < a for a, b in zip(times[True], times[False])),
        "pairs": args.pairs, "cost_ms_median": 1e3 * (on["median"] - off["median"]),
        "cost_us_per_application": 1e6 * (on["median"] - off["median"]) / rep["solves"],
        "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
