#!/usr/bin/env python3
"""Members of ``random_batched_lp(1024, 128, 512, seed)`` through the batched
solver of both packages on the CPU: the PyTorch port's
(``distributedlpsolver_tpu_torch.backends.batched.solve_batched``) and the
JAX package's, on the same numpy arrays, and each member alone through both
dense solvers.

Lanes of a batched solve are independent, so a slice of the batch follows
the same per-member path as the full batch in the unsegmented schedule.

    JAX_PLATFORMS=cpu python scripts/port_batched_cpu_parity.py --members 775:776
    JAX_PLATFORMS=cpu python scripts/port_batched_cpu_parity.py --members 768:832 --segment-iters 8

Prints, per package, each non-optimal member's status, iterations,
rel_gap and pinf, the slice's iteration range and the phase rows, then
whether statuses and iterations agree and the largest relative objective
gap. ``--solo`` adds the dense solo solves of the slice's non-optimal
members.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--members", default="775:776", help="slice lo:hi of the batch")
    ap.add_argument("--segment-iters", type=int, default=0)
    ap.add_argument("--solo", action="store_true")
    args = ap.parse_args()

    from distributedlpsolver_tpu.backends import batched as jbatched
    from distributedlpsolver_tpu.ipm import solve as jax_solve
    from distributedlpsolver_tpu.models.generators import BatchedLP as JaxBatchedLP
    from distributedlpsolver_tpu_torch.backends import batched as tbatched
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.interop import batched_lp_from_arrays
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_batched_lp

    full = random_batched_lp(args.batch, args.m, args.n, seed=args.seed)
    lo, hi = (int(v) for v in args.members.split(":"))
    A, b, c = (np.array(getattr(full, f)[lo:hi]) for f in ("A", "b", "c"))
    del full
    name = f"members[{lo}:{hi}]"
    tb = batched_lp_from_arrays(A, b, c, name)
    jb = JaxBatchedLP(c=c.copy(), A=A.copy(), b=b.copy(), name=name)
    kw = {"tol": 1e-8, "segment_iters": args.segment_iters}
    results = {}
    for pkg, run in (("torch", lambda: tbatched.solve_batched(tb, device="cpu", **kw)),
                     ("jax", lambda: jbatched.solve_batched(jb, **kw))):
        t0 = time.perf_counter()
        r = run()
        results[pkg] = r
        bad = [(lo + k, r.status[k].value, int(r.iterations[k]), float(r.rel_gap[k]), float(r.pinf[k]))
               for k in range(hi - lo) if r.status[k].value != "optimal"]
        print(f"{pkg}: {r.n_optimal}/{hi - lo} optimal, iterations {int(r.iterations.min())}.."
              f"{int(r.iterations.max())}, not optimal {bad}, {time.perf_counter() - t0:.1f} s")
        print(f"{pkg}: phase rows {r.phase_report}")
    rt, rj = results["torch"], results["jax"]
    same = [s.value for s in rt.status] == [s.value for s in rj.status]
    rel = np.abs(rt.objective - rj.objective) / (1.0 + np.abs(rj.objective))
    print(f"same statuses {same}, same iterations {np.array_equal(rt.iterations, rj.iterations)}, "
          f"objective max rel {rel.max():.3e}")
    if args.solo:
        for k in range(hi - lo):
            if rt.status[k].value == "optimal":
                continue
            st = solve(tbatched.member_interior_form(tb, k), backend=get_backend("cuda", device="cpu"),
                       tol=1e-8)
            sj = jax_solve(jbatched.member_interior_form(jb, k), backend="tpu", tol=1e-8)
            print(f"member {lo + k} solo: torch {st.status.value} {st.iterations} it {st.objective!r}, "
                  f"jax {sj.status.value} {sj.iterations} it {sj.objective!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
