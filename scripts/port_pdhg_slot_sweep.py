#!/usr/bin/env python3
"""Solve one request of ``chip_smoke.py``'s PDHG wave in every slot of one
PDHG bucket, and count the slots whose OPTIMAL answer misses the wave's
request-level bound (``chip_smoke.PDHG_REQUEST_KKT_BOUND``).

A lane's step size comes from a power iteration seeded by its slot
(``backends/first_order.py``), and which slot a request takes in the
serve wave depends on arrival timing; so a request whose answer misses
the bound in some slots fails that check on the runs that put it there.
The sweep runs on the CPU (the engine's code is the card's):

    python scripts/port_pdhg_slot_sweep.py [--request sparse_req_96x384_r402] [--slots 256]

It prints the request, the bucket's seconds, and each slot over the bound
with its (pinf, dinf, gap) on the request's own data.

``--waves K`` serves the whole wave instead, K + 1 times on one card,
through ``chip_smoke.pdhg_wave`` on one service of the default
configuration (as ``chip_smoke.py``'s serve phase runs it, without the
IPM waves before it; the first wave is a warm-up and not counted), and
prints each wave's verdict: passed, or the check that failed.
``--root DIR`` takes the package and ``chip_smoke.py`` from the checkout
at DIR (for example the parent commit unpacked into an ignored
directory), so that two trees' rates are measured in one call:

    python scripts/port_pdhg_slot_sweep.py --waves 8 [--root DIR]
"""

import argparse
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--request", default="sparse_req_96x384_r402")
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--waves", type=int, default=0)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.waves:
        return waves(root, args.waves)
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import first_order
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models import sparse_request_stream
    from distributedlpsolver_tpu_torch.models.generators import BatchedLP
    from distributedlpsolver_tpu_torch.serve import pad_standard_form, standard_form

    cs = _chip_smoke(root)
    # The wave's loose stream (chip_smoke.pdhg_wave) and bucket (BM, BN).
    stream = sparse_request_stream(1024, shapes=((96, 384), (cs.BM, cs.BN)), seed=25)
    p, tol = next((q, t) for q, t in stream if q.name == args.request)
    c, A, b = pad_standard_form(*standard_form(p), cs.BM, cs.BN)
    B = args.slots
    batch = BatchedLP(A=np.repeat(A[None], B, 0), b=np.repeat(b[None], B, 0),
                      c=np.repeat(c[None], B, 0))
    t0 = time.perf_counter()
    r = first_order.solve_pdhg_bucket(batch, np.ones(B, bool), SolverConfig(tol=tol), device="cpu")
    print(f"{p.name} {p.A.shape} tol {tol:g}: {B} slots in {time.perf_counter() - t0:.1f} s")
    over = []
    for k in range(B):
        if r.status[k].value != "optimal":
            continue
        x, y = np.asarray(r.x[k]), np.asarray(r.dual[k])
        e = cs.host_kkt(p.c, p.A, p.rlb, x[: p.n], y[: p.m])
        if any(v > lim for v, lim in zip(e, cs.PDHG_REQUEST_KKT_BOUND)):
            over.append((k, e))
    optimal = sum(s.value == "optimal" for s in r.status)
    print(f"OPTIMAL in {optimal} of {B} slots; over the bound {cs.PDHG_REQUEST_KKT_BOUND} in "
          f"{len(over)}:")
    for k, e in over:
        print(f"  slot {k}: pinf {e[0]:.3e} dinf {e[1]:.3e} gap {e[2]:.4e}")
    return 0


def _chip_smoke(root):
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def waves(root, k) -> int:
    """``k`` PDHG waves on the card (see the module note)."""
    import torch

    from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService

    cs = _chip_smoke(root)
    ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")
    torch.backends.cuda.matmul.allow_tf32 = False
    ne.load_library()
    card = cs.card_line()
    failed = 0
    with SolveService(ServiceConfig(batch=cs.SERVE_BATCH, flush_s=0.02)) as svc:
        # A first wave, not counted: it builds the programs that
        # chip_smoke.py's IPM waves build before its PDHG wave, so it fails
        # the wave's no-build check.
        for w in range(k + 1):
            try:
                cs.pdhg_wave(torch, ne, svc, card)
                print(f"wave {w}: passed" + (" (warm-up, not counted)" if w == 0 else ""))
            except SystemExit as e:
                failed += w > 0
                print(f"wave {w}: {e}" + (" (warm-up, not counted)" if w == 0 else ""))
    print(f"{root}: {failed} of {k} PDHG waves failed [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
