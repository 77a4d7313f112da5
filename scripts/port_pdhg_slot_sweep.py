#!/usr/bin/env python3
"""Solve one request of ``chip_smoke.py``'s PDHG wave in every slot of one
PDHG bucket, and count the slots whose OPTIMAL answer misses the wave's
request-level bound (``chip_smoke.PDHG_REQUEST_KKT_BOUND``).

A lane's step size comes from a power iteration started at row ``seeds[k]``
of a table of B vectors (``backends/first_order.py``). The serve layer
passes ``pdhg_seed(name, B) = crc32(name) mod B``, so a request's verdict
no longer depends on the slot arrival timing gives it. The sweep gives the
request every seed index in turn (what every slot gave it when the slot
was the seed) and runs on the CPU (the engine's code is the card's):

    python scripts/port_pdhg_slot_sweep.py [--request sparse_req_96x384_r402] [--slots 256]

It prints the request, its own seed index and whether it passes there,
the bucket's seconds, and each seed index over the bound with its (pinf,
dinf, gap) on the request's own data.

``--wave-cpu`` checks the whole loose stream of the wave under the rule,
on the CPU: every request in buckets of ``--slots`` lanes at its own seed
index, each OPTIMAL answer held to the tol on the padded problem and to
``PDHG_REQUEST_KKT_BOUND`` on its own data; lanes left short of the tol
(which cross over to the solo IPM in the service) are listed:

    python scripts/port_pdhg_slot_sweep.py --wave-cpu

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
    ap.add_argument("--wave-cpu", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.waves:
        return waves(root, args.waves)
    if args.wave_cpu:
        return wave_cpu(root, args.slots)
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
    # Lane k starts from table row k: the sweep covers every seed index.
    r = first_order.solve_pdhg_bucket(batch, np.ones(B, bool), SolverConfig(tol=tol), device="cpu")
    print(f"{p.name} {p.A.shape} tol {tol:g}: {B} seed indices in {time.perf_counter() - t0:.1f} s")
    over = []
    for k in range(B):
        if r.status[k].value != "optimal":
            continue
        x, y = np.asarray(r.x[k]), np.asarray(r.dual[k])
        e = cs.host_kkt(p.c, p.A, p.rlb, x[: p.n], y[: p.m])
        if any(v > lim for v, lim in zip(e, cs.PDHG_REQUEST_KKT_BOUND)):
            over.append((k, e))
    optimal = sum(s.value == "optimal" for s in r.status)
    own = first_order.pdhg_seed(p.name, B)
    own_ok = r.status[own].value == "optimal" and own not in {k for k, _ in over}
    print(f"OPTIMAL in {optimal} of {B} seed indices; over the bound "
          f"{cs.PDHG_REQUEST_KKT_BOUND} in {len(over)}:")
    for k, e in over:
        print(f"  seed index {k}: pinf {e[0]:.3e} dinf {e[1]:.3e} gap {e[2]:.4e}")
    print(f"{p.name}: its own seed index pdhg_seed(name, {B}) = {own}: "
          f"{'passes' if own_ok else 'FAILS'} ({r.status[own].value})")
    return 0


def wave_cpu(root, B) -> int:
    """The wave's loose stream under the seed rule, on the CPU (see the
    module note). Exit 1 if an OPTIMAL answer breaks a bound."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import first_order
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models import sparse_request_stream
    from distributedlpsolver_tpu_torch.models.generators import BatchedLP
    from distributedlpsolver_tpu_torch.serve import pad_standard_form, standard_form

    cs = _chip_smoke(root)
    stream = list(sparse_request_stream(1024, shapes=((96, 384), (cs.BM, cs.BN)), seed=25))
    t0 = time.perf_counter()
    bad, short, worst = [], [], [0.0] * 3
    for lo in range(0, len(stream), B):
        chunk = stream[lo:lo + B]
        tols = {t for _, t in chunk}
        if len(tols) != 1:
            raise SystemExit(f"the stream mixes tolerances {tols}")
        padded = [pad_standard_form(*standard_form(p), cs.BM, cs.BN) for p, _ in chunk]
        padded += [padded[0]] * (B - len(chunk))
        batch = BatchedLP(c=np.stack([q[0] for q in padded]), A=np.stack([q[1] for q in padded]),
                          b=np.stack([q[2] for q in padded]))
        active = np.arange(B) < len(chunk)
        seeds = np.arange(B)
        seeds[:len(chunk)] = [first_order.pdhg_seed(p.name, B) for p, _ in chunk]
        r = first_order.solve_pdhg_bucket(batch, active, SolverConfig(tol=tols.pop()),
                                          device="cpu", seeds=seeds)
        for k, (p, tol) in enumerate(chunk):
            if r.status[k].value != "optimal":
                short.append((lo + k, p.name, r.status[k].value))
                continue
            x, y = np.asarray(r.x[k]), np.asarray(r.dual[k])
            ep = cs.host_kkt(*padded[k], x, y)
            eo = cs.host_kkt(p.c, p.A, p.rlb, x[: p.n], y[: p.m])
            worst = [max(a, v) for a, v in zip(worst, eo)]
            if max(ep) > tol or any(v > lim for v, lim in zip(eo, cs.PDHG_REQUEST_KKT_BOUND)):
                bad.append((lo + k, p.name, ep, eo))
        print(f"requests {lo}..{lo + len(chunk) - 1}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{len(stream)} loose requests at their own seed index: {len(short)} short of the tol "
          f"(solo IPM crossover) {short}; request-data KKT max pinf/dinf/gap "
          f"{worst} against the bound {cs.PDHG_REQUEST_KKT_BOUND}; {len(bad)} over a bound")
    for k, name, ep, eo in bad:
        print(f"  request {k} {name}: padded {ep}, own data {eo}")
    return 1 if bad else 0


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
