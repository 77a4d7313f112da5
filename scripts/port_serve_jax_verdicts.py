#!/usr/bin/env python3
"""The JAX package's verdict for the requests of ``chip_smoke.py``'s serve
phase, on the CPU, and the port's beside it where a verdict depends on the
warm cache.

Each wave's requests are padded into the serve bucket's (128, 512) exactly
as the service packs them and solved through the JAX package's bucket
engine (``backends/batched.py::solve_bucket``, in slices of ``--slice``
slots: a slot's path does not depend on its batch-mates). A member left
unfinished then goes the JAX service's solo way
(``supervisor.supervised_solve``): cold on the ``"auto"`` backend, and —
for a member whose model has earlier requests in the wave (the correlated
wave) — warm-started from the warm cache as the service would hold it,
the bucket iterate of each of its last ``--cache-members`` same-model
predecessors, through BOTH packages (the port on the CPU), which must
agree. The JSON printed last maps each wave to ``{request index: [the
verdicts seen]}`` for the requests not always answered OPTIMAL.

The PDHG wave's two streams (``--streams pdhg``) go the same way through
the JAX service's tolerance tiers: the loose stream
(``sparse_request_stream(1024, seed=25)`` at its tol 1e-4) through the
JAX bucketed PDHG engine (``backends/first_order.py::solve_pdhg_bucket``)
in buckets of 256 slots with each request at slot
``pdhg_seed(name, 256)`` — the JAX engine seeds a lane's power iteration
with its slot, the port with that index whatever the slot, so there the
two run the same lane — and a lane left short of its tol through the JAX
solo ladder at that tol (the crossover); the tight stream
(``random_request_stream(80, seed=26)`` at 1e-8; the PDHG wave takes its
first 64, the network plane's inline and MPS requests all 80) through the
IPM bucket engine and its solo ladder. Their verdicts carry the engine:
``"pdhg:optimal"``, ``"ipm:optimal"`` (a crossover's), and so on.

    JAX_PLATFORMS=cpu python scripts/port_serve_jax_verdicts.py [--streams ipm|pdhg|all]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

M, N = 128, 512


def waves(gen):
    """The serve phase's three waves (chip_smoke.py, serve_phase), from a
    package's generators module."""
    shapes = ((96, 384), (M, N))
    return {
        "cold": list(gen.random_request_stream(1024, shapes=shapes, seed=21)),
        "warm": list(gen.random_request_stream(1024, shapes=shapes, seed=22)),
        "correlated": list(gen.correlated_request_stream(512, shapes=((M, N),), n_models=4,
                                                         seed=23)),
    }


def pdhg_waves(gen):
    """The PDHG wave's streams (chip_smoke.py, pdhg_wave): loose requests
    at their tol 1e-4 and tight ones at 1e-8."""
    return {
        "pdhg_loose": list(gen.sparse_request_stream(1024, shapes=((96, 384), (M, N)), seed=25)),
        "pdhg_tight": [(p, 1e-8) for p in gen.random_request_stream(80, shapes=((M, N),),
                                                                     seed=26)],
    }


def jax_bucket(problems, B, engine="ipm", tol=1e-8):
    """The JAX bucket result of each request (status, iterate)."""
    from distributedlpsolver_tpu.backends.batched import solve_bucket
    from distributedlpsolver_tpu.backends.first_order import solve_pdhg_bucket
    from distributedlpsolver_tpu.ipm.config import SolverConfig
    from distributedlpsolver_tpu.models.generators import BatchedLP
    from distributedlpsolver_tpu.serve import pad_standard_form, standard_form

    rows = [pad_standard_form(*standard_form(p), M, N) for p in problems]
    fn = solve_pdhg_bucket if engine == "pdhg" else solve_bucket
    out = []
    for lo in range(0, len(rows), B):
        part = rows[lo:lo + B]
        live = len(part)
        part = part + [part[0]] * (B - live)
        c, A, b = (np.stack(v) for v in zip(*part))
        r = fn(BatchedLP(c=c, A=A, b=b, name=f"[{lo}]"), np.arange(B) < live,
               SolverConfig(tol=tol))
        if r.y is None:  # the PDHG engine returns no dual iterate
            r.y = r.s = r.w = r.z = r.x
        for k in range(live):
            p = problems[lo + k]
            out.append((r.status[k], tuple(np.asarray(v[k]) for v in (r.x, r.y, r.s, r.w, r.z)),
                        p.m, p.n))
    return out


def jax_pdhg_at_seed_slots(problems, B, tol):
    """The JAX PDHG bucket status of each request, each at slot
    ``pdhg_seed(name, B)`` of a bucket of ``B`` slots: the requests are
    packed greedily, at most one per slot in a dispatch."""
    from distributedlpsolver_tpu.backends.first_order import solve_pdhg_bucket
    from distributedlpsolver_tpu.ipm.config import SolverConfig
    from distributedlpsolver_tpu.models.generators import BatchedLP
    from distributedlpsolver_tpu.serve import pad_standard_form, standard_form
    from distributedlpsolver_tpu_torch.backends.first_order import pdhg_seed

    rows = [pad_standard_form(*standard_form(p), M, N) for p in problems]
    todo = list(range(len(problems)))
    out = {}
    while todo:
        slots, rest = {}, []
        for k in todo:
            slot = pdhg_seed(problems[k].name, B)
            (rest.append(k) if slot in slots else slots.__setitem__(slot, k))
        part = [rows[slots[j]] if j in slots else rows[todo[0]] for j in range(B)]
        c, A, b = (np.stack(v) for v in zip(*part))
        r = solve_pdhg_bucket(BatchedLP(c=c, A=A, b=b, name="seeded"),
                              np.array([j in slots for j in range(B)]), SolverConfig(tol=tol))
        for j, k in slots.items():
            out[k] = r.status[j]
        print(f"  seeded dispatch: {len(slots)} requests, {len(rest)} left", flush=True)
        todo = rest
    return [out[k] for k in range(len(problems))]


def warm_solo(pkg, problem, prior, m, n):
    """The solo solve of ``problem`` with a warm cache holding ``prior``
    (the real slice of a bucket iterate), through one package."""
    if pkg == "jax":
        from distributedlpsolver_tpu.ipm.state import IPMState
        from distributedlpsolver_tpu.serve.warmcache import WarmCache
        from distributedlpsolver_tpu.supervisor import SupervisorConfig, supervised_solve
        from distributedlpsolver_tpu.utils.fingerprint import structural_fingerprint
        backend = "tpu"
    else:
        from distributedlpsolver_tpu_torch.backends import get_backend
        from distributedlpsolver_tpu_torch.ipm.state import IPMState
        from distributedlpsolver_tpu_torch.serve.warmcache import WarmCache
        from distributedlpsolver_tpu_torch.supervisor import SupervisorConfig, supervised_solve
        from distributedlpsolver_tpu_torch.utils.fingerprint import structural_fingerprint
        backend = get_backend("cuda", device="cpu")
    x, y, s, w, z = prior
    cache = WarmCache(4)
    cache.store(structural_fingerprint(problem.A, problem.m, problem.n, problem.lb, problem.ub),
                m=m, n=n, state=IPMState(x[:n], y[:m], s[:n], w[:n], z[:n]), tol=1e-8)
    r = supervised_solve(problem, backend=backend, supervisor=SupervisorConfig(backoff_base=0.01),
                         warm_cache=cache)
    return r.status.value, r.iterations, r.warm


def pdhg_verdicts(slice_slots: int) -> dict:
    """``{stream: {request index: [verdicts seen]}}`` of the PDHG wave's
    requests not always answered ``<engine>:optimal`` by the JAX tiers."""
    from distributedlpsolver_tpu.ipm.state import Status
    from distributedlpsolver_tpu.models import generators as jgen
    from distributedlpsolver_tpu.supervisor import SupervisorConfig, supervised_solve

    verdicts = {}
    for tag, stream in pdhg_waves(jgen).items():
        t0 = time.perf_counter()
        problems, tol = [p for p, _ in stream], stream[0][1]
        engine = "pdhg" if tag == "pdhg_loose" else "ipm"
        seen = {k: set() for k in range(len(problems))}
        B = 256 if engine == "pdhg" else slice_slots
        if engine == "pdhg":
            statuses = jax_pdhg_at_seed_slots(problems, B, tol)
        else:
            statuses = [st for st, *_ in jax_bucket(problems, B, engine, tol)]
        for k, st in enumerate(statuses):
            if st is Status.OPTIMAL:
                seen[k].add(f"{engine}:optimal")
                continue
            try:  # the crossover / solo ladder at the request's tol
                r = supervised_solve(problems[k], backend="auto", tol=tol,
                                     supervisor=SupervisorConfig(backoff_base=0.01))
                v = r.status.value
            except Exception:  # SolveFailure: the service's FAILED verdict
                v = "failed"
            seen[k].add(f"{engine}:{v}")
            print(f"{tag} {k} {problems[k].name}: bucket {st.value}, solo {v}")
        out = {k: sorted(v) for k, v in seen.items() if v != {f"{engine}:optimal"}}
        verdicts[tag] = out
        print(f"{tag}: {len(problems)} requests at tol {tol:g} on {engine}, {len(out)} not always "
              f"OPTIMAL, {time.perf_counter() - t0:.1f} s")
    return verdicts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slice", type=int, default=64, help="bucket slots a JAX dispatch holds")
    ap.add_argument("--cache-members", type=int, default=4,
                    help="same-model predecessors whose iterate a warm solo starts from")
    ap.add_argument("--streams", choices=("ipm", "pdhg", "all"), default="all",
                    help="the three IPM waves, the PDHG wave's two streams, or both")
    args = ap.parse_args()
    if args.streams == "pdhg":
        print(json.dumps(pdhg_verdicts(args.slice)))
        return 0

    from distributedlpsolver_tpu.ipm.state import Status
    from distributedlpsolver_tpu.models import generators as jgen
    from distributedlpsolver_tpu.supervisor import SupervisorConfig, supervised_solve
    from distributedlpsolver_tpu_torch.models import generators as tgen

    port_waves = waves(tgen)
    verdicts = {}
    for tag, problems in waves(jgen).items():
        t0 = time.perf_counter()
        bucket = jax_bucket(problems, args.slice)
        out = {}
        for k, (st, _, m, n) in enumerate(bucket):
            if st is Status.OPTIMAL:
                continue
            seen = set()
            try:
                cold = supervised_solve(problems[k], backend="auto",
                                        supervisor=SupervisorConfig(backoff_base=0.01))
                seen.add(cold.status.value)
                print(f"{tag} {k} {problems[k].name}: bucket {st.value}, cold solo "
                      f"{cold.status.value} {cold.iterations}")
            except Exception as e:  # SolveFailure: the service's FAILED verdict
                seen.add("failed")
                print(f"{tag} {k}: {type(e).__name__}: {e}")
            model = problems[k].name.split("_")[1] if tag == "correlated" else None
            preds = [j for j in range(k) if model and problems[j].name.split("_")[1] == model
                     and bucket[j][0] is Status.OPTIMAL][-args.cache_members:]
            for j in preds:
                rj = warm_solo("jax", problems[k], bucket[j][1], m, n)
                rt = warm_solo("port", port_waves[tag][k], bucket[j][1], m, n)
                seen.add(rj[0])
                print(f"{tag} {k}: warm from {j}: jax {rj}, port {rt}"
                      + ("" if rj == rt else "  <-- DIFFERENT"))
            if seen != {"optimal"}:
                out[k] = sorted(seen)
        verdicts[tag] = out
        print(f"{tag}: {len(problems)} requests, {len(out)} not always OPTIMAL, "
              f"{time.perf_counter() - t0:.1f} s")
    if args.streams == "all":
        verdicts.update(pdhg_verdicts(args.slice))
    print(json.dumps(verdicts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
