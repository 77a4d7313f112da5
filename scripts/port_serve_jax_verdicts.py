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

    JAX_PLATFORMS=cpu python scripts/port_serve_jax_verdicts.py
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


def jax_bucket(problems, B):
    """The JAX bucket result of each request (status, iterate)."""
    from distributedlpsolver_tpu.backends.batched import solve_bucket
    from distributedlpsolver_tpu.models.generators import BatchedLP
    from distributedlpsolver_tpu.serve import pad_standard_form, standard_form

    rows = [pad_standard_form(*standard_form(p), M, N) for p in problems]
    out = []
    for lo in range(0, len(rows), B):
        part = rows[lo:lo + B]
        live = len(part)
        part = part + [part[0]] * (B - live)
        c, A, b = (np.stack(v) for v in zip(*part))
        r = solve_bucket(BatchedLP(c=c, A=A, b=b, name=f"[{lo}]"), np.arange(B) < live)
        for k in range(live):
            p = problems[lo + k]
            out.append((r.status[k], tuple(np.asarray(v[k]) for v in (r.x, r.y, r.s, r.w, r.z)),
                        p.m, p.n))
    return out


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slice", type=int, default=64, help="bucket slots a JAX dispatch holds")
    ap.add_argument("--cache-members", type=int, default=4,
                    help="same-model predecessors whose iterate a warm solo starts from")
    args = ap.parse_args()

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
    print(json.dumps(verdicts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
