"""Command-line driver of the torch package: ``solve <file.mps> --backend=<name>``.

The port of the ``solve``, ``serve`` and ``backends`` subcommands of the
JAX package's ``cli.py``, with the flags this package honours plus
``--device``. Subcommands:

    solve       solve an MPS file to tolerance
    serve       async batching solve service: JSONL/MPS requests in,
                result records out
    backends    list registered SolverBackend names

``--backend auto`` (the default, as in the JAX CLI) picks a backend by
problem structure for ``--device``: on the card (``--device cuda``, the
default; it fails where there is none) every problem the port can solve
goes to ``cuda``; with ``--device cpu`` to ``cpu-native``. The chosen
backend is named in the result (``auto(<name>)``). ``--device cpu`` runs the card's path on the CPU.
Serving flags of the JAX CLI whose layer is not ported (``--quotas``,
``--brownout``, ``--mesh-devices`` above 1) are refused. The supervisor,
network and generate commands are not ported yet.

Run as ``python -m distributedlpsolver_tpu_torch.cli ...``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _add_solver_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--backend", default="auto",
        help="SolverBackend name (auto = pick by problem size/structure; see `backends`)",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the backend runs (cuda: the first card; no fallback)",
    )
    ap.add_argument("--tol", type=float, default=1e-8, help="relative gap/infeasibility tolerance")
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--quiet", action="store_true", help="suppress per-iteration log")
    ap.add_argument("--log-jsonl", default=None, help="write per-iteration JSONL here")
    ap.add_argument("--checkpoint", default=None, help="iterate checkpoint path")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument(
        "--factor-dtype", default="auto",
        help="Cholesky dtype: auto = the iterate dtype (float64); or float32/float64",
    )
    ap.add_argument(
        "--no-presolve", action="store_true",
        help="disable structural presolve (singleton/redundant rows, fixed cols)",
    )
    ap.add_argument(
        "--no-scale", action="store_true", help="disable Ruiz equilibration"
    )
    ap.add_argument("--json", action="store_true", help="print result as one JSON object")
    ap.add_argument("--x-out", default=None, help="write solution vector as .npy")


def _config_from(args) -> "SolverConfig":
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig

    return SolverConfig(
        tol=args.tol,
        max_iter=args.max_iter,
        verbose=not args.quiet,
        log_jsonl=args.log_jsonl,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        factor_dtype=args.factor_dtype,
        presolve=not args.no_presolve,
        scale=not args.no_scale,
    )


def _report(result, as_json: bool, x_out: Optional[str]) -> int:
    if x_out and result.x is not None:
        import numpy as np

        np.save(x_out, result.x)
    if as_json:
        print(
            json.dumps(
                {
                    "name": result.name,
                    "status": result.status.value,
                    "objective": result.objective,
                    "iterations": result.iterations,
                    "rel_gap": result.rel_gap,
                    "pinf": result.pinf,
                    "dinf": result.dinf,
                    "solve_time_s": result.solve_time,
                    "setup_time_s": result.setup_time,
                    "iters_per_sec": result.iters_per_sec,
                    "backend": result.backend,
                    "faults": [f.asdict() for f in result.faults],
                }
            )
        )
    else:
        print(result.summary())
    from distributedlpsolver_tpu_torch.ipm.state import Status

    return 0 if result.status == Status.OPTIMAL else 2


def cmd_solve(args) -> int:
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.io.mps import read_mps
    from distributedlpsolver_tpu_torch.ipm import solve

    problem = read_mps(args.file)
    backend = get_backend(args.backend, device=args.device)
    result = solve(problem, backend=backend, config=_config_from(args))
    return _report(result, args.json, args.x_out)


def _iter_request_specs(args):
    """Yield request-spec dicts from --requests (JSONL file or '-' =
    stdin) or --dir (sorted *.mps files, each one request, plus *.jsonl
    files of specs). A spec is ``{"mps": path}`` or ``{"m": .., "n": ..,
    "seed": ..}`` (generated standard-form), plus optional ``"id"``,
    ``"tol"``, ``"deadline_s"``."""
    import os

    if args.dir:
        for fname in sorted(os.listdir(args.dir)):
            path = os.path.join(args.dir, fname)
            if fname.endswith(".mps") or fname.endswith(".mps.gz"):
                yield {"mps": path, "id": fname}
            elif fname.endswith(".jsonl"):
                with open(path) as fh:
                    for line in fh:
                        if line.strip():
                            yield json.loads(line)
        return
    fh = sys.stdin if args.requests == "-" else open(args.requests)
    try:
        for line in fh:
            if line.strip():
                yield json.loads(line)
    finally:
        if fh is not sys.stdin:
            fh.close()


def _service_config_from(args) -> "ServiceConfig":
    """The ServiceConfig of the serving flags; the flags of layers that
    are not ported raise."""
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, ladder_from_json

    if args.quotas or args.brownout:
        raise NotImplementedError(
            "--quotas/--brownout: SLO admission and the brownout ladder are not ported to "
            "the torch package yet (ROADMAP Queue 1 item 14)"
        )
    buckets = None
    if args.buckets:
        with open(args.buckets) as fh:
            buckets = ladder_from_json(fh.read())
    return ServiceConfig(
        buckets=buckets,
        batch=args.batch,
        flush_s=args.flush_ms / 1e3,
        max_queue_depth=args.queue_depth,
        default_deadline_s=args.deadline_s or None,
        log_jsonl=args.log_jsonl,
        mesh_devices=args.mesh_devices,
        warm_start=not args.no_warm_start,
        warm_cache_entries=args.warm_cache_entries,
        solo_backend=args.solo_backend,
        journal_dir=args.journal_dir,
        journal_fsync=args.journal_fsync,
    )


def cmd_serve(args) -> int:
    """Serve loop: read LP requests, multiplex them through the async
    batching SolveService on ``--device``, write one JSONL result record
    per request; the service summary goes to stderr."""
    import time

    from distributedlpsolver_tpu_torch.io.mps import read_mps
    from distributedlpsolver_tpu_torch.models.generators import random_dense_lp
    from distributedlpsolver_tpu_torch.serve import ServiceOverloaded, SolveService
    from distributedlpsolver_tpu_torch.utils.logging import stamp_record

    svc_cfg = _service_config_from(args)
    solver_cfg = _config_from(args).replace(verbose=False, log_jsonl=None)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    n_failed = 0
    backoffs = 0
    backoff_s = 0.0
    try:
        with SolveService(svc_cfg, solver_config=solver_cfg, device=args.device) as svc:
            submitted = []
            for spec in _iter_request_specs(args):
                if "mps" in spec:
                    problem = read_mps(spec["mps"])
                else:
                    problem = random_dense_lp(
                        int(spec["m"]), int(spec["n"]), seed=int(spec.get("seed", 0)),
                    )
                while True:
                    try:
                        fut = svc.submit(
                            problem,
                            deadline=spec.get("deadline_s"),
                            tol=spec.get("tol"),
                            name=str(spec.get("id", problem.name)),
                            tenant=str(spec.get("tenant", "default")),
                            priority=str(spec.get("priority", "normal")),
                        )
                        break
                    except ServiceOverloaded as e:
                        # Backpressure: the reader outran the solver; wait
                        # as long as the verdict says (clamped).
                        wait = min(max(e.retry_after_s, 1e-3), 60.0)
                        backoffs += 1
                        backoff_s += wait
                        time.sleep(wait)
                submitted.append(fut)
            svc.drain()
            for fut in submitted:
                r = fut.result()
                n_failed += r.status.value == "failed"
                out.write(json.dumps(stamp_record(r.record())) + "\n")
            out.flush()
            summary = {
                **svc.stats(),
                "submit_backoffs": backoffs,
                "submit_backoff_s": round(backoff_s, 3),
            }
            print(json.dumps(summary), file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()
    return 2 if n_failed else 0


def _add_serving_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch", type=int, default=16, help="bucket slots")
    p.add_argument(
        "--flush-ms", type=float, default=50.0,
        help="oldest-request age that launches a part-full bucket",
    )
    p.add_argument(
        "--queue-depth", type=int, default=1024,
        help="admission-control bound on total queued requests",
    )
    p.add_argument(
        "--deadline-s", type=float, default=0.0, help="default per-request deadline (0 = none)",
    )
    p.add_argument(
        "--mesh-devices", type=int, default=0,
        help="0/1 = unsharded (more is not ported and is refused)",
    )
    p.add_argument(
        "--buckets", default=None,
        help="explicit bucket ladder JSON (the autotune output) instead of auto "
        "power-of-two buckets",
    )
    p.add_argument(
        "--solo-backend", default="auto",
        help="backend of the per-request solo path, for --device (auto = pick by problem "
        "size/structure; see `backends`)",
    )
    p.add_argument(
        "--no-warm-start", action="store_true",
        help="disable the warm-start & amortization layer (fingerprint cache)",
    )
    p.add_argument(
        "--warm-cache-entries", type=int, default=512,
        help="bounded LRU capacity of the problem-fingerprint warm cache",
    )
    p.add_argument("--quotas", default=None, help="SLO admission policy (not ported: refused)")
    p.add_argument("--brownout", default=None, help="overload brownout ladder (not ported: refused)")
    p.add_argument(
        "--journal-dir", default=None,
        help="durable job journal directory: write-ahead request log + on-disk results; "
        "a restart against it replays unfinished work",
    )
    p.add_argument(
        "--journal-fsync", default="flush", choices=["none", "flush", "always"],
        help="journal persistence per record",
    )


def cmd_backends(_args) -> int:
    from distributedlpsolver_tpu_torch.backends import available_backends

    for name in available_backends():
        print(name)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="distributedlpsolver_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_solve = sub.add_parser("solve", help="solve an MPS file")
    ap_solve.add_argument("file", help="MPS path (optionally .gz)")
    _add_solver_flags(ap_solve)
    ap_solve.set_defaults(fn=cmd_solve)

    ap_srv = sub.add_parser(
        "serve", help="async batching solve service: JSONL/MPS requests in, result records out",
    )
    src = ap_srv.add_mutually_exclusive_group(required=True)
    src.add_argument("--requests", help="JSONL request file, or '-' for stdin")
    src.add_argument("--dir", help="directory of *.mps requests and/or *.jsonl spec files")
    ap_srv.add_argument("--out", default="-", help="result JSONL path ('-' = stdout)")
    _add_serving_flags(ap_srv)
    _add_solver_flags(ap_srv)
    ap_srv.set_defaults(fn=cmd_serve, quiet=True)

    ap_b = sub.add_parser("backends", help="list registered backends")
    ap_b.set_defaults(fn=cmd_backends)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
