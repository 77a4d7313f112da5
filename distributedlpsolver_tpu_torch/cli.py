"""Command-line driver of the torch package: ``solve <file.mps> --backend=<name>``.

The port of the ``solve`` and ``backends`` subcommands of the JAX
package's ``cli.py``, with the solver flags this package honours plus
``--device``. Subcommands:

    solve       solve an MPS file to tolerance
    backends    list registered SolverBackend names

``--device cuda`` (the default) runs on the first CUDA card and fails
where there is none; ``--device cpu`` runs the same path on the CPU.
The supervisor, serve, network and generate commands are not ported yet.

Run as ``python -m distributedlpsolver_tpu_torch.cli ...``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _add_solver_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--backend", default="cuda",
        help="SolverBackend name (cuda = dense/torch, the only one ported)",
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

    ap_b = sub.add_parser("backends", help="list registered backends")
    ap_b.set_defaults(fn=cmd_backends)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
