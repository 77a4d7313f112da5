#!/usr/bin/env python3
"""Where the two-phase schedule's f32 phases break down on the card.

Runs ``random_dense_lp(m, n, seed)`` (default the main path's
2048×10240) through ``DenseTorchBackend(schedule_platform="tpu")`` on the
segmented route, uncaptured, under the two-phase direct plan (and with
``--pcg`` the three-phase PCG plan too), four times each: every f32
normal matrix (phase 1's, the PCG preconditioner's, the closure's G)
assembled by K1 or by one cuBLAS f32 product (``(A·d)·Aᵀ``, TF32 off),
and phase 1's f32 factorization done by cuSOLVER on the card or by
LAPACK on the host (the matrix copied over). Each run prints its verdict,
each phase's iterations and bad steps, and every f32 direct
factorization that failed on the card or would have failed on the host
(its index, regularization and ``info``). Then, at the d of the first
factorization that failed with K1 and cuSOLVER (else the last of phase
1), both f32 assemblies of the solve's (scaled) A against the f64
product: the Frobenius-relative error, the largest relative error on the
diagonal, and the Cholesky ``info`` of each at the base regularization;
the script exits 1 where K1's M is the farther from the f64 product on
either measure (K1's f32 design is held to one cuBLAS product there).

Every line ends with the card's name and power limit. Needs one card:

    python3 scripts/port_two_phase_probe.py [--m 2048 --n 10240 --seed 0] [--pcg]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--n", type=int, default=10240)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pcg", action="store_true", help="also run the three-phase PCG plan")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_two_phase_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from distributedlpsolver_tpu_torch.backends import dense
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp
    from distributedlpsolver_tpu_torch.ops import kernel_build

    ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")
    kernel_build.build(ne.build_job())
    ne.load_library()
    tag = card()
    orig = dense._cholesky_ops
    mode = {}
    log = []  # per f32 factorization: (reg, info on the card's route, info of LAPACK, d)

    def assemble(Af, d):
        if mode["asm"] == "k1" or Af.dtype != torch.float32:
            return ne.normal_eq(Af, d)
        return (Af * d[None, :]) @ Af.T

    def cholesky_ops(A, factor_dtype, refine_steps, Af=None, tri_solves=False, assemble_=None):
        if factor_dtype != torch.float32:
            return orig(A, factor_dtype, refine_steps, Af, tri_solves, assemble_)
        _, solve_ = orig(A, factor_dtype, refine_steps, Af, tri_solves, assemble_)

        def factorize(d, reg):
            M = assemble(Af, d.to(torch.float32))
            diag = M.diagonal()
            diag.add_(diag * reg)
            L_host, info_host = torch.linalg.cholesky_ex(M.cpu())
            if mode["chol"] == "cusolver":
                L, info = torch.linalg.cholesky_ex(M)
            else:
                L, info = L_host.to(M.device), info_host.to(M.device)
            log.append((float(reg), int(info), int(info_host), d.detach().clone()))
            return torch.where(info == 0, L, float("nan")), M

        return factorize, solve_

    dense._cholesky_ops = cholesky_ops
    dense.normal_eq = assemble  # every assembly of the backend's ops
    p = random_dense_lp(args.m, args.n, seed=args.seed)
    d_probe = None
    for plan in ("direct", "pcg") if args.pcg else ("direct",):
        for asm in ("k1", "sgemm"):
            for chol in ("cusolver", "lapack"):
                mode.update(asm=asm, chol=chol)
                log.clear()
                be = dense.DenseTorchBackend(schedule_platform="tpu")
                be.capture = False  # the host reads each factorization's info
                r = solve(p, backend=be, tol=1e-8, max_iter=200,
                          solve_mode="pcg" if plan == "pcg" else None)
                failed = [(i, reg, info, info_h) for i, (reg, info, info_h, _) in enumerate(log)
                          if info or info_h]
                print(json.dumps({
                    "plan": plan, "assembly": asm, "cholesky": chol, "status": r.status.value,
                    "iterations": r.iterations, "objective": r.objective,
                    "phases": [[ph["mode"], ph["iters"], ph["bad_steps"]]
                               for ph in be.phase_report],
                    "f32_factorizations": len(log),
                    "failed_index_reg_info_card_route_info_lapack": failed,
                }) + f" [{tag}]", flush=True)
                if plan == "direct" and asm == "k1" and chol == "cusolver":
                    at = failed[0][0] if failed else len(log) - 1
                    d_probe, A = log[at][3], be._A  # the scaled A the solve factors
    dense._cholesky_ops, dense.normal_eq = orig, ne.normal_eq

    A32 = A.to(torch.float32)
    M64 = (A * d_probe[None, :]) @ A.T
    d32 = d_probe.to(torch.float32)
    errs = {}
    for asm in ("k1", "sgemm"):
        mode["asm"] = asm
        M = assemble(A32, d32).double()
        err = (M - M64).norm() / M64.norm()
        diag_err = ((M.diagonal() - M64.diagonal()).abs() / M64.diagonal().abs()).max()
        Mr = M.float()
        Mr.diagonal().add_(Mr.diagonal() * 1e-10)
        info = torch.linalg.cholesky_ex(Mr)[1]
        errs[asm] = (err.item(), diag_err.item())
        print(json.dumps({"assembly": asm, "rel_err_vs_f64": err.item(),
                          "max_rel_err_diag": diag_err.item(), "cholesky_info_reg_1e-10": int(info),
                          "d_spread": (d_probe.max() / d_probe.min()).item()}) + f" [{tag}]")
    ok = all(a <= b for a, b in zip(errs["k1"], errs["sgemm"]))
    print(f"k1 no farther from the f64 product than cuBLAS f32: {ok} [{tag}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
