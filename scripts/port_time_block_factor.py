#!/usr/bin/env python3
"""Time the block tier's Schur factorization and solve on the card, part
by part, at the pds classes' shapes (``block_angular_lp(K, 432, 1400,
link, seed=0, sparse=True, density=0.005)``), and the ways of forming
H_k = M_kk⁻¹·G_kᵀ:

* ``batched``: two batched ``solve_triangular`` calls on the (K, mb, mb)
  factor with the (K, mb, link) right-hand side (cuBLAS ``trsmBatched``,
  what ``torch`` picks for more than 8 matrices);
* ``looped``: the same two solves one block at a time (cuBLAS ``trsm`` on
  each (mb, mb) factor, K calls);
* ``half``: one forward solve W_k = L_k⁻¹·G_kᵀ, batched or looped, and
  Σ_k G_k·H_k as Σ_k W_kᵀ·W_k (the same matrix, another rounding).

Each time is the mean of ``--iters`` calls between CUDA events after a
warm-up, on the backend's own tensors and a seeded positive d. Prints
one JSON line a class, and the card's name and power limit.

    python scripts/port_time_block_factor.py [--classes pds10,pds20] [--iters 10] [--root DIR]

``--root`` imports the package from another checkout (the parent's, to
time both in one call).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CLASSES = {"pds10": (32, 432, 1400, 800), "pds20": (64, 432, 1400, 1600)}


def cuda_ms(torch, fn, iters, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_class(torch, name, iters, device="cuda"):
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import block_angular as ba
    from distributedlpsolver_tpu_torch.models import block_angular_lp
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form
    from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq

    p = block_angular_lp(*CLASSES[name], seed=0, sparse=True, density=0.005)
    t, lay = ba.build_tensors(to_interior_form(p), torch.float64, device)
    K, mb, nb, link, n0, n, m = lay
    rng = np.random.default_rng(0)
    d = torch.tensor(np.exp(rng.uniform(-3, 3, n)), dtype=torch.float64, device=device)
    r = torch.tensor(rng.standard_normal(m), dtype=torch.float64, device=device)
    ops = ba._block_ops(t, lay, 1e-10)
    fac = ops.factorize(d)
    Lk, Ls, GT = fac
    dc = torch.cat([d, d.new_zeros(1)])[t.cat_idx]
    dB = dc[: K * nb].view(K, nb)
    L_view = t.L_cat[:, : K * nb].view(link, K, nb).permute(1, 2, 0)
    Mkk = normal_eq(t.B_all, dB)
    tri = torch.linalg.solve_triangular

    def batched():
        return tri(Lk.mT, tri(Lk, GT, upper=False), upper=True)

    def looped():
        out = torch.empty_like(GT)
        for k in range(K):
            out[k] = tri(Lk[k].mT, tri(Lk[k], GT[k], upper=False), upper=True)
        return out

    def half_batched():
        W = tri(Lk, GT, upper=False).reshape(K * mb, link)
        return W.mT @ W

    def half_looped():
        W = torch.empty_like(GT)
        for k in range(K):
            W[k] = tri(Lk[k], GT[k], upper=False)
        W = W.reshape(K * mb, link)
        return W.mT @ W

    H = batched()
    S_ref = GT.reshape(K * mb, link).mT @ H.reshape(K * mb, link)
    agree = {}
    for key, fn in (("looped", lambda: GT.reshape(K * mb, link).mT @ looped().reshape(K * mb, link)),
                    ("half_batched", half_batched), ("half_looped", half_looped)):
        agree[key] = float((fn() - S_ref).norm() / S_ref.norm())
    row = {
        "class": name, "layout": dict(lay._asdict()),
        "factorize_ms": cuda_ms(torch, lambda: ops.factorize(d), iters),
        "solve_ms": cuda_ms(torch, lambda: ops.solve(fac, r), iters),
        "matvec_ms": cuda_ms(torch, lambda: ops.matvec(d), iters),
        "rmatvec_ms": cuda_ms(torch, lambda: ops.rmatvec(r), iters),
        "k1_lanes_ms": cuda_ms(torch, lambda: normal_eq(t.B_all, dB), iters),
        "k1_link_ms": cuda_ms(torch, lambda: normal_eq(t.L_cat, dc), iters),
        "cholesky_lanes_ms": cuda_ms(torch, lambda: torch.linalg.cholesky_ex(Mkk), iters),
        "cholesky_link_ms": cuda_ms(torch, lambda: torch.linalg.cholesky_ex(S_ref + S_ref.diagonal().diag_embed()), iters),
        "GT_bmm_ms": cuda_ms(torch, lambda: torch.bmm(t.B_all * dB[:, None, :], L_view), iters),
        "sum_GH_gemm_ms": cuda_ms(torch, lambda: GT.reshape(K * mb, link).mT @ H.reshape(K * mb, link), iters),
        "H_batched_ms": cuda_ms(torch, batched, iters),
        "H_looped_ms": cuda_ms(torch, looped, iters),
        "sum_GH_half_batched_ms": cuda_ms(torch, half_batched, iters),
        "sum_GH_half_looped_ms": cuda_ms(torch, half_looped, iters),
        "block_solve_1rhs_batched_ms": cuda_ms(
            torch, lambda: tri(Lk.mT, tri(Lk, r[: K * mb].view(K, mb, 1), upper=False), upper=True), iters),
        "link_solve_1rhs_ms": cuda_ms(
            torch, lambda: tri(Ls.mT, tri(Ls, r[:link, None], upper=False), upper=True), iters),
        "sum_GH_rel_diff": agree,
    }
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--classes", default="pds10,pds20")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("port_time_block_factor: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    for name in args.classes.split(","):
        print(json.dumps({**time_class(torch, name, args.iters), "card": card,
                          "root": os.path.abspath(args.root)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
