#!/usr/bin/env python3
"""Time the port's ELL products at stormG2_1000's shape on one card, on the
yardsticks of ``chip_smoke.py``'s ``timing ell`` lines, for the package of
this checkout or of another one.

The operator is the one ``chip_smoke.py`` times: ``sparse.from_scipy`` of
the Ruiz-equilibrated interior form of ``storm_sparse_lp(1000, 528, 1259,
121, seed=1, t_nnz_per_row=2, w_nnz_per_row=4)`` (528,000 × 1,259,121).
For A·v, Aᵀ·v and diag(A·D·Aᵀ) through ``SparseOperator.matvec``,
``rmatvec`` and ``normal_diag``, and cuSPARSE's CSR product of the same
matrix, it prints the mean milliseconds a launch paced by the host
(``chip_smoke.cuda_ms``, 50 launches) and queued with the L2 flushed
before each launch (``chip_smoke.cuda_ms_cold``, 50 launches, kernel and
cuSPARSE in turns), then the seconds of ``from_scipy`` (twice: the first
call in a process pays its lazy setup) and the card's name and power
limit.

``--root DIR`` imports ``distributedlpsolver_tpu_torch`` from the checkout
at DIR (for example the parent commit unpacked with ``git archive`` into an
ignored directory), so that two designs are timed in one call, each in its
own process, in turns:

    python scripts/port_time_ell.py [--root DIR]
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from distributedlpsolver_tpu_torch.models import storm_sparse_lp
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form
    from distributedlpsolver_tpu_torch.models.scaling import equilibrate
    from distributedlpsolver_tpu_torch.ops import sparse

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    A = equilibrate(to_interior_form(storm_sparse_lp(**cs.STORM_FULL)))[0].A
    setup = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op = sparse.from_scipy(A, device="cuda")
        torch.cuda.synchronize()
        setup.append(time.perf_counter() - t0)
    g = torch.Generator(device="cuda").manual_seed(7)
    v = torch.randn(op.n, dtype=torch.float64, device="cuda", generator=g)
    w = torch.randn(op.m, dtype=torch.float64, device="cuda", generator=g)
    d = torch.rand(op.n, dtype=torch.float64, device="cuda", generator=g) + 0.1

    def csr(M):
        M = M.tocsr()
        return torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr.astype(np.int64)), torch.from_numpy(M.indices.astype(np.int64)),
            torch.from_numpy(M.data), size=M.shape).to("cuda")

    flush = torch.zeros(2**25, dtype=torch.float32, device="cuda")  # 128 MiB
    for name, kern, S, x in (("A·v", lambda: op.matvec(v), csr(A), v),
                             ("Aᵀ·v", lambda: op.rmatvec(w), csr(A.T), w),
                             ("diag(A·D·Aᵀ)", lambda: op.normal_diag(d, 1e-8), csr(A.multiply(A)), d)):
        lib = lambda: S @ x  # noqa: E731
        kc, lc = [], []
        for t in (kc, lc, lc, kc):
            t.append(cs.cuda_ms_cold(torch, kern if t is kc else lib, iters=50, warm=3, flush=flush))
        print(json.dumps({
            "root": root, "function": name, "ms": cs.cuda_ms(torch, kern, iters=50, warm=5),
            "library_ms": cs.cuda_ms(torch, lib, iters=50, warm=5), "ms_cold_turns": kc,
            "library_ms_cold_turns": lc, "card": card}, ensure_ascii=False))
        del S
    print(json.dumps({"root": root, "from_scipy_s": setup, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
