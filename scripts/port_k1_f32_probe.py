#!/usr/bin/env python3
"""K1's f32 assembly on the card against other f32 assemblies: accuracy,
time, and the verdicts of the solves that factor in f32.

Assemblies: ``k1`` (this checkout's kernel), ``cublas`` (one cuBLAS f32
product ``(A·d)·Aᵀ``, TF32 off), ``exact`` (the products and their sum in
f64, rounded to f32 once), and each ``--variant NAME=SOURCE.cu``: another
``csrc/normal_eq.cu``, built here with the same nvcc flags into
``build/dlps_torch/`` and called through its f32 entry point (to compare
a design change against the checkout's kernel in one run).

For each assembly it prints, on ``chip_smoke.make_inputs``-style inputs
at 2048×10240 and 4096×20480 (seed 1): the Frobenius-relative error
against the f64 product of the same f32 inputs, the largest relative
error on the diagonal, the diagonal's mean signed relative error (a
rounding that leans one way shows there) and the mean milliseconds of a
launch (CUDA events, 10 after 2). Then, with every f32 assembly of the
dense backend routed through it: the forced-PCG solves
(``solve_mode="pcg"``) of ``random_dense_lp(60, 180)`` on the fused and
host loops and of ``(512, 2560)`` fused, and the two-phase schedule
(``schedule_platform="tpu"``) at 2048×10240 and 4096×20480, each with its
status, iterations and phases. Every line ends with the card's name and
power limit. Needs one card:

    python3 scripts/port_k1_f32_probe.py [--variant NAME=path/to/normal_eq.cu ...]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def build_variants(variants) -> dict:
    """NAME -> the f32 C entry of each variant source, built in parallel."""
    from distributedlpsolver_tpu_torch.ops import kernel_build

    infos = {name: {} for name, _ in variants}
    jobs = [(src, f"libdlps_normal_eq_{name}", kernel_build.BUILD_DIR, kernel_build.find_nvcc,
             infos[name]) for name, src in variants]
    fns = {}
    for (name, _), so in zip(variants, kernel_build.build(*jobs)):
        print(f"variant {name}: {so} " + "; ".join(infos[name].get("ptxas", [])))
        fn = kernel_build.open_library(so).dlps_normal_eq_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=SOURCE.cu")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_k1_f32_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from distributedlpsolver_tpu_torch.backends import dense, get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp
    from distributedlpsolver_tpu_torch.ops import kernel_build

    ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")
    kernel_build.build(ne.build_job())
    ne.load_library()
    tag = card()
    fns = build_variants([tuple(v.split("=", 1)) for v in args.variant])

    def assemble(kind, A, d):
        if kind == "k1":
            return ne.normal_eq(A, d)
        if kind == "cublas":
            return (A * d[None, :]) @ A.T
        if kind == "exact":
            return ((A * d[None, :]).double() @ A.double().T).float()
        m, n = A.shape
        M = torch.empty(m, m, device=A.device, dtype=torch.float32)
        rc = fns[kind](A.data_ptr(), d.data_ptr(), M.data_ptr(), 1, m, n, 0, 0,
                       torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"variant {kind}: CUDA error {rc}")
        return M

    def ms(fn, it=10):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(it):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / it

    kinds = ["k1", *fns, "cublas", "exact"]
    for m, n in ((2048, 10240), (4096, 20480)):
        g = torch.Generator(device="cuda").manual_seed(1)
        A = torch.randn(m, n, dtype=torch.float64, device="cuda", generator=g).float()
        d = (torch.rand(n, dtype=torch.float64, device="cuda", generator=g) + 0.1).float()
        exact = (A.double() * d.double()[None, :]) @ A.double().T
        for kind in kinds:
            D = assemble(kind, A, d).double() - exact
            rd = D.diagonal() / exact.diagonal()
            print(f"accuracy {m}x{n} {kind}: fro {(D.norm() / exact.norm()).item():.3e}, diagonal "
                  f"max {rd.abs().max().item():.3e}, diagonal mean signed {rd.mean().item():+.3e}, "
                  f"{ms(lambda: assemble(kind, A, d)):.4f} ms [{tag}]", flush=True)
        del A, d, exact, D
        torch.cuda.empty_cache()

    orig = dense.normal_eq

    def routed(kind):
        def f(A, d):
            return orig(A, d) if A.dtype != torch.float32 else assemble(kind, A, d)
        return f

    try:
        for m, n, loops in ((60, 180, ("fused", "host")), (512, 2560, ("fused",))):
            for kind in kinds:
                dense.normal_eq = routed(kind)
                for loop in loops:
                    kw = {} if loop == "fused" else {"fused_loop": False}
                    r = solve(random_dense_lp(m, n, seed=0), backend=get_backend("cuda"), tol=1e-8,
                              solve_mode="pcg", **kw)
                    print(f"pcg {m}x{n} {kind} {loop}: {r.status.value} at {r.iterations} [{tag}]",
                          flush=True)
        for m, n in ((2048, 10240), (4096, 20480)):
            p = random_dense_lp(m, n, seed=0)
            for kind in kinds:
                dense.normal_eq = routed(kind)
                be = dense.DenseTorchBackend(schedule_platform="tpu")
                r = solve(p, backend=be, tol=1e-8, max_iter=200)
                phases = [[ph["mode"], ph["iters"], ph["bad_steps"]] for ph in be.phase_report]
                print(f"two_phase {m}x{n} {kind}: {r.status.value} at {r.iterations}, phases "
                      f"(mode, iterations, bad steps) {phases} [{tag}]", flush=True)
    finally:
        dense.normal_eq = orig
    return 0


if __name__ == "__main__":
    sys.exit(main())
