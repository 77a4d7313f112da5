#!/usr/bin/env python3
"""Smoke run of the torch package (distributedlpsolver_tpu_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and fails (non-zero exit, no result line) without one. It:

1. prints the card (``nvidia-smi`` name and power limit), builds the
   normal-equations kernel from ``distributedlpsolver_tpu_torch/csrc`` into
   ``build/dlps_torch/`` and prints nvcc's register/shared-memory report;
2. holds the kernel against its plain PyTorch version on the card
   (Frobenius-relative error ≤ 1e-12 f64, ≤ 1e-5 f32, ≤ 1e-4 bf16, and
   in bf16 at most a tenth of the distance to the product taken without
   rounding A·d to bf16) at the main path's shape 2048×10240, a ragged
   1000×3001, and in f64 at the reference shape 10000×50000;
3. times the kernel, its plain version and one library call
   (``torch.einsum``) with CUDA events after warm-up, beside the bound
   ``max(m·(m+1)·n / peak FLOP/s, bytes / 3.35 TB/s)`` (M is symmetric:
   its lower triangle is all the work the function needs);
4. drives the main path, ``solve(random_dense_lp(2048, 10240, seed=0),
   backend="cuda")`` at tol 1e-8, with the kernel's launch count reset
   just before and read just after (it must equal the factorization
   count), checks the answer on the host in numpy, and solves a
   256×1024 problem against HiGHS;
5. runs the CLI, ``cli solve tests/fixtures/maximize.mps --backend cuda``;
6. profiles a second main-path solve with ``torch.profiler`` and prints
   its device-time breakdown by kernel (Chrome trace written to
   ``build/dlps_torch/main_path_trace.json``);
7. prints the ``kernels`` JSON line, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): FP64 tensor
# cores and FP32 67 TFLOP/s, bf16 989 TFLOP/s; HBM3 3.35 TB/s.
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# Frobenius-relative error of the kernel against its plain version.
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-4}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warm: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches, CUDA events,
    after ``warm`` untimed calls."""
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


def bound_ms(m: int, n: int, dtype: str, out_bytes: int) -> tuple:
    """Least time for M = A·diag(d)·Aᵀ: the larger of the operations
    over the type's peak and the bytes (A and d read once, M written
    once) over the memory rate. M is symmetric, so the operations are
    those of its lower triangle, m·(m+1)/2 entries of n multiply-adds:
    m·(m+1)·n. Returns (ms, "operations"|"bytes")."""
    elt = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    t_ops = float(m) * (m + 1) * n / PEAK_FLOPS[dtype]
    t_bytes = (m * n * elt + n * elt + m * m * out_bytes) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def make_inputs(torch, m, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(m, n, dtype=torch.float64, device="cuda", generator=g).to(dtype)
    d = (torch.rand(n, dtype=torch.float64, device="cuda", generator=g) + 0.1).to(dtype)
    return A, d


def kernel_parity(torch, ne, m, n, dtype_name, seed=0):
    """Kernel vs plain version on the card; returns (rel_err, max_abs_err).
    In bf16 the kernel must also sit ten times closer to the plain version
    than the product without the bf16 rounding of A·d does, so that the
    rounding is shown to happen."""
    dtype = getattr(torch, dtype_name)
    A, d = make_inputs(torch, m, n, dtype, seed)
    M = ne.normal_eq(A, d)
    torch.cuda.synchronize()
    R = ne.normal_eq_reference(A, d).double()
    diff = M.double() - R
    rel = (diff.norm() / R.norm()).item()
    mx = diff.abs().max().item()
    del diff, M
    if dtype == torch.bfloat16:
        unrounded = (A.double() * d.double()[None, :]) @ A.double().T
        rounding = ((unrounded - R).norm() / R.norm()).item()
        del unrounded
        if not rel <= rounding / 10:
            fail(f"normal_eq bfloat16 {m}x{n}: error {rel:.3e} vs the rounding's own {rounding:.3e}")
    del A, d, R
    torch.cuda.empty_cache()
    if not rel <= TOL[dtype_name]:
        fail(f"normal_eq {dtype_name} {m}x{n}: relative error {rel:.3e} > {TOL[dtype_name]:.0e}")
    return rel, mx


def kernel_timing(torch, ne, m, n, dtype_name, iters, warm):
    dtype = getattr(torch, dtype_name)
    A, d = make_inputs(torch, m, n, dtype, 1)
    row = {
        "shape": [m, n], "dtype": dtype_name,
        "ms": cuda_ms(torch, lambda: ne.normal_eq(A, d), iters, warm),
        "plain_ms": cuda_ms(torch, lambda: ne.normal_eq_reference(A, d), iters, warm),
        # One PyTorch call computing the same function (library yardstick).
        "library_ms": cuda_ms(torch, lambda: torch.einsum("ik,k,jk->ij", A, d, A), iters, warm),
    }
    out_bytes = 4 if dtype == torch.bfloat16 else A.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(m, n, dtype_name, out_bytes)
    # Rate of the flops the kernel issues: both triangles, 2·m²·n.
    row["issued_tflops"] = 2.0 * m * m * n / (row["ms"] * 1e-3) / 1e12
    del A, d
    torch.cuda.empty_cache()
    return row


def main_path(m, n, seed):
    """solve(random_dense_lp(m, n, seed), backend="cuda") with the launch
    count reset just before and read just after, plus the host check."""
    import numpy as np

    from distributedlpsolver_tpu_torch.ipm import Status, solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp
    from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
    from distributedlpsolver_tpu_torch.ops import normal_eq

    p = random_dense_lp(m, n, seed=seed)
    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        normal_eq.launches = 0
        t0 = time.perf_counter()
        r = solve(p, backend="cuda", tol=1e-8)
        wall = time.perf_counter() - t0
        launches = normal_eq.launches
    finally:
        obs_metrics.set_registry(prev)
    refactors = int(reg.snapshot().get("ipm_refactorizations_total", 0))
    factorizations = 1 + r.iterations + refactors  # starting point + one per step attempt
    x, y = np.asarray(r.x), np.asarray(r.y)
    viol = p.max_violation(x)
    pobj, dobj = float(p.c @ x), float(p.rlb @ y)
    gap = abs(pobj - dobj) / (1.0 + abs(pobj))
    row = {
        "problem": p.name, "status": r.status.value, "iterations": r.iterations,
        "objective": r.objective, "wall_s": wall, "setup_s": r.setup_time,
        "solve_s": r.solve_time, "iters_per_s": r.iters_per_sec,
        "normal_eq_launches": launches, "factorizations": factorizations,
        "refactorizations": refactors, "max_violation": viol, "host_rel_gap": gap,
    }
    if r.status != Status.OPTIMAL:
        fail(f"main path {p.name}: status {r.status.value}")
    if not (launches == factorizations and launches > 0):
        fail(f"main path: {launches} kernel launches for {factorizations} factorizations")
    if not viol <= 1e-6:
        fail(f"main path: max_violation {viol:.3e} > 1e-6")
    if not gap <= 1e-7:
        fail(f"main path: host |cᵀx - bᵀy| relative {gap:.3e} > 1e-7")
    return row, p, r


def highs_objective(p) -> float:
    # The tests' HiGHS oracle, loaded by path: a ``tests`` package
    # installed elsewhere may shadow the repo's directory.
    spec = importlib.util.spec_from_file_location("dlps_oracle", os.path.join(ROOT, "tests", "oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    h = oracle.highs_on_general(p)
    if h.status != 0:
        fail(f"HiGHS did not solve {p.name}: {h.message}")
    obj = h.fun + p.c0
    return -obj if p.maximize else obj


def profile_main_path(torch, m, n, seed):
    """Device-time breakdown of one main-path solve: kernel time by
    category and by kernel, device busy time, and the idle share of the
    backend's host-clock window (setup + iterations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    p = random_dense_lp(m, n, seed=seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = solve(p, backend="cuda", tol=1e-8)
        torch.cuda.synchronize()
    kernels = [
        (ev.key, ev.self_device_time_total / 1e3, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    kernels.sort(key=lambda t: -t[1])
    categories = {}
    for key, ms, _ in kernels:
        k = key.lower()
        cat = next((c for c, words in (
            ("normal_eq", ("normal_eq",)),
            ("cholesky", ("potrf", "getrf", "chol", "syrk", "herk")),
            ("triangular_solve", ("trsv", "trsm", "potrs")),
            ("gemv", ("gemv", "dot_kernel")),
            ("memcpy", ("memcpy", "memset")),
        ) if any(w in k for w in words)), "elementwise_reduce_other")
        categories[cat] = categories.get(cat, 0.0) + ms
    busy_ms = sum(t[1] for t in kernels)
    out_dir = os.path.join(ROOT, "build", "dlps_torch")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "main_path_trace.json"))
    return {
        "iterations": r.iterations, "solve_s_profiled": r.solve_time,
        "setup_s_profiled": r.setup_time, "device_busy_ms": busy_ms,
        # Over the backend's window: setup (copy, starting point) + loop.
        "device_idle_share": 1.0 - busy_ms / (1e3 * (r.setup_time + r.solve_time)),
        "by_category_ms": categories,
        "top": [{"kernel": k[:80], "ms": ms, "count": c} for k, ms, c in kernels[:10]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script needs one card", file=sys.stderr)
        return 2
    from distributedlpsolver_tpu_torch import cli
    from distributedlpsolver_tpu_torch.io import read_mps
    # The module (the package's ``ops.normal_eq`` attribute is the function).
    ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")

    torch.backends.cuda.matmul.allow_tf32 = False  # library matmuls in true fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch.cuda.get_device_name(0) = {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. Build from the checkout's sources.
    t0 = time.perf_counter()
    ne.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {ne.build_info.get('seconds', 0.0):.2f} s) -> {ne.build_info['path']}")
    for ln in ne.build_info.get("ptxas", []):
        print(f"  {ln}")

    # 2. Parity on the card.
    parity = {}
    for (m, n) in [(2048, 10240), (1000, 3001)]:
        for dt in ("float64", "float32", "bfloat16"):
            parity[f"{dt}_{m}x{n}"] = kernel_parity(torch, ne, m, n, dt)
    parity["float64_10000x50000"] = kernel_parity(torch, ne, 10000, 50000, "float64")
    for k, (rel, mx) in parity.items():
        print(f"parity normal_eq {k}: rel_err {rel:.3e} max_abs_err {mx:.3e} (tol {TOL[k.split('_')[0]]:.0e})")

    # 3. Timing (card and power limit printed above and below).
    timings = [
        kernel_timing(torch, ne, 2048, 10240, "float64", iters=20, warm=3),
        kernel_timing(torch, ne, 2048, 10240, "float32", iters=20, warm=3),
        kernel_timing(torch, ne, 2048, 10240, "bfloat16", iters=20, warm=3),
        kernel_timing(torch, ne, 10000, 50000, "float64", iters=3, warm=1),
    ]
    for t in timings:
        print(f"timing normal_eq {t['dtype']} {t['shape'][0]}x{t['shape'][1]}: kernel {t['ms']:.3f} ms "
              f"({t['issued_tflops']:.2f} TFLOP/s issued), plain {t['plain_ms']:.3f} ms, library(einsum) "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}) [{card}]")

    # 4. The main path, counts reset just before and read just after.
    row, _, _ = main_path(2048, 10240, seed=0)
    print("main_path " + json.dumps(row))
    small, p_small, r_small = main_path(256, 1024, seed=0)
    h_obj = highs_objective(p_small)
    rel = abs(r_small.objective - h_obj) / (1.0 + abs(h_obj))
    if not rel <= 1e-8:
        fail(f"256x1024 objective {r_small.objective!r} vs HiGHS {h_obj!r}: {rel:.3e}")
    print(f"small_path {small['problem']}: {small['status']} {small['iterations']} it, "
          f"objective vs HiGHS rel {rel:.3e}")

    # 5. The CLI on a fixture.
    fixture = os.path.join(ROOT, "tests", "fixtures", "maximize.mps")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["solve", fixture, "--backend", "cuda", "--json", "--quiet"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    h_cli = highs_objective(read_mps(fixture))
    if rc != 0 or out["status"] != "optimal" or abs(out["objective"] - h_cli) > 1e-8 * (1 + abs(h_cli)):
        fail(f"cli solve maximize.mps: rc {rc}, {out}, HiGHS {h_cli}")
    print(f"cli: {out['name']} {out['status']} objective {out['objective']!r} (HiGHS {h_cli!r}) "
          f"iterations {out['iterations']}")

    # 6. Where the main path's device time goes (a second, warm solve).
    print("profile " + json.dumps(profile_main_path(torch, 2048, 10240, 0)))

    main_t = timings[0]
    kernels = {"kernels": [{
        "name": "normal_eq",
        "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        "launches": row["normal_eq_launches"],
        "max_abs_err": parity["float64_2048x10240"][1],
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "kernel_ms": main_t["ms"],
        "dtypes": ["float64", "float32", "bfloat16"],
        "shape": main_t["shape"],
        "timings": timings,
    }]}
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
