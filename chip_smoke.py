#!/usr/bin/env python3
"""Smoke run of the torch package (distributedlpsolver_tpu_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and fails (non-zero exit, no result line) without one. It:

1. prints the card (``nvidia-smi`` name and power limit), builds the
   normal-equations kernel from ``distributedlpsolver_tpu_torch/csrc`` into
   ``build/dlps_torch/``, prints nvcc's register/shared-memory report, and
   counts the ``DMMA`` (FP64 tensor-core) instructions in the f64
   kernel's SASS (``cuobjdump -sass``); none is a failure;
2. holds the kernel's lower triangle against its plain PyTorch version's
   on the card (the kernel mirrors it into the upper half; Frobenius-relative
   error ≤ 1e-12 f64, ≤ 1e-5 f32, ≤ 1e-4 bf16, and in bf16 at most a
   tenth of the distance to the product taken without rounding A·d to
   bf16) at the main path's shape 2048×10240, a ragged 1000×3001 (odd
   n), one row past two tiles (2·edge+1 rows), and in f64 at the
   reference shape 10000×50000; at each, M must equal Mᵀ bit for bit
   and a second launch must give the same bits;
3. times the kernel, its plain version and one library call
   (``torch.einsum``) with CUDA events after warm-up, beside the bound
   ``max(m·(m+1)·n / peak FLOP/s, bytes / 3.35 TB/s)`` (M is symmetric:
   its lower triangle is all the work the function needs) and the bound
   share (bound over kernel time);
4. drives the main path, ``solve(random_dense_lp(2048, 10240, seed=0),
   backend="cuda")`` at tol 1e-8 — the fused loop, one captured CUDA
   graph of the Mehrotra step replayed by the host — with the kernel's
   launch count reset just before and read just after (it must equal 1
   for the starting point plus the loop's bodies, at most 2 of them past
   the exit), checks the answer on the host in numpy, solves a 256×1024
   problem against HiGHS, and solves the main path again warm (same
   iterations, objective within 1e-9 relative);
5. solves the main path with the host loop (``fused_loop=False``) and
   host-segmented (``segment_iters=4``): same status and iterations as
   the fused loop, objective within 1e-12 relative, launches equal to the
   factorizations; prints whether x is bitwise equal. Cold solves (the
   first in a process) of the fused and the host loop run in fresh
   processes (``chip_smoke.py --one-solve``). The zero-row LP
   (presolve off, no regularization) must end ``numerical_error`` at 0
   iterations through the fused loop;
6. runs the CLI, ``cli solve tests/fixtures/maximize.mps --backend cuda``;
7. profiles a warm main-path solve of the fused and of the host loop
   with ``torch.profiler``: device busy ms, idle share, host-clock solve
   s, device operations and host launch calls per solve, and the
   device-time breakdown by kernel (Chrome traces written to
   ``build/dlps_torch/main_path_{fused,host}_trace.json``);
8. the batched solver (``backends/batched.py::solve_batched``), with
   vmap's per-sample fallback off: K1 with a lane axis at the full width
   (1024 lanes of 128×512, f64) and on a ragged batch of 3 lanes of
   100×333 (odd m·n) in all three types — every lane bit for bit the
   unbatched kernel on its inputs, the lower triangle within the
   tolerances above of the batched plain version, M = Mᵀ and two launches
   bit for bit — timed beside its bound and ``torch.einsum``; then
   ``solve_batched(random_batched_lp(1024, 128, 512, seed=0), tol=1e-8)``
   cold and warm on the default configuration (one captured graph of the
   vmapped step), segmented (``segment_iters=8``: same statuses,
   objectives within 1e-9) and in the JAX package's TPU schedule
   (``chunk=256, segment_iters=8``: every member OPTIMAL), each with its
   K1 launches held to a start a chunk + its bodies (+ the solo
   cleanup's bodies);
   every member OPTIMAL at rel_gap ≤ 1e-8 and pinf ≤ 1e-7, or left at the
   iteration limit with its budget spent (the JAX package's verdict);
   every 32nd member, and any left unfinished, against HiGHS (1e-8) and
   the dense solo solve on the card (1e-8, both stopping at a 1e-8 gap);
   and a profiled warm solve
   (trace ``build/dlps_torch/batched_trace.json``);
9. the serve phase (``serve/service.py::SolveService`` over
   ``backends/batched.py::solve_bucket``) at the batched member width,
   every request padded into the bucket (128, 512, 256): K1 at the bucket
   shape (256 lanes of 128×512, f64) against its plain version and
   ``torch.einsum``; then ``SolveService(ServiceConfig(batch=256,
   flush_s=0.02))`` on the card driven with three waves — a cold
   ``random_request_stream(1024, shapes=((96, 384), (128, 512)),
   seed=21)``, a warm one (``seed=22``) and
   ``correlated_request_stream(512, shapes=((128, 512),), n_models=4,
   seed=23)`` — with the K1 count reset just before each wave and read
   just after: every request OPTIMAL, or at the iteration limit with its
   bucket's and its solo solve's budgets spent (the JAX package's verdict
   for such a request), every 32nd against HiGHS (1e-8; HiGHS at
   feasibility tolerances of 1e-10), no
   bucket program built and no graph captured over the warm and
   correlated waves, warm starts taken in the correlated wave, and the K1
   launches of each dispatch equal to its start + warm selection +
   bodies; printed per wave: requests/s, p50/p99 latency, pack / compile /
   solve / overlap ms, padding waste, bodies per dispatch, solo
   fallbacks and peak device memory; then a fourth wave of 512 requests
   under ``torch.profiler`` (device busy ms and idle share of its wall,
   trace ``build/dlps_torch/serve_trace.json``). Then ``cli serve --requests`` on 8
   requests of 128×512 in a subprocess, all ``optimal``;
10. prints the ``kernels`` JSON line, the card line, and last the result
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


def bound_ms(m: int, n: int, dtype: str, out_bytes: int, batch: int = 1) -> tuple:
    """Least time for M = A·diag(d)·Aᵀ over ``batch`` lanes: the larger of
    the operations over the type's peak and the bytes (A and d read once,
    M written once) over the memory rate. M is symmetric, so the
    operations are those of its lower triangle, m·(m+1)/2 entries of n
    multiply-adds: m·(m+1)·n a lane. Returns (ms, "operations"|"bytes")."""
    elt = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    t_ops = batch * float(m) * (m + 1) * n / PEAK_FLOPS[dtype]
    t_bytes = batch * (m * n * elt + n * elt + m * m * out_bytes) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def make_inputs(torch, m, n, dtype, seed, batch=None):
    """A (m, n) and d (n,), or with ``batch`` a leading lane axis on both."""
    lead = () if batch is None else (batch,)
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(*lead, m, n, dtype=torch.float64, device="cuda", generator=g).to(dtype)
    d = (torch.rand(*lead, n, dtype=torch.float64, device="cuda", generator=g) + 0.1).to(dtype)
    return A, d


def shape_name(m, n, batch=None) -> str:
    return f"{m}x{n}" if batch is None else f"{batch}x{m}x{n}"


def kernel_parity(torch, ne, m, n, dtype_name, seed=0, batch=None):
    """Kernel vs plain version on the card; returns (rel_err, max_abs_err).
    M must equal Mᵀ bit for bit, and a second launch must give the same
    bits. With ``batch`` the launch covers every lane, and each lane must
    equal, bit for bit, the unbatched kernel on that lane's inputs. In
    bf16 the kernel must also sit ten times closer to the plain version
    than the product without the bf16 rounding of A·d does, so that the
    rounding is shown to happen."""
    dtype = getattr(torch, dtype_name)
    name = f"normal_eq {dtype_name} {shape_name(m, n, batch)}"
    A, d = make_inputs(torch, m, n, dtype, seed, batch)
    M = ne.normal_eq(A, d)
    M2 = ne.normal_eq(A, d)
    torch.cuda.synchronize()
    if not torch.equal(M, M.mT):
        fail(f"{name}: M is not bitwise symmetric")
    if not torch.equal(M, M2):
        fail(f"{name}: two launches differ")
    del M2
    for i in range(batch or 0):
        if not torch.equal(M[i], ne.normal_eq(A[i].contiguous(), d[i].contiguous())):
            fail(f"{name}: lane {i} differs from the unbatched kernel on its inputs")
    # The kernel computes the lower triangle and mirrors it (checked above).
    R = torch.tril(ne.normal_eq_reference(A, d)).double()
    diff = torch.tril(M).double() - R
    rel = (diff.norm() / R.norm()).item()
    mx = diff.abs().max().item()
    del diff, M
    if dtype == torch.bfloat16:
        unrounded = torch.tril((A.double() * d.double()[..., None, :]) @ A.double().mT)
        rounding = ((unrounded - R).norm() / R.norm()).item()
        del unrounded
        if not rel <= rounding / 10:
            fail(f"{name}: error {rel:.3e} vs the rounding's own {rounding:.3e}")
    del A, d, R
    torch.cuda.empty_cache()
    if not rel <= TOL[dtype_name]:
        fail(f"{name}: relative error {rel:.3e} > {TOL[dtype_name]:.0e}")
    return rel, mx


def kernel_timing(torch, ne, m, n, dtype_name, iters, warm, batch=None):
    dtype = getattr(torch, dtype_name)
    A, d = make_inputs(torch, m, n, dtype, 1, batch)
    # One PyTorch call computing the same function (library yardstick).
    spec = "ik,k,jk->ij" if batch is None else "bik,bk,bjk->bij"
    row = {
        "shape": [m, n] if batch is None else [batch, m, n], "dtype": dtype_name,
        "ms": cuda_ms(torch, lambda: ne.normal_eq(A, d), iters, warm),
        "plain_ms": cuda_ms(torch, lambda: ne.normal_eq_reference(A, d), iters, warm),
        "library_ms": cuda_ms(torch, lambda: torch.einsum(spec, A, d, A), iters, warm),
    }
    out_bytes = 4 if dtype == torch.bfloat16 else A.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(m, n, dtype_name, out_bytes, batch or 1)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    # Rate of the flops the kernel issues: its T·(T+1)/2 lower-triangle
    # tiles a lane, diagonal tiles whole, each edge²·n multiply-adds.
    edge = ne.tile_edge(dtype)
    tiles = -(-m // edge)
    row["issued_tflops"] = ((batch or 1) * tiles * (tiles + 1) * edge * edge * n
                            / (row["ms"] * 1e-3) / 1e12)
    del A, d
    torch.cuda.empty_cache()
    return row


def dmma_count(ne) -> int:
    """DMMA instructions in the SASS of the f64 kernel (both copy-width
    instances) of the built library, read with the toolkit's
    ``cuobjdump -sass``."""
    cuda_bin = os.path.dirname(ne._nvcc())
    tool = os.path.join(cuda_bin, "cuobjdump")
    sass = subprocess.run([tool, "-sass", ne.build_info["path"]], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    count, in_f64 = 0, False
    for ln in sass.splitlines():
        if "Function :" in ln:
            in_f64 = "normal_eq_dmma_kernel" in ln
        elif in_f64 and "DMMA" in ln:
            count += 1
    return count


# Bodies the fused loop may run past its exit (the graph runner queues
# two replays ahead of the host's read).
MAX_MASKED = 2


def solve_counted(p, **kw):
    """``solve(p, backend=<a cuda backend>, **kw)`` with the kernel's
    launch count reset just before and read just after. Returns the
    result, the count, the backend's phase rows (fused loop) or None
    (host loop), the host loop's refactorizations and the wall time."""
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
    from distributedlpsolver_tpu_torch.ops import normal_eq

    be = get_backend("cuda")
    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        normal_eq.launches = 0
        t0 = time.perf_counter()
        r = solve(p, backend=be, **kw)
        wall = time.perf_counter() - t0
        launches = normal_eq.launches
    finally:
        obs_metrics.set_registry(prev)
    refactors = int(reg.snapshot().get("ipm_refactorizations_total", 0))
    return r, launches, getattr(be, "phase_report", None), refactors, wall


def launch_accounting(r, launches, phases, refactors, fused: bool) -> dict:
    """The kernel launches of a solve against its factorizations: the
    starting point plus, in the fused loop, one per body (accepted, bad,
    or masked past the exit); in the host loop, one per step attempt."""
    if fused:
        if phases is None:
            fail("the fused loop did not run (no phase report)")
        acc = {k: sum(row[k] for row in phases)
               for k in ("bodies", "eager", "replays", "masked", "bad_steps", "runs")}
        for k in ("eager_ms", "capture_ms", "replay_ms"):
            acc[k] = [row[k] for row in phases]
        factorizations = 1 + acc["bodies"]
        if acc["bodies"] != r.iterations + acc["bad_steps"] + acc["masked"]:
            fail(f"fused loop: {acc['bodies']} bodies for {r.iterations} iterations, "
                 f"{acc['bad_steps']} bad and {acc['masked']} masked")
        if acc["masked"] > MAX_MASKED * acc["runs"]:
            fail(f"fused loop: {acc['masked']} bodies past the exit over {acc['runs']} runs")
    else:
        if phases is not None:
            fail("the host loop was asked for, but the fused loop ran")
        acc = {"refactorizations": refactors}
        factorizations = 1 + r.iterations + refactors
    if not (launches == factorizations and launches > 0):
        fail(f"{launches} kernel launches for {factorizations} factorizations ({acc})")
    return {"normal_eq_launches": launches, "factorizations": factorizations, **acc}


def main_path(m, n, seed, **kw):
    """solve(random_dense_lp(m, n, seed), backend="cuda", **kw) with the
    launch accounting and the host check; the fused loop unless ``kw``
    turns it off."""
    import numpy as np

    from distributedlpsolver_tpu_torch.ipm import Status
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    p = random_dense_lp(m, n, seed=seed)
    r, launches, phases, refactors, wall = solve_counted(p, tol=1e-8, **kw)
    acc = launch_accounting(r, launches, phases, refactors, kw.get("fused_loop", True))
    x, y = np.asarray(r.x), np.asarray(r.y)
    viol = p.max_violation(x)
    pobj, dobj = float(p.c @ x), float(p.rlb @ y)
    gap = abs(pobj - dobj) / (1.0 + abs(pobj))
    row = {
        "problem": p.name, "loop": loop_name(kw), "status": r.status.value,
        "iterations": r.iterations, "objective": r.objective, "wall_s": wall,
        "setup_s": r.setup_time, "solve_s": r.solve_time, "iters_per_s": r.iters_per_sec,
        **acc, "max_violation": viol, "host_rel_gap": gap,
    }
    if r.status != Status.OPTIMAL:
        fail(f"main path {p.name} ({row['loop']}): status {r.status.value}")
    if not viol <= 1e-6:
        fail(f"main path ({row['loop']}): max_violation {viol:.3e} > 1e-6")
    if not gap <= 1e-7:
        fail(f"main path ({row['loop']}): host |cᵀx - bᵀy| relative {gap:.3e} > 1e-7")
    return row, p, r


def loop_name(kw) -> str:
    if kw.get("fused_loop") is False:
        return "host"
    return f"segmented({kw['segment_iters']})" if kw.get("segment_iters") else "fused"


def same_answer(name, ref, ref_row, r, row) -> bool:
    """Status, iterations and objective (1e-12 relative) of ``r`` against
    the fused loop's ``ref``; returns whether x is bitwise equal."""
    import numpy as np

    rel = abs(r.objective - ref.objective) / (1.0 + abs(ref.objective))
    if r.status != ref.status or r.iterations != ref.iterations or not rel <= 1e-12:
        fail(f"{name}: {r.status.value} {r.iterations} it objective {r.objective!r} against the "
             f"fused loop's {ref.status.value} {ref.iterations} it {ref.objective!r} ({rel:.3e})")
    return bool(np.array_equal(np.asarray(r.x), np.asarray(ref.x)))


def cold_solve(loop_kw: dict) -> dict:
    """The main path as the first solve of a fresh process (the kernel
    library is already built), through ``chip_smoke.py --one-solve``."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--one-solve", json.dumps(loop_kw)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
    )
    if proc.returncode != 0:
        fail(f"cold solve {loop_kw}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def one_solve(loop_kw: dict) -> int:
    """The body of ``--one-solve``: one main-path solve, its row on the
    last line of standard output."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    row, _, _ = main_path(2048, 10240, seed=0, **loop_kw)
    print(json.dumps(row))
    return 0


def zero_row_lp():
    """A zero row that presolve would remove: with presolve off and no
    regularization, every Cholesky of M fails."""
    import numpy as np

    from distributedlpsolver_tpu_torch.models.problem import LPProblem

    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 10))
    A[2] = 0.0
    b = A @ rng.uniform(0.5, 2.0, 10)
    c = A.T @ rng.standard_normal(4) + rng.uniform(0.5, 2.0, 10)
    return LPProblem(c=c, A=A, rlb=b, rub=b, lb=np.zeros(10), ub=np.full(10, np.inf),
                     name="zero_row")


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


def highs_tight_objective(p) -> float:
    """HiGHS on a standard-form request (min cᵀx, Ax = b, x ≥ 0) at primal
    and dual feasibility tolerances of 1e-10. At its default 1e-7 HiGHS
    can stop ~3e-8 from the optimum — more than the 1e-8 the serve phase
    holds: request 480 of the correlated wave reads 3.0e-8 from the IPM's
    answer at 1e-7 and 1.6e-9 at 1e-10 (rel_gap 1.8e-9, pinf 1e-12)."""
    import scipy.optimize as sopt

    h = sopt.linprog(p.c, A_eq=p.A, b_eq=p.rlb, bounds=(0, None), method="highs",
                     options={"primal_feasibility_tolerance": 1e-10,
                              "dual_feasibility_tolerance": 1e-10})
    if h.status != 0:
        fail(f"HiGHS did not solve {p.name}: {h.message}")
    return h.fun


# Host calls that each put one operation on the card: kernel launches
# (runtime and driver API), graph launches, copies and fills.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def device_profile(torch, run, tag):
    """``run()`` under ``torch.profiler``: its result, and the kernel
    time by category and by kernel, device busy time, the operations on
    the card and the host calls that launched them. The Chrome trace goes
    to ``build/dlps_torch/{tag}_trace.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [
        (ev.key, ev.self_device_time_total / 1e3, ev.count)
        for ev in events
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    kernels.sort(key=lambda t: -t[1])
    calls = {}
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.key.startswith(LAUNCH_CALLS):
            name = next(c for c in LAUNCH_CALLS if ev.key.startswith(c))
            calls[name] = calls.get(name, 0) + ev.count
    categories, names = {}, {}
    for key, ms, _ in kernels:
        k = key.lower()
        cat = next((c for c, words in (
            ("normal_eq", ("normal_eq",)),
            ("cholesky", ("potrf", "getrf", "chol", "syrk", "herk")),
            ("triangular_solve", ("trsv", "trsm", "potrs")),
            ("gemv_bmv", ("gemv", "dot_kernel", "gemm")),
            ("memcpy", ("memcpy", "memset")),
        ) if any(w in k for w in words)), "elementwise_reduce_other")
        categories[cat] = categories.get(cat, 0.0) + ms
        names.setdefault(cat, []).append(key[:80])
    out_dir = os.path.join(ROOT, "build", "dlps_torch")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_trace.json"))
    return r, {
        "device_busy_ms": sum(t[1] for t in kernels),
        "device_ops": sum(t[2] for t in kernels), "host_launch_calls": calls,
        "by_category_ms": categories,
        # Which library kernels factor and solve.
        "linalg_kernels": {c: names[c] for c in ("cholesky", "triangular_solve") if c in names},
        "top": [{"kernel": k[:80], "ms": ms, "count": c} for k, ms, c in kernels[:10]],
    }


def profile_main_path(torch, m, n, seed, tag, **loop_kw):
    """Device-time breakdown of one warm main-path solve, and the idle
    share of the backend's host-clock window (setup + iterations)."""
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    p = random_dense_lp(m, n, seed=seed)
    r, prof = device_profile(torch, lambda: solve(p, backend="cuda", tol=1e-8, **loop_kw),
                             f"main_path_{tag}")
    return {
        "loop": tag, "iterations": r.iterations, "solve_s_profiled": r.solve_time,
        "setup_s_profiled": r.setup_time, "device_busy_ms": prof["device_busy_ms"],
        # Over the backend's window: setup (copy, starting point) + loop.
        "device_idle_share": 1.0 - prof["device_busy_ms"] / (1e3 * (r.setup_time + r.solve_time)),
        **{k: v for k, v in prof.items() if k != "device_busy_ms"},
    }


# The batched solver's configuration (BASELINE.json:11): 1024 independent
# standard-form LPs of 128×512, f64, tol 1e-8.
BATCH, BM, BN = 1024, 128, 512
# Members held against HiGHS and the dense solo solve: every 32nd.
SAMPLE = range(0, BATCH, 32)


def batched_solve(torch, batch, **kw):
    """``solve_batched(batch, tol=1e-8, **kw)`` on the card with the
    kernel's launch count reset just before and read just after, and its
    accounting: K1 runs once for each chunk's batched start, once per body
    of the batched loops (one launch for every lane of the loop) and once
    per body of each solo cleanup solve (warm-started, so without a start
    of its own)."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends.batched import solve_batched
    from distributedlpsolver_tpu_torch.ops import normal_eq

    torch.cuda.reset_peak_memory_stats()
    normal_eq.launches = 0
    t0 = time.perf_counter()
    r = solve_batched(batch, tol=1e-8, **kw)
    wall = time.perf_counter() - t0
    launches = normal_eq.launches
    loops = [row for row in r.phase_report if row["phase"] != "cleanup"]
    cleanup = [row for row in r.phase_report if row["phase"] == "cleanup"]
    acc = {k: sum(row[k] for row in loops) for k in ("bodies", "eager", "replays", "masked", "runs")}
    for k in ("eager_ms", "capture_ms", "replay_ms"):
        acc[k] = sum(row[k] for row in loops)
    cleanup_bodies = sum(row["bodies"] for row in cleanup)
    starts = len({row["chunk"] for row in loops})
    if launches != starts + acc["bodies"] + cleanup_bodies:
        fail(f"batched {kw}: {launches} K1 launches for {starts} starts + {acc['bodies']} bodies + "
             f"{cleanup_bodies} cleanup bodies")
    if acc["bodies"] != sum(row["iters"] for row in loops) + acc["masked"] or (
            acc["masked"] > MAX_MASKED * acc["runs"]):
        fail(f"batched {kw}: {acc['bodies']} bodies for {[row['iters'] for row in loops]} "
             f"iterations, {acc['masked']} past the exit over {acc['runs']} runs")
    its = r.iterations.astype(np.int64)
    row = {
        "kw": kw, "wall_s": wall, "setup_s": r.setup_time, "solve_s": r.solve_time,
        "optimal": r.n_optimal, "members": len(its),
        "member_iters": [int(its.min()), float(its.mean()), int(its.max())],
        "normal_eq_launches": launches, "starts": starts, **acc,
        "sizes": [row["sizes"] for row in loops],
        "cleanup_solves": len(cleanup), "cleanup_members": [row["member"] for row in cleanup],
        "cleanup_bodies": cleanup_bodies,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "member_iters_per_s": float(its.sum()) / r.solve_time,
        "batch_bodies_per_s": acc["bodies"] / r.solve_time,
    }
    return row, r


def check_members(name, r, max_iter):
    """Every member OPTIMAL at the tolerance (rel_gap ≤ 1e-8, pinf ≤ 1e-7),
    or left at the iteration limit with its whole budget spent — the JAX
    package's verdict for a member still short of the tolerance after
    max_iter batched iterations. Returns the indices of the latter."""
    import numpy as np

    status = np.array([s.value for s in r.status])
    opt = status == "optimal"
    if not (np.all(r.rel_gap[opt] <= 1e-8) and np.all(r.pinf[opt] <= 1e-7)
            and np.all(np.isfinite(r.objective)) and np.all(np.isfinite(r.x))):
        fail(f"{name}: an OPTIMAL member above the tolerance, or a non-finite answer")
    limited = np.flatnonzero(~opt)
    if not (np.all(status[limited] == "iteration_limit") and np.all(r.iterations[limited] == max_iter)):
        fail(f"{name}: members {limited.tolist()} end {status[limited].tolist()} at "
             f"{r.iterations[limited].tolist()} iterations")
    return limited.tolist()


def batched_phase(torch, ne, card):
    """K1 with a lane axis on the card, then the batched solver at the
    full width (see the module note, step 8). Returns the batched
    kernel's parity rows, its timing rows and the default cold run's
    row."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models import random_batched_lp

    # K1 batched: the full width in f64, and a ragged batch with an odd
    # m·n (every odd f64 lane 8 bytes off a 16-byte boundary) in all three.
    parity = {}
    for dt, (B, m, n) in [("float64", (BATCH, BM, BN)), ("float64", (3, 100, 333)),
                          ("float32", (3, 100, 333)), ("bfloat16", (3, 100, 333))]:
        parity[f"{dt}_{shape_name(m, n, B)}"] = kernel_parity(torch, ne, m, n, dt, batch=B)
    for k, (rel, mx) in parity.items():
        print(f"parity normal_eq batched {k}: rel_err {rel:.3e} max_abs_err {mx:.3e} "
              f"(tol {TOL[k.split('_')[0]]:.0e}), every lane bitwise equal to the unbatched kernel, "
              "M = Mᵀ bitwise, two launches bitwise equal")
    timings = [kernel_timing(torch, ne, BM, BN, "float64", iters=20, warm=3, batch=BATCH),
               kernel_timing(torch, ne, 100, 333, "float64", iters=20, warm=3, batch=3)]
    for t in timings:
        print(f"timing normal_eq batched {t['dtype']} {'x'.join(map(str, t['shape']))}: kernel "
              f"{t['ms']:.4f} ms ({t['issued_tflops']:.2f} TFLOP/s issued), plain {t['plain_ms']:.4f} ms, "
              f"library(einsum) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"bound share {t['bound_share']:.3f} [{card}]")

    # The full-width solve: cold (the first batched solve of the process)
    # and warm, on the default configuration.
    batch = random_batched_lp(BATCH, BM, BN, seed=0)
    max_iter = SolverConfig().max_iter
    print(f"linalg: preferred library {torch.backends.cuda.preferred_linalg_library()}")
    runs = {}
    for tag, kw in (("cold", {}), ("warm", {}), ("segmented", {"segment_iters": 8}),
                    ("chunked", {"chunk": 256, "segment_iters": 8})):
        row, r = batched_solve(torch, batch, **kw)
        row["limited"] = check_members(f"batched {tag}", r, max_iter)
        runs[tag] = (row, r)
        print(f"batched_{tag} " + json.dumps(row) + f" [{card}]")
    (cold, rc), (warm, rw), (seg, rs), (chunked, rk) = (runs[k] for k in ("cold", "warm", "segmented", "chunked"))
    same = lambda a, b: [s.value for s in a.status] == [s.value for s in b.status]
    rel = lambda a, b: np.abs(a - b) / (1.0 + np.abs(b))
    if not (same(rw, rc) and np.array_equal(rw.iterations, rc.iterations)
            and rel(rw.objective, rc.objective).max() <= 1e-9):
        fail("batched: the warm solve differs from the cold one")
    # Objectives are compared where both runs end OPTIMAL: a member left
    # at the iteration limit keeps an unfinished iterate, which the
    # segmented run's solo cleanup moves.
    opt = np.array([s.value == "optimal" for s in rc.status])
    seg_rel = rel(rs.objective[opt], rc.objective[opt]).max()
    if not (same(rs, rc) and seg_rel <= 1e-9):
        fail(f"batched segmented(8): statuses or objectives (max rel {seg_rel:.3e}) differ "
             "from the unsegmented run")
    # chunk=256 + segment_iters=8 is the JAX package's schedule on a TPU,
    # the one BENCH_SUITE.json's 1024/1024 record ran: every member must
    # end OPTIMAL.
    if chunked["optimal"] != BATCH:
        fail(f"batched chunk=256 segmented(8): {chunked['optimal']}/{BATCH} OPTIMAL")
    print(f"batched: members the default run left at the iteration limit: {cold['limited']}; "
          f"chunk=256 segmented(8) solves all {BATCH}, its objectives vs the default run's OPTIMAL "
          f"members max rel {rel(rk.objective[opt], rc.objective[opt]).max():.3e}; segmented(8) vs "
          f"default max rel {seg_rel:.3e}")

    # Sampled members (and any the default run left unfinished) against
    # HiGHS and against the dense solo solve on the card.
    # Both the batched and the solo solve stop at a relative gap of 1e-8,
    # by different paths, so their objectives may differ by about that
    # much: the solo comparison holds them to 1e-8 and counts how many
    # agree to 1e-9.
    sample = sorted(set(SAMPLE) | set(cold["limited"]))
    worst_h, worst_s, within_1e9 = 0.0, 0.0, 0
    for k in sample:
        ref = rk if k in cold["limited"] else rc
        p = batch.problem(k)
        h = highs_objective(p)
        solo = solve(p, backend=get_backend("cuda"), tol=1e-8)
        if solo.status.value != "optimal":
            fail(f"batched member {k}: the dense solo solve ends {solo.status.value}")
        eh = abs(ref.objective[k] - h) / (1.0 + abs(h))
        es = abs(ref.objective[k] - solo.objective) / (1.0 + abs(solo.objective))
        worst_h, worst_s = max(worst_h, eh), max(worst_s, es)
        within_1e9 += es <= 1e-9
        if not (eh <= 1e-8 and es <= 1e-8):
            fail(f"batched member {k}: objective {ref.objective[k]!r} vs HiGHS {h!r} ({eh:.3e}) "
                 f"and the dense solo solve {solo.objective!r} ({es:.3e})")
    print(f"batched: {len(sample)} members {sample[:3]}…{sample[-2:]} vs HiGHS max rel {worst_h:.3e} "
          f"(tol 1e-8), vs the dense solo solve on the card max rel {worst_s:.3e} (tol 1e-8; "
          f"{within_1e9} of {len(sample)} within 1e-9)")

    # Where a warm batched solve's device time goes.
    from distributedlpsolver_tpu_torch.backends.batched import solve_batched

    r, prof = device_profile(torch, lambda: solve_batched(batch, tol=1e-8), "batched")
    prof_row = {
        "solve_s_profiled": r.solve_time, "setup_s_profiled": r.setup_time,
        "device_busy_ms": prof["device_busy_ms"],
        "device_idle_share": 1.0 - prof["device_busy_ms"] / (1e3 * (r.setup_time + r.solve_time)),
        **{k: v for k, v in prof.items() if k != "device_busy_ms"},
    }
    print("profile_batched " + json.dumps(prof_row) + f" [{card}]")
    return parity, timings, cold


# The serve phase: requests at the batched member width, padded into one
# bucket shape of SERVE_BATCH slots (BASELINE.json:11's members).
SERVE_BATCH = 256
SERVE_SAMPLE = 32  # every 32nd request against HiGHS


def serve_wave(torch, ne, svc, tag, problems, card):
    """Submit ``problems`` to the running service and wait for all: the
    wave's row (printed) and results. K1's launch count is reset just
    before and read just after; each dispatch row must hold K1 = start +
    warm selection + bodies (and the same for a cold bucket's
    one-iteration warm-up), and the wave's count must equal the
    dispatches' plus the solo solves'."""
    from distributedlpsolver_tpu_torch.backends import batched as tb
    from distributedlpsolver_tpu_torch.serve import latency_summary

    rows0 = len(svc.dispatch_report())
    size0, caps0 = tb.bucket_cache_size(), tb.bucket_capture_count()
    torch.cuda.reset_peak_memory_stats()
    ne.normal_eq.launches = 0
    t0 = time.perf_counter()
    futs = [svc.submit(p) for p in problems]
    submit_s = time.perf_counter() - t0
    if not svc.drain(timeout=900):
        fail(f"serve {tag}: the service did not drain")
    wall = time.perf_counter() - t0
    launches = ne.normal_eq.launches
    results = [f.result() for f in futs]
    rows = svc.dispatch_report()[rows0:]
    bucket_launches = sum(r["launches"] + r["warmup_launches"] for r in rows)
    solo = [r for r in results if r.retried_solo or r.bucket is None]
    summ = latency_summary(results)
    n = max(len(rows), 1)
    row = {
        "wave": tag, "requests": len(results), "wall_s": wall,
        "rps": len(results) / wall, "submit_s": submit_s,
        "latency_ms_p50": summ["latency_ms_p50"],
        "latency_ms_p99": summ["latency_ms_p99"], "dispatches": len(rows),
        "live": [r["live"] for r in rows],
        "pack_ms": [r["pack_ms"] for r in rows], "compile_ms": [r["compile_ms"] for r in rows],
        "solve_ms": [r["solve_ms"] for r in rows], "overlap_ms": [r["overlap_ms"] for r in rows],
        "padding_waste_mean": summ.get("mean_padding_waste"),
        "bodies_per_dispatch": [r["bodies"] for r in rows],
        "bodies_mean": sum(r["bodies"] for r in rows) / n,
        "replays": sum(r["replays"] for r in rows),
        "captures": sum(r["captures"] + r["warmup_captures"] for r in rows),
        "normal_eq_launches": launches, "bucket_launches": bucket_launches,
        "solo_fallbacks": len(solo), "solo_ms": [r.solve_ms for r in solo],
        "solo_members": [(r.name, r.iterations, [f.detail[:60] for f in r.faults]) for r in solo],
        "warm_used": sum(1 for r in results if r.warm == "warm"),
        "iterations_mean": sum(r.iterations for r in results) / max(len(results), 1),
        "programs_built": tb.bucket_cache_size() - size0,
        "graphs_captured": tb.bucket_capture_count() - caps0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "status": summ["status_breakdown"],
    }
    print(f"serve_{tag} " + json.dumps(row) + f" [{card}]")
    for r in rows:
        if r["launches"] != 2 + r["bodies"] or (
                r["warmup_launches"] != (2 if r["warmup_bodies"] else 0) + r["warmup_bodies"]):
            fail(f"serve {tag}: dispatch {r['dispatch']} K1 launches {r['launches']} "
                 f"(+{r['warmup_launches']} warm-up) for start + warm selection + "
                 f"{r['bodies']} bodies (+{r['warmup_bodies']})")
    if launches == 0 or launches < bucket_launches or (not solo and launches != bucket_launches):
        fail(f"serve {tag}: {launches} K1 launches in the wave, {bucket_launches} in its "
             f"dispatches, {len(solo)} solo solves")
    return row, results


def serve_phase(torch, ne, card):
    """The serve phase (see the module note, step 9). Returns K1's parity
    and timing at the bucket shape and the waves' rows."""
    import tempfile

    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models import (
        correlated_request_stream,
        random_request_stream,
    )
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService

    parity = kernel_parity(torch, ne, BM, BN, "float64", batch=SERVE_BATCH)
    timing = kernel_timing(torch, ne, BM, BN, "float64", iters=20, warm=3, batch=SERVE_BATCH)
    print(f"parity normal_eq serve bucket float64 {shape_name(BM, BN, SERVE_BATCH)}: rel_err "
          f"{parity[0]:.3e} max_abs_err {parity[1]:.3e} (tol {TOL['float64']:.0e})")
    print(f"timing normal_eq serve bucket float64 {shape_name(BM, BN, SERVE_BATCH)}: kernel "
          f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, library(einsum) "
          f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}), "
          f"bound share {timing['bound_share']:.3f} [{card}]")

    waves = [
        ("cold", list(random_request_stream(1024, shapes=((96, 384), (BM, BN)), seed=21))),
        ("warm", list(random_request_stream(1024, shapes=((96, 384), (BM, BN)), seed=22))),
        ("correlated", list(correlated_request_stream(512, shapes=((BM, BN),), n_models=4, seed=23))),
    ]
    rows = {}
    max_iter = SolverConfig().max_iter
    with SolveService(ServiceConfig(batch=SERVE_BATCH, flush_s=0.02)) as svc:
        for tag, problems in waves:
            row, results = serve_wave(torch, ne, svc, tag, problems, card)
            # OPTIMAL, or the JAX package's verdict for a request its bucket
            # and its solo solve both left short of the tolerance after
            # max_iter iterations (scripts/port_serve_jax_verdicts.py gives
            # it on the CPU for these streams).
            limited = [k for k, r in enumerate(results) if r.status.value != "optimal"]
            bad = [(k, results[k].status.value, results[k].iterations) for k in limited
                   if not (results[k].status.value == "iteration_limit" and results[k].retried_solo
                           and results[k].iterations == max_iter)]
            if bad:
                fail(f"serve {tag}: requests neither OPTIMAL nor at the iteration limit with "
                     f"the solo budget spent: {bad[:10]}")
            if limited:
                print(f"serve_{tag}: at the iteration limit after the solo ladder: "
                      f"{[(k, results[k].name) for k in limited]}")
            for r in results:
                if r.bucket is not None and tuple(r.bucket) != (BM, BN, SERVE_BATCH):
                    fail(f"serve {tag}: request {r.name} in bucket {r.bucket}")
            worst = 0.0
            for k in range(0, len(problems), SERVE_SAMPLE):
                if results[k].status.value != "optimal":
                    continue  # at the JAX package's verdict (checked above)
                h = highs_tight_objective(problems[k])
                e = abs(results[k].objective - h) / (1.0 + abs(h))
                worst = max(worst, e)
                if not e <= 1e-8:
                    fail(f"serve {tag}: request {k} objective {results[k].objective!r} vs HiGHS {h!r}")
            row["highs_max_rel"] = worst
            print(f"serve_{tag}: {len(range(0, len(problems), SERVE_SAMPLE))} requests vs HiGHS max rel "
                  f"{worst:.3e} (tol 1e-8)")
            rows[tag] = row
        # Where a warm wave's time goes: one more wave under the profiler.
        extra = list(random_request_stream(512, shapes=((96, 384), (BM, BN)), seed=24))
        (prow, _), prof = device_profile(
            torch, lambda: serve_wave(torch, ne, svc, "profiled", extra, card), "serve")
        print("profile_serve " + json.dumps({
            "wall_s": prow["wall_s"], "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": 1.0 - prof["device_busy_ms"] / (1e3 * prow["wall_s"]),
            **{k: v for k, v in prof.items() if k != "device_busy_ms"},
        }) + f" [{card}]")
        stats = svc.stats()
    for tag in ("warm", "correlated"):
        if rows[tag]["programs_built"] or rows[tag]["graphs_captured"]:
            fail(f"serve {tag}: {rows[tag]['programs_built']} bucket programs built, "
                 f"{rows[tag]['graphs_captured']} graphs captured")
    if rows["correlated"]["warm_used"] <= 0:
        fail("serve correlated: no request started warm")
    from distributedlpsolver_tpu_torch.backends.batched import bucket_donation_report

    print("serve_bucket_memory " + json.dumps(bucket_donation_report(BM, BN, SERVE_BATCH))
          + f" [{card}]")
    print("serve_stats " + json.dumps({k: stats[k] for k in (
        "requests", "dispatches", "programs_compiled", "pack_ms_total", "overlap_ms_total",
        "warm_cache", "buckets")}) + f" [{card}]")

    # The CLI, in a fresh process: 8 requests of 128×512.
    with tempfile.TemporaryDirectory() as d:
        req = os.path.join(d, "requests.jsonl")
        with open(req, "w") as fh:
            for k in range(8):
                fh.write(json.dumps({"m": BM, "n": BN, "seed": k}) + "\n")
        proc = subprocess.run(
            [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "serve", "--requests", req],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
        )
    recs = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or len(recs) != 8 or any(r["status"] != "optimal" for r in recs):
        fail(f"cli serve: rc {proc.returncode}, {[r.get('status') for r in recs]}\n{proc.stderr[-3000:]}")
    print(f"cli serve: 8 requests of {BM}x{BN}, all optimal, iterations {[r['iterations'] for r in recs]}")
    return parity, timing, rows


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
    dmma = dmma_count(ne)
    print(f"sass: {dmma} DMMA instructions in normal_eq_dmma_kernel (f64)")
    if dmma <= 0:
        fail("the f64 kernel's SASS holds no DMMA instruction")

    # 2. Parity on the card.
    parity = {}
    for dt in ("float64", "float32", "bfloat16"):
        past_edge = 2 * ne.tile_edge(getattr(torch, dt)) + 1  # one row past two tiles
        for (m, n) in [(2048, 10240), (1000, 3001), (past_edge, 515)]:
            parity[f"{dt}_{m}x{n}"] = kernel_parity(torch, ne, m, n, dt)
    parity["float64_10000x50000"] = kernel_parity(torch, ne, 10000, 50000, "float64")
    for k, (rel, mx) in parity.items():
        print(f"parity normal_eq {k}: rel_err {rel:.3e} max_abs_err {mx:.3e} (tol {TOL[k.split('_')[0]]:.0e}), "
              "M = Mᵀ bitwise, two launches bitwise equal")

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
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}), "
              f"bound share {t['bound_share']:.3f} [{card}]")

    # 4. The main path (the fused loop), counts reset just before and read
    # just after.
    print(f"linalg: preferred library {torch.backends.cuda.preferred_linalg_library()}")
    row, _, r_fused = main_path(2048, 10240, seed=0)
    print("main_path " + json.dumps(row))
    small, p_small, r_small = main_path(256, 1024, seed=0)
    h_obj = highs_objective(p_small)
    rel = abs(r_small.objective - h_obj) / (1.0 + abs(h_obj))
    if not rel <= 1e-8:
        fail(f"256x1024 objective {r_small.objective!r} vs HiGHS {h_obj!r}: {rel:.3e}")
    print(f"small_path {small['problem']}: {small['status']} {small['iterations']} it, "
          f"objective vs HiGHS rel {rel:.3e}")
    # The same main-path solve again, warm (libraries loaded, kernels built).
    warm_row, _, _ = main_path(2048, 10240, seed=0)
    drift = abs(warm_row["objective"] - row["objective"]) / (1.0 + abs(row["objective"]))
    if drift > 1e-9 or warm_row["iterations"] != row["iterations"]:
        fail(f"main path: warm solve {warm_row['objective']!r}/{warm_row['iterations']} it "
             f"differs from the cold one {row['objective']!r}/{row['iterations']} it")
    print("main_path_warm " + json.dumps(warm_row))

    # 5. The host loop and the segmented loop against the fused one, then
    # cold solves in fresh processes, then the bad-step path.
    for kw in ({"fused_loop": False}, {"segment_iters": 4}):
        other_row, _, r_other = main_path(2048, 10240, seed=0, **kw)
        other_row["x_bitwise_equal_to_fused"] = same_answer(
            other_row["loop"], r_fused, row, r_other, other_row)
        print(f"main_path_{other_row['loop']} " + json.dumps(other_row))
    for kw in ({}, {"fused_loop": False}):
        cold = cold_solve(kw)
        print(f"main_path_cold_{cold['loop']} " + json.dumps(cold))
    r_bad, launches, phases, _, _ = solve_counted(zero_row_lp(), presolve=False, reg_dual=0.0)
    acc = launch_accounting(r_bad, launches, phases, 0, fused=True)
    if r_bad.status.value != "numerical_error" or r_bad.iterations != 0:
        fail(f"zero-row LP: {r_bad.status.value} at {r_bad.iterations} iterations")
    print(f"bad_step_path zero_row: {r_bad.status.value} at {r_bad.iterations} iterations " + json.dumps(acc))

    # 6. The CLI on a fixture.
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

    # 7. Where the main path's device time goes (warm solves, both loops).
    for tag, kw in (("fused", {}), ("host", {"fused_loop": False})):
        print(f"profile_{tag} " + json.dumps(profile_main_path(torch, 2048, 10240, 0, tag, **kw)))

    # 8. The batched solver, with vmap's per-sample fallback off for the
    # whole phase (solve_batched also turns it off for its own run).
    torch._C._functorch._set_vmap_fallback_enabled(False)
    b_parity, b_timings, b_cold = batched_phase(torch, ne, card)

    # 9. The serve phase.
    s_parity, s_timing, s_rows = serve_phase(torch, ne, card)

    main_t = timings[0]
    batched_t = b_timings[0]
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
        "bound_share": main_t["bound_share"],
        "library_ms": main_t["library_ms"],
        "kernel_ms": main_t["ms"],
        "dtypes": ["float64", "float32", "bfloat16"],
        "shape": main_t["shape"],
        "timings": timings,
        "dmma_instructions": dmma,
    }, {
        "name": "normal_eq (batched)",
        "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        # The batched path's launches: one for every lane at a time.
        "launches": b_cold["normal_eq_launches"],
        "max_abs_err": b_parity[f"float64_{shape_name(BM, BN, BATCH)}"][1],
        "ms": batched_t["ms"],
        "plain_ms": batched_t["plain_ms"],
        "bound_ms": batched_t["bound_ms"],
        "bound_by": batched_t["bound_by"],
        "bound_share": batched_t["bound_share"],
        "library_ms": batched_t["library_ms"],
        "kernel_ms": batched_t["ms"],
        "dtypes": ["float64", "float32", "bfloat16"],
        "shape": batched_t["shape"],
        "timings": b_timings,
    }, {
        "name": "normal_eq (serve bucket)",
        "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        # The serve path's launches over its three waves (one for every
        # lane of a bucket at a time).
        "launches": sum(r["normal_eq_launches"] for r in s_rows.values()),
        "max_abs_err": s_parity[1],
        "ms": s_timing["ms"],
        "plain_ms": s_timing["plain_ms"],
        "bound_ms": s_timing["bound_ms"],
        "bound_by": s_timing["bound_by"],
        "bound_share": s_timing["bound_share"],
        "library_ms": s_timing["library_ms"],
        "kernel_ms": s_timing["ms"],
        "dtypes": ["float64"],
        "shape": s_timing["shape"],
    }]}
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one-solve"]:
        sys.exit(one_solve(json.loads(sys.argv[2])))
    sys.exit(main())
