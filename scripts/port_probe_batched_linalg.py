#!/usr/bin/env python3
"""Which batched solve of the Cholesky factor the port's batched step can
capture in a CUDA graph, on one CUDA card.

The batched solver runs the unbatched step under ``torch.func.vmap``
(per-sample fallback off) and captures it in a CUDA graph. This probe
does the same with the step's linear algebra alone, at the batched
configuration's shape (1024 lanes, 128×128 factors of 128×512 A): the
normal-equations assembly, ``cholesky_ex``, then either
``torch.cholesky_solve`` or two ``torch.linalg.solve_triangular``. For
each it prints whether the capture succeeded, whether a replay gives the
eager bits, and the kernels the eager call ran (``torch.profiler``).

    python scripts/port_probe_batched_linalg.py

Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} | preferred linalg library "
          f"{torch.backends.cuda.preferred_linalg_library()}")
    torch._C._functorch._set_vmap_fallback_enabled(False)
    B, m, n = 1024, 128, 512
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn(B, m, n, dtype=torch.float64, device="cuda", generator=g)
    d = torch.rand(B, n, dtype=torch.float64, device="cuda", generator=g) + 0.1
    rhs = torch.randn(B, m, dtype=torch.float64, device="cuda", generator=g)

    def lane(a, dd, r, solver):
        M = normal_eq(a, dd)
        L, info = torch.linalg.cholesky_ex(M)
        L = torch.where(info == 0, L, float("nan"))
        if solver == "cholesky_solve":
            return torch.cholesky_solve(r[:, None], L, upper=False)[:, 0]
        y = torch.linalg.solve_triangular(L, r[:, None], upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]

    stream = torch.cuda.Stream()
    for solver in ("solve_triangular", "cholesky_solve"):
        f = torch.func.vmap(lambda a, dd, r: lane(a, dd, r, solver))
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            eager = f(A, d, rhs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            f(A, d, rhs)
            torch.cuda.synchronize()
        kernels = sorted({ev.key[:90] for ev in prof.key_averages()
                          if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0})
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                out = f(A, d, rhs)
            graph.replay()
            torch.cuda.synchronize()
            verdict = f"captured; replay bitwise equal to eager: {torch.equal(out, eager)}"
        except Exception as e:  # the probe reports what capture raises
            verdict = f"capture FAILED: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
        print(f"{solver}: {verdict} [{card}]")
        for k in kernels:
            print(f"  {solver} kernel: {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
