#!/usr/bin/env python3
"""Time the port's normal-equations kernel (K1) at the main path's shape,
2048×10240, in f64, f32 and bf16, for the checkout in the current
directory.

Run from the root of a checkout on a machine with a CUDA card; to compare
two commits on one card, unpack each into its own directory and run the
script from each in turns (parent, change, change, parent):

    (cd parent && python /path/to/scripts/port_time_k1.py)
    (cd change && python /path/to/scripts/port_time_k1.py)

It builds the checkout's kernel (into its ``build/dlps_torch/``), prints
nvcc's register lines and then the mean milliseconds of a launch over 20
after 3 warm-up launches (CUDA events), keyed by the directory's name.
"""

import importlib
import os
import sys


def ms(torch, fn, it=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(it):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / it


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")
    ne.load_library()
    tag = os.getcwd().split("/")[-1]
    print(tag, [ln for ln in ne.build_info.get("ptxas", []) if "registers" in ln])
    g = torch.Generator(device="cuda").manual_seed(1)
    A = torch.randn(2048, 10240, dtype=torch.float64, device="cuda", generator=g)
    d = torch.rand(10240, dtype=torch.float64, device="cuda", generator=g) + 0.1
    out = {}
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        Ad, dd = A.to(dt), d.to(dt)
        out[str(dt).split(".")[1]] = round(ms(torch, lambda: ne.normal_eq(Ad, dd)), 4)
    print(tag, out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
