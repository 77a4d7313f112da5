#!/usr/bin/env python3
"""Time the port's normal-equations kernel (K1) for the checkout in the
current directory, at the shapes its paths give it: the main path's
2048×10240 in f64, f32 and bf16, the two-phase auto PCG's 4096×20480 in
f32, and the block tier's linking rows in f64 (pds-10's 800 × 46,247,
pds-20's 1,600 × 92,813, and rank 0's 800 × 26,039 in a world of 2).

Run from the root of a checkout on a machine with a CUDA card; to compare
two commits on one card, unpack each into its own directory and run the
script from each in turns (parent, change, change, parent):

    (cd parent && python /path/to/scripts/port_time_k1.py)
    (cd change && python /path/to/scripts/port_time_k1.py)

It builds the checkout's kernel (into its ``build/dlps_torch/``), prints
nvcc's register lines, then for each shape one line: the mean
milliseconds of a launch over 20 after 3 warm-up launches (CUDA events),
``torch.einsum``'s on the same inputs, the f64 split count where the
checkout has one, and the first 16 hex digits of the sha256 of M's bytes
(equal digests: the same bits). Every line is keyed by the directory's
name and ends with the card's name and power limit.

With ``--sweep`` it times instead each f64 linking shape at every split
count from 1 to its column floor's limit, forced through the launch's
private handle, beside the split ``split_count`` picks (the checkout
must have the split):

    python scripts/port_time_k1.py --sweep
"""

import hashlib
import importlib
import os
import subprocess
import sys

SHAPES = [
    ("float64", 2048, 10240),
    ("float32", 2048, 10240),
    ("bfloat16", 2048, 10240),
    ("float32", 4096, 20480),
    ("float64", 800, 46247),
    ("float64", 1600, 92813),
    ("float64", 800, 26039),
]


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


def sweep(torch, ne, card) -> int:
    for m, n in [(m, n) for dt, m, n in SHAPES if dt == "float64" and m < 2048]:
        g = torch.Generator(device="cuda").manual_seed(1)
        A = torch.randn(m, n, dtype=torch.float64, device="cuda", generator=g)
        d = torch.rand(n, dtype=torch.float64, device="cuda", generator=g) + 0.1
        times = {s: round(ms(torch, lambda: ne._launch(A, d, torch.float64, splits=s), it=10), 4)
                 for s in range(1, max(1, n // ne.SPLIT_MIN_COLUMNS) + 1)}
        best = min(times, key=times.get)
        print(f"sweep float64 {m}x{n}: chosen {ne.splits_on(A)}, fastest {best}, ms by splits "
              f"{times} [{card}]", flush=True)
        del A, d
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")
    ne.load_library()
    tag = os.getcwd().split("/")[-1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if sys.argv[1:] == ["--sweep"]:
        return sweep(torch, ne, card)
    print(tag, [ln for ln in ne.build_info.get("ptxas", []) if "registers" in ln], flush=True)
    for dt, m, n in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(1)
        A = torch.randn(m, n, dtype=torch.float64, device="cuda", generator=g)
        d = torch.rand(n, dtype=torch.float64, device="cuda", generator=g) + 0.1
        Ad, dd = A.to(getattr(torch, dt)), d.to(getattr(torch, dt))
        del A, d
        M = ne.normal_eq(Ad, dd)
        torch.cuda.synchronize()
        digest = hashlib.sha256(M.cpu().numpy().tobytes()).hexdigest()[:16]
        del M
        splits = ne.splits_on(Ad) if hasattr(ne, "splits_on") else 1
        k1 = ms(torch, lambda: ne.normal_eq(Ad, dd))
        lib = ms(torch, lambda: torch.einsum("ik,k,jk->ij", Ad, dd, Ad))
        print(f"{tag} {dt} {m}x{n}: kernel {k1:.4f} ms, einsum {lib:.4f} ms, splits {splits}, "
              f"M sha256 {digest} [{card}]", flush=True)
        del Ad, dd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
