#!/usr/bin/env python3
"""Host cost of CUDA-event stage timing on the card, the way the scenario
tier's stage clock (``backends/scenario.py::_StageClock``) uses it.

Between ``--n`` small kernels (an in-place add on a 1,024-entry vector),
each variant records one event and is timed on the host clock, minus the
kernels alone:

* ``new``: a ``torch.cuda.Event(enable_timing=True)`` made and recorded
  each time (the event is created on its first record);
* ``pooled``: events made and recorded once beforehand, recorded again;
* ``new_no_timing``: a ``torch.cuda.Event()`` made and recorded;
* ``elapsed``: ``elapsed_time`` of each consecutive pair, after a sync;
* ``free``: dropping the ``new`` variant's events.

Prints one JSON line of microseconds an event (median of ``--reps``) and
the card's name and power limit.

    python scripts/port_time_events.py [--n 4000] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_time_events: no CUDA device")
        return 2
    n = args.n
    v = torch.zeros(1024, dtype=torch.float64, device="cuda")

    def run(per_event):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            v.add_(1.0)
            per_event(i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {k: [] for k in ("kernels_only_us", "new", "pooled", "new_no_timing", "elapsed", "free")}
    pool = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for ev in pool:
        ev.record()
    for _ in range(args.reps + 1):  # the first round warms up
        base = run(lambda i: None)
        made = []
        t_new = run(lambda i: made.append(torch.cuda.Event(enable_timing=True)) or made[-1].record())
        t_pool = run(lambda i: pool[i].record())
        plain = []
        t_plain = run(lambda i: plain.append(torch.cuda.Event()) or plain[-1].record())
        t0 = time.perf_counter()
        for a, b in zip(made, made[1:]):
            a.elapsed_time(b)
        t_el = time.perf_counter() - t0
        t0 = time.perf_counter()
        del made[:]
        t_free = time.perf_counter() - t0
        del plain[:]
        out["kernels_only_us"].append(1e6 * base / n)
        for key, t in (("new", t_new - base), ("pooled", t_pool - base),
                       ("new_no_timing", t_plain - base), ("elapsed", t_el), ("free", t_free)):
            out[key].append(1e6 * t / n)
    med = {k: statistics.median(vals[1:]) for k, vals in out.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"events": n, "us_per_event_median": med, "runs": out, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
