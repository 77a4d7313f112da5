"""Utilization folding for phase reports.

The port of the JAX package's ``utils/utilization.py``.
``core.drive_phase_plan`` records one ``{"phase", "iters", "wall_s"}`` row
per phase; the backends stamp each row's ``"mode"`` from their plan
("f32"/"mixed"/"f64"/"f64c"/"pcg"/"endgame"). This helper turns that into
the utilization fields the scale artifacts record: effective FLOP/s per
assembly-bound phase, its percentage of the watchdog seed rates
(``core.SEG_RATE_F32``/``SEG_RATE_F64``, the conservative per-dtype rates
the segments are budgeted with), and its percentage of the card's peak
for that arithmetic class. ``pct_of_seed_rate`` is budget-relative (is
the phase running at the rate its watchdog segments were sized for?);
``pct_of_chip_peak`` is roofline-relative (how much of the card does the
phase use?). PCG and endgame phases get no rate: their per-iteration
flops are data-dependent, so their rows carry only the measured
iters/wall split.
"""

from __future__ import annotations

# Peaks of one H100 SXM (NVIDIA data sheet, dense): FP64 on the tensor
# cores and FP32 67 TFLOP/s each; HBM3 3.35 TB/s. The card has native
# FP64, so f64 phases share the f32 denominator's magnitude.
CHIP_PEAK_F32 = 67e12
CHIP_PEAK_F64 = 67e12
CHIP_PEAK_BYTES = 3.35e12


def fold_utilization(report, flops_per_iter: float):
    """Annotate ``report`` rows (in place) with ``eff_flops_per_s``,
    ``pct_of_seed_rate``, and ``pct_of_chip_peak``; returns the list.

    ``flops_per_iter`` is the backend's own per-iteration estimate for
    the direct factorization path — the same operation count runs in f32
    and f64, only the rates differ.
    """
    from distributedlpsolver_tpu_torch.ipm import core

    rates = {
        "f32": (core.SEG_RATE_F32, CHIP_PEAK_F32),
        "mixed": (core.SEG_RATE_F32, CHIP_PEAK_F32),
        "f64": (core.SEG_RATE_F64, CHIP_PEAK_F64),
        "f64c": (core.SEG_RATE_F64, CHIP_PEAK_F64),
    }
    for ph in report:
        pair = rates.get(ph.get("mode"))
        if pair and ph.get("iters") and ph.get("wall_s", 0) > 0:
            seed, peak = pair
            eff = flops_per_iter * ph["iters"] / ph["wall_s"]
            ph["eff_flops_per_s"] = f"{eff:.3g}"
            ph["pct_of_seed_rate"] = round(100.0 * eff / seed, 1)
            ph["pct_of_chip_peak"] = round(100.0 * eff / peak, 2)
    return report
