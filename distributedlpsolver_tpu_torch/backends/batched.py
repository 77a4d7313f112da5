"""Batched solver: many independent small LPs as one device loop.

The port of the JAX package's ``backends/batched.py::solve_batched``.
BASELINE.json:11 names the workload — 1024 independent (m=128, n=512)
problems solved concurrently. As there, the batch is a first-class array
axis: the unbatched Mehrotra step of the dense backend
(``dense._make_ops`` + ``core.mehrotra_step``) runs under
``torch.func.vmap`` over the lanes, and per-problem convergence is handled
by masking, never by an early exit — a converged member's iterate stays
exactly at its accepted solution while stragglers continue.

Where the JAX package traces one ``lax.while_loop``, the loop here is a
masked body (:func:`_batched_body`) run by ``ipm/device_loop.py``: eagerly
on the CPU, on a card one eager body and then one captured CUDA graph of
the body replayed by the host. Every update of the carry is a
``torch.where`` on the lane mask and on the loop guard, so a body run past
the exit leaves the carry bit for bit. Inside the step:

* the normal-equations assembly is ONE batched launch of the kernel of
  ``ops/normal_eq.py`` for all the lanes (its vmap rule; the JAX package
  assembles with plain XLA here);
* the Cholesky is the batched ``torch.linalg.cholesky_ex``; a lane whose
  factorization fails gets a NaN factor, so only that lane's step is bad;
* a solve is two batched ``torch.linalg.solve_triangular`` (the batched
  ``cholesky_solve`` cannot be captured: see ``dense._cholesky_ops``);
* the regularization is a per-lane tensor passed into the vmap.

vmap's per-sample fallback is switched off while a batched solve runs, so
an operation without a batching rule raises instead of looping the lanes.

Off TPU the JAX package runs one whole-batch program, single-phase f64,
with no chunking and no segments; so does this port by default.
``segment_iters > 0`` drives the loop in host segments with final-phase
compaction (B → B/2 → … → 32, each program size its own captured loop).
Members left unfinished re-solve alone through the ``cuda`` backend on the
same device, warm-started from their batched iterates.

The serving half, :func:`solve_bucket`, solves one pre-padded bucket
with a padding mask and per-slot warm lanes through ONE cached program per
bucket key (:class:`_BucketProgram`: static device buffers and one
captured graph of the same masked loop, replayed by every later dispatch).

``mesh=`` splits the batch axis over a mesh (``parallel/mesh.py``): each
executor — a rank of a process-group mesh, or a device of a local mesh —
places and solves only its contiguous block of lanes, through its own
cached program of B/K lanes keyed by (bucket, mesh). The loop holds no
collective: each lane is masked on its own, so a lane's iterate does not
depend on the other blocks (the JAX package's global ``any(active)``
guard exists only because one XLA program runs every lane), and the
captured graph stays captured even over gloo. After the loop the results
are gathered: a local mesh concatenates its blocks on the host; a world
runs ONE ``all_reduce`` of a zero-filled buffer in which each rank wrote
its own rows (a sum with zeros keeps every bit). A batch that does not
divide the mesh raises ``ValueError``. A local mesh runs its blocks one
after another in this process.

Not ported here: the two-phase and PCG batched schedules (reachable only
on a TPU or by ``solve_mode="pcg"``, which raises), the bucket df32
precision ladder and fused iterations (they raise).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from distributedlpsolver_tpu_torch.backends import dense
from distributedlpsolver_tpu_torch.backends.dense import resolve_device
from distributedlpsolver_tpu_torch.ipm import core, device_loop
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState, Status
from distributedlpsolver_tpu_torch.models.generators import BatchedLP
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.ops import kernel_build
from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq

_RUNNING, _OPTIMAL, _MAXITER, _NUMERR = 0, 1, 2, 3
_STALL = 6  # aligned with core.STATUS_STALL


@dataclasses.dataclass
class BatchedResult:
    """Per-problem outcomes of a batched solve."""

    status: np.ndarray  # (B,) Status values
    objective: np.ndarray  # (B,)
    x: np.ndarray  # (B, n)
    iterations: np.ndarray  # (B,)
    rel_gap: np.ndarray  # (B,)
    pinf: np.ndarray  # (B,)
    dinf: np.ndarray  # (B,)
    solve_time: float = 0.0
    setup_time: float = 0.0
    # Per-phase rows, tagged by chunk: {"phase", "mode", "iters",
    # "wall_s", "chunk"} as in the JAX package's segmented path, plus the
    # device loops' accounting (bodies, eager, replays, masked, runs, the
    # host-clock ms) and the program sizes the phase ran at; one row per
    # solo-cleanup solve ({"phase": "cleanup", "member", ...}).
    phase_report: Optional[list] = None
    # Iterations fused per trip of the device loop (one graph body).
    fused_iters: int = 1
    # Fields of the bucket path (solve_bucket); None from solve_batched.
    y: Optional[np.ndarray] = None
    s: Optional[np.ndarray] = None
    w: Optional[np.ndarray] = None
    z: Optional[np.ndarray] = None
    warm_used: Optional[np.ndarray] = None
    # The PDHG bucket engine's lane duals (B, m), for KKT checks of its
    # answers; ``y`` stays None there, so they never seed a warm start.
    dual: Optional[np.ndarray] = None

    @property
    def n_optimal(self) -> int:
        return int(np.sum(self.status == Status.OPTIMAL))


def _single_step(A, data, state, reg, params, factor_dtype, Af=None):
    # Af: the loop-invariant precast copy of an explicit f32 factor_dtype
    # (the assembly then runs in f32 on it, as in dense._cholesky_ops).
    ops = dense._make_ops(A, reg, factor_dtype, 0, Af, tri_solves=True)
    return core.mehrotra_step(ops, data, params, state)


def _single_start(A, data, reg, params, factor_dtype):
    ops = dense._make_ops(A, reg, factor_dtype, 0, tri_solves=True)
    return core.starting_point(ops, data, params)


@contextlib.contextmanager
def _no_vmap_fallback():
    """vmap's per-sample fallback off for the block: an operation of the
    step without a batching rule raises instead of looping the lanes."""
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)


def _batched_data(c, b) -> core.ProblemData:
    """Per-lane problem vectors of a standard-form batch (no upper
    bounds): ``core.make_problem_data`` under vmap, leaves (B, ...)."""
    u = torch.full_like(c, float("inf"))
    return torch.func.vmap(
        lambda cc, bb, uu: core.make_problem_data(cc, bb, uu, c.dtype, c.device)
    )(c, b, u)


def _vstep(params, factor_dtype, with_af: bool):
    """``(A, Af, data, states, regs) -> (states', stats)``: the unbatched
    step vmapped over the lanes (``Af`` is None without a precast copy)."""
    return torch.func.vmap(
        lambda a, af, d, st, rg: _single_step(a, d, st, rg, params, factor_dtype, af),
        in_dims=(0, 0 if with_af else None, 0, 0, 0),
    )


def _batched_start(A, data, reg0, params, factor_dtype):
    return torch.func.vmap(
        lambda a, d: _single_start(a, d, reg0, params, factor_dtype)
    )(A, data)


def _batched_norms(A, data, states, factor_dtype):
    """Final per-member (pinf, dinf, rel_gap, pobj)."""
    def final_norms(a, d, st):
        ops = dense._make_ops(a, 0.0, factor_dtype, 0)
        pinf, dinf, _, rel_gap, pobj, _, _ = core.residual_norms(ops, d, st)
        return pinf, dinf, rel_gap, pobj

    return torch.func.vmap(final_norms)(A, data, states)


def _guard(active, it, s):
    """Whether the loop runs another body: some lane active, under the
    phase's ``max_iter`` and this run's ``it_stop`` (device scalars)."""
    return active.any() & (it < s["max_iter"]) & (it < s["it_stop"])


def _batched_body(carry, s, step, params, stall_window, stall_status):
    """One masked batched iteration, ``carry ↦ carry'``: the JAX
    package's ``_batched_phase`` body, every update also masked by the
    loop guard so that a body past the exit changes nothing.

    ``carry = (states, active, it, regs, badcount, status, iters, best,
    since)``; ``it`` is phase-local, ``iters`` counts accepted steps per
    problem, ``best``/``since`` drive per-problem stall detection
    (``stall_window`` accepted steps without a 10% improvement of
    max(gap, pinf, dinf) deactivate a problem with ``stall_status``; in
    the final phase only while its best error is above 1e3·tol).
    ``step(states, regs)`` is the vmapped Mehrotra step."""
    states, active, it, regs, badcount, status, iters, best, since = carry
    go = _guard(active, it, s)
    new_states, stats = step(states, regs)
    bad = stats.bad
    conv = (
        (stats.rel_gap <= params.tol)
        & (stats.pinf <= params.tol)
        & (stats.dinf <= params.tol)
    )
    accept = active & ~bad
    # Freeze non-accepted problems component-wise.
    states1 = IPMState(*(
        torch.where(accept[:, None], n, o) for n, o in zip(new_states, states)
    ))
    iters1 = iters + accept.to(iters.dtype)
    # Per-problem regularization escalation on failed factorizations.
    regs1 = torch.where(active & bad, regs.clamp_min(1e-12) * s["reg_grow"], regs)
    badcount1 = torch.where(active & bad, badcount + 1, badcount)
    give_up = badcount1 > s["max_refactor"]
    newly_opt = accept & conv
    err = torch.maximum(stats.rel_gap, torch.maximum(stats.pinf, stats.dinf))
    improved = accept & (err < 0.9 * best)
    best1 = torch.where(improved, err, best)
    since1 = torch.where(active & ~bad, torch.where(improved, 0, since + 1), since)
    if stall_window:
        stalled = active & (since1 > stall_window)
        if stall_status == _STALL:
            # Final phase: near-tol plateaus deserve patience — only give
            # up while still far (>1e3·tol) from tolerance.
            stalled = stalled & (best1 > 1e3 * params.tol)
    else:
        stalled = torch.zeros_like(active)
    status1 = torch.where(newly_opt, _OPTIMAL, status)
    status1 = torch.where(active & give_up, _NUMERR, status1)
    status1 = torch.where(stalled & ~newly_opt & ~give_up, stall_status, status1)
    active1 = active & ~newly_opt & ~give_up & ~stalled
    new = (states1, active1, it + 1, regs1, badcount1, status1, iters1, best1, since1)
    leaves_new, rebuild = device_loop.flatten(new)
    leaves_old, _ = device_loop.flatten(carry)
    return rebuild([torch.where(go, n, o) for n, o in zip(leaves_new, leaves_old)])


def _batched_meta(carry):
    """``[it, settled, n_active, n_unfinished]`` in ``core.drive_segments``'
    meta layout: the batch-level "status" is the all-settled predicate,
    and the active and unfinished counts ride the best_err/since slots for
    the tail extraction's early stop."""
    _, active, it, _, _, status, _, best, _ = carry
    f = best.dtype
    settled = torch.where(active.any(), core.STATUS_RUNNING, core.STATUS_OPTIMAL)
    return torch.stack([
        it.to(f), settled.to(f), active.sum().to(f), (status != _OPTIMAL).sum().to(f),
    ])


def _batched_loop(A, Af, data, params, factor_dtype, stall_window, stall_status,
                  fuse_iters=1, **loop_kw):
    """One phase's masked batched loop at one program size, in a
    :class:`device_loop.DeviceLoop` (one captured graph on a card).

    ``fuse_iters`` = k puts k masked micro-steps into one body (one graph
    replay): each re-checks the guard on its own carry, so the results
    are the bits of k = 1, and at most k - 1 guarded no-op steps run where
    a body straddles the finish. ``loop_kw`` goes to the DeviceLoop."""
    step_v = _vstep(params, factor_dtype, Af is not None)

    def step(states, regs):
        return step_v(A, Af, data, states, regs)

    def body(carry, s):
        for _ in range(fuse_iters):
            carry = _batched_body(carry, s, step, params, stall_window, stall_status)
        return carry

    def cond(carry, s):
        return _guard(carry[1], carry[2], s)

    i32 = dict(dtype=torch.int32, device=A.device)
    inputs = {
        "max_iter": torch.zeros((), **i32), "it_stop": torch.zeros((), **i32),
        "max_refactor": torch.zeros((), **i32),
        "reg_grow": torch.zeros((), dtype=A.dtype, device=A.device),
    }
    return device_loop.DeviceLoop(body, cond, _batched_meta, inputs, **loop_kw)


def _run_loop(loop, carry, it_stop, cfg):
    """``(carry, meta)`` of one run of ``loop`` from ``carry`` up to the
    phase iteration ``it_stop``."""
    return loop.run(carry, max_iter=cfg.max_iter, it_stop=it_stop,
                    max_refactor=cfg.max_refactor, reg_grow=cfg.reg_grow)


def _cleanup_cap(B: int) -> int:
    """Max members the solo-cleanup pass will re-solve — ONE definition,
    shared by tail extraction's early stop (which promises every abandoned
    member a cleanup solve) and the cleanup gate itself."""
    return max(4, B // 8)


# Backend name the solo-cleanup pass re-solves through.
CLEANUP_BACKEND = "cuda"

# Member size (m·n entries) from which the JAX package's auto schedule
# considers the multi-phase (two-phase, PCG) batched loops on a TPU.
_PHASED_MEMBER_ENTRIES = 1 << 24


def _phase_plan(cfg: SolverConfig, member_entries: Optional[int] = None,
                platform: str = "cuda"):
    """(two_phase, use_pcg, n_phases) — the batched loop's phase schedule,
    the JAX package's rule, ONE definition shared by solve_batched and the
    cleanup-budget helper. ``two_phase_enabled`` is False on this
    package's platforms, so the plan is one f64 phase unless
    ``solve_mode="pcg"`` asks for PCG (which solve_batched refuses)."""
    phased_pays = (
        member_entries is not None and member_entries >= _PHASED_MEMBER_ENTRIES
    )
    two_phase = cfg.two_phase_enabled(platform) and phased_pays
    use_pcg = cfg.cg_iters > 0 and (
        cfg.solve_mode == "pcg" or (cfg.solve_mode is None and two_phase)
    )
    return two_phase, use_pcg, 1 + (1 if two_phase else 0) + (1 if use_pcg else 0)


def cleanup_solo_max_iter(config: Optional[SolverConfig] = None,
                          member_entries: Optional[int] = None,
                          typical_spent: int = 40) -> int:
    """The ``max_iter`` a typical solo-cleanup solve runs with (cleanup
    budget = n_phases·max_iter − iterations already spent in the batched
    loop, via the shared :func:`_phase_plan`)."""
    cfg = config or SolverConfig()
    _, _, n_phases = _phase_plan(cfg, member_entries=member_entries)
    return max(1, n_phases * cfg.max_iter - typical_spent)


def _fresh_batch_carry(states, iters, B, reg0, dtype, status=None):
    """Phase-boundary carry reset. With ``status=None`` every member
    (re-)enters the phase. Passing the previous phase's status keeps
    _OPTIMAL members SETTLED (inactive), everyone else re-enters
    _RUNNING."""
    dev = iters.device
    if status is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
        status = torch.full((B,), _RUNNING, dtype=torch.int32, device=dev)
    else:
        active = status != _OPTIMAL
        status = torch.where(status == _OPTIMAL, _OPTIMAL, _RUNNING).to(torch.int32)
    return (
        states,
        active,
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.full((B,), reg0, dtype=dtype, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
        status,
        iters,
        torch.full((B,), float("inf"), dtype=dtype, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
    )


def _cast_batch_carry(carry, dtype):
    """Cast the batched carry's floating leaves (state, regs, best) to
    ``dtype``; integer/bool lanes (active, counters, status) pass through
    untouched."""
    states, active, it, regs, badcount, status, iters, best, since = carry
    states = IPMState(*(v.to(dtype) for v in states))
    return (states, active, it, regs.to(dtype), badcount, status, iters,
            best.to(dtype), since)


_COMPACT_FLOOR = 32  # smallest compacted program size


def _compact_gather(carry, order, keep_idx, new_size, B):
    """Gather the ``keep_idx`` members of a batched carry into a
    ``new_size`` program (padding by repeating the first kept member,
    padded entries forced inactive/settled with sentinel scatter target
    ``B`` so they can never write back)."""
    states, active, it, regs, badcount, status, iters, best, since = carry
    dev = active.device
    k = len(keep_idx)
    pad = np.full(new_size - k, keep_idx[0] if k else 0, np.int64)
    sel = torch.as_tensor(np.concatenate([keep_idx, pad]), device=dev)
    valid = torch.arange(new_size, device=dev) < k
    g = lambda v: v.index_select(0, sel)
    carry2 = (
        IPMState(*(g(v) for v in states)),
        g(active) & valid,
        it,
        g(regs),
        g(badcount),
        torch.where(valid, g(status), _OPTIMAL),
        g(iters),
        g(best),
        g(since),
    )
    order2 = torch.where(valid, order.index_select(0, sel), B)
    return carry2, order2, sel


def _scatter_out(outs, order, carry):
    """Scatter a (possibly compacted) carry's per-member lanes into the
    full-size out buffers (one sentinel row at index B absorbs pads)."""
    states_out, status_out, iters_out = outs
    states, _, _, _, _, status, iters, _, _ = carry
    put = lambda o, v: o.index_put((order,), v)
    states_out = IPMState(*(put(o, v) for o, v in zip(states_out, states)))
    return states_out, put(status_out, status), put(iters_out, iters)


def _loop_totals(loops) -> dict:
    """The device loops' accounting summed over a phase's programs."""
    reps = [lp.report() for lp in loops]
    out = {k: sum(r[k] for r in reps)
           for k in ("runs", "bodies", "eager", "replays", "masked")}
    for k in ("eager_ms", "capture_ms", "replay_ms"):
        out[k] = sum(r[k] or 0.0 for r in reps)
    return out


def _solve_batched_whole(A, data, cfg, params, fdt, fuse_iters):
    """The whole-batch run (the JAX package's ``_solve_batched_jit``, one
    phase): the full-precision start, one masked loop to the end, the
    final norms."""
    B = A.shape[0]
    dtype = A.dtype
    Af = A.to(torch.float32) if fdt == torch.float32 else None
    states0 = _batched_start(A, data, cfg.reg_dual, params, fdt)
    carry = _fresh_batch_carry(
        states0, torch.zeros(B, dtype=torch.int32, device=A.device), B, cfg.reg_dual, dtype)
    w = cfg.stall_window
    t0 = time.perf_counter()
    loop = _batched_loop(A, Af, data, params, fdt, 2 * w if w else 0, _STALL, fuse_iters)
    try:
        carry, _ = _run_loop(loop, carry, cfg.max_iter, cfg)
        rows = [{"phase": 0, "mode": _mode_name(fdt), "iters": int(carry[2]),
                 "wall_s": round(time.perf_counter() - t0, 3), **_loop_totals([loop]),
                 "sizes": [B]}]
    finally:
        loop.close()
    states, status, iters = carry[0], carry[5], carry[6]
    status = torch.where(status == _RUNNING, _MAXITER, status)
    pinf, dinf, rel_gap, pobj = _batched_norms(A, data, states, fdt)
    return states, status, iters, pinf, dinf, rel_gap, pobj, rows


def _mode_name(fdt) -> str:
    return "float32" if fdt == torch.float32 else "float64"


def _solve_batched_segmented(A, data, cfg, params, fdt, seg, compact_ok=True,
                             fuse_iters=1):
    """Host-segmented batched solve (the JAX package's
    ``_solve_batched_segmented``, one phase): the loop runs in segments of
    ~``seg`` iterations with tail extraction, and, with ``compact_ok``,
    final-phase compaction — whenever the active-member count falls to
    half the program size, the still-active members are gathered into a
    half-size program (B → B/2 → … → 32), each size its own captured
    loop."""
    B = A.shape[0]
    dtype = A.dtype
    Af = A.to(torch.float32) if fdt == torch.float32 else None
    states0 = _batched_start(A, data, cfg.reg_dual, params, fdt)
    w = cfg.stall_window
    window = 2 * w if w else 0
    carry = _fresh_batch_carry(
        states0, torch.zeros(B, dtype=torch.int32, device=A.device), B, cfg.reg_dual, dtype)
    # Tail extraction: once ≤ tail problems are active, stop — the
    # leftover problems finish solo (solve_batched's cleanup), warm-started
    # from their batched iterates. tail = B//32 is 0 for small batches, and
    # the stop also requires the TOTAL unfinished count to fit the cleanup
    # bound, so an abandoned problem is never left without its solve.
    tail = B // 32
    cleanup_cap = _cleanup_cap(B)
    loops, sizes = [], []

    def mk_run_seg(Ax, dx, Afx):
        if loops:
            loops[-1].close()  # a size left behind keeps no graph
        loop = _batched_loop(Ax, Afx, dx, params, fdt, window, _STALL, fuse_iters)
        loops.append(loop)
        sizes.append(Ax.shape[0])
        return lambda c, stop: _run_loop(loop, c, stop, cfg)

    t_ph = time.perf_counter()
    try:
        if compact_ok and B >= 2 * _COMPACT_FLOOR:
            carry = _drive_compacting(mk_run_seg, carry, A, data, Af, cfg, seg, B, tail,
                                      cleanup_cap, dtype)
        else:
            carry, _ = core.drive_segments(
                mk_run_seg(A, data, Af), carry, cfg.max_iter, 0, seg,
                early_stop=(
                    (lambda it, status, n_active, n_unfinished:
                     0 < n_active <= tail and n_unfinished <= cleanup_cap)
                    if tail else None
                ),
            )
        rows = [{"phase": 0, "mode": _mode_name(fdt), "iters": int(carry[2]),
                 "wall_s": round(time.perf_counter() - t_ph, 3), **_loop_totals(loops),
                 "sizes": sizes}]
    finally:
        for loop in loops:
            loop.close()
    states, status, iters = carry[0], carry[5], carry[6]
    status = torch.where(status == _RUNNING, _MAXITER, status)
    pinf, dinf, rel_gap, pobj = _batched_norms(A, data, states, fdt)
    return states, status, iters, pinf, dinf, rel_gap, pobj, rows


def _drive_compacting(mk_run_seg, carry, A, data, Af, cfg, seg, B, tail, cleanup_cap,
                      dtype):
    """Final-phase segment drive with program compaction (see
    _solve_batched_segmented). Returns a FULL-SIZE carry whose states /
    status / iters lanes hold every member's final values (the only
    lanes the caller consumes after the final phase)."""
    dev = A.device
    states_out = IPMState(*(
        torch.zeros((B + 1,) + v.shape[1:], dtype=v.dtype, device=dev) for v in carry[0]
    ))
    status_out = torch.full((B + 1,), _OPTIMAL, dtype=torch.int32, device=dev)
    iters_out = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    order = torch.arange(B, device=dev)
    size = B
    out_nonopt = 0  # non-optimal members already scattered out
    it_g, status_g = 0, core.STATUS_RUNNING
    run_seg = mk_run_seg(A, data, Af)
    while True:
        def early(it, status, n_active, n_unfinished, _size=size, _out=out_nonopt):
            if (
                tail
                and 0 < n_active <= max(1, _size // 32)
                and n_unfinished + _out <= cleanup_cap
            ):
                return True
            return _size > _COMPACT_FLOOR and n_active <= _size // 2

        prev_it = it_g
        # Short segments (≤ 8 iterations) keep boundaries — the only
        # points compaction can act — frequent.
        carry, (it_g, status_g, n_act, n_unf) = core.drive_segments(
            run_seg, carry, cfg.max_iter, 0, min(seg, 8), target_s=4.0,
            early_stop=early, it0_status0=(it_g, status_g), seg_cap=8,
        )
        n_act, n_unf = int(n_act), int(n_unf)
        if (
            status_g != core.STATUS_RUNNING
            or it_g >= cfg.max_iter
            or n_act == 0
            or (
                tail
                and n_act <= max(1, size // 32)
                and n_unf + out_nonopt <= cleanup_cap
            )
            or size <= _COMPACT_FLOOR
            or it_g == prev_it  # spin guard: drive made no progress
        ):
            break
        # Shrink: gather actives into the smallest half-size that fits.
        act = carry[1].cpu().numpy()
        stat_host = carry[5].cpu().numpy()
        keep = np.flatnonzero(act)
        new_size = size // 2
        while new_size > _COMPACT_FLOOR and len(keep) <= new_size // 2:
            new_size //= 2
        if len(keep) > new_size:
            break  # defensive: actives cannot exceed the early trigger
        out_nonopt += int(np.sum(~act & (stat_host != _OPTIMAL)))
        states_out, status_out, iters_out = _scatter_out(
            (states_out, status_out, iters_out), order, carry
        )
        carry, order, sel = _compact_gather(carry, order, keep, new_size, B)
        A = A.index_select(0, sel)
        Af = Af.index_select(0, sel) if Af is not None else None
        data = core.ProblemData(*(v.index_select(0, sel) for v in data))
        size = new_size
        run_seg = mk_run_seg(A, data, Af)
    states_out, status_out, iters_out = _scatter_out(
        (states_out, status_out, iters_out), order, carry
    )
    states = IPMState(*(v[:B] for v in states_out))
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    return (
        states,
        torch.zeros(B, dtype=torch.bool, device=dev),
        carry[2],
        torch.full((B,), cfg.reg_dual, dtype=dtype, device=dev),
        zi,
        status_out[:B],
        iters_out[:B],
        torch.full((B,), float("inf"), dtype=dtype, device=dev),
        zi,
    )


# ---------------------------------------------------------------------------
# Bucket entry point (serve/): a pre-padded batch + active mask, one cached
# program per bucket key, reused verbatim across service dispatches.


def _warm_build_single(a, d, x, y, s, w, z, reg0, fdt):
    """Twin of ipm.warm.interior_candidate for ONE bucket slot (vmapped
    by :func:`_warm_select`): interior shift → primal projection onto the
    new b (one AAᵀ solve) → dual slack refresh on the new c →
    residual-aware centrality lift. Policy constants come from
    ipm/warm.py. Returns (candidate, merit, μ_w).

    The projection's solve is two triangular solves (``tri_solves``): the
    batched ``cholesky_solve`` allocates on every call (see
    ``dense._cholesky_ops``)."""
    from distributedlpsolver_tpu_torch.ipm import warm as warm_mod

    floor = warm_mod.INTERIOR_FLOOR
    ops = dense._make_ops(a, reg0, fdt, 0, tri_solves=True)
    xm = x.abs().mean().clamp_min(1.0)
    sm = s.abs().mean().clamp_min(1.0)
    x1 = torch.maximum(x, floor * xm)
    # Primal projection: x += Aᵀ(AAᵀ)⁻¹(b − Ax) lands the candidate on the
    # new feasible affine (the clip after re-opens a floor-sized residual
    # at worst). A degenerate factorization NaNs the merit and the slot
    # falls back to cold — the safeguard's job.
    fac = ops.factorize(torch.ones_like(x))
    x1 = x1 + ops.rmatvec(ops.solve(fac, d.b - ops.matvec(x1)))
    x1 = torch.maximum(x1, floor * xm)
    hub, u_f = d.hub, d.u_f
    x1 = torch.where(hub > 0, torch.minimum(torch.maximum(x1, 0.01 * u_f), 0.99 * u_f), x1)
    w1 = torch.where(hub > 0, u_f - x1, torch.ones_like(w))
    # Dual refresh: s − z = c − Aᵀy exactly wherever the positive split
    # allows, a floor-shift on both parts elsewhere.
    s_hat = d.c - ops.rmatvec(y)
    z1 = torch.where(hub > 0, torch.maximum(z, floor * sm), torch.zeros_like(z))
    s1 = torch.where(hub > 0, s_hat + z1, torch.maximum(s_hat, floor * sm))
    deficit = torch.where(hub > 0, (floor * sm - s1).clamp_min(0.0), torch.zeros_like(s1))
    s1 = s1 + deficit
    z1 = z1 + deficit
    mu_w = (x1 @ s1 + (hub * w1) @ z1) / d.ncomp
    pinf, dinf, *_ = core.residual_norms(ops, d, IPMState(x=x1, y=y, s=s1, w=w1, z=z1))
    merit = torch.maximum(pinf, dinf)
    # Residual-aware centrality lift (MERIT_MU_FLOOR): raise the SMALLER
    # factor of any pair whose product trails the recentre target.
    pobj = d.c @ x1
    target = torch.maximum(
        warm_mod.CENTRALITY_BETA * mu_w,
        warm_mod.MERIT_MU_FLOOR * merit * (1.0 + pobj.abs()) / d.ncomp,
    )
    lift = torch.sqrt(torch.clamp(target / (x1 * s1).clamp_min(1e-30), 1.0, 1e16))
    x2 = torch.where(x1 <= s1, x1 * lift, x1)
    s2 = torch.where(s1 < x1, s1 * lift, s1)
    liftw = torch.sqrt(torch.clamp(target / (w1 * z1).clamp_min(1e-30), 1.0, 1e16))
    w2 = torch.where((hub > 0) & (w1 <= z1), w1 * liftw, w1)
    z2 = torch.where((hub > 0) & (z1 < w1), z1 * liftw, z1)
    return IPMState(x=x2, y=y, s=s2, w=w2, z=z2), merit, mu_w


def _warm_select(A, data, states_cold, warm_raw, warm_mask, fdt, reg0):
    """Per-slot safeguarded warm-start selection: candidates built by
    :func:`_warm_build_single`, each compared against the cold start's
    initial residual merit AND complementarity; a slot takes the warm
    iterate only where the mask requests it and both guards accept. Runs
    on every dispatch (zero warm lanes and an all-false mask on a cold
    one), so one program serves any warm/cold mix. Returns (states0,
    warm_used)."""
    from distributedlpsolver_tpu_torch.ipm import warm as warm_mod

    cand, merit_w, mu_w = torch.func.vmap(
        lambda a, d, x, y, s, w, z: _warm_build_single(a, d, x, y, s, w, z, reg0, fdt)
    )(A, data, *warm_raw)

    def cold_stats(a, d, st):
        ops = dense._make_ops(a, 0.0, fdt, 0)
        pinf, dinf, _, _, _, _, mu = core.residual_norms(ops, d, st)
        return torch.maximum(pinf, dinf), mu

    merit_c, mu_c = torch.func.vmap(cold_stats)(A, data, states_cold)
    tiny = 1e-12
    ok = (
        warm_mask
        & torch.isfinite(merit_w)
        & torch.isfinite(mu_w)
        & (merit_w <= warm_mod.WARM_ACCEPT_FACTOR * merit_c.clamp_min(tiny))
        & (mu_w <= warm_mod.MU_ACCEPT_FACTOR * mu_c.clamp_min(tiny))
    )
    B = A.shape[0]
    pick = lambda wv, cv: torch.where(ok.reshape((B,) + (1,) * (wv.ndim - 1)), wv, cv)
    return IPMState(*(pick(wv, cv) for wv, cv in zip(cand, states_cold))), ok


def _bucket_phase_carry(states, iters, B, reg0, dtype, active0, status=None):
    """Bucket phase-entry carry: :func:`_fresh_batch_carry` with the
    padding mask re-applied — padding slots are inactive and report a
    placeholder _OPTIMAL (the all-settled loop predicate and the demux
    treat them as finished; serve/service.py demuxes by slot index, so a
    padding verdict is never read)."""
    c = _fresh_batch_carry(states, iters, B, reg0, dtype, status=status)
    states, active, it, regs, bad, st, iters, best, since = c
    return (states, active & active0, it, regs, bad,
            torch.where(active0, st, _OPTIMAL).to(torch.int32), iters, best, since)


def _bucket_schedule(cfg: SolverConfig, platform: str):
    """``(phase tiers, fused iterations)`` of a bucket program, refusing
    what is not ported: the df32 ladder (``ops/df32.py``, Queue 2) and
    more than one iteration a body (item 5b)."""
    tiers = cfg.bucket_phases(cfg.tol, platform)
    if tiers != (("f64", cfg.tol),):
        raise NotImplementedError(
            f"bucket schedule {tiers}: the df32 precision ladder is not ported to the "
            "torch package yet (ROADMAP Queue 2, ops/df32.py)"
        )
    fuse = cfg.fused_iters_resolved(platform)
    if fuse != 1:
        raise NotImplementedError(
            f"fused_iters={fuse}: more than one iteration per bucket body is not ported "
            "to the torch package yet (ROADMAP Queue 1 item 5b)"
        )
    return tiers, fuse


class _BucketProgram:
    """One cached bucket program — the counterpart of one compiled
    ``_solve_bucket_jit`` executable of the JAX package.

    It owns static device buffers for the bucket's A, b, c, ``active``, the
    five warm lanes and the warm mask, the problem data derived from b
    and c, and the :class:`DeviceLoop` of the masked batched loop over
    them. A dispatch ``copy_``s its bucket into the buffers, runs the
    start (at the phase's params), the warm selection and the loop, and
    reads the final norms; on a card the loop is ONE CUDA graph, captured
    at the program's first dispatch (even a one-iteration warm-up; the
    capture is thread-local, so the serve pack thread may use the card
    meanwhile), and only replayed after. ``max_iter``,
    ``max_refactor`` and ``reg_grow`` are device scalars of the loop's
    inputs and ``reg0`` enters the (eager) start and carry, so a
    per-request budget is a fill, never a new graph."""

    def __init__(self, B, m, n, dtype, fdt, params, stall_window, fuse, device):
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        self.fdt, self.params, self.B = fdt, params, B
        self.A, self.b, self.c = zeros(B, m, n), zeros(B, m), zeros(B, n)
        self.active = torch.zeros(B, dtype=torch.bool, device=device)
        self.warm = IPMState(x=zeros(B, n), y=zeros(B, m), s=zeros(B, n), w=zeros(B, n),
                             z=zeros(B, n))
        self.warm_mask = torch.zeros(B, dtype=torch.bool, device=device)
        with _no_vmap_fallback():
            self.data = _batched_data(self.c, self.b)
        self.loop = _batched_loop(
            self.A, None, self.data, params, fdt, 2 * stall_window if stall_window else 0,
            _STALL, fuse, capture_on_exit=True,
        )
        self.lock = threading.Lock()

    def input_bytes(self) -> int:
        bufs = [self.A, self.b, self.c, self.active, self.warm_mask, *self.warm, *self.data]
        return sum(t.numel() * t.element_size() for t in bufs)

    def fill(self, A, b, c, active, warm, warm_mask) -> None:
        """Copy one bucket into the static buffers and refresh the data."""
        for dst, src in ((self.A, A), (self.b, b), (self.c, c), (self.active, active),
                         (self.warm_mask, warm_mask), *zip(self.warm, warm)):
            if dst is not src:
                dst.copy_(src)
        for dst, src in zip(self.data, _batched_data(self.c, self.b)):
            dst.copy_(src)

    def run(self, cfg: SolverConfig, seg: int):
        """Start, warm selection, the masked loop (whole, or in host
        segments of ~``seg`` iterations) and the final norms, on the
        filled buffers. Returns the host-side fields, the loop's
        iterations and its accounting for this dispatch (``launches``:
        K1 launches, one for the start, one for the warm selection's
        projection and one per body)."""
        B, dtype = self.B, self.A.dtype
        reg0 = cfg.reg_dual
        launches0 = kernel_build.thread_launches(normal_eq)
        states0 = _batched_start(self.A, self.data, reg0, self.params, self.fdt)
        states0, warm_used = _warm_select(
            self.A, self.data, states0, tuple(self.warm), self.warm_mask, self.fdt, reg0)
        carry = _bucket_phase_carry(
            states0, torch.zeros(B, dtype=torch.int32, device=self.A.device), B, reg0, dtype,
            self.active)
        before = self.loop.report()
        run_seg = lambda c, stop: _run_loop(self.loop, c, stop, cfg)
        if seg:
            carry, (it, _, _, _) = core.drive_segments(run_seg, carry, cfg.max_iter, 0, seg)
        else:
            carry, meta = run_seg(carry, cfg.max_iter)
            it = int(meta[0])
        after = self.loop.report()
        acc = {k: after[k] - before[k]
               for k in ("runs", "captures", "bodies", "eager", "replays", "masked")}
        for k in ("eager_ms", "replay_ms"):
            acc[k] = after[k] - before[k]
        acc["capture_ms"] = after["capture_ms"] if acc["captures"] else 0.0
        states, status, iters = carry[0], carry[5], carry[6]
        status = torch.where(status == _RUNNING, _MAXITER, status)
        pinf, dinf, rel_gap, pobj = _batched_norms(self.A, self.data, states, self.fdt)
        acc["launches"] = kernel_build.thread_launches(normal_eq) - launches0
        to_np = lambda v: v.detach().to(torch.float64).cpu().numpy()
        host = {
            "status": status.cpu().numpy(), "iterations": iters.cpu().numpy(),
            "objective": to_np(pobj), "rel_gap": to_np(rel_gap), "pinf": to_np(pinf),
            "dinf": to_np(dinf), "warm_used": warm_used.cpu().numpy(),
            **{f: to_np(v) for f, v in zip(IPMState._fields, states)},
        }
        return host, int(it), acc


# Bucket programs of this process, by key (B, m, n, dtype, factor dtype,
# step params, stall window, fused iterations, device).
_PROGRAMS: dict = {}
_PROGRAMS_LOCK = threading.Lock()


def _program(key, make) -> tuple:
    """(program, built) for ``key``; ``make()`` builds a missing one."""
    with _PROGRAMS_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is not None:
            return prog, False
        prog = _PROGRAMS[key] = make()
        return prog, True


def bucket_cache_size() -> int:
    """Number of bucket programs in this process, the PDHG engine's
    included (``first_order.pdhg_bucket_cache_size``) — the serve layer's
    recompile telemetry, and the warm-bucket assertion in tests (repeat
    dispatches to a warm bucket must not grow it). On a card each program
    holds one captured CUDA graph of its loop (see
    :func:`bucket_capture_count`); on the CPU its loop runs eagerly."""
    from distributedlpsolver_tpu_torch.backends.first_order import pdhg_bucket_cache_size

    with _PROGRAMS_LOCK:
        n = len(_PROGRAMS)
    return n + pdhg_bucket_cache_size()


def bucket_capture_count() -> int:
    """CUDA-graph captures the bucket programs (IPM and PDHG) made so far
    (one each on a card; a capture on a warm program would show here)."""
    from distributedlpsolver_tpu_torch.backends.first_order import pdhg_bucket_capture_count

    with _PROGRAMS_LOCK:
        n = sum(p.loop.captures for p in _PROGRAMS.values())
    return n + pdhg_bucket_capture_count()


def release_bucket_programs() -> None:
    """Close every bucket program (IPM and PDHG) and drop it from the
    cache (its graph and buffers are freed once no dispatch holds it)."""
    from distributedlpsolver_tpu_torch.backends.first_order import release_pdhg_bucket_programs

    release_pdhg_bucket_programs()
    with _PROGRAMS_LOCK:
        progs = list(_PROGRAMS.values())
        _PROGRAMS.clear()
    for p in progs:
        with p.lock:
            p.loop.close()


def bucket_donation_report(m: int, n: int, batch: int, config: Optional[SolverConfig] = None,
                           device=None):
    """Build a bucket program at the given shape outside the cache,
    capture its graph with a one-iteration dispatch, and return its
    memory figures: ``alias_bytes``, the carry the graph updates in place
    across replays and segments (the counterpart of the JAX package's
    donated carry); ``argument_bytes``, the program's static input
    buffers; ``temp_bytes``, the device memory the capture reserved for
    the graph's private pool. None on the CPU, where no graph exists."""
    from distributedlpsolver_tpu_torch.models.generators import random_batched_lp

    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    cfg = (config or SolverConfig()).replace(max_iter=1)
    dtype = dense._torch_dtype(cfg.dtype)
    _bucket_schedule(cfg, dev.type)
    prog = _BucketProgram(batch, m, n, dtype, dense._torch_dtype(cfg.factor_dtype_resolved()),
                          cfg.bucket_phase_params("f64", cfg.tol), cfg.stall_window, 1, dev)
    placed, act = place_bucket(random_batched_lp(batch, m, n, seed=0), np.ones(batch, bool),
                               cfg, device=dev)
    warm, wm = place_warm(None, None, (batch, m, n), cfg, device=dev)
    try:
        with _no_vmap_fallback():
            prog.fill(placed.A, placed.b, placed.c, act, warm, wm)
            prog.run(cfg, 0)
        return {
            "alias_bytes": prog.loop.carry_bytes,
            "argument_bytes": prog.input_bytes(),
            "output_bytes": None,
            "temp_bytes": prog.loop.pool_bytes,
        }
    finally:
        prog.loop.close()


def _host_tensor(v, dev: torch.device) -> torch.Tensor:
    """A host array as a CPU tensor, in pinned memory when it goes to a
    card (so the copy is asynchronous)."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
    if dev.type == "cuda" and not t.is_pinned():
        t = t.pin_memory()
    return t


def place_bucket(batch: BatchedLP, active, config: Optional[SolverConfig] = None, mesh=None,
                 device=None):
    """Host→device transfer of a pre-padded bucket — the PACK stage of the
    serving pipeline. Casts to the solve dtype and copies to the device
    asynchronously from pinned memory on the current stream (the service
    runs it on its pack stream). ``solve_bucket`` accepts the returned
    (batch, active) verbatim.

    With ``mesh`` (the batch axis split over it) each field is a tuple of
    this process's lane blocks, one per executor, each on its executor's
    device (a rank of a world places only its own block); ``device`` is
    then the mesh's."""
    cfg = config or SolverConfig()
    dtype = dense._torch_dtype(cfg.dtype)
    act = np.asarray(active, dtype=bool) if not isinstance(active, torch.Tensor) else active
    Bsz = np.asarray(batch.A).shape[0] if not isinstance(batch.A, torch.Tensor) else batch.A.shape[0]
    if tuple(act.shape) != (Bsz,):
        raise ValueError(f"active mask shape {tuple(act.shape)} != ({Bsz},)")
    if mesh is not None:
        blocks = mesh.lane_blocks(Bsz)
        put = lambda v, dt, d, lo, hi: _host_tensor(v[lo:hi], d).to(
            device=d, dtype=dt, non_blocking=True)
        fields = {f: tuple(put(getattr(batch, f), dtype, d, lo, hi) for d, lo, hi in blocks)
                  for f in ("c", "A", "b")}
        return (BatchedLP(name=batch.name, **fields),
                tuple(put(act, torch.bool, d, lo, hi) for d, lo, hi in blocks))
    dev = resolve_device(device)
    put = lambda v, dt: _host_tensor(v, dev).to(device=dev, dtype=dt, non_blocking=True)
    placed = BatchedLP(c=put(batch.c, dtype), A=put(batch.A, dtype), b=put(batch.b, dtype),
                       name=batch.name)
    return placed, put(act, torch.bool)


def place_warm(warm: Optional[IPMState], warm_mask, shape, config: Optional[SolverConfig] = None,
               mesh=None, device=None):
    """Host→device transfer of a bucket's warm-start lanes — the warm half
    of :func:`place_bucket`. ``warm`` is an IPMState of (B, n)/(B, m) host
    arrays (None = cold dispatch: zeros), ``warm_mask`` the (B,)
    offered-slots mask; ``shape`` is the bucket's (B, m, n). With ``mesh``
    each lane field is a tuple of this process's blocks, as
    :func:`place_bucket` places them."""
    cfg = config or SolverConfig()
    dtype = dense._torch_dtype(cfg.dtype)
    B, m, n = shape
    if warm is None:
        lanes = [np.zeros((B, k)) for k in (n, m, n, n, n)]
        wm = np.zeros(B, dtype=bool)
    else:
        lanes = list(warm)
        wm = np.asarray(warm_mask, dtype=bool)
    if wm.shape != (B,):
        raise ValueError(f"warm mask shape {wm.shape} != ({B},)")
    if mesh is not None:
        blocks = mesh.lane_blocks(B)
        put = lambda v, dt: tuple(_host_tensor(v[lo:hi], d).to(device=d, dtype=dt, non_blocking=True)
                                  for d, lo, hi in blocks)
        return IPMState(*(put(v, dtype) for v in lanes)), put(wm, torch.bool)
    dev = resolve_device(device)
    put = lambda v, dt: _host_tensor(v, dev).to(device=dev, dtype=dt, non_blocking=True)
    return IPMState(*(put(v, dtype) for v in lanes)), put(wm, torch.bool)


_CODE_MAP = {
    _OPTIMAL: Status.OPTIMAL,
    _MAXITER: Status.ITERATION_LIMIT,
    _NUMERR: Status.NUMERICAL_ERROR,
    _STALL: Status.STALLED,
}
_STATUS_CODE = {v: k for k, v in _CODE_MAP.items()}


def _bucket_block(A, b, c, act, warm_states, wm, cfg, dev, mesh_key=None):
    """One executor's dispatch of a bucket (or of its lane block over a
    mesh) through the cached program of its key: (host fields, loop
    iterations, accounting, built)."""
    dtype = dense._torch_dtype(cfg.dtype)
    fdt = dense._torch_dtype(cfg.factor_dtype_resolved())
    tiers, fuse = _bucket_schedule(cfg, dev.type)
    params = cfg.bucket_phase_params(*tiers[-1])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f64/f32 library matmuls exact
    Bsz, m, n = A.shape
    key = (Bsz, m, n, dtype, fdt, params, cfg.stall_window, fuse, dev, mesh_key)
    prog, built = _program(key, lambda: _BucketProgram(
        Bsz, m, n, dtype, fdt, params, cfg.stall_window, fuse, dev))
    seg = (cfg.segment_iters or 8) if core.use_segments(cfg.segment_iters, dev.type) else 0
    with prog.lock, _no_vmap_fallback():
        prog.fill(A, b, c, act, warm_states, wm)
        host, it, acc = prog.run(cfg, seg)
    acc["captured"] = prog.loop.captures > 0
    if built:
        obs_metrics.get_registry().counter(
            "bucket_programs_compiled_total",
            help="batched bucket programs built in this process",
        ).inc()
    return host, it, acc, built


def _gather_lanes(mesh, B: int, blocks, parts: list, stats: list) -> tuple:
    """Whole-bucket host fields from this process's lane blocks, and the
    per-executor ``stats`` rows of every executor. A local mesh holds
    every block; a world gathers with ONE all-reduce of a zero-filled
    buffer (every rank writes its own lanes and its stats row; a sum
    with zeros keeps the bits)."""
    names = list(parts[0])
    if mesh.is_local:
        return ({f: np.concatenate([p[f] for p in parts]) for f in names},
                np.asarray(stats, dtype=np.float64))
    (_, lo, hi), part = blocks[0], parts[0]
    widths = [int(np.prod(part[f].shape[1:], dtype=np.int64)) for f in names]
    W, S = sum(widths), len(stats[0])
    buf = np.zeros(B * W + mesh.size * S)
    lanes = buf[:B * W].reshape(B, W)
    off = 0
    for f, w in zip(names, widths):
        lanes[lo:hi, off:off + w] = part[f].reshape(hi - lo, w)
        off += w
    buf[B * W + mesh.rank * S:B * W + (mesh.rank + 1) * S] = stats[0]
    t = mesh.all_reduce(torch.from_numpy(buf).to(mesh.collective_device))
    out = t.cpu().numpy()
    lanes = out[:B * W].reshape(B, W)
    host, off = {}, 0
    for f, w in zip(names, widths):
        host[f] = lanes[:, off:off + w].reshape((B,) + part[f].shape[1:]).astype(part[f].dtype)
        off += w
    return host, out[B * W:].reshape(mesh.size, S)


def _solve_bucket_mesh(batch, active, cfg, mesh, warm, warm_mask) -> BatchedResult:
    """:func:`solve_bucket` over ``mesh`` (see the module note)."""
    t0 = time.perf_counter()
    if isinstance(batch.A, tuple):  # placed by place_bucket(mesh=): this process's blocks
        Bsz = batch.A[0].shape[0] * mesh.size
        blocks = mesh.lane_blocks(Bsz)
        A, b, c = batch.A, batch.b, batch.c
        act = active if isinstance(active, tuple) else tuple(
            torch.as_tensor(np.asarray(active, dtype=bool)[lo:hi], device=d) for d, lo, hi in blocks)
    else:
        Bsz = np.asarray(batch.A).shape[0]
        placed, act = place_bucket(batch, active, cfg, mesh=mesh)
        blocks = mesh.lane_blocks(Bsz)
        A, b, c = placed.A, placed.b, placed.c
    m, n = A[0].shape[1:]
    if warm is not None and isinstance(warm.x, tuple):
        warm_states = warm
        wm = warm_mask if isinstance(warm_mask, tuple) else tuple(
            torch.as_tensor(np.asarray(warm_mask, dtype=bool)[lo:hi], device=d)
            for d, lo, hi in blocks)
    else:
        warm_states, wm = place_warm(warm, warm_mask, (Bsz, m, n), cfg, mesh=mesh)
    setup_time = time.perf_counter() - t0

    t1 = time.perf_counter()
    parts, stats, built = [], [], False
    tiers = _bucket_schedule(cfg, blocks[0][0].type)[0]
    for i, (dev, lo, hi) in enumerate(blocks):
        host, it, acc, blt = _bucket_block(
            A[i], b[i], c[i], act[i], IPMState(*(w[i] for w in warm_states)), wm[i], cfg, dev,
            mesh.key)
        built |= blt
        parts.append(host)
        stats.append([it, acc["bodies"], acc["launches"], acc["captures"], float(acc["captured"])])
    t_g = time.perf_counter()
    host, per_exec = _gather_lanes(mesh, Bsz, blocks, parts, stats)
    gather_ms = 1e3 * (time.perf_counter() - t_g)
    solve_time = time.perf_counter() - t1
    # ``bodies`` is the slowest executor's (the dispatch's wall);
    # launches and captures are this process's executors'.
    row = {"phase": 0, "engine": tiers[0][0], "tol": tiers[0][1],
           "iters": int(per_exec[:, 0].max()), "built": built,
           "bodies": int(per_exec[:, 1].max()), "launches": int(sum(s[2] for s in stats)),
           "captures": int(sum(s[3] for s in stats)), "captured": all(s[4] for s in stats),
           "executors": int(per_exec.shape[0]), "mesh_devices": mesh.size,
           "executor_bodies": [int(v) for v in per_exec[:, 1]],
           "executor_launches": [int(v) for v in per_exec[:, 2]], "gather_ms": gather_ms}
    return _bucket_result(host, solve_time, setup_time, row, 1)


def _bucket_result(host, solve_time, setup_time, row, fuse) -> BatchedResult:
    return BatchedResult(
        status=np.array([_CODE_MAP[int(sc)] for sc in host["status"]], dtype=object),
        objective=host["objective"],
        x=host["x"],
        iterations=host["iterations"],
        rel_gap=host["rel_gap"],
        pinf=host["pinf"],
        dinf=host["dinf"],
        solve_time=solve_time,
        setup_time=setup_time,
        phase_report=[row],
        fused_iters=fuse,
        y=host["y"],
        s=host["s"],
        w=host["w"],
        z=host["z"],
        warm_used=host["warm_used"],
    )


def solve_bucket(
    batch: BatchedLP,
    active,
    config: Optional[SolverConfig] = None,
    mesh=None,
    warm: Optional[IPMState] = None,
    warm_mask=None,
    device=None,
    **config_overrides,
) -> BatchedResult:
    """Solve one pre-padded serving bucket: ``batch`` is (B, m, n) arrays
    already padded to the bucket shape (serve/buckets.py), ``active`` a
    (B,) bool mask — False slots are padding and are frozen from the
    first iteration (their returned status is a placeholder OPTIMAL and
    their iterations 0; demux by slot and ignore them). Runs on the first
    CUDA card unless ``device`` names another (``"cpu"``).

    No chunking and no solo cleanup: the service owns the retry budget of
    unfinished members. Each (B, m, n, dtype, tol, schedule, device,
    mesh) key has ONE cached program (:class:`_BucketProgram`) reused by
    every dispatch: on a card its loop is captured once and only replayed
    after (:func:`bucket_cache_size`, :func:`bucket_capture_count`). The
    drive is host-segmented when ``segment_iters > 0``
    (``core.use_segments``), with the same results.

    ``warm``/``warm_mask`` offer per-slot warm-start iterates (see
    :func:`place_warm`): offered slots start from the refreshed prior
    iterate when the safeguard accepts it; ``BatchedResult.warm_used``
    reports the per-slot outcome. Inputs already placed by
    :func:`place_bucket`/:func:`place_warm` are used as they are.

    ``mesh`` splits the batch axis over its executors (B must divide by
    the mesh size; see the module note): each runs its block through its
    own program, and the result is the whole bucket's on every rank.
    ``phase_report[0]`` then adds ``executors``, ``executor_bodies``,
    ``executor_launches`` and ``gather_ms`` (the host clock around the
    gather); its ``bodies`` is the slowest executor's and its
    ``launches`` this process's.
    """
    cfg = config or SolverConfig()
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    if mesh is not None:
        return _solve_bucket_mesh(batch, active, cfg, mesh, warm, warm_mask)
    dev = resolve_device(device)
    dtype = dense._torch_dtype(cfg.dtype)
    tiers, fuse = _bucket_schedule(cfg, dev.type)

    t0 = time.perf_counter()
    placed_in = lambda v: isinstance(v, torch.Tensor) and v.device == dev and v.dtype == dtype
    if placed_in(batch.A):
        A, b, c = batch.A, batch.b, batch.c
        act = active if isinstance(active, torch.Tensor) else torch.as_tensor(
            np.asarray(active, dtype=bool), device=dev)
    else:
        placed, act = place_bucket(batch, active, cfg, device=dev)
        A, b, c = placed.A, placed.b, placed.c
    Bsz, m, n = A.shape
    if warm is not None and placed_in(warm.x):
        warm_states = warm
        wm = warm_mask if isinstance(warm_mask, torch.Tensor) else torch.as_tensor(
            np.asarray(warm_mask, dtype=bool), device=dev)
    else:
        warm_states, wm = place_warm(warm, warm_mask, (Bsz, m, n), cfg, device=dev)
    setup_time = time.perf_counter() - t0

    t1 = time.perf_counter()
    host, it, acc, built = _bucket_block(A, b, c, act, warm_states, wm, cfg, dev)
    solve_time = time.perf_counter() - t1
    row = {"phase": 0, "engine": tiers[0][0], "tol": tiers[0][1], "iters": it, "built": built, **acc}
    return _bucket_result(host, solve_time, setup_time, row, fuse)


def member_interior_form(batch: BatchedLP, i: int):
    """One batch member as a standalone InteriorForm — the solo-cleanup
    path's input."""
    from distributedlpsolver_tpu_torch.interop import interior_form_from_arrays

    n = np.asarray(batch.A).shape[2]
    return interior_form_from_arrays(
        batch.A[i], batch.b[i], batch.c[i], np.full(n, np.inf), name=f"{batch.name}[{i}]",
    )


def _concat_results(parts, solve_time, setup_time) -> BatchedResult:
    cat = lambda f: np.concatenate([getattr(p, f) for p in parts])
    first = np.cumsum([0] + [len(p.status) for p in parts])  # each chunk's first member
    return BatchedResult(
        status=cat("status"),
        objective=cat("objective"),
        x=cat("x"),
        iterations=cat("iterations"),
        rel_gap=cat("rel_gap"),
        pinf=cat("pinf"),
        dinf=cat("dinf"),
        solve_time=solve_time,
        setup_time=setup_time,
        # Flat rows with a chunk tag — same shape chunked or not; a
        # cleanup row's member is its index in the whole batch.
        phase_report=[
            {**ph, "chunk": ci,
             **({"member": int(first[ci]) + ph["member"]} if "member" in ph else {})}
            for ci, p in enumerate(parts)
            for ph in (p.phase_report or [])
        ],
        fused_iters=parts[0].fused_iters if parts else 1,
    )


def _solve_batched_mesh(batch, cfg, mesh, chunk) -> BatchedResult:
    """:func:`solve_batched` over ``mesh``: each executor's block through
    :func:`solve_batched` on its device, then one gather."""
    k = mesh.size
    if chunk and chunk % k:
        raise ValueError(f"chunk {chunk} not divisible by mesh axis {k}")
    B = np.asarray(batch.A).shape[0]
    blocks = mesh.lane_blocks(B)
    t0 = time.perf_counter()
    parts = [
        solve_batched(BatchedLP(c=batch.c[lo:hi], A=batch.A[lo:hi], b=batch.b[lo:hi],
                                name=f"{batch.name}[{lo}:{hi}]"),
                      cfg, device=d, chunk=chunk // k if chunk else chunk)
        for d, lo, hi in blocks
    ]
    fields = ("objective", "x", "iterations", "rel_gap", "pinf", "dinf")
    hosts = [{"status": np.array([_STATUS_CODE[st] for st in p.status], dtype=np.int32),
              **{f: getattr(p, f) for f in fields}} for p in parts]
    host, per_exec = _gather_lanes(mesh, B, blocks, hosts, [[p.solve_time] for p in parts])
    first = [lo for _, lo, _ in blocks]
    executor = (lambda i: i) if mesh.is_local else (lambda i: mesh.rank)
    return BatchedResult(
        status=np.array([_CODE_MAP[int(c)] for c in host["status"]], dtype=object),
        **{f: host[f] for f in fields},
        solve_time=float(per_exec[:, 0].max()),
        setup_time=max(time.perf_counter() - t0 - float(per_exec[:, 0].max()), 0.0),
        phase_report=[{**ph, "executor": executor(i),
                       **({"member": first[i] + ph["member"]} if "member" in ph else {})}
                      for i, p in enumerate(parts) for ph in (p.phase_report or [])],
        fused_iters=parts[0].fused_iters,
    )


def solve_batched(
    batch: BatchedLP,
    config: Optional[SolverConfig] = None,
    device=None,
    chunk: Optional[int] = None,
    mesh=None,
    **config_overrides,
) -> BatchedResult:
    """Solve every problem in ``batch`` concurrently on one device: the
    first CUDA card unless ``device`` names another (``"cpu"`` for the
    CPU); without a card it raises.

    ``chunk`` bounds how many problems one device loop holds; chunks run
    one after another (default: no chunking — the JAX package chunks only
    on a TPU). ``mesh`` splits the batch axis over the mesh's executors
    (the batch, and ``chunk``, must divide by its size; each executor
    solves its block, in chunks of ``chunk`` / size, and the results are
    gathered as :func:`solve_bucket`'s; ``phase_report`` rows carry their
    ``executor``, a world's rank its own).
    """
    cfg = config or SolverConfig()
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    if mesh is not None:
        return _solve_batched_mesh(batch, cfg, mesh, chunk)
    dev = resolve_device(device)
    dtype = dense._torch_dtype(cfg.dtype)
    fdt = dense._torch_dtype(cfg.factor_dtype_resolved())

    B_total = np.asarray(batch.A).shape[0]
    if chunk and B_total > chunk:
        t0 = time.perf_counter()
        parts = [
            # Each chunk solves on this device alone (no mesh, no collective).
            # graftcheck: disable=spmd-divergent-collective (local chunk)
            solve_batched(
                BatchedLP(
                    c=batch.c[i : i + chunk],
                    A=batch.A[i : i + chunk],
                    b=batch.b[i : i + chunk],
                    name=f"{batch.name}[{i}:{i + chunk}]",
                ),
                cfg,
                device=dev,
                chunk=0,  # no further splitting
            )
            for i in range(0, B_total, chunk)
        ]
        wall = time.perf_counter() - t0
        solve_time = sum(p.solve_time for p in parts)
        return _concat_results(
            parts,
            solve_time=solve_time,
            setup_time=max(wall - solve_time, 0.0),  # wall minus solve, no double count
        )

    t0 = time.perf_counter()
    Bsz, m, n = np.asarray(batch.A).shape
    two_phase, use_pcg, n_phases = _phase_plan(cfg, member_entries=m * n, platform=dev.type)
    if two_phase or use_pcg:
        raise NotImplementedError(
            "the two-phase and PCG batched schedules are not ported to the torch package yet "
            "(ROADMAP Queue 1 item 5b)"
        )
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 library matmuls in true fp32
    host = lambda v: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float64))
    A = host(batch.A).to(device=dev, dtype=dtype)
    b = host(batch.b).to(device=dev, dtype=dtype)
    c = host(batch.c).to(device=dev, dtype=dtype)
    params = cfg.step_params()
    with _no_vmap_fallback():
        data = _batched_data(c, b)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_time = time.perf_counter() - t0

    t1 = time.perf_counter()
    fuse = cfg.fused_iters_resolved(dev.type)
    seg = cfg.segment_iters or 0  # None = auto: unsegmented off TPU
    with _no_vmap_fallback():
        if seg:
            run = _solve_batched_segmented(A, data, cfg, params, fdt, seg, fuse_iters=fuse)
        else:
            run = _solve_batched_whole(A, data, cfg, params, fdt, fuse)
    states, status, iters, pinf, dinf, rel_gap, pobj, phase_report = run
    phase_report = [{**ph, "chunk": 0} for ph in phase_report]

    status_arr = np.array(
        [_CODE_MAP[int(sc)] for sc in status.cpu().numpy()], dtype=object
    )
    to_np = lambda v: v.detach().to(torch.float64).cpu().numpy()
    objective = to_np(pobj)
    x = to_np(states.x)
    iterations = iters.cpu().numpy()
    rel_gap, pinf, dinf = to_np(rel_gap), to_np(pinf), to_np(dinf)

    # Solo cleanup: members the batched loop left unfinished (tail
    # extraction stopped early, stalls, iteration limits) re-solve
    # individually through the dense backend on the same device,
    # warm-started from their batched iterates (a raw IPMState: trusted
    # verbatim). Bounded so a pathological batch can't turn into B
    # sequential solves.
    bad = [i for i in range(Bsz) if status_arr[i] != Status.OPTIMAL]
    if bad and len(bad) <= _cleanup_cap(Bsz):
        from distributedlpsolver_tpu_torch.backends.base import get_backend
        from distributedlpsolver_tpu_torch.ipm.driver import solve as _solve

        base_cfg = cfg.replace(
            verbose=False, log_jsonl=None, checkpoint_path=None,
            checkpoint_every=0, profile_dir=None,
        )
        y_h, s_h, w_h, z_h = (to_np(v) for v in states[1:])
        for i in bad:
            # The solo solve only gets what the batched loop left unspent.
            remaining = n_phases * cfg.max_iter - int(iterations[i])
            if remaining <= 0:
                continue
            ws = IPMState(x=x[i], y=y_h[i], s=s_h[i], w=w_h[i], z=z_h[i])
            be = get_backend(CLEANUP_BACKEND, device=dev)
            t_c = time.perf_counter()
            # A mesh-less backend with no checkpoint path: the solve enters
            # no collective (the driver's barrier is the checkpoint's).
            # graftcheck: disable=spmd-divergent-collective (local cleanup)
            r = _solve(member_interior_form(batch, i), backend=be,
                       config=base_cfg.replace(max_iter=remaining), warm_start=ws)
            status_arr[i] = r.status
            objective[i] = r.objective
            x[i] = r.x
            iterations[i] += r.iterations
            rel_gap[i], pinf[i], dinf[i] = r.rel_gap, r.pinf, r.dinf
            loop_rows = getattr(be, "phase_report", None) or [{}]
            phase_report.append({
                "phase": "cleanup", "member": i, "mode": "solo", "iters": r.iterations,
                "wall_s": round(time.perf_counter() - t_c, 3), "chunk": 0,
                **{k: v for k, v in loop_rows[0].items() if k not in ("phase", "iters", "wall_s", "mode")},
            })

    solve_time = time.perf_counter() - t1
    return BatchedResult(
        status=status_arr,
        objective=objective,
        x=x,
        iterations=iterations,
        rel_gap=rel_gap,
        pinf=pinf,
        dinf=dinf,
        solve_time=solve_time,
        setup_time=setup_time,
        phase_report=phase_report,
        fused_iters=fuse,
    )
