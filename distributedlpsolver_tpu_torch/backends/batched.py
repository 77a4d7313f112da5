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

Not ported here: the two-phase and PCG batched schedules (reachable only
on a TPU or by ``solve_mode="pcg"``, which raises), the mesh (``mesh=``
raises), and the serving half of the JAX module — ``solve_bucket``, its
placement, in-program warm selection and the compile-cache reports.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    # Fields of the JAX package's bucket path (not ported): always None.
    y: Optional[np.ndarray] = None
    s: Optional[np.ndarray] = None
    w: Optional[np.ndarray] = None
    z: Optional[np.ndarray] = None
    warm_used: Optional[np.ndarray] = None

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
                  fuse_iters=1):
    """One phase's masked batched loop at one program size, in a
    :class:`device_loop.DeviceLoop` (one captured graph on a card).

    ``fuse_iters`` = k puts k masked micro-steps into one body (one graph
    replay): each re-checks the guard on its own carry, so the results
    are the bits of k = 1, and at most k - 1 guarded no-op steps run where
    a body straddles the finish."""
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
    return device_loop.DeviceLoop(body, cond, _batched_meta, inputs, counters=(normal_eq,))


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
    on a TPU). ``mesh`` is not ported and raises.
    """
    if mesh is not None:
        raise NotImplementedError("solve_batched over a mesh is not ported to the torch package yet")
    cfg = config or SolverConfig()
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    dev = resolve_device(device)
    dtype = dense._torch_dtype(cfg.dtype)
    fdt = dense._torch_dtype(cfg.factor_dtype_resolved())

    B_total = np.asarray(batch.A).shape[0]
    if chunk and B_total > chunk:
        t0 = time.perf_counter()
        parts = [
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
            "the two-phase and PCG batched schedules are not ported to the torch package yet"
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

    code_map = {
        _OPTIMAL: Status.OPTIMAL,
        _MAXITER: Status.ITERATION_LIMIT,
        _NUMERR: Status.NUMERICAL_ERROR,
        _STALL: Status.STALLED,
    }
    status_arr = np.array(
        [code_map[int(sc)] for sc in status.cpu().numpy()], dtype=object
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
