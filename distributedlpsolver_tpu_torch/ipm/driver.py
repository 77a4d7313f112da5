"""Host-side Mehrotra driver loop (SURVEY.md §1 L4, §3.1).

The port of the JAX package's ``ipm/driver.py``. By default, as there,
:func:`solve` hands the whole iteration to the backend's fused loop
(``backend.solve_full``; on a card, one captured CUDA graph of the
Mehrotra step replayed by the host). Hooks, ``profile_dir``, periodic
checkpoints or ``fused_loop=False`` select the host loop: each
``backend.iterate`` call queues one full iteration on the device and
returns only convergence scalars, copied to the host in one transfer,
and this loop owns convergence testing at the configured duality-gap
tolerance, numerical-failure recovery (deterministic regularization
escalation), per-iteration logging and checkpoints. Both end in the
recovery of the solution in the original variable space.

Warm starts are the JAX package's two: a raw :class:`IPMState` is trusted
verbatim (the checkpoint-resume contract; the batched solver's solo
cleanup hands its iterates over so), a :class:`ipm.warm.WarmStart` is
safeguarded by :func:`_init_warm_start`. A ``warm_cache``
(``serve/warmcache.py``) supplies both, as there: a cached iterate and
Ruiz scaling for the problem's structural fingerprint, a cached
preconditioner scaling for a backend with the ``offer_precond`` seam
(``sparse-iterative``), and the store of this solve's on an OPTIMAL
finish.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import TYPE_CHECKING, Optional, Union

import numpy as np

from distributedlpsolver_tpu_torch.ipm.config import SolverConfig

if TYPE_CHECKING:  # real import is deferred to solve() — backends import ipm
    from distributedlpsolver_tpu_torch.backends.base import SolverBackend
from distributedlpsolver_tpu_torch.ipm import core
from distributedlpsolver_tpu_torch.ipm.state import (
    IPMResult,
    IterRecord,
    Status,
)
from distributedlpsolver_tpu_torch.models.problem import (
    InteriorForm,
    LPProblem,
    to_interior_form,
)
from distributedlpsolver_tpu_torch.obs import context as obs_context
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.obs import trace as obs_trace
from distributedlpsolver_tpu_torch.parallel import runtime
from distributedlpsolver_tpu_torch.utils import checkpoint as ckpt
from distributedlpsolver_tpu_torch.utils.logging import IterLogger

_DIVERGE = 1e30


class SolveHooks:
    """Per-iteration instrumentation seam of the host loop.

    ``run_step`` executes one device step (a supervisor can put it under
    a watchdog deadline); ``on_iterate`` inspects the host-side scalar
    dict after each iteration, before the iterate is checkpointed. Both
    may raise; an exception aborts the solve (the logger still closes)
    and propagates to the caller.
    """

    def run_step(self, step_fn, iteration: int):
        """Execute one device step (``step_fn`` returns (state, stats))."""
        return step_fn()

    def on_iterate(self, iteration: int, scalars: dict) -> None:
        """Inspect the host-side scalar dict after iteration ``iteration``."""


def solve(
    problem: Union[LPProblem, InteriorForm],
    backend: Union[str, "SolverBackend"] = "cuda",
    config: Optional[SolverConfig] = None,
    warm_start=None,
    hooks: Optional[SolveHooks] = None,
    warm_cache=None,
    **config_overrides,
) -> IPMResult:
    """Solve an LP to the configured duality-gap tolerance.

    ``problem`` may be a general-form :class:`LPProblem` (converted via
    :func:`to_interior_form`; solution is recovered in the original space)
    or an :class:`InteriorForm` directly. ``backend`` is a registry name
    (``--backend=`` in the CLI) or an instance; the name ``"cuda"`` places
    everything on the first CUDA card, and raises where there is none —
    pass ``get_backend("cuda", device="cpu")`` to run on the CPU.

    ``warm_start`` accepts a raw :class:`IPMState` of host arrays in the
    interior space (trusted verbatim — the checkpoint-resume contract) or
    an :class:`ipm.warm.WarmStart` (safeguarded: shifted into the strict
    interior, recentred, and DROPPED for the cold start when its initial
    residuals regress — see ipm/warm.py); presolve is skipped with either,
    since a warm iterate lives in the unreduced space. ``warm_cache`` is
    an optional :class:`serve.warmcache.WarmCache`: the solve looks up the
    problem's structural fingerprint for a cached scaling and prior
    iterate (presolve is skipped on this path too), and stores its own
    scaling and final iterate back on an OPTIMAL finish. A
    ``config.checkpoint_path`` resume works.
    """
    from distributedlpsolver_tpu_torch.backends.base import get_backend
    from distributedlpsolver_tpu_torch.ipm import warm as warm_mod

    cfg = config or SolverConfig()
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    # Resolved first: a "cuda" backend without a card raises here, even
    # for a problem presolve alone would settle.
    be = get_backend(backend) if isinstance(backend, str) else backend

    original: Optional[LPProblem] = problem if isinstance(problem, LPProblem) else None
    cache_fp = None
    cache_entry = None
    if warm_cache is not None and original is not None:
        from distributedlpsolver_tpu_torch.utils.fingerprint import structural_fingerprint

        # Model identity of the RAW problem; the entry's shape guard runs
        # against the interior form below (cached iterates live in
        # interior space, whose dims differ for general-form inputs).
        cache_fp = structural_fingerprint(
            original.A, original.m, original.n, original.lb, original.ub
        )
    presolve_info = None
    t_pre0 = time.perf_counter()
    if (
        cfg.presolve
        and original is not None
        and original.block_structure is None  # reductions break the hint
        and warm_start is None  # warm starts are in the unreduced space
        and cache_fp is None  # cached iterates/scalings are too
    ):
        from distributedlpsolver_tpu_torch.models.presolve import presolve as _presolve

        reduced, presolve_info = _presolve(original)
        if presolve_info.status is not None:
            return _presolved_result(original, presolve_info, backend)
        inf = to_interior_form(reduced)
    else:
        inf = to_interior_form(problem) if isinstance(problem, LPProblem) else problem
    if cache_fp is not None:
        cache_entry = warm_cache.lookup(cache_fp, inf.m, inf.n)
        if warm_start is None and cache_entry is not None and cache_entry.state is not None:
            warm_start = warm_mod.WarmStart(cache_entry.state, source="cache")
    if cache_entry is not None and cache_entry.structure is not None and inf.block_structure is None:
        # Structure detection amortized across the stream: the hint a prior
        # same-structure solve recorded routes this one without detecting
        # again (the reference's rule).
        inf.block_structure = cache_entry.structure

    t_pre = time.perf_counter() - t_pre0
    scaling = None
    inf_solve = inf
    t_scale0 = time.perf_counter()
    if cfg.scale:
        if (
            cache_entry is not None
            and cache_entry.scaling is not None
            and cache_entry.scaled_A is not None
        ):
            # Delta-solve amortization: Ruiz factors depend only on A, so
            # a same-structure request reuses the cached (Dr, Dc) and
            # pre-scaled A — only the new b/c/u are rescaled here.
            scaling = cache_entry.scaling
            inf_solve = _rescale_interior(inf, scaling, cache_entry.scaled_A)
        else:
            from distributedlpsolver_tpu_torch.models.scaling import equilibrate

            inf_solve, scaling = equilibrate(inf)

    logger = IterLogger(
        cfg.verbose, cfg.log_jsonl, fsync=cfg.log_fsync, append=cfg.log_append
    )

    def to_solver_space(host_state):
        return be.from_host(
            scaling.scale_state(host_state) if scaling else host_state
        )

    t_setup0 = time.perf_counter()
    t_scale = t_setup0 - t_scale0
    be.setup(inf_solve, cfg)
    t_place = time.perf_counter() - t_setup0
    # Warm-cache-supplied preconditioner: a backend with the offer/export
    # seam (sparse-iterative) seeds its PCG preconditioner from the cached
    # final scaling of the last OPTIMAL same-structure solve. Only valid
    # when this solve reuses the Ruiz scaling the cached d was exported
    # under (the delta-solve path); offer_precond shape-guards the rest.
    if (
        cache_entry is not None
        and cache_entry.precond_d is not None
        and hasattr(be, "offer_precond")
        and (not cfg.scale or cache_entry.scaling is not None)
    ):
        be.offer_precond(cache_entry.precond_d)
    fingerprint = ckpt.problem_fingerprint(inf) if cfg.checkpoint_path else ""
    resumed = (
        ckpt.maybe_load(cfg.checkpoint_path, fingerprint)
        if warm_start is None
        else None
    )
    if cfg.checkpoint_path:
        # Every rank of a world runs this driver and rank 0 alone writes
        # the checkpoint: no rank may start (and rank 0 overwrite the
        # file) before every rank has read it. After a shrink the
        # backend's mesh holds the survivors, and its first member writes.
        runtime.barrier(getattr(be, "mesh", None))
    warm_label = "cold"
    if isinstance(warm_start, warm_mod.WarmStart):
        state, warm_label = _init_warm_start(
            be, warm_start, inf, inf_solve, scaling, to_solver_space
        )
        start_iter = 0
    elif warm_start is not None:
        state, start_iter = to_solver_space(warm_start), 0
    elif (
        resumed is not None
        and resumed[2] == inf.name
        and resumed[0].x.shape == (inf.n,)
        and resumed[0].y.shape == (inf.m,)
    ):
        # Checkpoints are host-canonical (utils/checkpoint.py v3), so a
        # file written by either package resumes here: from_host places
        # the iterate on this backend's device.
        state, start_iter = to_solver_space(resumed[0]), resumed[1]
    else:
        state, start_iter = be.starting_point(), 0
    setup_time = time.perf_counter() - t_setup0
    # The host setup by part, on the backend the solve ran on.
    be.setup_report = {"presolve_s": t_pre, "scale_s": t_scale, "place_s": t_place,
                       "start_s": setup_time - t_place}

    on_host_state = None
    if cache_fp is not None:
        def on_host_state(final_status, host_state):
            if final_status is not Status.OPTIMAL:
                return
            export = getattr(be, "export_precond", None)
            warm_cache.store(
                cache_fp, m=inf.m, n=inf.n, state=host_state, scaling=scaling,
                scaled_A=inf_solve.A if scaling is not None else None,
                structure=inf.block_structure,
                precond_d=export() if export is not None else None, tol=cfg.tol,
            )

    use_fused = cfg.fused_loop
    if use_fused is None:
        use_fused = not (cfg.checkpoint_every and cfg.checkpoint_path)
    if hooks is not None or cfg.profile_dir:
        use_fused = False  # both need iteration boundaries on the host
    if use_fused:
        fused = _try_fused(be, state, cfg, logger)
        # None only for a backend with no fused loop: alike on every rank.
        # graftcheck: disable=spmd-divergent-collective (same backend)
        if fused is not None:
            state, status, history, last, solve_time, fused_iters = fused
            return _finalize(
                be, state, status, history, last, solve_time, setup_time,
                inf, original, backend, start_iter, scaling=scaling,
                presolve_info=presolve_info, extra_iters=fused_iters,
                warm_label=warm_label, on_host_state=on_host_state,
            )

    status = Status.ITERATION_LIMIT
    history = []
    last = None
    it = start_iter
    # Hot-path instruments, resolved ONCE before the loop. Disabled mode
    # (the default NULL registry) makes every observe below a no-op.
    _reg = obs_metrics.get_registry()
    _m_iters = _reg.counter(
        "ipm_iterations_total", help="completed IPM iterations"
    )
    _m_step = _reg.histogram(
        "ipm_step_seconds", buckets=obs_metrics.SECONDS_BUCKETS,
        help="device-synchronized wall time per IPM iteration",
    )
    _m_refactor = _reg.counter(
        "ipm_refactorizations_total",
        help="bad-step regularization-bump refactorization attempts",
    )
    _tracer = obs_trace.get_tracer()
    _trace_args = (
        obs_context.current().span_args()
        if _tracer.enabled and obs_context.current() is not None
        else None
    )
    t_solve0 = time.perf_counter()
    profile_stack = contextlib.ExitStack()
    try:
        profile_stack.enter_context(_maybe_profiler(cfg.profile_dir))
        while it < cfg.max_iter:
            t_it0 = time.perf_counter()
            refactor = 0
            while True:
                if hooks is None:
                    new_state, stats = _step_once(be, state)
                else:
                    step_state = state  # freeze for the deferred closure
                    new_state, stats = hooks.run_step(
                        lambda: _step_once(be, step_state), it + 1
                    )
                bad = bool(stats.bad)
                if not bad:
                    break
                refactor += 1
                _m_refactor.inc()
                if refactor > cfg.max_refactor or not be.bump_regularization():
                    status = Status.NUMERICAL_ERROR
                    break
            if bad:
                break
            state = new_state
            it += 1
            t_it = time.perf_counter() - t_it0
            _m_iters.inc()
            _m_step.observe(t_it)
            if _tracer.enabled:
                it_args = {"iter": it, "refactor": refactor}
                if _trace_args is not None:
                    it_args.update(_trace_args)
                _tracer.complete(
                    f"ipm.iter {it}", t_it, cat="ipm", args=it_args
                )
            last = _to_floats(stats)
            rec = IterRecord(iter=it, t_iter=t_it, **last)
            history.append(rec)
            logger.log(rec)
            if hooks is not None:
                hooks.on_iterate(it, last)
            if (cfg.checkpoint_every and it % cfg.checkpoint_every == 0 and cfg.checkpoint_path
                    and runtime.is_primary(getattr(be, "mesh", None))):  # once per world
                host_state = be.to_host(state)
                if scaling is not None:
                    host_state = scaling.unscale_state(host_state)
                ckpt.save_state(
                    cfg.checkpoint_path, host_state, it, inf.name, fingerprint
                )
            # On a process-group mesh the step's collectives hand every rank
            # the same stats, so each rank takes the same exit below (and
            # every rank met the checkpoint barrier above before the loop).
            # graftcheck: disable=spmd-divergent-collective (replicated stats)
            if (
                last["rel_gap"] <= cfg.tol
                and last["pinf"] <= cfg.tol
                and last["dinf"] <= cfg.tol
            ):
                status = Status.OPTIMAL
                break
            pinfeas, dinfeas = core.classify_divergence(
                last["mu"], last["pinf"], last["dinf"], last["rel_gap"],
                last["pobj"], last["dobj"],
            )
            if pinfeas:  # graftcheck: disable=spmd-divergent-collective (replicated stats)
                status = Status.PRIMAL_INFEASIBLE
                break
            if dinfeas:  # graftcheck: disable=spmd-divergent-collective (replicated stats)
                status = Status.DUAL_INFEASIBLE
                break
            # graftcheck: disable=spmd-divergent-collective (replicated stats)
            if not np.isfinite(last["mu"]) or last["mu"] > _DIVERGE:
                status = Status.NUMERICAL_ERROR
                break
    finally:
        profile_stack.close()
        solve_time = time.perf_counter() - t_solve0
        logger.close()

    return _finalize(
        be, state, status, history, last, solve_time, setup_time,
        inf, original, backend, start_iter, extra_iters=it - start_iter,
        scaling=scaling, presolve_info=presolve_info, warm_label=warm_label,
        on_host_state=on_host_state,
    )


def _rescale_interior(inf: InteriorForm, scaling, scaled_A) -> InteriorForm:
    """Apply a cached Ruiz scaling (same A by fingerprint contract) to a
    new interior form: the pre-scaled A is reused as it is, only b, c and
    u are rescaled."""
    import dataclasses

    return dataclasses.replace(
        inf,
        c=inf.c * scaling.dc,
        A=scaled_A,
        b=inf.b * scaling.dr,
        u=np.where(np.isfinite(inf.u), inf.u / scaling.dc, np.inf),
    )


def _init_warm_start(be, ws, inf, inf_solve, scaling, to_solver_space):
    """Safeguarded warm-start initialization: shift-and-recentre the
    prior iterate (ipm/warm.py), then accept it only when its initial
    residual merit does not regress past the Mehrotra cold start's —
    the fallback keeps an adversarial prior from costing more than the
    warm start could save. Returns (device_state, "warm"|"rejected")."""
    from distributedlpsolver_tpu_torch.ipm import warm as warm_mod

    cold = be.starting_point()
    try:
        cand = warm_mod.interior_candidate(ws.state, inf)
        cand_scaled = scaling.scale_state(cand) if scaling else cand
        cold_host = be.to_host(cold)
        merit_w = warm_mod.residual_merit(inf_solve, cand_scaled)
        merit_c = warm_mod.residual_merit(inf_solve, cold_host)
        mu_w = warm_mod.state_mu(cand_scaled, inf_solve.u)
        mu_c = warm_mod.state_mu(cold_host, inf_solve.u)
        accept = (
            np.isfinite(merit_w)
            and np.isfinite(mu_w)
            and merit_w
            <= warm_mod.WARM_ACCEPT_FACTOR * max(merit_c, 1e-12)
            # μ guard: the primal/dual refresh makes even a far-off
            # prior nearly feasible — complementarity is what still
            # tells it apart from a useful start.
            and mu_w <= warm_mod.MU_ACCEPT_FACTOR * max(mu_c, 1e-12)
        )
    except Exception:  # malformed prior (shape drift): cold start
        accept = False
    if accept:
        return be.from_host(cand_scaled), "warm"
    obs_metrics.get_registry().counter(
        "warm_start_rejected_total",
        help="safeguard fallbacks: warm starts whose initial residuals "
        "regressed past the cold start's",
    ).inc()
    return cold, "rejected"


def _step_once(be, state):
    """One synchronized device step — the unit of work a watchdog would
    deadline."""
    new_state, stats = be.iterate(state)
    # The one sanctioned per-iteration sync: the convergence test needs
    # the step to have actually finished.
    # graftcheck: disable=host-sync (watchdog; stats.mu is a device value on the card)
    be.block_until_ready(stats.mu)
    return new_state, stats


_STAT_FIELDS = (
    "mu", "gap", "rel_gap", "pinf", "dinf", "pobj", "dobj",
    "alpha_p", "alpha_d", "sigma",
)


def _try_fused(be, state, cfg: SolverConfig, logger: IterLogger):
    """Run the backend's fused on-device loop; None only for a backend
    with no fused loop. The dense backend's ``solve_full`` returns the
    iteration count, status and stats buffer on the host."""
    t0 = time.perf_counter()
    out = be.solve_full(state)
    if out is None:
        return None
    state, it_dev, status_code, buf = out
    be.block_until_ready(it_dev)
    solve_time = time.perf_counter() - t0

    iters = int(np.asarray(it_dev))
    buf = np.asarray(buf)[: min(iters, len(np.asarray(buf)))]
    status = {
        core.STATUS_OPTIMAL: Status.OPTIMAL,
        core.STATUS_MAXITER: Status.ITERATION_LIMIT,
        core.STATUS_NUMERR: Status.NUMERICAL_ERROR,
        core.STATUS_PINFEAS: Status.PRIMAL_INFEASIBLE,
        core.STATUS_DINFEAS: Status.DUAL_INFEASIBLE,
        core.STATUS_STALL: Status.STALLED,
    }.get(int(np.asarray(status_code)), Status.NUMERICAL_ERROR)

    # Fused-loop records carry the AVERAGE seconds/iteration.
    t_avg = solve_time / max(iters, 1)
    obs_metrics.get_registry().counter(
        "ipm_iterations_total", help="completed IPM iterations"
    ).inc(iters)
    history, last = [], None
    for i in range(len(buf)):
        last = dict(zip(_STAT_FIELDS, (float(v) for v in buf[i])))
        rec = IterRecord(iter=i + 1, t_iter=t_avg, **last)
        history.append(rec)
        logger.log(rec)
    logger.close()
    return state, status, history, last, solve_time, iters


def _finalize(
    be, state, status, history, last, solve_time, setup_time,
    inf, original, backend, start_iter, extra_iters=None, scaling=None,
    presolve_info=None, warm_label="cold", on_host_state=None,
):
    n_iters = extra_iters if extra_iters is not None else len(history)
    _reg = obs_metrics.get_registry()
    _reg.counter(
        "ipm_solves_total", labels={"status": status.value},
        help="finished IPM solves by terminal status",
    ).inc()
    # Warm-vs-cold attribution: a safeguard-rejected warm start counts as
    # cold — it ran the cold trajectory.
    _reg.histogram(
        "ipm_iterations", buckets=obs_metrics.ITER_BUCKETS,
        labels={"start": "warm" if warm_label == "warm" else "cold"},
        help="IPM iterations per finished solve, by start kind",
    ).observe(n_iters)
    _tracer = obs_trace.get_tracer()
    solve_args = {
        "backend": getattr(be, "name", str(backend)),
        "status": status.value,
        "iterations": n_iters,
    }
    _ctx = obs_context.current() if _tracer.enabled else None
    if _ctx is not None:
        solve_args.update(_ctx.span_args())
    _tracer.complete(
        f"ipm.solve {inf.name}", solve_time, cat="ipm", args=solve_args
    )
    if _tracer.enabled:
        # CG attribution for matrix-free backends: one span carrying the
        # solve's inner-iteration economics, linked to the owning request.
        cg_report = getattr(be, "cg_report", None)
        if cg_report is not None:
            try:
                rep = cg_report()
            except Exception:  # telemetry must never sink a solve
                rep = None
            if rep and rep.get("cg_iters"):
                cg_args = {k: rep.get(k) for k in ("cg_iters", "precond", "shards", "psum_per_iter")}
                if _ctx is not None:
                    cg_args.update(_ctx.span_args())
                _tracer.complete(f"cg.solve {inf.name}", solve_time, cat="cg", args=cg_args)
    host = be.to_host(state)
    if scaling is not None:
        host = scaling.unscale_state(host)
    if on_host_state is not None:
        try:  # a warm-cache store must never sink the solve
            on_host_state(status, host)
        except Exception:
            pass
    certificate = None
    if status in (
        Status.PRIMAL_INFEASIBLE,
        Status.DUAL_INFEASIBLE,
        Status.ITERATION_LIMIT,
        Status.STALLED,
        Status.NUMERICAL_ERROR,
    ):
        # Farkas-ray extraction (ipm/certificates.py): a passing
        # certificate is a mathematical proof, so it may UPGRADE a
        # heuristic/indeterminate status — never the other way around.
        try:
            from distributedlpsolver_tpu_torch.ipm import certificates as _certs

            certificate = _certs.extract_certificate(
                inf, host, status.value
            )
        except Exception:  # certificates must never sink a solve
            certificate = None
        if certificate is not None and certificate.certified:
            status = (
                Status.PRIMAL_INFEASIBLE
                if certificate.kind == "primal_infeasible"
                else Status.DUAL_INFEASIBLE
            )
    x_t = np.asarray(host.x, dtype=np.float64)
    obj_min = inf.objective(x_t)
    y = np.asarray(host.y, dtype=np.float64)
    s = np.asarray(host.s, dtype=np.float64)
    if original is not None:
        x_orig = inf.recover(x_t)
        if presolve_info is not None:
            # ``inf`` was built from the presolve-reduced problem: expand
            # the primal back to the full variable space and recover exact
            # duals for the removed rows (models/presolve.py).
            x_orig = presolve_info.postsolve_x(x_orig)
            y, s = presolve_info.postsolve_duals(original, x_orig, y)
            obj_min = float(original.c @ x_orig) + original.c0
        else:
            s = original.c - np.asarray(original.A.T @ y).ravel()
        objective = -obj_min if original.maximize else obj_min
    else:
        x_orig = x_t
        objective = obj_min

    return IPMResult(
        status=status,
        x=x_orig,
        objective=objective,
        iterations=n_iters,
        rel_gap=last["rel_gap"] if last else np.inf,
        pinf=last["pinf"] if last else np.inf,
        dinf=last["dinf"] if last else np.inf,
        solve_time=solve_time,
        setup_time=setup_time,
        history=history,
        backend=getattr(be, "name", str(backend)),
        name=inf.name,
        y=y,
        s=s,
        certificate=certificate,
        warm=warm_label,
    )


def _presolved_result(original: LPProblem, info, backend) -> IPMResult:
    """Result for a problem presolve settled without running the IPM."""
    optimal = info.status == Status.OPTIMAL
    x = info.postsolve_x(np.empty(0)) if optimal else None
    y = s = None
    if optimal:
        y, s = info.postsolve_duals(original, x, None)
        obj = -info.objective if original.maximize else info.objective
    elif info.status == Status.DUAL_INFEASIBLE:
        obj = np.inf if original.maximize else -np.inf
    else:  # infeasible: no attainable objective
        obj = -np.inf if original.maximize else np.inf
    return IPMResult(
        status=info.status,
        x=x,
        objective=obj,
        iterations=0,
        rel_gap=0.0 if optimal else np.inf,
        pinf=0.0 if optimal else np.inf,
        dinf=0.0 if optimal else np.inf,
        solve_time=0.0,
        setup_time=0.0,
        history=[],
        backend=f"presolve+{backend if isinstance(backend, str) else getattr(backend, 'name', '')}",
        name=original.name,
        y=y,
        s=s,
    )


def _to_floats(stats):
    return {f: float(getattr(stats, f)) for f in stats._fields if f != "bad"}


@contextlib.contextmanager
def _maybe_profiler(profile_dir: Optional[str]):
    """``torch.profiler`` over the host loop when ``profile_dir`` is set;
    the Chrome trace lands in ``profile_dir/torch_trace.json``."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "torch_trace.json"))
