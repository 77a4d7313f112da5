"""Command-line driver of the torch package: ``solve <file.mps> --backend=<name>``.

The port of the JAX package's ``cli.py``, with the flags this package
honours plus ``--device``. Subcommands:

    solve        solve an MPS file to tolerance (``--supervise`` and its
                 watchdog flags run it under the solve supervisor)
    serve        async batching solve service: JSONL/MPS requests in,
                 result records out
    serve-http   HTTP front-end over the solve service
    serve-slice  one HTTP front-end over a world of rank processes: a
                 supervisor that launches and relaunches the world, and
                 the ranks (``--rank``) that serve the slice's buckets
    route        router tier over serve-http backends
    elastic      closed-loop autoscaler of serve-http backends
    autotune     refine a bucket ladder from serve telemetry
    report       analyze telemetry JSONL streams and metric snapshots
    obs-agg      fleet telemetry aggregator and trace merge
    generate     write a generated problem to MPS
    backends     list registered SolverBackend names
    check        graftcheck static-analysis suite over this package (the
                 tier-1 CI gate)

Every command that touches a device takes ``--device``: ``cuda`` (the
default: the first card; it fails where there is none, never falling
back to the host) or ``cpu``. ``--backend auto`` (the default, as in the
JAX CLI) picks a backend by problem structure for ``--device``: on the
card every problem the port can solve goes to ``cuda``; with ``--device
cpu`` to ``cpu-native``. The chosen backend is named in the result
(``auto(<name>)``). ``--mesh-devices K`` splits each bucket over a local
batch mesh of K devices (K distinct cards; on the CPU the CPU device K
times); more than the process has raises.

Run as ``python -m distributedlpsolver_tpu_torch.cli ...`` (or
``python -m distributedlpsolver_tpu_torch ...``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional


def _add_solver_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--backend", default="auto",
        help="SolverBackend name (auto = pick by problem size/structure; see `backends`)",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the backend runs (cuda: the first card; no fallback)",
    )
    ap.add_argument("--tol", type=float, default=1e-8, help="relative gap/infeasibility tolerance")
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--quiet", action="store_true", help="suppress per-iteration log")
    ap.add_argument("--log-jsonl", default=None, help="write per-iteration JSONL here")
    ap.add_argument("--checkpoint", default=None, help="iterate checkpoint path")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument(
        "--factor-dtype", default="auto",
        help="Cholesky dtype: auto = the iterate dtype (float64); or float32/float64",
    )
    ap.add_argument(
        "--no-presolve", action="store_true",
        help="disable structural presolve (singleton/redundant rows, fixed cols)",
    )
    ap.add_argument(
        "--no-scale", action="store_true", help="disable Ruiz equilibration"
    )
    ap.add_argument("--json", action="store_true", help="print result as one JSON object")
    ap.add_argument("--x-out", default=None, help="write solution vector as .npy")
    ap.add_argument(
        "--profile-dir", default=None,
        help="torch.profiler Chrome trace of the solve (host loop) into this directory",
    )
    ap.add_argument(
        "--log-fsync", action="store_true",
        help="fsync the JSONL log after each record (crash-proof telemetry)",
    )
    ap.add_argument(
        "--supervise", action="store_true",
        help="run under the solve supervisor (watchdog + rollback + backend degradation)",
    )
    ap.add_argument(
        "--step-timeout", type=float, default=0.0,
        help="watchdog deadline per device step in seconds (0 = no watchdog; implies "
        "--supervise when set)",
    )
    ap.add_argument(
        "--max-retries", type=int, default=6,
        help="supervisor recovery attempts before a structured failure",
    )
    ap.add_argument(
        "--adaptive-timeout", action="store_true",
        help="size the watchdog deadline adaptively (10x the trailing median step time, "
        "clamped, with warm-up grace) instead of the static --step-timeout; implies "
        "--supervise",
    )
    ap.add_argument(
        "--min-devices", type=int, default=1,
        help="smallest mesh the shrink recovery may re-form (below it the ladder degrades)",
    )
    ap.add_argument(
        "--metrics-path", default=None,
        help="enable the obs/ metrics registry and write a Prometheus-text snapshot here "
        "at exit",
    )
    ap.add_argument(
        "--trace-path", default=None,
        help="enable the obs/ span tracer and write a Chrome-trace JSON here at exit",
    )


def _obs_setup(args):
    """Install a process-wide metrics registry / span tracer when
    --metrics-path / --trace-path are given (every layer resolves the
    module defaults, so one switch instruments the whole process).
    Returns a finalizer that writes both artifacts and restores the no-op
    defaults."""
    from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
    from distributedlpsolver_tpu_torch.obs import trace as obs_trace

    reg = tracer = None
    if getattr(args, "metrics_path", None):
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.set_registry(reg)
    if getattr(args, "trace_path", None):
        tracer = obs_trace.Tracer(args.trace_path)
        obs_trace.set_tracer(tracer)

    def finalize():
        if reg is not None:
            reg.write_prometheus(args.metrics_path)
            obs_metrics.set_registry(None)
            print(f"metrics snapshot -> {args.metrics_path}", file=sys.stderr)
        if tracer is not None:
            tracer.close()
            obs_trace.set_tracer(None)
            print(f"trace ({tracer.event_count()} events) -> {args.trace_path} "
                  "(open at ui.perfetto.dev)", file=sys.stderr)

    return finalize


def _live_registry():
    """The process registry if one is enabled, else a fresh one: a
    process that advertises /metrics always runs with a live registry."""
    from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics

    reg = obs_metrics.get_registry()
    return reg if reg.enabled else obs_metrics.MetricsRegistry()


def _config_from(args) -> "SolverConfig":
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig

    return SolverConfig(
        tol=args.tol,
        max_iter=args.max_iter,
        verbose=not args.quiet,
        log_jsonl=args.log_jsonl,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        factor_dtype=args.factor_dtype,
        presolve=not args.no_presolve,
        scale=not args.no_scale,
        profile_dir=args.profile_dir,
        log_fsync=args.log_fsync,
    )


def _report(result, as_json: bool, x_out: Optional[str]) -> int:
    if x_out and result.x is not None:
        import numpy as np

        np.save(x_out, result.x)
    if as_json:
        print(
            json.dumps(
                {
                    "name": result.name,
                    "status": result.status.value,
                    "objective": result.objective,
                    "iterations": result.iterations,
                    "rel_gap": result.rel_gap,
                    "pinf": result.pinf,
                    "dinf": result.dinf,
                    "solve_time_s": result.solve_time,
                    "setup_time_s": result.setup_time,
                    "iters_per_sec": result.iters_per_sec,
                    "backend": result.backend,
                    "faults": [f.asdict() for f in result.faults],
                }
            )
        )
    else:
        print(result.summary())
    from distributedlpsolver_tpu_torch.ipm.state import Status

    return 0 if result.status == Status.OPTIMAL else 2


def cmd_solve(args) -> int:
    from distributedlpsolver_tpu_torch.io.mps import read_mps

    finalize_obs = _obs_setup(args)
    try:
        return _cmd_solve_inner(args, read_mps(args.file))
    finally:
        finalize_obs()


def _cmd_solve_inner(args, problem) -> int:
    from distributedlpsolver_tpu_torch.distributed import world as world_lib

    world = None
    if args.backend.lower() in _MESH_BACKENDS and os.environ.get(world_lib.ENV_COORDINATOR):
        # A rank of a launched world: join it from the DLPS_* environment.
        world = world_lib.init_world(
            dataclasses.replace(world_lib.WorldConfig.from_env(), device=args.device))
    try:
        return _solve_and_report(args, problem, world)
    finally:
        if world is not None:
            world.close()


# Backend names that run over a mesh: ``cli solve`` joins the DLPS_*
# world with them, or runs a world of one in-process.
_MESH_BACKENDS = ("sharded", "tpu-sharded", "mesh")


def _solve_and_report(args, problem, world) -> int:
    from distributedlpsolver_tpu_torch.backends import get_backend

    cfg = _config_from(args)
    backend = get_backend(args.backend, device=args.device if world is None else world.device)
    if args.supervise or args.step_timeout > 0 or args.adaptive_timeout:
        from distributedlpsolver_tpu_torch.supervisor import (
            SolveFailure,
            SupervisorConfig,
            supervised_solve,
        )

        sup = SupervisorConfig(
            step_timeout=args.step_timeout or None,
            adaptive_timeout=args.adaptive_timeout,
            max_retries=args.max_retries,
            min_devices=args.min_devices,
        )
        try:
            result = supervised_solve(problem, backend=backend, config=cfg, supervisor=sup)
        except SolveFailure as e:
            payload = {
                "name": problem.name,
                "status": e.status.value,
                "error": str(e),
                "faults": [f.asdict() for f in e.faults],
            }
            if args.json:
                print(json.dumps(payload))
            else:
                print(f"{problem.name}: FAILED — {e}", file=sys.stderr)
            return 3
    else:
        from distributedlpsolver_tpu_torch.ipm import solve

        result = solve(problem, backend=backend, config=cfg)
    return _report(result, args.json, args.x_out)


def _iter_request_specs(args):
    """Yield request-spec dicts from --requests (JSONL file or '-' =
    stdin) or --dir (sorted *.mps files, each one request, plus *.jsonl
    files of specs). A spec is ``{"mps": path}`` or ``{"m": .., "n": ..,
    "seed": ..}`` (generated standard-form), plus optional ``"id"``,
    ``"tol"``, ``"deadline_s"``."""
    import os

    if args.dir:
        for fname in sorted(os.listdir(args.dir)):
            path = os.path.join(args.dir, fname)
            if fname.endswith(".mps") or fname.endswith(".mps.gz"):
                yield {"mps": path, "id": fname}
            elif fname.endswith(".jsonl"):
                with open(path) as fh:
                    for line in fh:
                        if line.strip():
                            yield json.loads(line)
        return
    fh = sys.stdin if args.requests == "-" else open(args.requests)
    try:
        for line in fh:
            if line.strip():
                yield json.loads(line)
    finally:
        if fh is not sys.stdin:
            fh.close()


def _admission_from(args):
    """AdmissionConfig from ``--quotas`` (inline JSON or ``@file``):
    ``{"tenants": {"acme": {"rate": 10, "burst": 20, "weight": 2}},
    "default": {...}, "fair_start": 0.5}``. None when the flag is
    absent — the classic depth-only admission."""
    spec = getattr(args, "quotas", None)
    if not spec:
        return None
    from distributedlpsolver_tpu_torch.net.admission import AdmissionConfig, TenantQuota

    if spec.startswith("@"):
        with open(spec[1:]) as fh:
            spec = fh.read()
    cfg = json.loads(spec)

    def _quota(d: dict) -> TenantQuota:
        return TenantQuota(
            rate=float(d.get("rate", float("inf"))),
            burst=float(d.get("burst", float("inf"))),
            weight=float(d.get("weight", 1.0)),
        )

    kwargs = {"quotas": {t: _quota(q) for t, q in (cfg.get("tenants") or {}).items()}}
    if "default" in cfg:
        kwargs["default_quota"] = _quota(cfg["default"])
    if "fair_start" in cfg:
        kwargs["fair_start"] = float(cfg["fair_start"])
    if "priority_flush_scale" in cfg:
        kwargs["priority_flush_scale"] = {
            k: float(v) for k, v in cfg["priority_flush_scale"].items()
        }
    return AdmissionConfig(**kwargs)


def _brownout_from(args):
    """BrownoutConfig from ``--brownout`` (``on`` for defaults, or inline
    JSON overriding any BrownoutConfig field, e.g. ``{"depth_high": 0.6,
    "engage_after_s": 0.5}``). None when the flag is absent."""
    spec = getattr(args, "brownout", None)
    if not spec:
        return None
    from distributedlpsolver_tpu_torch.net.admission import BrownoutConfig

    if spec.strip().lower() == "on":
        return BrownoutConfig()
    return BrownoutConfig(**json.loads(spec))


def _service_config_from(args) -> "ServiceConfig":
    """The ServiceConfig both ``serve`` and ``serve-http`` build from the
    shared serving flags."""
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, ladder_from_json

    buckets = None
    if args.buckets:
        with open(args.buckets) as fh:
            buckets = ladder_from_json(fh.read())
    return ServiceConfig(
        buckets=buckets,
        batch=args.batch,
        flush_s=args.flush_ms / 1e3,
        max_queue_depth=args.queue_depth,
        default_deadline_s=args.deadline_s or None,
        log_jsonl=args.log_jsonl,
        mesh_devices=args.mesh_devices,
        warm_start=not args.no_warm_start,
        warm_cache_entries=args.warm_cache_entries,
        solo_backend=args.solo_backend,
        journal_dir=args.journal_dir,
        journal_fsync=args.journal_fsync,
        admission=_admission_from(args),
        brownout=_brownout_from(args),
    )


def cmd_serve(args) -> int:
    """Serve loop: read LP requests, multiplex them through the async
    batching SolveService on ``--device``, write one JSONL result record
    per request; the service summary goes to stderr."""
    import time

    from distributedlpsolver_tpu_torch.io.mps import read_mps
    from distributedlpsolver_tpu_torch.models.generators import random_dense_lp
    from distributedlpsolver_tpu_torch.serve import ServiceOverloaded, SolveService
    from distributedlpsolver_tpu_torch.utils.logging import stamp_record

    finalize_obs = _obs_setup(args)
    svc_cfg = _service_config_from(args)
    solver_cfg = _config_from(args).replace(verbose=False, log_jsonl=None)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    n_failed = 0
    backoffs = 0
    backoff_s = 0.0
    try:
        with SolveService(svc_cfg, solver_config=solver_cfg, device=args.device) as svc:
            submitted = []
            for spec in _iter_request_specs(args):
                if "mps" in spec:
                    problem = read_mps(spec["mps"])
                else:
                    problem = random_dense_lp(
                        int(spec["m"]), int(spec["n"]), seed=int(spec.get("seed", 0)),
                    )
                while True:
                    try:
                        fut = svc.submit(
                            problem,
                            deadline=spec.get("deadline_s"),
                            tol=spec.get("tol"),
                            name=str(spec.get("id", problem.name)),
                            tenant=str(spec.get("tenant", "default")),
                            priority=str(spec.get("priority", "normal")),
                        )
                        break
                    except ServiceOverloaded as e:
                        # Backpressure: the reader outran the solver; wait
                        # as long as the verdict says (clamped).
                        wait = min(max(e.retry_after_s, 1e-3), 60.0)
                        backoffs += 1
                        backoff_s += wait
                        time.sleep(wait)
                submitted.append(fut)
            svc.drain()
            for fut in submitted:
                r = fut.result()
                n_failed += r.status.value == "failed"
                out.write(json.dumps(stamp_record(r.record())) + "\n")
            out.flush()
            summary = {
                **svc.stats(),
                "submit_backoffs": backoffs,
                "submit_backoff_s": round(backoff_s, 3),
            }
            print(json.dumps(summary), file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()
        finalize_obs()
    return 2 if n_failed else 0


def cmd_serve_http(args) -> int:
    """HTTP front-end: bind a SolveHTTPServer over one SolveService on
    ``--device`` and serve until interrupted or drained."""
    import threading

    from distributedlpsolver_tpu_torch.net import NetConfig, SolveHTTPServer
    from distributedlpsolver_tpu_torch.serve import SolveService

    finalize_obs = _obs_setup(args)
    svc_cfg = _service_config_from(args)
    net_cfg = NetConfig(
        host=args.host,
        port=args.port,
        max_wait_s=args.max_wait_s,
        wedge_s=args.wedge_s,
        log_jsonl=args.net_log_jsonl,
        deadline_propagation=args.deadline_propagation,
    )
    reg = _live_registry()
    try:
        svc = SolveService(
            svc_cfg,
            solver_config=_config_from(args).replace(verbose=False, log_jsonl=None),
            metrics=reg,
            # Warm-up (below) runs before the pipeline threads start, so
            # journal-replayed work dispatches against built programs.
            auto_start=not args.warm_buckets,
            device=args.device,
        )
        if args.warm_buckets:
            n = svc.warm_buckets(svc.scheduler.table.specs())
            print(f"warmed {n} bucket programs", file=sys.stderr)
        with svc:
            server = SolveHTTPServer(svc, net_cfg).start()
            stopped = threading.Event()
            # /quitquitquit closes the listener, then this lets the
            # process exit cleanly.
            server.on_drained = lambda drained: stopped.set()
            # Self-registration + heartbeats, strictly after warm-up and
            # the listener bind: a rollout never exposes a backend whose
            # bucket ladder is not built yet.
            hb_stop = threading.Event()
            if args.registry:
                from distributedlpsolver_tpu_torch.net.registry import BackendRegistry

                breg = BackendRegistry(args.registry, logger=svc._logger, metrics=reg)
                breg.register(server.url)

                def _beat():
                    while not hb_stop.wait(args.heartbeat_s):
                        breg.heartbeat(server.url)

                threading.Thread(target=_beat, daemon=True, name="dlps-http-hb").start()
            print(f"serving on {server.url} on {svc.device} (POST /v1/solve; GET /metrics "
                  "/healthz /readyz /statusz; POST /quitquitquit drains)", file=sys.stderr)
            try:
                stopped.wait()  # serve until SIGINT or drained
                print("drained; exiting", file=sys.stderr)
            except KeyboardInterrupt:
                print("shutting down", file=sys.stderr)
            finally:
                hb_stop.set()
                server.shutdown()
    finally:
        finalize_obs()
    return 0


def cmd_route(args) -> int:
    """Router tier: health-checked, shape/load-aware routing over
    serve-http backends."""
    import threading

    from distributedlpsolver_tpu_torch.net.router import Router, RouterConfig, RouterHTTPServer

    if not args.backend and not args.registry:
        print("route: need --backend URLs or a --registry backends register into",
              file=sys.stderr)
        return 2
    finalize_obs = _obs_setup(args)
    router = Router(
        args.backend or [],
        RouterConfig(
            poll_s=args.poll_s,
            eject_after=args.eject_after,
            log_jsonl=args.log_jsonl,
            registry_path=args.registry,
            probe_backoff_cap_s=args.probe_backoff_cap_s,
            registry_ttl_s=args.registry_ttl_s,
            hedge_enabled=args.hedge,
            hedge_rate_cap=args.hedge_rate_cap,
            retry_budget_rate=args.retry_budget,
            retry_budget_burst=args.retry_budget_burst,
            deadline_propagation=args.deadline_propagation,
        ),
        metrics=_live_registry(),
    )
    try:
        router.start()
        server = RouterHTTPServer(router, host=args.host, port=args.port)
        server.start()
        print(f"routing on {server.url} over {len(args.backend or [])} configured backends "
              f"({router.healthy_count()} healthy)", file=sys.stderr)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            print("shutting down", file=sys.stderr)
        finally:
            server.shutdown()
    finally:
        router.shutdown()
        finalize_obs()
    return 0


def cmd_elastic(args) -> int:
    """Closed-loop elasticity controller: telemetry-driven autoscaling of
    a pool of serve-http backends on ``--device`` over the shared
    registry."""
    import threading

    from distributedlpsolver_tpu_torch.serve.elastic import ElasticConfig, ElasticController

    finalize_obs = _obs_setup(args)
    backend_flags = ["--device", args.device]
    for item in args.backend_flag or []:
        backend_flags.extend(item.split())
    ctl = ElasticController(
        ElasticConfig(
            registry_path=args.registry,
            min_backends=args.min_backends,
            max_backends=args.max_backends,
            poll_s=args.poll_s,
            load_high=args.load_high,
            load_low=args.load_low,
            reject_rate_high=args.reject_rate_high,
            out_sustain_s=args.out_sustain_s,
            in_sustain_s=args.in_sustain_s,
            cooldown_s=args.cooldown_s,
            host=args.host,
            workdir=args.workdir,
            buckets_json=args.buckets,
            backend_flags=tuple(backend_flags),
            heartbeat_s=args.heartbeat_s,
            log_jsonl=args.log_jsonl,
        ),
        metrics=_live_registry(),
    )
    try:
        ctl.start()
        print(f"elastic controller over {args.registry}: pool {args.min_backends}.."
              f"{args.max_backends} on {args.device}, {ctl.pool_size()} up", file=sys.stderr)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            print("draining managed pool", file=sys.stderr)
    finally:
        ctl.shutdown(drain=True)
        finalize_obs()
    return 0


def cmd_autotune(args) -> int:
    """Refine a serve bucket ladder from a telemetry JSONL file and write
    it as a ladder JSON ``serve --buckets`` consumes."""
    from distributedlpsolver_tpu_torch.serve import (
        AutotuneConfig,
        autotune_from_jsonl,
        ladder_from_json,
        ladder_to_json,
    )

    current = None
    if args.current:
        with open(args.current) as fh:
            current = ladder_from_json(fh.read())
    specs, report = autotune_from_jsonl(
        args.telemetry,
        current=current,
        config=AutotuneConfig(
            waste_threshold=args.waste_threshold,
            max_programs=args.max_programs,
            batch=args.batch or None,
            devices=args.devices,
        ),
    )
    if not specs:
        print("no bucketed request telemetry found; nothing to tune", file=sys.stderr)
        return 2
    with open(args.out, "w") as fh:
        fh.write(ladder_to_json(specs) + "\n")
    print(json.dumps(report))
    return 0


def cmd_report(args) -> int:
    """Merge telemetry JSONL streams and JSON metric snapshots into
    per-phase latency breakdowns, padding waste by bucket, recovery
    overhead and the iters/sec trajectory."""
    import os

    from distributedlpsolver_tpu_torch.obs import report as obs_report

    for p in args.files:
        if not os.path.exists(p):
            print(f"report: {p!r}: file not found", file=sys.stderr)
            return 2
    rep = obs_report.report_from_paths(args.files)
    print(json.dumps(rep) if args.json else obs_report.render(rep))
    return 0


def cmd_obs_agg(args) -> int:
    """Fleet telemetry aggregator: discover the fleet (registry,
    heartbeat dirs, URLs), pull every process's /statusz and /metrics,
    merge per-process traces into one Perfetto trace connected by
    trace_id, and print the reconciliation table (router hedge ledger,
    backend request records, journal lifecycle counts)."""
    import os

    from distributedlpsolver_tpu_torch.obs import agg as obs_agg

    traces = []
    for spec in args.trace or []:
        label, sep, path = spec.partition("=")
        if not sep:
            label, path = os.path.basename(spec), spec
        traces.append((label, path))
    fleet, merged = obs_agg.fleet_view(
        registry_path=args.registry,
        heartbeat_dirs=args.heartbeat_dir or [],
        routers=args.router or [],
        backends=args.backend or [],
        traces=traces,
        metrics_json=args.metrics_json or [],
        timeout_s=args.timeout_s,
    )
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        fleet_path = os.path.join(args.out, "fleet.json")
        with open(fleet_path, "w") as fh:
            json.dump(fleet, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"fleet view -> {fleet_path}", file=sys.stderr)
        if merged is not None:
            trace_path = os.path.join(args.out, "trace_merged.json")
            with open(trace_path, "w") as fh:
                json.dump(merged, fh)
                fh.write("\n")
            print(f"merged trace ({len(merged['traceEvents'])} events, "
                  f"{merged['otherData']['traces_connected']} trace(s) connected) -> "
                  f"{trace_path} (open at ui.perfetto.dev)", file=sys.stderr)
    if args.json:
        print(json.dumps(fleet))
    else:
        print(obs_agg.render_text(fleet), end="")
    rec = fleet.get("reconciliation") or {}
    return 0 if rec.get("consistent", True) else 1


def cmd_generate(args) -> int:
    from distributedlpsolver_tpu_torch.io.mps import write_mps
    from distributedlpsolver_tpu_torch.models import generators as gen

    if args.kind == "dense":
        p = gen.random_dense_lp(args.m, args.n, seed=args.seed)
    elif args.kind == "general":
        p = gen.random_general_lp(args.m, args.n, seed=args.seed)
    elif args.kind == "scenario":
        # Lowered two-stage stochastic LP. The hint is not representable in
        # MPS; for sparse-stored ingests (m·n > 200k) `solve --backend auto`
        # recovers it from the sparsity pattern
        # (models/structure.detect_two_stage) and routes back to the
        # scenario engine.
        from distributedlpsolver_tpu_torch.models.scenario import two_stage_storm

        p = two_stage_storm(
            args.scenarios, block_m=args.m, block_n=args.n, seed=args.seed,
        ).to_block_angular()
    else:
        kw = {} if args.density is None else {"density": args.density}
        p = gen.block_angular_lp(args.blocks, args.m, args.n, args.link, seed=args.seed, **kw)
    write_mps(p, args.out)
    print(f"wrote {p.name} ({p.m}x{p.n}) to {args.out}")
    return 0


def cmd_serve_slice(args) -> int:
    """One-service-per-slice serving over a world of rank processes.

    Without ``--rank``: SUPERVISOR mode — spawn ``--world-size`` rank
    processes of this same command line, watch them, and on the world's
    death relaunch a smaller world on the same HTTP port and job journal
    (``distributed/launcher.WorldSupervisor``; ``world_reinit`` records
    with ``recovery_overhead_s`` in ``<slice workdir>/world.jsonl``).

    With ``--rank`` (set by the supervisor; the env contract comes from
    the launcher): rank 0 runs the HTTP front-end whose SolveService
    dispatches onto the world's batch mesh through the slice's dispatch
    journal and registers into ``--registry``; the other ranks run the
    follower loop off that journal (``distributed/slice.py``)."""
    import threading

    if args.local_devices not in (0, 1):
        raise ValueError(
            f"--local-devices {args.local_devices}: a torch world runs one process per "
            "device; launch one rank per device (--world-size) instead")
    pg_backend = args.pg_backend or os.environ.get("DLPS_PG_BACKEND") or None
    if args.rank is None:
        # ---------------- supervisor mode ----------------------------
        from distributedlpsolver_tpu_torch.distributed.launcher import (
            SupervisorConfig,
            WorldSupervisor,
        )

        workdir = args.slice_workdir or os.path.join(
            args.journal_dir or ".", f"slice-{args.slice_id}-world")
        base_argv = list(args.argv)

        def argv_for_gen(generation, world_size, port):
            # Every generation runs the same command line: the same HTTP
            # port and job journal, so the relaunched rank 0 rebinds the
            # poll URLs and replays the journal.
            return lambda rank: ([sys.executable, "-m", "distributedlpsolver_tpu_torch.cli"]
                                 + base_argv + ["--rank", str(rank)])

        sup = WorldSupervisor(
            argv_for_gen, world_size=args.world_size, workdir=workdir,
            config=SupervisorConfig(
                min_world=1, max_reforms=args.max_reforms,
                # Its own stream: a relaunched rank re-opens its logs.
                log_jsonl=os.path.join(workdir, "world.jsonl")),
            slice_id=args.slice_id, device=args.device, pg_backend=pg_backend,
        )
        try:
            sup.run(timeout=args.supervise_timeout_s)
        except KeyboardInterrupt:
            if sup.handle is not None:
                sup.handle.kill_all()
            print("slice supervisor: interrupted", file=sys.stderr)
        return 0

    # -------------------- rank mode ----------------------------------
    from distributedlpsolver_tpu_torch.distributed.slice import (
        FileControlPlane,
        SliceRunner,
        canonical_bucket_config,
        follower_loop,
    )
    from distributedlpsolver_tpu_torch.distributed.world import WorldConfig, init_world

    cfg = WorldConfig.from_env()
    world = init_world(cfg)
    world.start_heartbeat()
    ctrl_dir = os.path.join(
        args.control_dir or os.path.join(os.environ.get("DLPS_HEARTBEAT_DIR", "."), ".."),
        f"ctrl-gen{cfg.generation}")
    solver_cfg = canonical_bucket_config(_config_from(args))
    try:
        if world.rank != 0:
            n = follower_loop(world, FileControlPlane(ctrl_dir), solver_cfg)
            print(f"slice follower rank {world.rank}: executed {n} dispatches; exiting",
                  file=sys.stderr)
            return 0

        # ---- rank 0: front-end + scheduler + demux -------------------
        from distributedlpsolver_tpu_torch.net import NetConfig, SolveHTTPServer
        from distributedlpsolver_tpu_torch.serve import SolveService

        finalize_obs = _obs_setup(args)
        runner = SliceRunner(world, FileControlPlane(ctrl_dir), solver_cfg)
        net_cfg = NetConfig(
            host=args.host, port=args.port, max_wait_s=args.max_wait_s, wedge_s=args.wedge_s,
            log_jsonl=args.net_log_jsonl, deadline_propagation=args.deadline_propagation,
        )
        reg = _live_registry()
        try:
            svc = SolveService(_service_config_from(args), solver_config=solver_cfg, metrics=reg,
                               auto_start=not args.warm_buckets, slice_runner=runner,
                               device=world.device)
            if args.warm_buckets:
                n = svc.warm_buckets(svc.scheduler.table.specs())
                print(f"warmed {n} bucket programs across {world.world_size} ranks",
                      file=sys.stderr)
            with svc:
                server = SolveHTTPServer(svc, net_cfg).start()
                stopped = threading.Event()
                server.on_drained = lambda drained: stopped.set()
                hb_stop = threading.Event()
                if args.registry:
                    from distributedlpsolver_tpu_torch.net.registry import BackendRegistry

                    breg = BackendRegistry(args.registry, logger=svc._logger, metrics=reg)
                    breg.register(server.url, slice_id=args.slice_id,
                                  world_size=world.world_size)

                    def _beat():
                        while not hb_stop.wait(args.heartbeat_s):
                            breg.heartbeat(server.url)

                    threading.Thread(target=_beat, daemon=True, name="dlps-slice-hb").start()
                print(f"slice {args.slice_id} gen {cfg.generation} serving on {server.url} "
                      f"(world {world.world_size}, {world.pg_backend or 'no'} process group, "
                      f"{world.device})", file=sys.stderr)
                try:
                    stopped.wait()
                    print("slice drained; exiting", file=sys.stderr)
                except KeyboardInterrupt:
                    print("slice shutting down", file=sys.stderr)
                finally:
                    hb_stop.set()
                    server.shutdown()
                    runner.stop()  # followers leave their loop cleanly
        finally:
            finalize_obs()
        return 0
    finally:
        world.close()


def _add_serving_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch", type=int, default=16, help="bucket slots")
    p.add_argument(
        "--flush-ms", type=float, default=50.0,
        help="oldest-request age that launches a part-full bucket",
    )
    p.add_argument(
        "--queue-depth", type=int, default=1024,
        help="admission-control bound on total queued requests",
    )
    p.add_argument(
        "--deadline-s", type=float, default=0.0, help="default per-request deadline (0 = none)",
    )
    p.add_argument(
        "--mesh-devices", type=int, default=0,
        help="batch-axis data parallelism over this many local devices (0/1 = unsharded; "
        "-1 = every local card; bucket batches must divide by it)",
    )
    p.add_argument(
        "--buckets", default=None,
        help="explicit bucket ladder JSON (the autotune output) instead of auto "
        "power-of-two buckets",
    )
    p.add_argument(
        "--solo-backend", default="auto",
        help="backend of the per-request solo path, for --device (auto = pick by problem "
        "size/structure; see `backends`)",
    )
    p.add_argument(
        "--no-warm-start", action="store_true",
        help="disable the warm-start & amortization layer (fingerprint cache)",
    )
    p.add_argument(
        "--warm-cache-entries", type=int, default=512,
        help="bounded LRU capacity of the problem-fingerprint warm cache",
    )
    p.add_argument(
        "--quotas", default=None,
        help="SLO-aware admission policy, inline JSON or @file: "
        '{"tenants": {"acme": {"rate": 10, "burst": 20, "weight": 2}}, "default": {...}, '
        '"fair_start": 0.5}',
    )
    p.add_argument(
        "--brownout", default=None,
        help="overload brownout ladder: 'on' for defaults, or inline JSON overriding "
        'BrownoutConfig fields, e.g. {"depth_high": 0.6, "engage_after_s": 0.5}',
    )
    p.add_argument(
        "--journal-dir", default=None,
        help="durable job journal directory: write-ahead request log + on-disk results; "
        "a restart against it replays unfinished work",
    )
    p.add_argument(
        "--journal-fsync", default="flush", choices=["none", "flush", "always"],
        help="journal persistence per record",
    )


def cmd_check(args) -> int:
    """graftcheck: run the repo's static-analysis suite (jit/recompile
    hygiene, dtype discipline, lock + static deadlock discipline, SPMD
    discipline, JSONL schema) over the given paths. Exit 0 iff there are
    no unsuppressed findings: the tier-1 CI gate over this package. With
    ``--baseline`` the gate is incremental: only findings NOT in the
    committed baseline fail (the repo commits an EMPTY one,
    ``BASELINE_GRAFTCHECK_TORCH.json``). Pure stdlib: no torch import,
    touches no device."""
    from distributedlpsolver_tpu_torch import analysis

    if args.list_rules:
        for name, doc in analysis.all_rules().items():
            print(f"{name}: {doc}")
        return 0
    paths = args.paths or [os.path.dirname(os.path.abspath(__file__))]
    for p in paths:
        if not os.path.exists(p):
            print(f"check: {p!r}: path not found", file=sys.stderr)
            return 2
    rules = args.rules.split(",") if args.rules else None
    try:
        findings = analysis.check_paths(paths, rules=rules)
    except ValueError as e:  # unknown rule name
        print(f"check: {e}", file=sys.stderr)
        return 2
    if args.write_baseline:
        with open(args.write_baseline, "w") as fh:
            fh.write(analysis.write_baseline(findings) + "\n")
        print(
            f"check: wrote baseline of "
            f"{sum(1 for f in findings if not f.suppressed)} finding(s) "
            f"to {args.write_baseline}",
            file=sys.stderr,
        )
        return 0
    gating = [f for f in findings if not f.suppressed]
    if args.baseline:
        try:
            with open(args.baseline) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"check: --baseline {args.baseline!r}: {e}", file=sys.stderr)
            return 2
        gating = analysis.diff_baseline(findings, doc)
        known = sum(1 for f in findings if not f.suppressed) - len(gating)
        if known:
            print(
                f"check: {known} known finding(s) covered by baseline "
                f"{args.baseline}",
                file=sys.stderr,
            )
    if args.json:
        print(analysis.render_json(findings))
    else:
        print(analysis.render_text(findings, show_suppressed=args.show_suppressed))
    return 1 if gating else 0


def cmd_backends(_args) -> int:
    from distributedlpsolver_tpu_torch.backends import available_backends

    for name in available_backends():
        print(name)
    return 0


def _add_plane_parsers(sub) -> None:
    """The network plane's subcommands and the tools around them."""
    ap_http = sub.add_parser(
        "serve-http",
        help="HTTP front-end over the solve service: POST /v1/solve, GET /metrics /healthz "
        "/readyz /statusz, POST /quitquitquit",
    )
    ap_http.add_argument("--host", default="127.0.0.1")
    ap_http.add_argument("--port", type=int, default=8080,
                         help="bind port (0 = OS-assigned ephemeral)")
    ap_http.add_argument("--max-wait-s", type=float, default=300.0,
                         help="sync-POST wait bound for requests without a deadline")
    ap_http.add_argument(
        "--wedge-s", type=float, default=30.0,
        help="queued depth with zero dispatch progress for this long flips /healthz unhealthy",
    )
    ap_http.add_argument("--net-log-jsonl", default=None,
                         help="http_request JSONL event stream (stamped schema)")
    ap_http.add_argument(
        "--warm-buckets", action="store_true",
        help="build the --buckets ladder's programs (on a card, capture their graphs) "
        "before binding the listener",
    )
    ap_http.add_argument(
        "--registry", default=None,
        help="shared backend-registry file: self-register after warm-up and the listener "
        "bind, and heartbeat",
    )
    ap_http.add_argument("--heartbeat-s", type=float, default=1.0,
                         help="registry heartbeat cadence when --registry is set")
    ap_http.add_argument(
        "--deadline-propagation", action=argparse.BooleanOptionalAction, default=True,
        help="honor the X-DLPS-Deadline-Ms remaining-budget header",
    )
    _add_serving_flags(ap_http)
    _add_solver_flags(ap_http)
    ap_http.set_defaults(fn=cmd_serve_http, quiet=True)

    ap_slice = sub.add_parser(
        "serve-slice",
        help="multi-host slice: a world of rank processes serving one HTTP front-end over "
        "the world's batch mesh, with coordinator-level recovery",
    )
    ap_slice.add_argument("--world-size", type=int, default=2, help="rank processes in the slice")
    ap_slice.add_argument(
        "--rank", type=int, default=None,
        help="run ONE rank (set by the supervisor; env contract from the launcher); omit it "
        "to run the slice supervisor",
    )
    ap_slice.add_argument(
        "--local-devices", type=int, default=1,
        help="devices per rank process: 1 (a torch world runs one process per device)",
    )
    ap_slice.add_argument(
        "--pg-backend", choices=("nccl", "gloo"), default=None,
        help="process-group backend (default: DLPS_PG_BACKEND, else nccl on cards and gloo "
        "on the CPU); gloo lets several ranks share one card",
    )
    ap_slice.add_argument("--slice-id", default="slice0",
                          help="slice name stamped into registry entries and world_reinit events")
    ap_slice.add_argument("--registry", default=None,
                          help="shared backend-registry file to self-register into")
    ap_slice.add_argument("--heartbeat-s", type=float, default=1.0,
                          help="registry heartbeat cadence")
    ap_slice.add_argument("--control-dir", default=None,
                          help="slice dispatch-journal directory (default: next to the "
                          "launcher's heartbeat dir)")
    ap_slice.add_argument("--slice-workdir", default=None,
                          help="supervisor workdir (heartbeats, rank logs, world.jsonl)")
    ap_slice.add_argument("--max-reforms", type=int, default=3,
                          help="world re-initializations before the supervisor gives up")
    ap_slice.add_argument("--supervise-timeout-s", type=float, default=86400.0,
                          help="supervisor wall-clock budget")
    ap_slice.add_argument("--host", default="127.0.0.1")
    ap_slice.add_argument(
        "--port", type=int, default=8080,
        help="rank-0 HTTP port — explicit, so a re-initialized world rebinds the same poll URLs",
    )
    ap_slice.add_argument("--max-wait-s", type=float, default=300.0)
    ap_slice.add_argument("--wedge-s", type=float, default=30.0)
    ap_slice.add_argument("--net-log-jsonl", default=None,
                          help="http_request JSONL event stream")
    ap_slice.add_argument("--warm-buckets", action="store_true",
                          help="build the bucket ladder's programs on EVERY rank before the "
                          "listener binds")
    ap_slice.add_argument(
        "--deadline-propagation", action=argparse.BooleanOptionalAction, default=True,
        help="honor the X-DLPS-Deadline-Ms remaining-budget header",
    )
    _add_serving_flags(ap_slice)
    _add_solver_flags(ap_slice)
    ap_slice.set_defaults(fn=cmd_serve_slice, quiet=True)

    ap_rt = sub.add_parser(
        "route",
        help="router tier over serve-http backends: shape/load-aware routing, "
        "health-checked failover, hedging",
    )
    ap_rt.add_argument("--backend", action="append",
                       help="backend base URL (repeatable); optional with --registry")
    ap_rt.add_argument("--host", default="127.0.0.1")
    ap_rt.add_argument("--port", type=int, default=8079,
                       help="bind port (0 = OS-assigned ephemeral)")
    ap_rt.add_argument("--poll-s", type=float, default=1.0,
                       help="backend health/status poll cadence")
    ap_rt.add_argument("--eject-after", type=int, default=2,
                       help="consecutive failed health probes before ejection")
    ap_rt.add_argument("--log-jsonl", default=None,
                       help="route/ejection JSONL event stream (stamped schema)")
    ap_rt.add_argument(
        "--registry", default=None,
        help="shared backend-registry file: replicated routers share one view of backends",
    )
    ap_rt.add_argument("--probe-backoff-cap-s", type=float, default=30.0,
                       help="ceiling on the re-probe backoff of ejected backends")
    ap_rt.add_argument(
        "--registry-ttl-s", type=float, default=0.0,
        help="eject self-registered backends whose heartbeat is older than this (0 = off)",
    )
    ap_rt.add_argument(
        "--hedge", action=argparse.BooleanOptionalAction, default=True,
        help="adaptive hedged solves: race one duplicate on the next-best backend when the "
        "primary is silent past its recent p95",
    )
    ap_rt.add_argument("--hedge-rate-cap", type=float, default=0.05,
                       help="global bound on hedges as a fraction of solve forwards")
    ap_rt.add_argument("--retry-budget", type=float, default=5.0,
                       help="per-tenant retry-budget refill rate (tokens/s)")
    ap_rt.add_argument("--retry-budget-burst", type=float, default=20.0,
                       help="per-tenant retry-budget bucket capacity")
    ap_rt.add_argument(
        "--deadline-propagation", action=argparse.BooleanOptionalAction, default=True,
        help="stamp every forward/retry/hedge with the remaining deadline budget",
    )
    ap_rt.add_argument("--metrics-path", default=None, help=argparse.SUPPRESS)
    ap_rt.add_argument("--trace-path", default=None, help=argparse.SUPPRESS)
    ap_rt.set_defaults(fn=cmd_route)

    ap_el = sub.add_parser(
        "elastic",
        help="closed-loop elasticity controller: scale serve-http backends out/in from "
        "pool telemetry",
    )
    ap_el.add_argument("--registry", required=True,
                       help="shared backend-registry file the pool lives in")
    ap_el.add_argument("--min-backends", type=int, default=1)
    ap_el.add_argument("--max-backends", type=int, default=4)
    ap_el.add_argument("--poll-s", type=float, default=0.5, help="decision cadence")
    ap_el.add_argument("--load-high", type=float, default=8.0,
                       help="mean per-backend queued+inflight that counts as overload")
    ap_el.add_argument("--load-low", type=float, default=1.0,
                       help="mean load at/below which the pool counts as idle")
    ap_el.add_argument("--reject-rate-high", type=float, default=1.0,
                       help="pool-wide admission rejects/s that count as overload")
    ap_el.add_argument("--out-sustain-s", type=float, default=1.0,
                       help="overload must hold this long before a scale-out")
    ap_el.add_argument("--in-sustain-s", type=float, default=5.0,
                       help="idleness must hold this long before a scale-in")
    ap_el.add_argument("--cooldown-s", type=float, default=5.0,
                       help="minimum quiet time between target changes")
    ap_el.add_argument("--host", default="127.0.0.1")
    ap_el.add_argument("--workdir", default=".",
                       help="spawned backends' journals and logs live here")
    ap_el.add_argument("--buckets", default=None,
                       help="bucket ladder JSON spawned backends warm before they register")
    ap_el.add_argument(
        "--backend-flag", action="append", default=None,
        help="extra serve-http flag(s) for spawned backends (repeatable; whitespace-split)",
    )
    ap_el.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where spawned backends serve (cuda: the first card; no fallback)",
    )
    ap_el.add_argument("--heartbeat-s", type=float, default=0.5,
                       help="registry heartbeat cadence of spawned backends")
    ap_el.add_argument("--log-jsonl", default=None,
                       help="scale_out/scale_in/scale_veto JSONL event stream")
    ap_el.add_argument("--metrics-path", default=None, help=argparse.SUPPRESS)
    ap_el.add_argument("--trace-path", default=None, help=argparse.SUPPRESS)
    ap_el.set_defaults(fn=cmd_elastic)

    ap_at = sub.add_parser("autotune", help="refine a serve bucket ladder from telemetry JSONL")
    ap_at.add_argument("--telemetry", required=True,
                       help="service telemetry JSONL (the serve --log-jsonl stream)")
    ap_at.add_argument("--out", required=True, help="ladder JSON output path")
    ap_at.add_argument("--current", default=None, help="current ladder JSON")
    ap_at.add_argument("--waste-threshold", type=float, default=0.35)
    ap_at.add_argument("--max-programs", type=int, default=12)
    ap_at.add_argument("--batch", type=int, default=0, help="slots per bucket")
    ap_at.add_argument("--devices", type=int, default=1,
                       help="mesh width bucket batches must divide")
    ap_at.set_defaults(fn=cmd_autotune)

    ap_r = sub.add_parser(
        "report",
        help="analyze telemetry JSONL streams + metric snapshots: per-phase p50/p95/p99, "
        "padding waste by bucket, recovery overhead, iters/sec trajectory",
    )
    ap_r.add_argument("files", nargs="+", help="telemetry JSONL files and/or JSON metric snapshots")
    ap_r.add_argument("--json", action="store_true", help="emit the report as one JSON object")
    ap_r.set_defaults(fn=cmd_report)

    ap_oa = sub.add_parser(
        "obs-agg",
        help="fleet telemetry aggregator: /statusz + /metrics across routers and backends, "
        "merged traces, reconciliation",
    )
    ap_oa.add_argument("--registry", default=None, help="shared backend-registry JSON")
    ap_oa.add_argument("--router", action="append", default=None, metavar="URL",
                       help="router URL to pull the hedge ledger from (repeatable)")
    ap_oa.add_argument("--backend", action="append", default=None, metavar="URL",
                       help="extra backend URL beyond the registry (repeatable)")
    ap_oa.add_argument("--heartbeat-dir", action="append", default=None, metavar="DIR",
                       help="world heartbeat dir to scan (repeatable)")
    ap_oa.add_argument("--trace", action="append", default=None, metavar="[LABEL=]PATH",
                       help="per-process Chrome-trace JSON to merge (repeatable)")
    ap_oa.add_argument("--metrics-json", action="append", default=None, metavar="PATH",
                       help="JSON metrics snapshot to mine for histogram exemplars")
    ap_oa.add_argument("--out", default=None, metavar="DIR",
                       help="write fleet.json + trace_merged.json here")
    ap_oa.add_argument("--timeout-s", type=float, default=2.0, help="per-pull HTTP timeout")
    ap_oa.add_argument("--json", action="store_true", help="print the fleet view as JSON")
    ap_oa.set_defaults(fn=cmd_obs_agg)

    ap_c = sub.add_parser(
        "check",
        help="graftcheck static-analysis suite: jit/recompile hygiene, "
        "dtype discipline, lock discipline, SPMD discipline, JSONL schema — "
        "the tier-1 CI gate (README 'Static analysis')",
    )
    ap_c.add_argument(
        "paths", nargs="*",
        help="files/directories to check (default: the installed "
        "distributedlpsolver_tpu_torch package)",
    )
    ap_c.add_argument(
        "--json", action="store_true",
        help="machine-readable findings (the gate's artifact format)",
    )
    ap_c.add_argument(
        "--rules", default=None,
        help="comma-separated rule subset (see --list-rules)",
    )
    ap_c.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue and exit",
    )
    ap_c.add_argument(
        "--show-suppressed", action="store_true",
        help="also print findings silenced by graftcheck directives",
    )
    ap_c.add_argument(
        "--baseline", default=None, metavar="JSON",
        help="incremental diff-gate: fail only on findings absent from "
        "this committed baseline (see --write-baseline); the tier-1 "
        "gate runs against the empty BASELINE_GRAFTCHECK_TORCH.json",
    )
    ap_c.add_argument(
        "--write-baseline", default=None, metavar="JSON",
        help="write the current unsuppressed findings as a baseline "
        "document and exit 0 (adopt-then-ratchet for existing trees)",
    )
    ap_c.set_defaults(fn=cmd_check)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="distributedlpsolver_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_solve = sub.add_parser("solve", help="solve an MPS file")
    ap_solve.add_argument("file", help="MPS path (optionally .gz)")
    _add_solver_flags(ap_solve)
    ap_solve.set_defaults(fn=cmd_solve)

    ap_srv = sub.add_parser(
        "serve", help="async batching solve service: JSONL/MPS requests in, result records out",
    )
    src = ap_srv.add_mutually_exclusive_group(required=True)
    src.add_argument("--requests", help="JSONL request file, or '-' for stdin")
    src.add_argument("--dir", help="directory of *.mps requests and/or *.jsonl spec files")
    ap_srv.add_argument("--out", default="-", help="result JSONL path ('-' = stdout)")
    _add_serving_flags(ap_srv)
    _add_solver_flags(ap_srv)
    ap_srv.set_defaults(fn=cmd_serve, quiet=True)

    _add_plane_parsers(sub)

    ap_b = sub.add_parser("backends", help="list registered backends")
    ap_b.set_defaults(fn=cmd_backends)

    ap_g = sub.add_parser("generate", help="write a generated problem to MPS")
    ap_g.add_argument("kind", choices=["dense", "general", "block", "scenario"])
    ap_g.add_argument("out")
    ap_g.add_argument("--m", type=int, default=100)
    ap_g.add_argument("--n", type=int, default=250)
    ap_g.add_argument("--blocks", type=int, default=4)
    ap_g.add_argument("--link", type=int, default=20)
    ap_g.add_argument("--scenarios", type=int, default=8,
                      help="scenario count K of the two-stage instance "
                      "(kind=scenario; --m/--n are the recourse block shape)")
    ap_g.add_argument("--seed", type=int, default=0)
    ap_g.add_argument(
        "--density", type=float, default=None,
        help="kind=block: the blocks' and linking rows' density (default: the generator's 0.3; "
        "the pds classes use 0.005)",
    )
    ap_g.set_defaults(fn=cmd_generate)

    args = ap.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
