"""Repo-specific graftcheck tuning: which scopes are hot, which modules
may narrow precision, which programs must donate, and the JSONL record
schema catalogue. Rules read these tables; changing project policy means
editing here, not the rule logic.
"""

from __future__ import annotations

# -- host-sync (rules_jit) ---------------------------------------------------
# Function scopes where a host↔device synchronization is a pipeline
# stall: the serve dispatcher's pack/solve thread bodies (a sync there
# serializes the two-deep pipeline) and the IPM driver's
# per-iteration loop (a sync there caps iters/sec). Keys are
# package-relative paths; values are qualnames ("Class.method" or bare
# function names). Deliberate sync points inside these scopes carry
# line-level ``# graftcheck: disable=host-sync`` comments explaining why.
HOT_SCOPES = {
    "serve/service.py": {
        "SolveService._run_pack",
        "SolveService._pack_bucket",
        "SolveService._run_solve",
        "SolveService._dispatch",
        "SolveService._dispatch_bucket",
    },
    "ipm/driver.py": {
        "solve",
        "_step_once",
    },
    # Network serving plane thread bodies: the router's poll loop and
    # forward path run concurrently with every backend's pipeline, and
    # the HTTP front-end's handler/health threads must never touch a
    # device value (all device work stays on the service's pipeline
    # threads — a sync here would serialize handler threads behind it).
    "net/router.py": {
        "Router._poll_loop",
        "Router.poll_once",
        "Router._record_probe",
        "Router.forward",
        # Hedge legs run on their own threads concurrently with the
        # client-facing forward — same no-device-value contract.
        "Router._forward_hedged",
        "Router._attempt_result",
        "Router._cancel_loser",
    },
    "net/server.py": {
        "SolveHTTPServer.health",
        "_Handler.do_POST",
        "_Handler.do_GET",
    },
}

# -- jit-donate (rules_jit) --------------------------------------------------
# Programs whose big per-call buffers are consumed by the call and dead
# afterwards; their jit definitions must carry donate_argnums so the
# device reuses the buffers in place. NOT in this table (deliberately):
# the fused bucket program's INPUTS (_solve_bucket_jit) — they are
# re-dispatched verbatim on batch retry and shared with warm-up calls,
# so donating them would poison the retry path; and A/data of the
# segment programs, which are loop-invariant across segments. The bucket
# SEGMENT carry (_bucket_segment_jit) is internal to one dispatch and
# rebound per segment, so it donates like the batched one.
DONATE_EXPECTED = {
    # (pkg_path, function name) -> human description of the donated arg
    ("backends/batched.py", "_batched_segment_jit"): "carry (arg 2)",
    ("backends/batched.py", "_bucket_segment_jit"): "carry (arg 2)",
    ("backends/dense.py", "_eg_scale_reg"): "M (arg 0)",
}

# -- dtype rules (rules_dtype) -----------------------------------------------
# Package dirs where every jnp constructor must pin its dtype: these are
# the device-math layers where "whatever the default is" has already
# produced silent f32-on-TPU / x64-flag surprises.
DTYPE_SCOPE_DIRS = ("ops", "ipm", "backends")

# jnp constructors and the positional index their signature accepts
# dtype at (the repo writes both ``jnp.zeros(n, jnp.f32)`` and
# ``dtype=``). ``*_like`` variants inherit and are exempt; ``arange`` is
# exempt — its int default is the index-arithmetic convention here.
DTYPE_CONSTRUCTORS = {
    "zeros": 1,
    "ones": 1,
    "empty": 1,
    "full": 2,
    "eye": 3,
    "identity": 1,
    "array": 1,
    "asarray": 1,
}

# Modules sanctioned to narrow f64→f32: the mixed-precision schedule
# owners (ROUND5_NOTES — the f32-gram/f64c and df32 schedules, the
# two-phase f32 factorization ladder, and the MXU panel kernels).
# Anywhere else, an ``.astype(float32)`` is a silent precision loss the
# two-phase design never sanctioned.
NARROW_SANCTIONED = {
    "ops/chol_mxu.py",
    "ops/df32.py",  # the two-float layer: every df32 narrowing lives there
    "ops/normal_eq.py",
    "backends/dense.py",
    "backends/block_angular.py",
    "backends/batched.py",
    # Huge-sparse tier: the ELL operator stores int32 column indices and
    # may down-convert cached f64 value arrays to the configured solve
    # dtype; the PCG preconditioners build f32 probe factors for the
    # loose (early-μ) forcing-sequence solves.
    "ops/sparse.py",
    "ops/pcg.py",
}

# -- JSONL schema (rules_schema) ---------------------------------------------
# Event types the telemetry streams may carry (IterLogger.event payloads
# and RequestResult.record). ``cli report`` and the autotuner dispatch on
# these; an uncatalogued type is invisible to every consumer.
JSONL_EVENT_TYPES = {
    "batch",
    "dispatch_error",
    "fault",
    "ladder_swap",
    "reject",
    "request",
    "reshard",
    "resume",
    "service",
    "warmup",
    "warmup_error",
    # Network serving plane (net/): one record per HTTP request on a
    # front-end, per routed forward on the router, and per backend
    # rotation change (ejection on failed health / forward, re-admission
    # on recovery).
    "http_request",
    "route",
    "backend_ejected",
    "backend_readmitted",
    # Crash-safe serving fabric: one record per journal recovery pass
    # (serve/service._replay_journal), per drain phase transition
    # (begin/end/listener_close), and per applied shared-registry
    # mutation (net/registry.py).
    "journal_replay",
    "drain",
    "registry_write",
    # Multi-host runtime (distributed/): one record per coordinator-
    # level world re-initialization (launcher.WorldSupervisor — a dead
    # rank kills the world as a unit, recovery relaunches a smaller
    # one), per slice self-registration into the shared backend
    # registry, and per registry liveness beat where a stream consumer
    # wants them (cli serve-slice).
    "world_reinit",
    "slice_register",
    "heartbeat",
    # Closed-loop elasticity (serve/elastic.py, net/admission.py
    # BrownoutController, net/router.py circuit breaker): one record per
    # controller scale action (or vetoed intent), per brownout-ladder
    # stage transition, and per breaker state change on a backend.
    "scale_out",
    "scale_in",
    "scale_veto",
    "brownout_enter",
    "brownout_exit",
    "breaker_open",
    "breaker_close",
    # Tail tolerance (net/router.py, net/server.py, serve/service.py):
    # one record per hedge resolution (launched hedges only — the
    # suppressed ones surface through router_hedges_total and the
    # statusz ledger), per cancellation (router loser-cancel AND the
    # backend's queue-removal), per unfunded retry-budget spend, and
    # per expired-on-arrival deadline rejection at a backend.
    "hedge",
    "cancel",
    "retry_budget",
    "deadline_expired",
}

# Every field a stamped JSONL record may carry, across all streams: the
# stamp_record fields, iteration-row fields (ipm.state.IterRecord), the
# serve request/batch/service records, and the supervisor fault/resume
# events. The checker flags literal keys outside this set — adding a
# field is fine, but it must be catalogued here (and picked up by
# obs/report) in the same change.
JSONL_FIELDS = {
    # stamp_record
    "schema_version",
    "t_mono",
    "ts",
    # IterRecord rows
    "alpha_d",
    "alpha_p",
    "dinf",
    "dobj",
    "gap",
    "iter",
    "mu",
    "pinf",
    "pobj",
    "rel_gap",
    "sigma",
    "t_iter",
    # event discriminator
    "event",
    # serve request records (serve/records.py RequestResult.record)
    "bucket",
    "compile_ms",
    "dispatch",
    "faults",
    "id",
    "iterations",
    "m",
    "n",
    "name",
    "objective",
    "overlap_ms",
    "pack_ms",
    "padding_waste",
    "queue_ms",
    "retried_solo",
    "slot",
    "solve_ms",
    "status",
    "total_ms",
    # serve batch/fault/lifecycle events (serve/service.py)
    "action",
    "attempts",
    "buckets",
    "cache",
    "detail",
    "devices",
    "excluded",
    "fused_iters",
    "kind",
    "live",
    "mesh_devices",
    "metrics",
    "migrated",
    "misfits",
    "occupancy",
    "queue_depth",
    "schedule",
    "tol",
    # warm-start & amortization layer: request records carry the
    # "warm"/"rejected"/"cold" start label, batch events the number of
    # warm-started slots (serve/service.py, serve/records.py)
    "warm",
    # huge-sparse tier (tolerance-tiered serve ladder + inexact IPM):
    # request/batch records carry the solve engine ("ipm"|"pdhg"),
    # sparse-iterative iteration rows/bench rows the PCG iteration count
    # and the resolved preconditioner (jacobi/block/bordered)
    "engine",
    "cg_iters",
    "precond",
    # row-sharded matrix-free tier: cg_report/bench rows carry the row
    # shard count and the per-CG-iteration psum count (1 n-vector
    # all-reduce when sharded, 0 single-device); ``precond`` gains the
    # "ildl" value (incomplete-LDLᵀ escalation). block_angular phase
    # records/A-B harness rows stamp the per-phase program class
    # (oneshot vs K-grouped f64 — backends.block_angular.
    # phase_program_class)
    "shards",
    "psum_per_iter",
    "program_class",
    # stochastic scenario tier: scenario-request records carry the
    # scenario count, the padded scenario-count bucket
    # (models/scenario.scenario_k_bucket), and the decomposition's
    # stage split — batched per-scenario Schur wall vs first-stage
    # linking wall (serve/records.py, backends/scenario.py)
    "n_scenarios",
    "scenario_bucket",
    "schur_ms",
    "link_ms",
    # network serving plane (net/): http_request records (method/path/
    # code/ms), admission-verdict reject records (tenant/priority/
    # reason/retry_after_s), router route records (backend/padding/
    # retried) and rotation events (fails), and the summary event's
    # per-tenant admission table
    "admission",
    "code",
    "fails",
    "method",
    "ms",
    "path",
    "priority",
    "reason",
    "retried",
    "retry_after_s",
    "tenant",
    # supervisor fault/resume events (supervisor/supervisor.py)
    "backend",
    "iteration",
    "recovery_overhead_s",
    "t",
    # crash-safe serving fabric: journal_replay tallies (replayed/
    # re-enqueued/expired-honest-TIMEOUT/failed-spec, torn/skipped WAL
    # lines, result files re-bound), drain phases (begin/end/
    # listener_close + drained verdict + in-flight count), and
    # registry_write records (ejected flag, file generation, writer id)
    "replayed",
    "reenqueued",
    "expired",
    "failed",
    "torn",
    "skipped",
    "results",
    "phase",
    "inflight",
    "drained",
    "ejected",
    "generation",
    "writer",
    # multi-host runtime (distributed/, cli serve-slice, supervisor
    # probe-fault attribution): which process observed/emitted the
    # record, the world it belonged to, and the logical slice — stamped
    # on world_reinit / slice_register / heartbeat events and on
    # supervisor fault records (probes only see addressable devices, so
    # the rank scopes the evidence).
    "rank",
    "world_size",
    "slice_id",
    # graftcheck v2 catalogue-drift audit: jsonl-fields now also checks
    # literal payloads routed through stamp_record(...), which brought
    # two stamped streams the lexical rule never saw into coverage —
    # the job-journal WAL (serve/journal.py: the "j" lifecycle
    # discriminator and its admitted-record fields) and the per-rank
    # heartbeat files (distributed/world.py: writer pid, merged into
    # the world's JSONL view post-mortem).
    "j",
    "jid",
    "fp",
    "spec",
    "nonce",
    "next_seq",
    "stage",
    "deadline_ts",
    "pid",
    # closed-loop elasticity: scale_out/scale_in/scale_veto events carry
    # the pool size after the action and the controller's target; the
    # breaker_open event attributes its trip (observed error rate over
    # the outcome window, hold before the half-open probe).
    "pool",
    "target",
    "error_rate",
    "backoff_s",
    # tail tolerance: hedge events carry the primary backend, the delay
    # that fired, and the resolution outcome; route events flag hedge
    # legs; cancel events carry the cancellation state verdict; the
    # backend's deadline_expired rejection records the (zero) budget
    # that arrived.
    "primary",
    "delay_ms",
    "outcome",
    "hedge",
    "state",
    "remaining_ms",
    # Distributed tracing (obs/context.py): request/hedge/route records
    # stamp the W3C-shaped trace identity (trace_id + the emitting hop's
    # span_id + its parent), journal WAL records carry the wire-form
    # header under ``trace`` so replays resume the ORIGINAL trace, batch
    # events list every member request's trace under ``trace_ids``, and
    # JSON histogram snapshots carry the slowest observation's trace as
    # an ``exemplar`` — the keys the fleet aggregator (obs/agg.py)
    # stitches cross-process Perfetto flows and exemplar tables from.
    "trace_id",
    "span_id",
    "parent_span_id",
    "trace",
    "trace_ids",
    "exemplar",
}

# ``X.write(json.dumps(...))`` record emission points that must stamp:
# every JSONL stream a consumer merges needs schema_version/ts/t_mono.
# (Chrome-trace and metric-snapshot files use ``json.dump(obj, fh)`` and
# are whole-file JSON, not JSONL records — the pattern doesn't match
# them, by design. HTTP response bodies are ``json.dumps(...).encode()``
# bytes and exempt by the same token: they are replies, not stream
# records.)

# -- SPMD rules (rules_spmd) -------------------------------------------------
# The multi-host contract (distributed/world.py): every rank of a world
# executes a bit-identical program sequence. Three statically visible
# ways to break it, each with its own rule family below.

# Environment keys whose values differ per rank (distributed/world.py
# env contract) — reading one is a rank-taint source exactly like
# ``jax.process_index()`` or ``world.rank``.
RANK_ENV_KEYS = {"DLPS_RANK"}

# Calls that are (or dispatch) world collectives: every rank must reach
# them in the same order with the same static arguments. A rank-derived
# branch guarding a path into one of these is the
# every-follower-hangs-in-the-collective bug class.
COLLECTIVE_CALLS = {
    "barrier",
    "allgather",
    "agree",
    "sync_global_devices",
    "process_allgather",
    "psum",
    "pmean",
    "put_global",
    "host_values",
    "host_value",
    # bucket-program dispatch: the collective lives inside the compiled
    # program, so dispatching it IS reaching a collective
    "solve_bucket",
    "solve_pdhg_bucket",
    "execute_dispatch",
}

# Deliberate rank-divergence seams — the rank-0-publish /
# follower-execute architecture (distributed/slice.py): both sides of
# the branch execute the SAME dispatch sequence, one via the
# SolveService, one via the control-plane journal, so the divergence is
# the design, not a bug. Entries are (pkg_path, qualname).
SPMD_SANCTIONED = {
    # cli serve-slice: rank 0 runs the HTTP front-end + SliceRunner,
    # followers run follower_loop — the two sides reach the collectives
    # through the one shared execute_dispatch path, in journal order.
    ("cli.py", "cmd_serve_slice"),
}

# Order-insensitive consumers: a directory scan wrapped in one of these
# never feeds iteration order anywhere, so it is exempt from
# spmd-unordered-dispatch.
ORDER_SAFE_CONSUMERS = {
    "sorted",
    "set",
    "frozenset",
    "len",
    "sum",
    "min",
    "max",
    "any",
    "all",
}

# Order-sensitive sinks: a call reaching one of these from inside a
# loop over an unordered collection publishes the iteration order to
# the rest of the world (dispatch journals, JSONL streams, registry
# merges, jit cache warm order).
ORDER_SINKS = {
    "publish",
    "publish_stop",
    "event",
    "dispatch",
    "execute_dispatch",
    "solve_bucket",
    "solve_pdhg_bucket",
    "warm_buckets",
    "put_global",
    "record",
    "register",
}

# Committed-placement helpers (spmd-uncommitted-input): host data enters
# a multi-process program ONLY through these — they materialize each
# process's addressable shards against the global mesh. A bare
# ``jax.device_put(x)`` / ``jnp.asarray(x)`` commits to the default
# device instead and breaks the program's sharding contract on a pod.
COMMITTED_PLACERS = {
    "put_global",
    "place_bucket",
    "place_warm",
    "batch_sharding",
    "col_sharding",
    "vec_sharding",
    "make_array_from_callback",
    # ops/sparse.py: builds the row-sharded hybrid-ELL operator with
    # every leaf placed against the global mesh (shard axis leading).
    "shard_rows",
}

# Calls that take a ``mesh=`` keyword and compile/execute against it —
# the sinks the uncommitted-input rule guards.
MESH_PROGRAM_SINKS = {
    "solve_bucket",
    "solve_pdhg_bucket",
    "execute_dispatch",
    "solve_batched",
}

# -- deadlock rules (rules_locks) --------------------------------------------
# Blocking operations that must not run while a lock is held: a
# collective blocks until EVERY rank arrives (seconds to forever), an
# HTTP round-trip or fsync blocks on I/O, subprocess waits on another
# process, Future.result on another thread. Any of them under a lock
# extends the lock's hold time from nanoseconds to unbounded — the
# pipeline-stall / deadlock-feeding class. Terminal call names.
BLOCKING_CALLS = COLLECTIVE_CALLS | {
    "urlopen",
    "fsync",
    "sleep",
    "Popen",
    "check_call",
    "check_output",
    "communicate",
}

# Deliberately-blocking-under-lock seams, (pkg_path, qualname) — a bare
# class name sanctions every method of that class:
BLOCKING_SANCTIONED = {
    # The slice dispatch lock IS the cross-rank ordering contract:
    # publish order must equal execute order, so the collective runs
    # under the lock by design (distributed/slice.py module doc).
    ("distributed/slice.py", "SliceRunner"),
    # The WAL's append ordering + fsync durability is the journal's
    # whole contract: appends are one small write each and the lock IS
    # the WAL order, and compaction must be atomic against appends
    # (serve/journal.py module doc). Only these two methods are
    # sanctioned — the bounded result-store write in finish() was moved
    # OUT of the lock when this rule was added.
    ("serve/journal.py", "JobJournal._append_locked"),
    ("serve/journal.py", "JobJournal.compact"),
    # flush()/close() are the drain path's explicit force-to-disk
    # calls; the lock is the WAL order they are flushing.
    ("serve/journal.py", "JobJournal.flush"),
    ("serve/journal.py", "JobJournal.close"),
    # IterLogger/Tracer emit one small flushed write per record under
    # their own lock — that lock exists only to serialize the stream,
    # never wraps device work, and fsync mode is opt-in diagnostics.
    ("utils/logging.py", "IterLogger"),
}

# -- the torch package's own entries -----------------------------------------
# Designs of this package that the JAX package does not have. Each entry
# names its design and why the rule's concern does not hold there.

JSONL_FIELDS |= {
    # batch events (serve/service.py): whether the dispatch's device
    # loop ran as a captured CUDA graph (None where nothing was captured)
    "captured",
    # warmup events (serve/service.py): the kernel build directory a
    # bucket build reads and writes; ``cache`` says whether it wrote
    "cache_dir",
}

SPMD_SANCTIONED |= {
    # The serving slice's rank-0-publish / follower-execute seam from the
    # service's side: the service runs on rank 0 alone and sends every
    # bucket dispatch through SliceRunner.dispatch, which the followers
    # replay from the journal in order. Its per-request path (_solo) runs
    # under parallel.runtime.rank_local(), so the solve it calls enters
    # no world collective.
    ("serve/service.py", "SolveService._dispatch_bucket"),
    # Every rank of a world runs the same supervised plan: the faults,
    # the shrink's survivor ids and the degradation target are computed
    # alike on each (the shrink's re-form is itself a collective of the
    # whole world), and the backend's mesh hands every rank the same
    # step statistics. A solve that one rank runs alone does so under
    # parallel.runtime.rank_local(), where no world collective is entered.
    ("supervisor/supervisor.py", "supervised_solve"),
}

BLOCKING_SANCTIONED |= {
    # load_library() holds _lib_lock across the one nvcc build of its
    # kernel library, so that two threads never build (and write) the
    # same library; every later call returns the loaded one at once.
    ("ops/normal_eq.py", "load_library"),
    ("ops/ell_spmv.py", "load_library"),
}
