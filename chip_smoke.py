#!/usr/bin/env python3
"""Smoke run of the torch package (distributedlpsolver_tpu_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and fails (non-zero exit, no result line) without one. It:

1. prints the card (``nvidia-smi`` name and power limit), builds both
   kernels (normal equations, sliced-ELL SpMV) from
   ``distributedlpsolver_tpu_torch/csrc`` into ``build/dlps_torch/``, one
   ``nvcc`` per source started together, prints nvcc's
   register/shared-memory report, and
   counts the ``DMMA`` (FP64 tensor-core) instructions in the f64
   kernel's SASS and the ``HMMA`` TF32 ones in the f32 kernel's
   (``cuobjdump -sass``); none in either is a failure. From the build
   on, the port's static-analysis gate (``python3 -m
   distributedlpsolver_tpu_torch check --json`` over the package, in a
   subprocess with a 120 s limit, host only) runs beside the build and
   step 2's parity checks, and is awaited before any timed step; any
   exit code but 0 fails the run, and a ``graftcheck`` line prints its
   findings (0), the suppressed count and its seconds;
2. holds the kernel's lower triangle against its plain PyTorch version's
   on the card, in f32 against the exact product of the same inputs
   (``normal_eq_exact``, summed in f64: the f32 plain version's own sum can
   lie ~1e-5 from it) (the kernel mirrors it into the upper half;
   Frobenius-relative error ≤ 1e-12 f64, ≤ 1e-5 f32, ≤ 1e-4 bf16, and in bf16 at most a
   tenth of the distance to the product taken without rounding A·d to
   bf16) at the main path's shape 2048×10240, a ragged 1000×3001 (odd
   n), one row past two tiles (2·edge+1 rows), and in f64 at the
   reference shape 10000×50000; at each, M must equal Mᵀ bit for bit
   and a second launch must give the same bits;
3. times the kernel, its plain version and one library call
   (``torch.einsum``) with CUDA events after warm-up, beside the bound
   ``max(m·(m+1)·n / peak FLOP/s, bytes / 3.35 TB/s)`` (M is symmetric:
   its lower triangle is all the work the function needs) and the bound
   share (bound over kernel time), in f32 the f32 design's own bound
   (3·m·(m+1)·n flops at the TF32 tensor cores' 494.7 TFLOP/s, the lesser)
   with the CUDA-core one beside it (``cuda_core_bound_ms``),
   in f64 with the split over k the launch takes (``split_count``); and
   holds K1's f32 M to the f64 product of the same f32 inputs: no farther
   than one cuBLAS f32 product (TF32 off), Frobenius-relative and on the
   diagonal (``f32_exact_check``; again on the PCG and two-phase paths'
   A);
4. drives the main path, ``solve(random_dense_lp(2048, 10240, seed=0),
   backend="cuda")`` at tol 1e-8 — the fused loop, one captured CUDA
   graph of the Mehrotra step replayed by the host — with the kernel's
   launch count reset just before and read just after (it must equal 1
   for the starting point plus the loop's bodies, at most 2 of them past
   the exit), checks the answer on the host in numpy, solves a 256×1024
   problem against HiGHS, and solves the main path again warm (same
   iterations, objective within 1e-9 relative);
5. solves the main path with the host loop (``fused_loop=False``) and
   host-segmented (``segment_iters=4``): same status and iterations as
   the fused loop, objective within 1e-12 relative, launches equal to the
   factorizations; prints whether x is bitwise equal. A cold solve (the
   first in a process) of the fused loop runs in a fresh process
   (``chip_smoke.py --one-solve``). The zero-row LP
   (presolve off, no regularization) must end ``numerical_error`` at 0
   iterations through the fused loop;
6. runs the CLI, ``cli solve tests/fixtures/maximize.mps --backend cuda``;
7. profiles a warm main-path solve of the fused loop with
   ``torch.profiler`` (the host loop's profile was cut for the script's
   time): device busy ms, idle share, host-clock solve s, device
   operations and host launch calls per solve, and the device-time
   breakdown by kernel (no Chrome trace is written: nothing read them,
   and writing them cost the run's time);
8. the batched solver (``backends/batched.py::solve_batched``), with
   vmap's per-sample fallback off: K1 with a lane axis at the full width
   (1024 lanes of 128×512, f64) and on a ragged batch of 3 lanes of
   100×333 (odd m·n) in all three types — every lane bit for bit the
   unbatched kernel on its inputs, the lower triangle within the
   tolerances above of the batched plain version, M = Mᵀ and two launches
   bit for bit — timed beside its bound and ``torch.einsum``; then
   ``solve_batched(random_batched_lp(1024, 128, 512, seed=0), tol=1e-8)``
   cold and warm on the default configuration (one captured graph of the
   vmapped step), segmented (``segment_iters=8``: same statuses,
   objectives within 1e-9) and in the JAX package's TPU schedule
   (``chunk=256, segment_iters=8``: every member OPTIMAL), each with its
   K1 launches held to a start a chunk + its bodies (+ the solo
   cleanup's bodies);
   every member OPTIMAL at rel_gap ≤ 1e-8 and pinf ≤ 1e-7, or left at the
   iteration limit with its budget spent (the JAX package's verdict);
   every 32nd member, and any left unfinished, against HiGHS (1e-8) and
   the dense solo solve on the card (1e-8, both stopping at a 1e-8 gap);
   and a profiled warm solve;
9. the serve phase (``serve/service.py::SolveService`` over
   ``backends/batched.py::solve_bucket``) at the batched member width,
   every request padded into the bucket (128, 512, 256): K1 at the bucket
   shape (256 lanes of 128×512, f64) against its plain version and
   ``torch.einsum``; then ``SolveService(ServiceConfig(batch=256,
   flush_s=0.02))`` on the card driven with three waves — a cold
   ``random_request_stream(1024, shapes=((96, 384), (128, 512)),
   seed=21)``, a warm one of 512 (``seed=22``) and
   the first 256 of ``correlated_request_stream(512, shapes=((128, 512),),
   n_models=4, seed=23)`` — with the K1 count reset just before each wave and read
   just after: every request OPTIMAL, or at the iteration limit with its
   bucket's and its solo solve's budgets spent (the JAX package's verdict
   for such a request), every 32nd against HiGHS (1e-8; HiGHS at
   feasibility tolerances of 1e-10), no
   bucket program built and no graph captured over the warm and
   correlated waves, warm starts taken in the correlated wave, and the K1
   launches of each dispatch equal to its start + warm selection +
   bodies; printed per wave: requests/s, p50/p99 latency, pack / compile /
   solve / overlap ms, padding waste, bodies per dispatch, solo
   fallbacks and peak device memory; then a fourth wave of 256 requests
   under ``torch.profiler`` (device busy ms and idle share of its wall).
   And ``cli serve --requests`` on 8 requests of 128×512 in a
   subprocess, all ``optimal`` (started right after the build, beside the
   gate, and awaited with it before step 3);
10. the default backend of the CLI and the service, ``auto``:
   ``solve(random_dense_lp(2048, 10240, seed=0), backend="auto")`` must
   report ``auto(cuda)``, give x bit for bit equal to ``backend="cuda"``
   (``solve()``'s default, as ``tpu`` is the JAX package's) and launch K1
   as often (1 + bodies); ``cli solve`` with no ``--backend`` on a
   256×1024 MPS file must report ``auto(cuda)`` and the x of
   ``backend="cuda"``;
11. the route table: ``choose_backend_name`` on the card for every input
   the smoke solves (the MPS fixtures, the main path, a 128×512 request,
   batched member 775) — ``cuda`` for each, where the JAX package's
   accelerator route sends the small ones to the host — the fixtures
   solved by ``auto`` to check that the route taken is the route printed;
12. the solo cost on both routes: the cold serve stream's straggler
   (request 1007) solved alone by the supervised solo path on the
   ``cuda`` host loop and, asked for by name, on ``cpu-native`` (CPU
   numbers, with the host's CPU model and the native library's threads),
   and each again unsupervised;
13. in the serve phase (step 9), under the JAX package's default
   ``ServiceConfig(batch=256, flush_s=0.02)`` (solo ``auto``, PDHG
   routing on): the three waves' solo fallbacks on ``auto(cuda)``, the
   cold wave's last 256 requests (its straggler among them) again with
   ``solo_backend="cpu-native"`` (the host route, asked for by name), and
   the PDHG wave —
   ``warm_buckets(..., tol=1e-4)``, then ``sparse_request_stream(1024,
   seed=25)`` at tol 1e-4 with ``random_request_stream(64, seed=26)`` at
   1e-8 interleaved: every loose request on engine ``pdhg`` and every
   tight one on ``ipm``, no program built and no graph captured during the
   wave, every OPTIMAL PDHG answer at pinf, dinf and gap ≤ 1e-4 recomputed
   on the host on the problem the engine solved (the request padded into
   its bucket) and, on the request's own data, within the bound
   ``PDHG_REQUEST_KKT_BOUND``, the (engine, status) of every request the JAX package's
   (``scripts/port_serve_jax_verdicts.py --streams pdhg``), crossovers
   counted, ms a body against the bytes bound;
14. the solo PDHG engine: ``solve(random_dense_lp(2048, 10240, seed=0),
   backend="pdlp", tol=1e-4)``, fused: inner iterations, steps/s, status,
   the KKT errors on the host of the returned iterate mapped into the
   presolved, scaled form the verdict is taken on (an OPTIMAL verdict must
   meet the tol there; the iteration limit is an allowed outcome); then
   its column mesh asked for by ``mesh_shape=(1,)`` on an NCCL world of
   one in this process (``pdlp_mesh_nccl1``): x bit for bit and the inner
   steps of that answer, the loop captured with its all-reduces inside,
   ms a body beside the solo one's (the gloo world of 2 rides step 20's);
15. no hidden fallback: any supervisor degradation (outside the ladder
   check of step 16), or a solo request served by another backend than its
   route names, fails the run;
16. the matrix-free sparse tier (``sparse_phase``; ``--sparse-only``
   runs the build and this phase alone): the stormG2_1000-shape instance
   ``storm_sparse_lp(**STORM_FULL)`` (528,000 × 1,259,121), its host setup
   timed by part (generation, interior form, Ruiz on CSR, ``from_scipy``,
   the bordered preconditioner's symbolic setup); the sliced-ELL kernel
   (``ops/ell_spmv.py``) for A·v, Aᵀ·v and diag(A·D·Aᵀ) against its plain
   version on that operator and on ``netlib_sparse_lp(20000, 40000,
   seed=3)`` (relative error ≤ 1e-12, two launches bit for bit), timed
   beside its bound (the bytes of the matrix's live entries, its row
   pointers and the two vectors) and cuSPARSE (a ``torch.sparse`` CSR
   product of the same matrix), paced by the host, then queued with the
   L2 flushed before each launch, kernel and cuSPARSE in turns;
   its layout's bytes printed and held to 1.10 of the bound; the
   full-shape instance through ``solve(p, backend="auto")`` —
   ``auto(sparse-iterative)``, the bordered preconditioner, OPTIMAL at
   1e-8, the host KKT check on the problem as given (gap ≤ 1e-8), the
   objective within 1e-8 of ``STORM_FULL_OBJECTIVE``, the memory guard (no
   operand near the m×m normal matrix), the kernel's launches counted per
   function and direction, CG iterations, host syncs per Newton solve,
   peak device memory and one step (iteration 10) under
   ``torch.profiler`` (the rows phase's world of one is held to this
   solve bit for bit); the ILDL rung (``netlib_sparse_lp(120, 220,
   seed=10)``, precond "auto"); the ladder (a supervised ``cuda`` solve
   whose injected crashes exhaust its rungs degrades to
   ``sparse-iterative`` on the card; a K1 that fails to load ends in
   ``KernelError``, not degraded); the reference's acceptance instance
   ``storm_sparse_lp(**STORM_20K)`` (the JAX package's iterations,
   preconditioner and objective from
   ``scripts/port_sparse_jax_verdicts.py``, HiGHS in a side process
   within 1e-7 (in a whole run started before step 17), the memory
   guard; the rows phase's gloo worlds are held to this solve);
17. the network plane (``plane_phase``; ``--plane-only`` runs the build
   and this phase alone), at the serve configuration's width (f64, tol
   1e-8, the bucket (128, 512, 256), ``ServiceConfig(batch=256,
   flush_s=0.02)``): (a) in process, two ``SolveService``s on the card,
   each after ``warm_buckets`` (IPM at 1e-8, PDHG at 1e-4), each behind a
   ``SolveHTTPServer``, and a ``Router`` + ``RouterHTTPServer`` over both;
   64 client threads POST to the router the first 128 of the serve
   phase's cold stream as generated specs, 16 inline ``c/A/b`` bodies and
   4 ``mps_text`` bodies (``random_request_stream(20, seed=26)``), and the
   PDHG wave's first 16 loose requests at tol 1e-4, interleaved (164
   requests: the wave's depth is cut from 1,232, then 308, to keep the
   whole script within half its limit; the widths are the serve cell's); every answer OPTIMAL
   or the JAX package's verdict, every 32nd IPM answer against HiGHS
   (1e-8), every OPTIMAL PDHG answer within the tol on its padded problem
   and ``PDHG_REQUEST_KKT_BOUND`` on its own data, K1's launches (reset
   before the wave, read after) equal to the IPM dispatches' start + warm
   selection + bodies, no program built and no graph captured, and
   ``/healthz`` ``devices_healthy: 1`` from the torch probe on each
   backend; printed: requests/s, p50/p99 through HTTP, the routed counts,
   and the same 128 generated requests through ``svc.submit`` on a fresh
   service. (b) As processes: two ``cli serve-http`` backends (``--device``
   defaulting to the card, ``--buckets`` + ``--warm-buckets``,
   ``--registry``, journals) and ``cli route --registry``; 32 async
   requests through the router, ``kill -9`` of one backend mid-wave and a
   relaunch of its command line: every id resolves ``optimal`` or
   ``timeout`` (never 404), zero duplicate solves in the journals; ``cli
   obs-agg`` before the crash (16 routed requests, every reconciliation
   check ``ok``) and after it (the router's attempts balance the records
   once the records be-a lost with its process are counted from its
   journal; consistent exactly when it lost none); then each backend's
   ``/statusz`` K1 launches > 0, a drain by ``/quitquitquit``, ``cli
   report`` over the backends' logs; and ``cli elastic --min-backends 1
   --max-backends 2`` (started beside the two backends, so that its first
   backend comes up with theirs, and driven beside the steps after them)
   scales out under a burst and back in after it. In a whole run step
   21's ``cli serve-slice`` leg runs beside (b), and HiGHS's side process
   for step 16 starts before this step;
18. the block-angular tier (``block_phase``; ``--block-only`` runs the
   build and this phase alone), the pds family's classes at full width,
   ``block_angular_lp(K, 432, 1400, link, seed=0, sparse=True,
   density=0.005)``: pds-10 (K 32, link 800; 14,624 × 44,800) through
   ``solve(p, backend="auto")`` twice — ``auto(block)``, OPTIMAL,
   ``max_violation ≤ 1e-6``, the JAX package's status, iterations and
   objective (≤ 1e-8; ``BLOCK_JAX``, from
   ``scripts/port_block_jax_verdicts.py``), within 1e-8 of its recorded
   ``cpu-sparse`` objective, x bit for bit, K1's launches (reset before,
   read after) 1 + bodies for the K lanes and as many for the linking
   matrix — with its setup by part (generation, interior form, the host
   tensors, the transfer to the card), ms an iteration and peak device
   memory, then a third solve under ``torch.profiler``; the same class
   written by ``cli generate block`` and solved by ``cli solve`` with no
   backend (no hint in the file: presolve and ``auto``'s detection pass;
   ``auto(block)``, the JAX package's CLI's status, iterations and
   objective on the same file, within 1e-8 of the recorded objective); the
   pds-20 class (K 64, link 1600; 29,248 × 89,600) through
   ``backend="block"`` twice, the same checks against the JAX package and
   ``SCALE_RUNS.json``'s objective; K1 at the tier's four shapes (the
   lanes K × mb × nb and the linking (link, K·nb + n0) of each class)
   against its plain version (lower triangles ≤ 1e-12, M = Mᵀ and two
   launches bit for bit, each lane the unbatched kernel's bits) and timed
   beside ``torch.einsum`` and its bound, the linking launches split over
   k (``split_count``: every linking launch of a solve counted a split
   one) and the split's sum kernel held bit for bit to its plain version
   (``split_sum_row``) and timed; and the tier on a mesh
   (``BlockAngularBackend(mesh=)``, the K axis over the ranks, the linking
   factor ``ops/dist_chol.py``): pds-10 and pds-20 through the
   ``sharded_cases`` task on one NCCL world of one in this process
   (``block_nccl_legs``) — OPTIMAL, iterations
   within ±2 and the objective within 1e-8 of the mesh=None solves above,
   each answer held by ``sharded_answer_check``, the loop captured with K1
   1 + bodies on the lanes and as many on the linking columns — and the
   same code on a local mesh of one in this process (x bit for bit with
   the world's, the same K1 launches, 1 + 2·P ``Mesh.all_reduce`` calls a
   factorization), with ms an iteration beside mesh=None's; pds-10 over a
   gloo world of 2 sharing the card (both ranks the same x bits, OPTIMAL
   within 1e-8 of mesh=None's objective, 16 blocks a rank, uncaptured)
   and ``supervised_solve`` on ``block`` over a gloo world of 4 with
   DEVICE_LOST of rank 3 at iteration 3 (``shrink:4->3``, K 32 -> 33 over
   3 survivors, their x bits equal, within 1e-8 of mesh=None's objective,
   ``recovery_overhead_s`` printed), in a whole run the world of 2 as a
   world of step 20 and the shrink as a case of step 21's world of 4;
   and K1 at rank 0's
   shares on those worlds (16, 8 and 11 lanes of 432 × 1263; 800 ×
   (K_r·1263 + 5831) linking columns) held and timed as above;
19. the stochastic scenario tier (``scenario_phase``; ``--scenario-only``
   runs the build and this phase alone): the tier's own family at a full
   bucket, ``two_stage_storm(1024, 24, 36, 24, 2, seed=1)`` lowered
   (24,578 × 36,888), its setup by part (generation, lowering, interior
   form, the stacks scattered on the card, the operator's transfer), the
   ELL kernel against its plain version on that operator (as step 16
   holds it; timed beside cuSPARSE), then ``solve(p, backend="auto")``
   twice and once through the ``ScenarioBackend`` and ``solve_scenario``
   — ``auto(scenario)``, 1,024 lanes, OPTIMAL, ``max_violation ≤ 1e-6``,
   the JAX package's status, iterations and objective (≤ 1e-8;
   ``SCENARIO_JAX``, from ``scripts/port_scenario_jax_verdicts.py``), x
   bit for bit across all four, K1 once a factorization over every lane
   and the ELL kernel in both directions (each reset before, read after),
   with the factorizations' Schur/link ms and the CG solves' ms, CG
   iterations by step beside the reference's, host syncs a Newton solve
   and peak device memory, then a fifth solve with its step 10 under
   ``torch.profiler``;
   stormG2's blocks at K = 8 through ``scenario``
   (``storm_sparse_lp(8, 528, 1259, 121, seed=1, t_nnz_per_row=2,
   w_nnz_per_row=4)`` with a ``two_stage`` hint; the same checks, and the
   ELL kernel on its operator); K1 at the main path's lanes (1024 × 24 × 36),
   at the K = 8 path's (8 × 528 × 1259) and over a full bucket at that
   width (1024 × 528 × 1259, which no path runs) against its plain
   version (lower triangles ≤ 1e-12, M = Mᵀ and two launches bit for bit,
   each lane the unbatched kernel's bits), timed beside ``torch.einsum``
   and its bound; ``cli generate scenario --scenarios 64 --m 24 --n 36``
   then ``cli solve`` (no hint in the file: ``auto``'s detection,
   ``auto(scenario)``, the JAX CLI's verdict); a ``SolveService`` on the
   card with the reference's delta wave (median warm iterations below the
   cold ones), a 64-scenario warm-up and K = 33, 49 (one bucket,
   admission units ``ceil(K/16)`` off the tenant's tokens; every
   sixteenth K of 33..64, to fit the script's time), a 64-scenario HTTP body
   (200 OPTIMAL), and ``stats()["scenario"]``, the metrics and ``cli
   report``'s table over the log reconciled; the lane mesh
   (``ScenarioBackend(mesh=)``): the main path through the
   ``scenario_lanes`` task on an NCCL world of one in this process (the
   problem handed over) and on a local mesh of one on ``cuda:0`` — x bit
   for bit with the cold ``auto`` solve, its IPM and CG iterations and K1
   launches, one ``Mesh.all_reduce`` a factorization and two an
   application (every application counted), ms an iteration and the
   member's bytes — and over a gloo world of 2 sharing the card (512 lanes
   a rank; here with ``--scenario-only``, in a whole run a case of step
   20's world): both ranks the same x bits, OPTIMAL, iterations within ±2
   and the objective within 1e-8 of the cold solve's, each answer held by
   ``sharded_answer_check``; K1 at rank 0's lanes (512 × 24 × 36) held and
   timed as above;
20. the column-sharded dense backend (``sharded_phase``;
   ``--sharded-only`` runs the build and this phase alone): the card
   count; K1 at the shard shape of the gloo world of 2 below (f64 2048 ×
   5,120) against its plain version (lower triangle ≤ 1e-12, M = Mᵀ and
   two launches bit for bit), timed beside ``torch.einsum`` and its
   bound; the main path's problem, ``random_dense_lp(2048, 10240,
   seed=0)`` at tol 1e-8, through ``cuda`` and through ``sharded`` on an
   NCCL world of one formed in this process — both OPTIMAL, the same
   iterations and K1 launches (each reset before, read after), x bit for
   bit — with each solve's host setup by part, wall and ms an iteration,
   then three clocked iterations of the sharded step (K1 on the shard,
   the all-reduces, the Cholesky, the rest); then a gloo world of 2 ranks
   sharing the card (``run_world("sharded_cases", ...)``, subprocesses
   waited on with a deadline; any rank's failure fails the run) on the
   same problem with the stage clock: every rank OPTIMAL with the same x
   bits, K1 at its shard's shape, the objective within 1e-8 of
   ``cuda``'s; every answer of the phase held to its problem (row
   violation ≤ 1e-7 × (1 + max |row bound|), rel_gap ≤ 1e-8, host |cᵀx −
   bᵀy| ≤ 1e-7 relative); at the same time a second gloo world of 2
   solves step 14's problem through pdlp with ``mesh_shape=(2,)`` (5,120
   columns a rank,
   uncaptured: both ranks the same x bits, OPTIMAL, step 14's host KKT
   checks on the scaled form at the tol and ``PDHG_REQUEST_KKT_BOUND`` on
   the given data, the objective within 2·tol·(1 + |obj|) of the solo
   answer's; with ``--sharded-only`` the solo answer is solved here) and,
   in a whole run, a third runs steps 18 and 19's gloo cases (and the
   second, step 25's; the NCCL world of one also carries step 25's (a)–(c));
   with two cards or more, an NCCL world over the cards on the same problem.
   (``BASELINE.json`` config 3, 10000 × 50000, is not solved here: K1 at
   that shape is held and timed in steps 2–3; its solve, host presolve
   and scaling ~25 s of a ~30 s wall, and the world of 4, the shrink's in
   step 21 runs that split, were cut to keep the script within its time
   limit on a slower host);
21. the serving slice and the elastic shrink (``slice_phase``;
   ``--slice-only`` runs the build and this phase alone): K1 at a rank's
   lane block of the serve bucket over a world of 2 (f64 128 × 128 × 512)
   against its plain version and timed beside ``torch.einsum`` and its
   bound; ``bucket_probe`` (``random_batched_lp(256, 128, 512, seed=0)``
   then ``seed=1``, f64, tol 1e-8, every lane active) on an NCCL world of
   one and a gloo world of 2 ranks sharing the card, each rank solving
   its lane block through its own captured program and one all-reduce
   gathering the bucket: no build or capture on the second dispatch, the
   cache sizes equal on every rank, K1 = start + warm selection + the
   rank's bodies, lane by lane the one-process dispatch's status and
   iterations with objectives within 1e-8 (the world of one x bit for
   bit), the gathered x equal on both gloo ranks (the lanes bit for bit
   with the one-process dispatch counted); at the same time as those two
   worlds, the SHRINK rung on ``sharded`` over a gloo world of 4
   (``random_dense_lp(2048, 10240, seed=0)``, DEVICE_LOST of rank 3 at
   iteration 3: ``shrink:4->3``, OPTIMAL within 1e-8 of ``cuda``'s
   objective, the survivors' x bits equal, each survivor's answer held to
   the problem; with ``min_devices=4``: ``degrade:cuda``; in a whole run
   step 18's block shrink is its third case) and (with ``--slice-only``;
   in a whole run beside step 17's ``cli`` processes) ``cli
   serve-slice --world-size 2 --pg-backend gloo`` behind its HTTP
   front-end with a registry: the first 48 of the serve phase's cold
   stream through 64 clients (every answer OPTIMAL, every 32nd against
   HiGHS), then 32 async requests and a SIGKILL of rank 1 — the world
   dies as a unit, the supervisor relaunches a world of one on the same
   port and journal (``world_reinit`` with ``recovery_overhead_s``),
   every acknowledged id resolves, no duplicate solve;
   ``ServiceConfig(mesh_devices=cards + 1)`` raises naming the card count;
22. the row-sharded matrix-free tier (``rows_phase``; ``--rows-only``
   runs the build and this phase alone): the ``sparse_rows`` task on
   STORM_FULL on an NCCL world of one in this process (stormG2_1000's
   shape, 528,000 ×
   1,259,121, not cut; ``SparseIterativeBackend(mesh=world.mesh())``)
   against the ``mesh=None`` solve of the same problem (step 16's
   unprofiled ``auto`` solve, the same code; in this phase's own run with
   ``--rows-only``) —
   OPTIMAL, x and y bit for bit (their SHA-256s), the same IPM and CG
   iterations, the objective within 1e-8 of ``STORM_FULL_OBJECTIVE``, the
   answer held to the problem (``sharded_answer_check``), with its s a
   step, host setup by part, solve and per-device operand bytes; the ELL
   kernel on rank 0's block of a ``ROWS_SPLIT``-way split of the scaled
   full-shape A (A_r·v, A_rᵀ·v and the diagonal against their plain
   versions at ``ELL_TOL``, every empty row of A_rᵀ·w an exact +0, timed
   paced and L2-cold beside cuSPARSE and the bound) and the block's
   memory against the whole operator's; then two gloo worlds at once,
   sharing the card, at the 20,480-row acceptance instance (held to step
   16's ``mesh=None`` solve of it): ``sparse_rows`` over 2
   ranks (every rank OPTIMAL at the ``mesh=None`` solve's IPM iterations
   and objective within 1e-8, the same x bits and CG iterations on both,
   each answer held to the problem) and ``supervised_solve`` on
   ``sparse-iterative`` over 4 ranks with DEVICE_LOST of rank 3 at
   iteration 3 (``shrink:4->3``, the rows re-split unevenly over 3, the
   survivors' x bits equal, within 1e-8 of the ``mesh=None`` objective,
   ``recovery_overhead_s`` printed). Gloo stages every all-reduce through
   the host: no number of those worlds stands for NCCL over NVLink;
23. the dense backend's forced-PCG schedule (``pcg_phase``; ``--pcg-only``
   runs the build and this phase alone), ``solve_mode="pcg"`` at tol 1e-8
   and ``max_iter=200``, each solve held to the JAX package's verdict for
   its route (``PCG_JAX``, from ``scripts/port_pcg_jax_verdicts.py``):
   the main path's problem, ``random_dense_lp(2048, 10240, seed=0)``, on
   the captured fused loop (the same status; where OPTIMAL,
   iterations within ±2 and the objective within 1e-8 of the JAX
   package's and 1e-6 of HiGHS, else the final rel_gap and pinf within a
   factor of 10), beside the direct path's
   ms an iteration and peak memory on the same problem; K1 f32 on that
   path's f32 copy of A against the exact product and one
   preconditioner build split by CUDA events (K1 f32, the f32 Cholesky,
   the inverse); then ``random_dense_lp(512, 2560, seed=0)`` on the fused
   loop (twice, x bit for bit on the repeat) and ``segment_iters=10`` (the
   closure's route), and ``(60, 180, seed=0)`` on those and the host loop
   (``PCG_CUT``: the host loop at 512x2560 was cut for the script's
   time). Each solve's K1 f32
   launches are held to its factorizations (+1 for the closure's G on
   the segmented loop); printed: ms an iteration, live and masked CG
   iterations a Newton solve, peak GB, the best error and where. A status
   other than the JAX package's passes only on the plateau of a loop with
   a stall exit, where each run's best error lies on the side of the
   patience floor (1e3·tol) its status needs (``pcg_by_patience``);
24. the dense backend's two-phase schedule, the reference's default on a
   TPU, asked for with ``DenseTorchBackend(schedule_platform="tpu")``
   (``two_phase_phase``; ``--two-phase-only`` runs the build and this
   phase alone), at tol 1e-8 and ``max_iter=200``, each solve held to
   the JAX package's verdict for its case (``TWO_PHASE_JAX``, from
   ``scripts/port_two_phase_jax_verdicts.py``: the same status; where
   OPTIMAL, iterations within ±2 — or a difference before the f64 finish
   alone, where an earlier, f32-factored phase took bad steps and the
   f64 finish is within ±2 (``two_phase_by_f32_edge``); the cases of
   ``TWO_PHASE_BY_PHASE`` within ±2 in every phase, with no such
   allowance — and the
   objective within 1e-8 of the JAX package's and within 1e-6 of HiGHS
   at full width (``MAIN_HIGHS_OBJECTIVE``, from ``--highs-main`` on the
   CPU); else the final rel_gap and pinf within a factor of 10): the
   main path's problem, ``random_dense_lp(2048, 10240, seed=0)``, on the
   segmented route (the TPU's auto), on
   ``segment_iters=0`` (the fused two-phase program, twice: x bit for
   bit on the repeat) and on the host loop, with ms an iteration by
   phase beside a warm direct solve's; the three-phase PCG plan
   (``solve_mode="pcg"``: f32 → PCG → f64) on the same problem, with the
   PCG phase's live and masked CG iterations a Newton solve; and
   ``random_dense_lp(4096, 20480, seed=0)``, the smallest class where
   ``solve_mode=None`` engages that plan (2²⁶ ≤ m·n < 2²⁸). Each solve's
   phases are checked, and its K1 launches split by dtype: f32 = the
   start, the closure's G on a PCG plan and the bodies of the f32 and PCG
   phases; f64 = the f64 phase's bodies (the host loop: its steps). K1
   f32 on each path's f32 copy of A, and f64 at 4096×20480, against
   their plain versions, and timed;
25. the sharded backend's PCG (``sharded_pcg_phase``;
   ``--sharded-pcg-only`` runs the build and this step alone, solving
   step 24's dense answers first; in a whole run its legs ride step 20's
   NCCL world of one and its pdlp gloo world of 2), at tol 1e-8 and
   ``max_iter=200``, each sharded answer held to its problem
   (``sharded_answer_check``) and its K1 launches split by dtype as in
   step 24 (forced PCG: the start + the bodies, + the closure's G on the
   segmented loop; the host loop its steps): (a)
   ``random_dense_lp(4096, 20480, seed=0)`` through
   ``ShardedTorchBackend(schedule_platform="tpu")`` with
   ``solve_mode=None`` on the NCCL world of one — the reference's
   automatic PCG (2²⁶ ≤ m·n < 2²⁸), the segmented ``[f32, pcg, f64]`` plan
   with the closure in every phase, every phase captured, TF32 off —
   against step 24's dense answer to the same problem (the same status,
   each phase's iterations within ±2, the objective within 1e-8), with ms
   an iteration by phase, CG live and masked a Newton solve and peak GB
   beside the dense solve's, and three clocked PCG iterations split by
   part (``pcg_stage_parts``); (b) the main path's problem with
   ``solve_mode="pcg"`` under the same schedule on the NCCL world of one
   and on a local mesh of one on ``cuda:0``: x bit for bit, each held to
   step 24's dense PCG plan as in (a), each captured loop's graph pool
   the same on both and the card's reserved bytes not grown by a run of
   replays (``pool_report``); (c) forced PCG at the reference's mesh
   instances, ``random_dense_lp(48, 120, seed=11)``, ``(48, 128,
   seed=4)`` and ``(64, 160, seed=9)``, on the fused loop (captured), the
   host loop and ``segment_iters=2`` (the closure's route) on the NCCL
   world of one, each held to the JAX package's verdict on its mesh of 8
   (``SHARDED_PCG_JAX``, from ``scripts/port_sharded_pcg_jax_verdicts.py``:
   the same status, iterations within ±2, the objective within 1e-8);
   (d) (b)'s problem and plan, and (48, 120, seed=11) forced, over a gloo
   world of 2 sharing the card (2048 × 5,120 a rank, uncaptured): every
   rank the same x bits, the first held to (b)'s answer as in (a) and to
   its problem, the second to the JAX verdict; (e) K1 f32 at a rank's
   block (2048 × 5,120) and at 4096 × 20,480 against the exact product
   (≤ 1e-5) and timed beside its bounds and ``torch.einsum``. Gloo stages
   every sum through the host and the ranks share one card: no number of
   that world stands for NCCL over NVLink;
26. prints the ``kernels`` JSON line, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line.
"""

from __future__ import annotations

import atexit
import contextlib
import importlib
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): FP64 tensor
# cores and FP32 67 TFLOP/s, bf16 989 TFLOP/s; HBM3 3.35 TB/s.
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# The TF32 tensor cores, dense: 494.7 TFLOP/s. K1's f32 design takes three
# TF32 passes a product (3×TF32), so its own bound is 3·m·(m+1)·n flops
# there, the lesser one; the CUDA-core bound (PEAK_FLOPS) stays beside it.
PEAK_TF32 = 494.7e12
# Frobenius-relative error of the kernel against its plain version (in
# f32 against the exact product, ``parity_reference``).
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-4}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


GRAFTCHECK_TIMEOUT_S = 120.0


def start_graftcheck():
    """Start ``python3 -m distributedlpsolver_tpu_torch check --json`` over
    the package in a subprocess; returns (process, start time, output file)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = open(os.path.join(ROOT, "build", "graftcheck.json"), "w+")
    cmd = [sys.executable, "-m", "distributedlpsolver_tpu_torch", "check", "--json",
           os.path.join(ROOT, "distributedlpsolver_tpu_torch")]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.PIPE, text=True)
    atexit.register(_stop, proc)  # a run that fails first leaves no gate behind
    return proc, time.perf_counter(), out


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def finish_graftcheck(proc, t0, out):
    """Wait for the gate within its limit; any exit code but 0 fails the run."""
    try:
        _, err = proc.communicate(timeout=max(1.0, GRAFTCHECK_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        out.close()
        fail(f"graftcheck did not finish within {GRAFTCHECK_TIMEOUT_S:.0f} s")
    secs = time.perf_counter() - t0
    out.seek(0)
    text = out.read()
    out.close()
    if proc.returncode != 0:
        fail(f"graftcheck exited {proc.returncode}: {text[-2000:]} {err[-2000:]}")
    counts = json.loads(text)["counts"]
    print(f"graftcheck: {counts['findings']} finding(s), {counts['suppressed']} suppressed, "
          f"{secs:.2f} s (python3 -m distributedlpsolver_tpu_torch check --json, exit 0)")


def cuda_ms(torch, fn, iters: int, warm: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches, CUDA events,
    after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(torch, fn, iters: int, warm: int, flush) -> float:
    """Mean milliseconds of one launch of ``fn`` with a cold L2: before each
    launch ``flush`` (a tensor larger than the 50 MB L2) is read whole, so
    the L2 holds none of ``fn``'s inputs and no dirty line to write back
    (as a loop leaves it whose other work streams gigabytes of reads), and
    a pair of CUDA events times the launch alone. A sleep kernel holds the
    stream while the host enqueues, so the time is the device's even where
    a call's host path is as long as its kernel."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    torch.cuda._sleep(iters * 200_000)  # ~100 µs a launch at ~2 GHz
    for start, end in ev:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in ev) / iters


def bound_ms(m: int, n: int, dtype: str, out_bytes: int, batch: int = 1) -> tuple:
    """Least time for M = A·diag(d)·Aᵀ over ``batch`` lanes: the larger of
    the operations over the type's peak and the bytes (A and d read once,
    M written once) over the memory rate. M is symmetric, so the
    operations are those of its lower triangle, m·(m+1)/2 entries of n
    multiply-adds: m·(m+1)·n a lane. Returns (ms, "operations"|"bytes")."""
    elt = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    t_ops = batch * float(m) * (m + 1) * n / PEAK_FLOPS[dtype]
    t_bytes = batch * (m * n * elt + n * elt + m * m * out_bytes) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def tensor_bound_ms(m: int, n: int, batch: int = 1) -> tuple:
    """Least time of K1's f32 design (3×TF32 products on the tensor
    cores) for M = A·diag(d)·Aᵀ over ``batch`` lanes: the larger of its
    3·m·(m+1)·n flops at the TF32 peak and the bytes at the memory rate.
    Returns (ms, "operations"|"bytes")."""
    t_ops = batch * 3.0 * m * (m + 1) * n / PEAK_TF32
    t_bytes = batch * (m * n * 4 + n * 4 + m * m * 4) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def parity_reference(torch, ne, A, d):
    """What the kernel on (A, d) is held against, in f64: the plain
    version, but for f32 the exact product of the same inputs
    (``normal_eq_exact``), since one cuBLAS f32 product lies up to ~1e-5
    from it where K1's f32 M lies ~1e-7 from it."""
    if A.dtype == torch.float32:
        return ne.normal_eq_exact(A, d)
    return ne.normal_eq_reference(A, d).double()


def exact_errors(M, exact) -> tuple:
    """Frobenius-relative error of M against the exact product, and the
    largest relative error on its diagonal."""
    D = M.double() - exact
    fro = (D.norm() / exact.norm()).item()
    diag = (D.diagonal(dim1=-2, dim2=-1).abs() / exact.diagonal(dim1=-2, dim2=-1).abs()).max().item()
    return fro, diag


def f32_exact_check(torch, ne, A32, d32, name) -> dict:
    """K1's f32 M and one cuBLAS f32 product (TF32 off), each against the
    f64 product of the same f32 inputs; K1 must be no farther, both
    Frobenius-relative and on the diagonal (the f32 design's gate)."""
    exact = ne.normal_eq_exact(A32, d32)
    k1 = exact_errors(ne.normal_eq(A32, d32), exact)
    cublas = exact_errors((A32 * d32[None, :]) @ A32.T, exact)
    del exact
    torch.cuda.empty_cache()
    out = {"k1_exact_err": k1[0], "k1_exact_diag_err": k1[1],
           "cublas_exact_err": cublas[0], "cublas_exact_diag_err": cublas[1]}
    print(f"f32_exact {name}: K1 {k1[0]:.3e} (diagonal {k1[1]:.3e}), cuBLAS f32 {cublas[0]:.3e} "
          f"(diagonal {cublas[1]:.3e}) from the f64 product of the same f32 inputs")
    if not (k1[0] <= cublas[0] and k1[1] <= cublas[1]):
        fail(f"f32_exact {name}: K1's f32 M is farther from the exact product than cuBLAS's: {out}")
    return out


def make_inputs(torch, m, n, dtype, seed, batch=None):
    """A (m, n) and d (n,), or with ``batch`` a leading lane axis on both."""
    lead = () if batch is None else (batch,)
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(*lead, m, n, dtype=torch.float64, device="cuda", generator=g).to(dtype)
    d = (torch.rand(*lead, n, dtype=torch.float64, device="cuda", generator=g) + 0.1).to(dtype)
    return A, d


def shape_name(m, n, batch=None) -> str:
    return f"{m}x{n}" if batch is None else f"{batch}x{m}x{n}"


def kernel_parity(torch, ne, m, n, dtype_name, seed=0, batch=None):
    """Kernel vs ``parity_reference`` on the card (the plain version; for
    f32 the exact product); returns (rel_err, max_abs_err).
    M must equal Mᵀ bit for bit, and a second launch must give the same
    bits. With ``batch`` the launch covers every lane, and each lane must
    equal, bit for bit, the unbatched kernel on that lane's inputs. In
    bf16 the kernel must also sit ten times closer to the plain version
    than the product without the bf16 rounding of A·d does, so that the
    rounding is shown to happen."""
    dtype = getattr(torch, dtype_name)
    name = f"normal_eq {dtype_name} {shape_name(m, n, batch)}"
    A, d = make_inputs(torch, m, n, dtype, seed, batch)
    M = ne.normal_eq(A, d)
    M2 = ne.normal_eq(A, d)
    torch.cuda.synchronize()
    if not torch.equal(M, M.mT):
        fail(f"{name}: M is not bitwise symmetric")
    if not torch.equal(M, M2):
        fail(f"{name}: two launches differ")
    del M2
    for i in range(batch or 0):
        if not torch.equal(M[i], ne.normal_eq(A[i].contiguous(), d[i].contiguous())):
            fail(f"{name}: lane {i} differs from the unbatched kernel on its inputs")
    # The kernel computes the lower triangle and mirrors it (checked above).
    R = torch.tril(parity_reference(torch, ne, A, d))
    diff = torch.tril(M).double() - R
    rel = (diff.norm() / R.norm()).item()
    mx = diff.abs().max().item()
    del diff, M
    if dtype == torch.bfloat16:
        unrounded = torch.tril((A.double() * d.double()[..., None, :]) @ A.double().mT)
        rounding = ((unrounded - R).norm() / R.norm()).item()
        del unrounded
        if not rel <= rounding / 10:
            fail(f"{name}: error {rel:.3e} vs the rounding's own {rounding:.3e}")
    del A, d, R
    torch.cuda.empty_cache()
    if not rel <= TOL[dtype_name]:
        fail(f"{name}: relative error {rel:.3e} > {TOL[dtype_name]:.0e}")
    return rel, mx


def kernel_timing(torch, ne, m, n, dtype_name, iters, warm, batch=None):
    dtype = getattr(torch, dtype_name)
    A, d = make_inputs(torch, m, n, dtype, 1, batch)
    # One PyTorch call computing the same function (library yardstick).
    spec = "ik,k,jk->ij" if batch is None else "bik,bk,bjk->bij"
    row = {
        "shape": [m, n] if batch is None else [batch, m, n], "dtype": dtype_name,
        "ms": cuda_ms(torch, lambda: ne.normal_eq(A, d), iters, warm),
        "plain_ms": cuda_ms(torch, lambda: ne.normal_eq_reference(A, d), iters, warm),
        "library_ms": cuda_ms(torch, lambda: torch.einsum(spec, A, d, A), iters, warm),
    }
    out_bytes = 4 if dtype == torch.bfloat16 else A.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(m, n, dtype_name, out_bytes, batch or 1)
    if dtype == torch.float32:
        # The kernel's own design (3×TF32 on the tensor cores) is the lesser
        # bound; the CUDA-core f32 one stays beside it.
        row["cuda_core_bound_ms"] = row["bound_ms"]
        row["cuda_core_bound_share"] = row["bound_ms"] / row["ms"]
        row["bound_ms"], row["bound_by"] = min((row["bound_ms"], row["bound_by"]),
                                               tensor_bound_ms(m, n, batch or 1))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    if dtype == torch.float64:
        row["splits"] = ne.splits_on(A)
    # Rate of the flops the kernel issues: its T·(T+1)/2 lower-triangle
    # tiles a lane, diagonal tiles whole, each edge²·n multiply-adds.
    edge = ne.tile_edge(dtype)
    tiles = -(-m // edge)
    row["issued_tflops"] = ((batch or 1) * tiles * (tiles + 1) * edge * edge * n
                            / (row["ms"] * 1e-3) / 1e12)
    del A, d
    torch.cuda.empty_cache()
    return row


def sass_counts(ne) -> dict:
    """Tensor-core instructions in the SASS of the built library, read
    with the toolkit's ``cuobjdump -sass``: DMMA in the f64 kernel and
    HMMA (TF32) in the f32 kernel, both copy-width instances of each."""
    cuda_bin = os.path.dirname(ne._nvcc())
    tool = os.path.join(cuda_bin, "cuobjdump")
    sass = subprocess.run([tool, "-sass", ne.build_info["path"]], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, kernel = {"dmma": 0, "hmma_tf32": 0}, ""
    for ln in sass.splitlines():
        if "Function :" in ln:
            kernel = ln
        elif "normal_eq_dmma_kernel" in kernel and "DMMA" in ln:
            counts["dmma"] += 1
        elif "normal_eq_tf32_kernel" in kernel and "HMMA" in ln and "TF32" in ln:
            counts["hmma_tf32"] += 1
    return counts


def ptxas_lines(ne, kernel: str) -> list:
    """nvcc's -Xptxas -v lines (registers, shared memory, spills) of the
    entry functions whose name holds ``kernel``."""
    out, keep = [], False
    for ln in ne.build_info.get("ptxas", []):
        if "Compiling entry" in ln:
            keep = kernel in ln
        if keep:
            out.append(ln)
    return out


# Bodies the fused loop may run past its exit (the graph runner queues
# two replays ahead of the host's read).
MAX_MASKED = 2


def solve_counted(p, **kw):
    """``solve(p, backend=<a cuda backend>, **kw)`` with the kernel's
    launch count reset just before and read just after. Returns the
    result, the count, the backend's phase rows (fused loop) or None
    (host loop), the host loop's refactorizations and the wall time."""
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
    from distributedlpsolver_tpu_torch.ops import normal_eq

    be = get_backend("cuda")
    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        normal_eq.launches = 0
        t0 = time.perf_counter()
        r = solve(p, backend=be, **kw)
        wall = time.perf_counter() - t0
        launches = normal_eq.launches
    finally:
        obs_metrics.set_registry(prev)
    refactors = int(reg.snapshot().get("ipm_refactorizations_total", 0))
    return r, launches, getattr(be, "phase_report", None), refactors, wall


def launch_accounting(r, launches, phases, refactors, fused: bool) -> dict:
    """The kernel launches of a solve against its factorizations: the
    starting point plus, in the fused loop, one per body (accepted, bad,
    or masked past the exit); in the host loop, one per step attempt."""
    if fused:
        if phases is None:
            fail("the fused loop did not run (no phase report)")
        acc = {k: sum(row[k] for row in phases)
               for k in ("bodies", "eager", "replays", "masked", "bad_steps", "runs")}
        for k in ("eager_ms", "capture_ms", "replay_ms"):
            acc[k] = [row[k] for row in phases]
        factorizations = 1 + acc["bodies"]
        if acc["bodies"] != r.iterations + acc["bad_steps"] + acc["masked"]:
            fail(f"fused loop: {acc['bodies']} bodies for {r.iterations} iterations, "
                 f"{acc['bad_steps']} bad and {acc['masked']} masked")
        if acc["masked"] > MAX_MASKED * acc["runs"]:
            fail(f"fused loop: {acc['masked']} bodies past the exit over {acc['runs']} runs")
    else:
        if phases is not None:
            fail("the host loop was asked for, but the fused loop ran")
        acc = {"refactorizations": refactors}
        factorizations = 1 + r.iterations + refactors
    if not (launches == factorizations and launches > 0):
        fail(f"{launches} kernel launches for {factorizations} factorizations ({acc})")
    return {"normal_eq_launches": launches, "factorizations": factorizations, **acc}


def main_path(m, n, seed, **kw):
    """solve(random_dense_lp(m, n, seed), backend="cuda", **kw) with the
    launch accounting and the host check; the fused loop unless ``kw``
    turns it off."""
    import numpy as np

    from distributedlpsolver_tpu_torch.ipm import Status
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    p = random_dense_lp(m, n, seed=seed)
    r, launches, phases, refactors, wall = solve_counted(p, tol=1e-8, **kw)
    acc = launch_accounting(r, launches, phases, refactors, kw.get("fused_loop", True))
    x, y = np.asarray(r.x), np.asarray(r.y)
    viol = p.max_violation(x)
    pobj, dobj = float(p.c @ x), float(p.rlb @ y)
    gap = abs(pobj - dobj) / (1.0 + abs(pobj))
    row = {
        "problem": p.name, "loop": loop_name(kw), "status": r.status.value,
        "iterations": r.iterations, "objective": r.objective, "wall_s": wall,
        "setup_s": r.setup_time, "solve_s": r.solve_time, "iters_per_s": r.iters_per_sec,
        **acc, "max_violation": viol, "host_rel_gap": gap,
    }
    if r.status != Status.OPTIMAL:
        fail(f"main path {p.name} ({row['loop']}): status {r.status.value}")
    if not viol <= 1e-6:
        fail(f"main path ({row['loop']}): max_violation {viol:.3e} > 1e-6")
    if not gap <= 1e-7:
        fail(f"main path ({row['loop']}): host |cᵀx - bᵀy| relative {gap:.3e} > 1e-7")
    return row, p, r


def loop_name(kw) -> str:
    if kw.get("fused_loop") is False:
        return "host"
    return f"segmented({kw['segment_iters']})" if kw.get("segment_iters") else "fused"


def same_answer(name, ref, ref_row, r, row) -> bool:
    """Status, iterations and objective (1e-12 relative) of ``r`` against
    the fused loop's ``ref``; returns whether x is bitwise equal."""
    import numpy as np

    rel = abs(r.objective - ref.objective) / (1.0 + abs(ref.objective))
    if r.status != ref.status or r.iterations != ref.iterations or not rel <= 1e-12:
        fail(f"{name}: {r.status.value} {r.iterations} it objective {r.objective!r} against the "
             f"fused loop's {ref.status.value} {ref.iterations} it {ref.objective!r} ({rel:.3e})")
    return bool(np.array_equal(np.asarray(r.x), np.asarray(ref.x)))


def cold_solve(loop_kw: dict) -> dict:
    """The main path as the first solve of a fresh process (the kernel
    library is already built), through ``chip_smoke.py --one-solve``."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--one-solve", json.dumps(loop_kw)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
    )
    if proc.returncode != 0:
        fail(f"cold solve {loop_kw}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def one_solve(loop_kw: dict) -> int:
    """The body of ``--one-solve``: one main-path solve, its row on the
    last line of standard output."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    row, _, _ = main_path(2048, 10240, seed=0, **loop_kw)
    print(json.dumps(row))
    return 0


def zero_row_lp():
    """A zero row that presolve would remove: with presolve off and no
    regularization, every Cholesky of M fails."""
    import numpy as np

    from distributedlpsolver_tpu_torch.models.problem import LPProblem

    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 10))
    A[2] = 0.0
    b = A @ rng.uniform(0.5, 2.0, 10)
    c = A.T @ rng.standard_normal(4) + rng.uniform(0.5, 2.0, 10)
    return LPProblem(c=c, A=A, rlb=b, rub=b, lb=np.zeros(10), ub=np.full(10, np.inf),
                     name="zero_row")


def highs_objective(p) -> float:
    # The tests' HiGHS oracle, loaded by path: a ``tests`` package
    # installed elsewhere may shadow the repo's directory.
    spec = importlib.util.spec_from_file_location("dlps_oracle", os.path.join(ROOT, "tests", "oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    h = oracle.highs_on_general(p)
    if h.status != 0:
        fail(f"HiGHS did not solve {p.name}: {h.message}")
    obj = h.fun + p.c0
    return -obj if p.maximize else obj


def highs_tight_objective(p) -> float:
    """HiGHS on a standard-form request (min cᵀx, Ax = b, x ≥ 0) at primal
    and dual feasibility tolerances of 1e-10. At its default 1e-7 HiGHS
    can stop ~3e-8 from the optimum — more than the 1e-8 the serve phase
    holds: request 480 of the correlated wave reads 3.0e-8 from the IPM's
    answer at 1e-7 and 1.6e-9 at 1e-10 (rel_gap 1.8e-9, pinf 1e-12)."""
    import scipy.optimize as sopt

    h = sopt.linprog(p.c, A_eq=p.A, b_eq=p.rlb, bounds=(0, None), method="highs",
                     options={"primal_feasibility_tolerance": 1e-10,
                              "dual_feasibility_tolerance": 1e-10})
    if h.status != 0:
        fail(f"HiGHS did not solve {p.name}: {h.message}")
    return h.fun


# Host calls that each put one operation on the card: kernel launches
# (runtime and driver API), graph launches, copies and fills.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def device_profile(torch, run):
    """``run()`` under ``torch.profiler``: its result, and the kernel
    time by category and by kernel, device busy time, the operations on
    the card and the host calls that launched them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [
        (ev.key, ev.self_device_time_total / 1e3, ev.count)
        for ev in events
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    kernels.sort(key=lambda t: -t[1])
    calls = {}
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.key.startswith(LAUNCH_CALLS):
            name = next(c for c in LAUNCH_CALLS if ev.key.startswith(c))
            calls[name] = calls.get(name, 0) + ev.count
    categories, names = {}, {}
    for key, ms, _ in kernels:
        k = key.lower()
        cat = next((c for c, words in (
            ("normal_eq", ("normal_eq",)),
            ("cholesky", ("potrf", "getrf", "chol", "syrk", "herk")),
            ("triangular_solve", ("trsv", "trsm", "potrs")),
            ("gemv_bmv", ("gemv", "dot_kernel", "gemm")),
            ("memcpy", ("memcpy", "memset")),
        ) if any(w in k for w in words)), "elementwise_reduce_other")
        categories[cat] = categories.get(cat, 0.0) + ms
        names.setdefault(cat, []).append(key[:80])
    return r, {
        "device_busy_ms": sum(t[1] for t in kernels),
        "device_ops": sum(t[2] for t in kernels), "host_launch_calls": calls,
        "by_category_ms": categories,
        # Which library kernels factor and solve.
        "linalg_kernels": {c: names[c] for c in ("cholesky", "triangular_solve") if c in names},
        "top": [{"kernel": k[:80], "ms": ms, "count": c} for k, ms, c in kernels[:10]],
    }


def profile_main_path(torch, m, n, seed, tag, **loop_kw):
    """Device-time breakdown of one warm main-path solve, and the idle
    share of the backend's host-clock window (setup + iterations)."""
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    p = random_dense_lp(m, n, seed=seed)
    r, prof = device_profile(torch, lambda: solve(p, backend="cuda", tol=1e-8, **loop_kw))
    return {
        "loop": tag, "iterations": r.iterations, "solve_s_profiled": r.solve_time,
        "setup_s_profiled": r.setup_time, "device_busy_ms": prof["device_busy_ms"],
        # Over the backend's window: setup (copy, starting point) + loop.
        "device_idle_share": 1.0 - prof["device_busy_ms"] / (1e3 * (r.setup_time + r.solve_time)),
        **{k: v for k, v in prof.items() if k != "device_busy_ms"},
    }


# The batched solver's configuration (BASELINE.json:11): 1024 independent
# standard-form LPs of 128×512, f64, tol 1e-8.
BATCH, BM, BN = 1024, 128, 512
# Members held against HiGHS and the dense solo solve: every 32nd.
SAMPLE = range(0, BATCH, 32)


def batched_solve(torch, batch, **kw):
    """``solve_batched(batch, tol=1e-8, **kw)`` on the card with the
    kernel's launch count reset just before and read just after, and its
    accounting: K1 runs once for each chunk's batched start, once per body
    of the batched loops (one launch for every lane of the loop) and once
    per body of each solo cleanup solve (warm-started, so without a start
    of its own)."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends.batched import solve_batched
    from distributedlpsolver_tpu_torch.ops import normal_eq

    torch.cuda.reset_peak_memory_stats()
    normal_eq.launches = 0
    t0 = time.perf_counter()
    r = solve_batched(batch, tol=1e-8, **kw)
    wall = time.perf_counter() - t0
    launches = normal_eq.launches
    loops = [row for row in r.phase_report if row["phase"] != "cleanup"]
    cleanup = [row for row in r.phase_report if row["phase"] == "cleanup"]
    acc = {k: sum(row[k] for row in loops) for k in ("bodies", "eager", "replays", "masked", "runs")}
    for k in ("eager_ms", "capture_ms", "replay_ms"):
        acc[k] = sum(row[k] for row in loops)
    cleanup_bodies = sum(row["bodies"] for row in cleanup)
    starts = len({row["chunk"] for row in loops})
    if launches != starts + acc["bodies"] + cleanup_bodies:
        fail(f"batched {kw}: {launches} K1 launches for {starts} starts + {acc['bodies']} bodies + "
             f"{cleanup_bodies} cleanup bodies")
    if acc["bodies"] != sum(row["iters"] for row in loops) + acc["masked"] or (
            acc["masked"] > MAX_MASKED * acc["runs"]):
        fail(f"batched {kw}: {acc['bodies']} bodies for {[row['iters'] for row in loops]} "
             f"iterations, {acc['masked']} past the exit over {acc['runs']} runs")
    its = r.iterations.astype(np.int64)
    row = {
        "kw": kw, "wall_s": wall, "setup_s": r.setup_time, "solve_s": r.solve_time,
        "optimal": r.n_optimal, "members": len(its),
        "member_iters": [int(its.min()), float(its.mean()), int(its.max())],
        "normal_eq_launches": launches, "starts": starts, **acc,
        "sizes": [row["sizes"] for row in loops],
        "cleanup_solves": len(cleanup), "cleanup_members": [row["member"] for row in cleanup],
        "cleanup_bodies": cleanup_bodies,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "member_iters_per_s": float(its.sum()) / r.solve_time,
        "batch_bodies_per_s": acc["bodies"] / r.solve_time,
    }
    return row, r


def check_members(name, r, max_iter):
    """Every member OPTIMAL at the tolerance (rel_gap ≤ 1e-8, pinf ≤ 1e-7),
    or left at the iteration limit with its whole budget spent — the JAX
    package's verdict for a member still short of the tolerance after
    max_iter batched iterations. Returns the indices of the latter."""
    import numpy as np

    status = np.array([s.value for s in r.status])
    opt = status == "optimal"
    if not (np.all(r.rel_gap[opt] <= 1e-8) and np.all(r.pinf[opt] <= 1e-7)
            and np.all(np.isfinite(r.objective)) and np.all(np.isfinite(r.x))):
        fail(f"{name}: an OPTIMAL member above the tolerance, or a non-finite answer")
    limited = np.flatnonzero(~opt)
    if not (np.all(status[limited] == "iteration_limit") and np.all(r.iterations[limited] == max_iter)):
        fail(f"{name}: members {limited.tolist()} end {status[limited].tolist()} at "
             f"{r.iterations[limited].tolist()} iterations")
    return limited.tolist()


def batched_phase(torch, ne, card):
    """K1 with a lane axis on the card, then the batched solver at the
    full width (see the module note, step 8). Returns the batched
    kernel's parity rows, its timing rows and the default cold run's
    row."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models import random_batched_lp

    # K1 batched: the full width in f64, and a ragged batch with an odd
    # m·n (every odd f64 lane 8 bytes off a 16-byte boundary) in all three.
    parity = {}
    for dt, (B, m, n) in [("float64", (BATCH, BM, BN)), ("float64", (3, 100, 333)),
                          ("float32", (3, 100, 333)), ("bfloat16", (3, 100, 333))]:
        parity[f"{dt}_{shape_name(m, n, B)}"] = kernel_parity(torch, ne, m, n, dt, batch=B)
    for k, (rel, mx) in parity.items():
        print(f"parity normal_eq batched {k}: rel_err {rel:.3e} max_abs_err {mx:.3e} "
              f"(tol {TOL[k.split('_')[0]]:.0e}), every lane bitwise equal to the unbatched kernel, "
              "M = Mᵀ bitwise, two launches bitwise equal")
    timings = [kernel_timing(torch, ne, BM, BN, "float64", iters=20, warm=3, batch=BATCH),
               kernel_timing(torch, ne, 100, 333, "float64", iters=20, warm=3, batch=3)]
    for t in timings:
        print(f"timing normal_eq batched {t['dtype']} {'x'.join(map(str, t['shape']))}: kernel "
              f"{t['ms']:.4f} ms ({t['issued_tflops']:.2f} TFLOP/s issued), plain {t['plain_ms']:.4f} ms, "
              f"library(einsum) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"bound share {t['bound_share']:.3f} [{card}]")

    # The full-width solve: cold (the first batched solve of the process)
    # and warm, on the default configuration.
    batch = random_batched_lp(BATCH, BM, BN, seed=0)
    max_iter = SolverConfig().max_iter
    print(f"linalg: preferred library {torch.backends.cuda.preferred_linalg_library()}")
    runs = {}
    for tag, kw in (("cold", {}), ("warm", {}), ("segmented", {"segment_iters": 8}),
                    ("chunked", {"chunk": 256, "segment_iters": 8})):
        row, r = batched_solve(torch, batch, **kw)
        row["limited"] = check_members(f"batched {tag}", r, max_iter)
        runs[tag] = (row, r)
        print(f"batched_{tag} " + json.dumps(row) + f" [{card}]")
    (cold, rc), (warm, rw), (seg, rs), (chunked, rk) = (runs[k] for k in ("cold", "warm", "segmented", "chunked"))
    same = lambda a, b: [s.value for s in a.status] == [s.value for s in b.status]
    rel = lambda a, b: np.abs(a - b) / (1.0 + np.abs(b))
    if not (same(rw, rc) and np.array_equal(rw.iterations, rc.iterations)
            and rel(rw.objective, rc.objective).max() <= 1e-9):
        fail("batched: the warm solve differs from the cold one")
    # Objectives are compared where both runs end OPTIMAL: a member left
    # at the iteration limit keeps an unfinished iterate, which the
    # segmented run's solo cleanup moves.
    opt = np.array([s.value == "optimal" for s in rc.status])
    seg_rel = rel(rs.objective[opt], rc.objective[opt]).max()
    if not (same(rs, rc) and seg_rel <= 1e-9):
        fail(f"batched segmented(8): statuses or objectives (max rel {seg_rel:.3e}) differ "
             "from the unsegmented run")
    # chunk=256 + segment_iters=8 is the JAX package's schedule on a TPU,
    # the one BENCH_SUITE.json's 1024/1024 record ran: every member must
    # end OPTIMAL.
    if chunked["optimal"] != BATCH:
        fail(f"batched chunk=256 segmented(8): {chunked['optimal']}/{BATCH} OPTIMAL")
    print(f"batched: members the default run left at the iteration limit: {cold['limited']}; "
          f"chunk=256 segmented(8) solves all {BATCH}, its objectives vs the default run's OPTIMAL "
          f"members max rel {rel(rk.objective[opt], rc.objective[opt]).max():.3e}; segmented(8) vs "
          f"default max rel {seg_rel:.3e}")

    # Sampled members (and any the default run left unfinished) against
    # HiGHS and against the dense solo solve on the card.
    # Both the batched and the solo solve stop at a relative gap of 1e-8,
    # by different paths, so their objectives may differ by about that
    # much: the solo comparison holds them to 1e-8 and counts how many
    # agree to 1e-9.
    sample = sorted(set(SAMPLE) | set(cold["limited"]))
    worst_h, worst_s, within_1e9 = 0.0, 0.0, 0
    for k in sample:
        ref = rk if k in cold["limited"] else rc
        p = batch.problem(k)
        h = highs_objective(p)
        solo = solve(p, backend=get_backend("cuda"), tol=1e-8)
        if solo.status.value != "optimal":
            fail(f"batched member {k}: the dense solo solve ends {solo.status.value}")
        eh = abs(ref.objective[k] - h) / (1.0 + abs(h))
        es = abs(ref.objective[k] - solo.objective) / (1.0 + abs(solo.objective))
        worst_h, worst_s = max(worst_h, eh), max(worst_s, es)
        within_1e9 += es <= 1e-9
        if not (eh <= 1e-8 and es <= 1e-8):
            fail(f"batched member {k}: objective {ref.objective[k]!r} vs HiGHS {h!r} ({eh:.3e}) "
                 f"and the dense solo solve {solo.objective!r} ({es:.3e})")
    print(f"batched: {len(sample)} members {sample[:3]}…{sample[-2:]} vs HiGHS max rel {worst_h:.3e} "
          f"(tol 1e-8), vs the dense solo solve on the card max rel {worst_s:.3e} (tol 1e-8; "
          f"{within_1e9} of {len(sample)} within 1e-9)")

    # Where a warm batched solve's device time goes.
    from distributedlpsolver_tpu_torch.backends.batched import solve_batched

    r, prof = device_profile(torch, lambda: solve_batched(batch, tol=1e-8))
    prof_row = {
        "solve_s_profiled": r.solve_time, "setup_s_profiled": r.setup_time,
        "device_busy_ms": prof["device_busy_ms"],
        "device_idle_share": 1.0 - prof["device_busy_ms"] / (1e3 * (r.setup_time + r.solve_time)),
        **{k: v for k, v in prof.items() if k != "device_busy_ms"},
    }
    print("profile_batched " + json.dumps(prof_row) + f" [{card}]")
    return parity, timings, cold


def route_of(p) -> str:
    """``choose_backend_name`` on the card for ``p`` (its interior form,
    with the structure detection pass ``AutoBackend`` runs)."""
    from distributedlpsolver_tpu_torch.backends.auto import choose_backend_name
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form

    return choose_backend_name(to_interior_form(p), "cuda", detect=True)[0]


def no_fallback(name, problems, results, solo_backend):
    """No hidden fallback: no request went through a supervisor
    degradation, and every solo request was served by the backend its
    route names (``auto(<route>)`` for the ``auto`` solo backend)."""
    for p, r in zip(problems, results):
        degraded = [f.action for f in r.faults if f.action.startswith("degrade")]
        if degraded:
            fail(f"{name}: request {r.name} degraded ({degraded}) with no injected fault")
        if r.retried_solo or r.bucket is None:
            want = f"auto({route_of(p)})" if solo_backend == "auto" else solo_backend
            if r.backend != want:
                fail(f"{name}: request {r.name} served solo by {r.backend!r}, its route is {want!r}")


def host_cpu() -> str:
    """The host's CPU model and logical CPUs (``/proc/cpuinfo``), and the
    native library's OpenMP threads: printed beside every CPU time."""
    from distributedlpsolver_tpu_torch.native import load

    import platform

    first = {}
    with open("/proc/cpuinfo") as fh:
        for ln in fh:
            if not ln.strip():
                break  # the first processor's block
            k, _, v = ln.partition(":")
            first.setdefault(k.strip(), v.strip())
    known = {k: v for k, v in first.items() if v and v != "unknown"}
    model = known.get("model name") or " ".join(
        f"{k} {known[k]}" for k in ("vendor_id", "cpu family", "model", "stepping", "cpu MHz")
        if k in known) or platform.processor() or platform.machine()
    return (f"host CPU {model} ({platform.machine()}) x{os.cpu_count()}, "
            f"dlps_num_threads {load().dlps_num_threads()}")


# The serve phase: requests at the batched member width, padded into one
# bucket shape of SERVE_BATCH slots (BASELINE.json:11's members).
SERVE_BATCH = 256
SERVE_SAMPLE = 32  # every 32nd request against HiGHS


def serve_wave(torch, ne, svc, tag, problems, card, tols=None):
    """Submit ``problems`` (at ``tols``, else the service tol) to the
    running service and wait for all: the wave's row (printed) and
    results. K1's launch count is reset just before and read just after;
    each IPM dispatch row must hold K1 = start + warm selection + bodies
    (and the same for a cold bucket's one-iteration warm-up), and the
    wave's count must equal the dispatches' plus the solo solves'. No
    request may reach a supervisor degradation, and each solo request
    must be served by the backend its route names (``no_fallback``)."""
    from distributedlpsolver_tpu_torch.backends import batched as tb
    from distributedlpsolver_tpu_torch.serve import latency_summary

    rows0 = len(svc.dispatch_report())
    size0, caps0 = tb.bucket_cache_size(), tb.bucket_capture_count()
    torch.cuda.reset_peak_memory_stats()
    ne.normal_eq.launches = 0
    t0 = time.perf_counter()
    tols = tols or [None] * len(problems)
    futs = [svc.submit(p, tol=tol) for p, tol in zip(problems, tols)]
    submit_s = time.perf_counter() - t0
    if not svc.drain(timeout=900):
        fail(f"serve {tag}: the service did not drain")
    wall = time.perf_counter() - t0
    launches = ne.normal_eq.launches
    results = [f.result() for f in futs]
    rows = svc.dispatch_report()[rows0:]
    bucket_launches = sum(r["launches"] + r["warmup_launches"] for r in rows)
    solo = [r for r in results if r.retried_solo or r.bucket is None]
    summ = latency_summary(results)
    n = max(len(rows), 1)
    row = {
        "wave": tag, "requests": len(results), "wall_s": wall,
        "rps": len(results) / wall, "submit_s": submit_s,
        "latency_ms_p50": summ["latency_ms_p50"],
        "latency_ms_p99": summ["latency_ms_p99"], "dispatches": len(rows),
        "live": [r["live"] for r in rows],
        "pack_ms": [r["pack_ms"] for r in rows], "compile_ms": [r["compile_ms"] for r in rows],
        "solve_ms": [r["solve_ms"] for r in rows], "overlap_ms": [r["overlap_ms"] for r in rows],
        "padding_waste_mean": summ.get("mean_padding_waste"),
        "bodies_per_dispatch": [r["bodies"] for r in rows],
        "bodies_mean": sum(r["bodies"] for r in rows) / n,
        "replays": sum(r["replays"] for r in rows),
        "captures": sum(r["captures"] + r["warmup_captures"] for r in rows),
        "normal_eq_launches": launches, "bucket_launches": bucket_launches,
        "solo_fallbacks": len(solo), "solo_ms": [r.solve_ms for r in solo],
        "solo_backends": sorted({str(r.backend) for r in solo}),
        "engines": {e: sum(r.engine == e for r in results) for e in sorted({r.engine for r in results})},
        "solo_members": [(r.name, r.iterations, [f.detail[:60] for f in r.faults]) for r in solo],
        "warm_used": sum(1 for r in results if r.warm == "warm"),
        "iterations_mean": sum(r.iterations for r in results) / max(len(results), 1),
        "programs_built": tb.bucket_cache_size() - size0,
        "graphs_captured": tb.bucket_capture_count() - caps0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "status": summ["status_breakdown"],
    }
    print(f"serve_{tag} " + json.dumps(row) + f" [{card}]")
    no_fallback(f"serve {tag}", problems, results, svc.config.solo_backend)
    for r in rows:
        if r["engine"] != "ipm":
            continue  # the PDHG engine launches no kernel of ours
        if r["launches"] != 2 + r["bodies"] or (
                r["warmup_launches"] != (2 if r["warmup_bodies"] else 0) + r["warmup_bodies"]):
            fail(f"serve {tag}: dispatch {r['dispatch']} K1 launches {r['launches']} "
                 f"(+{r['warmup_launches']} warm-up) for start + warm selection + "
                 f"{r['bodies']} bodies (+{r['warmup_bodies']})")
    if launches == 0 or launches < bucket_launches or (not solo and launches != bucket_launches):
        fail(f"serve {tag}: {launches} K1 launches in the wave, {bucket_launches} in its "
             f"dispatches, {len(solo)} solo solves")
    return row, results


def start_cli_serve():
    """Step 9's ``cli serve --requests`` on 8 requests of 128×512, in a
    fresh process (started beside the gate, before any timed step)."""
    import tempfile

    d = tempfile.mkdtemp(prefix="dlps-cli-serve-")
    req = os.path.join(d, "requests.jsonl")
    with open(req, "w") as fh:
        for k in range(8):
            fh.write(json.dumps({"m": BM, "n": BN, "seed": k}) + "\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "serve", "--requests", req],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    atexit.register(_stop, proc)
    return proc, d


def finish_cli_serve(proc, d):
    """Wait for :func:`start_cli_serve`'s process: every request optimal."""
    import shutil

    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("cli serve: no answer within 600 s")
    shutil.rmtree(d, ignore_errors=True)
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or len(recs) != 8 or any(r["status"] != "optimal" for r in recs):
        fail(f"cli serve: rc {proc.returncode}, {[r.get('status') for r in recs]}\n{err[-3000:]}")
    print(f"cli serve: 8 requests of {BM}x{BN}, all optimal, iterations {[r['iterations'] for r in recs]}")


def serve_phase(torch, ne, card):
    """The serve phase (see the module note, step 9). Returns K1's parity
    and timing at the bucket shape and the waves' rows."""
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models import (
        correlated_request_stream,
        random_request_stream,
    )
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService

    parity = kernel_parity(torch, ne, BM, BN, "float64", batch=SERVE_BATCH)
    timing = kernel_timing(torch, ne, BM, BN, "float64", iters=20, warm=3, batch=SERVE_BATCH)
    print(f"parity normal_eq serve bucket float64 {shape_name(BM, BN, SERVE_BATCH)}: rel_err "
          f"{parity[0]:.3e} max_abs_err {parity[1]:.3e} (tol {TOL['float64']:.0e})")
    print(f"timing normal_eq serve bucket float64 {shape_name(BM, BN, SERVE_BATCH)}: kernel "
          f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, library(einsum) "
          f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}), "
          f"bound share {timing['bound_share']:.3f} [{card}]")

    waves = [
        ("cold", list(random_request_stream(1024, shapes=((96, 384), (BM, BN)), seed=21))),
        ("warm", list(random_request_stream(512, shapes=((96, 384), (BM, BN)), seed=22))),
        ("correlated", list(correlated_request_stream(512, shapes=((BM, BN),), n_models=4,
                                                      seed=23))[:256]),
    ]
    rows = {}
    max_iter = SolverConfig().max_iter

    def ipm_wave(svc, tag, problems):
        row, results = serve_wave(torch, ne, svc, tag, problems, card)
        # OPTIMAL, or the JAX package's verdict for a request its bucket
        # and its solo solve both left short of the tolerance after
        # max_iter iterations (scripts/port_serve_jax_verdicts.py gives
        # it on the CPU for these streams).
        limited = [k for k, r in enumerate(results) if r.status.value != "optimal"]
        bad = [(k, results[k].status.value, results[k].iterations) for k in limited
               if not (results[k].status.value == "iteration_limit" and results[k].retried_solo
                       and results[k].iterations == max_iter)]
        if bad:
            fail(f"serve {tag}: requests neither OPTIMAL nor at the iteration limit with "
                 f"the solo budget spent: {bad[:10]}")
        if limited:
            print(f"serve_{tag}: at the iteration limit after the solo ladder: "
                  f"{[(k, results[k].name) for k in limited]}")
        for r in results:
            if r.bucket is not None and tuple(r.bucket) != (BM, BN, SERVE_BATCH):
                fail(f"serve {tag}: request {r.name} in bucket {r.bucket}")
        worst = 0.0
        for k in range(0, len(problems), SERVE_SAMPLE):
            if results[k].status.value != "optimal":
                continue  # at the JAX package's verdict (checked above)
            h = highs_tight_objective(problems[k])
            e = abs(results[k].objective - h) / (1.0 + abs(h))
            worst = max(worst, e)
            if not e <= 1e-8:
                fail(f"serve {tag}: request {k} objective {results[k].objective!r} vs HiGHS {h!r}")
        row["highs_max_rel"] = worst
        print(f"serve_{tag}: {len(range(0, len(problems), SERVE_SAMPLE))} requests vs HiGHS max rel "
              f"{worst:.3e} (tol 1e-8)")
        rows[tag] = row

    # The JAX package's default service configuration: solo "auto", PDHG
    # routing on at pdhg_tol 1e-4.
    default_cfg = ServiceConfig(batch=SERVE_BATCH, flush_s=0.02)
    if not (default_cfg.solo_backend == "auto" and default_cfg.pdhg_routing
            and default_cfg.pdhg_tol == PDHG_TOL):
        fail(f"ServiceConfig defaults: {default_cfg}")
    with SolveService(default_cfg) as svc:
        for tag, problems in waves:
            ipm_wave(svc, tag, problems)
        # Where a warm wave's time goes: one more wave under the profiler.
        extra = list(random_request_stream(256, shapes=((96, 384), (BM, BN)), seed=24))
        (prow, _), prof = device_profile(
            torch, lambda: serve_wave(torch, ne, svc, "profiled", extra, card))
        print("profile_serve " + json.dumps({
            "wall_s": prow["wall_s"], "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": 1.0 - prof["device_busy_ms"] / (1e3 * prow["wall_s"]),
            **{k: v for k, v in prof.items() if k != "device_busy_ms"},
        }) + f" [{card}]")
        rows["pdhg"] = pdhg_wave(torch, ne, svc, card)
        stats = svc.stats()
    # Both solo routes on the same requests: the cold wave's last 256
    # again (its straggler, 1007, among them), their solo fallbacks on the
    # host's cpu-native, asked for by name.
    with SolveService(ServiceConfig(batch=SERVE_BATCH, flush_s=0.02,
                                    solo_backend="cpu-native")) as svc:
        ipm_wave(svc, "cold_host_solo", waves[0][1][-SERVE_BATCH:])
    if rows["cold_host_solo"]["graphs_captured"] or rows["cold_host_solo"]["programs_built"]:
        fail("serve cold_host_solo: a bucket program was built or captured")
    print(f"serve solo routes on the cold wave: auto {rows['cold']['solo_backends']} "
          f"{rows['cold']['solo_ms']} ms [{card}]; cpu-native "
          f"{rows['cold_host_solo']['solo_backends']} {rows['cold_host_solo']['solo_ms']} ms "
          f"[{host_cpu()}]")
    for tag in ("warm", "correlated"):
        if rows[tag]["programs_built"] or rows[tag]["graphs_captured"]:
            fail(f"serve {tag}: {rows[tag]['programs_built']} bucket programs built, "
                 f"{rows[tag]['graphs_captured']} graphs captured")
    if rows["correlated"]["warm_used"] <= 0:
        fail("serve correlated: no request started warm")
    from distributedlpsolver_tpu_torch.backends.batched import bucket_donation_report

    print("serve_bucket_memory " + json.dumps(bucket_donation_report(BM, BN, SERVE_BATCH))
          + f" [{card}]")
    print("serve_stats " + json.dumps({k: stats[k] for k in (
        "requests", "dispatches", "programs_compiled", "pack_ms_total", "overlap_ms_total",
        "warm_cache", "buckets")}) + f" [{card}]")

    return parity, timing, rows


def host_kkt(c, A, b, x, y, u=None) -> tuple:
    """(pinf, dinf, gap) of (x, y) on min cᵀx, Ax = b, 0 ≤ x ≤ u (u None:
    no upper bounds), in numpy — the PDHG engine's measures
    (first_order._kkt_error, _lanes_kkt): on a column with a finite upper
    bound a negative reduced cost is priced by the bound, not infeasible."""
    import numpy as np

    r = c - A.T @ y
    r_neg = np.minimum(r, 0.0)
    bounded = np.zeros(len(c), bool) if u is None else np.isfinite(u)
    pobj = float(c @ x)
    dobj = float(b @ y) + float(np.where(bounded, u if u is not None else 0.0, 0.0) @ r_neg)
    return (float(np.linalg.norm(b - A @ x) / (1 + np.linalg.norm(b))),
            float(np.linalg.norm(np.where(bounded, 0.0, r_neg)) / (1 + np.linalg.norm(c))),
            abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj)))


PDHG_TOL = 1e-4
# The JAX package's verdicts of the PDHG wave's requests that are not
# "<engine>:optimal" (scripts/port_serve_jax_verdicts.py --streams pdhg,
# on the CPU, each loose request at slot pdhg_seed(name, 256) of the JAX
# engine, where its lane runs the port's): none — every loose request is
# pdhg:optimal and every tight one (80, the plane's too) ipm:optimal there.
PDHG_JAX_NOT_OPTIMAL = {"pdhg_loose": {}, "pdhg_tight": {}}
# The PDHG bucket engine takes its verdict on the request padded into its
# bucket, as the JAX package's does; on the request's own data the same
# iterate's KKT errors run higher. The most any chip run has measured
# there (three runs of 1,024 loose requests): pinf 1.0010e-4, dinf
# 1.0026e-4, gap 5.26e-3. This bound, about twice that, fails the run on
# a regression.
PDHG_REQUEST_KKT_BOUND = (2e-4, 2e-4, 1e-2)
# A PDHG bucket body reads A 84 times: two products in each of its 40
# inner steps and two in each of its two KKT evaluations.
PDHG_A_READS = 2 * 40 + 2 * 2


def pdhg_wave(torch, ne, svc, card):
    """The PDHG wave (see the module note, step 13) on the running
    default service. Returns its row."""
    from distributedlpsolver_tpu_torch.backends import batched as tb
    from distributedlpsolver_tpu_torch.models import random_request_stream, sparse_request_stream
    from distributedlpsolver_tpu_torch.serve import pad_standard_form, standard_form

    loose = list(sparse_request_stream(1024, shapes=((96, 384), (BM, BN)), seed=25))
    tight = list(random_request_stream(64, shapes=((BM, BN),), seed=26))
    order = []  # (stream, index): one tight request after every 16 loose ones
    for k in range(len(tight)):
        order += [("pdhg_loose", j) for j in range(16 * k, 16 * k + 16)] + [("pdhg_tight", k)]
    problems = [loose[j][0] if st == "pdhg_loose" else tight[j] for st, j in order]
    tols = [loose[j][1] if st == "pdhg_loose" else 1e-8 for st, j in order]
    t0 = time.perf_counter()
    warmed = svc.warm_buckets(svc.scheduler.table.specs(), tol=PDHG_TOL)
    warm_s = time.perf_counter() - t0
    size0, caps0 = tb.bucket_cache_size(), tb.bucket_capture_count()
    row, results = serve_wave(torch, ne, svc, "pdhg", problems, card, tols=tols)
    built, captured = tb.bucket_cache_size() - size0, tb.bucket_capture_count() - caps0
    if built or captured:
        fail(f"serve pdhg: {built} bucket programs built, {captured} graphs captured in the wave")
    for (st, j), r in zip(order, results):
        engine = "pdhg" if st == "pdhg_loose" else "ipm"
        if r.engine != engine:
            fail(f"serve pdhg: {st} request {j} ({r.name}) on engine {r.engine}")
        allowed = PDHG_JAX_NOT_OPTIMAL[st].get(j, [f"{engine}:optimal"])
        if f"{r.engine}:{r.status.value}" not in allowed:
            fail(f"serve pdhg: {st} request {j} ({r.name}) {r.engine}:{r.status.value}, the JAX "
                 f"package's {allowed}")
    # The verdicts on the host: every OPTIMAL PDHG answer meets the tol on
    # the problem the engine solved (the request padded into its bucket),
    # and the same iterate on the request's own data the bound above.
    worst, own, own_over, checked = [0.0] * 3, [0.0] * 3, [0] * 3, 0
    for (st, _), p, r in zip(order, problems, results):
        if st != "pdhg_loose" or r.status.value != "optimal" or r.retried_solo:
            continue
        e = host_kkt(*pad_standard_form(*standard_form(p), r.bucket[0], r.bucket[1]), *r.lane)
        if max(e) > PDHG_TOL:
            fail(f"serve pdhg: {r.name} OPTIMAL at host pinf/dinf/gap {e} > {PDHG_TOL:g}")
        eo = host_kkt(p.c, p.A, p.rlb, r.lane[0][:p.n], r.lane[1][:p.m])
        if any(v > lim for v, lim in zip(eo, PDHG_REQUEST_KKT_BOUND)):
            fail(f"serve pdhg: {r.name} OPTIMAL at request pinf/dinf/gap {eo}, over the "
                 f"bound {PDHG_REQUEST_KKT_BOUND}")
        worst = [max(a, b) for a, b in zip(worst, e)]
        own = [max(a, b) for a, b in zip(own, eo)]
        own_over = [k + (v > PDHG_TOL) for k, v in zip(own_over, eo)]
        checked += 1
    disp = [d for d in svc.dispatch_report()[-row["dispatches"]:] if d["engine"] == "pdhg"]
    A_bytes = SERVE_BATCH * BM * BN * 8
    bound_body_ms = 1e3 * PDHG_A_READS * A_bytes / PEAK_BYTES
    replays = sum(d["replays"] for d in disp)
    body_ms = sum(d["replay_ms"] for d in disp) / max(replays, 1)
    out = {
        "warm_buckets": warmed, "warm_buckets_s": warm_s, "programs_built": built,
        "graphs_captured": captured,
        "loose": len(loose), "tight": len(tight),
        "crossovers": sum(r.retried_solo for (st, _), r in zip(order, results) if st == "pdhg_loose"),
        "pdhg_dispatches": len(disp), "pdhg_live": [d["live"] for d in disp],
        "pdhg_bodies": [d["bodies"] for d in disp], "pdhg_solve_ms": [d["solve_ms"] for d in disp],
        "pdhg_body_ms": body_ms, "pdhg_body_bound_ms": bound_body_ms,
        "pdhg_body_bound_share": bound_body_ms / body_ms if body_ms else None,
        "pdhg_iterations_mean": sum(r.iterations for (st, _), r in zip(order, results)
                                    if st == "pdhg_loose") / len(loose),
        "host_kkt_checked": checked, "host_kkt_max_padded": worst,
        "request_kkt_max": own, "request_kkt_over_tol": own_over,
        "request_kkt_bound": PDHG_REQUEST_KKT_BOUND,
    }
    print("serve_pdhg_check " + json.dumps(out) + f" [{card}]")
    row.update(out)
    return row


# -- the network plane (cli serve-http / route / elastic over the bucket engine) ------

PLANE_CLIENTS = 64
# Generated-spec requests: the first PLANE_GEN of random_request_stream(1024,
# seed=21) (the serve phase's cold wave) as specs (the stream's prefix: its
# draws run in order). The JAX package's verdict that is not OPTIMAL in the
# whole stream: request 1007 stops at the iteration limit in its bucket and
# its solo solve (scripts/port_serve_jax_verdicts.py).
PLANE_GEN = 128
PLANE_GEN_JAX_NOT_OPTIMAL = {1007: ["iteration_limit"]}
PLANE_LOOSE = 16  # the first loose requests of the PDHG wave's stream
PLANE_INLINE, PLANE_MPS = 16, 4  # requests 0-15 / 16-19 of the tight stream


def _http_json(url, body=None, timeout=600.0, raw=None, ctype="application/json"):
    """(code, parsed body, seconds) of one request; transport failures come
    back as 599."""
    import urllib.error
    import urllib.request

    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype} if data else {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read()), time.perf_counter() - t0
        except ValueError:
            return e.code, {}, time.perf_counter() - t0
    except (urllib.error.URLError, OSError) as e:
        return 599, {"error": str(e)}, time.perf_counter() - t0


def plane_wave_requests():
    """The HTTP wave: (kind, index, body, content type, problem, tol) of the
    PLANE_GEN generated specs, PLANE_INLINE inline ``c/A/b`` bodies,
    PLANE_MPS MPS text bodies and PLANE_LOOSE loose requests at tol 1e-4,
    interleaved (one inline body every 16 specs, one MPS body every 64,
    one loose request every 8)."""
    import tempfile

    import numpy as np

    from distributedlpsolver_tpu_torch.io import write_mps
    from distributedlpsolver_tpu_torch.models import (
        random_dense_lp,
        random_request_stream,
        sparse_request_stream,
    )

    shapes = ((96, 384), (BM, BN))
    rng = np.random.default_rng(21)  # random_request_stream's draws, as specs
    gen = []
    for k in range(PLANE_GEN):
        m, n = shapes[int(rng.integers(len(shapes)))]
        gen.append({"m": m, "n": n, "seed": int(rng.integers(2**31 - 1))})
    cold = list(random_request_stream(len(gen), shapes=shapes, seed=21))
    for spec, p in zip(gen[::97], cold[::97]):
        if random_dense_lp(spec["m"], spec["n"], seed=spec["seed"]).name != p.name:
            fail(f"plane: spec {spec} is not the cold stream's {p.name}")
    tight = list(random_request_stream(PLANE_INLINE + PLANE_MPS, shapes=((BM, BN),), seed=26))
    loose = list(sparse_request_stream(PLANE_LOOSE, shapes=shapes, seed=25))
    mk = lambda p: {"c": p.c.tolist(), "A": np.asarray(p.A).tolist(), "b": p.rlb.tolist()}
    inline = [("inline", k, {"problem": mk(p), "id": p.name}, "application/json", p, 1e-8)
              for k, p in enumerate(tight[:PLANE_INLINE])]
    mps = []
    with tempfile.TemporaryDirectory() as d:
        for k, p in enumerate(tight[PLANE_INLINE:]):
            path = os.path.join(d, f"{p.name}.mps")
            write_mps(p, path)
            with open(path) as fh:
                text = fh.read()
            mps.append(("mps", PLANE_INLINE + k, {"mps_text": text, "id": p.name},
                        "application/json", p, 1e-8))
    loose_b = [("loose", k, {"problem": mk(p), "id": p.name, "tol": tol}, "application/json", p,
                tol) for k, (p, tol) in enumerate(loose)]
    out = []
    for k, spec in enumerate(gen):
        out.append(("generated", k, spec, "application/json",
                    cold[k], 1e-8))
        if k % 16 == 0:
            out.append(inline[k // 16])
        if k % 64 == 0:
            out.append(mps[k // 64])
        if k % 8 == 0:
            out.append(loose_b[k // 8])
    return out


def _results_by_name(svcs):
    out = {}
    for svc in svcs:
        with svc._lock:
            for r in svc._results:
                out[r.name] = r
    return out


def plane_inprocess(torch, ne, card):
    """Step 17(a) of the module note: two services behind HTTP front-ends
    and a router, the HTTP wave through the router, its checks; then the
    same generated IPM requests through ``svc.submit`` in process."""
    import threading
    from queue import Empty, Queue

    from distributedlpsolver_tpu_torch.backends import batched as tb
    from distributedlpsolver_tpu_torch.net import NetConfig, SolveHTTPServer
    from distributedlpsolver_tpu_torch.net.router import Router, RouterConfig, RouterHTTPServer
    from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry
    from distributedlpsolver_tpu_torch.obs.stats import percentile
    from distributedlpsolver_tpu_torch.serve import (
        BucketSpec,
        ServiceConfig,
        SolveService,
        latency_summary,
        pad_standard_form,
        standard_form,
    )

    reqs = plane_wave_requests()
    spec = BucketSpec(BM, BN, SERVE_BATCH)
    svcs, fronts = [], []
    t0 = time.perf_counter()
    for _ in range(2):
        reg = MetricsRegistry()
        svc = SolveService(ServiceConfig(batch=SERVE_BATCH, flush_s=0.02), metrics=reg)
        svc.warm_buckets([spec])
        svc.warm_buckets([spec], tol=PDHG_TOL, engines=["pdhg"])
        svcs.append(svc)
        fronts.append(SolveHTTPServer(svc, NetConfig(), metrics=reg).start())
    router = Router([f.url for f in fronts], RouterConfig(poll_s=0.5), metrics=MetricsRegistry())
    router.start()
    rhttp = RouterHTTPServer(router, metrics=MetricsRegistry()).start()
    setup_s = time.perf_counter() - t0
    try:
        health = []
        for f in fronts:
            code, h, _ = _http_json(f.url + "/healthz", timeout=30)
            if code != 200 or h.get("devices_healthy") != 1 or not h.get("device", "").startswith("cuda"):
                fail(f"plane: {f.url}/healthz {code} {h}")
            health.append(h)
        rows0 = [len(s.dispatch_report()) for s in svcs]
        solo0 = sum(s.stats()["solo_retries"] for s in svcs)
        size0, caps0 = tb.bucket_cache_size(), tb.bucket_capture_count()
        work: "Queue" = Queue()
        for k, r in enumerate(reqs):
            work.put((k, r))
        answers = [None] * len(reqs)

        def client():
            while True:
                try:
                    k, (kind, i, body, ctype, p, tol) = work.get_nowait()
                except Empty:
                    return
                t_req = time.perf_counter()
                while True:
                    code, out, _ = _http_json(rhttp.url + "/v1/solve", body, ctype=ctype)
                    if code in (429, 503, 599) and time.perf_counter() - t_req < 300:
                        time.sleep(min(float(out.get("retry_after_s", 0.05) or 0.05), 1.0))
                        continue
                    break
                answers[k] = (code, out, time.perf_counter() - t_req)

        ne.normal_eq.launches = 0
        t_wave = time.perf_counter()
        threads = [threading.Thread(target=client, daemon=True) for _ in range(PLANE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t_wave
        for s in svcs:
            if not s.drain(timeout=300):
                fail("plane: a service did not drain")
        launches = ne.normal_eq.launches
        built, captured = tb.bucket_cache_size() - size0, tb.bucket_capture_count() - caps0
        rows = [r for s, n0 in zip(svcs, rows0) for r in s.dispatch_report()[n0:]]
        solo = sum(s.stats()["solo_retries"] for s in svcs) - solo0
        served = _results_by_name(svcs)
        rst = router.statusz()
        routed = {b["url"]: b["forwards"] for b in rst["backends"]}
        hedging = {k: rst["hedging"].get(k) for k in ("hedges_launched", "outcomes")}
        hedging["failovers"] = rst["failovers"]
    finally:
        rhttp.shutdown()
        router.shutdown()
        for f in fronts:
            f.shutdown()
    if any(a is None for a in answers):
        fail(f"plane: {sum(a is None for a in answers)} requests never answered")
    if built or captured:
        fail(f"plane: {built} bucket programs built, {captured} graphs captured in the wave")
    # Verdicts: OPTIMAL, or the JAX package's verdict for the request.
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig

    ipm_checked, worst_highs, pdhg_checked = 0, 0.0, 0
    worst_pad, worst_own = [0.0] * 3, [0.0] * 3
    max_iter = SolverConfig().max_iter
    n_ipm = 0
    for (kind, i, body, ctype, p, tol), (code, out, _) in zip(reqs, answers):
        status = out.get("status")
        # HTTP carries the status, not the engine (checked below).
        if kind == "generated":
            allowed = {"optimal", *PLANE_GEN_JAX_NOT_OPTIMAL.get(i, [])}
        else:
            st, default = ("pdhg_loose", "pdhg") if kind == "loose" else ("pdhg_tight", "ipm")
            allowed = {v.split(":")[1] for v in PDHG_JAX_NOT_OPTIMAL[st].get(
                i, [f"{default}:optimal"])}
        if code != 200 or status not in allowed:
            fail(f"plane: {kind} request {i} ({p.name}): HTTP {code} {status}, the JAX "
                 f"package's {sorted(allowed)}: {str(out)[:300]}")
        if status == "iteration_limit" and out.get("iterations") != max_iter:
            fail(f"plane: {kind} request {i} at the iteration limit after {out.get('iterations')}")
        if out.get("bucket") not in (None, [BM, BN, SERVE_BATCH]):
            fail(f"plane: {kind} request {i} in bucket {out.get('bucket')}")
        if kind != "loose":
            n_ipm += 1
            if status == "optimal" and n_ipm % SERVE_SAMPLE == 1:
                h = highs_tight_objective(p)
                e = abs(out["objective"] - h) / (1.0 + abs(h))
                worst_highs = max(worst_highs, e)
                ipm_checked += 1
                if not e <= 1e-8:
                    fail(f"plane: {p.name} objective {out['objective']!r} vs HiGHS {h!r}")
            continue
        r = served.get(p.name)
        if r is None:
            fail(f"plane: no service record of {p.name}")
        if r.engine != "pdhg":
            fail(f"plane: loose request {p.name} on engine {r.engine}")
        if status != "optimal" or r.retried_solo:
            continue
        e = host_kkt(*pad_standard_form(*standard_form(p), r.bucket[0], r.bucket[1]), *r.lane)
        eo = host_kkt(p.c, p.A, p.rlb, r.lane[0][:p.n], r.lane[1][:p.m])
        if max(e) > tol or any(v > lim for v, lim in zip(eo, PDHG_REQUEST_KKT_BOUND)):
            fail(f"plane: {p.name} OPTIMAL at padded {e}, request {eo} (bound "
                 f"{PDHG_REQUEST_KKT_BOUND})")
        worst_pad = [max(a, b) for a, b in zip(worst_pad, e)]
        worst_own = [max(a, b) for a, b in zip(worst_own, eo)]
        pdhg_checked += 1
    # K1: each IPM dispatch = start + warm selection + bodies; the wave's
    # launches = the dispatches' (+ the solo solves', if any).
    bucket_launches = 0
    for r in rows:
        if r["engine"] != "ipm":
            continue
        if r["launches"] != 2 + r["bodies"] or r["warmup_launches"] != (
                (2 if r["warmup_bodies"] else 0) + r["warmup_bodies"]):
            fail(f"plane: dispatch {r['dispatch']} K1 launches {r['launches']} for "
                 f"{r['bodies']} bodies")
        bucket_launches += r["launches"] + r["warmup_launches"]
    if launches == 0 or launches < bucket_launches or (not solo and launches != bucket_launches):
        fail(f"plane: {launches} K1 launches in the wave, {bucket_launches} in its dispatches, "
             f"{solo} solo solves")
    lat = [a[2] * 1e3 for a in answers]
    row = {
        "requests": len(reqs), "clients": PLANE_CLIENTS, "setup_s": setup_s, "wall_s": wall,
        "rps": len(reqs) / wall, "latency_ms_p50": percentile(lat, 50),
        "latency_ms_p99": percentile(lat, 99),
        "kinds": {k: sum(r[0] == k for r in reqs) for k in ("generated", "inline", "mps", "loose")},
        "routed": list(routed.values()), "router": hedging, "dispatches": len(rows),
        "live_mean": sum(r["live"] for r in rows) / max(len(rows), 1),
        "engines": {e: sum(r["engine"] == e for r in rows) for e in ("ipm", "pdhg")},
        "normal_eq_launches": launches, "bucket_launches": bucket_launches, "solo": solo,
        "programs_built": built, "graphs_captured": captured,
        "highs_checked": ipm_checked, "highs_max_rel": worst_highs,
        "pdhg_checked": pdhg_checked, "pdhg_padded_kkt_max": worst_pad,
        "pdhg_request_kkt_max": worst_own,
        "healthz": [{k: h[k] for k in ("devices_healthy", "device")} for h in health],
        "statuses": {s: sum(a[1].get("status") == s for a in answers)
                     for s in sorted({a[1].get("status") for a in answers})},
    }
    print("plane_http " + json.dumps(row) + f" [{card}]")
    # The same generated IPM requests through svc.submit, on a fresh service
    # (its warm cache empty, as the HTTP wave's was).
    gen = [r[4] for r in reqs if r[0] == "generated"]
    with SolveService(ServiceConfig(batch=SERVE_BATCH, flush_s=0.02)) as svc:
        t0 = time.perf_counter()
        futs = [svc.submit(p) for p in gen]
        if not svc.drain(timeout=600):
            fail("plane: the in-process service did not drain")
        wall_in = time.perf_counter() - t0
        res = [f.result() for f in futs]
    summ = latency_summary(res)
    inproc = {"requests": len(gen), "wall_s": wall_in, "rps": len(gen) / wall_in,
              "latency_ms_p50": summ["latency_ms_p50"], "latency_ms_p99": summ["latency_ms_p99"],
              "status": summ["status_breakdown"]}
    print("plane_inprocess " + json.dumps(inproc) + f" [{card}]")
    for s in svcs:
        s.shutdown()
    return row


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            fail(f"plane cli: {what}")
        time.sleep(0.2)


def _journal_pending(plane) -> int:
    """Jobs admitted but not finished, over the CLI leg's backends."""
    return sum(_http_json(plane.procs[n].url + "/statusz", timeout=30)[1]["stats"]["journal"]
               ["pending"] for n in ("be-a", "be-b"))


def _obs_agg(reg, router_url):
    """``cli obs-agg --json`` over the registry's two backends and the
    router. Its exit code must be its own reconciliation's verdict (0
    consistent, 1 a mismatch)."""
    agg = subprocess.run(
        [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "obs-agg", "--registry",
         reg, "--router", router_url, "--json"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    if not agg.stdout.strip():
        fail(f"plane cli: obs-agg rc {agg.returncode}: {agg.stderr[-2000:]}")
    fleet = json.loads(agg.stdout)
    if (agg.returncode != (0 if fleet["reconciliation"]["consistent"] else 1)
            or fleet["rollup"]["totals"].get("backends") != 2):
        fail(f"plane cli: obs-agg rc {agg.returncode}, "
             f"{fleet['rollup']['totals'].get('backends')} backends: {agg.stderr[-2000:]}")
    return fleet, agg.returncode


def _agg_totals(fleet) -> dict:
    t = fleet["reconciliation"]["totals"]
    return {k: t[k] for k in ("forwards_total", "hedges_launched", "cancels", "failovers",
                              "backend_records", "journal_results")}


def plane_cli(card):
    """Step 17(b) of the module note: ``cli serve-http`` ×2 + ``cli route``
    as processes on the card, a kill -9 and relaunch mid-wave, ``cli
    elastic`` scaling out and in, ``cli report`` and ``cli obs-agg``."""
    import shutil
    import tempfile

    from distributedlpsolver_tpu_torch.net.chaos import (
        ChaosPlane,
        free_port,
        journal_duplicate_solves,
    )

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="dlps-plane-", dir=os.path.join(ROOT, "build"))
    plane = ChaosPlane(work, device="cuda")
    out = {}
    ladder = os.path.join(work, "ladder.json")
    with open(ladder, "w") as fh:
        json.dump([{"m": BM, "n": BN, "batch": SERVE_BATCH}], fh)
    reg = os.path.join(work, "registry.json")
    logs = {n: os.path.join(work, f"{n}.serve.jsonl") for n in ("be-a", "be-b")}
    pool = None
    t0 = time.perf_counter()
    try:
        # The elastic controller's first backend comes up beside the two
        # served below; its burst runs beside the steps after them (its
        # fleet shares nothing with theirs but the card).
        elastic = plane_elastic_start(plane, work, ladder)
        bes = {}
        for name in ("be-a", "be-b"):
            bes[name] = plane.spawn_backend(
                name, port=free_port(), buckets_json=ladder,
                extra_flags=["--registry", reg, "--flush-ms", "20", "--batch", str(SERVE_BATCH),
                             "--log-jsonl", logs[name]])
            if "--device" not in bes[name].cmd or "cuda" not in bes[name].cmd:
                fail(f"plane cli: {bes[name].cmd}")
        for name, be in bes.items():
            if not plane.wait_ready(be, 300):
                fail(f"plane cli: {name} did not come up:\n{open(be.log_path).read()[-3000:]}")
        router = plane.spawn_router("router", [], reg)
        if not plane.wait_ready(router, 60):
            fail("plane cli: the router did not come up")
        out["up_s"] = time.perf_counter() - t0
        pool = ThreadPoolExecutor(1)
        fut_elastic = pool.submit(plane_elastic, plane, *elastic)
        _wait(lambda: sum(b["healthy"] for b in _http_json(router.url + "/statusz")[1]
                          .get("backends", [])) == 2, 60, "the router never saw both backends")
        # A routed wave on the healthy fleet; once it is drained, cli
        # obs-agg must reconcile the router's ledger with the backends'
        # records and journals, every check "ok".
        with ThreadPoolExecutor(16) as ex:
            answers = list(ex.map(lambda k: _http_json(
                router.url + "/v1/solve", {"m": BM, "n": BN, "seed": 6900 + k}), range(16)))
        for k, (code, resp, _) in enumerate(answers):
            if code != 200 or resp.get("status") != "optimal":
                fail(f"plane cli: routed request {k}: {code} {str(resp)[:200]}")
        _wait(lambda: _journal_pending(plane) == 0, 60, "the journals never drained")
        fleet, rc = _obs_agg(reg, router.url)
        checks = {c["name"]: c["status"] for c in fleet["reconciliation"]["checks"]}
        if rc != 0 or set(checks.values()) != {"ok"} or len(checks) != 3:
            fail(f"plane cli: obs-agg on the healthy fleet rc {rc}: "
                 f"{json.dumps(fleet['reconciliation'])[:3000]}")
        out["obs_agg_healthy"] = {"rc": rc, "checks": checks, "totals": _agg_totals(fleet)}
        ids = []
        for k in range(32):
            code, resp, _ = _http_json(router.url + "/v1/solve",
                                       {"m": BM, "n": BN, "seed": 7000 + k, "async": True})
            if code != 202:
                fail(f"plane cli: async request {k}: {code} {resp}")
            ids.append(resp["id"])
        plane.kill9("be-a")  # mid-wave: acknowledged work is unfinished
        t_kill = time.perf_counter()
        be_a = plane.restart("be-a", wait=False)
        if not plane.wait_ready(be_a, 300):
            fail(f"plane cli: be-a did not come back:\n{open(be_a.log_path).read()[-3000:]}")
        out["relaunch_s"] = time.perf_counter() - t_kill
        verdicts = {}
        deadline = time.monotonic() + 300
        while len(verdicts) < len(ids):
            if time.monotonic() > deadline:
                fail(f"plane cli: unresolved ids {sorted(set(ids) - set(verdicts))}")
            for rid in ids:
                if rid in verdicts:
                    continue
                code, resp, _ = _http_json(router.url + f"/v1/solve/{rid}", timeout=30)
                if code == 404:
                    fail(f"plane cli: id {rid} answered 404 after the relaunch")
                if code in (200, 504) and "status" in resp:
                    verdicts[rid] = resp["status"]
            time.sleep(0.1)
        if not set(verdicts.values()) <= {"optimal", "timeout"}:
            fail(f"plane cli: verdicts {verdicts}")
        dups = {n: journal_duplicate_solves(be.journal_dir) for n, be in plane.procs.items()
                if be.journal_dir}
        if any(dups.values()):
            fail(f"plane cli: duplicate solves {dups}")
        out["verdicts"] = {s: sum(v == s for v in verdicts.values()) for s in set(verdicts.values())}
        out["duplicate_solves"] = dups
        # obs-agg after the crash. A backend's request records count its
        # process's work, so those be-a finished before the kill died with
        # it; its journal kept them. The fleet balances once they are
        # counted from the journal: routed attempts = the backends' records
        # + what be-a lost (its journal results - its records), within the
        # cancels, and be-b lost nothing. The reconciliation is consistent
        # exactly when be-a lost nothing.
        _wait(lambda: _journal_pending(plane) == 0, 60, "the journals never drained")
        fleet, rc = _obs_agg(reg, router.url)
        rec = fleet["reconciliation"]
        tot = rec["totals"]
        checks = {c["name"]: c["status"] for c in rec["checks"]}
        lost = {}
        for row in fleet["backends"].values():
            st = row["statusz"]["stats"]
            lost[os.path.realpath(st["journal"]["dir"])] = st["journal"]["results"] - st["requests"]
        lost_a = lost.pop(os.path.realpath(plane.procs["be-a"].journal_dir), None)
        slack = tot["forwards_total"] + tot["hedges_launched"] - tot["backend_records"] - (lost_a or 0)
        if (lost_a is None or lost_a < 0 or len(lost) != 1 or any(lost.values())
                or not 0 <= slack <= tot["cancels"] or tot["journal_pending"]
                or checks["hedge_outcomes_accounted"] != "ok"
                or rec["consistent"] != (lost_a == 0)):
            fail(f"plane cli: obs-agg after the crash rc {rc}, be-a lost {lost_a}, others {lost}, "
                 f"slack {slack}: {json.dumps(rec)[:3000]}")
        out["obs_agg_after_crash"] = {"rc": rc, "lost_with_be_a": lost_a, "checks": checks,
                                      "totals": _agg_totals(fleet)}
        # Each backend serves a few more requests, sent to it directly,
        # then its /statusz must show the bucket programs' K1 launches.
        launches = {}
        for name in ("be-a", "be-b"):
            be = plane.procs[name]
            for k in range(4):
                code, resp, _ = _http_json(be.url + "/v1/solve", {"m": BM, "n": BN,
                                                                  "seed": 7100 + k})
                if code != 200 or resp.get("status") != "optimal":
                    fail(f"plane cli: {name} request {k}: {code} {str(resp)[:200]}")
            st = _http_json(be.url + "/statusz")[1]["stats"]
            launches[name] = st["dispatch_totals"].get("launches", 0)
            if launches[name] <= 0 or not st["device"].startswith("cuda"):
                fail(f"plane cli: {name} /statusz {st['device']} K1 launches {launches[name]}")
        out["statusz_k1_launches"] = launches
        # Drain the backends.
        for name in ("be-a", "be-b"):
            _http_json(plane.procs[name].url + "/quitquitquit", {}, timeout=30)
        for name in ("be-a", "be-b"):
            try:
                plane.procs[name].popen.wait(timeout=120)
            except subprocess.TimeoutExpired:
                fail(f"plane cli: {name} did not exit after its drain")
        rep = subprocess.run(
            [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "report", *logs.values(),
             "--json"], capture_output=True, text=True, timeout=120, cwd=ROOT)
        if rep.returncode != 0:
            fail(f"plane cli: report rc {rep.returncode}: {rep.stderr[-2000:]}")
        report = json.loads(rep.stdout)
        out["report_keys"] = sorted(report)[:12]
        out["elastic"] = fut_elastic.result()
    finally:
        if pool is not None:
            pool.shutdown(wait=False)  # its result is in hand, or the run has failed
        plane.shutdown_all()
    out["wall_s"] = time.perf_counter() - t0
    print("plane_cli " + json.dumps(out) + f" [{card}]")
    shutil.rmtree(work, ignore_errors=True)  # journals and logs: kept only on a failure
    return out


def plane_elastic_start(plane, work, ladder):
    """Start ``cli elastic --min-backends 1 --max-backends 2``; returns its
    registry and log paths."""
    reg = os.path.join(work, "elastic-registry.json")
    log = os.path.join(work, "elastic.jsonl")
    plane.spawn_controller("elastic", reg, min_backends=1, max_backends=2, buckets_json=ladder,
                           extra_flags=["--poll-s", "0.25", "--load-high", "16",
                                        "--out-sustain-s", "0.5", "--in-sustain-s", "2",
                                        "--cooldown-s", "1", "--log-jsonl", log,
                                        "--backend-flag", f"--flush-ms 20 --batch {SERVE_BATCH}"])
    return reg, log


def plane_elastic(plane, reg, log):
    """The controller of :func:`plane_elastic_start` scales out under a
    burst of async requests, and back in when it ends."""
    import threading

    def events():
        try:
            with open(log) as fh:
                return [json.loads(ln) for ln in fh if ln.strip()]
        except (OSError, ValueError):
            return []

    def live():
        try:
            with open(reg) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return []
        return [u for u, e in doc.get("backends", {}).items() if not e.get("ejected")]

    t0 = time.perf_counter()
    _wait(lambda: len(live()) >= 1, 300, "elastic: the first backend never registered")
    first = live()[0].rstrip("/")
    stop = threading.Event()
    sent = [0]

    def flood():
        k = 0
        while not stop.is_set():
            _http_json(first + "/v1/solve", {"m": BM, "n": BN, "seed": 9000 + k, "async": True},
                       timeout=30)
            k += 1
            sent[0] += 1

    threads = [threading.Thread(target=flood, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    burst_out = lambda ev: next((k for k, e in enumerate(ev) if e["event"] == "scale_out"
                                 and e["reason"] != "min_backends"), None)
    try:
        _wait(lambda: burst_out(events()) is not None, 300,
              "elastic: no scale-out under the burst")
        _wait(lambda: len(live()) >= 2, 300, "elastic: the second backend never registered")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    t_out = time.perf_counter() - t0
    # Back in once the burst is served: an idle scale-in after the burst's
    # scale-out.
    _wait(lambda: any(e["event"] == "scale_in" and e["reason"] == "idle"
                      for e in events()[burst_out(events()):]), 300,
          "elastic: no idle scale-in after the burst")
    t_in = time.perf_counter() - t0 - t_out
    # SIGINT: the controller drains its pool and exits; then no backend
    # it spawned is left serving.
    ctl = plane.procs["elastic"].popen
    ctl.send_signal(signal.SIGINT)
    try:
        ctl.wait(timeout=180)
    except subprocess.TimeoutExpired:
        ctl.kill()
        fail("elastic: the controller did not exit on SIGINT")
    for url in live():
        if _http_json(url.rstrip("/") + "/healthz", timeout=5)[0] != 599:
            fail(f"elastic: {url} still serving after the controller's exit")
    ev = events()
    return {"scale_out": [e["reason"] for e in ev if e["event"] == "scale_out"],
            "scale_in": [e["reason"] for e in ev if e["event"] == "scale_in"],
            "burst_requests": sent[0], "to_scale_out_s": t_out, "to_scale_in_s": t_in}


def plane_phase(torch, ne, card, shared=None) -> int:
    """Step 17 of the module note. Returns the HTTP wave's K1 launches.
    With ``shared`` (a whole run) step 21's ``cli serve-slice`` leg runs
    beside the plane's processes, after the timed in-process wave; its
    row is left in ``shared["slice_cli"]``."""
    _T0[0] = t0 = time.perf_counter()
    http = plane_inprocess(torch, ne, card)
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(slice_cli, card) if shared is not None else None
        plane_cli(card)
        if fut is not None:
            shared["slice_cli"] = fut.result()
    print(f"plane phase: {time.perf_counter() - t0:.1f} s")
    return http["normal_eq_launches"]


def serve_bucket_row(parity, timing, launches) -> dict:
    """K1's row at the serve bucket (128, 512, 256), f64: the serve phase's
    and the network plane's launches."""
    return {
        "name": "normal_eq (serve bucket)",
        "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        # One launch for every lane of a bucket at a time.
        "launches": launches,
        "max_abs_err": parity[1],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "bound_share": timing["bound_share"],
        "library_ms": timing["library_ms"],
        "kernel_ms": timing["ms"],
        "dtypes": ["float64"],
        "shape": timing["shape"],
    }


def default_entry_phase(torch, ne, cuda_row, r_cuda):
    """The JAX package's default entry points on the card (see the module
    note, step 10). Returns the row of the default solve."""
    import tempfile

    import numpy as np

    from distributedlpsolver_tpu_torch import cli
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.io import read_mps
    from distributedlpsolver_tpu_torch.io.mps import write_mps
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    p = random_dense_lp(2048, 10240, seed=0)
    ne.normal_eq.launches = 0
    t0 = time.perf_counter()
    r = solve(p, backend="auto", tol=1e-8)  # the CLI's and the service's default
    wall = time.perf_counter() - t0
    launches = ne.normal_eq.launches
    bitwise = bool(np.array_equal(np.asarray(r.x), np.asarray(r_cuda.x)))
    row = {"problem": p.name, "backend": r.backend, "status": r.status.value,
           "iterations": r.iterations, "objective": r.objective, "wall_s": wall,
           "solve_s": r.solve_time, "normal_eq_launches": launches,
           "x_bitwise_equal_to_cuda": bitwise}
    print("main_path_default " + json.dumps(row))
    if r.backend != "auto(cuda)" or not bitwise:
        fail(f"solve(backend='auto'): {r.backend}, x bitwise equal to backend='cuda': {bitwise}")
    if launches != cuda_row["normal_eq_launches"] or r.iterations != cuda_row["iterations"]:
        fail(f"solve(backend='auto'): {launches} K1 launches / {r.iterations} it against "
             f"backend='cuda''s {cuda_row['normal_eq_launches']} (1 + bodies) / "
             f"{cuda_row['iterations']}")
    # The CLI with no --backend, on an MPS file large enough for the card.
    with tempfile.TemporaryDirectory() as d:
        path, xf = os.path.join(d, "dense256x1024.mps"), os.path.join(d, "x.npy")
        write_mps(random_dense_lp(256, 1024, seed=0), path)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["solve", path, "--json", "--quiet", "--x-out", xf])
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        x_cli = np.load(xf)
        ref = solve(read_mps(path), backend=get_backend("cuda"), tol=1e-8)
    cli_bitwise = bool(np.array_equal(x_cli, np.asarray(ref.x)))
    print(f"cli_default: {out['name']} {out['status']} backend {out['backend']} iterations "
          f"{out['iterations']} objective {out['objective']!r}; x bitwise equal to backend='cuda': "
          f"{cli_bitwise}")
    if rc != 0 or out["backend"] != "auto(cuda)" or not cli_bitwise:
        fail(f"cli solve with no --backend: rc {rc}, {out}, x bitwise {cli_bitwise}")
    return row


def route_and_solo_phase(card):
    """The route table and the solo cost on both routes (see the module
    note, steps 11 and 12)."""
    import glob

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.io import read_mps
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import (
        correlated_request_stream,
        random_batched_lp,
        random_dense_lp,
        random_request_stream,
    )
    from distributedlpsolver_tpu_torch.supervisor import SupervisorConfig, supervised_solve

    cold = list(random_request_stream(1024, shapes=((96, 384), (BM, BN)), seed=21))
    corr = list(correlated_request_stream(512, shapes=((BM, BN),), n_models=4, seed=23))
    inputs = [(os.path.relpath(f, ROOT), read_mps(f))
              for f in sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures", "*.mps")))]
    inputs += [("main path 2048x10240", random_dense_lp(2048, 10240, seed=0)),
               ("request 128x512 (cold 1007)", cold[1007]),
               ("request 128x512 (correlated 187)", corr[187]),
               ("batched member 775", random_batched_lp(BATCH, BM, BN, seed=0).problem(775))]
    for name, p in inputs:
        route = route_of(p)
        taken = None
        if route != "cuda":
            fail(f"route table: {name} routes to {route} on the card")
        if name.endswith(".mps"):  # the others' solves are checked where they run
            taken = solve(p, backend="auto", tol=1e-8).backend
            if taken != f"auto({route})":
                fail(f"route table: {name} routes to {route}, solved by {taken}")
        print(f"route {name} ({p.m}x{p.n}, {p.m * p.n} entries): {route}"
              + (f"; solved by {taken}" if taken else ""))
    cpu = host_cpu()
    # The cold wave's straggler alone (its 200 iterations are the solo
    # ladder's whole budget; the other two were cut for the script's time).
    for name, p in inputs[-3:-2]:
        for backend in ("cpu-native", "cuda"):
            be = get_backend(backend)
            t0 = time.perf_counter()
            r = supervised_solve(p, backend=be, tol=1e-8,
                                 supervisor=SupervisorConfig(backoff_base=0.01))
            ms = 1e3 * (time.perf_counter() - t0)
            if r.faults or r.backend != backend:
                fail(f"solo {name} on {backend}: served by {r.backend}, faults {r.faults}")
            where = f"[{cpu}]" if backend == "cpu-native" else f"[{card}]"
            # The same solve without the supervisor (no watchdog, no
            # per-iteration checkpoint; the cuda one on the fused loop).
            t0 = time.perf_counter()
            r_plain = solve(p, backend=get_backend(backend), tol=1e-8)
            ms_plain = 1e3 * (time.perf_counter() - t0)
            print(f"solo_cost {name} {r.backend}: supervised {ms:.1f} ms, {r.iterations} it "
                  f"({ms / max(r.iterations, 1):.2f} ms/it), {r.status.value}; unsupervised "
                  f"{ms_plain:.1f} ms, {r_plain.iterations} it "
                  f"({ms_plain / max(r_plain.iterations, 1):.2f} ms/it) {where}")


def scaled_form_iterate(p, r):
    """The presolved, Ruiz-scaled interior form the driver solved for
    ``p``, with ``r``'s x and y mapped into it: the rows and columns
    presolve kept, then x / Dc and y / Dr (``models/scaling.py``). Fails
    unless the interior form is the reduced problem itself, which is what
    makes the mapping exact."""
    import numpy as np

    from distributedlpsolver_tpu_torch.models.presolve import presolve
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form
    from distributedlpsolver_tpu_torch.models.scaling import equilibrate

    reduced, info = presolve(p)
    inf = to_interior_form(reduced)
    x = np.asarray(r.x)[info.col_live]
    y = np.asarray(r.y)[info.row_live]
    if (inf.m, inf.n) != (len(y), len(x)) or not np.array_equal(inf.recover(x), x):
        fail(f"solo pdhg: the interior form {inf.m}x{inf.n} is not the presolved problem "
             f"{len(y)}x{len(x)}; the returned iterate cannot be mapped into it")
    inf_s, scaling = equilibrate(inf)
    return inf_s, x / scaling.dc, y / scaling.dr


def solo_pdhg_phase(card):
    """The solo PDHG engine on the card (see the module note, step 14).
    Its verdict is taken, as the driver runs every backend, on the
    presolved, Ruiz-scaled interior form: the host recomputes the KKT
    errors there, from the returned iterate mapped into that form, and on
    the problem as given."""
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    p = random_dense_lp(2048, 10240, seed=0)
    be = get_backend("pdlp")
    t0 = time.perf_counter()
    r = solve(p, backend=be, tol=PDHG_TOL)
    wall = time.perf_counter() - t0
    (rep,) = be.phase_report
    inf_s, x_s, y_s = scaled_form_iterate(p, r)
    e = host_kkt(inf_s.c, inf_s.A, inf_s.b, x_s, y_s, inf_s.u)
    e_given = host_kkt(p.c, p.A, p.rlb, r.x, r.y)
    bound_body_ms = 1e3 * PDHG_A_READS * p.m * p.n * 8 / PEAK_BYTES
    body_ms = rep["replay_ms"] / max(rep["replays"], 1)
    row = {"problem": p.name, "backend": r.backend, "status": r.status.value,
           "inner_iterations": r.iterations, "wall_s": wall, "solve_s": r.solve_time,
           "setup_s": r.setup_time, "inner_steps_per_s": r.iterations / r.solve_time,
           "host_pinf_dinf_gap_scaled": e, "host_pinf_dinf_gap_as_given": e_given,
           "reported_pinf_dinf_gap": [r.pinf, r.dinf, r.rel_gap],
           "body_ms": body_ms, "body_bound_ms": bound_body_ms,
           "body_bound_share": bound_body_ms / body_ms if body_ms else None, **rep}
    print("solo_pdhg " + json.dumps(row) + f" [{card}]")
    if r.status.value == "optimal" and max(e) > PDHG_TOL:
        fail(f"solo pdhg: OPTIMAL at host pinf/dinf/gap {e} > {PDHG_TOL:g} on the scaled form")
    if r.status.value not in ("optimal", "iteration_limit"):
        fail(f"solo pdhg: {r.status.value}")
    return row, p, r


def pdlp_mesh_case() -> dict:
    """pdlp's column mesh as a case of the sharded phase's gloo world of 2:
    the solo phase's problem through ``SolverConfig(mesh_shape=(2,))``."""
    return {"backend": "pdlp", "mesh_shape": [2], "instance": "dense", **SHARDED_MAIN,
            "tol": PDHG_TOL, "return_xy": True}


def pdlp_mesh_nccl1(torch, card, p, r0, row0) -> dict:
    """pdlp's column mesh on an NCCL world of one in this process, asked for
    the way a config asks (``mesh_shape=(1,)``): x bit for bit with the solo
    phase's ``mesh=None`` answer ``r0``, the same inner steps, the loop
    captured with its all-reduces inside (``Mesh.all_reduce`` runs in
    Python only in the eager body, the capture and outside the loop, far
    fewer times than the replays' bodies hold). Returns its row."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.distributed import world as world_lib
    from distributedlpsolver_tpu_torch.distributed.launcher import free_port
    from distributedlpsolver_tpu_torch.ipm import solve

    world = world_lib.init_world(world_lib.WorldConfig(
        coordinator=f"127.0.0.1:{free_port()}", rank=0, world_size=1, device="cuda"))
    calls, restore = counting_all_reduces()
    try:
        be = get_backend("pdlp")
        t0 = time.perf_counter()
        r = solve(p, backend=be, tol=PDHG_TOL, mesh_shape=(1,))
        wall = time.perf_counter() - t0
        pg = be.mesh.pg_backend if be.mesh is not None else None
    finally:
        restore()
        world.close()
    (rep,) = be.phase_report
    body_ms = rep["replay_ms"] / max(rep["replays"], 1)
    # Each body: 2 sums a step for CHECK_EVERY steps, 2 for each of two KKT errors.
    per_body = 2 * 40 + 4
    row = {"problem": p.name, "world": "nccl world of one (in this process)", "pg_backend": pg,
           "status": r.status.value, "inner_iterations": r.iterations,
           "mesh_none_inner_iterations": r0.iterations, "x_bits_equal_mesh_none": True,
           "wall_s": wall, "solve_s": r.solve_time, "body_ms": body_ms,
           "mesh_none_body_ms": row0["body_ms"], "python_all_reduce_calls": len(calls),
           "all_reduces_in_replayed_bodies": per_body * rep["replays"], **rep}
    print(f"pdlp_mesh_nccl1 {json.dumps(row)} [{card}]")
    if pg != "nccl" or not np.array_equal(r.x, r0.x) or r.iterations != r0.iterations:
        fail(f"pdlp mesh_shape=(1,) on {pg}: {r.status.value} {r.iterations} inner steps, x equal "
             f"{np.array_equal(r.x, r0.x)}, against mesh=None's {r0.iterations}")
    if not rep["captured"] or rep["replays"] <= 0 or not 0 < len(calls) < per_body * rep["replays"]:
        fail(f"pdlp mesh_shape=(1,): captured {rep['captured']}, {rep['replays']} replays, "
             f"{len(calls)} all-reduce calls in Python")
    return row


def pdlp_gloo2_check(p, r0, outs, wall, card) -> dict:
    """pdlp over the gloo world of 2 (``outs``: each rank's case result):
    both ranks the same x bits, OPTIMAL, the solo phase's host KKT checks
    (the scaled form at the tol, ``PDHG_REQUEST_KKT_BOUND`` on the given
    data) and the objective within 2·tol·(1 + |obj|) of mesh=None's."""
    import types

    import numpy as np

    name = "pdlp gloo world of 2"
    shas = {o["x_sha256"] for o in outs}
    o = outs[0]
    x, y = np.asarray(o["x"]), np.asarray(o["y"])
    for rank, orank in enumerate(outs):
        if orank["status"] != "optimal" or orank["pg_backend"] != "gloo":
            fail(f"{name}: rank {rank} {orank['status']} on {orank['pg_backend']}")
        if orank["phase_report"][0]["captured"]:
            fail(f"{name}: rank {rank} captured the loop over gloo")
    if len(shas) != 1:
        fail(f"{name}: the ranks' x differ: {shas}")
    inf_s, x_s, y_s = scaled_form_iterate(p, types.SimpleNamespace(x=x, y=y))
    e = host_kkt(inf_s.c, inf_s.A, inf_s.b, x_s, y_s, inf_s.u)
    e_given = host_kkt(p.c, p.A, p.rlb, x, y)
    off = abs(o["objective"] - r0.objective)
    if max(e) > PDHG_TOL or any(v > b for v, b in zip(e_given, PDHG_REQUEST_KKT_BOUND)):
        fail(f"{name}: host pinf/dinf/gap {e} on the scaled form, {e_given} on the given data")
    if not off <= 2 * PDHG_TOL * (1 + abs(r0.objective)):
        fail(f"{name}: objective {o['objective']!r} against mesh=None's {r0.objective!r}")
    rep = o["phase_report"][0]
    row = {"problem": p.name, "world": name, "status": o["status"],
           "inner_iterations": o["iterations"], "mesh_none_inner_iterations": r0.iterations,
           "objective": o["objective"], "mesh_none_objective": r0.objective,
           "x_bits_equal_across_ranks": True, "shard_shape": o["shard_shape"],
           "host_pinf_dinf_gap_scaled": e, "host_pinf_dinf_gap_as_given": e_given,
           "solve_s_rank0": o["solve_s"], "wall_s_rank0": o["wall_s"],
           "body_ms_rank0": rep["eager_ms"] / max(rep["eager"], 1),
           "captured": rep["captured"], "capture_off_reason": rep["capture_off_reason"],
           "world_wall_s": wall}
    print(f"pdlp_mesh_gloo2 {json.dumps(row)} [{card}]")
    return row



# -- the sparse tier (sparse-iterative) ----------------------------------------

# The JAX package's verdicts for the sparse phase's instances, on the CPU
# (scripts/port_sparse_jax_verdicts.py): status, IPM iterations, CG
# iterations, preconditioner and objective of its sparse-iterative backend.
SPARSE_JAX = {
    "acceptance_20k": {"status": "optimal", "iterations": 32, "cg_iters": 2870,
                       "precond": "bordered", "objective": 31216.655298566173},
    "ildl": {"status": "optimal", "iterations": 15, "cg_iters": 6164, "precond": "ildl",
             "objective": 144.48842430662728},
    "storm_ladder": {"status": "optimal", "iterations": 25, "cg_iters": 1831,
                     "precond": "bordered", "objective": 3205.0281049553932},
}
# stormG2_1000's published shape (Mittelmann's large sparse LP set:
# 528,185 × 1,259,121, 3,341,696 nonzeros; 1,000 scenarios of 528 rows and
# 1,259 columns, 121 first-stage columns). The generator has no
# first-stage rows, so its m is 185 short: 528,000 × 1,259,121.
STORM_FULL = dict(num_scenarios=1000, block_m=528, block_n=1259, first_stage_n=121, seed=1,
                  t_nnz_per_row=2, w_nnz_per_row=4)
# Its objective through auto on the H100 (PERF.md §5, PR 7's runs), which
# a solve must keep within 1e-8 relative whatever the rounding of its CG
# iterations; and the host's gap bound on its answer.
STORM_FULL_OBJECTIVE = 826963.9984573115
STORM_FULL_GAP = 1e-8
# The reference's own acceptance instance (tests/test_sparse.py): 20,480 ×
# 30,784.
STORM_20K = dict(num_scenarios=320, block_m=64, block_n=96, first_stage_n=64, seed=1)
# Relative error of the ELL kernel against its plain version (f64).
ELL_TOL = 1e-12
# Bytes the kernel's sliced-ELL layout may move at the full storm shape,
# over the live entries' bound (``ell_bound``), in each direction.
ELL_LAYOUT_LIMIT = 1.10


def ell_bound(op, rows, n_in) -> tuple:
    """Least time of one product with the matrix of ``op`` (or its
    transpose) in whatever layout: the larger of the bytes it must move —
    each of the ``op.nnz`` live entries read once (value and int32
    column), ``rows + 1`` int32 row pointers, the ``n_in`` input entries
    that a live entry reads (a row block's empty columns read nothing)
    read once, the output written once — over the memory rate, and its multiply-adds
    over the f64 peak. The pad slots of the kernel's layout (a slice's
    rows padded to its widest) and its perm in place of row pointers are
    bytes it moves beyond this bound. Returns (ms, "bytes"|"operations",
    bytes)."""
    es = op.vals.element_size()
    nbytes = op.nnz * (es + 4) + (rows + 1) * 4 + n_in * es + rows * es
    t_bytes, t_ops = nbytes / PEAK_BYTES, 2.0 * op.nnz / PEAK_FLOPS["float64"]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes


def ell_layout_bytes(lay, n_in) -> int:
    """Bytes the kernel reads and writes on its sliced-ELL layout ``lay``:
    every stored slot (pads included) and the heavy rows' entries, the
    index (slice offsets, perm, chunk index), the heavy rows' partials
    written and read and their counters, the ``n_in`` live input entries
    once and the output once."""
    es = lay.vals.element_size()
    return (lay.vals.numel() * (es + 4) + lay.index.numel() * 4 + 2 * lay.n_chunks * es
            + 2 * lay.n_heavy * 4 + n_in * es + lay.rows * es)


def ell_cases(torch, op, seed=7):
    """(name, kernel call, plain call, CSR of the library yardstick, its
    input, bound, the kernel's layout, its live input entries) for A·v,
    Aᵀ·w and diag(A·D·Aᵀ) + reg of ``op``. An input entry is live where its
    column (of A for A·v and the diagonal, of Aᵀ for Aᵀ·w) holds an entry:
    0.89 of v for the whole storm matrix, 0.45 for its first half's rows."""
    import numpy as np

    from distributedlpsolver_tpu_torch.ops.ell_spmv import ell_spmv_reference

    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn(op.n, dtype=torch.float64, device="cuda", generator=g)
    w = torch.randn(op.m, dtype=torch.float64, device="cuda", generator=g)
    d = torch.rand(op.n, dtype=torch.float64, device="cuda", generator=g) + 0.1
    A = op.to_scipy()
    n_live = int((np.diff(A.tocsc().indptr) > 0).sum())
    m_live = int((np.diff(A.tocsr().indptr) > 0).sum())

    def csr(M):
        M = M.tocsr()
        return torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr.astype(np.int64)), torch.from_numpy(M.indices.astype(np.int64)),
            torch.from_numpy(M.data), size=M.shape).to("cuda")

    reg = 1e-8
    return [
        ("A·v", lambda: op.matvec(v), lambda: ell_spmv_reference(op.vals, op.cols, v, op.tail()),
         csr(A), v, ell_bound(op, op.m, n_live), op.sell, n_live),
        ("Aᵀ·v", lambda: op.rmatvec(w), lambda: ell_spmv_reference(op.tvals, op.tcols, w, op.ttail()),
         csr(A.T), w, ell_bound(op, op.n, m_live), op.tsell, m_live),
        ("diag(A·D·Aᵀ)", lambda: op.normal_diag(d, reg),
         lambda: ell_spmv_reference(op.vals, op.cols, d, op.tail(), square=True, reg=reg),
         csr(A.multiply(A)), d, ell_bound(op, op.m, n_live), op.sell, n_live),
    ]


def ell_phase(torch, op, tag, card, timing=True):
    """The kernel against its plain version on the card for each function
    of ``op`` (relative error ≤ ELL_TOL, two launches bit for bit) and,
    with ``timing``, the kernel, the plain version and cuSPARSE (one
    ``torch.sparse`` CSR product of the same matrix) with CUDA events
    beside the bytes bound: paced by the host as a caller's loop launches
    them (``ms``, ``library_ms``), and queued with the L2 cold before each
    launch (``ms_cold``, ``library_ms_cold``; ``cuda_ms_cold``); and the
    layout's bytes held to ELL_LAYOUT_LIMIT of the bound. Returns one row
    per function."""
    rows = {}
    flush = torch.zeros(2**25, dtype=torch.float32, device="cuda") if timing else None  # 128 MiB
    for name, kern, plain, S, x, (b_ms, b_by, nbytes), lay, n_in in ell_cases(torch, op):
        layout = ell_layout_bytes(lay, n_in)
        shape = (f"the sliced-ELL layout moves {layout / 1e6:.1f} MB ({layout / nbytes:.3f} of the "
                 f"bound): {lay.n_slices} slices, {lay.n_chunks} heavy chunks on {lay.n_heavy} "
                 "heavy rows")
        if timing and not layout <= ELL_LAYOUT_LIMIT * nbytes:
            fail(f"ell {name} {tag}: {shape}, over {ELL_LAYOUT_LIMIT} of the bound")
        k1, k2, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            fail(f"ell {name} {tag}: two launches differ")
        mx = (k1 - ref).abs().max().item()
        rel = mx / max(ref.abs().max().item(), 1e-300)
        if not rel <= ELL_TOL:
            fail(f"ell {name} {tag}: relative error {rel:.3e} > {ELL_TOL:.0e}")
        row = {"function": name, "instance": tag, "rel_err": rel, "max_abs_err": mx,
               "bytes": nbytes, "layout_bytes": layout, "slices": lay.n_slices,
               "heavy_chunks": lay.n_chunks, "heavy_rows": lay.n_heavy, "bound_ms": b_ms,
               "bound_by": b_by}
        if timing:
            # Paced by the host, as a caller's loop launches them; then
            # queued with the L2 flushed before each launch (the matrix and
            # the vector cold, as the CG loop finds them after its
            # preconditioner's gigabytes of reads), the kernel and cuSPARSE
            # in turns.
            row["ms"] = cuda_ms(torch, kern, iters=50, warm=5)
            row["plain_ms"] = cuda_ms(torch, plain, iters=20, warm=3)
            row["library_ms"] = cuda_ms(torch, lambda: S @ x, iters=50, warm=5)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            kc, lc = [], []
            for t in (kc, lc, lc, kc):
                t.append(cuda_ms_cold(torch, kern if t is kc else (lambda: S @ x), iters=50, warm=3,
                                      flush=flush))
            row["ms_cold"], row["library_ms_cold"] = sum(kc) / 2, sum(lc) / 2
            row["ms_cold_turns"], row["library_ms_cold_turns"] = kc, lc
            row["bound_share_cold"] = row["bound_ms"] / row["ms_cold"]
            print(f"timing ell {name} {tag}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"cuSPARSE {row['library_ms']:.4f} ms (paced by the host); L2 cold, queued: kernel "
                  f"{row['ms_cold']:.4f} ms (turns {', '.join(f'{t:.4f}' for t in kc)}), cuSPARSE "
                  f"{row['library_ms_cold']:.4f} ms (turns {', '.join(f'{t:.4f}' for t in lc)}); bound "
                  f"{row['bound_ms']:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB), bound share "
                  f"{row['bound_share']:.3f} (cold {row['bound_share_cold']:.3f}); {shape} [{card}]")
        print(f"parity ell {since()} {name} {tag}: rel_err {rel:.3e} max_abs_err {mx:.3e} (tol {ELL_TOL:.0e}), "
              "two launches bitwise equal")
        rows[name] = row
        del k1, k2, ref, S
    del flush
    torch.cuda.empty_cache()
    return rows


_T0 = [0.0]


def since() -> str:
    """Seconds into the sparse phase, for its lines."""
    return f"[{time.perf_counter() - _T0[0]:.1f} s]"


def ell_counts_reset():
    from distributedlpsolver_tpu_torch.ops import ell_normal_diag, ell_spmv

    ell_spmv.launches = ell_spmv.launches_t = 0
    ell_normal_diag.launches = 0


def ell_counts() -> dict:
    """Launches per function and direction since the last reset."""
    from distributedlpsolver_tpu_torch.ops import ell_normal_diag, ell_spmv

    return {"A·v": ell_spmv.launches, "Aᵀ·v": ell_spmv.launches_t,
            "diag(A·D·Aᵀ)": ell_normal_diag.launches}


def memory_guard(name, be, m):
    """No device operand of the backend may approach the (m, m) normal
    matrix: bytes below 0.02·m²·8 and no (≥ m, ≥ m) shape (the reference's
    acceptance guard)."""
    rep = be.memory_report()
    for key, info in rep.items():
        shp = info["shape"]
        if info["nbytes"] >= 0.02 * m * m * 8 or (len(shp) >= 2 and min(shp[-2:]) >= m):
            fail(f"{name}: operand {key} {info} approaches the normal matrix (m = {m})")
    return max(v["nbytes"] for v in rep.values())


def sparse_verdict(name, r, rep, jax_ref=None, iterations=True):
    """OPTIMAL at 1e-8, and with ``jax_ref`` the JAX package's
    preconditioner, iteration count and objective (≤ 1e-8 relative)."""
    if r.status.value != "optimal" or not max(r.rel_gap, r.pinf, r.dinf) <= 1e-8:
        fail(f"{name}: {r.status.value}, rel_gap {r.rel_gap:.2e} pinf {r.pinf:.2e} dinf {r.dinf:.2e}")
    if jax_ref is None:
        return
    rel = abs(r.objective - jax_ref["objective"]) / (1.0 + abs(jax_ref["objective"]))
    if rep["precond"] != jax_ref["precond"] or not rel <= 1e-8 or (
            iterations and r.iterations != jax_ref["iterations"]):
        fail(f"{name}: {rep['precond']} {r.iterations} it objective {r.objective!r} against the JAX "
             f"package's {jax_ref['precond']} {jax_ref['iterations']} it {jax_ref['objective']!r} "
             f"({rel:.3e})")


def profile_one_step(torch, at: int):
    """Solve hooks (``ipm/driver.py::SolveHooks``) that run IPM step ``at``
    under ``torch.profiler`` (``device_profile``) and time every step."""
    from distributedlpsolver_tpu_torch.ipm.driver import SolveHooks

    class ProfileOneStep(SolveHooks):
        def __init__(self):
            self.at, self.prof, self.step_s = at, None, {}

        def run_step(self, step_fn, iteration):
            t0 = time.perf_counter()
            if iteration == at:
                out, self.prof = device_profile(torch, step_fn)
            else:
                out = step_fn()
            self.step_s[iteration] = time.perf_counter() - t0
            return out

    return ProfileOneStep()


def highs_storm20k() -> int:
    """The body of ``--highs-storm20k``: HiGHS's objective for the
    acceptance instance, on the last line of standard output. Its interior
    point method with crossover (``highs-ipm``) at feasibility tolerances
    of 1e-10; the dual simplex, HiGHS's default, takes minutes there."""
    import scipy.optimize as sopt

    from distributedlpsolver_tpu_torch.models import storm_sparse_lp

    p = storm_sparse_lp(**STORM_20K)
    t0 = time.perf_counter()
    h = sopt.linprog(p.c, A_eq=p.A, b_eq=p.rlb, bounds=(0, None), method="highs-ipm",
                     options={"primal_feasibility_tolerance": 1e-10,
                              "dual_feasibility_tolerance": 1e-10})
    print(json.dumps({"status": int(h.status), "message": h.message, "objective": h.fun,
                      "seconds": time.perf_counter() - t0}))
    return 0


def start_highs_storm20k():
    """HiGHS on the acceptance instance in a second process (one core, no
    device); the sparse phase waits for it at its end."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--highs-storm20k"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    atexit.register(_stop, proc)
    return proc


def sparse_phase(torch, card, shared):
    """The matrix-free sparse tier on the card (module note, step 16).
    Returns the kernels-line rows of the sliced-ELL kernel. HiGHS's answer
    for the acceptance instance is computed meanwhile in a second
    process (in a whole run started before the plane phase,
    ``shared["highs"]``; else here) and waited for at the end."""
    highs = shared.pop("highs", None) or start_highs_storm20k()
    try:
        return _sparse_phase(torch, card, highs, shared)
    finally:
        if highs.poll() is None:
            highs.kill()
        highs.communicate()


def _sparse_phase(torch, card, highs, shared):
    import numpy as np
    import scipy.sparse as sp

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import netlib_sparse_lp, random_dense_lp, storm_sparse_lp
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form
    from distributedlpsolver_tpu_torch.models.scaling import equilibrate
    from distributedlpsolver_tpu_torch.ops import KernelError, pcg, sparse
    from distributedlpsolver_tpu_torch.supervisor import (
        FaultKind,
        InjectedFault,
        SupervisorConfig,
        supervised_solve,
    )

    # 1. The full stormG2_1000-shape instance, its host setup by part.
    _T0[0] = t0 = time.perf_counter()
    p_full = storm_sparse_lp(**STORM_FULL)
    parts = {"generate_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    inf = to_interior_form(p_full)
    parts["interior_form_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inf_s, _ = equilibrate(inf)
    parts["ruiz_s"] = time.perf_counter() - t0
    if not (sp.issparse(inf.A) and sp.issparse(inf_s.A)):
        fail("the storm instance's A was densified on the way to the backend")
    t0 = time.perf_counter()
    op = sparse.from_scipy(inf_s.A, device="cuda")
    torch.cuda.synchronize()
    parts["from_scipy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prec = pcg.BorderedPrecond(inf_s.A, inf_s.block_structure, device="cuda")
    torch.cuda.synchronize()
    parts["bordered_setup_s"] = time.perf_counter() - t0
    m_full, n_full = p_full.A.shape
    print(f"sparse_setup {since()} {p_full.name} {m_full}x{n_full} nnz {p_full.A.nnz}: "
          + json.dumps(parts) + f"; hybrid ELL widths A {op.vals.shape[1]}, Aᵀ {op.tvals.shape[1]}, "
          f"Aᵀ tail {0 if op.ttail_vals is None else op.ttail_vals.numel()}; sliced ELL A "
          f"{op.sell.n_slices} slices, Aᵀ {op.tsell.n_slices} slices + {op.tsell.n_chunks} chunks "
          f"on {op.tsell.n_heavy} heavy rows; A_blocks "
          f"{tuple(prec.blocks.A_blocks.shape)}")
    del prec

    # 2. The kernel against its plain version and cuSPARSE: the full
    # storm operator (the scaled A the solve runs on), and a netlib-like
    # operator with an uneven row profile and a real tail in both
    # directions.
    ell_full = ell_phase(torch, op, f"storm {m_full}x{n_full}", card)
    del op
    netlib = netlib_sparse_lp(20000, 40000, seed=3)
    op_n = sparse.from_scipy(netlib.A, device="cuda")
    print(f"netlib 20000x40000: ELL widths {op_n.vals.shape[1]} / {op_n.tvals.shape[1]}, tails "
          f"{0 if op_n.tail_vals is None else op_n.tail_vals.numel()} / "
          f"{0 if op_n.ttail_vals is None else op_n.ttail_vals.numel()}")
    ell_phase(torch, op_n, "netlib 20000x40000", card, timing=False)
    del op_n
    torch.cuda.empty_cache()

    # 3. The full shape through the default route, auto, with one step
    # profiled; counts reset just before and read just after.
    route = route_of(p_full)
    if route != "sparse-iterative":
        fail(f"storm full shape routes to {route}")
    hooks = profile_one_step(torch, at=10)
    be = get_backend("auto")
    torch.cuda.reset_peak_memory_stats()
    ell_counts_reset()
    t0 = time.perf_counter()
    r = solve(p_full, backend=be, tol=1e-8, hooks=hooks)
    wall = time.perf_counter() - t0
    full_counts = ell_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    inner = be.inner
    rep = inner.cg_report()
    if be.name != "auto(sparse-iterative)" or rep["precond"] != "bordered":
        fail(f"storm full shape: {be.name}, precond {rep['precond']}")
    sparse_verdict("storm full shape", r, rep)
    if full_counts["A·v"] <= 0 or full_counts["Aᵀ·v"] <= 0:
        fail(f"storm full shape: ELL kernel launches {full_counts}")
    x, y = np.asarray(r.x), np.asarray(r.y)
    viol = p_full.max_violation(x)
    pobj, dobj = float(p_full.c @ x), float(p_full.rlb @ y)
    gap = abs(pobj - dobj) / (1.0 + abs(pobj))
    obj_rel = abs(r.objective - STORM_FULL_OBJECTIVE) / abs(STORM_FULL_OBJECTIVE)
    if not viol <= 1e-6 or not gap <= STORM_FULL_GAP or not obj_rel <= 1e-8:
        fail(f"storm full shape: max_violation {viol:.3e}, host gap {gap:.3e}, objective "
             f"{r.objective!r} ({obj_rel:.2e} from {STORM_FULL_OBJECTIVE!r})")
    max_full = memory_guard("storm full shape", inner, m_full)
    prof = hooks.prof or {}
    steps = sorted(hooks.step_s.items())
    print(f"sparse_full {since()} " + json.dumps({
        "problem": p_full.name, "backend": be.name, "status": r.status.value,
        "iterations": r.iterations, "objective": r.objective, "objective_rel": obj_rel,
        "max_violation": viol, "host_rel_gap": gap, "wall_s": wall, "setup_s": r.setup_time, "solve_s": r.solve_time,
        "cg_iters": rep["cg_iters"], "cg_per_iteration": rep["cg_per_iteration"],
        "newton_solves": rep["newton_solves"], "host_syncs": rep["host_syncs"],
        "host_syncs_per_newton_solve": rep["host_syncs"] / max(rep["newton_solves"], 1),
        "step_s": [round(s, 4) for _, s in steps], "launches": full_counts,
        # The profiled step pays the profiler's start-up; the rest do not.
        "solve_s_without_profiled_step": r.solve_time - hooks.step_s.get(hooks.at, 0.0),
        "peak_device_gb": peak_gb, "max_operand_bytes": max_full,
    }))
    print("sparse_full_profile " + json.dumps({
        "iteration": hooks.at, "cg_iters": rep["cg_per_iteration"][hooks.at]
        if len(rep["cg_per_iteration"]) > hooks.at else None, **prof}))
    # The rows phase holds its world of one to this solve (auto routes to
    # sparse-iterative, the same code bit for bit) instead of solving again;
    # its wall and solve times include the profiled step's.
    shared["sparse_full"] = dict(x=x, y=np.asarray(r.y), iterations=r.iterations, wall_s=wall,
                                 cg_iters=rep["cg_iters"], setup_s=r.setup_time,
                                 solve_s=r.solve_time, setup_parts=be.setup_report)
    del r, be, inner, x, y
    torch.cuda.empty_cache()

    # 4. The ILDL rung: precond "auto" escalates Jacobi → ILDL and finishes
    # on sparse-iterative (Jacobi's normal_diag runs until then).
    p_ildl = netlib_sparse_lp(120, 220, seed=10)
    be = get_backend("sparse-iterative")
    ell_counts_reset()
    r = solve(p_ildl, backend=be, tol=1e-8)
    ildl_counts = ell_counts()
    rep = be.cg_report()
    sparse_verdict("ildl rung", r, rep, SPARSE_JAX["ildl"])
    if min(ildl_counts.values()) <= 0:
        fail(f"ildl rung: kernel launches {ildl_counts}")
    print(f"sparse_ildl {since()} {p_ildl.name}: {r.status.value} {r.iterations} it, precond {rep['precond']}, "
          f"cg {rep['cg_iters']} (JAX {SPARSE_JAX['ildl']['cg_iters']}), objective {r.objective!r}, "
          f"launches {ildl_counts}")

    # 5. The ladder: a supervised cuda solve whose crashes exhaust its
    # rungs degrades to sparse-iterative on the card ...
    p_lad = storm_sparse_lp(32, 64, 96, 64, seed=1)
    plan = [InjectedFault(FaultKind.CRASH, iteration=1, times=None, backend="cuda")]
    r = supervised_solve(p_lad, backend="cuda", tol=1e-8,
                         supervisor=SupervisorConfig(backoff_base=0.001, fault_plan=plan))
    actions = [f.action for f in r.faults]
    if r.backend != "sparse-iterative" or "degrade:sparse-iterative" not in actions:
        fail(f"ladder: served by {r.backend}, faults {actions}")
    ref = SPARSE_JAX["storm_ladder"]
    rel = abs(r.objective - ref["objective"]) / (1.0 + abs(ref["objective"]))
    if r.status.value != "optimal" or not rel <= 1e-8:
        fail(f"ladder: {r.status.value} objective {r.objective!r} vs {ref['objective']!r}")
    print(f"sparse_ladder {since()} {p_lad.name}: cuda -> {r.backend}, faults {actions}, {r.status.value} "
          f"{r.iterations} it, objective rel {rel:.2e} to the JAX package's")
    # ... and a K1 that fails to load ends in the loader's error, not
    # degraded.
    ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")
    saved = (ne._lib, ne._nvcc, ne.BUILD_DIR)

    def no_nvcc():
        raise KernelError("nvcc withheld by chip_smoke.py (forced K1 load failure)")

    ne._lib, ne._nvcc, ne.BUILD_DIR = None, no_nvcc, os.path.join(ROOT, "build", "dlps_torch", "absent")
    try:
        supervised_solve(random_dense_lp(64, 160, seed=0), backend="cuda", tol=1e-8,
                         supervisor=SupervisorConfig(backoff_base=0.001))
        fail("ladder: a K1 load failure did not raise")
    except KernelError as e:
        print(f"sparse_ladder {since()} K1 load failure: {type(e).__name__} raised, not degraded ({e})")
    finally:
        ne._lib, ne._nvcc, ne.BUILD_DIR = saved

    # 6. The reference's acceptance instance: the JAX package's verdict,
    # HiGHS, the memory guard.
    p20 = storm_sparse_lp(**STORM_20K)
    be = get_backend("sparse-iterative")
    ell_counts_reset()
    t0 = time.perf_counter()
    r20 = solve(p20, backend=be, tol=1e-8, max_iter=200)
    wall20 = time.perf_counter() - t0
    c20 = ell_counts()
    rep20 = be.cg_report()
    sparse_verdict("storm 20k", r20, rep20, SPARSE_JAX["acceptance_20k"])
    max20 = memory_guard("storm 20k", be, p20.A.shape[0])
    # The rows phase's gloo worlds are held to this mesh=None solve.
    shared["storm20k"] = dict(objective=r20.objective, iterations=r20.iterations,
                              cg_iters=rep20["cg_iters"], solve_s=r20.solve_time)
    out, err = highs.communicate(timeout=1200)
    if highs.returncode != 0:
        fail(f"HiGHS on storm 20k: exit {highs.returncode}\n{err[-3000:]}")
    h = json.loads(out.strip().splitlines()[-1])
    if h["status"] != 0:
        fail(f"HiGHS did not solve storm 20k: {h['message']}")
    h20 = h["objective"]
    rel_h = abs(r20.objective - h20) / (1.0 + abs(h20))
    if not rel_h <= 1e-7:
        fail(f"storm 20k: objective {r20.objective!r} vs HiGHS {h20!r}: {rel_h:.3e}")
    if c20["A·v"] <= 0 or c20["Aᵀ·v"] <= 0:
        fail(f"storm 20k: ELL kernel launches {c20}")
    print(f"sparse_acceptance {since()} " + json.dumps({
        "problem": p20.name, "status": r20.status.value, "iterations": r20.iterations,
        "objective": r20.objective, "jax_objective": SPARSE_JAX["acceptance_20k"]["objective"],
        "highs_rel": rel_h, "highs_s": h["seconds"], "cg_iters": rep20["cg_iters"],
        "jax_cg_iters": SPARSE_JAX["acceptance_20k"]["cg_iters"], "precond": rep20["precond"],
        "newton_solves": rep20["newton_solves"], "host_syncs": rep20["host_syncs"],
        "wall_s": wall20, "setup_s": r20.setup_time, "solve_s": r20.solve_time,
        "launches": c20, "max_operand_bytes": max20,
    }))

    rows = []
    for name, replaces, counts in (("A·v", "distributedlpsolver_tpu/ops/sparse.py:123", full_counts),
                                   ("Aᵀ·v", "distributedlpsolver_tpu/ops/sparse.py:133", full_counts),
                                   ("diag(A·D·Aᵀ)", "distributedlpsolver_tpu/ops/sparse.py:143",
                                    ildl_counts)):
        t = ell_full[name]
        rows.append({
            "name": "ell_normal_diag" if name.startswith("diag") else f"ell_spmv ({name})",
            "route": "cuda",
            "source": "distributedlpsolver_tpu_torch/csrc/ell_spmv.cu",
            "replaces": replaces,
            # A·v and Aᵀ·v: the full-shape auto solve, each direction's
            # own count; ell_normal_diag: the ILDL rung's Jacobi steps
            # (the bordered path never calls it).
            "launches": counts[name],
            "launches_path": "ildl rung" if name.startswith("diag") else "storm full shape (auto)",
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_share": t["bound_share"],
            "library_ms": t["library_ms"], "library": "cuSPARSE CSR SpMV (torch.sparse)",
            "ms_cold": t["ms_cold"], "library_ms_cold": t["library_ms_cold"],
            "bound_share_cold": t["bound_share_cold"],
            "layout_bytes": t["layout_bytes"], "slices": t["slices"],
            "heavy_chunks": t["heavy_chunks"], "dtypes": ["float64"], "shape": [m_full, n_full],
        })
    print(f"sparse phase {since()}")
    return rows



# The block-angular tier (step 18): the pds family's classes at full width,
# block_angular_lp(K, 432, 1400, link, seed=0, sparse=True, density=0.005).
PDS_KW = dict(seed=0, sparse=True, density=0.005)
PDS10 = (32, 432, 1400, 800)  # 14,624 × 44,800; K=32, mb=432, nb=1263, link=800, n0=5831
PDS20 = (64, 432, 1400, 1600)  # 29,248 × 89,600; K=64, mb=432, nb=1265, link=1600, n0=11853
# The JAX package's block backend on the CPU, single-phase f64 (its path
# off the TPU): ``JAX_PLATFORMS=cpu python scripts/port_block_jax_verdicts.py``.
BLOCK_JAX = {
    "pds10": {"status": "optimal", "iterations": 34, "objective": 22707.91725093084},
    "pds20": {"status": "optimal", "iterations": 31, "objective": 46665.29021638479},
    # The pds-10 file through its CLI's solve, auto routed as on an
    # accelerator (presolve, then the detection pass: block).
    "pds10_file": {"status": "optimal", "iterations": 35, "objective": 22707.91724371506},
}
# The JAX package's recorded objectives: pds-10 through cpu-sparse
# (.pds10_cpu.json), pds-20 on the TPU (SCALE_RUNS.json "pds20_tpu").
PDS10_CPU_SPARSE = 22707.91725211212
PDS20_TPU = 46665.29021635177
BLOCK_OBJ_TOL = 1e-8


def block_counts_reset(ne):
    ne.normal_eq.launches = ne.normal_eq.launches_batched = ne.normal_eq.launches_split = 0


def block_counts(ne) -> dict:
    """K1 launches since the reset: the K lanes (batched launches) and
    the linking matrix (the rest), and the split launches among them
    (each also launched the split's sum kernel)."""
    lanes = ne.normal_eq.launches_batched
    return {"lanes": lanes, "link": ne.normal_eq.launches - lanes,
            "split": ne.normal_eq.launches_split}


def block_solve(torch, ne, name, p, jax_ref, recorded, backend, **kw):
    """One solve through ``backend`` with K1's launches reset just before
    and read just after; held to OPTIMAL, ``max_violation ≤ 1e-6``, the
    JAX package's status, iterations and objective (≤ 1e-8 relative) and
    the recorded objective (≤ 1e-8). Returns the result, its row and the
    backend."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve

    be = get_backend(backend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_counts_reset(ne)
    t0 = time.perf_counter()
    r = solve(p, backend=be, tol=1e-8, **kw)
    wall = time.perf_counter() - t0
    counts = block_counts(ne)
    peak = torch.cuda.max_memory_allocated() / 1e9
    inner = getattr(be, "inner", be)
    phases = be.phase_report
    bodies = sum(row["bodies"] for row in phases)
    viol = p.max_violation(np.asarray(r.x))
    rel_rec = abs(r.objective - recorded) / abs(recorded)
    row = {
        "problem": p.name, "backend": be.name, "status": r.status.value,
        "iterations": r.iterations, "objective": r.objective, "max_violation": viol,
        "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf, "objective_rel_recorded": rel_rec,
        "layout": dict(inner.layout._asdict()), "wall_s": wall, "setup_s": r.setup_time,
        "solve_s": r.solve_time, "ms_per_iteration": 1e3 * r.solve_time / max(r.iterations, 1),
        **{f"setup_{k}": v for k, v in inner.setup_report.items()},
        "bodies": bodies, "masked": sum(row["masked"] for row in phases),
        "capture_ms": [row["capture_ms"] for row in phases],
        "replay_ms": [row["replay_ms"] for row in phases],
        "k1_launches": counts, "peak_device_gb": peak,
    }
    if r.status.value != "optimal" or not viol <= 1e-6:
        fail(f"{name}: {r.status.value}, max_violation {viol:.3e}")
    if jax_ref is not None:
        rel = abs(r.objective - jax_ref["objective"]) / (1.0 + abs(jax_ref["objective"]))
        row["objective_rel_jax"] = rel
        if (r.status.value != jax_ref["status"] or r.iterations != jax_ref["iterations"]
                or not rel <= BLOCK_OBJ_TOL):
            fail(f"{name}: {r.status.value} {r.iterations} it objective {r.objective!r} against the "
                 f"JAX package's {jax_ref['status']} {jax_ref['iterations']} it "
                 f"{jax_ref['objective']!r} ({rel:.3e})")
    if not rel_rec <= BLOCK_OBJ_TOL:
        fail(f"{name}: objective {r.objective!r} is {rel_rec:.3e} from the recorded {recorded!r}")
    # Each factorization launches K1 twice: the start, then every body;
    # the linking launch splits where the chooser says so.
    lay = inner.layout
    split = ne.split_count(lay.link, lay.K * lay.nb + lay.n0, 1, ne.sm_count("cuda"))
    row["link_splits"] = split
    if not (counts["lanes"] == counts["link"] == 1 + bodies
            and counts["split"] == (counts["link"] if split > 1 else 0)):
        fail(f"{name}: K1 launches {counts} for 1 + {bodies} factorizations (link splits {split})")
    return r, row, be


# The tier on a mesh (step 18's mesh legs): pds-10 over gloo worlds of 2
# and 4 sharing the card (the shrink's survivors: 33 blocks over 3), rank
# 0's K lanes there; and what a mesh solve is held to against mesh=None's
# (another route: the linking factor's explicit inverse, ``ops/dist_chol.py``).
BLOCK_RANK_SHAPES = {"gloo2": (16, 2), "gloo4": (8, 4), "shrunk": (11, 3)}
BLOCK_RANK_PATHS = {
    "gloo2": "pds-10 block over a gloo world of 2 on one card, rank 0's solve",
    "gloo4": "pds-10 supervised block over a gloo world of 4 on one card, rank 0, before "
             "shrink:4->3 (the launches are the run's on both shapes)",
    "shrunk": "the same run after shrink:4->3 (K 32 -> 33 over 3; the run's launches on "
              "both shapes)",
}
BLOCK_MESH_ITERS = 2
BLOCK_WORLD_TIMEOUT_S = 300.0


def pds_spec(K, mb, nb, link, **kw) -> dict:
    """A world case of the pds class ``(K, mb, nb, link)`` on ``block``."""
    return {"backend": "block", "instance": "block", "blocks": K, "block_m": mb, "block_n": nb,
            "link": link, "tol": 1e-8, **PDS_KW, **kw}


def block_gloo2_case() -> dict:
    return pds_spec(*PDS10, return_xy=True)


def block_shrink_case() -> dict:
    return pds_spec(*PDS10, return_xy=True, supervisor={"backoff_base": 0.001},
                    faults=[{"kind": "device_lost", "iteration": SHRINK_FAULT_ITERATION,
                             "device_ids": [3]}])


def mesh_none_check(name, o, ref_rows, iterations=True):
    """A mesh solve against the phase's mesh=None solves of the problem:
    OPTIMAL, the objective within ``BLOCK_OBJ_TOL`` relative and, with
    ``iterations``, the iterations within ±``BLOCK_MESH_ITERS``."""
    ref = ref_rows[0]
    rel = abs(o["objective"] - ref["objective"]) / (1.0 + abs(ref["objective"]))
    off = abs(o["iterations"] - ref["iterations"]) if iterations else 0
    if o["status"] != "optimal" or off > BLOCK_MESH_ITERS or not rel <= BLOCK_OBJ_TOL:
        fail(f"{name}: {o['status']} {o['iterations']} it objective {o['objective']!r} against "
             f"mesh=None's {ref['iterations']} it {ref['objective']!r} ({rel:.3e})")
    return rel


def counting_all_reduces():
    """``(calls, restore)``: ``Mesh.all_reduce`` wrapped to record each
    call's tensor shape until ``restore()``."""
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    calls, real = [], mesh_lib.Mesh.all_reduce

    def counted(self, t, axis=None):
        calls.append(tuple(t.shape))
        return real(self, t, axis)

    mesh_lib.Mesh.all_reduce = counted

    def restore():
        mesh_lib.Mesh.all_reduce = real

    return calls, restore


def allreduces_a_factorization(torch, be) -> int:
    """``Mesh.all_reduce`` calls of one factorization on ``be``'s mesh (d = 1)."""
    calls, restore = counting_all_reduces()
    try:
        be._ops().factorize(torch.ones(be.layout.n, dtype=torch.float64, device="cuda"))
        torch.cuda.synchronize()
    finally:
        restore()
    return len(calls)


def block_nccl_legs(torch, ne, card, p10, p20, ref10, ref20) -> dict:
    """pds-10 and pds-20 through the ``sharded_cases`` world task on an
    NCCL world of one in this process (the problems handed over as
    objects), then the same code on a local mesh of one (x bit for bit)
    and against the mesh=None solves. Returns the world's K1 launches by
    class (``{"lanes", "link"}``)."""
    import hashlib

    import numpy as np

    from distributedlpsolver_tpu_torch.backends.block_angular import BlockAngularBackend
    from distributedlpsolver_tpu_torch.distributed import world as world_lib
    from distributedlpsolver_tpu_torch.distributed.launcher import free_port
    from distributedlpsolver_tpu_torch.distributed.worker import TASKS
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.ops import dist_chol
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    sha = lambda a: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()  # noqa: E731
    cases = [pds_spec(*PDS10, problem=p10), pds_spec(*PDS20, problem=p20)]
    t0 = time.perf_counter()
    world = world_lib.init_world(world_lib.WorldConfig(
        coordinator=f"127.0.0.1:{free_port()}", rank=0, world_size=1, device="cuda"))
    try:
        if world.pg_backend != "nccl":
            fail(f"block: the world of one runs {world.pg_backend}, not nccl")
        res = TASKS["sharded_cases"](world, {"cases": cases})["cases"]
    finally:
        world.close()
    wall = time.perf_counter() - t0
    out = {}
    for o, (tag, p, ref) in zip(res, (("pds-10", p10, ref10), ("pds-20", p20, ref20))):
        name = f"block {tag} nccl world of one"
        rel = mesh_none_check(name, o, ref)
        row0 = o["phase_report"][0]
        counts = block_k1(o)
        if not row0["captured"] or not counts["lanes"] == counts["link"] == 1 + row0["bodies"]:
            fail(f"{name}: captured {row0['captured']}, K1 {counts}, bodies {row0['bodies']}")
        be = BlockAngularBackend(mesh=mesh_lib.make_mesh(axis_names=("blocks",),
                                                         devices=["cuda:0"]))
        block_counts_reset(ne)
        t0 = time.perf_counter()
        r = solve(p, backend=be, tol=1e-8)
        wall_l = time.perf_counter() - t0
        local = block_counts(ne)
        if (sha(r.x) != o["x_sha256"] or r.iterations != o["iterations"]
                or {k: local[k] for k in counts} != counts):
            fail(f"{name}: the local mesh of one {r.iterations} it x {sha(r.x)[:12]} K1 {local} "
                 f"against the world's {o['iterations']} it x {o['x_sha256'][:12]} K1 {counts}")
        # x is the world's bit for bit: hold it (and y) to the problem.
        answer = sharded_answer_check(name, p, r.x, r.y, o["rel_gap"])
        P = dist_chol.slab_plan(be.layout.link, 1, be.link_panel)[3]
        reduces = allreduces_a_factorization(torch, be)
        if reduces != 1 + 2 * P:
            fail(f"{name}: {reduces} all-reduces a factorization, not 1 + 2·{P}")
        out[tag] = counts
        print(f"block_mesh_nccl1 {since()} " + json.dumps({
            "problem": p.name, "world": "nccl world of one (in this process)",
            "status": o["status"], "iterations": o["iterations"], "objective": o["objective"],
            "mesh_none_iterations": ref[0]["iterations"], "objective_rel_mesh_none": rel,
            "x_bits_equal_local_mesh_of_one": True,
            "ms_per_iteration": 1e3 * o["solve_s"] / max(o["iterations"], 1),
            "mesh_none_ms_per_iteration": [row["ms_per_iteration"] for row in ref],
            "local_mesh_ms_per_iteration": 1e3 * r.solve_time / max(r.iterations, 1),
            "local_mesh_wall_s": wall_l, "solve_s": o["solve_s"], "wall_s": o["wall_s"],
            "setup": o["setup"], "k1_launches": counts, "bodies": row0["bodies"],
            "captured": row0["captured"], "allreduces_a_factorization": reduces,
            "link_panels": P, "layout": o["layout"], "answer": answer,
            "world_wall_s": wall}) + f" [{card}]")
        del r, be
        torch.cuda.empty_cache()
    return out


def block_k1(o) -> dict:
    """A world result's K1 launches: the K lanes and the linking columns."""
    return {"lanes": o["k1_launches_batched"], "link": o["k1_launches"] - o["k1_launches_batched"]}


def block_gloo2_check(block, outs, wall, card) -> dict:
    """pds-10 over a gloo world of 2 sharing the card (``outs``: each
    rank's case result; ``block``: the block phase's pds-10 and its
    mesh=None rows): both ranks the same x bits, OPTIMAL within 1e-8 of
    mesh=None's objective, each answer held to the problem, 16 blocks a
    rank, the loop uncaptured. Returns rank 0's K1 launches."""
    p10, ref10 = block["p10"], block["ref10"]
    if len({o["x_sha256"] for o in outs}) != 1:
        fail(f"block gloo world of 2: ranks' x differ: {[o['x_sha256'][:12] for o in outs]}")
    for k, o in enumerate(outs):
        rel = mesh_none_check(f"block gloo world of 2, rank {k}", o, ref10, iterations=False)
        o["answer"] = sharded_answer_check(f"block gloo world of 2, rank {k}", p10, o.pop("x"),
                                           o.pop("y"), o["rel_gap"])
        if o["phase_report"][0]["captured"] or o["shard_shape"][0] != 16:
            fail(f"block gloo world of 2, rank {k}: captured {o['phase_report'][0]['captured']}, "
                 f"shard {o['shard_shape']}")
    o = outs[0]
    print(f"block_mesh_gloo2 {since()} " + json.dumps({
        "problem": p10.name, "world": "gloo world of 2", "status": o["status"],
        "iterations": o["iterations"], "mesh_none_iterations": ref10[0]["iterations"],
        "objective_rel_mesh_none": rel, "x_bits_equal_across_ranks": True,
        "ms_per_iteration_rank0": 1e3 * o["solve_s"] / max(o["iterations"], 1),
        "solve_s_rank0": o["solve_s"], "wall_s_rank0": o["wall_s"],
        "shard_shape_rank0": o["shard_shape"],
        "link_columns_by_rank": [x["link_columns"] for x in outs],
        "k1_launches_by_rank": [block_k1(x) for x in outs], "answers": [x["answer"] for x in outs],
        "capture_off_reason": o["phase_report"][0]["capture_off_reason"],
        "setup_rank0": o["setup"], "world_wall_s": wall}) + f" [{card}; gloo through the host, "
          "not NCCL]")
    return block_k1(o)


def block_shrink_check(block, res4, wall, card) -> dict:
    """The shrink on ``block``: ``res4`` maps each rank of the gloo world of
    4 to its case result; rank 3 left at ``shrink:4->3``, the survivors
    OPTIMAL on ``block`` within 1e-8 of mesh=None's objective with equal x
    bits, each answer held to the problem. Returns rank 0's K1 launches
    (before and after the shrink)."""
    p10, ref10 = block["p10"], block["ref10"]
    if not res4[3]["left"] or res4[3]["faults"][0]["action"] != "shrink:4->3":
        fail(f"block shrink: rank 3 {res4[3]}")
    shas, answers, overhead = set(), [], []
    for k in (0, 1, 2):
        o = res4[k]
        f = o["faults"]
        if (o["left"] or o["backend"] != "block" or [x["action"] for x in f] != ["shrink:4->3"]
                or f[0]["devices"] != [3] or not f[0]["recovery_overhead_s"] > 0):
            fail(f"block shrink: rank {k} on {o['backend']}, faults {f}")
        rel = mesh_none_check(f"block shrink, rank {k}", o, ref10, iterations=False)
        shas.add(o["x_sha256"])
        answers.append(sharded_answer_check(f"block shrink, rank {k}", p10, o.pop("x"), o.pop("y"),
                                            o["rel_gap"]))
        overhead.append(f[0]["recovery_overhead_s"])
    if len(shas) != 1:
        fail(f"block shrink: the survivors' x differ: {shas}")
    o = res4[0]
    print(f"block_mesh_shrink {since()} " + json.dumps({
        "problem": p10.name, "world": "gloo world of 4", "action": "shrink:4->3",
        "blocks": "32 over 4, then 33 (one dead) over 3", "status": o["status"],
        "backend": o["backend"], "iterations": o["iterations"],
        "mesh_none_iterations": ref10[0]["iterations"], "objective_rel_mesh_none": rel,
        "x_bits_equal_across_survivors": True, "recovery_overhead_s": overhead,
        "k1_launches_rank0": block_k1(o), "answers": answers, "wall_s_rank0": o["wall_s"],
        "world_wall_s": wall}) + f" [{card}; gloo through the host, not NCCL]")
    return block_k1(o)


def block_rank_rows(torch, ne, card, block, key, counts) -> list:
    """The kernels-line rows of K1 at rank 0's share of pds-10 on the world
    ``key`` of ``BLOCK_RANK_SHAPES`` (its lanes, and its linking columns
    with the border's), held against the plain version and timed."""
    Kr, ranks = BLOCK_RANK_SHAPES[key]
    lay = block["lay10"]._replace(K=Kr)
    tag = f"pds-10 rank 0 of {ranks}" + (" after shrink:4->3" if key == "shrunk" else "")
    return [block_k1_row(torch, ne, card, tag, part, shape, counts[part], BLOCK_RANK_PATHS[key])
            for part, shape in (("lanes", (lay.mb, lay.nb, lay.K)),
                                ("link", (lay.link, lay.K * lay.nb + lay.n0, None)))]


def split_sum_row(torch, ne, card, tag, m, n, launches, path) -> dict:
    """The split's sum kernel at an f64 linking shape: on partial tiles of
    the launch's own split count (random values), against its plain
    version bit for bit, timed beside its bound (the workspace read once,
    M written once); a kernels-line row. No one PyTorch call adds tiles
    in place and mirrors them: library_ms is null."""
    splits = ne.split_count(m, n, 1, ne.sm_count("cuda"))
    g = torch.Generator(device="cuda").manual_seed(5)
    work = torch.randn(ne.workspace_numel(m, 1, splits), dtype=torch.float64, device="cuda",
                       generator=g)
    M = ne.split_sum(work, m, 1, splits)
    R = ne.split_sum_reference(work, m, 1, splits)
    mx = (M - R).abs().max().item()
    if not torch.equal(M, R) or not torch.equal(M, M.mT):
        fail(f"split sum {tag} {m}x{n} ({splits} splits): max_abs_err {mx:.3e} against its plain "
             f"version, symmetric {torch.equal(M, M.mT)}")
    del M, R
    ms = cuda_ms(torch, lambda: ne.split_sum(work, m, 1, splits), 20, 3)
    plain = cuda_ms(torch, lambda: ne.split_sum_reference(work, m, 1, splits), 5, 1)
    bound = 1e3 * (work.numel() * 8 + m * m * 8) / PEAK_BYTES
    del work
    torch.cuda.empty_cache()
    print(f"split_sum {tag} {m}x{n}: {splits} splits, bit for bit its plain version, kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms (bytes), share {bound / ms:.3f} "
          f"[{card}]")
    return {
        "name": f"normal_eq split sum ({tag} link)", "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        "launches": launches, "launches_path": path, "splits": splits,
        "max_abs_err": mx, "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
        "bound_share": bound / ms, "library_ms": None, "dtypes": ["float64"], "shape": [m, n],
        "ptxas": ptxas_lines(ne, "normal_eq_split_sum"),
    }


def block_k1_row(torch, ne, card, tag, part, shape, launches, path) -> dict:
    """K1 at one of the tier's shapes against its plain version (≤ 1e-12,
    M = Mᵀ and two launches bit for bit), timed beside ``torch.einsum``
    and its bound: a kernels-line row."""
    m, n, batch = shape
    rel_err, mx = kernel_parity(torch, ne, m, n, "float64", batch=batch)
    t = kernel_timing(torch, ne, m, n, "float64", iters=20, warm=3, batch=batch)
    print(f"block_k1 {tag} {part} {shape_name(m, n, batch)}: rel_err {rel_err:.3e} max_abs_err "
          f"{mx:.3e} (tol {TOL['float64']:.0e}), M = Mᵀ bitwise, two launches bitwise equal; "
          f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, einsum {t['library_ms']:.4f} "
          f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), share {t['bound_share']:.3f}, "
          f"splits {t['splits']} [{card}]")
    return {
        "name": f"normal_eq (block {part}, {tag})", "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        "launches": launches, "launches_path": path,
        "max_abs_err": mx, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_share": t["bound_share"],
        "library_ms": t["library_ms"], "dtypes": ["float64"], "shape": t["shape"],
        "splits": t["splits"],
    }


def block_phase(torch, ne, card, shared, defer=False):
    """The block-angular tier on the card (module note, step 18). Returns
    the kernels-line rows of K1 at the tier's shapes. With ``defer`` (a
    whole run) the gloo legs of the tier on a mesh are left to the
    sharded and slice phases' worlds: ``shared["block"]`` hands them
    pds-10, its mesh=None rows and its layout."""
    import numpy as np

    from distributedlpsolver_tpu_torch import cli
    from distributedlpsolver_tpu_torch.backends import block_angular as ba
    from distributedlpsolver_tpu_torch.models import block_angular_lp
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form

    _T0[0] = time.perf_counter()
    # 1. pds-10 through auto, its setup by part.
    t0 = time.perf_counter()
    p10 = block_angular_lp(*PDS10, **PDS_KW)
    parts = {"generate_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    inf10 = to_interior_form(p10)
    parts["interior_form_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays, lay10 = ba.build_arrays(inf10)
    parts["build_arrays_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ba.place_tensors(arrays, lay10, torch.float64, "cuda")
    torch.cuda.synchronize()
    parts["transfer_s"] = time.perf_counter() - t0
    del arrays
    torch.cuda.empty_cache()
    print(f"block_setup {since()} {p10.name} {p10.m}x{p10.n} nnz {p10.A.nnz}, layout "
          f"{dict(lay10._asdict())}: " + json.dumps(parts))
    runs = []
    for tag in ("cold", "warm"):
        r, row, be = block_solve(torch, ne, f"pds-10 auto ({tag})", p10, BLOCK_JAX["pds10"],
                                 PDS10_CPU_SPARSE, "auto")
        if be.name != "auto(block)":
            fail(f"pds-10 routes to {be.name}")
        print(f"block_pds10_{tag} {since()} " + json.dumps(row))
        runs.append((r, row))
    if not np.array_equal(runs[0][0].x, runs[1][0].x):
        fail("pds-10: x differs between two solves")
    print("block_pds10 x bit for bit across two solves")
    # Where a warm solve's device time goes.
    r, prof = device_profile(torch, lambda: block_solve(
        torch, ne, "pds-10 auto (profiled)", p10, BLOCK_JAX["pds10"], PDS10_CPU_SPARSE, "auto")[0])
    print("block_pds10_profile " + json.dumps({
        "iterations": r.iterations, "solve_s_profiled": r.solve_time,
        "device_idle_share": 1.0 - prof["device_busy_ms"] / (1e3 * (r.setup_time + r.solve_time)),
        **prof}))
    p10_counts = runs[0][1]["k1_launches"]
    ref10 = [row for _, row in runs]  # mesh=None, cold and warm
    del runs, r, inf10
    torch.cuda.empty_cache()

    # 2. The same class as an MPS file through cli generate and cli solve
    # (no hint in the file: presolve, then auto's detection pass).
    path = os.path.join(ROOT, "build", "dlps_torch", "pds10.mps")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    K, mb, nb, link = PDS10
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["generate", "block", path, "--blocks", str(K), "--m", str(mb), "--n", str(nb),
                       "--link", str(link), "--seed", "0", "--density", str(PDS_KW["density"])])
    if rc != 0:
        fail(f"cli generate block: rc {rc}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["solve", path, "--json", "--quiet"])
    wall = time.perf_counter() - t0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    rel = abs(out["objective"] - PDS10_CPU_SPARSE) / abs(PDS10_CPU_SPARSE)
    ref = BLOCK_JAX["pds10_file"]
    rel_jax = abs(out["objective"] - ref["objective"]) / (1.0 + abs(ref["objective"]))
    if (rc != 0 or out["status"] != ref["status"] or out["backend"] != "auto(block)"
            or out["iterations"] != ref["iterations"] or not rel <= BLOCK_OBJ_TOL
            or not rel_jax <= BLOCK_OBJ_TOL):
        fail(f"cli solve pds10.mps: rc {rc}, {out}, {rel:.3e} from {PDS10_CPU_SPARSE!r}; the JAX "
             f"package's CLI: {ref}")
    print(f"block_cli {since()} " + json.dumps({
        "file": os.path.basename(path), "backend": out["backend"], "status": out["status"],
        "iterations": out["iterations"], "objective": out["objective"], "objective_rel_recorded": rel,
        "objective_rel_jax": rel_jax, "wall_s": wall}))

    # 3. pds-20 class by name, twice.
    t0 = time.perf_counter()
    p20 = block_angular_lp(*PDS20, **PDS_KW)
    gen20 = time.perf_counter() - t0
    runs = []
    for tag in ("cold", "warm"):
        r, row, be = block_solve(torch, ne, f"pds-20 block ({tag})", p20, BLOCK_JAX["pds20"],
                                 PDS20_TPU, "block")
        row["generate_s"] = gen20
        print(f"block_pds20_{tag} {since()} " + json.dumps(row))
        runs.append((r, row))
    if not np.array_equal(runs[0][0].x, runs[1][0].x):
        fail("pds-20: x differs between two solves")
    print("block_pds20 x bit for bit across two solves")
    p20_counts = runs[0][1]["k1_launches"]
    ref20 = [row for _, row in runs]
    lay20 = be.layout
    del runs, r, be
    torch.cuda.empty_cache()

    # 4. The tier on a mesh: an NCCL world of one and a local mesh of one.
    nccl1 = block_nccl_legs(torch, ne, card, p10, p20, ref10, ref20)

    # 5. K1 at the tier's four shapes: parity and timing.
    rows = []
    for tag, lay, counts in (("pds-10", lay10, p10_counts), ("pds-20", lay20, p20_counts)):
        for part, shape in (("lanes", (lay.mb, lay.nb, lay.K)),
                            ("link", (lay.link, lay.K * lay.nb + lay.n0, None))):
            path = f"{tag} {'auto' if tag == 'pds-10' else 'block'} cold solve"
            row = block_k1_row(torch, ne, card, tag, part, shape, counts[part], path)
            row["launches_nccl_world_of_one"] = nccl1[tag][part]
            rows.append(row)
        # The split's sum kernel, launched with every split linking launch.
        if counts["split"] == 0:
            fail(f"{tag}: no split launch of the linking rows in its solve ({counts})")
        rows.append(split_sum_row(torch, ne, card, tag, lay.link, lay.K * lay.nb + lay.n0,
                                  counts["split"], path))

    # 6. pds-10 over gloo worlds of 2 and 4 sharing the card: here with
    # --block-only, and in a whole run as a case of the sharded phase's
    # second world of 2 and of the slice phase's world of 4.
    block = dict(p10=p10, ref10=ref10, lay10=lay10)
    if defer:
        shared["block"] = block
    else:
        res2, wall2 = card_world("sharded_cases", {"cases": [block_gloo2_case()]}, 2, "gloo",
                                 "block_gloo2", BLOCK_WORLD_TIMEOUT_S)
        counts = block_gloo2_check(block, [res2[k]["cases"][0] for k in (0, 1)], wall2, card)
        rows += block_rank_rows(torch, ne, card, block, "gloo2", counts)
        res4, wall4 = card_world("supervised_solve", block_shrink_case(), 4, "gloo",
                                 "block_shrink_gloo4", BLOCK_WORLD_TIMEOUT_S)
        counts = block_shrink_check(block, res4, wall4, card)
        rows += block_rank_rows(torch, ne, card, block, "gloo4", counts)
        rows += block_rank_rows(torch, ne, card, block, "shrunk", counts)
    print(f"block phase {since()}")
    return rows


# The stochastic scenario tier (step 19): the tier's own family at a full
# bucket of 1,024 scenarios (the block shape of bench.py --scenario at
# stormG2_1000's scenario count padded to its bucket; 24,578 × 36,888).
SCENARIO_MAIN = dict(num_scenarios=1024, block_m=24, block_n=36, first_stage_n=24,
                     first_stage_m=2, seed=1)
# stormG2's own blocks (STORM_FULL's shapes) at K = 8, with a two_stage hint:
# 4,224 × 10,193, no first-stage rows. (At K = 16 the reference's CG grinds
# at its cap from iteration 29 on: ROADMAP Queue 3.)
SCENARIO_STORM = dict(block_m=528, block_n=1259, first_stage_n=121, seed=1, t_nnz_per_row=2,
                      w_nnz_per_row=4)
# K1 alone at the scenario lanes of stormG2's block width, a full bucket.
SCENARIO_K1 = (1024, 528, 1259)
# The JAX package's scenario backend on the CPU (tol 1e-8):
# ``JAX_PLATFORMS=cpu python scripts/port_scenario_jax_verdicts.py``.
SCENARIO_JAX = {
    "main": {"status": "optimal", "iterations": 22, "objective": 37182.08404374491, "cg_iters": 652,
             "cg_per_iteration": [2, 8, 8, 8, 8, 8, 8, 8, 8, 12, 12, 14, 14, 14, 20, 20, 28, 42, 58,
                                  76, 86, 96, 94]},
    "storm8": {"status": "optimal", "iterations": 28, "objective": 6735.873380717234,
               "cg_iters": 1762,
               "cg_per_iteration": [2, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 10, 14, 14, 16,
                                    20, 26, 38, 62, 116, 231, 483, 602]},
    # cli generate scenario --scenarios 64 --m 24 --n 36, then cli solve (auto).
    "cli_file": {"status": "optimal", "iterations": 18, "objective": 1922.6162423151154},
}
SCENARIO_OBJ_TOL = 1e-8
# The K-mixed serve stream takes every sixteenth K of 33..64 (2 requests):
# its solo solves run one at a time at ~2 s each, and the script has a limit.
SCENARIO_KMIXED_STEP = 16


def scenario_storm(K):
    """stormG2's blocks at K scenarios with a two_stage hint (no
    first-stage rows): such a hint routes to ``scenario`` on every
    platform."""
    from distributedlpsolver_tpu_torch.models import storm_sparse_lp

    p = storm_sparse_lp(K, **SCENARIO_STORM)
    p.block_structure = dict(p.block_structure, kind="two_stage", first_stage_m=0)
    return p


def scenario_solve(torch, ne, name, p, jax_ref, backend, **kw):
    """One solve with K1's and the ELL kernel's launches reset just before
    and read just after;
    held to OPTIMAL, ``max_violation ≤ 1e-6`` and, with ``jax_ref``, the JAX
    package's status, iterations and objective (≤ 1e-8). K1 must run once a
    factorization (setup's unit-diagonal one included), every launch
    batched over all padded lanes, and CG's operator must have launched
    the ELL kernel in both directions. Returns the result and its row."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.backends import scenario as sc
    from distributedlpsolver_tpu_torch.ipm import solve

    be = get_backend(backend) if isinstance(backend, str) else backend
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_counts_reset(ne)
    ell_counts_reset()
    t0 = time.perf_counter()
    r = solve(p, backend=be, tol=1e-8, **kw)
    wall = time.perf_counter() - t0
    launches, batched = ne.normal_eq.launches, ne.normal_eq.launches_batched
    ell = ell_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    inner = getattr(be, "inner", be)
    rep = sc.last_solve_report()
    cg = inner.cg_report()
    viol = p.max_violation(np.asarray(r.x))
    row = {
        "problem": p.name, "backend": be.name, "status": r.status.value,
        "iterations": r.iterations, "objective": r.objective, "max_violation": viol,
        "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf,
        "layout": dict(inner.layout._asdict()), "wall_s": wall, "setup_s": r.setup_time,
        "solve_s": r.solve_time, "ms_per_iteration": 1e3 * r.solve_time / max(r.iterations, 1),
        **{f"setup_{k}": v for k, v in inner.setup_report.items()},
        "schur_ms": rep["schur_ms"], "link_ms": rep["link_ms"], "solve_ms": rep["solve_ms"],
        "factorizations": rep["factorizations"], "applications": rep["solves"],
        "ms_per_factorization": (rep["schur_ms"] + rep["link_ms"]) / max(rep["factorizations"], 1),
        "ms_per_cg_solve": rep["solve_ms"] / max(cg["newton_solves"], 1),
        "cg_iters": cg["cg_iters"], "cg_masked": rep["cg_masked"],
        "newton_solves": cg["newton_solves"], "host_syncs": cg["host_syncs"],
        "host_syncs_per_newton_solve": cg["host_syncs"] / max(cg["newton_solves"], 1),
        "cg_per_iteration": cg["cg_per_iteration"],
        "k1_launches": launches, "k1_launches_batched": batched, "ell_launches": ell,
        "peak_device_gb": peak,
    }
    if jax_ref is not None:
        rel = abs(r.objective - jax_ref["objective"]) / (1.0 + abs(jax_ref["objective"]))
        row["objective_rel_jax"] = rel
        row["jax_cg_per_iteration"] = jax_ref["cg_per_iteration"]
        if (r.status.value != jax_ref["status"] or r.iterations != jax_ref["iterations"]
                or not rel <= SCENARIO_OBJ_TOL):
            fail(f"{name}: {r.status.value} {r.iterations} it objective {r.objective!r} against the "
                 f"JAX package's {jax_ref['status']} {jax_ref['iterations']} it "
                 f"{jax_ref['objective']!r} ({rel:.3e})")
        if r.status.value != "optimal" or not viol <= 1e-6:
            fail(f"{name}: {r.status.value}, max_violation {viol:.3e}")
    # One K1 launch over every lane a factorization: setup's, then each step's.
    if not launches == batched == 1 + rep["factorizations"]:
        fail(f"{name}: K1 launches {launches} ({batched} batched) for 1 + {rep['factorizations']} "
             "factorizations")
    # CG's operator: both products of the ELL kernel, every CG iteration.
    if ell["A·v"] <= 0 or ell["Aᵀ·v"] <= 0:
        fail(f"{name}: ELL kernel launches {ell}")
    return r, row


def scenario_gloo2_case() -> dict:
    """The scenario main path as a case of a gloo world of 2: the lanes
    over the ranks (512 a rank), every rank generating the problem."""
    return {"backend": "scenario", "instance": "two_stage",
            "scenarios": SCENARIO_MAIN["num_scenarios"],
            **{k: v for k, v in SCENARIO_MAIN.items() if k != "num_scenarios"},
            "tol": 1e-8, "return_xy": True}


def scenario_sums(name, calls, lay, rep) -> dict:
    """Holds a scenario mesh solve's ``Mesh.all_reduce`` calls to one a
    factorization (C, n0×n0; setup's unit-diagonal one included) and two an
    application (t, n0; the dy rows, m), every application counted, the
    masked CG iterations' included."""
    n_c = calls.count((lay.n0, lay.n0))
    n_t, n_dy = calls.count((lay.n0,)), calls.count((lay.m,))
    apps = rep["solves"] + rep["cg_masked"]
    if (n_c != 1 + rep["factorizations"] or n_t != apps or n_dy != apps
            or n_c + n_t + n_dy != len(calls)):
        fail(f"{name}: all-reduces C {n_c}, t {n_t}, dy {n_dy} of {len(calls)} for "
             f"1 + {rep['factorizations']} factorizations and {apps} applications")
    return {"factorizations": 1 + rep["factorizations"], "applications": apps,
            "all_reduces_C": n_c, "all_reduces_t": n_t, "all_reduces_dy": n_dy}


def scenario_mesh_legs(torch, ne, card, p, lay, x0, ref) -> int:
    """The lane mesh at a mesh of one (step 19): the ``scenario_lanes``
    task on an NCCL world of one in this process (the problem handed over
    as an object), then a local mesh of one on ``cuda:0``; each x bit for
    bit with the phase's ``mesh=None`` solve (``x0``, its row ``ref``), the
    same IPM iterations, CG count and K1 launches, and one sum a
    factorization and two an application. Returns the world's K1
    launches."""
    import hashlib

    import numpy as np

    from distributedlpsolver_tpu_torch.backends import scenario as sc
    from distributedlpsolver_tpu_torch.distributed import world as world_lib
    from distributedlpsolver_tpu_torch.distributed.launcher import free_port
    from distributedlpsolver_tpu_torch.distributed.worker import TASKS
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    sha0 = hashlib.sha256(np.asarray(x0).tobytes()).hexdigest()
    t0 = time.perf_counter()
    world = world_lib.init_world(world_lib.WorldConfig(
        coordinator=f"127.0.0.1:{free_port()}", rank=0, world_size=1, device="cuda"))
    calls, restore = counting_all_reduces()
    try:
        if world.pg_backend != "nccl":
            fail(f"scenario: the world of one runs {world.pg_backend}, not nccl")
        o = {**TASKS["scenario_lanes"](world, {"problem": p, "tol": 1e-8}), **world.describe()}
        rep = sc.last_solve_report()
    finally:
        restore()
        world.close()
    wall = time.perf_counter() - t0
    name = "scenario main nccl world of one"
    sums = scenario_sums(name, calls, lay, rep)
    if (o["status"] != "optimal" or o["x_sha256"] != sha0 or o["iterations"] != ref["iterations"]
            or o["cg_iters"] != ref["cg_iters"] or o["k1_launches"] != ref["k1_launches"]
            or o["lanes"] != [[0, lay.k_pad]]):
        fail(f"{name}: {o['status']} {o['iterations']} it cg {o['cg_iters']} K1 {o['k1_launches']} "
             f"lanes {o['lanes']} x {o['x_sha256'][:12]} against mesh=None's {ref['iterations']} "
             f"it cg {ref['cg_iters']} K1 {ref['k1_launches']} x {sha0[:12]}")
    print(f"scenario_mesh_nccl1 {since()} " + json.dumps({
        "problem": p.name, "world": "nccl world of one (in this process)",
        "status": o["status"], "iterations": o["iterations"], "objective": o["objective"],
        "x_bits_equal_mesh_none": True, "cg_iters": o["cg_iters"],
        "mesh_none_cg_iters": ref["cg_iters"], "k1_launches": o["k1_launches"],
        "lanes": o["lanes"], "member_bytes": o["member_bytes"],
        "ms_per_iteration": 1e3 * o["solve_s"] / max(o["iterations"], 1),
        "mesh_none_ms_per_iteration": ref["ms_per_iteration"], "solve_s": o["solve_s"],
        "wall_s": o["wall_s"], "setup": o["setup"], **sums, "world_wall_s": wall}) + f" [{card}]")
    be = sc.ScenarioBackend(mesh=mesh_lib.make_mesh(axis_names=("batch",), devices=["cuda:0"]))
    block_counts_reset(ne)
    calls, restore = counting_all_reduces()
    try:
        r = solve(p, backend=be, tol=1e-8)
        rep = sc.last_solve_report()
    finally:
        restore()
    name = "scenario main local mesh of one"
    sums = scenario_sums(name, calls, lay, rep)
    launches = ne.normal_eq.launches
    if (not np.array_equal(r.x, x0) or r.iterations != ref["iterations"]
            or be.cg_report()["cg_iters"] != ref["cg_iters"] or launches != ref["k1_launches"]):
        fail(f"{name}: {r.iterations} it cg {be.cg_report()['cg_iters']} K1 {launches}, x equal "
             f"{np.array_equal(r.x, x0)}")
    print(f"scenario_mesh_local1 {since()} " + json.dumps({
        "x_bits_equal_mesh_none": True, "iterations": r.iterations,
        "cg_iters": be.cg_report()["cg_iters"], "k1_launches": launches,
        "member_bytes": be.member_nbytes(),
        "ms_per_iteration": 1e3 * r.solve_time / max(r.iterations, 1), **sums}) + f" [{card}]")
    return o["k1_launches"]


def scenario_gloo2_rows(torch, ne, card, scen, outs, wall) -> list:
    """The scenario main path over a gloo world of 2 sharing the card
    (``outs``: each rank's case result; ``scen``: the phase's problem,
    layout and mesh=None row): both ranks the same x bits, OPTIMAL, the
    iterations within ±2 and the objective within 1e-8 of mesh=None's,
    each answer held to the problem, 512 lanes a rank. Returns the
    kernels-line row of K1 at rank 0's lanes (512 × 24 × 36)."""
    p, ref, lay = scen["p"], scen["ref"], scen["lay"]
    half = lay.k_pad // 2
    name = "scenario gloo world of 2"
    if len({o["x_sha256"] for o in outs}) != 1:
        fail(f"{name}: the ranks' x differ: {[o['x_sha256'][:12] for o in outs]}")
    for k, o in enumerate(outs):
        rel = abs(o["objective"] - ref["objective"]) / (1.0 + abs(ref["objective"]))
        if (o["status"] != "optimal" or abs(o["iterations"] - ref["iterations"]) > 2
                or not rel <= SCENARIO_OBJ_TOL or o["pg_backend"] != "gloo"):
            fail(f"{name}, rank {k}: {o['status']} {o['iterations']} it objective "
                 f"{o['objective']!r} on {o['pg_backend']} against mesh=None's "
                 f"{ref['iterations']} it {ref['objective']!r} ({rel:.3e})")
        if o["lanes"] != [[k * half, (k + 1) * half]] or o["k1_launches"] <= 0:
            fail(f"{name}, rank {k}: lanes {o['lanes']}, K1 launches {o['k1_launches']}")
        o["answer"] = sharded_answer_check(f"{name}, rank {k}", p, o.pop("x"), o.pop("y"),
                                           o["rel_gap"])
    o = outs[0]
    print(f"scenario_mesh_gloo2 {since()} " + json.dumps({
        "problem": p.name, "world": name, "status": o["status"], "iterations": o["iterations"],
        "mesh_none_iterations": ref["iterations"], "objective": o["objective"],
        "objective_rel_mesh_none": abs(o["objective"] - ref["objective"]) / (
            1.0 + abs(ref["objective"])),
        "x_bits_equal_across_ranks": True, "cg_iters_by_rank": [x["cg_iters"] for x in outs],
        "mesh_none_cg_iters": ref["cg_iters"],
        "ms_per_iteration_rank0": 1e3 * o["solve_s"] / max(o["iterations"], 1),
        "mesh_none_ms_per_iteration": ref["ms_per_iteration"],
        "lanes_by_rank": [x["lanes"] for x in outs],
        "member_bytes_by_rank": [x["member_bytes"] for x in outs],
        "k1_launches_by_rank": [x["k1_launches"] for x in outs],
        "answers": [x["answer"] for x in outs], "solve_s_rank0": o["solve_s"],
        "wall_s_rank0": o["wall_s"], "setup_rank0": o["setup"], "world_wall_s": wall})
        + f" [{card}; gloo through the host, not NCCL]")
    rel_err, mx = kernel_parity(torch, ne, lay.mb, lay.nb, "float64", batch=half)
    t = kernel_timing(torch, ne, lay.mb, lay.nb, "float64", iters=20, warm=3, batch=half)
    print(f"scenario_k1 rank 0 of 2 {shape_name(lay.mb, lay.nb, half)}: rel_err {rel_err:.3e} "
          f"max_abs_err {mx:.3e} (tol {TOL['float64']:.0e}), M = Mᵀ bitwise, two launches bitwise "
          f"equal, each lane the unbatched kernel's bits; kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, einsum {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}), share {t['bound_share']:.3f}; launches {o['k1_launches']} [{card}]")
    return [{
        "name": "normal_eq (scenario lanes, rank 0 of a gloo world of 2)", "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        "launches": o["k1_launches"],
        "launches_path": "scenario main path over a gloo world of 2 on one card, rank 0",
        "launches_by_rank": [x["k1_launches"] for x in outs],
        "max_abs_err": mx, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_share": t["bound_share"],
        "library_ms": t["library_ms"], "dtypes": ["float64"], "shape": t["shape"],
    }]


def scenario_phase(torch, ne, card, shared, defer=False):
    """The stochastic scenario tier on the card (module note, step 19).
    Returns the kernels-line rows of K1 over the scenario lanes and of the
    ELL kernel on CG's operator. With ``defer`` (a whole run) the lane
    mesh's gloo world of 2 is left to the sharded phase's world:
    ``shared["scenario"]`` hands it the problem, its layout and its
    mesh=None row."""
    import math

    import numpy as np

    from distributedlpsolver_tpu_torch import cli
    from distributedlpsolver_tpu_torch.backends import scenario as sc
    from distributedlpsolver_tpu_torch.models import scenario_delta_stream, two_stage_storm
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form
    from distributedlpsolver_tpu_torch.net.admission import AdmissionConfig, TenantQuota
    from distributedlpsolver_tpu_torch.net.server import NetConfig, SolveHTTPServer
    from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry
    from distributedlpsolver_tpu_torch.obs.report import report_from_paths
    from distributedlpsolver_tpu_torch.ops import sparse as sparse_ops
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService

    _T0[0] = time.perf_counter()
    # 1. The main path at a full bucket, its setup by part.
    t0 = time.perf_counter()
    slp = two_stage_storm(**SCENARIO_MAIN)
    parts = {"generate_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    p = slp.to_block_angular()
    parts["lower_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inf = to_interior_form(p)
    parts["interior_form_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, lay = sc.build_tensors(inf, torch.float64, "cuda")
    torch.cuda.synchronize()
    parts["stacks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    op_main = sparse_ops.from_scipy(inf.A, device="cuda")
    torch.cuda.synchronize()
    parts["operator_transfer_s"] = time.perf_counter() - t0
    del inf
    print(f"scenario_setup {since()} {p.name} {p.m}x{p.n} nnz {p.A.nnz}, layout "
          f"{dict(lay._asdict())}: " + json.dumps(parts))
    # CG's operator, the ELL kernel, against its plain version at this
    # path's shapes (A: 24,576 rows over 32 entries, each one heavy chunk;
    # Aᵀ: the 24 first-stage columns as rows of 24,576 entries).
    ell_rows = {"main": ell_phase(torch, op_main, "scenario main", card)}
    del op_main
    torch.cuda.empty_cache()
    runs = []
    for tag in ("cold", "warm"):
        r, row = scenario_solve(torch, ne, f"scenario main auto ({tag})", p, SCENARIO_JAX["main"],
                                "auto")
        if row["backend"] != "auto(scenario)" or row["layout"]["k_pad"] != 1024:
            fail(f"scenario main path routes to {row['backend']} with {row['layout']}")
        print(f"scenario_main_{tag} {since()} " + json.dumps(row))
        runs.append((r, row))
    if not np.array_equal(runs[0][0].x, runs[1][0].x):
        fail("scenario main path: x differs between two solves")
    r_sc, row_sc = scenario_solve(torch, ne, "scenario main ScenarioBackend", p, SCENARIO_JAX["main"],
                                  sc.ScenarioBackend())
    print(f"scenario_main_backend {since()} " + json.dumps(row_sc))
    # Where a step's device time goes: step 10 (12 CG iterations) under the
    # profiler, its neighbours' unprofiled walls for the idle share (a whole
    # solve's ~120k device ops take a minute to post-process).
    at = 10
    hooks = profile_one_step(torch, at=at)
    _, row_p = scenario_solve(torch, ne, "scenario main auto (step profiled)", p,
                              SCENARIO_JAX["main"], "auto", hooks=hooks)
    wall_ms = 1e3 * (hooks.step_s[at - 1] + hooks.step_s[at + 1]) / 2
    print(f"scenario_main_step_profile {since()} " + json.dumps({
        "step": at, "cg_iters": row_p["cg_per_iteration"][at],
        "neighbour_steps_wall_ms": wall_ms,
        "device_idle_share": 1.0 - hooks.prof["device_busy_ms"] / wall_ms, **hooks.prof}))
    t0 = time.perf_counter()
    r_entry = sc.solve_scenario(slp, tol=1e-8)
    wall = time.perf_counter() - t0
    if not (np.array_equal(r_sc.x, runs[0][0].x) and np.array_equal(r_entry.x, runs[0][0].x)):
        fail("scenario main path: solve_scenario's x differs from auto's")
    print(f"scenario_main_solve_scenario {since()} x bit for bit with auto's (twice); "
          + json.dumps({"wall_s": wall, "iterations": r_entry.iterations}))
    # The lane mesh at a mesh of one, against the cold auto solve; the
    # world's K1 launches go to the main path's row.
    mesh_launches = scenario_mesh_legs(torch, ne, card, p, lay, runs[0][0].x, runs[0][1])
    scen = dict(p=p, ref=runs[0][1], lay=lay)
    main_launches = runs[0][1]["k1_launches"]
    main_ell = runs[0][1]["ell_launches"]
    del runs, r_sc, r_entry
    torch.cuda.empty_cache()

    # 2. stormG2's block width at K = 8 through scenario.
    p8 = scenario_storm(8)
    r8, row8 = scenario_solve(torch, ne, "stormG2 blocks K=8", p8, SCENARIO_JAX["storm8"], "scenario")
    print(f"scenario_storm8 {since()} " + json.dumps(row8))
    storm_launches, storm_ell, lay8 = row8["k1_launches"], row8["ell_launches"], row8["layout"]
    op8 = sparse_ops.from_scipy(to_interior_form(p8).A, device="cuda")
    ell_rows["storm8"] = ell_phase(torch, op8, "stormG2 blocks K=8", card)
    del op8
    del r8
    torch.cuda.empty_cache()

    # 3. K1 alone at the lanes: the main path's, the K = 8 path's at
    # stormG2's block width, and a full bucket at that width, which no
    # path runs (an observation: launches 0).
    rows = []
    for tag, (batch, m, n), launches, path in (
            ("main path", (lay.k_pad, lay.mb, lay.nb), main_launches + mesh_launches,
             "main path auto cold solve, and the scenario_lanes task on an NCCL world of one"),
            ("stormG2 width, K=8 path", (lay8["k_pad"], lay8["mb"], lay8["nb"]), storm_launches,
             "stormG2 blocks K=8 scenario solve"),
            ("stormG2 width, full bucket", SCENARIO_K1, 0, None)):
        rel_err, mx = kernel_parity(torch, ne, m, n, "float64", batch=batch)
        t = kernel_timing(torch, ne, m, n, "float64", iters=10, warm=2, batch=batch)
        print(f"scenario_k1 {tag} {shape_name(m, n, batch)}: rel_err {rel_err:.3e} max_abs_err "
              f"{mx:.3e} (tol {TOL['float64']:.0e}), M = Mᵀ bitwise, two launches bitwise equal, "
              f"each lane the unbatched kernel's bits; kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, einsum {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
              f"ms ({t['bound_by']}), share {t['bound_share']:.3f}; launches {launches} [{card}]")
        rows.append({
            "name": f"normal_eq (scenario lanes, {tag})", "route": "cuda",
            "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
            "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
            "launches": launches, "launches_path": path,
            "max_abs_err": mx, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_share": t["bound_share"],
            "library_ms": t["library_ms"], "dtypes": ["float64"], "shape": t["shape"],
        })
    # The ELL kernel on CG's operator, each direction's launches from its
    # path's cold solve.
    for key, counts, path, shape in (
            ("main", main_ell, "main path auto cold solve", [p.m, p.n]),
            ("storm8", storm_ell, "stormG2 blocks K=8 scenario solve", [p8.m, p8.n])):
        for name, replaces in (("A·v", "distributedlpsolver_tpu/ops/sparse.py:123"),
                               ("Aᵀ·v", "distributedlpsolver_tpu/ops/sparse.py:133")):
            t = ell_rows[key][name]
            rows.append({
                "name": f"ell_spmv ({name}, scenario {key})", "route": "cuda",
                "source": "distributedlpsolver_tpu_torch/csrc/ell_spmv.cu", "replaces": replaces,
                "launches": counts[name], "launches_path": path,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_share": t["bound_share"],
                "library_ms": t["library_ms"], "library": "cuSPARSE CSR SpMV (torch.sparse)",
                "ms_cold": t["ms_cold"], "library_ms_cold": t["library_ms_cold"],
                "layout_bytes": t["layout_bytes"], "slices": t["slices"],
                "heavy_chunks": t["heavy_chunks"], "dtypes": ["float64"], "shape": shape,
            })

    # 4. The CLI: generate a file, solve it with the default backend.
    path = os.path.join(ROOT, "build", "dlps_torch", "scenario64.mps")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["generate", "scenario", path, "--scenarios", "64", "--m", "24", "--n", "36"])
    if rc != 0:
        fail(f"cli generate scenario: rc {rc}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["solve", path, "--json", "--quiet"])
    wall = time.perf_counter() - t0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    ref = SCENARIO_JAX["cli_file"]
    rel = abs(out["objective"] - ref["objective"]) / (1.0 + abs(ref["objective"]))
    if (rc != 0 or out["backend"] != "auto(scenario)" or out["status"] != ref["status"]
            or out["iterations"] != ref["iterations"] or not rel <= SCENARIO_OBJ_TOL):
        fail(f"cli solve scenario64.mps: rc {rc}, {out}; the JAX package's CLI: {ref}")
    print(f"scenario_cli {since()} " + json.dumps({
        "file": os.path.basename(path), "backend": out["backend"], "status": out["status"],
        "iterations": out["iterations"], "objective": out["objective"], "objective_rel_jax": rel,
        "wall_s": wall}))

    # 5. Serving on the card: a delta wave, a K-mixed stream inside one
    # bucket, admission units, stats/metrics/report, HTTP.
    log = os.path.join(ROOT, "build", "dlps_torch", "scenario_serve.jsonl")
    if os.path.exists(log):
        os.remove(log)
    reg = MetricsRegistry()
    burst = 1e6
    svc = SolveService(ServiceConfig(flush_s=0.005, log_jsonl=log, admission=AdmissionConfig(
        quotas={"wave": TenantQuota(rate=1e-9, burst=burst)})), metrics=reg)
    front = SolveHTTPServer(svc, NetConfig(), metrics=reg).start()
    try:
        # The reference's delta-wave acceptance stream (tests/test_scenario.py).
        t0 = time.perf_counter()
        futs = [svc.submit(s.to_block_angular(), tol=1e-8) for s in scenario_delta_stream(
            10, num_scenarios=8, block_m=6, block_n=10, first_stage_n=6, first_stage_m=2, seed=11)]
        wave = [f.result(timeout=600) for f in futs]
        wave_s = time.perf_counter() - t0
        warm = [r.iterations for r in wave if r.warm == "warm"]
        cold = [r.iterations for r in wave if r.warm != "warm"]
        if (not all(r.status.value == "optimal" and r.engine == "scenario"
                    and r.backend == "scenario" for r in wave)
                or not warm or not cold or not np.median(warm) < np.median(cold)):
            fail(f"scenario delta wave: {[(r.status.value, r.warm, r.iterations, r.backend) for r in wave]}")
        print(f"scenario_serve_delta_wave {since()} " + json.dumps({
            "requests": len(wave), "wall_s": wave_s, "cold_iterations": cold,
            "warm_iterations": warm, "schur_ms_p50": float(np.median([r.schur_ms for r in wave])),
            "link_ms_p50": float(np.median([r.link_ms for r in wave]))}))
        # K = 33, 49 (every sixteenth of 33..64, cut for the script's
        # time): one bucket (64); units ceil(K/16) each.
        r64 = svc.submit(two_stage_storm(64, 24, 36, 24, 2, seed=64).to_block_angular(),
                         tol=1e-8).result(timeout=600)
        # Constant by construction (the port compiles nothing per key):
        # printed, not a gate.
        meter = sc.scenario_program_cache_size()
        ks = list(range(33, 65, SCENARIO_KMIXED_STEP))
        t0 = time.perf_counter()
        futs = [svc.submit(two_stage_storm(K, 24, 36, 24, 2, seed=K).to_block_angular(), tol=1e-8,
                           tenant="wave") for K in ks]
        mixed = [f.result(timeout=600) for f in futs]
        mixed_s = time.perf_counter() - t0
        units = burst - svc.stats()["admission"]["wave"]["tokens"]
        want = sum(math.ceil(K / 16) for K in ks)
        if (r64.status.value != "optimal" or not all(r.status.value == "optimal" for r in mixed)
                or {r.scenario_bucket for r in mixed} != {64} or abs(units - want) > 0.01):
            fail(f"scenario K-mixed stream: {[(r.status.value, r.scenario_bucket) for r in mixed]}, "
                 f"units {units} (want {want})")
        lat = sorted(r.total_ms for r in mixed)
        print(f"scenario_serve_kmixed {since()} " + json.dumps({
            "requests": len(mixed), "wall_s": mixed_s, "rps": len(mixed) / mixed_s,
            "total_ms_p50": lat[len(lat) // 2], "total_ms_max": lat[-1],
            "iterations": [r.iterations for r in mixed],
            "programs_compiled": [meter, sc.scenario_program_cache_size()],
            "admission_units": units, "admission_units_expected": want}))
        # HTTP: a generated 64-scenario body.
        code, body, _ = _http_json(front.url + "/v1/solve",
                                   {"scenarios": {"n_scenarios": 64, "seed": 7}})
        if (code != 200 or body.get("status") != "optimal" or body.get("n_scenarios") != 64
                or body.get("scenario_bucket") != 64):
            fail(f"scenario HTTP: {code} {body}")
        print(f"scenario_http {since()} " + json.dumps(
            {k: body.get(k) for k in ("status", "iterations", "objective", "n_scenarios",
                                      "scenario_bucket", "schur_ms", "link_ms", "total_ms")}))
        stats = svc.stats()
    finally:
        front.shutdown()
        svc.shutdown()
    # stats()["scenario"], the metrics and cli report over the log reconcile.
    n = len(wave) + 1 + len(mixed) + 1
    snap = reg.snapshot()
    solves = sum(v for k, v in snap.items() if k.startswith("scenario_solves_total"))
    rep = report_from_paths([log])
    ok = (solves == n == stats["scenario"]["solves"] == rep["scenario"]["solves"]
          and snap["scenario_k"]["count"] == n
          and set(rep["scenario"]["by_bucket"]) == set(stats["scenario"]["by_bucket"]))
    for b, row in rep["scenario"]["by_bucket"].items():
        srow = stats["scenario"]["by_bucket"][b]
        ok = ok and row["count"] == srow["count"] and row["k_max"] == srow["k_max"]
        ok = ok and abs(row["total_ms"]["p50"] - srow["total_ms_p50"]) <= 2e-3
    if not ok:
        fail(f"scenario stats/metrics/report: {solves} metric solves, stats {stats['scenario']}, "
             f"report {rep['scenario']}")
    print(f"scenario_serve_reconcile {since()} " + json.dumps(
        {"solves": n, "stats": stats["scenario"], "metric_solves": solves}))

    # 6. The lane mesh over a gloo world of 2 sharing the card: here with
    # --scenario-only, in a whole run a case of the sharded phase's world.
    if defer:
        shared["scenario"] = scen
    else:
        res2, wall2 = card_world("sharded_cases", {"cases": [scenario_gloo2_case()]}, 2, "gloo",
                                 "scenario_gloo2", SHARDED_WORLD_TIMEOUT_S)
        rows += scenario_gloo2_rows(torch, ne, card, scen,
                                    [case_results(res2[k])[0] for k in (0, 1)], wall2)
    print(f"scenario phase {since()}")
    return rows

# The column-sharded dense backend (step 20): BASELINE.json config 3 at
# full width, and the main path's problem over gloo worlds on the card.
SHARDED_MAIN = dict(m=2048, n=10240, seed=0)
SHARDED_RANKS = 2  # the gloo world's ranks (the shrink's world of 4 is step 21's)
SHARDED_OBJ_TOL = 1e-8
SHARDED_WORLD_TIMEOUT_S = 300.0


def sharded_solve_counted(ne, p, be, **kw):
    """``solve(p, backend=be, tol=1e-8, **kw)`` with K1's launch count
    reset just before and read just after; returns the result, a row and
    the launch accounting against the fused loop's bodies."""
    from distributedlpsolver_tpu_torch.ipm import Status, solve

    ne.normal_eq.launches = 0
    t0 = time.perf_counter()
    r = solve(p, backend=be, tol=1e-8, **kw)
    wall = time.perf_counter() - t0
    launches = ne.normal_eq.launches
    acc = launch_accounting(r, launches, be.phase_report, 0, fused=True)
    row = {"backend": r.backend, "status": r.status.value, "iterations": r.iterations,
           "objective": r.objective, "wall_s": wall, "setup_s": r.setup_time,
           "solve_s": r.solve_time, "ms_per_iteration": 1e3 * r.solve_time / max(r.iterations, 1),
           "setup_parts": be.setup_report, "pinf": r.pinf, "dinf": r.dinf,
           "rel_gap": r.rel_gap, **acc,
           "captured": be.phase_report[0].get("captured"),
           "capture_off_reason": be.phase_report[0].get("capture_off_reason")}
    if r.status != Status.OPTIMAL:
        fail(f"{p.name} through {r.backend}: status {r.status.value}")
    row.update(sharded_answer_check(f"{p.name} through {r.backend}", p, r.x, r.y, r.rel_gap))
    return r, row


def sharded_answer_check(name, p, x, y, rel_gap, tol=1e-8) -> dict:
    """Holds a sharded phase's answer to the problem itself: the row
    violation of x within 1e-7 of the rows' scale (1 + max |row bound|:
    the solver's pinf is relative to 1 + ‖b‖ too, and at 10000x50000 |b|
    runs past 1,000), the solver's rel_gap within ``tol``, and the host
    gap |cᵀx - bᵀy| / (1 + |cᵀx|) within 1e-7, as on the main path, b
    each row's finite bound (the right-hand side the interior form takes:
    the pds classes' linking rows are ≤ rows)."""
    import numpy as np

    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    viol = p.max_violation(x)
    bounds = np.concatenate([p.rlb, p.rub])
    scale = 1.0 + float(np.max(np.abs(bounds[np.isfinite(bounds)]), initial=0.0))
    b = np.where(np.isfinite(p.rlb), p.rlb, p.rub)
    pobj, dobj = float(p.c @ x), float(b @ y)
    gap = abs(pobj - dobj) / (1.0 + abs(pobj))
    if not viol <= 1e-7 * scale:
        fail(f"{name}: max_violation {viol:.3e} > 1e-7 x {scale:.3e}")
    if not rel_gap <= tol:
        fail(f"{name}: rel_gap {rel_gap:.3e} > {tol:.0e}")
    if not gap <= 1e-7:
        fail(f"{name}: host |cᵀx - bᵀy| relative {gap:.3e} > 1e-7")
    return {"max_violation": viol, "row_scale": scale, "host_rel_gap": gap}


def clocked_steps(torch, be, steps=3, parts=None) -> dict:
    """Milliseconds an iteration of the sharded step's parts: ``steps``
    host-loop iterations from the starting point with the stage clock on
    (each part synchronized on its own), split by ``parts`` (default
    :func:`stage_parts`)."""
    from distributedlpsolver_tpu_torch.backends.sharded import StageClock

    st = be.starting_point()
    be.clock = clock = StageClock(be.device)
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, stats = be.iterate(st)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        if stats.bad:
            fail("clocked sharded step: a bad step from the starting point")
    be.clock = None
    return (parts or stage_parts)(clock.report(), sum(walls), steps)


def stage_parts(rep, wall_ms, iterations) -> dict:
    """Per-iteration ms of K1 on the shard, the all-reduce of M, the
    vector all-reduces, the rest of each factorization (the Cholesky)
    and everything else of the step, from a stage clock's totals."""
    ms = rep["ms"]
    k1, red_m, red_v = ms.get("k1", 0.0), ms.get("allreduce_M", 0.0), ms.get("allreduce_vec", 0.0)
    chol = ms.get("factorize", 0.0) - k1 - red_m
    rest = wall_ms - ms.get("factorize", 0.0) - red_v
    per = lambda v: v / max(iterations, 1)
    return {"iterations": iterations, "k1_ms": per(k1), "allreduce_M_ms": per(red_m),
            "allreduce_vec_ms": per(red_v), "cholesky_ms": per(chol), "rest_ms": per(rest),
            "wall_ms": per(wall_ms), "calls": rep["calls"]}


def case_results(o) -> list:
    """A ``sharded_cases`` rank result as one dict a case, each with the
    world's fields (rank, world size, process-group backend)."""
    world = {k: v for k, v in o.items() if k != "cases"}
    return [{**world, **case} for case in o["cases"]]


def side_world(extras, tag, n_ranks=2):
    """``run_world("sharded_cases", ...)`` on a gloo world: ``extras`` are
    cases, each a dict with its ``case`` and a ``tag``, its per-rank
    results (with the world's fields) left in its ``"gloo2"`` with the
    world's wall."""
    res, wall = card_world("sharded_cases", {"cases": [e["case"] for e in extras]}, n_ranks,
                           "gloo", tag)
    res = {rank: case_results(o) for rank, o in res.items()}
    for i, e in enumerate(extras):
        e["gloo2"] = ([o[i] for _, o in sorted(res.items())], wall)


def sharded_world(torch, n_ranks, pg_backend, p, ref, card) -> dict:
    """``run_world("sharded_solve", ...)`` on the main path's problem ``p``
    with ``n_ranks`` ranks on the cards; fails unless every rank is
    OPTIMAL with the same x bits and an answer that passes
    :func:`sharded_answer_check`, K1 ran at its shard's shape, and the
    objective is within ``SHARDED_OBJ_TOL`` of ``ref``'s."""
    from distributedlpsolver_tpu_torch.distributed.launcher import run_world

    work = os.path.join(ROOT, "build", "dlps_torch", f"sharded_{pg_backend}{n_ranks}")
    spec = {**SHARDED_MAIN, "tol": 1e-8, "stage_clock": True, "return_xy": True}
    t0 = time.perf_counter()
    try:
        res = run_world("sharded_solve", spec, world_size=n_ranks, workdir=work, retries=0,
                        timeout=SHARDED_WORLD_TIMEOUT_S, device="cuda", pg_backend=pg_backend)
    except (RuntimeError, TimeoutError) as e:
        fail(f"{pg_backend} world of {n_ranks}: {e}")
    wall = time.perf_counter() - t0
    name = f"{pg_backend} world of {n_ranks}"
    if sorted(res) != list(range(n_ranks)):
        fail(f"{name}: results from ranks {sorted(res)}")
    shas = {o["x_sha256"] for o in res.values()}
    iters = {o["iterations"] for o in res.values()}
    width = SHARDED_MAIN["n"] // n_ranks  # the slack-free dense LP: n columns, no pad
    for rank, o in res.items():
        rel = abs(o["objective"] - ref.objective) / (1.0 + abs(ref.objective))
        if o["status"] != "optimal" or not rel <= SHARDED_OBJ_TOL:
            fail(f"{name}: rank {rank} {o['status']} objective {o['objective']!r} vs cuda "
                 f"{ref.objective!r} ({rel:.3e})")
        if o["shard_shape"] != [SHARDED_MAIN["m"], width] or o["k1_launches"] <= 0:
            fail(f"{name}: rank {rank} shard {o['shard_shape']}, {o['k1_launches']} K1 launches")
        if o["world_size"] != n_ranks or o["pg_backend"] != pg_backend:
            fail(f"{name}: rank {rank} in {o['pg_backend']} world of {o['world_size']}")
        o["answer"] = sharded_answer_check(f"{name}: rank {rank}", p, o.pop("x"), o.pop("y"),
                                           o["rel_gap"])
    if len(shas) != 1 or len(iters) != 1:
        fail(f"{name}: ranks disagree: x digests {shas}, iterations {iters}")
    o = res[0]
    row = {
        "world": name, "ranks": n_ranks, "status": o["status"], "iterations": o["iterations"],
        "cuda_iterations": ref.iterations, "objective": o["objective"],
        "objective_rel_cuda": abs(o["objective"] - ref.objective) / (1.0 + abs(ref.objective)),
        "x_bits_equal_across_ranks": True, "shard_shape": o["shard_shape"],
        "k1_launches_per_rank": [res[r]["k1_launches"] for r in sorted(res)],
        "answer_by_rank": [res[r]["answer"] for r in sorted(res)],
        "rel_gap": o["rel_gap"], "pinf": o["pinf"],
        "rank0_wall_s": o["wall_s"], "world_wall_s": wall, "setup_parts_rank0": o["setup"],
        "captured": o["phase_report"][0].get("captured"),
        "capture_off_reason": o["phase_report"][0].get("capture_off_reason"),
        # The clock covers the starting point and the loop.
        "per_iteration_rank0": stage_parts(
            o["stage_clock"], 1e3 * (o["setup"]["start_s"] + o["solve_s"]), o["iterations"]),
    }
    if o["iterations"] != ref.iterations:
        print(f"sharded_note {name}: {o['iterations']} iterations against cuda's {ref.iterations} "
              "(M summed in shard order rounds differently from one K1 over all columns)")
    print(f"sharded_world {since()} " + json.dumps(row) + f" [{card}]")
    return row


def sharded_phase(torch, ne, card, shared):
    """The column-sharded dense backend on the card (module note, step
    20). Returns the kernels-line rows of K1 at the path's shapes."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.backends.sharded import ShardedTorchBackend
    from distributedlpsolver_tpu_torch.distributed import world as world_lib
    from distributedlpsolver_tpu_torch.distributed.launcher import free_port
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    _T0[0] = time.perf_counter()
    cards = torch.cuda.device_count()
    print(f"sharded_devices torch.cuda.device_count() = {cards}")

    # 1. K1 at the shard shape of the gloo world of 2: parity and timing.
    m, n = SHARDED_MAIN["m"], SHARDED_MAIN["n"] // SHARDED_RANKS
    rel_err, mx = kernel_parity(torch, ne, m, n, "float64")
    t = kernel_timing(torch, ne, m, n, "float64", iters=20, warm=3)
    print(f"sharded_k1 {since()} {m}x{n}: rel_err {rel_err:.3e} max_abs_err {mx:.3e} (tol "
          f"{TOL['float64']:.0e}), M = Mᵀ bitwise, two launches bitwise equal; kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, einsum {t['library_ms']:.4f} ms, "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), share {t['bound_share']:.3f} [{card}]")

    # 2. The main path's problem through sharded on an NCCL world of one
    # formed in this process and through cuda, then three clocked
    # iterations of the sharded step.
    p_main = random_dense_lp(SHARDED_MAIN["m"], SHARDED_MAIN["n"], seed=SHARDED_MAIN["seed"])
    ref, row_cu = sharded_solve_counted(ne, p_main, get_backend("cuda"))
    print(f"sharded_main_cuda {since()} " + json.dumps(row_cu) + f" [{card}]")
    pcg_legs = None
    world = world_lib.init_world(world_lib.WorldConfig(
        coordinator=f"127.0.0.1:{free_port()}", rank=0, world_size=1, device="cuda"))
    try:
        if world.pg_backend != "nccl":
            fail(f"the world of one runs {world.pg_backend}, not nccl")
        be = ShardedTorchBackend()
        r_sh, row_sh = sharded_solve_counted(ne, p_main, be)
        row_sh["world"] = world.describe()
        print(f"sharded_main_nccl1 {since()} " + json.dumps(row_sh) + f" [{card}]")
        parts = clocked_steps(torch, be)
        print(f"sharded_main_parts {since()} " + json.dumps(parts) + f" [{card}]")
        del be
        torch.cuda.empty_cache()
        # Step 25's legs on this world (a whole run: step 24's answers).
        if shared.get("two_phase") is not None:
            pcg_legs = sharded_pcg_nccl_legs(torch, ne, card, shared.pop("two_phase"))
    finally:
        world.close()
    if not np.array_equal(r_sh.x, ref.x):
        fail(f"{p_main.name}: x of sharded (world of one) differs from cuda's")
    if (r_sh.iterations, row_sh["normal_eq_launches"]) != (ref.iterations, row_cu["normal_eq_launches"]):
        fail(f"{p_main.name}: sharded {r_sh.iterations} it / {row_sh['normal_eq_launches']} K1 "
             f"launches, cuda {ref.iterations} / {row_cu['normal_eq_launches']}")
    print(f"sharded_main {since()} sharded (nccl world of one) and cuda: x bit for bit, "
          f"{ref.iterations} iterations and {row_cu['normal_eq_launches']} K1 launches each")
    del r_sh

    # 3. The main path's problem over a gloo world of 2 sharing the card
    # (and an NCCL world over the cards where there are two or more); at
    # the same time, pdlp's column mesh (the solo phase's problem; here
    # with --sharded-only its mesh=None solve first) on a second world of
    # 2 and, in a whole run, the block and scenario tiers' gloo cases on a
    # third (six processes; every all-reduce is staged through the host
    # either way).
    pdlp = shared.get("pdlp")
    if pdlp is None:
        pdlp = dict(p=p_main, r=solve(p_main, backend="pdlp", tol=PDHG_TOL))
    pdlp_case = dict(tag="pdlp 2048x10240 mesh_shape=(2,)", case=pdlp_mesh_case())
    pcg_cases = [] if pcg_legs is None else sharded_pcg_gloo_cases()
    side = []
    block, scen = shared.get("block"), shared.get("scenario")
    if block is not None:
        side.append(dict(block, tag="block pds-10", case=block_gloo2_case()))
    if scen is not None:
        side.append(dict(scen, tag="scenario main path", case=scenario_gloo2_case()))
    with ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(side_world, [pdlp_case] + pcg_cases, "sharded_pdlp")]
        if side:
            futs.append(ex.submit(side_world, side, "sharded_side"))
        world2 = sharded_world(torch, SHARDED_RANKS, "gloo", p_main, ref, card)
        for fut in futs:
            fut.result()
    pdlp_gloo2_check(pdlp["p"], pdlp["r"], *pdlp_case["gloo2"], card)
    block_rows = []
    for e in side:
        if e["tag"] == "block pds-10":
            counts = block_gloo2_check(e, *e["gloo2"], card)
            block_rows += block_rank_rows(torch, ne, card, e, "gloo2", counts)
        else:
            block_rows += scenario_gloo2_rows(torch, ne, card, e, *e["gloo2"])
    if cards >= 2:
        sharded_world(torch, min(cards, 4), "nccl", p_main, ref, card)
    else:
        print("sharded_nccl_multi: one card, no NCCL world over several cards")

    rows = [{
        "name": f"normal_eq (sharded {m}x{n})", "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        "launches": sum(world2["k1_launches_per_rank"]),
        "launches_path": f"sharded, gloo world of {SHARDED_RANKS} on one card (all ranks), 2048x10240",
        "launches_nccl_world_of_one": row_sh["normal_eq_launches"],
        "max_abs_err": mx, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_share": t["bound_share"],
        "library_ms": t["library_ms"], "dtypes": ["float64"], "shape": t["shape"],
    }]
    if pcg_legs is not None:  # step 25
        gloo = sharded_pcg_gloo_check(pcg_cases, pcg_legs["b"]["row"], card)
        block_rows += sharded_pcg_rows(torch, ne, card, pcg_legs, gloo)
        print(f"sharded_pcg legs {pcg_legs['seconds']:.1f} s on the NCCL world of one")
    print(f"sharded phase {since()}")
    return rows + block_rows


# -- the serving slice and the elastic shrink (item 13b) ------------------------------

# The serve bucket, split over a world's batch mesh.
SLICE_BUCKET = dict(m=BM, n=BN, batch=SERVE_BATCH, seed=0, tol=1e-8)
SLICE_WORLD_TIMEOUT_S = 300.0
SLICE_STREAM, SLICE_ASYNC = 48, 32  # the serve phase's cold stream: sync, then async
SHRINK_FAULT_ITERATION = 3
SLICE_OBJ_TOL = 1e-8


def lane_digests(x) -> list:
    import hashlib

    import numpy as np

    return [hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest() for v in x]


def slice_probe(n_ranks, pg_backend, refs, card, block_refs=None) -> dict:
    """``run_world("bucket_probe", SLICE_BUCKET)``: two dispatches of the
    serve bucket over a world's batch mesh, each rank solving its block.
    Fails unless the second dispatch builds and captures nothing, the
    cache sizes agree, every rank's loop was captured (no collective in
    it), the K1 launches are start + warm selection + the rank's bodies,
    and lane by lane status and iterations equal the one-process
    dispatch's (``refs``) with objectives within ``SLICE_OBJ_TOL``; a
    world of one must give its x bit for bit, and rank 0's lanes must be
    bit for bit those of ``block_refs`` (its block solved alone in this
    process) where given."""
    from distributedlpsolver_tpu_torch.distributed.launcher import run_world

    name = f"{pg_backend} world of {n_ranks}"
    work = os.path.join(ROOT, "build", "dlps_torch", f"slice_probe_{pg_backend}{n_ranks}")
    t0 = time.perf_counter()
    try:
        res = run_world("bucket_probe", SLICE_BUCKET, world_size=n_ranks, workdir=work,
                        retries=0, timeout=SLICE_WORLD_TIMEOUT_S, device="cuda",
                        pg_backend=pg_backend)
    except (RuntimeError, TimeoutError) as e:
        fail(f"slice {name}: {e}")
    wall = time.perf_counter() - t0
    if sorted(res) != list(range(n_ranks)):
        fail(f"slice {name}: results from ranks {sorted(res)}")
    launches, bit_equal = 0, []
    for rank, out in res.items():
        if out["world_size"] != n_ranks or out["pg_backend"] != pg_backend:
            fail(f"slice {name}: rank {rank} in a {out['pg_backend']} world of {out['world_size']}")
        if out["warm_recompiles"] != 0 or len(set(out["bucket_cache_sizes"])) != 1:
            fail(f"slice {name}: rank {rank} warm recompiles {out['warm_recompiles']}, cache "
                 f"sizes {out['bucket_cache_sizes']}")
        for k, (d, ref) in enumerate(zip(out["dispatches"], refs)):
            row = d["phase_report"]
            tag = f"slice {name}: rank {rank} dispatch {k}"
            if k == 1 and (d["programs_built"] or d["graphs_captured"]):
                fail(f"{tag}: built {d['programs_built']}, captured {d['graphs_captured']}")
            if not row["captured"] or row["executors"] != n_ranks:
                fail(f"{tag}: captured {row['captured']} over {row['executors']} executors")
            if row["launches"] != 2 + row["executor_bodies"][rank] or row["launches"] <= 2:
                fail(f"{tag}: {row['launches']} K1 launches for "
                     f"{row['executor_bodies'][rank]} bodies")
            launches += row["launches"]
            if d["status"] != [st.value for st in ref.status] or d["iterations"] != ref.iterations.tolist():
                fail(f"{tag}: statuses or iterations differ from the one-process dispatch")
            rel = max(abs(a - b) / (1.0 + abs(b)) for a, b in zip(d["objectives"], ref.objective))
            if not rel <= SLICE_OBJ_TOL:
                fail(f"{tag}: objectives {rel:.3e} from the one-process dispatch")
            same = sum(a == b for a, b in zip(d["x_lane_sha256"], lane_digests(ref.x)))
            if n_ranks == 1 and same != len(ref.x):
                fail(f"{tag}: x of {len(ref.x) - same} lanes differs from the one-process dispatch")
            bit_equal.append(same)
    if len({out["dispatches"][1]["x_sha256"] for out in res.values()}) != 1:
        fail(f"slice {name}: the ranks' gathered x differ")
    block_equal = None
    if block_refs is not None:
        lo, hi = res[0]["lane_block"]
        block_equal = [sum(a == b for a, b in zip(d["x_lane_sha256"][lo:hi], lane_digests(r.x)))
                       for d, r in zip(res[0]["dispatches"], block_refs)]
        if block_equal != [hi - lo] * len(block_refs):
            fail(f"slice {name}: rank 0's lanes differ from its block solved alone: "
                 f"{block_equal} of {hi - lo} bit for bit")
    o = res[0]["dispatches"][1]
    row = {"world": name, "ranks": n_ranks, "world_wall_s": wall,
           "lane_block": res[0]["lane_block"], "bucket_cache_sizes": res[0]["bucket_cache_sizes"],
           "warm_recompiles": 0, "captured": True,
           "lanes_bit_equal_to_one_process": bit_equal, "lanes": len(refs[0].x),
           "rank0_lanes_bit_equal_to_its_block_alone": block_equal,
           "dispatch_ms_rank0": [1e3 * d["solve_s"] for d in res[0]["dispatches"]],
           "one_process_dispatch_ms": [1e3 * r.solve_time for r in refs],
           "gather_ms_rank0": [d["phase_report"]["gather_ms"] for d in res[0]["dispatches"]],
           "bodies": o["phase_report"]["bodies"],
           "executor_bodies": o["phase_report"]["executor_bodies"],
           "normal_eq_launches": launches}
    print(f"slice_probe {since()} " + json.dumps(row) + f" [{card}]")
    return row


def slice_cli(card) -> dict:
    """``cli serve-slice --world-size 2 --pg-backend gloo`` on the card
    behind its HTTP front-end with a registry: the first SLICE_STREAM of
    the serve phase's cold stream through 64 clients (every answer
    OPTIMAL, the JAX package's verdict there, every 32nd against HiGHS),
    then SLICE_ASYNC async requests and a SIGKILL of rank 1: the world
    dies as a unit, the supervisor relaunches a world of one on the same
    port and journal with a ``world_reinit`` record; every acknowledged
    id resolves optimal/timeout, never 404, with no duplicate solve."""
    import shutil
    import tempfile

    import numpy as np

    from distributedlpsolver_tpu_torch.models import random_dense_lp
    from distributedlpsolver_tpu_torch.net.chaos import free_port, journal_duplicate_solves

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="dlps-slice-", dir=os.path.join(ROOT, "build"))
    world_dir, journal = os.path.join(work, "world"), os.path.join(work, "journal")
    ladder, reg = os.path.join(work, "ladder.json"), os.path.join(work, "registry.json")
    with open(ladder, "w") as fh:
        json.dump([{"m": BM, "n": BN, "batch": SERVE_BATCH}], fh)
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "serve-slice",
           "--world-size", "2", "--pg-backend", "gloo", "--port", str(port),
           "--slice-workdir", world_dir, "--journal-dir", journal, "--registry", reg,
           "--buckets", ladder, "--warm-buckets", "--batch", str(SERVE_BATCH), "--flush-ms", "20",
           "--slice-id", "slice0"]
    shapes = ((96, 384), (BM, BN))
    rng = np.random.default_rng(21)  # the cold stream's draws, as specs
    specs = []
    for _ in range(SLICE_STREAM + SLICE_ASYNC):
        m, n = shapes[int(rng.integers(len(shapes)))]
        specs.append({"m": m, "n": n, "seed": int(rng.integers(2**31 - 1))})
    out = {}
    t0 = time.perf_counter()
    log = open(os.path.join(work, "supervisor.log"), "w")
    sup = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)

    def tail():
        log.flush()
        parts = []
        for fn in sorted(os.listdir(world_dir)) if os.path.isdir(world_dir) else []:
            if fn.endswith(".log"):
                parts.append(f"--- {fn} ---\n" + open(os.path.join(world_dir, fn)).read()[-2500:])
        return "\n".join(parts + [open(os.path.join(work, "supervisor.log")).read()[-2000:]])

    def wait(pred, timeout, what):
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline or sup.poll() is not None:
                fail(f"slice cli: {what}\n{tail()}")
            time.sleep(0.2)

    try:
        wait(lambda: _http_json(url + "/healthz", timeout=5)[0] == 200, 300, "never came up")
        out["up_s"] = time.perf_counter() - t0
        st = _http_json(url + "/statusz")[1]["stats"]
        if st.get("mesh_devices") != 2 or not str(st.get("device", "")).startswith("cuda"):
            fail(f"slice cli: /statusz mesh_devices {st.get('mesh_devices')} on {st.get('device')}")
        def client(spec):
            # As the plane's clients: back off on a refused or shed request.
            t_req = time.perf_counter()
            while True:
                code, resp, _ = _http_json(url + "/v1/solve", spec)
                if code in (429, 503, 599) and time.perf_counter() - t_req < 300:
                    time.sleep(min(float(resp.get("retry_after_s", 0.05) or 0.05), 1.0))
                    continue
                return code, resp, time.perf_counter() - t_req

        t_wave = time.perf_counter()
        with ThreadPoolExecutor(64) as ex:
            answers = list(ex.map(client, specs[:SLICE_STREAM]))
        wave_s = time.perf_counter() - t_wave
        worst = 0.0
        for k, (code, resp, _) in enumerate(answers):
            if code != 200 or resp.get("status") != "optimal":
                fail(f"slice cli: request {k}: {code} {str(resp)[:300]}")
            if k % SERVE_SAMPLE == 0:
                h = highs_tight_objective(random_dense_lp(**specs[k]))
                e = abs(resp["objective"] - h) / (1.0 + abs(h))
                worst = max(worst, e)
                if not e <= 1e-8:
                    fail(f"slice cli: request {k} objective {resp['objective']!r} vs HiGHS {h!r}")
        lat = sorted(a[2] for a in answers)
        out.update(requests=SLICE_STREAM, wave_s=wave_s, rps_before_kill=SLICE_STREAM / wave_s,
                   latency_ms_p50=1e3 * lat[len(lat) // 2],
                   latency_ms_p99=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                   highs_max_rel=worst, published=len([f for f in os.listdir(
                       os.path.join(world_dir, "ctrl-gen0")) if f.endswith(".npz")]))
        st = _http_json(url + "/statusz")[1]["stats"]
        out["rank0_k1_launches_before_kill"] = st["dispatch_totals"].get("launches", 0)
        ids = []
        for sp in specs[SLICE_STREAM:]:
            code, resp, _ = _http_json(url + "/v1/solve", {**sp, "async": True})
            if code != 202:
                fail(f"slice cli: async request: {code} {resp}")
            ids.append(resp["id"])
        with open(os.path.join(world_dir, "hb-gen0", "rank1.hb")) as fh:
            os.kill(json.load(fh)["pid"], signal.SIGKILL)
        t_kill = time.perf_counter()
        reinit = os.path.join(world_dir, "world.jsonl")
        wait(lambda: os.path.exists(reinit), 300, "no world_reinit after the kill")
        wait(lambda: _http_json(url + "/healthz", timeout=5)[0] == 200, 300, "no relaunch")
        out["relaunch_s"] = time.perf_counter() - t_kill
        with open(reinit) as fh:
            ev = [json.loads(ln) for ln in fh if ln.strip()]
        if (ev[0]["event"] != "world_reinit" or ev[0]["world_size"] != 1
                or not ev[0]["recovery_overhead_s"] > 0):
            fail(f"slice cli: {ev}")
        out["world_reinit"] = ev[0]
        verdicts = {}
        deadline = time.monotonic() + 300
        while len(verdicts) < len(ids):
            if time.monotonic() > deadline:
                fail(f"slice cli: unresolved ids {sorted(set(ids) - set(verdicts))}")
            for rid in ids:
                if rid in verdicts:
                    continue
                code, resp, _ = _http_json(f"{url}/v1/solve/{rid}", timeout=30)
                if code == 404:
                    fail(f"slice cli: id {rid} answered 404 after the relaunch")
                if code in (200, 504) and "status" in resp:
                    verdicts[rid] = resp["status"]
            time.sleep(0.1)
        if not set(verdicts.values()) <= {"optimal", "timeout"}:
            fail(f"slice cli: verdicts {verdicts}")
        dups = journal_duplicate_solves(journal)
        if dups:
            fail(f"slice cli: {dups} duplicate solves")
        out["verdicts"] = {v: sum(x == v for x in verdicts.values()) for v in set(verdicts.values())}
        out["duplicate_solves"] = dups
        st = _http_json(url + "/statusz")[1]["stats"]
        with open(reg) as fh:
            entry = json.load(fh)["backends"].get(url, {})
        if st.get("mesh_devices") != 1 or entry.get("world_size") != 1 or entry.get(
                "slice_id") != "slice0":
            fail(f"slice cli: after the relaunch mesh_devices {st.get('mesh_devices')}, "
                 f"registry {entry}")
        if _http_json(url + "/quitquitquit", {}, timeout=60)[0] != 200:
            fail("slice cli: the drain was refused")
        try:
            rc = sup.wait(timeout=180)
        except subprocess.TimeoutExpired:
            fail(f"slice cli: the supervisor did not exit after the drain\n{tail()}")
        if rc != 0:
            fail(f"slice cli: the supervisor exited {rc}\n{tail()}")
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait(timeout=60)
        for gen in os.listdir(world_dir) if os.path.isdir(world_dir) else []:
            hb_dir = os.path.join(world_dir, gen)
            if not (gen.startswith("hb-gen") and os.path.isdir(hb_dir)):
                continue
            for fn in os.listdir(hb_dir):  # no rank outlives the phase
                try:
                    with open(os.path.join(hb_dir, fn)) as fh:
                        os.kill(json.load(fh)["pid"], signal.SIGKILL)
                except (OSError, ValueError, KeyError):
                    pass
        log.close()
    out["wall_s"] = time.perf_counter() - t0
    print(f"slice_cli {since()} " + json.dumps(out) + f" [{card}]")
    shutil.rmtree(work, ignore_errors=True)  # journals and logs: kept only on a failure
    return out


def slice_shrink(ref, p_main, card, extra=None) -> dict:
    """The SHRINK rung on ``sharded`` over a gloo world of 4 ranks sharing
    the card: ``random_dense_lp(2048, 10240, seed=0)`` supervised with
    DEVICE_LOST of rank 3 at iteration SHRINK_FAULT_ITERATION; then the
    same plan with ``min_devices=4`` (``degrade:cuda``). ``extra``, another
    phase's case (a dict with its ``case``), rides the same world third:
    its per-rank results are left in its ``"gloo4"`` with the world's wall."""
    from distributedlpsolver_tpu_torch.distributed.launcher import run_world

    fault = [{"kind": "device_lost", "iteration": SHRINK_FAULT_ITERATION, "device_ids": [3]}]
    case = {**SHARDED_MAIN, "tol": 1e-8, "faults": fault, "supervisor": {"backoff_base": 0.001}}
    cases = [{**case, "return_xy": True},
             {**case, "supervisor": {"backoff_base": 0.001, "min_devices": 4}}]
    if extra is not None:
        cases.append(extra["case"])
    work = os.path.join(ROOT, "build", "dlps_torch", "slice_shrink_gloo4")
    t0 = time.perf_counter()
    try:
        res = run_world("supervised_solve", {"cases": cases}, world_size=4, workdir=work,
                        retries=0, timeout=SLICE_WORLD_TIMEOUT_S, device="cuda", pg_backend="gloo")
    except (RuntimeError, TimeoutError) as e:
        fail(f"shrink: {e}")
    wall = time.perf_counter() - t0
    if extra is not None:
        extra["gloo4"] = ({rank: o["cases"][2] for rank, o in res.items()}, wall)
    rel = lambda o: abs(o["objective"] - ref.objective) / (1.0 + abs(ref.objective))
    left = res[3]["cases"][0]
    if not left["left"] or left["faults"][0]["action"] != "shrink:4->3":
        fail(f"shrink: rank 3 {left}")
    shas, answers, overhead = set(), [], []
    for rank in (0, 1, 2):
        o = res[rank]["cases"][0]
        f = o["faults"]
        if (o["left"] or o["status"] != "optimal" or o["backend"] != "sharded"
                or [x["action"] for x in f] != ["shrink:4->3"] or f[0]["devices"] != [3]
                or not f[0]["recovery_overhead_s"] > 0 or not rel(o) <= SHARDED_OBJ_TOL):
            fail(f"shrink: rank {rank} {o['status']} on {o['backend']}, faults {f}, objective "
                 f"{o['objective']!r} against cuda's {ref.objective!r}")
        shas.add(o["x_sha256"])
        answers.append(sharded_answer_check(f"shrink rank {rank}", p_main, o.pop("x"),
                                            o.pop("y"), o["rel_gap"]))
        overhead.append(f[0]["recovery_overhead_s"])
    if len(shas) != 1:
        fail(f"shrink: the survivors' x differ: {shas}")
    for rank in range(4):
        o = res[rank]["cases"][1]
        if (o["status"] != "optimal" or o["backend"] != "cuda"
                or o["faults"][0]["action"] != "degrade:cuda" or not rel(o) <= SHARDED_OBJ_TOL):
            fail(f"shrink min_devices=4: rank {rank} {o}")
    o = res[0]["cases"][0]
    row = {"world": "gloo world of 4", "action": "shrink:4->3", "status": o["status"],
           "backend": o["backend"], "iterations": o["iterations"], "cuda_iterations": ref.iterations,
           "objective_rel_cuda": rel(o), "x_bits_equal_across_survivors": True,
           "recovery_overhead_s": overhead, "answers": answers, "wall_s_rank0": o["wall_s"],
           "min_devices_4": {"action": "degrade:cuda", "backend": "cuda",
                             "iterations": res[0]["cases"][1]["iterations"],
                             "recovery_overhead_s": res[0]["cases"][1]["faults"][0][
                                 "recovery_overhead_s"]},
           "world_wall_s": wall}
    print(f"slice_shrink {since()} " + json.dumps(row) + f" [{card}]")
    return row


def slice_phase(torch, ne, card, shared):
    """The serving slice and the elastic shrink (module note, step 21).
    Returns the kernels-line rows of K1 at a rank's lane block, and in a
    whole run those of the block tier's shrink, which rides this phase's
    world of 4 (``shared["block"]``)."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import batched as tb
    from distributedlpsolver_tpu_torch.ipm import SolverConfig, solve
    from distributedlpsolver_tpu_torch.models import random_batched_lp, random_dense_lp
    from distributedlpsolver_tpu_torch.models.generators import BatchedLP
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService

    _T0[0] = time.perf_counter()
    # 1. K1 at a rank's lane block of the serve bucket over a world of 2.
    half = SERVE_BATCH // 2
    parity = kernel_parity(torch, ne, BM, BN, "float64", batch=half)
    timing = kernel_timing(torch, ne, BM, BN, "float64", iters=20, warm=3, batch=half)
    print(f"slice_k1 {since()} {half}x{BM}x{BN}: max_abs_err {parity[1]:.3e} (tol "
          f"{TOL['float64']:.0e}), each lane the unbatched kernel's bits; kernel "
          f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, einsum "
          f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({timing['bound_by']}), share {timing['bound_share']:.3f} [{card}]")

    # 2. bucket_probe: the one-process dispatches first (warm), then an
    # NCCL world of one and a gloo world of 2 sharing the card.
    cfg = SolverConfig(tol=SLICE_BUCKET["tol"], verbose=False)
    B, seed = SLICE_BUCKET["batch"], SLICE_BUCKET["seed"]
    batches = [random_batched_lp(B, BM, BN, seed=s) for s in (seed, seed + 1)]
    tb.solve_bucket(batches[0], np.ones(B, bool), cfg, max_iter=1)  # build and capture
    refs = [tb.solve_bucket(b, np.ones(B, bool), cfg) for b in batches]
    # The first rank's block alone in this process: the same program on
    # the same lanes as that rank's.
    block = [tb.solve_bucket(BatchedLP(c=b.c[:B // 2], A=b.A[:B // 2], b=b.b[:B // 2],
                                       name=b.name), np.ones(B // 2, bool), cfg)
             for b in batches]
    # 3. cli serve-slice over gloo on the card, through a rank kill (in a
    # whole run it ran beside the plane phase's processes); and the SHRINK
    # rung on sharded over a gloo world of 4 (in a whole run with the
    # block tier's shrink as its third case), all at the same time as the
    # probes' worlds: every all-reduce of theirs is staged through the
    # host either way.
    p_main = random_dense_lp(SHARDED_MAIN["m"], SHARDED_MAIN["n"], seed=SHARDED_MAIN["seed"])
    ref = solve(p_main, backend="cuda", tol=1e-8)
    pds = shared.get("block")
    shrink_extra = None if pds is None else dict(case=block_shrink_case())
    cli_row = shared.pop("slice_cli", None)
    with ThreadPoolExecutor(3) as ex:
        fut_cli = ex.submit(slice_cli, card) if cli_row is None else None
        fut_shrink = ex.submit(slice_shrink, ref, p_main, card, shrink_extra)
        fut_gloo = ex.submit(slice_probe, 2, "gloo", refs, card, block)
        probes = {1: slice_probe(1, "nccl", refs, card), 2: fut_gloo.result()}
        fut_shrink.result()
        if fut_cli is not None:
            cli_row = fut_cli.result()
    block_rows = []
    if pds is not None:
        counts = block_shrink_check(pds, *shrink_extra["gloo4"], card)
        block_rows = (block_rank_rows(torch, ne, card, pds, "gloo4", counts)
                      + block_rank_rows(torch, ne, card, pds, "shrunk", counts))

    # 5. A local batch mesh names distinct cards: beyond the card count it
    # raises, naming the count; nothing falls back.
    cards = torch.cuda.device_count()
    try:
        svc = SolveService(ServiceConfig(mesh_devices=cards + 1), auto_start=False)
    except ValueError as e:
        if f"only {cards} local devices" not in str(e):
            fail(f"mesh_devices={cards + 1} on {cards} card(s): {e}")
        print(f"slice_mesh_devices mesh_devices={cards + 1} on {cards} card(s) raises: {e}")
    else:
        svc.shutdown()
        fail(f"mesh_devices={cards + 1} on {cards} card(s) built a service")
    print(f"slice phase {since()} (serve-slice {cli_row['wall_s']:.1f} s)")
    return [{
        "name": f"normal_eq (slice lane block {half}x{BM}x{BN})", "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        "launches": probes[2]["normal_eq_launches"],
        "launches_path": "bucket_probe over a gloo world of 2 on one card (both ranks, two dispatches)",
        "max_abs_err": parity[1], "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "bound_share": timing["bound_share"], "library_ms": timing["library_ms"],
        "dtypes": ["float64"], "shape": timing["shape"],
    }] + block_rows


# -- the row-sharded matrix-free tier (sparse-iterative on a mesh) -------------

# The kernel leg's split: rank 0's block of STORM_FULL over this many ranks.
ROWS_SPLIT = 2
# The gloo worlds sharing the card, the world of 2 and the shrink's world
# of 4: the reference's acceptance instance, as a sparse_rows spec.
ROWS_WORLD = dict(instance="storm", scenarios=STORM_20K["num_scenarios"],
                  block_m=STORM_20K["block_m"], block_n=STORM_20K["block_n"],
                  first_stage_n=STORM_20K["first_stage_n"], seed=STORM_20K["seed"], tol=1e-8)
ROWS_OBJ_TOL = 1e-8
ROWS_WORLD_TIMEOUT_S = 300.0


def card_world(task, spec, n_ranks, pg_backend, tag, timeout=ROWS_WORLD_TIMEOUT_S):
    """``run_world(task, spec)`` with ``n_ranks`` ranks on the card; any
    rank's failure fails the run. Returns (per-rank results, wall s)."""
    from distributedlpsolver_tpu_torch.distributed.launcher import run_world

    work = os.path.join(ROOT, "build", "dlps_torch", f"world_{tag}")
    t0 = time.perf_counter()
    try:
        res = run_world(task, spec, world_size=n_ranks, workdir=work, retries=0, timeout=timeout,
                        device="cuda", pg_backend=pg_backend)
    except (RuntimeError, TimeoutError) as e:
        fail(f"world {tag}: {e}")
    wall = time.perf_counter() - t0
    if sorted(res) != list(range(n_ranks)):
        fail(f"world {tag}: results from ranks {sorted(res)}")
    return res, wall


def rows_phase(torch, ne, card, shared):
    """The row-sharded matrix-free tier on the card (module note, step 22).
    Returns the kernels-line rows of the ELL kernel on a rank's row block."""
    import hashlib

    import numpy as np

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.distributed import world as world_lib
    from distributedlpsolver_tpu_torch.distributed.launcher import free_port
    from distributedlpsolver_tpu_torch.distributed.worker import TASKS
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import storm_sparse_lp
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form
    from distributedlpsolver_tpu_torch.models.scaling import equilibrate
    from distributedlpsolver_tpu_torch.ops import sparse

    _T0[0] = time.perf_counter()
    sha = lambda a: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()  # noqa: E731

    # 1. stormG2_1000's shape on an NCCL world of one (run_world), against
    # the mesh=None solve of the same problem in this process.
    full = {"instance": "storm", "scenarios": STORM_FULL["num_scenarios"],
            **{k: v for k, v in STORM_FULL.items() if k != "num_scenarios"}, "tol": 1e-8}
    # The world of one runs in this process (the task itself on an NCCL
    # world of one), as the sharded phase's does.
    t0 = time.perf_counter()
    world = world_lib.init_world(world_lib.WorldConfig(
        coordinator=f"127.0.0.1:{free_port()}", rank=0, world_size=1, device="cuda"))
    try:
        o = {**TASKS["sparse_rows"](world, full), **world.describe()}
    finally:
        world.close()
    wall_w = time.perf_counter() - t0
    res = {0: o}
    p_full = storm_sparse_lp(**STORM_FULL)
    m_full, n_full = p_full.A.shape
    ref = shared.get("sparse_full")
    if ref is None:  # --rows-only: the mesh=None solve here
        be = get_backend("sparse-iterative")
        t0 = time.perf_counter()
        r = solve(p_full, backend=be, tol=1e-8)
        ref = dict(x=np.asarray(r.x), y=np.asarray(r.y), iterations=r.iterations,
                   wall_s=time.perf_counter() - t0, cg_iters=be.cg_report()["cg_iters"],
                   setup_s=r.setup_time, solve_s=r.solve_time, setup_parts=be.setup_report)
        del r, be
    if o["pg_backend"] != "nccl" or o["world_size"] != 1 or o["shape"] != [m_full, n_full]:
        fail(f"rows full: {o['pg_backend']} world of {o['world_size']}, shape {o['shape']}")
    if (o["status"] != "optimal" or o["x_sha256"] != sha(ref["x"]) or o["y_sha256"] != sha(ref["y"])
            or o["iterations"] != ref["iterations"] or o["cg_iters"] != ref["cg_iters"]):
        fail(f"rows full: the world of one {o['status']} {o['iterations']} it cg {o['cg_iters']} "
             f"x {o['x_sha256'][:12]} against mesh=None {ref['iterations']} it cg "
             f"{ref['cg_iters']} x {sha(ref['x'])[:12]}")
    obj_rel = abs(o["objective"] - STORM_FULL_OBJECTIVE) / abs(STORM_FULL_OBJECTIVE)
    if not obj_rel <= 1e-8:
        fail(f"rows full: objective {o['objective']!r}, {obj_rel:.2e} from {STORM_FULL_OBJECTIVE!r}")
    if o["ell_launches"]["A·v"] <= 0 or o["ell_launches"]["Aᵀ·v"] <= 0:
        fail(f"rows full: ELL launches {o['ell_launches']}")
    # x and y are the world's bit for bit (their digests): hold them to the
    # problem on the host.
    answer = sharded_answer_check("rows full", p_full, ref["x"], ref["y"], o["rel_gap"])
    print(f"rows_full {since()} " + json.dumps({
        "problem": p_full.name, "world": "nccl world of one (in this process)",
        "status": o["status"],
        "iterations": o["iterations"], "cg_iters": o["cg_iters"], "objective": o["objective"],
        "objective_rel": obj_rel, "x_bits_equal_mesh_none": True, "y_bits_equal_mesh_none": True,
        "s_per_step": o["solve_s"] / max(o["iterations"], 1), "wall_s": o["wall_s"],
        "setup_s": o["setup_s"], "solve_s": o["solve_s"], "setup_parts": o["setup"],
        "world_wall_s": wall_w, "newton_solves": o["newton_solves"], "host_syncs": o["host_syncs"],
        "shards": o["shards"], "psum_per_iter": o["psum_per_iter"],
        "max_operand_per_device": o["max_operand_per_device"],
        "operator_bytes_per_device": o["operator_bytes_per_device"],
        "ell_launches": o["ell_launches"], "answer": answer,
        "mesh_none": {k: ref[k] for k in ("wall_s", "setup_s", "solve_s", "setup_parts",
                                          "cg_iters")},
    }) + f" [{card}]")
    torch.cuda.empty_cache()

    # 2. The ELL kernel on rank 0's block of a ROWS_SPLIT-way split (the
    # scaled A the solve runs on), beside the whole operator's memory.
    inf_s, _ = equilibrate(to_interior_form(p_full))
    lo, hi = 0, -(-m_full // ROWS_SPLIT)
    t0 = time.perf_counter()
    op_r = sparse.from_scipy(inf_s.A[lo:hi], device="cuda", fmt="ell")
    torch.cuda.synchronize()
    t_block = time.perf_counter() - t0
    op_w = sparse.from_scipy(inf_s.A, device="cuda")
    empty = int((np.diff(inf_s.A[lo:hi].tocsc().indptr) == 0).sum())
    mem = {"block_bytes": op_r.nbytes(), "whole_bytes": op_w.nbytes(),
           "block_share": op_r.nbytes() / op_w.nbytes(),
           "transpose_index_bytes": op_r.tsell.index.numel() * 4,
           "whole_transpose_index_bytes": op_w.tsell.index.numel() * 4,
           "block_by_tensor": {k: v["nbytes"] for k, v in op_r.memory_report().items()},
           "whole_by_tensor": {k: v["nbytes"] for k, v in op_w.memory_report().items()}}
    del op_w
    torch.cuda.empty_cache()
    print(f"rows_block {since()} rows [{lo}, {hi}) of {m_full} x {n_full}: nnz {op_r.nnz}, Aᵀ "
          f"rows empty {empty} of {n_full}, A_r {op_r.sell.n_slices} slices, A_rᵀ "
          f"{op_r.tsell.n_slices} slices + {op_r.tsell.n_chunks} chunks on {op_r.tsell.n_heavy} heavy "
          f"rows, built in {t_block:.2f} s; memory " + json.dumps(mem))
    w = torch.randn(op_r.m, dtype=torch.float64, device="cuda")
    out = op_r.rmatvec(w)
    torch.cuda.synchronize()
    zero_rows = torch.as_tensor(np.diff(inf_s.A[lo:hi].tocsc().indptr) == 0, device="cuda")
    if not bool((out[zero_rows] == 0).all()) or bool(torch.signbit(out[zero_rows]).any()):
        fail("rows block: an empty row of A_rᵀ·w is not an exact +0")
    ell_block = ell_phase(torch, op_r, f"storm rank 0 of {ROWS_SPLIT} {hi - lo}x{n_full}", card)
    del op_r, out, w, inf_s
    torch.cuda.empty_cache()

    # 3. Gloo worlds sharing the card at the 20,480-row instance, held to
    # the sparse phase's single-device solve of it: a world of 2, and the
    # shrink of a world of 4.
    p20 = storm_sparse_lp(**STORM_20K)
    r20 = shared.get("storm20k")
    if r20 is None:  # --rows-only: the mesh=None solve here
        be = get_backend("sparse-iterative")
        r = solve(p20, backend=be, tol=1e-8)
        if r.status.value != "optimal":
            fail(f"rows: mesh=None on {p20.name}: {r.status.value}")
        r20 = dict(objective=r.objective, iterations=r.iterations,
                   cg_iters=be.cg_report()["cg_iters"], solve_s=r.solve_time)
        del r, be
    rel = lambda v: abs(v - r20["objective"]) / (1.0 + abs(r20["objective"]))  # noqa: E731
    m4 = p20.A.shape[0]
    split3 = [min(m4, (k + 1) * -(-m4 // 3)) - min(m4, k * -(-m4 // 3)) for k in range(3)]
    fault = [{"kind": "device_lost", "iteration": SHRINK_FAULT_ITERATION, "device_ids": [3]}]
    case = {**ROWS_WORLD, "backend": "sparse-iterative", "faults": fault,
            "supervisor": {"backoff_base": 0.001}, "return_xy": True}
    # The two worlds run at once (six processes; every all-reduce is
    # staged through the host either way).
    with ThreadPoolExecutor(1) as ex:
        fut4 = ex.submit(card_world, "supervised_solve", case, 4, "gloo", "rows_shrink_gloo4")
        res2, wall2 = card_world("sparse_rows", {**ROWS_WORLD, "return_xy": True}, 2, "gloo",
                                 "rows_gloo2")
        res4, wall4 = fut4.result()
    for rank, o in res2.items():
        if (o["status"] != "optimal" or o["iterations"] != r20["iterations"]
                or not rel(o["objective"]) <= ROWS_OBJ_TOL or o["shards"] != 2
                or o["pg_backend"] != "gloo" or o["ell_launches"]["A·v"] <= 0
                or o["ell_launches"]["Aᵀ·v"] <= 0):
            fail(f"rows gloo world of 2: rank {rank} {o['status']} {o['iterations']} it (mesh=None "
                 f"{r20['iterations']}), objective {o['objective']!r} ({rel(o['objective']):.2e}), "
                 f"shards {o['shards']}, {o['pg_backend']}, launches {o['ell_launches']}")
        o["answer"] = sharded_answer_check(f"rows gloo world of 2: rank {rank}", p20, o.pop("x"),
                                           o.pop("y"), o["rel_gap"])
    if len({o["x_sha256"] for o in res2.values()}) != 1 or len({o["cg_iters"] for o in res2.values()}) != 1:
        fail(f"rows gloo world of 2: ranks disagree: {[(o['x_sha256'][:12], o['cg_iters']) for o in res2.values()]}")
    o = res2[0]
    w2 = {"world": "gloo world of 2", "problem": p20.name, "status": o["status"],
          "iterations": o["iterations"], "mesh_none_iterations": r20["iterations"],
          "objective_rel_mesh_none": rel(o["objective"]), "cg_iters": o["cg_iters"],
          "mesh_none_cg_iters": r20["cg_iters"], "x_bits_equal_across_ranks": True,
          "rows_by_rank": [res2[k]["rows"] for k in sorted(res2)],
          "ell_launches_by_rank": [res2[k]["ell_launches"] for k in sorted(res2)],
          "s_per_step_rank0": o["solve_s"] / max(o["iterations"], 1), "solve_s_rank0": o["solve_s"],
          "setup_parts_rank0": o["setup"], "mesh_none_solve_s": r20["solve_s"],
          "max_operand_per_device": o["max_operand_per_device"],
          "operator_bytes_per_device": [res2[k]["operator_bytes_per_device"] for k in sorted(res2)],
          "answers": [res2[k]["answer"] for k in sorted(res2)], "world_wall_s": wall2}
    print(f"rows_gloo2 {since()} " + json.dumps(w2) + f" [{card}; gloo through the host, not NCCL]")

    if not res4[3]["left"] or res4[3]["faults"][0]["action"] != "shrink:4->3":
        fail(f"rows shrink: rank 3 {res4[3]}")
    shas, answers, overhead = set(), [], []
    for rank in (0, 1, 2):
        o = res4[rank]
        f = o["faults"]
        if (o["left"] or o["status"] != "optimal" or o["backend"] != "sparse-iterative"
                or [x["action"] for x in f] != ["shrink:4->3"] or f[0]["devices"] != [3]
                or not f[0]["recovery_overhead_s"] > 0 or not rel(o["objective"]) <= ROWS_OBJ_TOL):
            fail(f"rows shrink: rank {rank} {o['status']} on {o['backend']}, faults {f}, objective "
                 f"{o['objective']!r} against mesh=None's {r20['objective']!r}")
        shas.add(o["x_sha256"])
        answers.append(sharded_answer_check(f"rows shrink rank {rank}", p20, o.pop("x"), o.pop("y"),
                                            o["rel_gap"]))
        overhead.append(f[0]["recovery_overhead_s"])
    if len(shas) != 1:
        fail(f"rows shrink: the survivors' x differ: {shas}")
    o = res4[0]
    w4 = {"world": "gloo world of 4", "problem": p20.name, "action": "shrink:4->3",
          "rows_after_shrink": split3, "status": o["status"],
          "backend": o["backend"], "iterations": o["iterations"],
          "mesh_none_iterations": r20["iterations"], "objective_rel_mesh_none": rel(o["objective"]),
          "x_bits_equal_across_survivors": True, "recovery_overhead_s": overhead,
          "answers": answers, "wall_s_rank0": o["wall_s"], "world_wall_s": wall4}
    print(f"rows_shrink {since()} " + json.dumps(w4) + f" [{card}; gloo through the host, not NCCL]")
    print(f"rows phase {since()}")

    rows = []
    for name, replaces in (("A·v", "distributedlpsolver_tpu/ops/sparse.py:579"),
                           ("Aᵀ·v", "distributedlpsolver_tpu/ops/sparse.py:595")):
        t = ell_block[name]
        rows.append({
            "name": f"ell_spmv ({name[0]}_r{name[1:]}, row block)", "route": "cuda",
            "source": "distributedlpsolver_tpu_torch/csrc/ell_spmv.cu", "replaces": replaces,
            # Rank 0's launches in the gloo world of 2 (its row block of
            # the 20,480-row instance); the kernel's numbers below are at
            # rank 0's block of stormG2_1000's shape split in two.
            "launches": res2[0]["ell_launches"][name],
            "launches_path": "sparse_rows over a gloo world of 2 on one card (rank 0)",
            "launches_full_world_of_one": res[0]["ell_launches"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_share": t["bound_share"],
            "library_ms": t["library_ms"], "library": "cuSPARSE CSR SpMV (torch.sparse)",
            "ms_cold": t["ms_cold"], "library_ms_cold": t["library_ms_cold"],
            "bound_share_cold": t["bound_share_cold"], "layout_bytes": t["layout_bytes"],
            "slices": t["slices"], "heavy_chunks": t["heavy_chunks"], "dtypes": ["float64"],
            "shape": [hi - lo, n_full],
        })
    return rows


# The JAX package's verdicts for the pcg phase's instances under
# solve_mode="pcg" at tol 1e-8, max_iter 200, on the CPU, with each run's
# best max(rel_gap, pinf, dinf) (``JAX_PLATFORMS=cpu python
# scripts/port_pcg_jax_verdicts.py``; the full width took 1,211 s).
PCG_JAX = {
    "small_fused": {"status": "optimal", "iterations": 12, "objective": 166.05981005706167,
        "rel_gap": 7.924253124358696e-09, "pinf": 7.475362475836445e-13,
        "min_err": 7.924253124358696e-09},
    "small_host": {"status": "optimal", "iterations": 12, "objective": 166.05981005706167,
        "rel_gap": 7.924253124358696e-09, "pinf": 7.475362475836445e-13,
        "min_err": 7.924253124358696e-09},
    "small_segmented": {"status": "optimal", "iterations": 12, "objective": 166.05981005718908,
        "rel_gap": 7.925016322805116e-09, "pinf": 3.5912469545549635e-13,
        "min_err": 7.925016322805116e-09},
    "mid_fused": {"status": "iteration_limit", "iterations": 200, "objective": 3246.321486954089,
        "rel_gap": 3.648475894581509e-06, "pinf": 1.3535873076421826e-05,
        "min_err": 8.183393886992595e-06},
    "mid_host": {"status": "iteration_limit", "iterations": 200, "objective": 3246.321486954089,
        "rel_gap": 3.648475894581509e-06, "pinf": 1.3535873076421826e-05,
        "min_err": 8.183393886992595e-06},
    "mid_segmented": {"status": "stalled", "iterations": 35, "objective": 3246.3410568283207,
        "rel_gap": 1.1190864307331612e-05, "pinf": 3.6110236382553035e-07,
        "min_err": 1.1190864307331612e-05},
    "full_fused": {"status": "iteration_limit", "iterations": 200, "objective": 15829.410043199126,
        "rel_gap": 2.0706636009363924e-06, "pinf": 6.705685172054956e-06,
        "min_err": 6.705685172054956e-06},
}
PCG_SHAPES = {"small": (60, 180), "mid": (512, 2560), "full": (2048, 10240)}
PCG_LOOPS = {"fused": {}, "host": {"fused_loop": False}, "segmented": {"segment_iters": 10}}
# Cases not run, for the script's time (PERF.md §4): since K1's f32 design
# the card runs 512x2560 to the iteration limit, as the JAX package does,
# and its host loop took 14.5 s there in a whole run; 60x180 keeps the
# host loop's verdict.
PCG_CUT = ("mid_host",)
PCG_OBJ_TOL = 1e-8  # objective against the JAX package's, OPTIMAL cases
PCG_HIGHS_TOL = 1e-6  # objective against HiGHS, OPTIMAL cases of the full width
PCG_ITER_SLACK = 2  # iterations against the JAX package's, where not at the limit
PCG_RATIO = 10.0  # final rel_gap and pinf against the JAX package's, where not OPTIMAL
# The fused loop's stall patience floor at tol 1e-8 (1e3·tol): its stall
# exit fires only while the run's best max(rel_gap, pinf, dinf) stays above.
PCG_PATIENCE = 1e-5


def pcg_solve_counted(torch, name, **kw):
    """``solve(random_dense_lp(m, n, seed=0), backend="cuda",
    solve_mode="pcg", tol=1e-8, max_iter=200)`` on the loop ``kw`` of the
    case ``name`` ("<size>_<loop>"), with K1's launches reset just before
    and read just after, the peak device memory and the CG tally. Returns
    the problem, the result and the row."""
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp
    from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
    from distributedlpsolver_tpu_torch.ops import normal_eq

    size, loop = name.split("_")
    p = random_dense_lp(*PCG_SHAPES[size], seed=0)
    be = get_backend("cuda")
    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        normal_eq.launches = 0
        t0 = time.perf_counter()
        r = solve(p, backend=be, tol=1e-8, max_iter=200, solve_mode="pcg", **PCG_LOOPS[loop], **kw)
        wall = time.perf_counter() - t0
        launches = normal_eq.launches
    finally:
        obs_metrics.set_registry(prev)
    refactors = int(reg.snapshot().get("ipm_refactorizations_total", 0))
    phases = getattr(be, "phase_report", None)
    err = [max(h.rel_gap, h.pinf, h.dinf) for h in r.history]
    best = min(range(len(err)), key=err.__getitem__)
    # The segmented route also assembles G = A·Aᵀ for its closure, once.
    closure = 1 if loop == "segmented" else 0
    if (be._closure is not None) != bool(closure):
        fail(f"pcg {name}: the primal-row closure {'missing' if closure else 'built'} on this route")
    acc = launch_accounting(r, launches - closure, phases, refactors, loop != "host")
    cg = be.cg_report()
    row = {
        "case": name, "status": r.status.value, "iterations": r.iterations,
        "objective": r.objective, "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf,
        "min_err": err[best], "min_err_at": best + 1, "wall_s": wall, "setup_s": r.setup_time, "solve_s": r.solve_time,
        "ms_per_iteration": 1e3 * r.solve_time / max(r.iterations, 1),
        "normal_eq_f32_launches": launches, "closure_launches": closure,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **cg,
        "cg_live_per_solve": cg["cg_live"] / max(cg["solves"], 1),
        "cg_masked_per_solve": cg["cg_masked"] / max(cg["solves"], 1),
        **{k: acc[k] for k in ("bodies", "replays", "masked", "bad_steps", "refactorizations")
           if k in acc},
    }
    if phases is not None and phases[0]["mode"] != "pcg":
        fail(f"pcg {name}: the phase ran in mode {phases[0]['mode']}")
    return p, r, be, row


def pcg_by_patience(name, status, row, ref) -> bool:
    """Whether a status that differs from the JAX package's differs only
    through the stall exit's patience floor: both runs end on the plateau
    (ITERATION_LIMIT or STALLED) of a loop with a stall exit, and each
    run's best error lies on the side of ``PCG_PATIENCE`` its status needs
    (above it where the run stalled, at or below it where the run went on
    to the iteration limit). One such case is logged in ROADMAP Queue 3."""
    plateau = ("iteration_limit", "stalled")
    return (not name.endswith("_host") and status in plateau and ref["status"] in plateau
            and (row["min_err"] > PCG_PATIENCE) == (status == "stalled")
            and (ref["min_err"] > PCG_PATIENCE) == (ref["status"] == "stalled"))


def pcg_verdict(name, r, row, p=None):
    """Hold a PCG solve to the JAX package's verdict for its case."""
    ref = PCG_JAX[name]
    if ref is None:
        fail(f"pcg {name}: no JAX verdict recorded")
    row["jax_status"] = ref["status"]
    if r.status.value != ref["status"]:
        if not pcg_by_patience(name, r.status.value, row, ref):
            fail(f"pcg {name}: {r.status.value} at {r.iterations} (best error {row['min_err']:.3e}) "
                 f"where the JAX package gives {ref['status']} at {ref['iterations']} (best error "
                 f"{ref['min_err']:.3e})")
    elif (ref["status"] != "iteration_limit"
          and abs(r.iterations - ref["iterations"]) > PCG_ITER_SLACK):
        fail(f"pcg {name}: {r.iterations} iterations against the JAX package's {ref['iterations']}")
    if ref["status"] == "optimal":
        rel = abs(r.objective - ref["objective"]) / (1.0 + abs(ref["objective"]))
        row["objective_rel_jax"] = rel
        if not rel <= PCG_OBJ_TOL:
            fail(f"pcg {name}: objective {r.objective!r} against the JAX package's "
                 f"{ref['objective']!r} ({rel:.3e} > {PCG_OBJ_TOL:.0e})")
        if p is not None:
            h = highs_objective(p)
            rel_h = abs(r.objective - h) / (1.0 + abs(h))
            row["objective_rel_highs"] = rel_h
            if not rel_h <= PCG_HIGHS_TOL:
                fail(f"pcg {name}: objective {r.objective!r} against HiGHS {h!r} ({rel_h:.3e})")
    else:
        for k in ("rel_gap", "pinf"):
            ratio = max(getattr(r, k), 1e-300) / max(ref[k], 1e-300)
            row[f"{k}_over_jax"] = ratio
            if not 1.0 / PCG_RATIO <= ratio <= PCG_RATIO:
                fail(f"pcg {name}: final {k} {getattr(r, k):.3e} against the JAX package's "
                     f"{ref[k]:.3e}")


def pcg_factor_split(torch, ne, be, card):
    """K1 f32 on the full-width path's f32 copy of A (a d spread over 8
    orders, seeded) against the exact product, and one preconditioner
    build split by CUDA events into K1, the f32 Cholesky and the explicit
    inverse. Returns (max_abs_err, rel_err, split row)."""
    from distributedlpsolver_tpu_torch.backends import dense

    A32 = be._A32
    m, n = A32.shape
    g = torch.Generator(device="cuda").manual_seed(19)
    d = (10.0 ** (8.0 * torch.rand(n, dtype=torch.float64, device="cuda", generator=g) - 4.0))
    d32 = d.to(torch.float32)
    M = ne.normal_eq(A32, d32)
    R = torch.tril(parity_reference(torch, ne, A32, d32))
    diff = torch.tril(M).double() - R
    rel, mx = (diff.norm() / R.norm()).item(), diff.abs().max().item()
    if not torch.equal(M, M.T) or not rel <= TOL["float32"]:
        fail(f"pcg K1 f32 on the path's A against the exact product: rel_err {rel:.3e} "
             f"(tol {TOL['float32']:.0e}), symmetric {torch.equal(M, M.T)}")
    exact = f32_exact_check(torch, ne, A32, d32, f"pcg path's A {m}x{n}, d over 8 orders")
    s = torch.rsqrt(M.diagonal().clamp_min(torch.finfo(torch.float32).tiny))
    Ms = M * s[:, None] * s[None, :]
    Ms.diagonal().add_(1e-8)
    L, info = torch.linalg.cholesky_ex(Ms)
    if int(info) != 0:
        fail(f"pcg: the f32 Cholesky of the scaled M failed (info {int(info)})")
    eye = torch.eye(m, dtype=torch.float32, device="cuda")
    fac, _ = dense._pcg_ops(be._A, A32, 1e-11, 100)
    split = {
        "k1_f32_ms": cuda_ms(torch, lambda: ne.normal_eq(A32, d32), 10, 2),
        "cholesky_f32_ms": cuda_ms(torch, lambda: torch.linalg.cholesky_ex(Ms), 10, 2),
        "inverse_f32_ms": cuda_ms(
            torch, lambda: torch.linalg.solve_triangular(L, eye, upper=False), 10, 2),
        "factorize_ms": cuda_ms(torch, lambda: fac(d, 1e-8), 10, 2),
    }
    del M, R, diff, Ms, L, eye
    torch.cuda.empty_cache()
    print(f"pcg factorization split {m}x{n} (K1 f32, Cholesky f32, inverse f32; the whole "
          f"factorize with its casts): " + json.dumps(split) + f" [{card}]")
    return mx, rel, split, exact


def pcg_phase(torch, ne, card):
    """The dense backend's forced-PCG schedule on the card (module note,
    step 23). Returns the kernels-line row of K1 f32 on this path."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    _T0[0] = time.perf_counter()
    # The direct path on the same problem (its second solve, warm), for ms
    # an iteration and peak memory.
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r_dir = solve(random_dense_lp(*PCG_SHAPES["full"], seed=0), backend=get_backend("cuda"),
                      tol=1e-8)
    direct = {"iterations": r_dir.iterations, "solve_s": r_dir.solve_time,
              "ms_per_iteration": 1e3 * r_dir.solve_time / max(r_dir.iterations, 1),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"pcg direct_fused {since()} " + json.dumps(direct) + f" [{card}]")

    # The full width on the captured fused loop (its 200 iterations take
    # ~25 s: its repeat, x bit for bit, runs at 512x2560 below).
    p, r, be, row = pcg_solve_counted(torch, "full_fused")
    pcg_verdict("full_fused", r, row, p)
    print(f"pcg full_fused {since()} " + json.dumps(row) + f" [{card}]")
    max_abs, rel, split, exact = pcg_factor_split(torch, ne, be, card)
    del be
    print(f"pcg full_fused against direct: ms an iteration {row['ms_per_iteration']:.3f} "
          f"vs {direct['ms_per_iteration']:.3f}, peak GB {row['peak_gb']:.3f} vs "
          f"{direct['peak_gb']:.3f}, CG live {row['cg_live_per_solve']:.2f} / masked "
          f"{row['cg_masked_per_solve']:.2f} a Newton solve, K1 f32 launches "
          f"{row['normal_eq_f32_launches']} [{card}]")

    # The loops at 512x2560 (the host loop's there cut for the script's
    # time) and all three at 60x180; then the fused one at 512x2560 again.
    for size in ("mid", "small"):
        for loop in PCG_LOOPS:
            name = f"{size}_{loop}"
            if name in PCG_CUT:
                continue
            _, r_l, _, row_l = pcg_solve_counted(torch, name)
            pcg_verdict(name, r_l, row_l)
            print(f"pcg {name} {since()} " + json.dumps(row_l) + f" [{card}]")
            if name == "mid_fused":
                r_mid = r_l
    _, r2, _, row2 = pcg_solve_counted(torch, "mid_fused")
    if r2.iterations != r_mid.iterations or not np.array_equal(np.asarray(r2.x),
                                                                np.asarray(r_mid.x)):
        fail(f"pcg mid_fused: a repeat solve gives {r2.iterations} iterations and other bits")
    print(f"pcg mid_fused_repeat {since()} x bit for bit, " + json.dumps(row2) + f" [{card}]")

    t = kernel_timing(torch, ne, *PCG_SHAPES["full"], "float32", iters=20, warm=3)
    print(f"pcg phase {since()}")
    return [{
        "name": "normal_eq (pcg, f32)",
        "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        # The full-width fused PCG solve: the starting point and one a body.
        "launches": row["normal_eq_f32_launches"],
        "max_abs_err": max_abs,
        "rel_err": rel,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_share": t["bound_share"],
        "library_ms": t["library_ms"],
        "cuda_core_bound_ms": t["cuda_core_bound_ms"],
        "cuda_core_bound_share": t["cuda_core_bound_share"],
        **exact,
        "dtype": "float32",
        "shape": t["shape"],
        "factorization_split": split,
        "ptxas": ptxas_lines(ne, "normal_eq_tf32_kernel"),
    }]


# The JAX package's verdicts for the two_phase phase's instances under its
# TPU schedule (jax.default_backend forced to "tpu", use_pallas=False) at
# tol 1e-8, max_iter 200, on the CPU (``JAX_PLATFORMS=cpu python
# scripts/port_two_phase_jax_verdicts.py``): each phase's iterations, and
# the run's best max(rel_gap, pinf, dinf) and the CPU seconds it took (8
# CPUs; "phases" is [mode, iterations] of each, None on the host loop).
TWO_PHASE_JAX = {
    "full_segmented": {"status": "optimal", "iterations": 25, "phases": [["f32", 17], ["f64", 8]],
        "objective": 15829.377320131895, "rel_gap": 2.500501569551409e-10, "pinf": 1.8246915230590684e-10,
        "min_err": 2.500501569551409e-10, "seconds": 31.0},
    "full_fused": {"status": "optimal", "iterations": 25, "phases": [["f32", 17], ["f64", 8]],
        "objective": 15829.377320028387, "rel_gap": 2.4349838913065215e-10, "pinf": 2.0664524292426392e-10,
        "min_err": 2.4349838913065215e-10, "seconds": 27.9},
    "full_host": {"status": "optimal", "iterations": 25, "phases": None,
        "objective": 15829.377320028354, "rel_gap": 2.4350103194550355e-10, "pinf": 2.0658110065054045e-10,
        "min_err": 2.4350103194550355e-10, "seconds": 38.9},
    "full_pcg": {"status": "optimal", "iterations": 34, "phases": [["f32", 17], ["pcg", 9], ["f64", 8]],
        "objective": 15829.377412651034, "rel_gap": 7.543149681374103e-09, "pinf": 3.73194663066146e-16,
        "min_err": 7.543149681374103e-09, "seconds": 97.9},
    "auto_pcg": {"status": "optimal", "iterations": 55, "phases": [["f32", 41], ["pcg", 5], ["f64", 9]],
        "objective": 17614.18318008747, "rel_gap": 8.265028292955787e-09, "pinf": 2.3475424850680472e-11,
        "min_err": 8.265028292955787e-09, "seconds": 557.3},
}
TWO_PHASE_SHAPES = {"full": (2048, 10240), "auto": (4096, 20480)}
# HiGHS's objective for random_dense_lp(2048, 10240, seed=0)
# (``python3 chip_smoke.py --highs-main``, on the CPU).
MAIN_HIGHS_OBJECTIVE = 15829.377317117824
TWO_PHASE_CASES = {
    "full_segmented": {},  # segment_iters=None: the TPU's auto, segmented
    "full_fused": {"segment_iters": 0},  # the fused two-phase program
    "full_host": {"fused_loop": False},
    "full_pcg": {"solve_mode": "pcg"},  # f32 -> PCG -> f64, always segmented
    "auto_pcg": {},  # m·n >= 2**26: solve_mode=None engages the PCG plan
}
# Cases held to the JAX package's iterations within ±2 in every phase,
# with no allowance at the f32 breakdown edge: since K1's f32 design
# (3×TF32 products, a blocked sum) the card's direct plans run the
# reference's 17 + 8 and the PCG plan 17 + 8 + 10 against 17 + 9 + 8
# (``scripts/port_two_phase_probe.py``); auto PCG at 4096×20480 keeps
# the allowance (20 + 6 + 10 against 41 + 5 + 9).
TWO_PHASE_BY_PHASE = ("full_segmented", "full_fused", "full_pcg")
TWO_PHASE_MODES = {"full_segmented": ["f32", "f64"], "full_fused": ["f32", "f64"],
                   "full_host": None, "full_pcg": ["f32", "pcg", "f64"],
                   "auto_pcg": ["f32", "pcg", "f64"]}


def two_phase_solve_counted(torch, name):
    """``solve(random_dense_lp(m, n, seed=0), backend=DenseTorchBackend(
    schedule_platform="tpu"), tol=1e-8, max_iter=200)`` on the route of
    the case ``name``, with K1's counts (all and f32) reset just before
    and read just after, and the peak device memory. Returns the problem,
    the result, the backend and the row; checks the plan's phases and
    K1's launches against them: f32 = the start (its f32 factorization or
    PCG preconditioner), the closure's G on a PCG plan, and the bodies of
    the f32 and PCG phases; f64 = the f64 phase's bodies (the host loop:
    its steps and refactorizations)."""
    from distributedlpsolver_tpu_torch.backends.dense import DenseTorchBackend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp
    from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
    from distributedlpsolver_tpu_torch.ops import normal_eq

    p = random_dense_lp(*TWO_PHASE_SHAPES[name.split("_")[0]], seed=0)
    be = DenseTorchBackend(schedule_platform="tpu")
    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        normal_eq.launches = normal_eq.launches_f32 = 0
        t0 = time.perf_counter()
        r = solve(p, backend=be, tol=1e-8, max_iter=200, **TWO_PHASE_CASES[name])
        wall = time.perf_counter() - t0
        launches, f32 = normal_eq.launches, normal_eq.launches_f32
    finally:
        obs_metrics.set_registry(prev)
    refactors = int(reg.snapshot().get("ipm_refactorizations_total", 0))
    host = name.endswith("_host")
    phases = None if host else be.phase_report
    modes = None if host else [row["mode"] for row in phases]
    if not be._two_phase or modes != TWO_PHASE_MODES[name]:
        fail(f"two_phase {name}: two-phase {be._two_phase}, phases {modes}")
    err = [max(h.rel_gap, h.pinf, h.dinf) for h in r.history]
    best = min(range(len(err)), key=err.__getitem__)
    row = {
        "case": name, "status": r.status.value, "iterations": r.iterations,
        "objective": r.objective, "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf,
        "min_err": err[best], "min_err_at": best + 1, "wall_s": wall, "setup_s": r.setup_time,
        "solve_s": r.solve_time, "ms_per_iteration": 1e3 * r.solve_time / max(r.iterations, 1),
        "normal_eq_launches": launches, "normal_eq_f32_launches": f32,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if host:
        f32_want, f64_want = 1, r.iterations + refactors
        row["refactorizations"] = refactors
    else:
        bodies = [ph["bodies"] for ph in phases]
        f32_want = 1 + int(be._pcg) + sum(bodies[:-1])
        f64_want = bodies[-1]
        row["phases"] = [{k: ph[k] for k in ("mode", "iters", "bodies", "bad_steps", "wall_s")}
                         | {"ms_per_iteration": 1e3 * ph["wall_s"] / max(ph["iters"], 1)}
                         for ph in phases]
        if sum(ph["iters"] for ph in phases) != r.iterations:
            fail(f"two_phase {name}: phase iterations {[ph['iters'] for ph in phases]} "
                 f"against {r.iterations}")
    if (f32, launches - f32) != (f32_want, f64_want):
        fail(f"two_phase {name}: K1 launches f32 {f32} / f64 {launches - f32} against "
             f"{f32_want} / {f64_want}")
    if be._pcg:
        cg = be.cg_report()
        row.update(cg, cg_live_per_solve=cg["cg_live"] / max(cg["solves"], 1),
                   cg_masked_per_solve=cg["cg_masked"] / max(cg["solves"], 1))
    return p, r, be, row


def two_phase_by_f32_edge(row, ref) -> bool:
    """Whether a two-phase solve whose iterations differ from the JAX
    package's by more than ``PCG_ITER_SLACK`` differs only before its f64
    finish, in phases that factor in f32 and met the edge of f32
    breakdown: its phases' modes are the JAX package's, its f64 finish is
    within ``PCG_ITER_SLACK`` of the JAX package's, and an earlier phase
    took bad steps (a failed f32 factorization or refinement, answered by
    raising the regularization). There the f32 phases' lengths follow the
    rounding of the f32 assembly: at 4096×20480 no assembly the probe
    tried gives the reference's 41 f32 iterations (``scripts/
    port_two_phase_probe.py``; ROADMAP Queue 3). The cases of
    ``TWO_PHASE_BY_PHASE`` never take this allowance."""
    phases, ref_phases = row.get("phases"), ref["phases"]
    if not phases or [ph["mode"] for ph in phases] != [mode for mode, _ in ref_phases or []]:
        return False
    return (phases[-1]["mode"] == "f64"
            and abs(phases[-1]["iters"] - ref_phases[-1][1]) <= PCG_ITER_SLACK
            and any(ph["bad_steps"] > 0 for ph in phases[:-1]))


def two_phase_verdict(name, r, row, card, highs=None):
    """Hold a two-phase solve to the JAX package's verdict for its case
    (:func:`_two_phase_verdict`), printing its row either way."""
    try:
        _two_phase_verdict(name, r, row, highs)
    finally:
        print(f"two_phase {name} {since()} " + json.dumps(row) + f" [{card}]")


def _two_phase_verdict(name, r, row, highs=None):
    """The same status as the JAX package's (a plateau status that differs
    only through the stall exit's patience floor passes,
    ``pcg_by_patience``); where OPTIMAL, iterations within ±2 (or a
    difference before the f64 finish alone, at the f32 breakdown edge:
    ``two_phase_by_f32_edge``; the cases of ``TWO_PHASE_BY_PHASE`` within
    ±2 in every phase, with no such allowance)
    and the objective within 1e-8 of the JAX package's and, with
    ``highs``, within 1e-6 of HiGHS; else the final rel_gap and pinf
    within a factor of 10."""
    ref = TWO_PHASE_JAX.get(name)
    if ref is None:
        fail(f"two_phase {name}: no JAX verdict recorded")
    row["jax_status"], row["jax_iterations"] = ref["status"], ref["iterations"]
    row["jax_phases"] = ref["phases"]
    if r.status.value != ref["status"]:
        if not pcg_by_patience(name, r.status.value, row, ref):
            fail(f"two_phase {name}: {r.status.value} at {r.iterations} (best error "
                 f"{row['min_err']:.3e}) where the JAX package gives {ref['status']} at "
                 f"{ref['iterations']} (best error {ref['min_err']:.3e})")
    elif name in TWO_PHASE_BY_PHASE:
        got = [[ph["mode"], ph["iters"]] for ph in row.get("phases") or []]
        if ([mode for mode, _ in got] != [mode for mode, _ in ref["phases"]]
                or any(abs(it - ref_it) > PCG_ITER_SLACK
                       for (_, it), (_, ref_it) in zip(got, ref["phases"]))):
            fail(f"two_phase {name}: phases {got} against the JAX package's {ref['phases']} "
                 f"(each within ±{PCG_ITER_SLACK})")
    elif (ref["status"] != "iteration_limit"
          and abs(r.iterations - ref["iterations"]) > PCG_ITER_SLACK):
        row["by_f32_edge"] = two_phase_by_f32_edge(row, ref)
        if not row["by_f32_edge"]:
            fail(f"two_phase {name}: {r.iterations} iterations (phases {row.get('phases')}) "
                 f"against the JAX package's {ref['iterations']} ({ref['phases']})")
    if ref["status"] == "optimal":
        rel = abs(r.objective - ref["objective"]) / (1.0 + abs(ref["objective"]))
        row["objective_rel_jax"] = rel
        if not rel <= PCG_OBJ_TOL:
            fail(f"two_phase {name}: objective {r.objective!r} against the JAX package's "
                 f"{ref['objective']!r} ({rel:.3e} > {PCG_OBJ_TOL:.0e})")
        if highs is not None:
            rel_h = abs(r.objective - highs) / (1.0 + abs(highs))
            row["objective_rel_highs"] = rel_h
            if not rel_h <= PCG_HIGHS_TOL:
                fail(f"two_phase {name}: objective {r.objective!r} against HiGHS {highs!r} "
                     f"({rel_h:.3e})")
    else:
        for k in ("rel_gap", "pinf"):
            ratio = max(getattr(r, k), 1e-300) / max(ref[k], 1e-300)
            row[f"{k}_over_jax"] = ratio
            if not 1.0 / PCG_RATIO <= ratio <= PCG_RATIO:
                fail(f"two_phase {name}: final {k} {getattr(r, k):.3e} against the JAX "
                     f"package's {ref[k]:.3e}")


def two_phase_k1_row(torch, ne, be, name, launches, extra):
    """K1 f32 on a two-phase path's f32 copy of A with a d spread over 8
    orders (seeded) against the exact product, timed at that shape; the
    kernels-line row."""
    A32 = be._A32
    m, n = A32.shape
    g = torch.Generator(device="cuda").manual_seed(20)
    d32 = (10.0 ** (8.0 * torch.rand(n, dtype=torch.float64, device="cuda", generator=g) - 4.0)
           ).to(torch.float32)
    M = ne.normal_eq(A32, d32)
    R = torch.tril(parity_reference(torch, ne, A32, d32))
    diff = torch.tril(M).double() - R
    rel, mx = (diff.norm() / R.norm()).item(), diff.abs().max().item()
    if not torch.equal(M, M.T) or not rel <= TOL["float32"]:
        fail(f"two_phase K1 f32 on the path's A ({m}x{n}) against the exact product: "
             f"rel_err {rel:.3e} (tol {TOL['float32']:.0e}), symmetric {torch.equal(M, M.T)}")
    del M, R, diff
    exact = f32_exact_check(torch, ne, A32, d32, f"two_phase path's A {m}x{n}, d over 8 orders")
    del d32
    torch.cuda.empty_cache()
    Am, dm = make_inputs(torch, m, n, torch.float32, 1)
    exact_inputs = f32_exact_check(torch, ne, Am, dm, f"make_inputs {m}x{n}")
    del Am, dm
    t = kernel_timing(torch, ne, m, n, "float32", iters=20, warm=3)
    return {
        "name": name, "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        "launches": launches, "max_abs_err": mx, "rel_err": rel,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
                             "library_ms", "cuda_core_bound_ms", "cuda_core_bound_share", "shape")},
        **exact, "make_inputs": exact_inputs,
        "dtype": "float32", "ptxas": ptxas_lines(ne, "normal_eq_tf32_kernel"), **extra,
    }


def highs_main() -> int:
    """The body of ``--highs-main`` (no card needed): HiGHS's objective
    for the main path's problem, ``random_dense_lp(2048, 10240, seed=0)``,
    on the last line of standard output, which ``MAIN_HIGHS_OBJECTIVE``
    pastes. Its interior point method (``highs-ipm``) at feasibility
    tolerances of 1e-10; either method takes minutes there, too long for
    this script's limit."""
    import scipy.optimize as sopt

    from distributedlpsolver_tpu_torch.models import random_dense_lp

    p = random_dense_lp(*TWO_PHASE_SHAPES["full"], seed=0)
    t0 = time.perf_counter()
    h = sopt.linprog(p.c, A_eq=p.A, b_eq=p.rlb, bounds=(0, None), method="highs-ipm",
                     options={"primal_feasibility_tolerance": 1e-10,
                              "dual_feasibility_tolerance": 1e-10})
    print(json.dumps({"status": int(h.status), "message": h.message, "objective": h.fun,
                      "seconds": time.perf_counter() - t0}))
    return 0


def two_phase_phase(torch, ne, card, shared=None):
    """The dense backend's two-phase schedule under
    ``schedule_platform="tpu"`` on the card (module note, step 24).
    Returns the kernels-line rows of K1 on this path; in a whole run
    ``shared["two_phase"]`` keeps its PCG plans' answers, which step 25
    holds the sharded backend to."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    _T0[0] = time.perf_counter()
    # The direct path on the same problem (its second solve, warm), for ms
    # an iteration.
    for _ in range(2):
        r_dir = solve(random_dense_lp(*TWO_PHASE_SHAPES["full"], seed=0),
                      backend=get_backend("cuda"), tol=1e-8)
    direct_ms = 1e3 * r_dir.solve_time / max(r_dir.iterations, 1)
    print(f"two_phase direct_fused {since()} {r_dir.iterations} it, {direct_ms:.3f} ms an "
          f"iteration (warm) [{card}]")
    highs = MAIN_HIGHS_OBJECTIVE

    rows = {}
    for name in ("full_segmented", "full_fused", "full_host"):
        _, r, be, row = two_phase_solve_counted(torch, name)
        two_phase_verdict(name, r, row, card, highs)
        rows[name] = (r, be, row)
    # The fused two-phase program again (warm): the same bits.
    _, r2, _, row2 = two_phase_solve_counted(torch, "full_fused")
    r1 = rows["full_fused"][0]
    if r2.iterations != r1.iterations or not np.array_equal(np.asarray(r2.x), np.asarray(r1.x)):
        fail("two_phase full_fused: a repeat solve gives other iterations or bits")
    print(f"two_phase full_fused_repeat {since()} x bit for bit, " + json.dumps(row2) + f" [{card}]")
    print("two_phase ms an iteration by phase (the warm fused program): "
          + ", ".join(f"{ph['mode']} {ph['ms_per_iteration']:.3f} ({ph['iters']} it)"
                      for ph in row2["phases"])
          + f"; the direct path {direct_ms:.3f} [{card}]")
    _, be_seg, row_seg = rows["full_segmented"]
    k1_rows = [two_phase_k1_row(torch, ne, be_seg, "normal_eq (two-phase, f32)",
                                row_seg["normal_eq_f32_launches"], {
        "f64_launches": row_seg["normal_eq_launches"] - row_seg["normal_eq_f32_launches"],
        "launches_by_route": {n: rows[n][2]["normal_eq_f32_launches"] for n in rows},
    })]
    del rows, be_seg

    # The PCG plan at the same shape: does its f64 finish reach OPTIMAL
    # where the forced PCG of the card's schedule stalls (step 23)?
    _, r, be, row = two_phase_solve_counted(torch, "full_pcg")
    two_phase_verdict("full_pcg", r, row, card, highs)
    k1_rows[0]["launches_by_route"]["full_pcg"] = row["normal_eq_f32_launches"]
    del be
    dense_pcg = {"full_pcg": (r, row)}
    print(f"two_phase full_pcg: {r.status.value} at {r.iterations} (phases "
          f"{[(ph['mode'], ph['iters']) for ph in row['phases']]}), the PCG phase's CG live "
          f"{row['cg_live_per_solve']:.2f} / masked {row['cg_masked_per_solve']:.2f} a Newton "
          f"solve; the forced PCG of step 23 ends {PCG_JAX['full_fused']['status']} in the JAX "
          f"package and STALLED at 35 on the card [{card}]")

    # Auto PCG at the smallest class that engages it (2**26 <= m·n < 2**28).
    _, r, be, row = two_phase_solve_counted(torch, "auto_pcg")
    if not be._pcg:
        fail("two_phase auto_pcg: solve_mode=None did not engage PCG")
    two_phase_verdict("auto_pcg", r, row, card)
    dense_pcg["auto_pcg"] = (r, row)
    if shared is not None:
        shared["two_phase"] = dense_pcg
    m, n = TWO_PHASE_SHAPES["auto"]
    rel64, mx64 = kernel_parity(torch, ne, m, n, "float64")
    t64 = kernel_timing(torch, ne, m, n, "float64", iters=10, warm=2)
    f64_launches = row["normal_eq_launches"] - row["normal_eq_f32_launches"]
    k1_rows.append(two_phase_k1_row(torch, ne, be, "normal_eq (two-phase auto PCG, f32)",
                                    row["normal_eq_f32_launches"], {"f64_launches": f64_launches}))
    del be
    k1_rows.append({
        "name": "normal_eq (two-phase auto PCG, f64 finish)", "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        "launches": f64_launches, "max_abs_err": mx64, "rel_err": rel64,
        **{k: t64[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
                               "library_ms", "shape")},
        "dtype": "float64",
    })
    torch.cuda.empty_cache()
    print(f"two_phase phase {since()}")
    return k1_rows


# -- the sharded backend's PCG (item 5b-1) --------------------------------------------

# The JAX package's verdicts for the sharded PCG step's forced instances:
# its sharded backend on a mesh of 8 virtual CPU devices, L⁻¹ column-split
# (``python scripts/port_sharded_pcg_jax_verdicts.py``, ~35 s on 8 CPUs),
# at tol 1e-8 and max_iter 200: the reference's own mesh instances
# (tests/test_dist_chol.py, tests/test_pcg.py) on each loop.
SHARDED_PCG_JAX = {
    "48x120s11_fused": {"status": "optimal", "iterations": 12, "objective": 82.99564417333492,
        "rel_gap": 5.126401959311193e-10, "pinf": 1.5720575122748864e-16},
    "48x120s11_host": {"status": "optimal", "iterations": 12, "objective": 82.99564417333492,
        "rel_gap": 5.126401959311193e-10, "pinf": 1.5720575122748864e-16},
    "48x120s11_segmented": {"status": "optimal", "iterations": 12, "objective": 82.99564417333491,
        "rel_gap": 5.126401959311193e-10, "pinf": 2.2784636288933935e-16},
    "48x128s4_fused": {"status": "optimal", "iterations": 14, "objective": 56.1648194546346,
        "rel_gap": 3.195948413302101e-10, "pinf": 2.133617629902021e-14},
    "48x128s4_host": {"status": "optimal", "iterations": 14, "objective": 56.1648194546346,
        "rel_gap": 3.1959496562741646e-10, "pinf": 2.133617629902021e-14},
    "48x128s4_segmented": {"status": "optimal", "iterations": 14, "objective": 56.16481945463833,
        "rel_gap": 3.196613403355668e-10, "pinf": 5.4254020958475545e-16},
    "64x160s9_fused": {"status": "optimal", "iterations": 16, "objective": 145.7187344243081,
        "rel_gap": 3.049126350264614e-10, "pinf": 7.213561867487075e-15},
    "64x160s9_host": {"status": "optimal", "iterations": 16, "objective": 145.7187344243081,
        "rel_gap": 3.049126350264614e-10, "pinf": 7.213561867487075e-15},
    "64x160s9_segmented": {"status": "optimal", "iterations": 16, "objective": 145.7187344243073,
        "rel_gap": 3.0490701727371516e-10, "pinf": 2.5213317355897056e-16},
}
SHARDED_PCG_INSTANCES = {"48x120s11": (48, 120, 11), "48x128s4": (48, 128, 4),
                         "64x160s9": (64, 160, 9)}
SHARDED_PCG_LOOPS = {"fused": {}, "host": {"fused_loop": False},
                     "segmented": {"segment_iters": 2}}
SHARDED_PCG_WORLD_TIMEOUT_S = 300.0


@contextlib.contextmanager
def loop_memory(torch):
    """Records every run of a fused loop: its graph pool's bytes, whether
    it was captured when the run began, and the card's reserved bytes
    before and after the run."""
    from distributedlpsolver_tpu_torch.ipm import device_loop

    log, real = [], device_loop.DeviceLoop.run

    def run(self, *args, **kw):
        captured, before = self.captures > 0, torch.cuda.memory_reserved()
        out = real(self, *args, **kw)
        log.append((id(self), captured, self.pool_bytes, before, torch.cuda.memory_reserved()))
        return out

    device_loop.DeviceLoop.run = run
    try:
        yield log
    finally:
        device_loop.DeviceLoop.run = real


# What a run of replays alone may add to the card's reserved bytes: one
# segment of the caching allocator's small pool (the phase plan's scalars
# between segments); a replay itself allocates nothing.
REPLAY_RESERVED_SLACK = 2 << 20


def pool_report(name, log) -> dict:
    """Each loop's graph pool and the card's reserved bytes over its runs
    of replays alone (the runs after its capture); fails if those runs
    added more than ``REPLAY_RESERVED_SLACK``."""
    loops = {}
    for key, captured, pool, before, after in log:
        loops.setdefault(key, []).append((captured, pool, before, after))
    out = []
    for runs in loops.values():
        replays = [(before, after) for captured, _, before, after in runs if captured]
        grown = (replays[-1][1] - replays[0][0]) if replays else 0
        if grown > REPLAY_RESERVED_SLACK:
            fail(f"{name}: the card's reserved bytes grew by {grown} B over a captured loop's "
                 f"replays")
        out.append({"runs": len(runs), "replay_runs": len(replays), "pool_bytes": runs[-1][1],
                    "reserved_growth_over_replays": grown})
    return {"loops": out}


def sharded_pcg_solve(torch, name, p, be, **kw):
    """``solve(p, backend=be, tol=1e-8, max_iter=200, **kw)`` on the
    sharded backend ``be`` with K1's counts (all and f32) reset just before
    and read just after, the peak device memory, the CG tally and each
    loop's graph pool. Returns the result and its row. Checks K1's
    launches against the plan: a two-phase plan f32 = the start, the
    closure's G and the f32 and PCG bodies, f64 = the f64 phase's bodies;
    forced PCG f32 = the start + the bodies (+ G on the segmented loop),
    the host loop the start + its steps and refactorizations."""
    import hashlib

    import numpy as np

    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
    from distributedlpsolver_tpu_torch.ops import normal_eq

    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        with loop_memory(torch) as log:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            normal_eq.launches = normal_eq.launches_f32 = 0
            t0 = time.perf_counter()
            r = solve(p, backend=be, tol=1e-8, max_iter=200, **kw)
            wall = time.perf_counter() - t0
            launches, f32 = normal_eq.launches, normal_eq.launches_f32
    finally:
        obs_metrics.set_registry(prev)
    refactors = int(reg.snapshot().get("ipm_refactorizations_total", 0))
    if not be._pcg:
        fail(f"sharded_pcg {name}: the backend did not engage PCG")
    cg = be.cg_report()
    row = {
        "case": name, "status": r.status.value, "iterations": r.iterations,
        "objective": r.objective, "rel_gap": r.rel_gap, "pinf": r.pinf, "dinf": r.dinf,
        "wall_s": wall, "setup_s": r.setup_time, "solve_s": r.solve_time,
        "ms_per_iteration": 1e3 * r.solve_time / max(r.iterations, 1),
        "normal_eq_launches": launches, "normal_eq_f32_launches": f32,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **cg,
        "cg_live_per_solve": cg["cg_live"] / max(cg["solves"], 1),
        "cg_masked_per_solve": cg["cg_masked"] / max(cg["solves"], 1),
        "x_sha256": hashlib.sha256(np.asarray(r.x).tobytes()).hexdigest(),
        "mesh": repr(be.mesh), "prec_sharding": [be.prec_sharding().axis, be.prec_sharding().dim],
        "memory": pool_report(f"sharded_pcg {name}", log),
    }
    closure = int(be._closure is not None)
    if kw.get("fused_loop") is False:
        f32_want, f64_want = 1 + r.iterations + refactors, 0
        row["refactorizations"] = refactors
    else:
        phases = be.phase_report
        bodies = [ph["bodies"] for ph in phases]
        if be._two_phase:
            f32_want, f64_want = 1 + closure + sum(bodies[:-1]), bodies[-1]
        else:
            f32_want, f64_want = 1 + closure + sum(bodies), 0
        row["phases"] = [{k: ph.get(k) for k in ("mode", "iters", "bodies", "bad_steps", "wall_s",
                                                 "captured", "capture_off_reason")}
                         | {"ms_per_iteration": 1e3 * ph["wall_s"] / max(ph["iters"], 1)}
                         for ph in phases]
        if sum(ph["iters"] for ph in phases) != r.iterations:
            fail(f"sharded_pcg {name}: phase iterations {[ph['iters'] for ph in phases]} "
                 f"against {r.iterations}")
    if (f32, launches - f32) != (f32_want, f64_want):
        fail(f"sharded_pcg {name}: K1 launches f32 {f32} / f64 {launches - f32} against "
             f"{f32_want} / {f64_want}")
    return r, row


def sharded_pcg_by_phase(name, row, ref, f32_edge=False):
    """The same status as ``ref`` (a dense answer's row on the card); its
    phases' modes, each phase's iterations within ±``PCG_ITER_SLACK``
    (with ``f32_edge``, or a difference before the f64 finish alone where
    an f32-factored phase took bad steps: ``two_phase_by_f32_edge``, the
    allowance step 24 gives the same problem against the reference), and,
    where OPTIMAL, the objective within ``PCG_OBJ_TOL``."""
    got = [[ph["mode"], ph["iters"]] for ph in row.get("phases") or []]
    want = [[ph["mode"], ph["iters"]] for ph in ref.get("phases") or []]
    row["against"] = {"status": ref["status"], "phases": want, "objective": ref["objective"]}
    if row["status"] != ref["status"]:
        fail(f"sharded_pcg {name}: {row['status']} at {row['iterations']} against "
             f"{ref['status']} at {ref['iterations']}")
    if ([mode for mode, _ in got] != [mode for mode, _ in want]
            or any(abs(it - ref_it) > PCG_ITER_SLACK for (_, it), (_, ref_it) in zip(got, want))):
        row["by_f32_edge"] = f32_edge and two_phase_by_f32_edge(row, {"phases": want})
        if not row["by_f32_edge"]:
            fail(f"sharded_pcg {name}: phases {got} against {want} (each within "
                 f"±{PCG_ITER_SLACK}; bad steps {[ph.get('bad_steps') for ph in row['phases']]})")
        print(f"sharded_pcg_note {name}: phases {got} against {want}: the f64 finish within "
              f"±{PCG_ITER_SLACK}, the f32 phase at the edge of f32 breakdown (bad steps "
              f"{[ph['bad_steps'] for ph in row['phases']]})")
    if ref["status"] == "optimal":
        rel = abs(row["objective"] - ref["objective"]) / (1.0 + abs(ref["objective"]))
        row["objective_rel"] = rel
        if not rel <= PCG_OBJ_TOL:
            fail(f"sharded_pcg {name}: objective {row['objective']!r} against "
                 f"{ref['objective']!r} ({rel:.3e} > {PCG_OBJ_TOL:.0e})")


def sharded_pcg_jax_verdict(name, row):
    """The JAX package's verdict on its mesh of 8 (``SHARDED_PCG_JAX``):
    the same status, iterations within ±``PCG_ITER_SLACK``, the objective
    within ``PCG_OBJ_TOL``."""
    ref = SHARDED_PCG_JAX[name]
    row["jax_status"], row["jax_iterations"] = ref["status"], ref["iterations"]
    rel = abs(row["objective"] - ref["objective"]) / (1.0 + abs(ref["objective"]))
    row["objective_rel_jax"] = rel
    if (row["status"] != ref["status"]
            or abs(row["iterations"] - ref["iterations"]) > PCG_ITER_SLACK
            or not rel <= PCG_OBJ_TOL):
        fail(f"sharded_pcg {name}: {row['status']} at {row['iterations']}, objective "
             f"{row['objective']!r}, against the JAX package's {ref['status']} at "
             f"{ref['iterations']}, {ref['objective']!r} ({rel:.3e})")


def pcg_stage_parts(rep, wall_ms, iterations) -> dict:
    """Per-iteration ms of a clocked PCG step's parts (the stage clock's
    spans, ``backends/sharded.py``): K1 on the blocks, the sum of M, the
    panel factorization and inverse and their sums, the rest of the
    factorization (scaling, casts), CG less its sums, the operator's and
    the slabs' sums in CG, the step's own products' sums, and the rest."""
    ms = rep["ms"]
    g = lambda k: ms.get(k, 0.0)  # noqa: E731
    per = lambda v: v / max(iterations, 1)  # noqa: E731
    return {
        "iterations": iterations, "k1_ms": per(g("k1")), "allreduce_M_ms": per(g("allreduce_M")),
        "panels_ms": per(g("chol_inv") - g("allreduce_panel")),
        "allreduce_panel_ms": per(g("allreduce_panel")),
        "factorize_rest_ms": per(g("factorize") - g("k1") - g("allreduce_M") - g("chol_inv")),
        "cg_ms": per(g("pcg_solve") - g("allreduce_cg") - g("allreduce_prec")),
        "allreduce_cg_ms": per(g("allreduce_cg")), "allreduce_prec_ms": per(g("allreduce_prec")),
        "allreduce_vec_ms": per(g("allreduce_vec")),
        "rest_ms": per(wall_ms - g("factorize") - g("pcg_solve") - g("allreduce_vec")),
        "wall_ms": per(wall_ms), "calls": rep["calls"],
    }


def sharded_pcg_gloo_cases() -> list:
    """(d)'s cases on a gloo world of 2 sharing the card: the main path's
    problem under the three-phase plan, and a reference mesh instance
    forced."""
    return [
        dict(tag="sharded pcg 2048x10240", case={
            **SHARDED_MAIN, "tol": 1e-8, "max_iter": 200, "solve_mode": "pcg",
            "schedule_platform": "tpu", "return_xy": True}),
        dict(tag="sharded pcg 48x120s11", case={
            "m": 48, "n": 120, "seed": 11, "tol": 1e-8, "max_iter": 200, "solve_mode": "pcg"}),
    ]


def sharded_pcg_nccl_legs(torch, ne, card, refs) -> dict:
    """(a)–(c) of the sharded PCG step on the NCCL world of one this
    process has joined, and (b)'s local mesh of one on ``cuda:0``;
    ``refs`` are the card's dense answers (step 24's ``full_pcg`` and
    ``auto_pcg`` rows). Returns what the step's rows and (d) need."""
    import numpy as np

    from distributedlpsolver_tpu_torch.backends.sharded import ShardedTorchBackend
    from distributedlpsolver_tpu_torch.models import random_dense_lp
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    t_legs = time.perf_counter()
    out = {}
    # (a) The reference's automatic PCG at full width, on the segmented
    # route with the closure in every phase.
    p_a = random_dense_lp(*TWO_PHASE_SHAPES["auto"], seed=0)
    be = ShardedTorchBackend(schedule_platform="tpu")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("sharded_pcg: TF32 is on for the f32 products")
    r, row = sharded_pcg_solve(torch, "auto_pcg_nccl1", p_a, be)
    if [ph["mode"] for ph in row["phases"]] != ["f32", "pcg", "f64"] or be._closure is None:
        fail(f"sharded_pcg auto_pcg: phases {row['phases']}, closure {be._closure is not None}")
    if be.mesh.pg_backend != "nccl" or not all(ph["captured"] for ph in row["phases"]):
        fail(f"sharded_pcg auto_pcg: mesh {be.mesh}, phases {row['phases']}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("sharded_pcg: TF32 was on after the PCG solve")
    ref = refs["auto_pcg"][1]
    try:
        sharded_pcg_by_phase("auto_pcg_nccl1", row, ref, f32_edge=True)
    finally:
        print(f"sharded_pcg auto_pcg_nccl1 row {since()} " + json.dumps(row) + f" [{card}]")
    row.update(sharded_answer_check("sharded_pcg auto_pcg", p_a, r.x, r.y, r.rel_gap))
    print("sharded_pcg auto_pcg ms an iteration by phase (sharded / dense): "
          + ", ".join(f"{a['mode']} {a['ms_per_iteration']:.3f} / {b['ms_per_iteration']:.3f} "
                      f"({a['iters']} / {b['iters']} it)"
                      for a, b in zip(row["phases"], ref["phases"]))
          + f"; PCG CG live {row['cg_live_per_solve']:.2f} / masked "
          f"{row['cg_masked_per_solve']:.2f} a Newton solve (dense {ref['cg_live_per_solve']:.2f}"
          f" / {ref['cg_masked_per_solve']:.2f}); peak GB {row['peak_gb']:.3f} (dense "
          f"{ref['peak_gb']:.3f}) [{card}]")
    parts = clocked_steps(torch, be, parts=pcg_stage_parts)
    print(f"sharded_pcg auto_pcg_parts {since()} " + json.dumps(parts) + f" [{card}]")
    out["a"] = dict(row=row, parts=parts, k1=two_phase_k1_row(
        torch, ne, be, "normal_eq (sharded pcg, f32, 4096x20480)",
        row["normal_eq_f32_launches"], {
            "launches_path": "sharded auto PCG, NCCL world of one, 4096x20480",
            "f64_launches": row["normal_eq_launches"] - row["normal_eq_f32_launches"]}))
    del r, be, p_a
    torch.cuda.empty_cache()

    # (b) The three-phase plan at the main path's problem on the world of
    # one and on a local mesh of one: the same code, bit for bit.
    p_b = random_dense_lp(*TWO_PHASE_SHAPES["full"], seed=0)
    b = {}
    for tag, mesh in (("nccl1", None),
                      ("local1", mesh_lib.make_mesh(axis_names=("cols",), devices=["cuda:0"]))):
        be = ShardedTorchBackend(mesh=mesh, schedule_platform="tpu")
        r, row = sharded_pcg_solve(torch, f"full_pcg_{tag}", p_b, be, solve_mode="pcg")
        try:
            if not all(ph["captured"] for ph in row["phases"]):
                fail(f"sharded_pcg full_pcg_{tag}: a phase ran uncaptured: {row['phases']}")
            sharded_pcg_by_phase(f"full_pcg_{tag}", row, refs["full_pcg"][1])
            row.update(sharded_answer_check(f"sharded_pcg full_pcg_{tag}", p_b, r.x, r.y,
                                            r.rel_gap))
        finally:
            print(f"sharded_pcg full_pcg_{tag} {since()} " + json.dumps(row) + f" [{card}]")
        if tag == "nccl1":
            # Rank 0's block of a world of 2: K1's f32 shape on (d)'s ranks.
            half = be._A32.shape[1] // 2
            out["block32"] = be._A32[:, :half].contiguous()
        b[tag] = (r, row)
        del be
    (rn, row_n), (rl, row_l) = b["nccl1"], b["local1"]
    if rn.iterations != rl.iterations or not np.array_equal(np.asarray(rn.x), np.asarray(rl.x)):
        fail("sharded_pcg full_pcg: the NCCL world of one and the local mesh of one differ")
    pools = lambda row: [lp["pool_bytes"] for lp in row["memory"]["loops"]]  # noqa: E731
    if pools(row_n) != pools(row_l):
        fail(f"sharded_pcg full_pcg: graph pools {pools(row_n)} against {pools(row_l)}")
    print(f"sharded_pcg full_pcg {since()} NCCL world of one and local mesh of one: x bit for "
          f"bit, {rn.iterations} iterations, graph pools {pools(row_n)} B [{card}]")
    out["b"] = dict(r=rn, row=row_n, local=row_l)
    del p_b, b, rl
    torch.cuda.empty_cache()

    # (c) Forced PCG at the reference's own mesh instances, each loop.
    out["c"] = {}
    for inst, (m, n, seed) in SHARDED_PCG_INSTANCES.items():
        for loop, kw in SHARDED_PCG_LOOPS.items():
            name = f"{inst}_{loop}"
            be = ShardedTorchBackend()
            r, row = sharded_pcg_solve(torch, name, random_dense_lp(m, n, seed=seed), be,
                                       solve_mode="pcg", **kw)
            if loop != "host" and not all(ph["captured"] for ph in row["phases"]):
                fail(f"sharded_pcg {name}: a phase ran uncaptured")
            if (be._closure is not None) != (loop == "segmented"):
                fail(f"sharded_pcg {name}: closure {be._closure is not None} on this route")
            sharded_pcg_jax_verdict(name, row)
            out["c"][name] = row
    print(f"sharded_pcg reference instances {since()} "
          + json.dumps({k: [v["status"], v["iterations"], v["jax_iterations"],
                            v["objective_rel_jax"], v["cg_live_per_solve"],
                            v["cg_masked_per_solve"]] for k, v in out["c"].items()})
          + f" [{card}]")
    out["seconds"] = time.perf_counter() - t_legs
    return out


def sharded_pcg_gloo_check(cases, ref_b, card) -> dict:
    """(d): every rank of the gloo world of 2 the same x bits; the main
    path's case within ±2 a phase and 1e-8 of (b)'s answer, its answer held
    to its problem; the forced instance to the JAX package's verdict; each
    rank's block and K1 f32 launches."""
    from distributedlpsolver_tpu_torch.models import random_dense_lp

    out = {}
    for e in cases:
        outs, wall = e["gloo2"]
        name = e["tag"]
        if len({o["x_sha256"] for o in outs}) != 1:
            fail(f"{name}: the gloo ranks' x bits differ")
        rows = []
        for o in outs:
            row = {"case": name, "status": o["status"], "iterations": o["iterations"],
                   "objective": o["objective"],
                   "phases": [{"mode": ph["mode"], "iters": ph["iters"]}
                              for ph in o["phase_report"] or []]}
            if o["phase_report"] and o["phase_report"][0].get("captured") is not False:
                fail(f"{name}: rank {o['rank']} captured a gloo loop")
            if "2048x10240" in name:
                sharded_pcg_by_phase(f"{name} rank {o['rank']}", row, ref_b)
                p = random_dense_lp(SHARDED_MAIN["m"], SHARDED_MAIN["n"], seed=SHARDED_MAIN["seed"])
                row.update(sharded_answer_check(f"{name} rank {o['rank']}", p, o.pop("x"),
                                                o.pop("y"), o["rel_gap"]))
                want = [SHARDED_MAIN["m"], SHARDED_MAIN["n"] // 2]
            else:
                sharded_pcg_jax_verdict("48x120s11_fused", row)
                want = [48, 60]
            if o["shard_shape"] != want or o["k1_launches_f32"] <= 0:
                fail(f"{name}: rank {o['rank']} block {o['shard_shape']}, K1 f32 launches "
                     f"{o['k1_launches_f32']}")
            row.update(rank=o["rank"], k1_launches_f32=o["k1_launches_f32"],
                       cg_report=o["cg_report"], solve_s=o["solve_s"])
            rows.append(row)
        out[name] = dict(rows=rows, wall_s=wall)
        print(f"sharded_pcg gloo2 {since()} {name}: every rank the same x bits "
              + json.dumps(rows) + f", world wall {wall:.1f} s [{card}]")
    return out


def sharded_pcg_rows(torch, ne, card, legs, gloo) -> list:
    """The kernels-line rows of K1 f32 on the sharded PCG path: a gloo
    rank's block of the main path's problem (2048 × 5,120; the world of 2's
    launches, every rank) and the full width's (4096 × 20,480, the NCCL
    world of one's)."""
    import types

    case = gloo["sharded pcg 2048x10240"]["rows"]
    row = two_phase_k1_row(
        torch, ne, types.SimpleNamespace(_A32=legs.pop("block32")),
        "normal_eq (sharded pcg, f32, 2048x5120)", sum(r["k1_launches_f32"] for r in case), {
            "launches_path": "sharded three-phase PCG plan, gloo world of 2 on one card "
                             "(all ranks), 2048x10240",
            "launches_nccl_world_of_one_whole_a": legs["b"]["row"]["normal_eq_f32_launches"]})
    torch.cuda.empty_cache()
    return [row, legs["a"]["k1"]]


def sharded_pcg_phase(torch, ne, card, refs=None):
    """The sharded backend's PCG on the card, run alone (module note,
    step 25): the card's dense answers first (``refs``: step 24's rows in a
    whole run), an NCCL world of one formed here, then (d) on a gloo world
    of 2. Returns the kernels-line rows."""
    from distributedlpsolver_tpu_torch.distributed import world as world_lib
    from distributedlpsolver_tpu_torch.distributed.launcher import free_port

    _T0[0] = time.perf_counter()
    if refs is None:
        refs = {}
        for name in ("full_pcg", "auto_pcg"):
            _, r, be, row = two_phase_solve_counted(torch, name)
            refs[name] = (r, row)
            print(f"sharded_pcg dense {name} {since()} " + json.dumps(row) + f" [{card}]")
            del be
        torch.cuda.empty_cache()
    world = world_lib.init_world(world_lib.WorldConfig(
        coordinator=f"127.0.0.1:{free_port()}", rank=0, world_size=1, device="cuda"))
    try:
        if world.pg_backend != "nccl":
            fail(f"the world of one runs {world.pg_backend}, not nccl")
        legs = sharded_pcg_nccl_legs(torch, ne, card, refs)
    finally:
        world.close()
    cases = sharded_pcg_gloo_cases()
    side_world(cases, "sharded_pcg_gloo2")
    gloo = sharded_pcg_gloo_check(cases, legs["b"]["row"], card)
    rows = sharded_pcg_rows(torch, ne, card, legs, gloo)
    print(f"sharded_pcg phase {since()}")
    return rows


def main(only: str = "") -> int:
    """The whole run, or with ``only`` ("pcg", "two_phase", "sparse",
    "plane", "block", "scenario", "sharded", "slice", "rows" or
    "sharded_pcg") the build and that phase alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script needs one card", file=sys.stderr)
        return 2
    from distributedlpsolver_tpu_torch.ops import kernel_build
    # The module (the package's ``ops.normal_eq`` attribute is the function).
    ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")

    torch.backends.cuda.matmul.allow_tf32 = False  # library matmuls in true fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch.cuda.get_device_name(0) = {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. Build every kernel from the checkout's sources: one nvcc per
    # source, all started together, and the static-analysis gate beside
    # them (host only: it touches no device; awaited before the first
    # timed step).
    es = importlib.import_module("distributedlpsolver_tpu_torch.ops.ell_spmv")
    gate = start_graftcheck()
    t0 = time.perf_counter()
    kernel_build.build(ne.build_job(), es.build_job())
    ne.load_library()
    es.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc in parallel: normal_eq "
          f"{ne.build_info.get('seconds', 0.0):.2f} s, ell_spmv {es.build_info.get('seconds', 0.0):.2f} s)")
    for mod in (ne, es):
        print(f"  {mod.build_info['path']}")
        for ln in mod.build_info.get("ptxas", []):
            print(f"  {ln}")
    if only:
        finish_graftcheck(*gate)
    # Step 9's CLI leg, a fresh process, runs beside the gate.
    serve_cli = None if only else start_cli_serve()

    # What a later phase takes from an earlier one in a whole run: the solo
    # PDHG answer (pdlp's mesh=None), the sparse phase's full-shape and
    # acceptance solves (the rows phase's mesh=None answers), the block
    # phase's pds-10 and the scenario main path (cases of the sharded and
    # slice phases' gloo worlds).
    shared = {}
    rows = [] if only else dense_phases(torch, ne, card, shared, gate, serve_cli)
    # 23. The dense backend's forced-PCG schedule.
    if only in ("", "pcg"):
        rows += pcg_phase(torch, ne, card)
    # 24. The dense backend's two-phase schedule (the reference's TPU one).
    if only in ("", "two_phase"):
        rows += two_phase_phase(torch, ne, card, shared)
    if not only:  # HiGHS for the sparse phase, beside the plane's processes
        shared["highs"] = start_highs_storm20k()
    # 17. The network plane: its launches go to the serve bucket's K1 row,
    # which a --plane-only run times on its own.
    if only in ("", "plane"):
        launches = plane_phase(torch, ne, card, None if only else shared)
        if only == "plane":
            rows.append(serve_bucket_row(
                kernel_parity(torch, ne, BM, BN, "float64", batch=SERVE_BATCH),
                kernel_timing(torch, ne, BM, BN, "float64", iters=20, warm=3, batch=SERVE_BATCH), 0))
        row = next(r for r in rows if r["name"] == "normal_eq (serve bucket)")
        row["launches"] += launches
        row["plane_launches"] = launches
    # 16. The matrix-free sparse tier.
    if only in ("", "sparse"):
        rows += sparse_phase(torch, card, shared)
    # 18. The block-angular tier.
    if only in ("", "block"):
        rows += block_phase(torch, ne, card, shared, defer=not only)
    # 19. The stochastic scenario tier.
    if only in ("", "scenario"):
        rows += scenario_phase(torch, ne, card, shared, defer=not only)
    # 20. The column-sharded dense backend.
    if only in ("", "sharded"):
        rows += sharded_phase(torch, ne, card, shared)
    # 21. The serving slice and the elastic shrink.
    if only in ("", "slice"):
        rows += slice_phase(torch, ne, card, shared)
    # 22. The row-sharded matrix-free tier.
    if only in ("", "rows"):
        rows += rows_phase(torch, ne, card, shared)
    # 25. The sharded backend's PCG: in a whole run legs of step 20's worlds.
    if only == "sharded_pcg":
        rows += sharded_pcg_phase(torch, ne, card)
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def dense_phases(torch, ne, card, shared, gate, serve_cli):
    """Steps 1 (the SASS count) to 14 of the module note; returns the K1
    rows of the kernels line and leaves the solo PDHG answer in
    ``shared["pdlp"]``."""
    from distributedlpsolver_tpu_torch import cli
    from distributedlpsolver_tpu_torch.io import read_mps

    _T0[0] = time.perf_counter()
    steps = {}  # seconds into the phase at the end of each step

    def mark(step):
        steps[step] = round(time.perf_counter() - _T0[0], 1)

    sass = sass_counts(ne)
    dmma = sass["dmma"]
    print(f"sass: {dmma} DMMA instructions in normal_eq_dmma_kernel (f64), "
          f"{sass['hmma_tf32']} HMMA TF32 in normal_eq_tf32_kernel (f32)")
    if dmma <= 0 or sass["hmma_tf32"] <= 0:
        fail(f"a K1 kernel's SASS holds no tensor-core instruction: {sass}")

    # 2. Parity on the card.
    parity = {}
    for dt in ("float64", "float32", "bfloat16"):
        past_edge = 2 * ne.tile_edge(getattr(torch, dt)) + 1  # one row past two tiles
        for (m, n) in [(2048, 10240), (1000, 3001), (past_edge, 515)]:
            parity[f"{dt}_{m}x{n}"] = kernel_parity(torch, ne, m, n, dt)
    parity["float64_10000x50000"] = kernel_parity(torch, ne, 10000, 50000, "float64")
    for k, (rel, mx) in parity.items():
        print(f"parity normal_eq {k}: rel_err {rel:.3e} max_abs_err {mx:.3e} (tol {TOL[k.split('_')[0]]:.0e}), "
              "M = Mᵀ bitwise, two launches bitwise equal")
    finish_graftcheck(*gate)  # before the first timed step
    finish_cli_serve(*serve_cli)
    mark("2 parity, graftcheck")

    # 3. Timing (card and power limit printed above and below).
    timings = [
        kernel_timing(torch, ne, 2048, 10240, "float64", iters=20, warm=3),
        kernel_timing(torch, ne, 2048, 10240, "float32", iters=20, warm=3),
        kernel_timing(torch, ne, 2048, 10240, "bfloat16", iters=20, warm=3),
        kernel_timing(torch, ne, 10000, 50000, "float64", iters=3, warm=1),
    ]
    for t in timings:
        tc = (f", CUDA-core bound {t['cuda_core_bound_ms']:.3f} ms, share "
              f"{t['cuda_core_bound_share']:.3f}" if "cuda_core_bound_ms" in t else "")
        print(f"timing normal_eq {t['dtype']} {t['shape'][0]}x{t['shape'][1]}: kernel {t['ms']:.3f} ms "
              f"({t['issued_tflops']:.2f} TFLOP/s issued), plain {t['plain_ms']:.3f} ms, library(einsum) "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}), "
              f"bound share {t['bound_share']:.3f}{tc}"
              + (f", splits {t['splits']}" if "splits" in t else "") + f" [{card}]")
    A32, d32 = make_inputs(torch, 2048, 10240, torch.float32, 1)
    timings[1].update(f32_exact_check(torch, ne, A32, d32, "make_inputs 2048x10240"))
    del A32, d32

    mark("3 timing")
    # 4. The main path (the fused loop), counts reset just before and read
    # just after.
    print(f"linalg: preferred library {torch.backends.cuda.preferred_linalg_library()}")
    row, _, r_fused = main_path(2048, 10240, seed=0)
    print("main_path " + json.dumps(row))
    small, p_small, r_small = main_path(256, 1024, seed=0)
    h_obj = highs_objective(p_small)
    rel = abs(r_small.objective - h_obj) / (1.0 + abs(h_obj))
    if not rel <= 1e-8:
        fail(f"256x1024 objective {r_small.objective!r} vs HiGHS {h_obj!r}: {rel:.3e}")
    print(f"small_path {small['problem']}: {small['status']} {small['iterations']} it, "
          f"objective vs HiGHS rel {rel:.3e}")
    # The same main-path solve again, warm (libraries loaded, kernels built).
    warm_row, _, _ = main_path(2048, 10240, seed=0)
    drift = abs(warm_row["objective"] - row["objective"]) / (1.0 + abs(row["objective"]))
    if drift > 1e-9 or warm_row["iterations"] != row["iterations"]:
        fail(f"main path: warm solve {warm_row['objective']!r}/{warm_row['iterations']} it "
             f"differs from the cold one {row['objective']!r}/{row['iterations']} it")
    print("main_path_warm " + json.dumps(warm_row))

    mark("4 main path")
    # 5. The host loop and the segmented loop against the fused one, then
    # cold solves in fresh processes, then the bad-step path.
    for kw in ({"fused_loop": False}, {"segment_iters": 4}):
        other_row, _, r_other = main_path(2048, 10240, seed=0, **kw)
        other_row["x_bitwise_equal_to_fused"] = same_answer(
            other_row["loop"], r_fused, row, r_other, other_row)
        print(f"main_path_{other_row['loop']} " + json.dumps(other_row))
    cold = cold_solve({})
    print(f"main_path_cold_{cold['loop']} " + json.dumps(cold))
    r_bad, launches, phases, _, _ = solve_counted(zero_row_lp(), presolve=False, reg_dual=0.0)
    acc = launch_accounting(r_bad, launches, phases, 0, fused=True)
    if r_bad.status.value != "numerical_error" or r_bad.iterations != 0:
        fail(f"zero-row LP: {r_bad.status.value} at {r_bad.iterations} iterations")
    print(f"bad_step_path zero_row: {r_bad.status.value} at {r_bad.iterations} iterations " + json.dumps(acc))

    mark("5 loops, cold, bad step")
    # 6. The CLI on a fixture.
    fixture = os.path.join(ROOT, "tests", "fixtures", "maximize.mps")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["solve", fixture, "--backend", "cuda", "--json", "--quiet"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    h_cli = highs_objective(read_mps(fixture))
    if rc != 0 or out["status"] != "optimal" or abs(out["objective"] - h_cli) > 1e-8 * (1 + abs(h_cli)):
        fail(f"cli solve maximize.mps: rc {rc}, {out}, HiGHS {h_cli}")
    print(f"cli: {out['name']} {out['status']} objective {out['objective']!r} (HiGHS {h_cli!r}) "
          f"iterations {out['iterations']}")

    mark("6 cli")
    # 7. Where the main path's device time goes (a warm solve of the fused
    # loop; the host loop's profile was cut for the script's time).
    print("profile_fused " + json.dumps(profile_main_path(torch, 2048, 10240, 0, "fused")))

    # 8. The batched solver, with vmap's per-sample fallback off for the
    # whole phase (solve_batched also turns it off for its own run).
    torch._C._functorch._set_vmap_fallback_enabled(False)
    mark("7 profiles")
    b_parity, b_timings, b_cold = batched_phase(torch, ne, card)
    mark("8 batched")

    # 10. The default backend of the CLI and the service (auto on the
    # card), with the counts reset just before and read just after.
    default_row = default_entry_phase(torch, ne, row, r_fused)
    mark("10 default entry")

    # 11-12. The route table, and the solo cost on both routes.
    route_and_solo_phase(card)
    mark("11-12 route, solo cost")

    # 9, 13. The serve phase, under the default ServiceConfig, with the
    # PDHG wave and both solo routes.
    s_parity, s_timing, s_rows = serve_phase(torch, ne, card)
    mark("9, 13 serve")

    # 14. The solo PDHG engine, then its column mesh on an NCCL world of
    # one (the gloo world of 2 rides the sharded phase's).
    pdhg_row, p_pdhg, r_pdhg = solo_pdhg_phase(card)
    pdlp_mesh_nccl1(torch, card, p_pdhg, r_pdhg, pdhg_row)
    shared["pdlp"] = dict(p=p_pdhg, r=r_pdhg)
    mark("14 solo pdhg")
    print(f"dense phase {since()} steps " + json.dumps(steps))

    main_t = timings[0]
    batched_t = b_timings[0]
    kernels = {"kernels": [{
        "name": "normal_eq",
        "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        # The main path through auto, the CLI's default (auto(cuda)).
        "launches": default_row["normal_eq_launches"],
        "max_abs_err": parity["float64_2048x10240"][1],
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "bound_share": main_t["bound_share"],
        "library_ms": main_t["library_ms"],
        "kernel_ms": main_t["ms"],
        "dtypes": ["float64", "float32", "bfloat16"],
        "shape": main_t["shape"],
        "timings": timings,
        "dmma_instructions": dmma,
        "hmma_tf32_instructions": sass["hmma_tf32"],
        "ptxas": ptxas_lines(ne, "normal_eq_dmma_kernel"),
        "ptxas_f32": ptxas_lines(ne, "normal_eq_tf32_kernel"),
    }, {
        "name": "normal_eq (batched)",
        "route": "cuda",
        "source": "distributedlpsolver_tpu_torch/csrc/normal_eq.cu",
        "replaces": "distributedlpsolver_tpu/ops/normal_eq.py:51",
        # The batched path's launches: one for every lane at a time.
        "launches": b_cold["normal_eq_launches"],
        "max_abs_err": b_parity[f"float64_{shape_name(BM, BN, BATCH)}"][1],
        "ms": batched_t["ms"],
        "plain_ms": batched_t["plain_ms"],
        "bound_ms": batched_t["bound_ms"],
        "bound_by": batched_t["bound_by"],
        "bound_share": batched_t["bound_share"],
        "library_ms": batched_t["library_ms"],
        "kernel_ms": batched_t["ms"],
        "dtypes": ["float64", "float32", "bfloat16"],
        "shape": batched_t["shape"],
        "timings": b_timings,
    },
        # The serve path's launches over its three waves; the plane phase
        # adds its own.
        serve_bucket_row(s_parity, s_timing, sum(r["normal_eq_launches"] for r in s_rows.values())),
        ]}
    return kernels["kernels"]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one-solve"]:
        sys.exit(one_solve(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--highs-storm20k"]:
        sys.exit(highs_storm20k())
    if sys.argv[1:2] == ["--highs-main"]:
        sys.exit(highs_main())
    only = {"--sparse-only": "sparse", "--plane-only": "plane", "--block-only": "block",
            "--scenario-only": "scenario", "--sharded-only": "sharded", "--slice-only": "slice",
            "--rows-only": "rows", "--pcg-only": "pcg", "--two-phase-only": "two_phase",
            "--sharded-pcg-only": "sharded_pcg"}
    if sys.argv[1:] and sys.argv[1] not in only:
        raise SystemExit(f"chip_smoke: unknown argument {sys.argv[1]!r}")
    sys.exit(main(only.get(sys.argv[1], "") if sys.argv[1:] else ""))
