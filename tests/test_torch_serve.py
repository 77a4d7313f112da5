"""The torch solve service (``serve/``) against the JAX package's, on the
CPU: the bucket and scheduler policies, the job journal, the end-to-end
service on the same request stream, the solo path, fault recovery,
journal replay after a restart, ``cli serve --device cpu``, and the
refusals of what is not ported.

The same seeded streams go through both packages; the JAX side runs on
the CPU as its own tests run it. Every service test bounds its wait with
``drain(timeout=...)``. Tolerances: equal statuses and iterations,
objectives within 1e-8 relative.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import Future

import numpy as np
import pytest

from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.serve import ServiceConfig as JServiceConfig
from distributedlpsolver_tpu.serve import SolveService as JSolveService
from distributedlpsolver_tpu_torch.backends import batched as tbatched
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models.generators import (
    random_dense_lp,
    random_general_lp,
    random_request_stream,
    sparse_request_stream,
)
from distributedlpsolver_tpu_torch.models.problem import LPProblem
from distributedlpsolver_tpu_torch.models.scenario import two_stage_storm
from distributedlpsolver_tpu_torch.serve import (
    BucketSpec,
    BucketTable,
    ServiceConfig,
    ServiceOverloaded,
    SolveService,
    pad_standard_form,
    padding_waste,
    standard_form,
)
from distributedlpsolver_tpu_torch.serve.journal import (
    JobJournal,
    request_fingerprint,
    request_spec,
)
from distributedlpsolver_tpu_torch.serve.scheduler import PendingRequest, Scheduler
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
WAIT = 300


def _svc(**kw):
    kw.setdefault("batch", 4)
    kw.setdefault("flush_s", 0.02)
    return SolveService(ServiceConfig(**kw), device=CPU)


# -- buckets and padding (copies of the JAX package's cases) -----------------


class TestBuckets:
    def test_auto_table_rounds_up_pow2(self):
        t = BucketTable(batch=4)
        s = t.spec_for(9, 40)
        assert (s.m, s.n, s.batch) == (16, 64, 4)
        assert t.spec_for(10, 33) is s

    def test_auto_table_bumps_n_for_pad_columns(self):
        s = BucketTable(batch=4).spec_for(15, 16)
        assert (s.m, s.n) == (16, 32)

    def test_explicit_table_smallest_fit(self):
        small, big = BucketSpec(8, 32, 4), BucketSpec(32, 128, 4)
        t = BucketTable(buckets=[big, small])
        assert t.spec_for(8, 24) is small
        assert t.spec_for(9, 24) is big
        with pytest.raises(ValueError):
            t.spec_for(64, 64)

    def test_pad_preserves_solution(self):
        p = random_dense_lp(8, 24, seed=5)
        c, A, b = standard_form(p)
        cp, Ap, bp = pad_standard_form(c, A, b, 16, 48)
        assert Ap.shape == (16, 48) and cp.shape == (48,) and bp.shape == (16,)
        np.testing.assert_array_equal(Ap[:8, :24], A)
        assert (Ap[8:, :24] == 0).all() and (Ap[:8, 24:] == 0).all()
        be = get_backend("cuda", device=CPU)
        r_ref = solve(p, backend=be)
        padded = LPProblem(c=cp, A=Ap, rlb=bp, rub=bp, lb=np.zeros(48), ub=np.full(48, np.inf))
        r_pad = solve(padded, backend=be)
        assert r_pad.status == Status.OPTIMAL
        assert r_pad.objective - 8 == pytest.approx(r_ref.objective, abs=1e-7)

    def test_pad_rejects_insufficient_columns(self):
        with pytest.raises(ValueError):
            pad_standard_form(np.ones(4), np.ones((4, 4)), np.ones(4), 8, 6)

    def test_padding_waste(self):
        spec = BucketSpec(16, 64, 4)
        assert padding_waste(spec.cells, spec) == 0.0
        assert padding_waste(spec.cells // 2, spec) == pytest.approx(0.5)


def _pending(m, n, rid=0, deadline=None, t=None):
    now = time.perf_counter() if t is None else t
    return PendingRequest(
        request_id=rid, name=f"r{rid}", c=np.ones(n), A=np.ones((m, n)), b=np.ones(m),
        tol=1e-8, future=Future(), t_submit=now, deadline=deadline,
    )


class TestScheduler:
    def test_admission_control(self):
        s = Scheduler(BucketTable(batch=4), max_depth=2, flush_s=10.0)
        s.add(_pending(8, 24, 0))
        s.add(_pending(8, 24, 1))
        with pytest.raises(ServiceOverloaded):
            s.add(_pending(8, 24, 2))
        assert s.depth() == 2

    def test_flush_on_full_or_age(self):
        s = Scheduler(BucketTable(batch=2), max_depth=64, flush_s=0.5)
        t0 = time.perf_counter()
        s.add(_pending(8, 24, 0, t=t0))
        assert s.ready(t0) == []
        assert 0.4 < s.next_event_in(t0) <= 0.5
        key = s.add(_pending(8, 24, 1, t=t0))
        assert s.ready(t0) == [key]
        live, expired = s.pop(key, t0)
        assert len(live) == 2 and not expired and s.depth() == 0
        s.add(_pending(8, 24, 2, t=t0))
        assert s.ready(t0 + 0.6) == [key]

    def test_deadline_split_never_poisons_batch(self):
        s = Scheduler(BucketTable(batch=4), max_depth=64, flush_s=9.0)
        t0 = time.perf_counter()
        key = s.add(_pending(8, 24, 0, t=t0))
        s.add(_pending(8, 24, 1, deadline=t0 + 0.001, t=t0))
        assert s.ready(t0 + 0.01) == [key]
        live, expired = s.pop(key, t0 + 0.01)
        assert [p.request_id for p in live] == [0]
        assert [p.request_id for p in expired] == [1]

    def test_distinct_tol_distinct_queue(self):
        s = Scheduler(BucketTable(batch=4), max_depth=64, flush_s=1.0)
        k1 = s.add(_pending(8, 24, 0))
        p = _pending(8, 24, 1)
        p.tol = 1e-6
        k2 = s.add(p)
        assert k1 != k2 and k1[0] is k2[0]


# -- the job journal (copies of the JAX package's cases) ---------------------


def _spec(seed=0, name=None):
    p = random_dense_lp(8, 24, seed=seed)
    return request_spec(p, tol=1e-8, tenant="acme", priority="normal", name=name or f"j{seed}")


def test_journal_admit_finish_replay_roundtrip(tmp_path):
    d = str(tmp_path / "j")
    j = JobJournal(d)
    s1, s2 = _spec(1), _spec(2)
    j1 = j.admit(s1, request_fingerprint(s1), "acme", "normal", None)
    j2 = j.admit(s2, request_fingerprint(s2), "acme", "high", None)
    j.mark(j1, "dispatched")
    j.finish(j1, {"status": "optimal", "id": 1}, "optimal")
    j.close()
    j_r = JobJournal(d)
    rep = j_r.replay()
    assert [job.jid for job in rep.unfinished] == [j2]
    assert rep.finished == 1 and rep.torn == 0
    assert j_r.result(j1)["status"] == "optimal"
    assert j_r.is_pending(j2)
    s3 = _spec(3)
    assert j_r.admit(s3, request_fingerprint(s3), "acme", "normal", None) not in (j1, j2)
    j_r.close()


def test_journal_torn_tail_skipped_with_count(tmp_path):
    d = str(tmp_path / "j")
    j = JobJournal(d)
    s = _spec(1)
    jid = j.admit(s, request_fingerprint(s), "t", "normal", None)
    j.close()
    with open(os.path.join(d, "journal.jsonl"), "ab") as fh:
        fh.write(b'{"j": "admitted", "jid": "jto')
    j_r = JobJournal(d)
    rep = j_r.replay()
    assert rep.torn == 1 and [job.jid for job in rep.unfinished] == [jid]
    j_r.close()


def test_journal_finish_idempotent_and_compaction(tmp_path):
    j = JobJournal(str(tmp_path / "j"), compact_every=40)
    s = _spec(1)
    jid = j.admit(s, request_fingerprint(s), "t", "normal", None)
    assert j.finish(jid, {"status": "optimal", "try": 1}, "optimal")
    assert not j.finish(jid, {"status": "optimal", "try": 2}, "optimal")
    assert j.result(jid)["try"] == 1
    for k in range(30):
        s = _spec(k + 10)
        jk = j.admit(s, request_fingerprint(s), "t", "normal", None)
        j.finish(jk, {"status": "optimal"}, "optimal")
    assert sum(1 for _ in open(os.path.join(str(tmp_path / "j"), "journal.jsonl"))) < 30
    j.close()


# -- the service end to end --------------------------------------------------


def test_service_matches_the_jax_service_and_builds_nothing_warm():
    """``random_request_stream(24, seed=21)`` through both services: the
    same statuses, iterations and objectives; a second wave over the same
    buckets builds no program (compile_ms 0 on every request)."""
    problems = list(random_request_stream(24, seed=21))
    tbatched.release_bucket_programs()  # programs are per process: build both here
    with _svc(batch=8, flush_s=0.01) as svc:
        futs = [svc.submit(p) for p in problems]
        assert svc.drain(timeout=WAIT)
        port = [f.result(timeout=5) for f in futs]
        size0 = tbatched.bucket_cache_size()
        warm = [svc.submit(p) for p in random_request_stream(16, seed=22)]
        assert svc.drain(timeout=WAIT)
        warm = [f.result(timeout=5) for f in warm]
        assert tbatched.bucket_cache_size() == size0
        stats, rows = svc.stats(), svc.dispatch_report()
    with JSolveService(JServiceConfig(batch=8, flush_s=0.01)) as jsvc:
        jfuts = [jsvc.submit(p) for p in jgen.random_request_stream(24, seed=21)]
        assert jsvc.drain(timeout=WAIT)
        ref = [f.result(timeout=5) for f in jfuts]
    assert [r.status.value for r in port] == [r.status.value for r in ref]
    assert all(r.status is Status.OPTIMAL for r in port + warm)
    assert [r.iterations for r in port] == [r.iterations for r in ref]
    for r, q in zip(port, ref):
        assert abs(r.objective - q.objective) <= 1e-8 * (1 + abs(q.objective)), r.name
        assert r.bucket == q.bucket
    assert all(r.compile_ms == 0.0 for r in warm)
    assert stats["programs_compiled"] == len({r.bucket for r in port}) == 2
    assert all(row["launches"] == row["warmup_launches"] == 0 for row in rows)  # CPU: no kernel
    assert all(row["bodies"] > 0 for row in rows)


def test_general_form_routes_solo():
    p = random_general_lp(6, 10, seed=5)
    assert standard_form(p) is None
    with _svc() as svc:
        r = svc.submit(p).result(timeout=WAIT)
    ref = solve(p, backend=get_backend("cuda", device=CPU))
    assert r.status is Status.OPTIMAL and r.bucket is None
    assert r.objective == pytest.approx(ref.objective, rel=1e-7)
    # The default solo backend is auto, as in the JAX service; the record
    # names the route it took.
    assert ServiceConfig().solo_backend == "auto"
    assert r.backend == r.record()["backend"] == "auto(cpu-native)"


def test_batch_fault_retries_then_goes_solo():
    """A dispatch that faults on both attempts: its members recover solo
    through the supervisor's ladder and still answer OPTIMAL."""
    injections = []

    def injector(seq, key):
        if seq == 0 and len(injections) < 2:
            injections.append(seq)
            raise RuntimeError("injected batch fault")

    with _svc(fault_injector=injector, max_batch_retries=1) as svc:
        futs = [svc.submit(random_dense_lp(8, 24, seed=k)) for k in range(4)]
        assert svc.drain(timeout=WAIT)
        results = [f.result(timeout=5) for f in futs]
    assert injections == [0, 0]
    assert all(r.status is Status.OPTIMAL and r.retried_solo for r in results)
    assert all([f.action for f in r.faults][:2] == ["retry_batch", "solo_fallback"]
               for r in results)


def test_journal_replay_after_a_restart(tmp_path):
    """A restarted service replays the WAL: the live job is solved, the
    one whose deadline died with the process times out, and a finished
    job's poll id re-binds."""
    d = tmp_path / "j"
    with _svc(journal_dir=str(d)) as svc:
        fut = svc.submit(random_dense_lp(8, 24, seed=1), name="a")
        assert fut.result(timeout=WAIT).status is Status.OPTIMAL
        done_jid = fut.jid
    j = JobJournal(str(d))
    s_live, s_dead = _spec(5, name="live"), _spec(6, name="dead")
    jid_live = j.admit(s_live, request_fingerprint(s_live), "acme", "normal", None)
    jid_dead = j.admit(s_dead, request_fingerprint(s_dead), "acme", "normal", time.time() - 30.0)
    j.close()
    with _svc(journal_dir=str(d)) as svc:
        assert svc.drain(timeout=WAIT)
        assert svc.job_result(jid_live)[1]["status"] == "optimal"
        kind, rec = svc.job_result(jid_dead)
        assert kind == "done" and rec["status"] == "timeout"
        assert svc.job_result(done_jid)[0] == "done"


def test_drain_for_shutdown_sheds_and_finishes(tmp_path):
    svc = _svc(journal_dir=str(tmp_path / "j"))
    try:
        futs = [svc.submit(random_dense_lp(8, 24, seed=k)) for k in range(6)]
        svc.begin_draining()
        with pytest.raises(ServiceOverloaded) as ei:
            svc.submit(random_dense_lp(8, 24, seed=99))
        assert ei.value.reason == "draining" and ei.value.retry_after_s > 0
        assert svc.drain_for_shutdown(timeout=WAIT)
        assert all(f.result(timeout=5).status is Status.OPTIMAL for f in futs)
        assert svc.stats()["draining"] is True
    finally:
        svc.shutdown(drain=False)


def test_cancel_a_queued_job(tmp_path):
    svc = SolveService(ServiceConfig(batch=4, flush_s=0.02, journal_dir=str(tmp_path / "j")),
                       device=CPU, auto_start=False)
    try:
        doomed = svc.submit(random_dense_lp(8, 24, seed=3))
        mate = svc.submit(random_dense_lp(8, 24, seed=4))
        assert svc.cancel(doomed.jid) == (True, "cancelled")
        assert svc.cancel("jnope-1") == (False, "unknown")
        svc.start()
        assert svc.drain(timeout=WAIT)
        assert doomed.result(timeout=5).status is Status.CANCELLED
        assert mate.result(timeout=5).status is Status.OPTIMAL
        assert svc.cancel(mate.jid) == (False, "finished")
    finally:
        svc.shutdown()


def test_warm_buckets_and_ladder_swap_build_each_program_once():
    """``warm_buckets`` builds a bucket's program before traffic (once per
    key); ``apply_ladder`` swaps the ladder and warms the new buckets, so
    the first dispatch after the swap builds nothing."""
    tbatched.release_bucket_programs()
    with _svc() as svc:
        assert svc.warm_buckets([BucketSpec(8, 32, 4)]) == 1
        assert svc.warm_buckets([BucketSpec(8, 32, 4)]) == 0
        assert svc.apply_ladder([BucketSpec(16, 64, 4)], drain_timeout=WAIT) == 1
        size = tbatched.bucket_cache_size()
        r = svc.submit(random_dense_lp(12, 32, seed=1)).result(timeout=WAIT)
        assert r.status is Status.OPTIMAL and r.bucket == (16, 64, 4) and r.compile_ms == 0.0
        assert tbatched.bucket_cache_size() == size == 2
        assert svc.stats()["programs_compiled"] == 2


def test_cli_serve_on_the_cpu(tmp_path):
    req = tmp_path / "requests.jsonl"
    req.write_text("".join(json.dumps({"m": 8, "n": 24, "seed": k}) + "\n" for k in range(3)))
    proc = subprocess.run(
        [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "serve", "--requests",
         str(req), "--device", "cpu", "--batch", "4", "--flush-ms", "5"],
        capture_output=True, text=True, timeout=WAIT, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    recs = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [r["status"] for r in recs] == ["optimal"] * 3
    summary = json.loads(proc.stderr.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["requests"] == 3


# -- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("kw, item", [
    ({"mesh_devices": 2}, "item 13"),
])
def test_unported_service_options_raise(kw, item):
    """Once refused (``item``), ``mesh_devices`` is ported: on the CPU it
    splits each bucket over the CPU device K times, and an explicit
    bucket whose batch does not divide the mesh raises
    (``test_torch_batch_mesh.py`` holds the dispatch)."""
    from distributedlpsolver_tpu_torch.serve import BucketSpec

    with pytest.raises(ValueError, match="divisible"):
        _svc(buckets=[BucketSpec(8, 24, 3)], **kw)
    with _svc(**kw) as svc:
        assert svc.mesh_devices == kw["mesh_devices"]
        assert svc.submit(random_dense_lp(8, 24, seed=0)).result(timeout=WAIT).status \
            is Status.OPTIMAL


@pytest.mark.parametrize("key, cls", [
    ("admission", "AdmissionConfig"),
    ("brownout", "BrownoutConfig"),
])
def test_service_admission_and_brownout_serve(key, cls):
    """SLO admission and the brownout ladder: the service builds their
    controllers and serves."""
    from distributedlpsolver_tpu_torch.net import admission

    svc = _svc(**{key: getattr(admission, cls)()})
    try:
        assert svc.submit(random_dense_lp(8, 24, seed=0)).result(timeout=WAIT).status \
            == Status.OPTIMAL
        stats = svc.stats()
        if key == "admission":
            assert svc.admission is not None and stats["admission"]["default"]["admitted"] == 1
        else:
            assert stats["brownout"]["stage"] == 0
    finally:
        svc.shutdown()


def test_unported_requests_and_calls_raise():
    """What the service once refused now serves: a slice runner takes the
    dispatches (``test_torch_slice.py``), and ``reshard`` without a mesh
    keeps the one device."""
    class _Runner:
        mesh = None

    rsvc = SolveService(ServiceConfig(), device=CPU, slice_runner=_Runner(), auto_start=False)
    assert rsvc._slice is not None and rsvc.config.solo_backend == "dense"
    rsvc.shutdown()
    svc = _svc()
    try:
        p = random_dense_lp(8, 24, seed=0)
        # PDHG is ported: the loose request rides it, as in the JAX service.
        assert svc.submit(p, tol=1e-4).result(timeout=WAIT).engine == "pdhg"
        # The scenario tier is ported: a two-stage request takes the solo
        # route pinned to the scenario engine, charged by K.
        scen = two_stage_storm(2, 4, 7, 4, 1, seed=1).to_block_angular()
        r = svc.submit(scen).result(timeout=WAIT)
        assert r.status is Status.OPTIMAL and r.engine == "scenario"
        assert (r.n_scenarios, r.scenario_bucket, r.backend) == (2, 2, "scenario")
        assert svc.reshard() == 1 and svc.mesh_devices == 1
    finally:
        svc.shutdown()
    with _svc(pdhg_routing=False) as svc:  # the IPM takes a loose tol when asked
        r = svc.submit(p, tol=1e-4).result(timeout=WAIT)
        assert r.status is Status.OPTIMAL and r.engine == "ipm"


def test_the_service_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolveService(ServiceConfig(), auto_start=False)


# -- tolerance-tiered routing (the PDHG engine) -------------------------------


def _host_kkt(c, A, b, x, y):
    """(pinf, dinf, gap) of (x, y) on min cᵀx, Ax = b, x ≥ 0, in numpy."""
    r = c - A.T @ y
    pobj, dobj = c @ x, b @ y
    return (np.linalg.norm(b - A @ x) / (1 + np.linalg.norm(b)),
            np.linalg.norm(np.minimum(r, 0.0)) / (1 + np.linalg.norm(c)),
            abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj)))


def _jax_verdicts(cfg_kw, streams, solver_config=None):
    """(engine, status) of each request of ``streams`` through the JAX
    service, in submit order."""
    from distributedlpsolver_tpu.ipm.config import SolverConfig as JaxConfig
    from distributedlpsolver_tpu.serve.buckets import BucketSpec as JBucketSpec

    cfg_kw = dict(cfg_kw, buckets=[JBucketSpec(*b.key()) for b in cfg_kw["buckets"]])
    with JSolveService(JServiceConfig(**cfg_kw),
                       solver_config=JaxConfig(**(solver_config or {}))) as jsvc:
        futs = [jsvc.submit(p, tol=tol) for p, tol in streams]
        assert jsvc.drain(timeout=WAIT)
        return [(r.engine, r.status.value) for r in (f.result(timeout=5) for f in futs)]


class TestServeRouting:
    """The JAX package's ``TestServeRouting`` (``tests/test_sparse.py``)
    through the port, at its sizes, with the JAX service's verdicts."""

    def test_pdhg_routing_200_requests_zero_warm_recompiles(self):
        cfg_kw = dict(buckets=[BucketSpec(16, 64, 8)], flush_s=0.05, warm_start=False)
        svc = SolveService(ServiceConfig(**cfg_kw), device=CPU)
        try:
            assert ServiceConfig().pdhg_routing and ServiceConfig().pdhg_tol == 1e-4
            svc.warm_buckets(svc.scheduler.table.specs(), tol=1e-4)
            svc.warm_buckets(svc.scheduler.table.specs(), tol=1e-8)
            size0, caps0 = tbatched.bucket_cache_size(), tbatched.bucket_capture_count()
            pdhg_futs = [svc.submit(p, tol=tol) for p, tol in sparse_request_stream(200, seed=30)]
            ipm_futs = [svc.submit(p, tol=1e-8) for p, _ in sparse_request_stream(8, seed=31)]
            pdhg_res = [f.result(timeout=WAIT) for f in pdhg_futs]
            ipm_res = [f.result(timeout=WAIT) for f in ipm_futs]
            stats = svc.stats()
        finally:
            svc.shutdown()
        assert all(r.engine == "pdhg" for r in pdhg_res)
        assert all(r.engine == "ipm" for r in ipm_res)
        assert all(r.status.value == "optimal" for r in pdhg_res + ipm_res)
        assert stats["engine_dispatches"].get("pdhg", 0) > 0
        assert stats["engine_dispatches"].get("ipm", 0) > 0
        assert tbatched.bucket_cache_size() == size0, "warm bucket rebuilt"
        assert tbatched.bucket_capture_count() == caps0
        # Crossover honesty: PDHG verdicts hold at the REQUEST tolerance, on
        # the problem the engine solved (the request padded into its bucket),
        # recomputed on the host from the engine's lane.
        for (p, _), r in zip(sparse_request_stream(200, seed=30), pdhg_res):
            assert r.rel_gap <= 1e-4 and r.pinf <= 1e-4 and r.dinf <= 1e-4
            assert max(_host_kkt(*pad_standard_form(*standard_form(p), 16, 64), *r.lane)) <= 1e-4
        ref = _jax_verdicts(cfg_kw, list(sparse_request_stream(200, seed=30))
                            + [(p, 1e-8) for p, _ in sparse_request_stream(8, seed=31)])
        assert [(r.engine, r.status.value) for r in pdhg_res + ipm_res] == ref

    def test_pdhg_routing_disabled_pins_ipm(self):
        cfg = ServiceConfig(buckets=[BucketSpec(16, 64, 8)], flush_s=0.05, pdhg_routing=False,
                            warm_start=False)
        with SolveService(cfg, device=CPU) as svc:
            futs = [svc.submit(p, tol=tol) for p, tol in sparse_request_stream(8, seed=32)]
            res = [f.result(timeout=WAIT) for f in futs]
        assert all(r.engine == "ipm" for r in res)
        assert all(r.status.value == "optimal" for r in res)

    def test_a_pdhg_lane_that_misses_its_tol_crosses_over_to_the_ipm(self):
        """A budget of one 400-step burst leaves PDHG lanes short of the
        request tol: each such lane re-solves solo on the IPM ladder at
        that tol (auto → ``cpu-native`` on the CPU), as the JAX service's
        do; the PDHG iterate never reaches the warm cache."""
        cfg_kw = dict(buckets=[BucketSpec(16, 64, 8)], flush_s=0.05, pdhg_tol=1e-6)
        stream = list(sparse_request_stream(16, seed=33, tol=1e-6))
        with SolveService(ServiceConfig(**cfg_kw), solver_config=SolverConfig(max_iter=1),
                          device=CPU) as svc:
            futs = [svc.submit(p, tol=tol) for p, tol in stream]
            assert svc.drain(timeout=WAIT)
            res = [f.result(timeout=5) for f in futs]
            stats = svc.stats()
        crossed = [r for r in res if r.retried_solo]
        assert crossed and all(r.engine == "pdhg" for r in res)
        for r in crossed:
            assert any(f.backend == "batched" and f.action == "solo_fallback" for f in r.faults)
            assert r.backend == "auto(cpu-native)"
        assert set(stats["engine_dispatches"]) == {"pdhg"}
        ref = _jax_verdicts(cfg_kw, stream, solver_config={"max_iter": 1})
        assert [(r.engine, r.status.value) for r in res] == ref

