"""The port's scenario tier (``models/scenario.py``, the ``scenario``
backend and its routes) against the JAX package's, on the CPU
(``device="cpu"``, the normal-equations kernel's plain version).

* The model copy gives the reference's objects bit for bit: the lowered
  A, b and c, the hint, the dict, the K ladder and the delta stream.
* Whole solves end with the JAX ``scenario`` backend's status and IPM
  iterations and its objective within 1e-8 (the reference's small storms
  at K 1, 4 and 32, and stormG2-like blocks with no first-stage rows).
* The stacks built from the JAX backend's state through ``interop`` are
  the port's own, and on them each factor (L_k, C, LH, G, LF) and one
  application of the decomposition agree within 1e-12; padded lanes are
  the identity and add exactly zero.
* The reference's three setup errors, ``auto`` with the hint and by
  detection alone, the degradation ladder and a supervised degrade.
* Serving: the warm delta wave, admission units, the journal, the
  K-mixed meter, HTTP, metrics and ``cli report`` against ``stats()``;
  ``cli generate scenario`` then ``cli solve`` against the JAX CLI.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import scipy.optimize as sopt
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu import cli as jcli
from distributedlpsolver_tpu.backends import scenario as jsc
from distributedlpsolver_tpu.backends.auto import degradation_chain as jax_chain
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.ipm.config import SolverConfig as JaxConfig
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models import scenario as jms
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_interior
from distributedlpsolver_tpu.models.structure import detect_two_stage as jax_detect
from distributedlpsolver_tpu_torch import cli, interop
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.backends import scenario as tsc
from distributedlpsolver_tpu_torch.backends.auto import (
    AutoBackend,
    choose_backend_name,
    degradation_chain,
)
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models import scenario as tms
from distributedlpsolver_tpu_torch.models.problem import to_interior_form
from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
OBJ_TOL = 1e-8
FACTOR_TOL = 1e-12
WAIT = 180


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


def _small(mod, K, seed):
    """The reference's test instance (tests/test_scenario.py::_small_storm)."""
    return mod.two_stage_storm(K, block_m=6, block_n=10, first_stage_n=6, first_stage_m=2,
                               seed=seed)


def _storm_m0(gen):
    """stormG2-like blocks with a two_stage hint and no first-stage rows."""
    p = gen.storm_sparse_lp(8, 16, 24, 16, seed=9)
    p.block_structure = dict(p.block_structure, kind="two_stage", first_stage_m=0)
    return p


def _scenario():
    return get_backend("scenario", device=CPU)


def _same_csr(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return (np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


# -- the model copy ------------------------------------------------------------


@pytest.mark.parametrize("K, seed", [(1, 0), (5, 3), (9, 7)])
def test_the_model_copy_is_the_reference_bit_for_bit(K, seed):
    js, ts = _small(jms, K, seed), _small(tms, K, seed)
    for f in ("A0", "b0", "c0", "T", "W", "b", "c", "probs"):
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    jp, tp = js.to_block_angular(), ts.to_block_angular()
    assert _same_csr(tp.A, jp.A)
    for f in ("c", "rlb", "rub", "lb", "ub"):
        assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
    assert tp.block_structure == jp.block_structure == ts.structure_hint()
    assert tp.name == jp.name
    text = json.dumps(ts.to_dict(), allow_nan=False)
    assert text == json.dumps(js.to_dict(), allow_nan=False)
    back = tms.ScenarioLP.from_dict(json.loads(text))
    for f in ("A0", "T", "W", "b", "c", "probs"):
        assert np.array_equal(getattr(back, f), getattr(ts, f)), f


def test_the_k_ladder_and_the_delta_stream_are_the_references():
    from distributedlpsolver_tpu_torch.utils.fingerprint import structural_fingerprint

    assert [tms.scenario_k_bucket(k) for k in range(1, 70)] == [
        jms.scenario_k_bucket(k) for k in range(1, 70)]
    with pytest.raises(ValueError):
        tms.scenario_k_bucket(0)
    kw = dict(num_scenarios=4, seed=7)
    waves = list(tms.scenario_delta_stream(3, **kw))
    for t, j in zip(waves, jms.scenario_delta_stream(3, **kw)):
        for f in ("A0", "b0", "c0", "T", "W", "b", "c", "probs"):
            assert np.array_equal(getattr(t, f), getattr(j, f)), f
    lows = [s.to_block_angular() for s in waves]
    fps = {structural_fingerprint(p.A, p.m, p.n, p.lb, p.ub) for p in lows}
    assert len(fps) == 1 and not np.array_equal(lows[0].rlb, lows[1].rlb)


# -- solves against the JAX scenario backend -------------------------------------


CASES = {
    "K1": lambda mod, gen: _small(mod, 1, 11).to_block_angular(),
    "K4": lambda mod, gen: _small(mod, 4, 14).to_block_angular(),
    "K32": lambda mod, gen: _small(mod, 32, 42).to_block_angular(),
    "storm_m0": lambda mod, gen: _storm_m0(gen),
}


@pytest.mark.parametrize("name", list(CASES))
def test_solves_match_the_jax_scenario_backend(name):
    jp, tp = CASES[name](jms, jgen), CASES[name](tms, tgen)
    rj = jax_solve(jp, backend="scenario", tol=1e-8)
    be = _scenario()
    rt = solve(tp, backend=be, tol=1e-8)
    assert rt.status == Status.OPTIMAL and rt.status.value == rj.status.value
    assert rt.iterations == rj.iterations
    assert _rel(rt.objective, rj.objective) <= OBJ_TOL
    assert tp.max_violation(np.asarray(rt.x)) <= 1e-6
    rep = tsc.last_solve_report()
    hint = tp.block_structure
    assert rep["n_scenarios"] == hint["num_blocks"]
    assert rep["scenario_bucket"] == tms.scenario_k_bucket(hint["num_blocks"])
    assert rep["chunks"] == 1 and rep["factorizations"] == rt.iterations + 1
    cg = be.cg_report()
    assert cg["cg_iters"] == rep["cg_iters"] == sum(cg["cg_per_iteration"])
    assert len(cg["cg_per_iteration"]) == rt.iterations + 1
    # On the CPU CG reads its exit flag before every iteration: no masked work.
    assert rep["cg_masked"] == 0 and rep["host_syncs"] == rep["cg_iters"] + cg["newton_solves"]


def test_stage_times_cover_factorizations_and_solves_and_change_no_bit(monkeypatch):
    p = _small(tms, 4, 3).to_block_angular()
    r_on = solve(p, backend=tsc.ScenarioBackend(device=CPU), tol=1e-8)
    on = tsc.last_solve_report()
    monkeypatch.setattr(tsc._StageClock, "mark", lambda self: None)
    monkeypatch.setattr(tsc._StageClock, "add", lambda self, key, t0, t1: None)
    r_off = solve(p, backend=tsc.ScenarioBackend(device=CPU), tol=1e-8)
    off = tsc.last_solve_report()
    assert np.array_equal(r_on.x, r_off.x) and r_on.iterations == r_off.iterations
    assert min(on[k] for k in ("schur_ms", "link_ms", "solve_ms")) > 0
    assert all(off[k] == 0.0 for k in ("schur_ms", "link_ms", "solve_ms"))
    assert (off["factorizations"], off["solves"]) == (on["factorizations"], on["solves"])


# -- factors and one application through interop ----------------------------------


def _jax_state(jbe):
    """The JAX backend's placed state, as numpy, chunks concatenated."""
    cat = lambda xs: np.concatenate([np.asarray(x) for x in xs])  # noqa: E731
    k_pad = jbe._shape["scenario_bucket"]
    return dict(
        W=cat(jbe._Wd), T=cat(jbe._Td), rowmask=cat(jbe._rowmask_d), A0=np.asarray(jbe._A0d),
        rows0=jbe._rows0, cols0=jbe._cols0, rows_idx=jbe._rows_idx.reshape(k_pad, -1),
        cols_idx=jbe._cols_idx.reshape(k_pad, -1), colmask=jbe._colmask.reshape(k_pad, -1),
    )


def _close(t, j):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape
    return np.linalg.norm(t - j) <= FACTOR_TOL * max(np.linalg.norm(j), 1e-300)


@pytest.mark.parametrize("name, K", [("K5", 5), ("storm_m0", 8)])
def test_factors_and_one_application_match_through_interop(name, K):
    if name == "K5":
        jp, tp = _small(jms, 5, 21).to_block_angular(), _small(tms, 5, 21).to_block_angular()
    else:
        jp, tp = _storm_m0(jgen), _storm_m0(tgen)
    jinf, tinf = jax_interior(jp), to_interior_form(tp)
    jbe = jsc.ScenarioBackend()
    jbe.setup(jinf, JaxConfig())
    tbe = _scenario()
    tbe.setup(tinf, SolverConfig())
    st = _jax_state(jbe)
    tens, lay = interop.scenario_tensors_from_arrays(**st, m=jinf.m, n=jinf.n, device=CPU)
    # The port's own stacks, scattered from A, are the reference's.
    assert tuple(lay) == tuple(tbe.layout) and lay.K == K
    (own,) = tbe._parts
    for f in tens._fields:
        assert torch.equal(getattr(tens, f), getattr(own, f)), f
    tbe._parts = [tens]

    rng = np.random.default_rng(3)
    d = rng.uniform(0.1, 10.0, jinf.n)
    reg = 1e-10
    dK = d[st["cols_idx"]] * st["colmask"]
    Lj, Cj = jsc._schur_factor_jit(st["W"], st["T"], dK, st["rowmask"], reg,
                                   np.zeros((lay.n0, lay.n0)))
    dt = torch.tensor(d)
    Lt, Ct = tbe._schur_factor(tens, tsc._pad(dt)[tens.cols_idx], reg)
    assert _close(Lt, Lj) and _close(Ct, Cj)
    LHj, Gj, LFj = jsc._link_factor_jit(Cj, d[st["cols0"]], st["A0"], reg)
    LHt, Gt, LFt = tbe._link_factor(Ct, dt[tens.cols0], reg)
    assert _close(LHt, LHj) and _close(Gt, Gj) and _close(LFt, LFj)
    # Padded lanes: the identity factor, a zero coupling, so zero in C.
    eye = torch.eye(lay.mb, dtype=torch.float64)
    assert all(torch.equal(Lt[k], eye) for k in range(K, lay.k_pad))
    assert not tens.T[K:].any() and not tens.W[K:].any()

    r = rng.standard_normal(jinf.m)
    yj = jbe._apply_decomp(jbe._factorize(d, reg), r)
    yt = tbe._apply_decomp(tbe._factorize(dt, reg), torch.tensor(r))
    assert _close(yt, yj)


# -- the reference's setup errors -----------------------------------------------------


def _bad_cases():
    """Each error's LPProblem maker and message; the same arrays in both."""
    def arrow(mod_gen):
        p = mod_gen.random_sparse_lp(24, 48, density=0.2, seed=1)
        p.block_structure = {"kind": "two_stage", "num_blocks": 4, "block_m": 6, "block_n": 11,
                             "first_stage_n": 4, "first_stage_m": 0}
        return p

    def array_hint(mod_gen, mod_sc, rb_fn, cb_fn):
        p = _small(mod_sc, 3, 2).to_block_angular()
        rb = np.full(p.m, -1)
        rb[2:] = np.repeat(np.arange(3), 6)
        cb = np.full(p.n, -1)
        cb[6:] = np.repeat(np.arange(3), 10)
        p.block_structure = {"kind": "two_stage", "num_blocks": 3, "row_block": rb_fn(rb).tolist(),
                             "col_block": cb_fn(cb).tolist()}
        return p

    empty = lambda g, s: array_hint(g, s, lambda rb: np.where(rb == 1, 0, rb), lambda cb: cb)  # noqa: E731
    no_first = lambda g, s: array_hint(g, s, lambda rb: rb, lambda cb: np.maximum(cb, 0))  # noqa: E731
    return {
        "outside_arrow": (lambda g, s: arrow(g), "outside the two_stage arrow"),
        "empty_block": (empty, "empty scenario block"),
        "no_first_stage_columns": (no_first, "no first-stage columns"),
    }


@pytest.mark.parametrize("name", list(_bad_cases()))
def test_setup_errors_match_the_reference(name):
    build, what = _bad_cases()[name]
    with pytest.raises(ValueError, match=what) as ej:
        jsc.ScenarioBackend().setup(jax_interior(build(jgen, jms)), JaxConfig())
    with pytest.raises(ValueError, match=what) as et:
        _scenario().setup(to_interior_form(build(tgen, tms)), SolverConfig())
    assert str(et.value) == str(ej.value)


def test_mesh_is_refused_naming_item_13():
    """The lane mesh solves: over a local mesh of 2 (the CPU twice) each
    member holds its half of the padded lanes, and the answer is the
    unsharded solve's (``test_torch_scenario_mesh.py`` holds the rest)."""
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    p = _small(tms, 4, 3).to_block_angular()
    be = get_backend("scenario", mesh=mesh_lib.make_mesh(axis_names=("batch",),
                                                         devices=[CPU] * 2))
    r = solve(p, backend=be, tol=1e-8)
    r0 = solve(p, backend=_scenario(), tol=1e-8)
    assert be.lane_ranges == [(0, 2), (2, 4)]
    assert r.status == Status.OPTIMAL and r.iterations == r0.iterations
    assert _rel(r.objective, r0.objective) <= 1e-8


# -- routes -------------------------------------------------------------------------


@pytest.mark.parametrize("hinted", [True, False])
def test_auto_routes_to_scenario_with_the_hint_and_by_detection(hinted):
    jp, tp = _small(jms, 8, 70).to_block_angular(), _small(tms, 8, 70).to_block_angular()
    if not hinted:
        jp.block_structure = tp.block_structure = None
        name, hint = choose_backend_name(to_interior_form(tp), "cpu", detect=True)
        assert name == "scenario"
        jhint = jax_detect(jp.A)
        assert set(hint) == set(jhint)
        for k in hint:
            assert np.array_equal(np.asarray(hint[k]), np.asarray(jhint[k])), k
    for platform in ("cpu", "cuda"):
        assert choose_backend_name(to_interior_form(tp), platform, detect=True)[0] == "scenario"
    rj = jax_solve(jp, backend="auto", tol=1e-8)
    be = AutoBackend(device=CPU)
    rt = solve(tp, backend=be, tol=1e-8)
    assert rt.backend == rj.backend == "auto(scenario)"
    assert rt.status == Status.OPTIMAL and rt.iterations == rj.iterations
    assert _rel(rt.objective, rj.objective) <= OBJ_TOL


def test_the_ladder_and_a_supervised_degrade_are_the_references():
    from distributedlpsolver_tpu.supervisor import supervised_solve as jax_supervised
    from distributedlpsolver_tpu_torch.supervisor import supervised_solve

    assert degradation_chain("scenario") == jax_chain("scenario")
    hint = {"kind": "two_stage", "num_blocks": 4, "block_m": 6, "block_n": 11,
            "first_stage_n": 4, "first_stage_m": 0}
    jp = jgen.random_sparse_lp(24, 48, density=0.2, seed=2)
    tp = tgen.random_sparse_lp(24, 48, density=0.2, seed=2)
    jp.block_structure, tp.block_structure = dict(hint), dict(hint)
    rj = jax_supervised(jp, backend="scenario", tol=1e-8)
    rt = supervised_solve(tp, backend=_scenario(), tol=1e-8)
    assert rt.status == Status.OPTIMAL and rt.backend == rj.backend == "sparse-iterative"
    A = sp.csr_matrix(tp.A)
    eq = tp.rlb == tp.rub
    hg = sopt.linprog(tp.c, A_eq=A[eq], b_eq=tp.rub[eq], A_ub=A[~eq], b_ub=tp.rub[~eq],
                      bounds=list(zip(tp.lb, np.where(np.isinf(tp.ub), None, tp.ub))),
                      method="highs")
    assert hg.status == 0
    assert abs(rt.objective - hg.fun) <= 1e-6 * (1.0 + abs(hg.fun))


def test_cli_generate_then_solve_routes_auto_scenario_as_the_jax_cli(tmp_path, capsys):
    """16 scenarios of 24×36: past m·n 200,000, so both readers take the
    file as CSR and ``auto``'s detection finds the arrow."""
    a, b = tmp_path / "port.mps", tmp_path / "ref.mps"
    argv = ["--scenarios", "16", "--m", "24", "--n", "36", "--seed", "3"]
    assert cli.main(["generate", "scenario", str(a)] + argv) == 0
    assert jcli.main(["generate", "scenario", str(b)] + argv) == 0
    assert a.read_bytes() == b.read_bytes()
    capsys.readouterr()
    assert cli.main(["solve", str(a), "--json", "--quiet", "--device", "cpu"]) == 0
    assert jcli.main(["solve", str(a), "--json", "--quiet"]) == 0
    port, ref = (json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()[-2:])
    assert port["backend"] == ref["backend"] == "auto(scenario)"
    assert port["status"] == ref["status"] == "optimal"
    assert port["iterations"] == ref["iterations"]
    assert _rel(port["objective"], ref["objective"]) <= OBJ_TOL


# -- serving ---------------------------------------------------------------------------


def _svc(metrics=None, **kw):
    kw.setdefault("flush_s", 0.005)
    return SolveService(ServiceConfig(**kw), device=CPU, metrics=metrics)


def test_the_delta_wave_warms_below_the_cold_median():
    svc = _svc()
    try:
        futs = [svc.submit(s.to_block_angular(), tol=1e-8) for s in tms.scenario_delta_stream(
            10, num_scenarios=8, block_m=6, block_n=10, first_stage_n=6, first_stage_m=2, seed=11)]
        res = [f.result(timeout=WAIT) for f in futs]
    finally:
        svc.shutdown()
    assert all(r.status is Status.OPTIMAL and r.engine == "scenario" for r in res)
    assert all((r.n_scenarios, r.scenario_bucket, r.backend) == (8, 8, "scenario") for r in res)
    warm = [r.iterations for r in res if r.warm == "warm"]
    cold = [r.iterations for r in res if r.warm != "warm"]
    assert warm and cold
    assert np.median(warm) < np.median(cold)
    assert all(r.schur_ms > 0 and r.link_ms > 0 for r in res)
    # The first (cold) request solves as the JAX package's engine does.
    first = next(jms.scenario_delta_stream(
        1, num_scenarios=8, block_m=6, block_n=10, first_stage_n=6, first_stage_m=2, seed=11))
    rj = jax_solve(first.to_block_angular(), backend="scenario", tol=1e-8)
    assert res[0].warm == "cold" and res[0].iterations == rj.iterations
    assert _rel(res[0].objective, rj.objective) <= OBJ_TOL


def test_admission_charges_ceil_k_over_the_unit():
    from distributedlpsolver_tpu_torch.net.admission import AdmissionConfig, TenantQuota
    from distributedlpsolver_tpu_torch.serve.scheduler import ServiceOverloaded

    assert ServiceConfig().scenario_k_unit == 16
    svc = _svc(scenario_k_unit=8, admission=AdmissionConfig(
        quotas={"acme": TenantQuota(rate=0.001, burst=8.0)}))
    try:
        p = _small(tms, 32, 80).to_block_angular()  # 32/8 = 4 units each
        futs, rejected = [], None
        for _ in range(3):
            try:
                futs.append(svc.submit(p, tol=1e-8, tenant="acme"))
            except ServiceOverloaded as e:
                rejected = e
                break
        assert len(futs) == 2 and rejected is not None and rejected.reason == "quota"
        assert all(f.result(timeout=WAIT).status is Status.OPTIMAL for f in futs)
        adm = svc.stats()["admission"]["acme"]
        assert adm["admitted"] == 2 and adm["in_system"] == 0
    finally:
        svc.shutdown()


def test_a_journalled_scenario_job_replays_after_a_restart(tmp_path):
    from distributedlpsolver_tpu_torch.net import protocol

    cfg = ServiceConfig(flush_s=0.005, journal_dir=str(tmp_path / "journal"))
    svc_a = SolveService(cfg, auto_start=False, device=CPU)
    jid = svc_a.submit(_small(tms, 4, 90).to_block_angular(), tol=1e-8).jid
    assert jid
    svc_a._journal.close()
    svc_b = SolveService(cfg, device=CPU)
    try:
        deadline = time.time() + WAIT
        while time.time() < deadline:
            kind, rec = svc_b.job_result(jid)
            if kind == "done":
                break
            time.sleep(0.05)
        assert kind == "done" and rec["status"] == "optimal" and rec["n_scenarios"] == 4
        code, body = protocol.payload_from_record(rec)
        assert code == 200 and body["status"] == "optimal"
        assert (body["n_scenarios"], body["scenario_bucket"], body["recovered"]) == (4, 4, True)
    finally:
        svc_b.shutdown()


def test_a_k_mixed_stream_inside_its_buckets_keeps_the_meter_flat():
    shape = dict(block_m=4, block_n=7, first_stage_n=4, first_stage_m=1)
    for K in (4, 8):  # one solve per bucket sets its key up
        r = tsc.solve_scenario(tms.two_stage_storm(K, seed=99, **shape), tol=1e-8, device=CPU)
        assert r.status is Status.OPTIMAL
    size0 = tsc.scenario_program_cache_size()
    svc = _svc()
    try:
        futs = [svc.submit(tms.two_stage_storm(K, seed=100 + K, **shape).to_block_angular(),
                           tol=1e-8) for K in (3, 4, 5, 6, 7, 8)]
        res = [f.result(timeout=WAIT) for f in futs]
    finally:
        svc.shutdown()
    assert all(r.status is Status.OPTIMAL for r in res)
    assert {r.scenario_bucket for r in res} == {4, 8}
    assert tsc.scenario_program_cache_size() == size0


def test_http_metrics_and_report_reconcile_with_stats(tmp_path):
    from distributedlpsolver_tpu_torch.net.server import NetConfig, SolveHTTPServer
    from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry
    from distributedlpsolver_tpu_torch.obs.report import render, report_from_paths

    log = str(tmp_path / "serve.jsonl")
    reg = MetricsRegistry()
    svc = _svc(log_jsonl=log, metrics=reg)
    front = SolveHTTPServer(svc, NetConfig(), metrics=reg).start()
    try:
        body = json.dumps({"scenarios": {"n_scenarios": 4, "seed": 5, "block_m": 4, "block_n": 7,
                                         "first_stage_n": 4, "first_stage_m": 1}}).encode()
        req = urllib.request.Request(front.url + "/v1/solve", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            assert resp.status == 200
            payload = json.loads(resp.read())
        assert payload["status"] == "optimal"
        assert (payload["n_scenarios"], payload["scenario_bucket"]) == (4, 4)
        assert payload["schur_ms"] > 0
        for K in (3, 8):
            r = svc.submit(_small(tms, K, K).to_block_angular(), tol=1e-8).result(timeout=WAIT)
            assert r.status is Status.OPTIMAL
        stats = svc.stats()
    finally:
        front.shutdown()
        svc.shutdown()
    snap = reg.snapshot()
    assert sum(v for k, v in snap.items() if k.startswith("scenario_solves_total")) == 3
    assert snap["scenario_k"]["count"] == 3 and snap["scenario_schur_ms"]["sum"] > 0
    rep = report_from_paths([log])
    assert rep["scenario"]["solves"] == stats["scenario"]["solves"] == 3
    assert set(rep["scenario"]["by_bucket"]) == set(stats["scenario"]["by_bucket"]) == {"4", "8"}
    for bucket, row in rep["scenario"]["by_bucket"].items():
        srow = stats["scenario"]["by_bucket"][bucket]
        assert row["count"] == srow["count"] and row["k_max"] == srow["k_max"]
        assert row["total_ms"]["p50"] == pytest.approx(srow["total_ms_p50"], abs=2e-3)
    assert "scenario tier: 3 solves" in render(rep)


def test_a_cached_structure_routes_a_hintless_problem_without_detecting_again(monkeypatch):
    """The warm cache's recorded hint routes the next same-structure
    hint-less problem straight to the scenario engine, with no second
    detection pass, in both packages (the JAX driver's rule; the port's
    driver stored the hint and did not read it back)."""
    from distributedlpsolver_tpu.models import structure as jstructure
    from distributedlpsolver_tpu.serve.warmcache import WarmCache as JaxWarmCache
    from distributedlpsolver_tpu_torch.models import structure as tstructure
    from distributedlpsolver_tpu_torch.serve.warmcache import WarmCache

    calls = {"jax": 0, "torch": 0}
    for key, mod in (("jax", jstructure), ("torch", tstructure)):
        real = mod.detect_two_stage

        def counted(A, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(A, **kw)

        monkeypatch.setattr(mod, "detect_two_stage", counted)
    jcache, tcache = JaxWarmCache(), WarmCache()
    for r_ in range(2):
        jp = next(jms.scenario_delta_stream(1, num_scenarios=4, seed=5, offset=r_)).to_block_angular()
        tp = next(tms.scenario_delta_stream(1, num_scenarios=4, seed=5, offset=r_)).to_block_angular()
        jp.block_structure = tp.block_structure = None
        # Unscaled: ``auto`` then attaches its detection to the form the
        # cache records (a scaled solve attaches it to the scaled copy).
        rj = jax_solve(jp, backend="auto", tol=1e-8, warm_cache=jcache, scale=False)
        rt = solve(tp, backend=AutoBackend(device=CPU), tol=1e-8, warm_cache=tcache, scale=False)
        assert rt.backend == rj.backend == "auto(scenario)"
        assert rt.status == Status.OPTIMAL and rt.iterations == rj.iterations
        assert _rel(rt.objective, rj.objective) <= OBJ_TOL
    assert calls == {"jax": 1, "torch": 1}
