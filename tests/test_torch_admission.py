"""The torch package's SLO admission and brownout (``net/admission.py``)
against the JAX package's, on the CPU.

* Both ``AdmissionController``s, driven by the same seeded sequence of
  submits, dispatches and finishes under an injected clock, give the same
  verdicts (admitted, reason, retry hint) and the same per-tenant stats.
* Both ``BrownoutController``s, fed the same queue depths and rejections
  under an injected clock, emit the same stage events and make the same
  shed / flush-widen / PDHG-reroute decisions at every step.
* ``SolveService(ServiceConfig(admission=, brownout=))`` in both packages
  sheds the same submits with the same ``ServiceOverloaded`` verdicts, and
  ``cli serve --quotas/--brownout`` runs in the port.
"""

import json

import numpy as np
import pytest

from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.net import admission as jadm
from distributedlpsolver_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from distributedlpsolver_tpu.serve import ServiceConfig as JaxServiceConfig
from distributedlpsolver_tpu.serve import ServiceOverloaded as JaxOverloaded
from distributedlpsolver_tpu.serve import SolveService as JaxService
from distributedlpsolver_tpu_torch import cli
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.net import admission as tadm
from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry
from distributedlpsolver_tpu_torch.serve import ServiceConfig, ServiceOverloaded, SolveService

PKGS = {"jax": (jadm, JaxRegistry), "torch": (tadm, MetricsRegistry)}
TENANTS = ("acme", "hog", "vip", "stranger")
PRIORITIES = ("high", "normal", "batch")


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _quotas(adm, rate=1.0):
    """The quota table; ``rate`` scales the refill rates (the service
    test runs on the real clock, so it takes refills too slow to land
    between two submits)."""
    return dict(
        quotas={"acme": adm.TenantQuota(rate=20.0 * rate, burst=4.0),
                "hog": adm.TenantQuota(weight=1.0),
                "vip": adm.TenantQuota(rate=50.0 * rate, burst=10.0, weight=3.0)},
        fair_start=0.25,
    )


def _admission_trace(pkg, seed, max_depth):
    """Verdicts of one seeded sequence of submits/finishes/clock ticks."""
    adm, Registry = PKGS[pkg]
    clock = Clock()
    ctl = adm.AdmissionController(adm.AdmissionConfig(**_quotas(adm)), max_depth=max_depth,
                                  flush_s=0.02, metrics=Registry(), clock=clock)
    rng = np.random.default_rng(seed)
    held = {t: 0 for t in TENANTS}
    out = []
    for _ in range(400):
        op = rng.random()
        tenant = TENANTS[rng.integers(len(TENANTS))]
        if op < 0.6:
            units = int(rng.integers(1, 3))
            v = ctl.admit(tenant, PRIORITIES[rng.integers(3)], units=units)
            out.append(("admit", tenant, v.admitted, v.reason, round(v.retry_after_s, 12)))
            if v.admitted:
                ctl.on_admitted(tenant, units=units)
                held[tenant] += units
        elif op < 0.85 and held[tenant]:
            ctl.on_finished(tenant, units=1)
            held[tenant] -= 1
        else:
            clock.t += float(rng.exponential(0.05))
    out.append(("stats", json.dumps(ctl.stats(), sort_keys=True)))
    out.append(("flush", [ctl.flush_scale(p) for p in PRIORITIES + ("unknown",)]))
    return out


@pytest.mark.parametrize("seed, max_depth", [(0, 16), (1, 32), (2, 8), (3, 64)])
def test_admission_verdicts_match_the_jax_package(seed, max_depth):
    ref = _admission_trace("jax", seed, max_depth)
    port = _admission_trace("torch", seed, max_depth)
    assert port == ref
    # The sequence exercised every verdict kind.
    reasons = {row[3] for row in ref if row[0] == "admit"}
    assert {"admitted", "quota"} <= reasons or {"quota"} <= reasons


def test_tenant_labels_are_bounded_the_same_way():
    out = {}
    for pkg, (adm, _) in PKGS.items():
        lab = adm.TenantLabeler(configured=["vip"], cap=4)
        out[pkg] = [lab.label(f"t{k}") for k in range(10)] + [lab.label("vip")]
    assert out["torch"] == out["jax"]
    assert out["torch"][-2:] == ["other", "vip"]


def _brownout_trace(pkg, seed):
    adm, Registry = PKGS[pkg]
    clock = Clock()
    bo = adm.BrownoutController(
        adm.BrownoutConfig(engage_after_s=1.0, escalate_after_s=2.0, release_after_s=2.0),
        max_depth=100, metrics=Registry(), clock=clock)
    rng = np.random.default_rng(seed)
    out = []
    # Saturation, a dip, saturation to stage 3, then calm to release.
    phases = [(90, 12), (50, 3), (95, 20), (5, 25)]
    for depth, steps in phases:
        for _ in range(steps):
            if rng.random() < 0.3:
                bo.note_reject()
            clock.t += float(rng.uniform(0.2, 0.6))
            evs = bo.observe(depth + int(rng.integers(-3, 4)))
            out.append([{k: v for k, v in e.items() if k not in ("ts", "t_mono")} for e in evs])
            out.append((bo.stage(), [bo.should_shed(p) for p in PRIORITIES], bo.flush_widen(),
                        bo.reroute_pdhg(1e-4), bo.reroute_pdhg(1e-9)))
    st = bo.stats()
    out.append({k: st[k] for k in st if k not in ("reject_rate",)})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brownout_ladder_matches_the_jax_package(seed):
    ref = _brownout_trace("jax", seed)
    port = _brownout_trace("torch", seed)
    assert port == ref
    stages = {row[0] for row in ref if isinstance(row, tuple)}
    assert stages == {0, 1, 2, 3}  # the ladder went all the way up and back


def _service_sheds(pkg):
    """Submit a fixed stream to a service that never dispatches (not
    started): the admission verdicts of every submit."""
    if pkg == "jax":
        adm, Service, Config, Overloaded, gen, kw = jadm, JaxService, JaxServiceConfig, \
            JaxOverloaded, jgen, {}
    else:
        adm, Service, Config, Overloaded, gen, kw = tadm, SolveService, ServiceConfig, \
            ServiceOverloaded, tgen, {"device": "cpu"}
    cfg = Config(batch=4, flush_s=0.02, max_queue_depth=12,
                 admission=adm.AdmissionConfig(**_quotas(adm, rate=1e-6)),
                 brownout=adm.BrownoutConfig(engage_after_s=0.0, depth_high=0.5))
    svc = Service(cfg, auto_start=False, **kw)
    out = []
    try:
        for k in range(24):
            tenant, prio = TENANTS[k % 3], PRIORITIES[k % 3]
            try:
                svc.submit(gen.random_dense_lp(4, 10, seed=k), tenant=tenant, priority=prio)
                out.append((k, "queued"))
            except Overloaded as e:
                out.append((k, e.reason, e.tenant))
        stats = svc.stats()
        out.append({t: {k: v for k, v in row.items() if k != "tokens"}
                    for t, row in stats["admission"].items()})
        out.append(stats["brownout"]["stage"])
    finally:
        svc.shutdown(drain=False)
    return out


def test_service_admission_and_brownout_shed_as_the_jax_service():
    ref = _service_sheds("jax")
    port = _service_sheds("torch")
    assert port == ref
    assert any(len(r) == 3 for r in ref[:-2])  # something was shed


def test_cli_serve_takes_quotas_and_brownout(tmp_path, capsys):
    req = tmp_path / "r.jsonl"
    req.write_text("".join(json.dumps({"m": 6, "n": 16, "seed": k, "tenant": "acme"}) + "\n"
                           for k in range(6)))
    quotas = json.dumps({"tenants": {"acme": {"rate": 1000, "burst": 2}}})
    rc = cli.main(["serve", "--requests", str(req), "--device", "cpu", "--batch", "4",
                   "--flush-ms", "5", "--quotas", quotas, "--brownout", "on"])
    captured = capsys.readouterr()
    recs = [json.loads(ln) for ln in captured.out.splitlines() if ln.startswith("{")]
    summary = json.loads(captured.err.strip().splitlines()[-1])
    assert rc == 0 and len(recs) == 6 and {r["status"] for r in recs} == {"optimal"}
    assert summary["admission"]["acme"]["admitted"] == 6
    assert summary["brownout"]["stage"] == 0
