"""One Mehrotra step of the port (torch on the CPU) against the JAX package.

The same interior-form arrays go to the JAX package's dense ``tpu``
backend (run on the CPU) and to the port's ``cuda`` backend asked to run
on the CPU; the starting point and one ``mehrotra_step`` from the same
state must agree. Tolerance 1e-9 relative in norm per state vector: the
two packages sum in different BLAS orders, and one Cholesky of a
conditioned M carries those roundings into the direction.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributedlpsolver_tpu.backends import get_backend as jax_backend
from distributedlpsolver_tpu.backends.cpu import CpuBackend
from distributedlpsolver_tpu.ipm import core as jcore
from distributedlpsolver_tpu.ipm.config import SolverConfig as JaxConfig
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_interior
from distributedlpsolver_tpu.models.scaling import equilibrate
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import core as tcore
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState
from distributedlpsolver_tpu_torch.interop import interior_form_from_arrays

RTOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _problem(kind):
    p = {
        "dense": lambda: jgen.random_dense_lp(24, 64, seed=3),
        "general": lambda: jgen.random_general_lp(16, 40, seed=4),
    }[kind]()
    inf, _ = equilibrate(jax_interior(p))
    return inf


def _port_interior(inf):
    return interior_form_from_arrays(inf.A, inf.b, inf.c, inf.u, name=inf.name)


@pytest.mark.parametrize("kind", ["dense", "general"])
def test_start_and_one_step_match_jax_backend(kind):
    inf = _problem(kind)
    jbe = jax_backend("tpu")
    jbe.setup(inf, JaxConfig())
    tbe = get_backend("cuda", device="cpu")
    tbe.setup(_port_interior(inf), SolverConfig())

    j0 = jbe.to_host(jbe.starting_point())
    t0 = tbe.to_host(tbe.starting_point())
    for f in IPMState._fields:
        assert _rel(getattr(t0, f), getattr(j0, f)) <= RTOL, f

    # One step from the SAME state (the JAX start) in both packages.
    j1, jst = jbe.iterate(jbe.from_host(j0))
    t1, tst = tbe.iterate(tbe.from_host(j0))
    j1, t1 = jbe.to_host(j1), tbe.to_host(t1)
    for f in IPMState._fields:
        assert _rel(getattr(t1, f), getattr(j1, f)) <= RTOL, f
    assert bool(tst.bad) is bool(jst.bad) is False
    for f in ("mu", "pinf", "dinf", "rel_gap", "alpha_p", "alpha_d", "sigma"):
        assert abs(getattr(tst, f) - float(getattr(jst, f))) <= RTOL * (1 + abs(float(getattr(jst, f)))), f


@pytest.mark.parametrize(
    "variant", [{"mcc": 2}, {"center": True}, {"mu_pinf_floor": 0.03}, {"kkt_refine": 0}]
)
def test_step_variants_match_jax_core(variant):
    """The step's optional branches (Gondzio correctors, pure centering,
    μ balance floor, no KKT refinement), held against the JAX package's
    core on its numpy CPU backend from the same state."""
    inf = _problem("general")
    jbe = CpuBackend()
    jbe.setup(inf, JaxConfig())
    tbe = get_backend("cuda", device="cpu")
    tbe.setup(_port_interior(inf), SolverConfig())
    state = jbe.starting_point()

    jp = dataclasses.replace(JaxConfig().step_params(), **variant)
    tp = dataclasses.replace(SolverConfig().step_params(), **variant)
    j1, jst = jcore.mehrotra_step(jbe._ops(), jbe._data, jp, state)
    t1, tst = tcore.mehrotra_step(tbe._ops(), tbe._data, tp, tbe.from_host(state))
    for f in IPMState._fields:
        assert _rel(getattr(t1, f).numpy(), getattr(j1, f)) <= RTOL, f
    assert abs(float(tst.sigma) - float(jst.sigma)) <= RTOL


def test_primal_row_closure_matches_jax_core():
    """LinOps.primal_project (the exact primal-row closure no port
    backend sets yet) corrects dx identically in both packages."""
    inf = _problem("dense")
    jbe = CpuBackend()
    jbe.setup(inf, JaxConfig())
    tbe = get_backend("cuda", device="cpu")
    tbe.setup(_port_interior(inf), SolverConfig())
    state = jbe.starting_point()
    A = np.asarray(inf.A)
    At = torch.from_numpy(A)
    jops = jbe._ops()._replace(primal_project=lambda rv: A.T @ np.linalg.solve(A @ A.T, rv))
    tops = tbe._ops()._replace(primal_project=lambda rv: At.T @ torch.linalg.solve(At @ At.T, rv))
    j1, _ = jcore.mehrotra_step(jops, jbe._data, jbe._params, state)
    t1, _ = tcore.mehrotra_step(tops, tbe._data, tbe._params, tbe.from_host(state))
    for f in IPMState._fields:
        assert _rel(getattr(t1, f).numpy(), getattr(j1, f)) <= RTOL, f


def test_classify_divergence_matches_on_host_floats():
    cases = [
        (1e-14, 0.5, 1e-9, 0.1, 1.0, 1.0),  # μ converged, pinf stuck
        (1.0, 1e-9, 0.5, 1.0, -1e10, 1.0),  # primal dive
        (1e-3, 1e-9, 1e-9, 1e-9, 5.0, 5.0),  # healthy
    ]
    for args in cases:
        assert tcore.classify_divergence(*args) == jcore.classify_divergence(*args)


def test_step_stats_stay_on_device_until_iterate_copies_them():
    """Every StepStats field of mehrotra_step is a 0-dim tensor (no host
    value is read inside the step); iterate copies them out once."""
    inf = _problem("dense")
    tbe = get_backend("cuda", device="cpu")
    tbe.setup(_port_interior(inf), SolverConfig())
    st = tbe.starting_point()
    _, stats = tcore.mehrotra_step(tbe._ops(), tbe._data, tbe._params, st)
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in stats)
    _, host = tbe.iterate(st)
    assert all(isinstance(v, float) for v in host[:-1]) and isinstance(host.bad, bool)
