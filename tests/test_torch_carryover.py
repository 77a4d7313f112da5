"""Framework-free modules the port keeps as copies, and the carry-over of
state from the JAX package (interop, checkpoints).

The copies must give bit-identical results to the originals: the same
interior forms, presolve reductions and Ruiz factors from the same
fixtures and generator seeds. A checkpoint the JAX package writes must
resume in the port and finish at the same objective.
"""

import dataclasses
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu.io import read_mps as jax_read_mps
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.ipm.config import SolverConfig as JaxConfig
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.presolve import presolve as jax_presolve
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_interior
from distributedlpsolver_tpu.models.scaling import equilibrate as jax_equilibrate
from distributedlpsolver_tpu_torch import interop
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.io import read_mps
from distributedlpsolver_tpu_torch.ipm import IPMState, Status, solve
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.presolve import presolve
from distributedlpsolver_tpu_torch.models.problem import to_interior_form
from distributedlpsolver_tpu_torch.models.scaling import equilibrate

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _pair(case):
    if case.endswith(".mps"):
        path = os.path.join(FIXTURES, case)
        return read_mps(path), jax_read_mps(path)
    fn, seed = case.split(":")
    args = {"random_dense_lp": (10, 30), "random_general_lp": (9, 20), "random_sparse_lp": (20, 60)}[fn]
    kw = {"density": 0.1} if fn == "random_sparse_lp" else {}
    return (getattr(tgen, fn)(*args, seed=int(seed), **kw),
            getattr(jgen, fn)(*args, seed=int(seed), **kw))


CASES = ["maximize.mps", "quirks.mps", "random_dense_lp:0", "random_general_lp:1",
         "random_sparse_lp:2"]


def _dense(A):
    return A.toarray() if sp.issparse(A) else np.asarray(A)


def _assert_same_fields(a, b, skip=()):
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if sp.issparse(va) or sp.issparse(vb):
            np.testing.assert_array_equal(_dense(va), _dense(vb), err_msg=f.name)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        elif f.name != "status":
            assert va == vb, f.name


@pytest.mark.parametrize("case", CASES)
def test_copies_reduce_convert_and_scale_identically(case):
    pt, pj = _pair(case)
    _assert_same_fields(pt, pj)
    rt, it = presolve(pt)
    rj, ij = jax_presolve(pj)
    _assert_same_fields(rt, rj)
    _assert_same_fields(it, ij, skip=("singletons",))
    assert [dataclasses.astuple(s) for s in it.singletons] == [
        dataclasses.astuple(s) for s in ij.singletons]
    assert (it.status is None) == (ij.status is None)
    ft, fj = to_interior_form(rt), jax_interior(rj)
    _assert_same_fields(ft, fj)
    (st, sct), (sj, scj) = equilibrate(ft), jax_equilibrate(fj)
    _assert_same_fields(st, sj)
    np.testing.assert_array_equal(sct.dr, scj.dr)
    np.testing.assert_array_equal(sct.dc, scj.dc)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    ck = str(tmp_path / "ck.npz")
    pj = jgen.random_dense_lp(14, 40, seed=5)
    full = jax_solve(pj, backend="tpu", fused_loop=False)
    part = jax_solve(pj, backend="tpu", checkpoint_path=ck, checkpoint_every=2, max_iter=4)
    assert part.status.value == "iteration_limit" and os.path.exists(ck)

    pt = tgen.random_dense_lp(14, 40, seed=5)
    res = solve(pt, backend=get_backend("cuda", device="cpu"), checkpoint_path=ck,
                checkpoint_every=2)
    assert res.status == Status.OPTIMAL
    assert abs(res.objective - full.objective) <= 1e-8 * (1 + abs(full.objective))
    # Resumed at the checkpoint's iteration: fewer iterations than a cold solve.
    assert res.iterations < full.iterations


def test_interior_form_from_arrays_round_trips_the_jax_form():
    inf_j = jax_interior(jgen.random_dense_lp(8, 20, seed=1))
    inf_t = interop.interior_form_from_arrays(inf_j.A, inf_j.b, inf_j.c, inf_j.u, name=inf_j.name)
    for f in ("A", "b", "c", "u"):
        np.testing.assert_array_equal(getattr(inf_t, f), getattr(inf_j, f))
    x = np.arange(inf_t.n, dtype=np.float64)
    np.testing.assert_array_equal(inf_t.recover(x), x)
    assert inf_t.objective(x) == float(inf_j.c @ x)


def test_state_from_arrays_is_the_inverse_of_to_host():
    rng = np.random.default_rng(2)
    host = IPMState(*(rng.random(n) for n in (6, 3, 6, 6, 6)))
    st = interop.state_from_arrays(*host, device="cpu")
    assert all(v.dtype == torch.float64 and v.device.type == "cpu" for v in st)
    back = get_backend("cuda", device="cpu").to_host(st)
    for a, b in zip(back, host):
        np.testing.assert_array_equal(a, b)


def test_config_from_dict_round_trips_the_jax_config():
    d = dataclasses.asdict(JaxConfig(tol=1e-7, max_iter=33, mesh_shape=(2, 2), use_pallas=False))
    cfg = interop.config_from_dict(d)
    assert isinstance(cfg, SolverConfig)
    assert dataclasses.asdict(cfg) == d
    assert cfg.factor_dtype_resolved() == "float64" and not cfg.two_phase_enabled("cuda")
    with pytest.raises(ValueError):
        interop.config_from_dict({"no_such_field": 1})
