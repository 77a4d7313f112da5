"""``backends/auto.py`` against the JAX package's: the same route from
``choose_backend_name`` on the same inputs — platform ``"cpu"`` on both
sides, and the port's ``"cuda"`` against the reference's ``"tpu"`` (whose
dense accelerator backend is the port's ``cuda``; where the reference
sends a problem from the accelerator to the host, the port keeps it on
the card, ``cuda``) — with and without the structure detection pass; the routes the port has not ported raise and
name their ROADMAP item, the sparse routes set up ``sparse-iterative``; ``AutoBackend(device="cpu")`` solves as the JAX
package's auto does on the CPU; without a card the default device raises.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu.backends.auto import choose_backend_name as jax_choose
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import InteriorForm as JaxInteriorForm
from distributedlpsolver_tpu.models.problem import LPProblem as JaxLP
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_interior
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.backends.auto import AutoBackend, choose_backend_name
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.models.problem import InteriorForm, LPProblem, to_interior_form

PLATFORMS = [("cpu", "cpu"), ("cuda", "tpu")]

# The reference's accelerator routes as the port names them on the card:
# its dense backend, and the card for its host routes (ROADMAP Queue 3).
ON_THE_CARD = {"tpu": "cuda", "cpu-native": "cuda", "cpu-sparse": "cuda"}


def _huge_sparse(cls, seed=0):
    """20,000 equality rows at density ~1e-4: the sparse tier's row wall.
    Built as the interior form directly (standard form already)."""
    m, n = 20_000, 40_000
    rng = np.random.default_rng(seed)
    k = 4 * m
    A = sp.csr_matrix((rng.standard_normal(k), (rng.integers(0, m, k), rng.integers(0, n, k))),
                      shape=(m, n))
    A = (A + sp.eye(m, n, format="csr")).tocsr()
    form = InteriorForm if cls is LPProblem else JaxInteriorForm
    return form(c=np.ones(n), A=A, b=np.asarray(A @ np.ones(n)).ravel(), u=np.full(n, np.inf),
                c0=0.0, orig_n=n, col_kind=np.zeros(n, np.int8), col_orig=np.arange(n),
                col_shift=np.zeros(n), col_sign=np.ones(n), name="huge_sparse")


def _hinted(fn, kind):
    def make(cls):
        p = fn(cls)
        p.block_structure = {"kind": kind, "num_blocks": 2}
        return p
    return make


def _gen(name, *args, **kw):
    """A generator of the JAX package, as a problem of either class."""
    def make(cls):
        jp = getattr(jgen, name)(*args, **kw)
        if cls is JaxLP:
            return jp
        return LPProblem(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(LPProblem)})
    return make


INPUTS = {
    "dense_tiny": _gen("random_general_lp", 27, 51, seed=0),
    "dense_large": _gen("random_dense_lp", 600, 1200, seed=0),
    "sparse_small": _gen("random_sparse_lp", 300, 900, seed=0, density=0.05),
    "block_angular_dense": _gen("block_angular_lp", 8, 96, 256, 64, seed=0, sparse=False),
    "block_angular_sparse": _gen("block_angular_lp", 8, 96, 256, 64, seed=0, sparse=True),
    "two_stage_hint": _hinted(_gen("random_dense_lp", 600, 1200, seed=1), "two_stage"),
    "bordered_hint": _hinted(_gen("random_dense_lp", 600, 1200, seed=2), "bordered"),
    "huge_sparse": _huge_sparse,
}


def _same_hint(ht, hj):
    assert (ht is None) == (hj is None)
    if ht is None:
        return
    assert set(ht) == set(hj)
    for k in ht:
        np.testing.assert_array_equal(np.asarray(ht[k]), np.asarray(hj[k]))


@pytest.fixture(scope="module")
def forms():
    cache = {}

    def get(name):
        if name not in cache:
            pt, pj = INPUTS[name](LPProblem), INPUTS[name](JaxLP)
            if isinstance(pt, LPProblem):
                pt, pj = to_interior_form(pt), jax_interior(pj)
            cache[name] = (pt, pj)
        return cache[name]

    return get


@pytest.mark.parametrize("detect", [False, True])
@pytest.mark.parametrize("platform, jax_platform", PLATFORMS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_route_matches_the_jax_package(forms, name, platform, jax_platform, detect):
    it, ij = forms(name)
    rt, ht = choose_backend_name(it, platform, detect=detect)
    rj, hj = jax_choose(ij, jax_platform, detect=detect)
    assert rt == (ON_THE_CARD.get(rj, rj) if platform == "cuda" else rj)
    _same_hint(ht, hj)


def test_the_routes_cover_every_tier(forms):
    """The inputs above reach each of the reference's routes: on the
    accelerator its host routes too, which the port serves on the card."""
    jax_routes = {jax_choose(forms(n)[1], "tpu", detect=True)[0] for n in INPUTS}
    assert jax_routes == {"cpu-native", "tpu", "cpu-sparse", "block", "scenario", "sparse-iterative"}
    routes = {choose_backend_name(forms(n)[0], "cuda", detect=True)[0] for n in INPUTS}
    assert routes == {"cuda", "block", "scenario", "sparse-iterative"}
    assert {choose_backend_name(forms(n)[0], "cpu")[0] for n in INPUTS} >= {"cpu-native"}


@pytest.mark.parametrize("name, platform, item", [
    ("two_stage_hint", "cpu", "item 11"),
    ("block_angular_dense", "cuda", "item 11"),
])
def test_unported_routes_raise_and_name_their_item(forms, name, platform, item):
    inf, _ = forms(name)
    be = AutoBackend(device="cpu")
    be.device = torch.device(platform)  # the route only reads the device type
    hint = inf.block_structure
    with pytest.raises(NotImplementedError, match=item):
        be.setup(inf, None)
    assert inf.block_structure is hint  # refused before touching the problem


@pytest.mark.parametrize("name, precond", [("huge_sparse", "jacobi"), ("storm", "bordered")])
def test_sparse_routes_set_up_the_sparse_tier(forms, name, precond):
    """A sparse problem at the row wall and a bordered (storm) one go to
    ``sparse-iterative``, as in the reference, and set it up with the
    reference's preconditioner for them."""
    from distributedlpsolver_tpu_torch.backends.sparse_iterative import SparseIterativeBackend
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models.generators import storm_sparse_lp

    inf = forms(name)[0] if name != "storm" else to_interior_form(storm_sparse_lp(4, 16, 24, 8, seed=0))
    assert choose_backend_name(inf, "cpu", detect=True)[0] == "sparse-iterative"
    assert choose_backend_name(inf, "cuda", detect=True)[0] == "sparse-iterative"
    be = AutoBackend(device="cpu")
    be.setup(inf, SolverConfig())
    assert be.name == "auto(sparse-iterative)"
    assert isinstance(be.inner, SparseIterativeBackend) and be.inner.precond == precond


@pytest.mark.parametrize("seed", [4, 5])
def test_auto_on_the_cpu_solves_as_the_jax_auto(seed):
    pj = jgen.random_general_lp(12, 30, seed=seed)
    pt = LPProblem(**{f.name: getattr(pj, f.name) for f in dataclasses.fields(LPProblem)})
    rt = solve(pt, backend=get_backend("auto", device="cpu"))
    rj = jax_solve(pj, backend="auto")
    assert rt.status == Status.OPTIMAL
    assert rt.backend == rj.backend == "auto(cpu-native)"
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-8 * (1 + abs(rj.objective))


def test_the_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(jgen.random_general_lp(12, 30, seed=4))


def test_a_tiny_problem_on_the_card_stays_on_the_card(forms):
    """On a card, ``auto`` keeps the problems the reference sends to the
    host (a tiny dense one to ``cpu-native``, a sparse one to
    ``cpu-sparse``) on the card's ``cuda``; on the CPU the tiny one takes
    the reference's ``cpu-native``."""
    for name, host_route in (("dense_tiny", "cpu-native"), ("sparse_small", "cpu-sparse")):
        it, ij = forms(name)
        assert jax_choose(ij, "tpu", detect=True)[0] == host_route
        assert choose_backend_name(it, "cuda", detect=True) == ("cuda", None)
    assert choose_backend_name(forms("dense_tiny")[0], "cpu") == ("cpu-native", None)


def test_require_cuda_exits_with_code_4_without_a_card(monkeypatch):
    """``utils/accel.py::require_cuda``, the counterpart of the JAX
    package's ``require_tpu``: a measurement that must run on the card
    stops before producing a figure elsewhere."""
    from distributedlpsolver_tpu_torch.utils.accel import REQUIRE_CUDA_EXIT, require_cuda

    assert REQUIRE_CUDA_EXIT == 4
    require_cuda(False)  # disabled: a no-op
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ei:
        require_cuda()
    assert ei.value.code == REQUIRE_CUDA_EXIT
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    require_cuda()
