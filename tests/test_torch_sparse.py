"""The port's hybrid-ELL operator (``ops/sparse.py``, ``ops/ell_spmv.py``)
and sparse generators against the JAX package's, on the CPU.

The same seeded inputs go through both packages: the operator's
``matvec``/``rmatvec``/``normal_diag``/``row_norms``/``col_norms`` agree
to 1e-12 relative (the same products, summed in another order), its
shapes — ELL widths, tail lengths, the dense fallback — are the
reference's (they decide the results), ``scaled`` and
``ruiz_equilibrate`` agree to 1e-12, the storm transpose rides the tail,
and the generators give the reference's instances bit for bit. A sparse
MPS file stays sparse from ``read_mps`` through presolve and scaling, and
solves on ``sparse-iterative`` to the JAX package's objective.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.ops import sparse as jsparse
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.ops import ell_normal_diag, ell_spmv
from distributedlpsolver_tpu_torch.ops import sparse as tsparse
from distributedlpsolver_tpu_torch.ops.ell_spmv import (
    CHUNK,
    HEAVY_MIN,
    EllTail,
    ell_spmv_reference,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# The operator's maps against the JAX package's: the same products, summed
# in another order.
OP_TOL = 1e-12

PROBLEMS = {
    "storm": lambda: jgen.storm_sparse_lp(16, 32, 48, 24, seed=0),
    "netlib": lambda: jgen.netlib_sparse_lp(400, 700, seed=1),
}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _both(A):
    return tsparse.from_scipy(A), jsparse.from_scipy(A)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_operator_maps_match_the_jax_operator(name):
    A = PROBLEMS[name]().A.tocsr()
    top, jop = _both(A)
    assert top.fmt == jop.fmt == "ell"
    rng = np.random.default_rng(0)
    v, w = rng.standard_normal(A.shape[1]), rng.standard_normal(A.shape[0])
    d = rng.uniform(0.5, 2.0, A.shape[1])
    T = torch.from_numpy
    assert _rel(top.matvec(T(v)), jop.matvec(jnp.asarray(v))) <= OP_TOL
    assert _rel(top.rmatvec(T(w)), jop.rmatvec(jnp.asarray(w))) <= OP_TOL
    assert _rel(top.normal_diag(T(d), 1e-3), jop.normal_diag(jnp.asarray(d), 1e-3)) <= OP_TOL
    assert _rel(top.row_norms(), jop.row_norms()) <= OP_TOL
    assert _rel(top.col_norms(), jop.col_norms()) <= OP_TOL
    # And against dense algebra, and the exact CSR round trip.
    Ad = A.toarray()
    assert _rel(top.matvec(T(v)), Ad @ v) <= OP_TOL
    assert _rel(top.normal_diag(T(d)), np.einsum("ij,j,ij->i", Ad, d, Ad)) <= OP_TOL
    assert (top.to_scipy() != A).nnz == 0


@pytest.mark.parametrize("name", list(PROBLEMS) + ["storm_heavy"])
def test_operator_shapes_are_the_jax_operators(name):
    """ELL widths, tail lengths and the stored arrays are the reference's
    bit for bit (they decide the shapes, and so the results)."""
    p = jgen.storm_sparse_lp(64, 32, 48, 24, seed=2) if name == "storm_heavy" else PROBLEMS[name]()
    top, jop = _both(p.A.tocsr())
    for f in ("vals", "cols", "tail_vals", "tail_rows", "tail_cols",
              "tvals", "tcols", "ttail_vals", "ttail_rows", "ttail_cols"):
        a, b = getattr(top, f), getattr(jop, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert top.memory_report()["vals"] == jop.memory_report()["vals"]


def test_storm_transpose_rides_the_tail_not_the_width():
    p = tgen.storm_sparse_lp(64, 32, 48, 24, seed=2)
    op = tsparse.from_scipy(p.A)
    assert op.tvals.shape[1] <= 32 and op.ttail_vals is not None
    assert op.nbytes() < 0.05 * op.m * op.n * 8
    # The kernel's index: every first-stage column, and no other, is a
    # heavy transpose row, cut into chunks of CHUNK entries.
    counts = np.diff(p.A.tocsc().indptr)
    lay = op.tsell
    assert lay.heavy_rows.tolist() == np.flatnonzero(counts > HEAVY_MIN).tolist() == list(range(24))
    np.testing.assert_array_equal(np.diff(lay.heavy_first.numpy()), -(-counts[:24] // CHUNK))
    assert op.sell.n_heavy == 0 and lay.n_slices == -(-(op.n - 24) // 32)


@pytest.mark.parametrize("square", [False, True])
def test_plain_version_is_the_dense_product(square):
    """The wrappers on CPU tensors (the plain version) on a hand-built
    hybrid with a tail, against dense algebra; the CPU path never counts
    a launch."""
    rng = np.random.default_rng(3)
    A = sp.random(40, 30, density=0.2, random_state=3, format="lil")
    A[5] = rng.standard_normal(30)  # one row far wider than the ELL width
    A = A.tocsr()
    h = tsparse._hybrid_tensors(A.tocsr(), np.float64, torch.device("cpu"))
    vals, cols = h["vals"], h["cols"]
    tail = EllTail(h["tail_vals"], h["tail_rows"], h["tail_cols"])
    assert vals.shape[1] < 30  # row 5 spills into the tail
    x = torch.from_numpy(rng.uniform(0.5, 2.0, 30))
    before = (ell_spmv.launches, ell_spmv.launches_t, ell_normal_diag.launches)
    Ad = A.toarray()
    if square:
        got, want = ell_normal_diag(vals, cols, x, tail, reg=0.25), (Ad * Ad) @ x.numpy() + 0.25
    else:
        got, want = ell_spmv(vals, cols, x, tail), Ad @ x.numpy()
    assert _rel(got, want) <= OP_TOL
    assert _rel(ell_spmv_reference(vals, cols, x, tail, square=square, reg=0.25 if square else 0.0),
                want) <= OP_TOL
    assert (ell_spmv.launches, ell_spmv.launches_t, ell_normal_diag.launches) == before


def test_scaled_and_ruiz_match_the_jax_operator():
    A = jgen.storm_sparse_lp(16, 32, 48, 24, seed=4).A.tocsr()
    top, jop = _both(A)
    rng = np.random.default_rng(1)
    dr, dc = rng.uniform(0.5, 2.0, top.m), rng.uniform(0.5, 2.0, top.n)
    v = rng.standard_normal(top.n)
    got = top.scaled(dr, dc).matvec(torch.from_numpy(v))
    assert _rel(got, jop.scaled(dr, dc).matvec(jnp.asarray(v))) <= OP_TOL
    assert _rel(got, (dr[:, None] * A.toarray() * dc[None, :]) @ v) <= OP_TOL
    sop, rr, cc = tsparse.ruiz_equilibrate(top)
    jsop, jrr, jcc = jsparse.ruiz_equilibrate(jop)
    assert _rel(rr, jrr) <= OP_TOL and _rel(cc, jcc) <= OP_TOL
    S = sop.to_scipy()
    rmax = np.abs(S).max(axis=1).toarray().ravel()
    assert np.all(np.abs(rmax[rmax > 0] - 1.0) < 0.1)
    np.testing.assert_allclose(S.toarray(), rr[:, None] * A.toarray() * cc[None, :], atol=1e-10)


def test_dense_fallback_matches_the_jax_operator():
    rng = np.random.default_rng(2)
    Ad = rng.standard_normal((12, 20))
    top, jop = _both(sp.csr_matrix(Ad))
    assert top.fmt == jop.fmt == "dense" and "dense" in top.memory_report()
    v, w = rng.standard_normal(20), rng.standard_normal(12)
    assert _rel(top.matvec(torch.from_numpy(v)), jop.matvec(jnp.asarray(v))) <= OP_TOL
    assert _rel(top.rmatvec(torch.from_numpy(w)), Ad.T @ w) <= OP_TOL
    assert _rel(top.normal_diag(torch.from_numpy(np.abs(v)), 0.5),
                jop.normal_diag(jnp.asarray(np.abs(v)), 0.5)) <= OP_TOL
    sop, rr, cc = tsparse.ruiz_equilibrate(top)
    _, jrr, jcc = jsparse.ruiz_equilibrate(jop)
    assert _rel(rr, jrr) <= OP_TOL and _rel(cc, jcc) <= OP_TOL


def test_from_scipy_takes_the_dtype_and_device():
    A = tgen.netlib_sparse_lp(200, 360, seed=5).A
    op = tsparse.from_scipy(A, dtype=np.float32, device="cpu")
    assert op.dtype == torch.float32 and op.device.type == "cpu"
    assert op.cols.dtype == torch.int32 and op.tsell.index.dtype == torch.int32
    assert op.sell.vals.dtype == op.tsell.partials.dtype == torch.float32
    v = np.random.default_rng(0).standard_normal(A.shape[1])
    # f32 products against f64 dense algebra (the rounding of f32).
    assert _rel(op.matvec(torch.from_numpy(v).float()), A @ v) <= 1e-5


# -- generators ----------------------------------------------------------------


@pytest.mark.parametrize("gen, args", [
    ("storm_sparse_lp", (8, 16, 24, 16)),
    ("storm_sparse_lp", (6, 20, 30, 10)),
    ("netlib_sparse_lp", (300, 500)),
])
def test_generators_give_the_jax_instances_bit_for_bit(gen, args):
    for seed in (21, 22):
        a = getattr(tgen, gen)(*args, seed=seed)
        b = getattr(jgen, gen)(*args, seed=seed)
        assert (a.A != b.A).nnz == 0 and a.A.dtype == b.A.dtype
        for f in ("c", "rlb", "rub", "lb", "ub"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.name == b.name and a.block_structure == b.block_structure
    c = getattr(tgen, gen)(*args, seed=23)
    assert (getattr(tgen, gen)(*args, seed=21).A != c.A).nnz != 0


def test_netlib_generator_is_heavy_tailed_and_storm_bordered():
    a = tgen.netlib_sparse_lp(300, 500, seed=23)
    counts = np.diff(a.A.tocsc().indptr)
    assert counts.max() >= 3 * np.median(counts)
    assert tgen.storm_sparse_lp(8, 16, 24, 16, seed=21).block_structure["kind"] == "bordered"


# -- sparse-preserving ingest --------------------------------------------------


def test_mps_round_trip_keeps_sparsity_and_solves(tmp_path):
    """A storm file with m·n > 200,000 is read as CSR, stays sparse through
    the interior form, presolve and Ruiz scaling, and solves on
    ``sparse-iterative`` (CPU) to the JAX package's objective (1e-8
    relative)."""
    from distributedlpsolver_tpu.io.mps import read_mps as jread
    from distributedlpsolver_tpu.ipm import driver as jdriver
    from distributedlpsolver_tpu_torch.backends import get_backend
    from distributedlpsolver_tpu_torch.io import read_mps, write_mps
    from distributedlpsolver_tpu_torch.ipm import solve
    from distributedlpsolver_tpu_torch.models import presolve, to_interior_form
    from distributedlpsolver_tpu_torch.models.scaling import equilibrate

    p = tgen.storm_sparse_lp(12, 32, 48, 24, seed=27)  # 384 × 600: m·n = 230,400
    path = tmp_path / "storm.mps"
    write_mps(p, path)
    q = read_mps(path)
    assert sp.issparse(q.A) and q.A.nnz == p.A.nnz
    reduced, info = presolve(q)
    assert sp.issparse(reduced.A)
    inf = to_interior_form(reduced)
    assert sp.issparse(inf.A) and sp.issparse(equilibrate(inf)[0].A)
    q.block_structure = p.block_structure
    be = get_backend("sparse-iterative", device="cpu")
    r = solve(q, backend=be, tol=1e-8)
    assert r.status.value == "optimal" and be.cg_report()["precond"] == "bordered"
    qj = jread(path)
    qj.block_structure = p.block_structure
    rj = jdriver.solve(qj, backend="sparse-iterative", tol=1e-8)
    assert r.iterations == rj.iterations
    assert abs(r.objective - rj.objective) <= 1e-8 * (1 + abs(rj.objective))


# -- the kernels' build ------------------------------------------------------


def test_build_runs_one_nvcc_per_source_and_raises_kernel_errors(tmp_path):
    """``ops/kernel_build.py`` with a stand-in for nvcc (this machine has
    none): every missing library is built by its own process, the build
    reports its seconds and ptxas lines, a built library is not built
    again, and every failure is a ``KernelError``."""
    import os
    import stat

    from distributedlpsolver_tpu_torch.ops import kernel_build
    from distributedlpsolver_tpu_torch.ops.kernel_build import KernelError

    def fake_nvcc(body):
        path = tmp_path / f"nvcc_{abs(hash(body))}"
        path.write_text("#!/bin/sh\n" + body)
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
        return lambda: str(path)

    writes = fake_nvcc('while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out=$2; shift; done\n'
                       'echo "ptxas info    : Used 32 registers" >&2\n: > "$out"\n')
    srcs = []
    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
        srcs.append(str(tmp_path / name))
    infos = [{}, {}]
    jobs = [(src, f"lib{i}", str(tmp_path / "build"), writes, info)
            for i, (src, info) in enumerate(zip(srcs, infos))]
    assert kernel_build.build(*jobs) == [info["path"] for info in infos]
    for info in infos:
        assert os.path.exists(info["path"]) and info["seconds"] >= 0.0
        assert info["ptxas"] == ["ptxas info    : Used 32 registers"]
    again = {}
    assert kernel_build.build((srcs[0], "lib0", str(tmp_path / "build"), writes, again)) == [infos[0]["path"]]
    assert "seconds" not in again  # found, not rebuilt

    (tmp_path / "c.cu").write_text("// c\n")
    fails = fake_nvcc('echo "error: no" >&2\nexit 3\n')
    with pytest.raises(KernelError, match="exit 3"):
        kernel_build.build((str(tmp_path / "c.cu"), "libc", str(tmp_path / "build"), fails, {}))

    def missing():
        raise RuntimeError("no toolkit")

    with pytest.raises(KernelError, match="no toolkit"):
        kernel_build.build((str(tmp_path / "c.cu"), "libc", str(tmp_path / "build"), missing, {}))
    with pytest.raises(KernelError, match="cannot load"):
        kernel_build.open_library(str(tmp_path / "nothing.so"))
