"""The port's block-angular Schur backend (``block``/``schur``/
``block-angular``) against the JAX package's, on the CPU
(``device="cpu"``, the normal-equations kernel's plain version).

* The generator gives the reference's problem bit for bit.
* ``analyze_structure`` and the host tensors match the reference's on
  both hint formats (uniform, and ``row_block`` with the rows shuffled
  and the blocks ragged), the JAX ``BlockTensors`` mapped through
  ``interop.block_tensors_from_arrays``.
* ``matvec``, ``rmatvec``, ``factorize`` and ``solve`` match the JAX
  ``_block_ops`` at ≤1e-12 on the same d and r (the linking matrix is
  summed in another order here, so not bit for bit).
* Whole solves end with the JAX ``block`` backend's status and iterations
  and its objective within 1e-8, and within 1e-7 of HiGHS run at 1e-10
  feasibility; the segmented and host loops give the fused loop's x, and
  two solves the same bits.
* The reference's refusals (missing hint, a column across two blocks) and
  the port's own (pcg) raise; ``mesh=``, ``mesh_shape`` and ``reshard``
  run; ``cli generate block`` writes
  a file that ``cli solve --backend block`` refuses for its missing hint,
  as the reference's CLI does, and ``auto`` solves; a supervised solve
  runs on the tier.
"""

import json

import numpy as np
import pytest
import scipy.optimize as sopt
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu import cli as jcli
from distributedlpsolver_tpu.backends import block_angular as jba
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_interior
from distributedlpsolver_tpu_torch import cli, interop
from distributedlpsolver_tpu_torch.backends import block_angular as tba
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.problem import to_interior_form
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
OBJ_TOL = 1e-8
OPS_TOL = 1e-12
# Whole solves: the reference's test shapes (tests/test_block_angular.py)
# and bench.py's quick block-angular case.
SOLVE_CASES = [(4, 12, 30, 8), (6, 10, 25, 5), (4, 24, 48, 12)]


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


def _block():
    return get_backend("block", device=CPU)


def _highs(p):
    """HiGHS's optimum of a block-angular problem (equality block rows,
    ≤ linking rows), at 1e-10 feasibility."""
    A = sp.csr_matrix(p.A)
    eq = p.rlb == p.rub
    res = sopt.linprog(p.c, A_eq=A[eq], b_eq=p.rub[eq], A_ub=A[~eq], b_ub=p.rub[~eq],
                       bounds=(0, None), method="highs",
                       options={"primal_feasibility_tolerance": 1e-10,
                                "dual_feasibility_tolerance": 1e-10})
    assert res.status == 0, res.message
    return res.fun


def _ragged(jinf, seed=5):
    """The JAX package's interior form with a ``row_block`` hint: the rows
    shuffled, two blocks' rows cut short (ragged sizes), the hint
    rewritten to match; and the port's form of the same arrays and hint
    through ``interop.interior_form_from_arrays``. For structure and
    operator checks only (the cut problem need not be bounded)."""
    hint = jinf.block_structure
    K, mb, link = hint["num_blocks"], hint["block_m"], hint["link_m"]
    row_block = np.concatenate([np.repeat(np.arange(K), mb), np.full(link, -1)])
    keep = np.ones(jinf.m, bool)
    keep[[mb + 1, mb + 4, 3 * mb, 3 * mb + 2, 3 * mb + 7]] = False
    order = np.random.default_rng(seed).permutation(np.flatnonzero(keep))
    ragged = {"num_blocks": K, "row_block": row_block[order]}
    A, b = sp.csr_matrix(jinf.A)[order], jinf.b[order]
    jform = type(jinf)(
        c=jinf.c, A=A, b=b, u=jinf.u, c0=jinf.c0, orig_n=jinf.orig_n,
        col_kind=jinf.col_kind, col_orig=jinf.col_orig, col_shift=jinf.col_shift,
        col_sign=jinf.col_sign, name=jinf.name, block_structure=ragged,
    )
    tform = interop.interior_form_from_arrays(A, b, jinf.c, jinf.u, jinf.name,
                                              block_structure=ragged)
    return tform, jform


def _forms(fmt):
    args = (5, 12, 30, 6)
    pt = tgen.block_angular_lp(*args, seed=4, sparse=True, density=0.3)
    pj = jgen.block_angular_lp(*args, seed=4, sparse=True, density=0.3)
    return _ragged(jax_interior(pj)) if fmt == "row_block" else (to_interior_form(pt), jax_interior(pj))


@pytest.mark.parametrize("sparse", [False, True])
def test_generator_is_the_reference(sparse):
    pt = tgen.block_angular_lp(4, 12, 30, 8, seed=3, sparse=sparse)
    pj = jgen.block_angular_lp(4, 12, 30, 8, seed=3, sparse=sparse)
    At = pt.A.toarray() if sparse else pt.A
    Aj = pj.A.toarray() if sparse else pj.A
    assert sp.issparse(pt.A) == sp.issparse(pj.A) == sparse
    assert np.array_equal(At, Aj)
    for f in ("c", "rlb", "rub", "lb", "ub"):
        assert np.array_equal(getattr(pt, f), getattr(pj, f))
    assert pt.name == pj.name and pt.block_structure == pj.block_structure


@pytest.mark.parametrize("fmt", ["uniform", "row_block"])
def test_structure_and_tensors_are_the_reference(fmt):
    it, ij = _forms(fmt)
    lay, info = tba.analyze_structure(it)
    jlay, jinfo = jba.analyze_structure(ij)
    assert tuple(lay) == tuple(jlay)
    assert np.array_equal(info["block_of_col"], jinfo["block_of_col"])
    if fmt == "row_block":
        assert lay.mb == 12 and lay.link == 6  # the largest block, uncut
    jt, _ = jba.build_tensors(ij, np.float64)
    ref, ref_lay = interop.block_tensors_from_arrays(*(np.asarray(a) for a in jt), jlay,
                                                     device=CPU)
    t, t_lay = tba.build_tensors(it, torch.float64, CPU)
    assert t_lay == ref_lay
    for name in tba.BlockTensors._fields:
        assert torch.equal(getattr(t, name), getattr(ref, name)), name
    # L_cat holds the reference's L_all and A0, blocks first.
    K, mb, nb, link, n0, n, m = lay
    L_all = t.L_cat[:, : K * nb].reshape(link, K, nb).permute(1, 0, 2)
    assert np.array_equal(L_all.numpy(), np.asarray(jt.L_all))
    assert np.array_equal(t.L_cat[:, K * nb:].numpy(), np.asarray(jt.A0))


@pytest.mark.parametrize("fmt", ["uniform", "row_block"])
def test_ops_match_the_reference(fmt):
    import jax.numpy as jnp

    it, ij = _forms(fmt)
    jt, jlay = jba.build_tensors(ij, np.float64)
    t, lay = tba.build_tensors(it, torch.float64, CPU)
    reg = 1e-9
    jops = jba._block_ops(jt, jlay, jnp.asarray(reg), jnp.float64)
    ops = tba._block_ops(t, lay, reg)
    rng = np.random.default_rng(11)
    x, y = rng.standard_normal(lay.n), rng.standard_normal(lay.m)
    d, r = np.exp(rng.uniform(-4, 4, lay.n)), rng.standard_normal(lay.m)

    def close(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert np.linalg.norm(a - b) <= OPS_TOL * np.linalg.norm(b), (
            np.linalg.norm(a - b) / np.linalg.norm(b))

    tt = lambda v: torch.as_tensor(v, dtype=torch.float64)
    close(ops.matvec(tt(x)).numpy(), jops.matvec(jnp.asarray(x)))
    close(ops.rmatvec(tt(y)).numpy(), jops.rmatvec(jnp.asarray(y)))
    # The operators agree with A itself on the interior form.
    A = sp.csr_matrix(it.A)
    close(ops.matvec(tt(x)).numpy(), A @ x)
    close(ops.rmatvec(tt(y)).numpy(), A.T @ y)
    fac = ops.factorize(tt(d))
    jfac = jops.factorize(jnp.asarray(d))
    Lk, Ls, GT = (f.numpy() for f in fac)
    jLk, jLs, jGk = (np.asarray(f) for f in jfac)
    close(Lk, jLk)
    close(Ls, jLs)
    close(GT.transpose(0, 2, 1), jGk)
    sol = ops.solve(fac, tt(r)).numpy()
    close(sol, jops.solve(jfac, jnp.asarray(r)))
    # Unregularized, the solve inverts A·D·Aᵀ on the interior form.
    ops0 = tba._block_ops(t, lay, 0.0)
    M = (A.multiply(d) @ A.T).toarray()
    res = M @ ops0.solve(ops0.factorize(tt(d)), tt(r)).numpy() - r
    assert np.linalg.norm(res) <= 1e-10 * np.linalg.norm(r)


def _pair_solve(args, seed=1, sparse=False, **kw):
    pt = tgen.block_angular_lp(*args, seed=seed, sparse=sparse)
    pj = jgen.block_angular_lp(*args, seed=seed, sparse=sparse)
    be = _block()
    r = solve(pt, backend=be, tol=1e-8, **kw)
    rj = jax_solve(pj, backend="block", tol=1e-8, **kw)
    return pt, r, rj, be


@pytest.mark.parametrize("args", SOLVE_CASES)
def test_solve_matches_jax_and_highs(args):
    p, r, rj, be = _pair_solve(args)
    assert r.status == Status.OPTIMAL and rj.status.value == "optimal"
    assert r.iterations == rj.iterations
    assert _rel(r.objective, rj.objective) <= OBJ_TOL
    assert _rel(r.objective, _highs(p)) <= 1e-7
    assert r.backend == "block"
    row = be.phase_report[0]
    assert row["mode"] == "f64" and row["iters"] == r.iterations
    assert row["bodies"] >= r.iterations and row["flops_per_iter"] > 0


def test_sparse_input_accepted():
    p, r, rj, _ = _pair_solve((4, 10, 24, 6), seed=2, sparse=True)
    assert sp.issparse(p.A)
    assert r.status == Status.OPTIMAL and r.iterations == rj.iterations
    assert _rel(r.objective, rj.objective) <= OBJ_TOL
    assert _rel(r.objective, _highs(p)) <= 1e-7


@pytest.mark.parametrize("loop", [{"segment_iters": 4}, {"fused_loop": False}])
def test_other_loops_give_the_fused_loops_x(loop):
    p = tgen.block_angular_lp(4, 12, 30, 8, seed=1, sparse=False)
    r = solve(p, backend=_block(), tol=1e-8)
    r2 = solve(p, backend=_block(), tol=1e-8, **loop)
    assert r2.status == r.status and r2.iterations == r.iterations
    assert np.array_equal(r2.x, r.x)


def test_two_solves_bit_for_bit():
    p = tgen.block_angular_lp(6, 10, 25, 5, seed=1, sparse=True)
    a = solve(p, backend=_block(), tol=1e-8)
    b = solve(p, backend=_block(), tol=1e-8)
    assert a.status == Status.OPTIMAL and np.array_equal(a.x, b.x)
    assert a.objective == b.objective and a.iterations == b.iterations


def test_missing_hint_raises_as_the_reference():
    pt, pj = tgen.random_dense_lp(10, 20, seed=0), jgen.random_dense_lp(10, 20, seed=0)
    with pytest.raises(ValueError, match="block_structure"):
        jba.analyze_structure(jax_interior(pj))
    with pytest.raises(ValueError, match="block_structure"):
        tba.analyze_structure(to_interior_form(pt))


def test_cross_block_column_raises_as_the_reference():
    msgs = []
    for gen, conv, mod in ((jgen, jax_interior, jba), (tgen, to_interior_form, tba)):
        p = gen.block_angular_lp(3, 8, 16, 4, seed=0, sparse=False)
        A = np.asarray(p.A).copy()
        A[0, 17] = 1.0  # a block-0 row's entry in a block-1 column
        p.A = A
        with pytest.raises(ValueError, match="spans blocks") as e:
            mod.analyze_structure(conv(p))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_names_and_device():
    for name in ("block", "schur", "block-angular"):
        be = get_backend(name, device=CPU)
        assert isinstance(be, tba.BlockAngularBackend) and be.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_backend("block")


@pytest.mark.parametrize("what", ["mesh", "mesh_shape", "pcg", "reshard"])
def test_unported_modes_name_their_item(what):
    """``pcg`` is still refused, naming item 5b. The mesh cases were
    item 13e's refusals and now run (``test_torch_block_mesh.py`` holds them
    against the JAX package): ``mesh=`` solves, ``mesh_shape`` runs
    unsharded as the reference does, and ``reshard`` returns a fresh
    backend on the given mesh."""
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    p = tgen.block_angular_lp(3, 6, 12, 3, seed=0, sparse=False)
    inf = to_interior_form(p)
    mesh = mesh_lib.make_mesh(axis_names=("blocks",), devices=[CPU] * 2)
    if what == "pcg":
        with pytest.raises(NotImplementedError, match="item 5b"):
            _block().setup(inf, SolverConfig(solve_mode="pcg"))
    elif what == "mesh":
        be = tba.BlockAngularBackend(mesh=mesh)
        r = solve(p, backend=be, tol=1e-8)
        assert r.status == Status.OPTIMAL and be.mesh is mesh and be.layout.K == 4
    elif what == "mesh_shape":
        be = _block()
        be.setup(inf, SolverConfig(mesh_shape=(2,)))
        assert be.mesh is None and be.layout.K == 3
    else:
        be = _block()
        new = be.reshard(mesh)
        assert isinstance(new, tba.BlockAngularBackend) and new is not be
        assert new.mesh is mesh and new.device.type == "cpu"


def test_cli_generate_block_then_solve(tmp_path, capsys):
    """The MPS file carries no hint: ``--backend block`` refuses it as the
    reference's CLI does, and ``auto`` on the CPU solves it on the
    reference's CPU route (on the card ``auto`` finds the blocks:
    ``test_torch_auto.py``)."""
    path = str(tmp_path / "blk.mps")
    assert cli.main(["generate", "block", path, "--blocks", "4", "--m", "12", "--n", "30",
                     "--link", "8", "--seed", "2"]) == 0
    capsys.readouterr()
    for main in (cli.main, jcli.main):
        with pytest.raises(ValueError, match="block_structure"):
            main(["solve", path, "--backend", "block", "--quiet"] + (
                ["--device", "cpu"] if main is cli.main else []))
    assert cli.main(["solve", path, "--device", "cpu", "--json", "--quiet"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = jax_solve(jgen.block_angular_lp(4, 12, 30, 8, seed=2), backend="block", tol=1e-8)
    assert out["status"] == "optimal" and out["backend"] == "auto(cpu-native)"
    assert _rel(out["objective"], ref.objective) <= OBJ_TOL


def test_supervised_solve_over_the_block_tier():
    from distributedlpsolver_tpu_torch.supervisor import supervised_solve

    p = tgen.block_angular_lp(4, 12, 30, 8, seed=1, sparse=False)
    r = supervised_solve(p, backend=_block(), tol=1e-8)
    ref = solve(p, backend=_block(), tol=1e-8)
    assert r.status == Status.OPTIMAL and not r.faults
    assert r.iterations == ref.iterations and _rel(r.objective, ref.objective) <= 1e-12
