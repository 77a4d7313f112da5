"""The sliced-ELL layout of the port's ELL kernel (``ops/ell_spmv.py::
sell_layout``, built by ``ops/sparse.py::from_scipy``) on the CPU.

The card's kernel cannot run here, so its layout and its order of
summation are held here: every live entry of the CSR sits in the layout
once, in CSR order within its row, and every pad is zero; the light rows
are a permutation sorted by live count within windows; the heavy rows'
chunks cover each heavy row once, in order. A plain walk of the layout in
the kernel's order (a thread's slots of a row; a lane's entries of a
chunk, the xor-butterfly, then the chunks in order) equals the plain
version ``ell_spmv_reference`` and the JAX package's operator on the same
numpy inputs, before and after ``scaled`` and ``ruiz_equilibrate``, and on
matrices at the layout's edges.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.ops import sparse as jsparse
from distributedlpsolver_tpu_torch.ops import sparse as tsparse
from distributedlpsolver_tpu_torch.ops.ell_spmv import (
    CHUNK,
    HEAVY_MIN,
    SLICE,
    WINDOW,
    ell_normal_diag,
    ell_spmv,
    ell_spmv_reference,
    sell_layout,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# The walk against the plain version and the JAX operator: the same
# products summed in another order.
OP_TOL = 1e-12


def _ragged():
    """1,100 × 2,300 (ragged slices in both directions), empty rows and a
    column with no entry, two rows and two columns over several chunks."""
    A = sp.random(1100, 2300, density=0.003, random_state=11, format="lil")
    rng = np.random.default_rng(11)
    for i in (0, 650):
        A[i] = rng.standard_normal(2300)
    for j in (7, 2299):
        A[:, j] = rng.standard_normal((1100, 1))
    A[[10, 11, 1099]] = 0.0
    A[:, 400] = 0.0
    A = A.tocsr()
    A.eliminate_zeros()
    return A


MATRICES = {
    "storm": lambda: jgen.storm_sparse_lp(16, 32, 48, 24, seed=0).A.tocsr(),
    "storm_heavy": lambda: jgen.storm_sparse_lp(64, 32, 48, 24, seed=2).A.tocsr(),
    "netlib": lambda: jgen.netlib_sparse_lp(400, 700, seed=1).A.tocsr(),
    "ragged": _ragged,
}
DIRECTIONS = ("A", "AT")


def _layout(name, direction):
    A = MATRICES[name]()
    op = tsparse.from_scipy(A)
    return (op.sell, A) if direction == "A" else (op.tsell, A.T.tocsr())


def _slots(lay):
    """Row and position within the row of every slot of ``lay`` (row -1:
    a pad lane)."""
    sp_ = lay.slice_ptr.long()
    width = (sp_[1:] - sp_[:-1]) // SLICE
    s = torch.repeat_interleave(torch.arange(lay.n_slices), width * SLICE)
    pos = torch.arange(s.numel()) - sp_[s]
    rows = [lay.perm.long()[s * SLICE + pos % SLICE]]
    js = [pos // SLICE]
    cp = lay.chunk_ptr.long()
    c = torch.repeat_interleave(torch.arange(lay.n_chunks), cp[1:] - cp[:-1])
    h = lay.chunk_row.long()[c]
    rows.append(lay.heavy_rows.long()[h])
    js.append(torch.arange(cp[0], cp[-1]) - cp[lay.heavy_first.long()[h]])
    return torch.cat(rows), torch.cat(js)


def _walk(lay, v, square=False, reg=0.0):
    """The kernel's arithmetic in its order: each light row's slots in
    order; each heavy chunk's lanes (entries lane, lane + 32, ...), their
    xor-butterfly, then a row's chunk partials in chunk order."""
    term = (lambda a, x: a * a * x) if square else (lambda a, x: a * x)
    out = torch.full((lay.rows,), float("nan"), dtype=v.dtype)
    sp_ = lay.slice_ptr.long()
    width = (sp_[1:] - sp_[:-1]) // SLICE
    acc = torch.zeros(lay.n_slices, SLICE, dtype=v.dtype)
    lane = torch.arange(SLICE)
    for j in range(int(width.max()) if lay.n_slices else 0):
        sel = width > j
        idx = sp_[:-1][sel, None] + j * SLICE + lane
        acc[sel] += term(lay.vals[idx], v[lay.cols[idx].long()])
    perm = lay.perm.long()
    live = perm >= 0
    out[perm[live]] = acc.flatten()[live] + reg
    cp = lay.chunk_ptr.long()
    parts = []
    for c in range(lay.n_chunks):
        e = torch.arange(cp[c], cp[c + 1])
        rounds = -(-e.numel() // 32)
        a = torch.zeros(rounds * 32, dtype=v.dtype)
        x = torch.zeros(rounds * 32, dtype=v.dtype)
        a[: e.numel()] = lay.vals[e]
        x[: e.numel()] = v[lay.cols[e].long()]
        lanes = torch.zeros(32, dtype=v.dtype)
        for r in range(rounds):
            lanes = lanes + term(a[r * 32:(r + 1) * 32], x[r * 32:(r + 1) * 32])
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[lane ^ off]
        parts.append(lanes[0])
    hf = lay.heavy_first.long()
    for h in range(lay.n_heavy):
        s = parts[hf[h]]
        if hf[h + 1] - hf[h] > 1:
            s = torch.zeros((), dtype=v.dtype)
            for k in range(hf[h], hf[h + 1]):
                s = s + parts[k]
        out[lay.heavy_rows[h]] = s + reg
    return out


def _hybrid_csr(vals, cols, tail, shape):
    """The CSR of one direction of the hybrid (ELL slots, then the tail, in
    the CSR order both were filled in), pads (value 0; these matrices store
    no zero) dropped."""
    m, k = vals.shape
    live = vals.numpy() != 0
    rows = [np.repeat(np.arange(m), k)[live.ravel()]]
    data, idx = [vals.numpy()[live]], [cols.numpy()[live]]
    if tail is not None:
        t = tail.rows.numpy() < m
        rows.append(tail.rows.numpy()[t])
        data.append(tail.vals.numpy()[t])
        idx.append(tail.cols.numpy()[t])
    rows, data, idx = (np.concatenate(a) for a in (rows, data, idx))
    order = np.argsort(rows, kind="stable")
    return sp.csr_matrix((data[order], idx[order], np.searchsorted(rows[order], np.arange(m + 1))),
                         shape=shape)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_layout_holds_every_live_entry_once_and_pads_are_zero(name, direction):
    lay, A = _layout(name, direction)
    rows, js = _slots(lay)
    assert rows.numel() == lay.vals.numel() == lay.cols.numel()
    counts = torch.from_numpy(np.diff(A.indptr)).long()
    live = (rows >= 0) & (js < counts[rows.clamp(min=0)])
    assert int(live.sum()) == A.nnz
    assert not lay.vals[~live].any() and not lay.cols[~live].any()
    src = torch.from_numpy(A.indptr).long()[rows[live]] + js[live]
    assert torch.unique(src).numel() == A.nnz  # each entry once
    np.testing.assert_array_equal(lay.vals[live].numpy(), A.data[src.numpy()])
    np.testing.assert_array_equal(lay.cols[live].numpy(), A.indices[src.numpy()])


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_light_rows_are_a_permutation_sorted_within_windows(name, direction):
    lay, A = _layout(name, direction)
    counts = np.diff(A.indptr)
    light = np.flatnonzero(counts <= HEAVY_MIN)
    perm = lay.perm.numpy()
    assert perm.size == SLICE * lay.n_slices == SLICE * -(-light.size // SLICE)
    assert (perm[light.size:] == -1).all()
    order = perm[: light.size]
    assert sorted(order.tolist()) == light.tolist()
    assert set(order.tolist()).isdisjoint(lay.heavy_rows.tolist())
    for w0 in range(0, light.size, WINDOW):
        assert sorted(order[w0:w0 + WINDOW].tolist()) == light[w0:w0 + WINDOW].tolist()
        assert (np.diff(counts[order[w0:w0 + WINDOW]]) <= 0).all()
    # Each slice is padded to its own widest row, no more.
    lens = np.zeros(perm.size, dtype=np.int64)
    lens[: light.size] = counts[order]
    np.testing.assert_array_equal(np.diff(lay.slice_ptr.numpy()),
                                  SLICE * lens.reshape(-1, SLICE).max(axis=1, initial=0))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_heavy_chunks_cover_each_heavy_row_once_in_order(name, direction):
    lay, A = _layout(name, direction)
    counts = np.diff(A.indptr)
    heavy = np.flatnonzero(counts > HEAVY_MIN)
    assert lay.heavy_rows.tolist() == heavy.tolist() and lay.n_heavy == heavy.size
    cp, hf = lay.chunk_ptr.numpy(), lay.heavy_first.numpy()
    assert cp[0] == lay.slice_ptr.numpy()[-1] and cp[-1] == lay.vals.numel()
    assert (lay.chunk_row.numpy() == np.repeat(np.arange(heavy.size), np.diff(hf))).all()
    for h, r in enumerate(heavy):
        lens = np.diff(cp[hf[h]:hf[h + 1] + 1])
        assert lens.sum() == counts[r] and (lens[:-1] == CHUNK).all() and 0 < lens[-1] <= CHUNK
        e = np.arange(cp[hf[h]], cp[hf[h + 1]])
        lo = A.indptr[r]
        np.testing.assert_array_equal(lay.vals.numpy()[e], A.data[lo:lo + counts[r]])
        np.testing.assert_array_equal(lay.cols.numpy()[e], A.indices[lo:lo + counts[r]])
    if name == "ragged":
        assert lay.n_chunks > lay.n_heavy  # rows over several chunks
    if name == "storm_heavy" and direction == "AT":
        assert lay.n_chunks == lay.n_heavy == 24  # rows of one chunk
    assert lay.partials.numel() == lay.n_chunks and not lay.counters.any()


@pytest.mark.parametrize("fn", ["matvec", "rmatvec", "normal_diag"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_kernel_order_walk_matches_the_plain_version_and_jax(name, fn):
    A = MATRICES[name]()
    top, jop = tsparse.from_scipy(A), jsparse.from_scipy(A)
    assert top.fmt == jop.fmt == "ell"
    rng = np.random.default_rng(4)
    if fn == "rmatvec":
        x = rng.standard_normal(A.shape[0])
        got = _walk(top.tsell, torch.from_numpy(x))
        plain = ell_spmv_reference(top.tvals, top.tcols, torch.from_numpy(x), top.ttail())
        want = jop.rmatvec(jnp.asarray(x))
    elif fn == "matvec":
        x = rng.standard_normal(A.shape[1])
        got = _walk(top.sell, torch.from_numpy(x))
        plain = ell_spmv_reference(top.vals, top.cols, torch.from_numpy(x), top.tail())
        want = jop.matvec(jnp.asarray(x))
    else:
        x = rng.uniform(0.5, 2.0, A.shape[1])
        got = _walk(top.sell, torch.from_numpy(x), square=True, reg=1e-3)
        plain = ell_spmv_reference(top.vals, top.cols, torch.from_numpy(x), top.tail(),
                                   square=True, reg=1e-3)
        want = jop.normal_diag(jnp.asarray(x), 1e-3)
    assert not torch.isnan(got).any()  # every row written
    assert _rel(got, plain) <= OP_TOL
    assert _rel(got, want) <= OP_TOL


@pytest.mark.parametrize("name", list(MATRICES))
def test_walk_after_scaled_and_ruiz_matches_the_jax_operator(name):
    """``scaled`` rescales the layout's values exactly as the hybrid's (the
    same products, bit for bit), so the kernel's order gives Dr·A·Dc's
    products; the same after ``ruiz_equilibrate``."""
    A = MATRICES[name]()
    top, jop = tsparse.from_scipy(A), jsparse.from_scipy(A)
    rng = np.random.default_rng(6)
    dr, dc = rng.uniform(0.5, 2.0, A.shape[0]), rng.uniform(0.5, 2.0, A.shape[1])
    v, w = rng.standard_normal(A.shape[1]), rng.standard_normal(A.shape[0])
    for sop, jsop in ((top.scaled(dr, dc), jop.scaled(dr, dc)),
                      (tsparse.ruiz_equilibrate(top)[0], jsparse.ruiz_equilibrate(jop)[0])):
        for lay, orig, M in (
                (sop.sell, top.sell, _hybrid_csr(sop.vals, sop.cols, sop.tail(), A.shape)),
                (sop.tsell, top.tsell, _hybrid_csr(sop.tvals, sop.tcols, sop.ttail(), A.shape[::-1]))):
            rows, js = _slots(lay)
            live = (rows >= 0) & (js < torch.from_numpy(np.diff(M.indptr))[rows.clamp(min=0)])
            src = torch.from_numpy(M.indptr).long()[rows[live]] + js[live]
            np.testing.assert_array_equal(lay.vals[live].numpy(), M.data[src.numpy()])
            assert not lay.vals[~live].any()
            for a, b in ((lay.partials, orig.partials), (lay.counters, orig.counters)):
                assert a.numel() == 0 or a.data_ptr() != b.data_ptr()  # scratch of its own
        assert _rel(_walk(sop.sell, torch.from_numpy(v)), jsop.matvec(jnp.asarray(v))) <= OP_TOL
        assert _rel(_walk(sop.tsell, torch.from_numpy(w)), jsop.rmatvec(jnp.asarray(w))) <= OP_TOL
        assert _rel(_walk(sop.sell, torch.from_numpy(np.abs(v)), square=True, reg=0.5),
                    jsop.normal_diag(jnp.asarray(np.abs(v)), 0.5)) <= OP_TOL


def _from_counts(counts, n, seed):
    """A CSR of ``n`` columns whose rows hold ``counts`` entries each
    (distinct sorted columns, nonzero values)."""
    rng = np.random.default_rng(seed)
    indices = np.concatenate([np.sort(rng.choice(n, c, replace=False)) for c in counts])
    data = rng.uniform(0.5, 2.0, indices.size) * rng.choice([-1.0, 1.0], indices.size)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return sp.csr_matrix((data, indices.astype(np.int32), indptr), shape=(len(counts), n))


EDGE_MATRICES = {
    # Every row heavy, one to five chunks each.
    "all_heavy": lambda: _from_counts(np.random.default_rng(1).integers(HEAVY_MIN + 1, 4 * CHUNK + 5, 40),
                                      5000, 1),
    # Rows at each threshold's edge, and empty ones.
    "thresholds": lambda: _from_counts([HEAVY_MIN, HEAVY_MIN + 1, 0, CHUNK - 1, CHUNK, CHUNK + 1, 1,
                                        2 * CHUNK, 0, HEAVY_MIN - 1], 3000, 2),
    # Over two windows of light rows of every count, the last slice ragged.
    "windows": lambda: _from_counts(np.random.default_rng(3).integers(0, HEAVY_MIN + 1, 2 * WINDOW + 77),
                                    600, 3),
}


@pytest.mark.parametrize("name", list(EDGE_MATRICES))
def test_layout_holds_edge_matrices_and_their_products(name):
    """Matrices at the layout's edges (every row heavy, rows at the heavy
    and chunk thresholds, several windows): the layout holds A, its chunks
    cut as CHUNK says, and the walk is A's product."""
    A = EDGE_MATRICES[name]()
    lay = sell_layout(A.indptr, A.indices, A.data, dtype=torch.float64, device="cpu")
    counts = np.diff(A.indptr)
    assert lay.n_heavy == int((counts > HEAVY_MIN).sum())
    assert lay.n_chunks == int(-(-counts[counts > HEAVY_MIN] // CHUNK).sum())
    rows, js = _slots(lay)
    live = (rows >= 0) & (js < torch.from_numpy(counts)[rows.clamp(min=0)])
    assert int(live.sum()) == A.nnz and not lay.vals[~live].any()
    v = np.random.default_rng(8).standard_normal(A.shape[1])
    got = _walk(lay, torch.from_numpy(v))
    assert not torch.isnan(got).any()
    assert _rel(got, A @ v) <= OP_TOL


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors take the plain version (and count no launch); any other
    device launches the kernel or raises — here, with no card, a tensor on
    the meta device raises, and no tensor reaches the plain version."""
    A = _ragged()
    op = tsparse.from_scipy(A)
    v = torch.from_numpy(np.random.default_rng(9).standard_normal(A.shape[1]))
    before = (ell_spmv.launches, ell_spmv.launches_t, ell_normal_diag.launches)
    assert _rel(ell_spmv(op.vals, op.cols, v, op.tail(), layout=op.sell), A @ v) <= OP_TOL
    assert (ell_spmv.launches, ell_spmv.launches_t, ell_normal_diag.launches) == before
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for device"):
        ell_spmv(meta(op.vals), meta(op.cols), meta(v), layout=op.sell)
