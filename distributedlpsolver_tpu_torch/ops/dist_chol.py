"""Mesh-distributed Cholesky and triangular inverse of an SPD matrix.

The port of the JAX package's ``ops/dist_chol.py::chol_tri_inv_mesh``:
``L⁻¹`` of ``chol(Ms)`` split by columns over one mesh axis, computed as
a left-looking panel Cholesky and then a right-looking blocked forward
substitution on each member's identity slab, so no member holds the
whole factor or the whole inverse. The block tier factors its link×link
Schur complement this way on a mesh (``backends/block_angular.py``).

The reference runs it as XLA inside ``shard_map`` with one ``psum`` a
panel in each stage. Torch has no per-shard programs: each member's slab
is a tensor on its device, and the two sums a panel are calls of
:meth:`parallel.mesh.Mesh.sum_parts` — one all-reduce over the axis on a
process-group mesh, the parts summed in member order on a local mesh.
The dense work is library calls (``@``, ``torch.linalg.cholesky_ex`` on
the pb×pb diagonal block, ``torch.linalg.solve_triangular``).

Padding, as in the reference: the panel width is ``pb = min(panel,
w0)`` with ``w0 = ⌈m/K⌉``; each member's slab is ``w`` columns, ``w0``
rounded up to a multiple of ``pb``; ``mp = w·K``; the columns and rows
past m carry an identity tail, which factors to itself and stays inert.

Per panel p (columns ``g0 = p·pb`` to ``g0 + pb``, owned by member
``g0 // w``)::

  factor:  U = Σ_members( ownerʼs M panel − L_loc·L_loc[panel rows]ᵀ )
           C = chol(U[panel rows])          (pb×pb, on the owner)
           L panel = U·C⁻ᵀ                  (rows ≥ g0; rows above are 0)
  invert:  Lp = Σ_members( ownerʼs L panel )
           X[panel rows] = C⁻¹·X[panel rows]
           X[below]     −= Lp[below]·X[panel rows]

The sums cover rows ``g0`` and below only (the rows above are zero in
the factor's panel and unused by the substitution), and each member's
left-looking update contracts only the columns it has factored, so a
member's work telescopes to its share of m³/3. The arithmetic is the
reference's; the summation order of the sums is the mesh's, so the
result agrees with the reference to rounding. A failed pb×pb Cholesky
(``info != 0``) becomes a NaN factor (the port's convention), which the
sums carry to every member.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SlabInverse(NamedTuple):
    """``L⁻¹`` split by columns over a mesh axis: ``slabs[i]`` is the
    (mp, w) column slab that starts at global column ``cols[i]``, for the
    members this process holds (every member of the axis on a local mesh,
    this rank's on a process-group mesh). ``m`` is the matrix's order."""

    slabs: Tuple[torch.Tensor, ...]
    cols: Tuple[int, ...]
    m: int
    mp: int
    w: int
    axis: str


def slab_plan(m: int, members: int, panel: int = 256) -> Tuple[int, int, int, int]:
    """``(pb, w, mp, P)``: the panel width, the slab width, the padded
    order and the panel count of an m×m matrix over ``members`` members
    (the reference's rules)."""
    w0 = -(-m // members)
    pb = min(panel, w0)
    w = -(-w0 // pb) * pb
    mp = w * members
    return pb, w, mp, mp // pb


def _slab(Ms: torch.Tensor, base: int, w: int, mp: int, device) -> torch.Tensor:
    """Columns ``[base, base + w)`` of ``Ms`` padded to mp×mp with the
    identity tail, on ``device``."""
    m = Ms.shape[0]
    out = torch.zeros((mp, w), dtype=Ms.dtype, device=device)
    hi = min(base + w, m)
    if hi > base:
        out[:m, : hi - base] = Ms[:, base:hi].to(device)
    lo = max(base, m)
    if lo < base + w:
        out[lo:, lo - base :].diagonal().fill_(1.0)
    return out


def _chol(D: torch.Tensor) -> torch.Tensor:
    C, info = torch.linalg.cholesky_ex(D)
    return torch.where(info == 0, C, float("nan"))


def chol_tri_inv_mesh(Ms: torch.Tensor, mesh, axis: Optional[str] = None,
                      panel: int = 256) -> SlabInverse:
    """``L⁻¹`` of ``chol(Ms)`` column-split over ``axis`` of ``mesh``
    (default its innermost). ``Ms`` is the scaled and regularized SPD
    matrix, whole on this process (on ``mesh.device``). Returns this
    process's slabs; nothing of order mp×mp is kept. Each call makes
    ``2·P`` sums over the axis (:func:`slab_plan`)."""
    axis = axis or mesh.axis_names[-1]
    K = int(mesh.shape[axis])
    m = Ms.shape[0]
    pb, w, mp, P = slab_plan(m, K, panel)
    ppm = w // pb  # panels a member owns
    slots = mesh.axis_members(axis)
    Mloc = [_slab(Ms, k * w, w, mp, dev) for k, dev in slots]
    Lloc = [torch.zeros((mp, w), dtype=Ms.dtype, device=dev) for _, dev in slots]

    # Factor: left-looking, one panel at a time.
    for p in range(P):
        g0 = p * pb
        owner, lc = divmod(g0, w)  # lc: the panel's first column in the owner's slab
        parts = []
        for (k, dev), M_k, L_k in zip(slots, Mloc, Lloc):
            done = min(max(p - k * ppm, 0), ppm) * pb  # columns this member has factored
            upd = L_k[g0:, :done] @ L_k[g0 : g0 + pb, :done].mT if done else None
            if k == owner:
                own = M_k[g0:, lc : lc + pb]
                parts.append(own.clone() if upd is None else own - upd)
            else:
                parts.append(torch.zeros((mp - g0, pb), dtype=Ms.dtype, device=dev)
                             if upd is None else -upd)
        U = mesh.sum_parts(parts, axis)
        for (k, dev), L_k in zip(slots, Lloc):
            if k == owner:
                Uo = U.to(dev)
                C = _chol(Uo[:pb])
                L_k[g0:, lc : lc + pb] = torch.linalg.solve_triangular(C, Uo.mT, upper=False).mT

    # Invert: forward substitution on each member's identity slab.
    X = [torch.zeros((mp, w), dtype=Ms.dtype, device=dev) for _, dev in slots]
    for (k, dev), X_k in zip(slots, X):
        X_k[k * w : (k + 1) * w] = torch.eye(w, dtype=Ms.dtype, device=dev)
    for p in range(P):
        g0 = p * pb
        owner, lc = divmod(g0, w)
        # The owner's panel; a rank of a process group that does not own
        # it enters the sum with zeros (a local mesh needs no zeros).
        parts = []
        for (k, dev), L_k in zip(slots, Lloc):
            if k == owner:
                parts.append(L_k[g0:, lc : lc + pb].clone())
            elif not mesh.is_local:
                parts.append(torch.zeros((mp - g0, pb), dtype=Ms.dtype, device=dev))
        Lp = mesh.sum_parts(parts, axis)
        for (k, dev), X_k in zip(slots, X):
            if g0 + pb <= k * w:
                continue  # the panel lies above this slab's identity: X's rows there stay 0
            Lpk = Lp.to(dev)
            Xp = torch.linalg.solve_triangular(Lpk[:pb], X_k[g0 : g0 + pb], upper=False)
            X_k[g0 : g0 + pb] = Xp
            if g0 + pb < mp:
                X_k[g0 + pb :] -= Lpk[pb:] @ Xp
    return SlabInverse(tuple(X), tuple(k * w for k, _ in slots), m, mp, w, axis)


def apply(inv: SlabInverse, v: torch.Tensor, mesh) -> torch.Tensor:
    """``L⁻¹·v`` for an m-vector ``v`` (replicated): each slab times its
    rows of v, summed over the axis."""
    vp = torch.cat([v, v.new_zeros(inv.mp - inv.m)])
    parts = [S @ vp[c : c + inv.w].to(S.device) for S, c in zip(inv.slabs, inv.cols)]
    return mesh.sum_parts(parts, inv.axis)[: inv.m]


def apply_t(inv: SlabInverse, u: torch.Tensor, mesh) -> torch.Tensor:
    """``L⁻ᵀ·u`` for an m-vector ``u`` (replicated): each slab's rows of
    the product in a zero-filled vector, summed over the axis."""
    up = torch.cat([u, u.new_zeros(inv.mp - inv.m)])
    parts = []
    for S, c in zip(inv.slabs, inv.cols):
        out = up.new_zeros(inv.mp, device=S.device)
        out[c : c + inv.w] = S.mT @ up.to(S.device)
        parts.append(out)
    return mesh.sum_parts(parts, inv.axis)[: inv.m]
