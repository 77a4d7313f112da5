"""Carry state across from the JAX package.

The JAX package hands its data out as numpy arrays and plain dicts
(``InteriorForm`` fields, ``backend.to_host`` states, config fields); the
functions here take exactly those and build this package's objects, so a
problem, an iterate or a configuration moves between the two packages
without importing either from the other. A v3 checkpoint file written by
the JAX package needs nothing here: ``utils/checkpoint.py`` is the same
format in both, and ``solve(..., checkpoint_path=...)`` resumes it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState
from distributedlpsolver_tpu_torch.models.generators import BatchedLP
from distributedlpsolver_tpu_torch.models.problem import _SHIFT, InteriorForm


def interior_form_from_arrays(A, b, c, u, name: str = "LP", block_structure=None) -> InteriorForm:
    """An :class:`InteriorForm` ``min cᵀx, Ax=b, 0≤x≤u`` from arrays, with
    identity recovery (the interior variables are the original ones) and
    the block-structure hint, if any, carried across."""
    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    return InteriorForm(
        c=c,
        A=A if hasattr(A, "tocsr") else np.asarray(A, dtype=np.float64),
        b=np.asarray(b, dtype=np.float64),
        u=np.asarray(u, dtype=np.float64),
        c0=0.0,
        orig_n=n,
        col_kind=np.full(n, _SHIFT, dtype=np.int8),
        col_orig=np.arange(n),
        col_shift=np.zeros(n),
        col_sign=np.ones(n),
        name=name,
        block_structure=block_structure,
    )


def block_tensors_from_arrays(B_all, L_all, A0, col_idx, border_idx, row_idx, link_idx,
                              layout, *, device, dtype=torch.float64):
    """The block tier's device tensors (``backends/block_angular.py::
    BlockTensors``, with its layout) from the host arrays of the JAX
    package's ``BlockTensors`` (its (K, link, nb) ``L_all`` and ``A0``
    laid out as the port's (link, K·nb + n0) ``L_cat``) and its
    ``BlockLayout`` fields."""
    from distributedlpsolver_tpu_torch.backends.block_angular import (
        BlockArrays,
        BlockLayout,
        place_tensors,
    )

    lay = BlockLayout(*(int(v) for v in layout))
    L_all = np.asarray(L_all, dtype=np.float64)
    L_cat = np.concatenate(
        [L_all.transpose(1, 0, 2).reshape(lay.link, lay.K * lay.nb),
         np.asarray(A0, dtype=np.float64).reshape(lay.link, lay.n0)], axis=1)
    arrays = BlockArrays(np.asarray(B_all, dtype=np.float64), L_cat, np.asarray(col_idx),
                         np.asarray(border_idx), np.asarray(row_idx), np.asarray(link_idx))
    return place_tensors(arrays, lay, dtype, device), lay


def scenario_tensors_from_arrays(W, T, rowmask, A0, rows0, cols0, rows_idx, cols_idx, colmask,
                                 m, n, *, device, dtype=torch.float64):
    """The scenario tier's device tensors (``backends/scenario.py::
    ScenarioTensors``, with its layout) from the host arrays of the JAX
    package's ``ScenarioBackend`` state: its lane stacks ``_Wd``/``_Td``/
    ``_rowmask_d`` with the chunks concatenated to (k_pad, ·, ·), ``_A0d``,
    ``_rows0``/``_cols0`` and the (k_pad, ·) ``_rows_idx``/``_cols_idx``
    with their masks. Padded slots, which the reference points at row or
    column 0 under a zero mask, point at m or n here."""
    from distributedlpsolver_tpu_torch.backends.scenario import ScenarioLayout, ScenarioTensors

    W = np.asarray(W, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64)
    rowmask = np.asarray(rowmask).reshape(W.shape[:2]) > 0
    colmask = np.asarray(colmask).reshape(W.shape[0], W.shape[2]) > 0
    rows0 = np.asarray(rows0, dtype=np.int64)
    k_pad, mb, nb = W.shape
    rows_idx = np.where(rowmask, np.asarray(rows_idx).reshape(rowmask.shape), m)
    cols_idx = np.where(colmask, np.asarray(cols_idx).reshape(colmask.shape), n)
    row_pos = np.empty(m, dtype=np.int64)
    row_pos[rows_idx[rowmask]] = np.flatnonzero(rowmask.ravel())
    row_pos[rows0] = k_pad * mb + np.arange(rows0.size)
    lay = ScenarioLayout(K=int(rowmask.any(axis=1).sum()), k_pad=k_pad, mb=mb, nb=nb,
                         m0=rows0.size, n0=T.shape[2], m=int(m), n=int(n))

    def put(a, dt=torch.int64):
        return torch.tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    tensors = ScenarioTensors(
        W=put(W, dtype), T=put(T, dtype), A0=put(np.asarray(A0).reshape(lay.m0, lay.n0), dtype),
        rows0=put(rows0), cols0=put(cols0), rows_idx=put(rows_idx), cols_idx=put(cols_idx),
        pad_row=put(~rowmask, dtype), row_pos=put(row_pos),
    )
    return tensors, lay


def batched_lp_from_arrays(A, b, c, name: str = "batched") -> BatchedLP:
    """A :class:`BatchedLP` (B standard-form members ``min cᵀx, Ax=b,
    x≥0``) from arrays of shape (B, m, n), (B, m) and (B, n) — the fields
    of the JAX package's ``BatchedLP``."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    if A.ndim != 3 or b.shape != A.shape[:2] or c.shape != A.shape[:1] + A.shape[2:]:
        raise ValueError(
            f"batched_lp_from_arrays: A {A.shape}, b {b.shape}, c {c.shape} do not fit "
            "(B, m, n), (B, m), (B, n)"
        )
    return BatchedLP(c=c, A=A, b=b, name=name)


def state_from_arrays(x, y, s, w, z, *, device, dtype=torch.float64) -> IPMState:
    """An :class:`IPMState` of tensors on ``device`` from host arrays —
    the inverse of a backend's ``to_host``."""
    return IPMState(
        *(torch.tensor(np.asarray(v), dtype=dtype, device=device) for v in (x, y, s, w, z))
    )


def config_from_dict(d: dict) -> SolverConfig:
    """A :class:`SolverConfig` from a dict of its fields (for example
    ``dataclasses.asdict`` of the JAX package's config). Unknown keys
    raise, so a field that has no meaning here is never dropped silently.
    """
    known = {f.name for f in dataclasses.fields(SolverConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown SolverConfig fields: {unknown}")
    kw = dict(d)
    if kw.get("mesh_shape") is not None:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    return SolverConfig(**kw)
