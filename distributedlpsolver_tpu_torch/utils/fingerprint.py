"""Problem fingerprints — ONE definition of problem identity, shared by
checkpoint validation (utils/checkpoint.py) and the warm-start cache
(serve/warmcache.py).

Two identities exist because two consumers need different invariances:

* :func:`problem_fingerprint` — the *instance* identity (shapes plus a
  hash over the c/b bytes). Checkpoints carry it so a stale
  ``--checkpoint`` path can never seed a solve with another LP's
  iterate (checkpoint format v2).
* :func:`structural_fingerprint` — the *model* identity: the A pattern
  and values, the shapes, and the bounds shape (which columns/rows are
  bounded), with b and c deliberately left out. Correlated serve
  traffic — the same model re-solved with perturbed b/c, parameterized
  streams — maps to ONE structural key, which is what lets the warm
  cache amortize presolve/scaling/structure work and seed delta-solves
  from a prior iterate of the same structure.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

try:  # scipy is already a hard dependency of models/; guard anyway
    import scipy.sparse as _sp
except Exception:  # pragma: no cover - scipy is baked into the image
    _sp = None


def _hash_array(h, v) -> None:
    h.update(np.ascontiguousarray(np.asarray(v, dtype=np.float64)).tobytes())


def problem_fingerprint(inf) -> str:
    """Stable identity of an interior-form problem: (m, n) plus a SHA-256
    over the c and b bytes (f64-normalized so dtype does not perturb it)."""
    h = hashlib.sha256()
    h.update(f"{int(inf.m)}x{int(inf.n)}".encode())
    for v in (inf.c, inf.b):
        _hash_array(h, v)
    return h.hexdigest()[:16]


def structural_fingerprint(
    A,
    m: Optional[int] = None,
    n: Optional[int] = None,
    lb=None,
    ub=None,
) -> str:
    """Structural identity of an LP model: SHA-256 over (m, n), the A
    pattern *and values* (same-A is the delta-solve contract — a changed
    coefficient is a different model), and the bounds *shape* (the
    finite/infinite pattern of lb/ub, not their values, so a stream that
    jitters bounds within the same pattern still shares the key).

    ``A`` may be dense or scipy-sparse; sparse matrices hash their CSR
    structure (indptr/indices/data), dense ones their f64 bytes. Returns
    the full 64-hex digest — the warm cache keys on it verbatim and
    additionally verifies recorded shapes at lookup (collision guard).
    """
    if m is None or n is None:
        m, n = A.shape
    h = hashlib.sha256()
    h.update(f"{int(m)}x{int(n)}".encode())
    if _sp is not None and _sp.issparse(A):
        csr = A.tocsr()
        h.update(np.ascontiguousarray(csr.indptr, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(csr.indices, dtype=np.int64).tobytes())
        _hash_array(h, csr.data)
    else:
        _hash_array(h, A)
    for tag, bound in (("lb", lb), ("ub", ub)):
        h.update(tag.encode())
        if bound is not None:
            h.update(np.packbits(np.isfinite(np.asarray(bound))).tobytes())
    return h.hexdigest()
