"""MPS reader/writer for Netlib/Mittelmann-style LP files.

Supports the sections NAME, OBJSENSE, ROWS, COLUMNS (incl. integrality
MARKERs, taken as LP relaxation), RHS, RANGES, BOUNDS, ENDATA, in both fixed
and free field layout (fields are whitespace-tokenized, as every modern
parser does — Netlib names contain no spaces).

Conventions implemented (the classic ones, matching HiGHS/CPLEX behavior):

* the first N row is the objective; further N rows are ignored free rows;
* an RHS entry on the objective row sets the objective constant to ``-value``;
* RANGES with range ``r`` on rhs ``b``: L rows → ``[b-|r|, b]``, G rows →
  ``[b, b+|r|]``, E rows → ``[b, b+r]`` for ``r ≥ 0`` else ``[b+r, b]``;
* default bounds are ``0 ≤ x < ∞``; ``UP`` with a negative value on a column
  whose lower bound is still the default 0 sets the lower bound to −∞
  (the classic MPS quirk, which several Netlib files rely on).

The reference's MPS layer is reconstructed from BASELINE.json:7,8,10 (it
must parse afiro, pds-*, neos3, stormG2_1000); no reference source was
available to cite (SURVEY.md §0).
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, TextIO, Union

import numpy as np
import scipy.sparse as sp

from distributedlpsolver_tpu_torch.models.problem import LPProblem

_INF = np.inf

_SECTIONS = {
    "NAME",
    "OBJSENSE",
    "ROWS",
    "COLUMNS",
    "RHS",
    "RANGES",
    "BOUNDS",
    "ENDATA",
}


def _num(tok: str) -> float:
    """Numeric field → float, accepting the Fortran D-exponent form
    ("1.5D+02") that old fixed-format Netlib files carry — float() alone
    rejects it and would fail the parse on a token the classic parsers
    all accept."""
    try:
        return float(tok)
    except ValueError:
        return float(tok.replace("D", "E").replace("d", "e"))


def read_mps(
    source: Union[str, os.PathLike, TextIO],
    dense: Optional[bool] = None,
) -> LPProblem:
    """Parse an MPS file (optionally .gz) into a general-form :class:`LPProblem`.

    ``dense=None`` auto-selects the matrix storage: dense ndarray when
    ``m·n ≤ 200_000``, CSR otherwise.
    """
    close = False
    if isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        fh = gzip.open(path, "rt") if path.endswith(".gz") else open(path, "r")
        close = True
    else:
        fh = source
    try:
        return _parse(fh, dense=dense)
    finally:
        if close:
            fh.close()


def read_mps_string(text: str, dense: Optional[bool] = None) -> LPProblem:
    import io as _io

    return _parse(_io.StringIO(text), dense=dense)


def _parse(fh: TextIO, dense: Optional[bool]) -> LPProblem:
    name = "LP"
    maximize = False

    row_names: List[str] = []
    row_index: Dict[str, int] = {}
    row_type: List[str] = []  # 'E', 'L', 'G'
    obj_row: Optional[str] = None
    free_rows: set = set()

    col_names: List[str] = []
    col_index: Dict[str, int] = {}
    obj_coef: Dict[int, float] = {}
    entries_i: List[int] = []
    entries_j: List[int] = []
    entries_v: List[float] = []

    rhs: Dict[int, float] = {}
    c0 = 0.0
    ranges: Dict[int, float] = {}
    lb: Dict[int, float] = {}
    ub: Dict[int, float] = {}
    integer_cols: set = set()

    section = None
    in_integer = False

    for raw in fh:
        line = raw.rstrip("\n")
        if not line.strip() or line.lstrip().startswith("*"):
            continue
        if line[0] not in (" ", "\t"):
            fields = line.split()
            head = fields[0].upper()
            if head == "NAME":
                name = fields[1] if len(fields) > 1 else "LP"
                section = None
            elif head == "OBJSENSE":
                section = "OBJSENSE"
                if len(fields) > 1:
                    maximize = fields[1].upper().startswith("MAX")
                    section = None
            elif head in _SECTIONS:
                section = head
                if head == "ENDATA":
                    break
            else:
                raise ValueError(f"Unknown MPS section header: {line!r}")
            continue

        fields = line.split()
        if section == "OBJSENSE":
            maximize = fields[0].upper().startswith("MAX")
            section = None  # single-line section body
        elif section == "ROWS":
            rt = fields[0].upper()
            rname = fields[1]
            if rt == "N":
                if obj_row is None:
                    obj_row = rname
                else:
                    free_rows.add(rname)  # extra free rows are dropped
            elif rt in ("E", "L", "G"):
                if rname in row_index:
                    raise ValueError(f"Duplicate row {rname!r}")
                row_index[rname] = len(row_names)
                row_names.append(rname)
                row_type.append(rt)
            else:
                raise ValueError(f"Unknown row type {rt!r}")
        elif section == "COLUMNS":
            # Marker lines look like "  MARKER  'MARKER'  'INTORG'". Only treat
            # the line as a marker when the INTORG/INTEND keyword is actually
            # present, so a genuine coefficient on a row named MARKER parses.
            if (
                len(fields) >= 3
                and fields[1].strip("'\"").upper() == "MARKER"
                and fields[2].strip("'\"").upper() in ("INTORG", "INTEND")
            ):
                in_integer = fields[2].strip("'\"").upper() == "INTORG"
                continue
            cname = fields[0]
            j = col_index.get(cname)
            if j is None:
                j = len(col_names)
                col_index[cname] = j
                col_names.append(cname)
            if in_integer:
                integer_cols.add(j)
            if len(fields) % 2 != 1:
                # col row val [row val]: an even token count means a pair is
                # incomplete — fail with the actual line, not a downstream
                # float-conversion error on a shifted token.
                raise ValueError(
                    f"COLUMNS line has {len(fields)} fields (expected an odd "
                    f"count: column name + row/value pairs): {line!r}"
                )
            for k in range(1, len(fields) - 1, 2):
                rname, val = fields[k], _num(fields[k + 1])
                if rname == obj_row:
                    obj_coef[j] = obj_coef.get(j, 0.0) + val
                elif rname in free_rows:
                    continue
                else:
                    i = row_index.get(rname)
                    if i is None:
                        raise ValueError(f"COLUMNS references unknown row {rname!r}")
                    entries_i.append(i)
                    entries_j.append(j)
                    entries_v.append(val)
        elif section == "RHS":
            # Lines are "SETNAME row val [row val]"; some files omit SETNAME.
            # Field-count parity decides (pairs after the optional set name),
            # avoiding misparses when a set name collides with a row name.
            start = len(fields) % 2
            for k in range(start, len(fields) - 1, 2):
                rname, val = fields[k], _num(fields[k + 1])
                if rname == obj_row:
                    c0 = -val
                elif rname in free_rows:
                    continue
                else:
                    i = row_index.get(rname)
                    if i is None:
                        raise ValueError(f"RHS references unknown row {rname!r}")
                    rhs[i] = val
        elif section == "RANGES":
            start = len(fields) % 2  # same parity rule as RHS
            for k in range(start, len(fields) - 1, 2):
                rname, val = fields[k], _num(fields[k + 1])
                if rname == obj_row or rname in free_rows:
                    # A range on a free/objective row has no constraint to
                    # widen — classic parsers ignore it (same convention
                    # as RHS/COLUMNS entries on dropped free rows).
                    continue
                i = row_index.get(rname)
                if i is None:
                    raise ValueError(f"RANGES references unknown row {rname!r}")
                ranges[i] = val
        elif section == "BOUNDS":
            bt = fields[0].upper()
            # "BT bndname col [value]" — bndname may be omitted in the wild.
            # Decide purely by field count (not name lookups, which misfire
            # when a bound-set name collides with a column name).
            if bt in ("FR", "MI", "PL", "BV"):
                cname = fields[2] if len(fields) >= 3 else fields[1]
                val = 0.0
            else:
                if len(fields) >= 4:
                    cname, val = fields[2], _num(fields[3])
                else:
                    cname, val = fields[1], _num(fields[2])
            j = col_index.get(cname)
            if j is None:
                raise ValueError(f"BOUNDS references unknown column {cname!r}")
            if bt == "UP":
                ub[j] = val
                if val < 0 and j not in lb:
                    lb[j] = -_INF  # classic MPS quirk
            elif bt == "LO":
                lb[j] = val
            elif bt == "FX":
                lb[j] = val
                ub[j] = val
            elif bt == "FR":
                lb[j] = -_INF
                ub[j] = _INF
            elif bt == "MI":
                lb[j] = -_INF
            elif bt == "PL":
                ub[j] = _INF
            elif bt == "BV":
                lb[j] = 0.0
                ub[j] = 1.0
                integer_cols.add(j)
            elif bt == "UI":
                ub[j] = val
                integer_cols.add(j)
            elif bt == "LI":
                lb[j] = val
                integer_cols.add(j)
            else:
                raise ValueError(f"Unknown bound type {bt!r}")
        elif section is None:
            raise ValueError(f"Data line outside any section: {line!r}")
        else:
            raise ValueError(f"Data line in unsupported section {section}: {line!r}")

    if obj_row is None:
        raise ValueError("MPS file has no objective (N) row")

    m, n = len(row_names), len(col_names)
    c = np.zeros(n)
    for j, v in obj_coef.items():
        c[j] = v

    rhs_arr = np.zeros(m)
    for i, v in rhs.items():
        rhs_arr[i] = v

    rlb = np.empty(m)
    rub = np.empty(m)
    for i, rt in enumerate(row_type):
        b = rhs_arr[i]
        if rt == "E":
            rlb[i] = rub[i] = b
        elif rt == "L":
            rlb[i], rub[i] = -_INF, b
        else:  # G
            rlb[i], rub[i] = b, _INF
    for i, r in ranges.items():
        rt, b = row_type[i], rhs_arr[i]
        if rt == "L":
            rlb[i] = b - abs(r)
        elif rt == "G":
            rub[i] = b + abs(r)
        else:  # E
            if r >= 0:
                rlb[i], rub[i] = b, b + r
            else:
                rlb[i], rub[i] = b + r, b

    lb_arr = np.zeros(n)
    ub_arr = np.full(n, _INF)
    for j, v in lb.items():
        lb_arr[j] = v
    for j, v in ub.items():
        ub_arr[j] = v

    A_coo = sp.coo_matrix(
        (entries_v, (entries_i, entries_j)), shape=(m, n), dtype=np.float64
    )
    A_coo.sum_duplicates()
    use_dense = dense if dense is not None else (m * n <= 200_000)
    A: Union[np.ndarray, sp.spmatrix] = A_coo.toarray() if use_dense else A_coo.tocsr()

    if maximize:
        c = -c
        c0 = -c0

    return LPProblem(
        c=c,
        A=A,
        rlb=rlb,
        rub=rub,
        lb=lb_arr,
        ub=ub_arr,
        c0=c0,
        name=name,
        row_names=row_names,
        col_names=col_names,
        integer_cols=sorted(integer_cols),
        maximize=maximize,
    )


def write_mps(p: LPProblem, path: Union[str, os.PathLike]) -> None:
    """Write a general-form LP to (free-format) MPS.

    Round-trips with :func:`read_mps` up to MPS semantics: a fully free row
    (rlb=-inf, rub=+inf) is emitted as a non-objective N row, which readers
    (including ours) drop — the feasible set is preserved but the row count
    may shrink.
    """
    m, n = p.shape
    rn = p.row_names or [f"R{i}" for i in range(m)]
    cn = p.col_names or [f"C{j}" for j in range(n)]
    A = sp.csc_matrix(p.A)

    obj_name = "OBJ"
    while obj_name in rn:
        obj_name = "_" + obj_name  # avoid colliding with a constraint row

    # LPProblem stores c/c0 minimized; the FILE carries the original sense
    # (reader negates back under OBJSENSE MAX), so emit -c for maximize.
    obj_sign = -1.0 if p.maximize else 1.0

    with open(os.fspath(path), "w") as f:
        f.write(f"NAME          {p.name}\n")
        if p.maximize:
            f.write("OBJSENSE\n    MAX\n")
        f.write("ROWS\n")
        f.write(f" N  {obj_name}\n")
        rtypes = []
        for i in range(m):
            lo, hi = p.rlb[i], p.rub[i]
            if lo == hi:
                rt = "E"
            elif np.isfinite(hi):
                rt = "L"
            elif np.isfinite(lo):
                rt = "G"
            else:
                rt = "N"  # free row: correct MPS type (readers drop it)
            rtypes.append(rt)
            f.write(f" {rt}  {rn[i]}\n")
        f.write("COLUMNS\n")
        for j in range(n):
            sl = slice(A.indptr[j], A.indptr[j + 1])
            if p.c[j] != 0.0 or sl.start == sl.stop:
                # Always declare the column, even if it only appears via an
                # explicit 0 objective entry (else it vanishes on re-read).
                f.write(f"    {cn[j]}  {obj_name}  {obj_sign * p.c[j]:.17g}\n")
            for i, v in zip(A.indices[sl], A.data[sl]):
                f.write(f"    {cn[j]}  {rn[i]}  {v:.17g}\n")
        f.write("RHS\n")
        if p.c0 != 0.0:
            f.write(f"    RHS1  {obj_name}  {-(obj_sign * p.c0):.17g}\n")
        for i in range(m):
            rt = rtypes[i]
            b = p.rub[i] if rt == "L" else p.rlb[i]
            if np.isfinite(b) and b != 0.0:
                f.write(f"    RHS1  {rn[i]}  {b:.17g}\n")
        # RANGES for doubly-finite non-equality rows
        rng_lines = []
        for i in range(m):
            lo, hi = p.rlb[i], p.rub[i]
            if lo != hi and np.isfinite(lo) and np.isfinite(hi):
                rng_lines.append(f"    RNG1  {rn[i]}  {hi - lo:.17g}\n")
        if rng_lines:
            f.write("RANGES\n")
            f.writelines(rng_lines)
        f.write("BOUNDS\n")
        for j in range(n):
            lo, hi = p.lb[j], p.ub[j]
            if lo == hi:
                f.write(f" FX BND1  {cn[j]}  {lo:.17g}\n")
                continue
            if lo == -_INF and hi == _INF:
                f.write(f" FR BND1  {cn[j]}\n")
                continue
            if lo == -_INF:
                f.write(f" MI BND1  {cn[j]}\n")
            elif lo != 0.0:
                f.write(f" LO BND1  {cn[j]}  {lo:.17g}\n")
            if hi != _INF:
                f.write(f" UP BND1  {cn[j]}  {hi:.17g}\n")
        f.write("ENDATA\n")
