"""Iterate checkpoint/resume (SURVEY.md §5.4).

IPM state is tiny — (x, y, s, w, z) plus the iteration counter — so a
plain ``.npz`` with atomic rename is the honest mechanism; no Orbax
machinery is warranted for five vectors. The driver writes every
``config.checkpoint_every`` iterations and :func:`load_state` lets a solve
resume with ``warm_start=``.

Format v2 hardening: each checkpoint carries a format version and a
*problem fingerprint* (shapes + a hash of the c/b bytes of the interior
form it was taken from). :func:`load_state` refuses to hand a checkpoint
from a different problem to a resume — the failure mode it closes is a
stale ``--checkpoint`` path silently seeding a solve with another LP's
iterate (shape-coincident garbage converges to the wrong answer; a shape
mismatch merely crashes later and uglier).

Format v3 (elastic recovery): checkpoints are **sharding-layout
independent** by contract. ``save_state`` force-materializes every field
on the host (``np.asarray`` pulls sharded device arrays down), so a
checkpoint written from an 8-device mesh restores onto a 6-device mesh, a
single device, or the CPU — placement belongs to the *active* backend's
``from_host``/``shardings()``, never to the file. v3 additionally records
the canonical (unpadded) problem shapes ``m``/``n`` and refuses a file
whose arrays disagree with them (a truncated/corrupt write fails loudly
instead of resuming garbage). v1 (no version/fingerprint) and v2 (no
shape fields) checkpoints still load.
"""

from __future__ import annotations

import os
import tempfile
import warnings
from typing import Optional, Tuple

import numpy as np

from distributedlpsolver_tpu_torch.ipm.state import IPMState

# One fingerprint definition for the whole repo (utils/fingerprint.py):
# checkpoints and the warm cache must agree on what "same problem" means.
from distributedlpsolver_tpu_torch.utils.fingerprint import (  # noqa: F401
    problem_fingerprint,
)

CKPT_FORMAT_VERSION = 3


class CheckpointMismatch(RuntimeError):
    """Checkpoint belongs to a different problem (fingerprint conflict),
    is internally inconsistent (v3 shape fields vs stored arrays), or was
    written by a newer, unreadable format version."""


def save_state(
    path: str,
    state: IPMState,
    iteration: int,
    name: str = "",
    fingerprint: str = "",
) -> None:
    """Atomically write a host-canonical checkpoint.

    ``np.asarray`` materializes each field on the host regardless of how
    the live iterate was placed (replicated, column-sharded over a mesh,
    already numpy) — the file never encodes a device layout, which is
    what lets the elastic supervisor resume the same checkpoint on a
    re-formed, smaller mesh. Callers hand in the *unpadded* state (the
    driver checkpoints ``backend.to_host`` output, which slices mesh
    padding off); the recorded m/n are the canonical shapes a v3 load
    re-validates.
    """
    arrays = {f: np.asarray(getattr(state, f)) for f in state._fields}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                iteration=iteration,
                name=name,
                version=CKPT_FORMAT_VERSION,
                fingerprint=fingerprint,
                m=int(arrays["y"].shape[0]),
                n=int(arrays["x"].shape[0]),
                **arrays,
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(
    path: str, expected_fingerprint: Optional[str] = None
) -> Tuple[IPMState, int, str]:
    """Load a checkpoint as host numpy arrays (placement is the caller's
    backend's job — ``from_host`` re-pads/re-shards for the active
    layout); raises :class:`CheckpointMismatch` when
    ``expected_fingerprint`` is given and conflicts with the stored one,
    or when a v3 file's recorded shapes disagree with its arrays. v1
    checkpoints have no fingerprint and are accepted as-is; v2 have no
    shape fields and skip that check."""
    with np.load(path, allow_pickle=False) as data:
        version = int(data["version"]) if "version" in data else 1
        if version > CKPT_FORMAT_VERSION:
            raise CheckpointMismatch(
                f"{path}: checkpoint format v{version} is newer than this "
                f"reader (v{CKPT_FORMAT_VERSION})"
            )
        stored = str(data["fingerprint"]) if "fingerprint" in data else ""
        if expected_fingerprint and stored and stored != expected_fingerprint:
            raise CheckpointMismatch(
                f"{path}: checkpoint fingerprint {stored} does not match the "
                f"problem being solved ({expected_fingerprint}) — refusing to "
                f"resume from a different problem's iterate"
            )
        state = IPMState(*(data[f] for f in IPMState._fields))
        if version >= 3:
            m, n = int(data["m"]), int(data["n"])
            if state.x.shape != (n,) or state.y.shape != (m,):
                raise CheckpointMismatch(
                    f"{path}: stored arrays x{state.x.shape}/y{state.y.shape} "
                    f"disagree with the recorded canonical shapes "
                    f"(n={n}, m={m}) — corrupt or non-canonical checkpoint"
                )
        return state, int(data["iteration"]), str(data["name"])


def maybe_load(
    path: Optional[str], expected_fingerprint: Optional[str] = None
) -> Optional[Tuple[IPMState, int, str]]:
    """Resume helper: None when no checkpoint exists; a fingerprint
    mismatch warns and returns None (fresh start, the path is about to be
    overwritten by this solve's own checkpoints) rather than raising."""
    if path and os.path.exists(path):
        try:
            return load_state(path, expected_fingerprint)
        except CheckpointMismatch as e:
            warnings.warn(f"ignoring checkpoint: {e}", stacklevel=2)
            return None
    return None
