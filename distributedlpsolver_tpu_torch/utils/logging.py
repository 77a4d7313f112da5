"""Structured per-iteration metrics (SURVEY.md §5.5).

The reference's published metric is "IPM iters/sec + wall-clock to 1e-8
duality gap" (BASELINE.json:2), which implies per-iteration reporting of
iteration count, gap trajectory, and timing. We emit both a human log line
and an optional JSONL stream, one record per iteration.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional, TextIO

from distributedlpsolver_tpu_torch.ipm.state import IterRecord
from distributedlpsolver_tpu_torch.obs import SCHEMA_VERSION

_HEADER = (
    f"{'it':>4} {'mu':>10} {'rel_gap':>10} {'pinf':>10} {'dinf':>10} "
    f"{'a_p':>6} {'a_d':>6} {'sigma':>8} {'pobj':>14} {'t_iter':>8}"
)


def stamp_record(payload: dict) -> dict:
    """Inject the shared record schema into one JSONL payload (in place):
    ``schema_version``, wall-clock ``ts`` (unix seconds — merging streams
    across processes), and monotonic ``t_mono`` (``perf_counter`` seconds
    — ordering within a process, and the clock the Chrome-trace events
    use, so a trace and a JSONL stream line up exactly). Every writer —
    IterLogger rows and events, and the CLI's serve output stream —
    routes through this one helper; ``cli report`` stays backward-
    compatible with unstamped files written before the stamp existed."""
    payload.setdefault("schema_version", SCHEMA_VERSION)
    payload.setdefault("ts", round(time.time(), 6))
    payload.setdefault("t_mono", round(time.perf_counter(), 6))
    return payload


class IterLogger:
    """Per-iteration metric emitter.

    Each JSONL record is written as ONE ``write`` call and flushed
    immediately, so a solve killed mid-iteration (watchdog timeout, OOM
    kill, SIGKILL) leaves a complete, parseable telemetry file for
    post-mortem — the one consumer that matters for the crash log is the
    run that did NOT reach ``close()``. ``fsync=True`` additionally forces
    each record to stable storage (survives a machine crash, not just a
    process crash) at a per-iteration syscall cost that is noise next to a
    device step.
    """

    def __init__(
        self,
        verbose: bool = False,
        jsonl_path: Optional[str] = None,
        fsync: bool = False,
        append: bool = False,
    ):
        # ``append`` keeps an existing stream: the supervisor's retries
        # re-enter the driver (one IterLogger per attempt) and must not
        # truncate the telemetry of the attempts — and the supervisor's
        # fault/resume event records — that came before. O_APPEND also
        # makes the supervisor's concurrent event handle safe: both
        # handles write whole flushed lines at the file end.
        self.verbose = verbose
        mode = "a" if append else "w"
        self._fh: Optional[TextIO] = (  # guarded-by: _lock
            open(jsonl_path, mode) if jsonl_path else None
        )
        self._fsync = fsync
        self._printed_header = False
        # The serve layer writes this stream from two threads (the submit
        # thread logs admission rejections while the dispatcher logs
        # results); whole-line writes interleave safely but flush/fsync
        # pairs do not, so serialize record emission.
        self._lock = threading.Lock()

    def log(self, rec: IterRecord) -> None:
        if self.verbose:
            if not self._printed_header:
                print(_HEADER)
                self._printed_header = True
            print(
                f"{rec.iter:>4} {rec.mu:>10.2e} {rec.rel_gap:>10.2e} "
                f"{rec.pinf:>10.2e} {rec.dinf:>10.2e} {rec.alpha_p:>6.3f} "
                f"{rec.alpha_d:>6.3f} {rec.sigma:>8.1e} {rec.pobj:>14.6e} "
                f"{rec.t_iter:>8.4f}"
            )
        self._write(rec.asdict())

    def event(self, payload: dict) -> None:
        """Write one non-iteration event record (fault classified, resume
        landed) into the same JSONL stream, flushed like iteration rows.
        Events carry an ``"event"`` key so consumers separate them from
        iteration records (which never have one)."""
        self._write(payload)

    def _write(self, payload: dict) -> None:
        # The single JSONL emission point: every record — iteration row
        # or event — is schema-stamped here and written as one flushed
        # line. The handle check lives INSIDE the lock: close() nulls
        # _fh under it, and a dispatcher thread outliving shutdown's
        # join timeout must drop records silently, not race a closing
        # handle.
        with self._lock:
            if self._fh:
                self._fh.write(json.dumps(stamp_record(payload)) + "\n")
                self._fh.flush()
                if self._fsync:
                    os.fsync(self._fh.fileno())

    def close(self) -> None:
        with self._lock:
            if self._fh:
                self._fh.flush()
                self._fh.close()
                self._fh = None
