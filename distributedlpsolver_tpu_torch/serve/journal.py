"""Durable job journal: a write-ahead log of request lifecycle plus a
bounded on-disk async-result store, so acknowledged work survives a
``kill -9`` of the serving process (README "Durability & graceful
shutdown").

Layout under ``journal_dir``::

    journal.jsonl    append-only WAL, one stamped JSONL record per
                     lifecycle transition:
                       {"j": "meta", "nonce": ..., "next_seq": ...}
                       {"j": "admitted", "jid": ..., "fp": ..., "spec": ...}
                       {"j": "stage",    "jid": ..., "stage": ...}
                       {"j": "finished", "jid": ..., "status": ...}
    results/<jid>.json   one whole-file JSON result record per finished
                         job (atomic rename), bounded to ``results_cap``
                         entries — all entries are resolved by
                         construction, so eviction can never lose
                         unfinished work.

Job ids are ``j<nonce>-<seq>``: the nonce is minted once per journal
directory and persisted in the meta record, so ids are globally unique
across backends (the router's fan-out poll depends on that) and stable
across restarts; the sequence continues past the replayed maximum so a
restart can never re-issue a pre-crash id.

Crash recovery contract (``replay``): every ``admitted`` record without
a matching ``finished`` record is returned for re-enqueue; a torn final
line (the crash landed mid-write) is skipped with a counted warning,
never an exception — the WAL's whole point is being readable after the
worst exit. ``finish`` is idempotent: a replayed job that raced its
pre-crash completion records exactly one ``finished`` transition (the
zero-duplicate-solves invariant the chaos harness asserts).

Fsync policy (``fsync=``): ``"none"`` leaves records in the stdio
buffer (fastest, loses the tail on process death), ``"flush"`` flushes
each record (survives ``kill -9``, the default), ``"always"``
additionally fsyncs (survives power loss, one syscall per record).

Write-failure behavior: a failed WAL append (disk full, injected fault)
is counted (``journal_write_errors_total``) and logged, and the service
keeps serving — durability degrades, availability doesn't. The
deterministic chaos harness injects exactly this via
``DLPS_JOURNAL_FAIL_AFTER=<n>`` (the n-th append raises once).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.utils.logging import stamp_record

FSYNC_POLICIES = ("none", "flush", "always")

# Chaos knob: the n-th WAL append in this process raises OSError once
# (seeded schedules set it on a spawned backend's environment).
FAULT_ENV = "DLPS_JOURNAL_FAIL_AFTER"


def request_spec(
    problem,
    tol: Optional[float],
    tenant: str,
    priority: str,
    name: Optional[str],
) -> dict:
    """The replayable request payload journaled at admit time: the full
    problem (LPProblem.to_dict) plus every submit argument recovery
    needs to reconstruct the call."""
    return {
        "problem": problem.to_dict(),
        "tol": tol,
        "tenant": tenant,
        "priority": priority,
        "name": name,
    }


def request_fingerprint(spec: dict) -> str:
    """Content identity of one request — the idempotency key that lets
    a client retry a crashed submit without a duplicate solve: a replayed
    pending job with the same fingerprint absorbs the retry."""
    import hashlib

    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:24]


@dataclasses.dataclass
class JournaledJob:
    """One job's replay view (the merge of its WAL records)."""

    jid: str
    fp: str
    spec: dict
    tenant: str = "default"
    priority: str = "normal"
    deadline_ts: Optional[float] = None  # wall clock; None = no deadline
    admitted_ts: float = 0.0
    stage: str = "admitted"  # admitted | packed | dispatched | finished
    status: Optional[str] = None
    # Trace header (obs/context wire form) journaled OUTSIDE spec: the
    # content fingerprint must not change because a request was traced,
    # and a replayed job resumes its ORIGINAL trace.
    trace: Optional[str] = None

    def trace_context(self):
        """The job's TraceContext (a child of the journaled span — the
        replay is causally downstream of the original submit), or None."""
        from distributedlpsolver_tpu_torch.obs import context as obs_context

        return obs_context.parse(self.trace)


@dataclasses.dataclass
class ReplayReport:
    """What ``replay`` found: the work to re-enqueue plus the tallies
    the ``journal_replay`` telemetry event carries."""

    unfinished: List[JournaledJob]
    finished: int = 0
    torn: int = 0  # torn final record (crash mid-write), skipped
    skipped: int = 0  # other unparseable/foreign lines, skipped
    results: int = 0  # result files found on disk (poll URLs re-bound)


class JobJournal:
    """Append-only request-lifecycle WAL + bounded on-disk result store.

    Thread-safe: the service's submit thread, pipeline threads, and the
    HTTP poll handlers all call in concurrently.
    """

    def __init__(
        self,
        journal_dir: str,
        fsync: str = "flush",
        compact_every: int = 4096,
        results_cap: int = 4096,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy {fsync!r} not in {FSYNC_POLICIES}"
            )
        self.dir = journal_dir
        self.path = os.path.join(journal_dir, "journal.jsonl")
        self.results_dir = os.path.join(journal_dir, "results")
        self.fsync = fsync
        self.compact_every = compact_every
        self.results_cap = results_cap
        os.makedirs(self.results_dir, exist_ok=True)
        m = metrics if metrics is not None else obs_metrics.get_registry()
        self._m_records: dict = {}  # kind -> counter; guarded-by: _lock
        self._metrics = m
        self._m_write_errors = m.counter(
            "journal_write_errors_total",
            help="failed WAL appends (durability degraded, not availability)",
        )
        self._m_pending = m.gauge(
            "journal_pending_jobs",
            help="admitted-but-unfinished jobs the WAL would replay",
        )
        self._m_evicted = m.counter(
            "journal_results_evicted_total",
            help="resolved result files evicted past results_cap",
        )
        self._m_compactions = m.counter(
            "journal_compactions_total",
            help="WAL rewrites keeping only unfinished records",
        )
        self._lock = threading.Lock()
        self._fh = None  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._nonce = ""  # guarded-by: _lock
        self._pending: Dict[str, JournaledJob] = {}  # guarded-by: _lock
        self._results: "OrderedDict[str, str]" = OrderedDict()  # jid -> path; guarded-by: _lock
        # jids whose result file is mid-write outside the lock — keeps
        # the finish() idempotency window closed without holding the
        # WAL lock across the disk write.
        self._finishing: set = set()  # guarded-by: _lock
        self._records_since_compact = 0  # guarded-by: _lock
        self.write_errors = 0  # guarded-by: _lock
        self._writes = 0  # guarded-by: _lock
        self._fail_after = int(os.environ.get(FAULT_ENV, "0") or 0)
        self._replay_report: Optional[ReplayReport] = None
        self._load()

    # -- load / replay ----------------------------------------------------

    def _load(self) -> None:
        """Parse the WAL (tolerating a torn tail) and the result dir;
        runs once at construction, before any append."""
        jobs: Dict[str, JournaledJob] = {}
        finished = 0
        torn = skipped = 0
        max_seq = 0
        nonce = ""
        if os.path.exists(self.path):
            with open(self.path, "r") as fh:
                lines = fh.read().splitlines()
            last_payload = None
            for i, line in enumerate(lines):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # A torn FINAL record is the expected crash artifact
                    # (the process died mid-write); anything earlier is
                    # foreign garbage. Both skip with a count — replay
                    # must never raise on its own crash debris.
                    if i == len(lines) - 1:
                        torn += 1
                    else:
                        skipped += 1
                    continue
                if not isinstance(rec, dict) or "j" not in rec:
                    skipped += 1
                    continue
                last_payload = rec
                kind = rec.get("j")
                if kind == "meta":
                    nonce = str(rec.get("nonce", "")) or nonce
                    max_seq = max(max_seq, int(rec.get("next_seq", 0)))
                elif kind == "admitted":
                    jid = str(rec.get("jid", ""))
                    jobs[jid] = JournaledJob(
                        jid=jid,
                        fp=str(rec.get("fp", "")),
                        spec=rec.get("spec") or {},
                        tenant=str(rec.get("tenant", "default")),
                        priority=str(rec.get("priority", "normal")),
                        deadline_ts=rec.get("deadline_ts"),
                        admitted_ts=float(rec.get("ts", 0.0)),
                        trace=rec.get("trace"),
                    )
                    max_seq = max(max_seq, _seq_of(jid))
                elif kind == "stage":
                    jid = str(rec.get("jid", ""))
                    if jid in jobs:
                        jobs[jid].stage = str(rec.get("stage", "admitted"))
                elif kind == "finished":
                    jid = str(rec.get("jid", ""))
                    if jid in jobs:
                        del jobs[jid]
                    finished += 1
                else:
                    skipped += 1
            del last_payload
        results = OrderedDict()
        try:
            names = sorted(
                os.listdir(self.results_dir),
                key=lambda f: _seq_of(f.rsplit(".", 1)[0]),
            )
        except OSError:
            names = []
        for fname in names:
            if fname.endswith(".json"):
                jid = fname[: -len(".json")]
                results[jid] = os.path.join(self.results_dir, fname)
                max_seq = max(max_seq, _seq_of(jid))
                # A stored result outranks the WAL: if the crash tore
                # off the `finished` record but the result file landed
                # (rename is atomic), the job is done — re-enqueueing
                # it would be the duplicate solve replay must prevent.
                if jid in jobs:
                    del jobs[jid]
                    finished += 1
        if not nonce:
            nonce = os.urandom(4).hex()
        with self._lock:
            self._nonce = nonce
            self._seq = max_seq
            self._pending = jobs
            self._results = results
            self._m_pending.set(len(jobs))
            # (Re)open for append and persist the meta record so a fresh
            # journal knows its nonce and a restarted one re-anchors its
            # sequence past everything it replayed.
            self._fh = open(self.path, "a")
            self._append_locked(
                {"j": "meta", "nonce": nonce, "next_seq": max_seq}
            )
        self._replay_report = ReplayReport(
            unfinished=sorted(jobs.values(), key=lambda j: _seq_of(j.jid)),
            finished=finished,
            torn=torn,
            skipped=skipped,
            results=len(results),
        )

    def replay(self) -> ReplayReport:
        """The recovery worklist parsed at construction: unfinished jobs
        in admit order, plus the torn/skipped tallies."""
        assert self._replay_report is not None
        return self._replay_report

    # -- WAL append -------------------------------------------------------

    def _append_locked(self, payload: dict) -> bool:  # holds: _lock
        self._writes += 1
        try:
            if self._fail_after and self._writes == self._fail_after:
                raise OSError(
                    f"injected journal fault ({FAULT_ENV}="
                    f"{self._fail_after})"
                )
            if self._fh is None:
                raise OSError("journal closed")
            self._fh.write(json.dumps(stamp_record(payload)) + "\n")
            if self.fsync != "none":
                self._fh.flush()
            if self.fsync == "always":
                os.fsync(self._fh.fileno())
        except OSError:
            self.write_errors += 1
            self._m_write_errors.inc()
            return False
        kind = payload.get("j", "?")
        ctr = self._m_records.get(kind)
        if ctr is None:
            ctr = self._metrics.counter(
                "journal_records_total",
                labels={"kind": str(kind)},
                help="WAL records appended by kind",
            )
            self._m_records[kind] = ctr
        ctr.inc()
        self._records_since_compact += 1
        return True

    # -- lifecycle --------------------------------------------------------

    def admit(
        self,
        spec: dict,
        fp: str,
        tenant: str,
        priority: str,
        deadline_ts: Optional[float],
        trace: Optional[str] = None,
    ) -> str:
        """Journal one admitted request; returns its durable job id (the
        poll URL token that survives restarts). ``trace`` is the
        request's trace header (wire form) — a top-level WAL field, not
        part of ``spec``, so tracing never perturbs the idempotency
        fingerprint."""
        with self._lock:
            self._seq += 1
            jid = f"j{self._nonce}-{self._seq}"
            job = JournaledJob(
                jid=jid,
                fp=fp,
                spec=spec,
                tenant=tenant,
                priority=priority,
                deadline_ts=deadline_ts,
                admitted_ts=time.time(),
                trace=trace,
            )
            self._pending[jid] = job
            self._m_pending.set(len(self._pending))
            rec = {
                "j": "admitted",
                "jid": jid,
                "fp": fp,
                "tenant": tenant,
                "priority": priority,
                "deadline_ts": deadline_ts,
                "spec": spec,
            }
            if trace is not None:
                rec["trace"] = trace
            self._append_locked(rec)
        return jid

    def readmit(self, job: JournaledJob) -> None:
        """Track a replayed job as pending again (no new WAL record —
        its original ``admitted`` entry still covers it)."""
        with self._lock:
            self._pending[job.jid] = job
            self._m_pending.set(len(self._pending))

    def mark(self, jid: str, stage: str) -> None:
        """Record a lifecycle transition (packed / dispatched)."""
        with self._lock:
            job = self._pending.get(jid)
            if job is None or job.stage == stage:
                return
            job.stage = stage
            self._append_locked({"j": "stage", "jid": jid, "stage": stage})

    def finish(self, jid: str, record: dict, status: str) -> bool:
        """Journal the terminal verdict and persist the result record to
        the bounded store. Idempotent: the second finish of one jid is a
        counted no-op, so a replayed job racing its pre-crash completion
        can never double-record (or double-serve) a result.

        The result-store write (a whole result record — solution vector
        included — plus an optional fsync) happens OUTSIDE the WAL lock:
        submit/poll/mark callers must never queue behind a disk write
        that only this jid cares about. ``_finishing`` keeps the
        idempotency window closed while the file is in flight; the WAL
        lock is held only for the in-memory commit + the one-line
        ``finished`` append."""
        with self._lock:
            if jid in self._results or jid in self._finishing:
                return False  # already finished (replay raced completion)
            self._finishing.add(jid)
            # The job stays in _pending until the commit block below: a
            # concurrent compact() must keep writing its admitted record
            # while the result file is still in flight, or a crash in
            # the window would lose acknowledged work.
        path = os.path.join(self.results_dir, f"{jid}.json")
        tmp = path + ".tmp"
        wrote = True
        try:
            with open(tmp, "w") as fh:
                json.dump(record, fh)
                if self.fsync == "always":
                    fh.flush()
                    os.fsync(fh.fileno())
            os.replace(tmp, path)
        except OSError:
            wrote = False
        except BaseException:
            # Unexpected failure (e.g. an unserializable record): reopen
            # the idempotency window before propagating, or the jid
            # would be stuck "finishing" forever.
            with self._lock:
                self._finishing.discard(jid)
            raise
        evicted: List[str] = []
        with self._lock:
            self._finishing.discard(jid)
            self._pending.pop(jid, None)
            self._m_pending.set(len(self._pending))
            if wrote:
                self._results[jid] = path
                # All stored results are resolved by construction —
                # eviction reclaims the oldest poll URLs, never
                # unfinished work.
                while len(self._results) > self.results_cap:
                    _old_jid, old_path = self._results.popitem(last=False)
                    evicted.append(old_path)
                    self._m_evicted.inc()
            else:
                self.write_errors += 1
                self._m_write_errors.inc()
            self._append_locked(
                {"j": "finished", "jid": jid, "status": status}
            )
            compact_due = (
                self._records_since_compact >= self.compact_every
            )
        for old_path in evicted:
            try:
                os.remove(old_path)
            except OSError:
                pass
        if compact_due:
            self.compact()
        return True

    # -- reads (the poll path) --------------------------------------------

    def is_pending(self, jid: str) -> bool:
        # A jid whose result file is mid-write (outside the lock) is
        # still pending to pollers — without _finishing here, a poll
        # racing finish() would see neither pending nor done.
        with self._lock:
            return jid in self._pending or jid in self._finishing

    def known(self, jid: str) -> bool:
        with self._lock:
            return (
                jid in self._pending
                or jid in self._results
                or jid in self._finishing
            )

    def result(self, jid: str) -> Optional[dict]:
        """The stored result record for ``jid``, or None (pending,
        unknown, or evicted)."""
        with self._lock:
            path = self._results.get(jid)
        if path is None:
            return None
        try:
            with open(path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    # -- maintenance ------------------------------------------------------

    def compact(self) -> int:
        """Rewrite the WAL keeping only the meta record and the admitted
        records of unfinished jobs (atomic rename) — the file stays
        bounded by the pending set, not request history. Returns the
        number of records the compacted file holds."""
        with self._lock:
            jobs = sorted(
                self._pending.values(), key=lambda j: _seq_of(j.jid)
            )
            tmp = self.path + ".tmp"
            try:
                with open(tmp, "w") as fh:
                    fh.write(
                        json.dumps(
                            stamp_record(
                                {
                                    "j": "meta",
                                    "nonce": self._nonce,
                                    "next_seq": self._seq,
                                }
                            )
                        )
                        + "\n"
                    )
                    for job in jobs:
                        adm = {
                            "j": "admitted",
                            "jid": job.jid,
                            "fp": job.fp,
                            "tenant": job.tenant,
                            "priority": job.priority,
                            "deadline_ts": job.deadline_ts,
                            "spec": job.spec,
                        }
                        if job.trace is not None:
                            # Compaction must not drop the trace: a
                            # post-compact replay still resumes it.
                            adm["trace"] = job.trace
                        fh.write(
                            json.dumps(stamp_record(adm)) + "\n"
                        )
                        if job.stage != "admitted":
                            fh.write(
                                json.dumps(
                                    stamp_record(
                                        {
                                            "j": "stage",
                                            "jid": job.jid,
                                            "stage": job.stage,
                                        }
                                    )
                                )
                                + "\n"
                            )
                    fh.flush()
                    if self.fsync == "always":
                        os.fsync(fh.fileno())
                if self._fh is not None:
                    self._fh.close()
                os.replace(tmp, self.path)
                self._fh = open(self.path, "a")
            except OSError:
                self.write_errors += 1
                self._m_write_errors.inc()
                try:
                    if self._fh is None or self._fh.closed:
                        self._fh = open(self.path, "a")
                except OSError:
                    pass
                return -1
            self._records_since_compact = 0
            self._m_compactions.inc()
            return 1 + len(jobs)

    def flush(self) -> None:
        """Force everything buffered to disk (the drain path's last act
        before the process exits)."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except OSError:
                    self.write_errors += 1
                    self._m_write_errors.inc()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "pending": len(self._pending),
                "results": len(self._results),
                "write_errors": self.write_errors,
                "fsync": self.fsync,
                "dir": self.dir,
            }


def _seq_of(jid: str) -> int:
    """The monotone sequence component of a job id (0 for foreign ids —
    they sort first and never collide with minted ones)."""
    try:
        return int(jid.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return 0
