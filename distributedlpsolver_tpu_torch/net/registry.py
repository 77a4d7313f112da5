"""File-backed shared backend registry: N router processes, one
consistent view of backends, ejections, and re-admissions (README
"Durability & graceful shutdown").

One JSON document at ``path`` (atomic-rename writes, so readers never
see a torn file), mtime-versioned (readers reload only when
``version()`` moves), mutated under a single-writer lease — a sidecar
``<path>.lock`` file created ``O_CREAT|O_EXCL`` holding the writer id
and an expiry; a crashed writer's stale lease is broken after expiry,
so the registry can never deadlock on a dead process.

Document shape::

    {
      "generation": 17,            # bumped by every applied write
      "writer": "host:pid",        # who wrote generation 17
      "updated_ts": 1770000000.0,
      "backends": {
        "http://10.0.0.2:8080": {
          "ejected": false,
          "fails": 0,
          "ejected_at_ts": 0.0,     # wall clock of the last ejection
          "observed_ts": 1770000000.0,  # when this state was OBSERVED
          "gen": 17                 # generation that applied it
        }, ...
      }
    }

Consistency rules (the cross-process half of the router's stale-probe guard):

- A write only applies when its ``observed_ts`` is newer than the
  stored one — a slow router flushing an old observation can't clobber
  fresher state.
- A re-admission only applies when it was observed AFTER the stored
  ``ejected_at_ts`` — a health probe that raced a crash (read the dead
  process's last 200) can't resurrect an ejected backend, no matter
  which router it came from.
- Ejections are never blocked by the second rule: fresh evidence that a
  backend is dead always lands.

Every applied write emits a ``registry_write`` JSONL event and bumps
``registry_generation``; skipped (stale) writes count into
``registry_writes_total{applied="false"}``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Callable, Optional

from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics


class BackendRegistry:
    """One process's handle on the shared registry file."""

    def __init__(
        self,
        path: str,
        lease_s: float = 5.0,
        writer_id: Optional[str] = None,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
        logger=None,
    ):
        self.path = path
        self.lock_path = path + ".lock"
        self.lease_s = lease_s
        self.writer_id = writer_id or f"{socket.gethostname()}:{os.getpid()}"
        self._logger = logger  # IterLogger-ish (.event) or None
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        m = metrics if metrics is not None else obs_metrics.get_registry()
        self._m_writes: dict = {}  # applied-label -> counter; guarded-by: _lock
        self._metrics = m
        self._m_generation = m.gauge(
            "registry_generation",
            help="shared backend-registry generation last read/written",
        )
        self._m_lease_breaks = m.counter(
            "registry_lease_breaks_total",
            help="stale writer leases broken (crashed writer recovery)",
        )
        self._lock = threading.Lock()

    # -- reads ------------------------------------------------------------

    def version(self) -> int:
        """Cheap change detector: the file's mtime_ns (0 when absent).
        Atomic-rename writes guarantee a new inode per generation, so a
        moved version always means real new content."""
        try:
            return os.stat(self.path).st_mtime_ns
        except OSError:
            return 0

    def load(self) -> dict:
        """The current document (``{}``-shaped default when absent).
        Atomic renames make a torn read impossible; a corrupt file
        (manual edit) degrades to the empty document rather than
        raising into the router's poll loop."""
        try:
            with open(self.path) as fh:
                data = json.load(fh)
            if not isinstance(data, dict):
                raise ValueError("registry root must be an object")
        except (OSError, ValueError):
            data = {}
        data.setdefault("generation", 0)
        data.setdefault("backends", {})
        self._m_generation.set(float(data["generation"]))
        return data

    # -- single-writer lease ----------------------------------------------

    def _acquire_lease(self, timeout: float = 0.5) -> bool:
        deadline = time.monotonic() + timeout
        payload = json.dumps(
            {"writer": self.writer_id, "expires_ts": time.time() + self.lease_s}
        )
        while True:
            try:
                fd = os.open(
                    self.lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY
                )
                try:
                    os.write(fd, payload.encode("utf-8"))
                finally:
                    os.close(fd)
                return True
            except FileExistsError:
                # Somebody holds the lease; break it only past expiry
                # (a crashed writer must not wedge the registry).
                try:
                    with open(self.lock_path) as fh:
                        holder = json.load(fh)
                    expired = (
                        float(holder.get("expires_ts", 0.0)) < time.time()
                    )
                except (OSError, ValueError):
                    expired = True  # unreadable lock: treat as stale
                if expired:
                    try:
                        os.unlink(self.lock_path)
                        self._m_lease_breaks.inc()
                    except OSError:
                        pass
                    continue
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.01)
            except OSError:
                return False

    def _release_lease(self) -> None:
        try:
            os.unlink(self.lock_path)
        except OSError:
            pass

    # -- writes -----------------------------------------------------------

    def _count_write(self, applied: bool):
        key = "true" if applied else "false"
        with self._lock:
            ctr = self._m_writes.get(key)
            if ctr is None:
                ctr = self._metrics.counter(
                    "registry_writes_total",
                    labels={"applied": key},
                    help="registry mutation attempts (false = stale, skipped)",
                )
                self._m_writes[key] = ctr
        return ctr

    def update(self, mutate: Callable[[dict], bool]) -> Optional[dict]:
        """Lease-serialized read-modify-write: ``mutate(backends)`` edits
        the backend table in place and returns True iff something
        changed. Applied changes bump the generation and land via atomic
        rename. Returns the written document, or None when nothing
        changed or the lease could not be taken (callers retry on their
        next poll — the registry favors availability over blocking).

        The file lease is the ONLY serialization: it already excludes
        writers across processes AND across threads of one process, so
        holding an in-process lock around the RMW would add nothing but
        a place for the router's poll thread to sleep behind a peer's
        lease wait + fsync (blocking-under-lock). ``_lock`` guards only
        the lazily-built metrics map."""
        if not self._acquire_lease():
            self._count_write(False).inc()
            return None
        try:
            data = self.load()
            changed = bool(mutate(data["backends"]))
            if not changed:
                self._count_write(False).inc()
                return None
            data["generation"] = int(data["generation"]) + 1
            data["writer"] = self.writer_id
            data["updated_ts"] = time.time()
            for entry in data["backends"].values():
                entry.setdefault("gen", data["generation"])
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w") as fh:
                json.dump(data, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
            self._m_generation.set(float(data["generation"]))
            self._count_write(True).inc()
            return data
        except OSError:
            self._count_write(False).inc()
            return None
        finally:
            self._release_lease()

    # -- the router-facing surface ----------------------------------------

    def ensure(self, urls) -> Optional[dict]:
        """Register backends that are not in the table yet (a router
        starting up contributes its configured list). Existing entries
        — including ejected ones — are left untouched: registering a
        URL must never resurrect it."""

        def _mutate(backends: dict) -> bool:
            changed = False
            for url in urls:
                u = url.rstrip("/")
                if u not in backends:
                    backends[u] = {
                        "ejected": False,
                        "fails": 0,
                        "ejected_at_ts": 0.0,
                        "observed_ts": time.time(),
                    }
                    changed = True
            return changed

        return self.update(_mutate)

    def register(
        self,
        url: str,
        slice_id: Optional[str] = None,
        world_size: Optional[int] = None,
    ) -> bool:
        """A SERVING process announces itself: ensure the entry exists,
        stamp its slice identity, and write the first heartbeat. Never
        clears an ejection (the resurrection rule — a restarted slice
        re-enters rotation through a router's own fresh probe), so a
        crash-looping process can't bounce itself back in. Returns True
        iff the write applied; emits a ``slice_register`` event."""
        u = url.rstrip("/")

        def _mutate(backends: dict) -> bool:
            e = backends.get(u)
            if e is None:
                e = {
                    "ejected": False,
                    "fails": 0,
                    "ejected_at_ts": 0.0,
                    "observed_ts": time.time(),
                }
                backends[u] = e
            if slice_id is not None:
                e["slice_id"] = str(slice_id)
            if world_size is not None:
                e["world_size"] = int(world_size)
            e["last_heartbeat_ts"] = time.time()
            return True

        applied = self.update(_mutate) is not None
        if applied and self._logger is not None:
            self._logger.event(
                {
                    "event": "slice_register",
                    "backend": u,
                    "slice_id": slice_id,
                    "world_size": world_size,
                }
            )
        return applied

    def heartbeat(self, url: str) -> bool:
        """Refresh the serving process's liveness stamp. Routers treat
        an entry whose ``last_heartbeat_ts`` is older than their
        ``registry_ttl_s`` as ejected — the deterministic exit from
        rotation for a kill -9'd slice that never answers another
        probe. Entries that never heartbeat (classic backends started
        without registration) are exempt from TTL ejection."""
        u = url.rstrip("/")

        def _mutate(backends: dict) -> bool:
            e = backends.get(u)
            if e is None:
                return False
            e["last_heartbeat_ts"] = time.time()
            return True

        return self.update(_mutate) is not None

    def record(
        self,
        url: str,
        ejected: bool,
        fails: int,
        observed_ts: float,
        ejected_at_ts: float = 0.0,
    ) -> bool:
        """Publish one observation (ejection or recovery) for ``url``.
        Stale observations are dropped (see the module consistency
        rules). Returns True iff the write applied."""
        url = url.rstrip("/")
        out = {"applied": False, "entry": None}

        def _mutate(backends: dict) -> bool:
            e = backends.get(url)
            if e is not None:
                if float(e.get("observed_ts", 0.0)) >= observed_ts:
                    return False  # stale writer: newer state already in
                if (
                    not ejected
                    and e.get("ejected")
                    and observed_ts <= float(e.get("ejected_at_ts", 0.0))
                ):
                    # Re-admission evidence predating the ejection —
                    # the cross-process stale-probe guard.
                    return False
            # Update in place over the stored entry: serving-side fields
            # (slice_id / world_size / last_heartbeat_ts) must survive a
            # router's observation push.
            entry = dict(e or {})
            entry.update(
                {
                    "ejected": bool(ejected),
                    "fails": int(fails),
                    "ejected_at_ts": float(
                        ejected_at_ts
                        if ejected_at_ts
                        else (e or {}).get("ejected_at_ts", 0.0)
                    ),
                    "observed_ts": float(observed_ts),
                }
            )
            if ejected and not entry["ejected_at_ts"]:
                entry["ejected_at_ts"] = observed_ts
            backends[url] = entry
            out["applied"] = True
            out["entry"] = entry
            return True

        data = self.update(_mutate)
        if data is not None and out["applied"] and self._logger is not None:
            self._logger.event(
                {
                    "event": "registry_write",
                    "backend": url,
                    "ejected": bool(ejected),
                    "fails": int(fails),
                    "generation": data["generation"],
                    "writer": self.writer_id,
                }
            )
        return data is not None and out["applied"]
