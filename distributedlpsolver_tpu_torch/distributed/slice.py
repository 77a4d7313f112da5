"""One-service-per-slice serving: bucket dispatch across a world.

The counterpart of the JAX package's ``distributed/slice.py``. The
serving plane's multi-host unit is a SLICE: one world (N rank processes,
``distributed/launcher.py``) running ONE SolveService. Rank 0 owns the
HTTP front-end, the scheduler and the demux; every rank — rank 0
included — executes the bucket programs on its lane block of the world's
batch mesh (``World.mesh("batch")``), and the ranks' results meet in one
all-reduce after the loop (``backends/batched.py``).

The control plane is a shared-directory DISPATCH JOURNAL
(:class:`FileControlPlane`): rank 0 publishes each dispatch — bucket
meta, the padded host batch, the warm lanes and the PDHG seeds — as one
atomically renamed ``.npz``; followers poll the directory and execute the
same ``solve_bucket``/``solve_pdhg_bucket`` call with identical static
arguments (their solver config comes from the same CLI flags through
:func:`canonical_bucket_config`). The gather after each block's loop is
the only synchronization point. A file-based control plane is
deliberate: followers sit in a cheap poll loop between dispatches and
never wait inside a collective — the world's collectives time out
(``WorldConfig.init_timeout_s``, 120 s), so a follower parked in the
gather across an idle serving lull would die.

Rank 0 publishes the whole padded batch so that every rank runs the same
program on the same data; each rank places only its own lane block.

Failure semantics: any rank death kills the whole world (see
``distributed/world.py``) — the front-end dies WITH its followers, its
poll URLs survive in the job journal, the router ejects the slice, and the
slice supervisor (``cli serve-slice``) relaunches a smaller world on the
same port and journal, which replays and re-registers. No half-alive
slice ever serves, and rank 0 never carries on without its followers.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Optional

import numpy as np

from distributedlpsolver_tpu_torch.distributed.world import World, exit_on_peer_loss

# Control-plane record kinds.
KIND_BUCKET = "bucket"
KIND_STOP = "stop"


def canonical_bucket_config(cfg):
    """The solver-config normalization the SolveService applies before
    bucket dispatch — ONE definition so rank 0 (inside the service) and
    the followers (from the same CLI flags) derive identical static
    arguments, and so the same program keys."""
    return cfg.replace(
        verbose=False,
        log_jsonl=None,
        checkpoint_path=None,
        checkpoint_every=0,
        profile_dir=None,
    )


class FileControlPlane:
    """Atomic-rename dispatch journal under ``path`` (see the module note).

    Writer (rank 0): ``publish(meta, arrays)`` → strictly increasing
    sequence numbers. Readers (followers): ``next_dispatch(after)`` polls
    for the next sequence. Records are never mutated; a reader can lag
    and still replay the exact order."""

    def __init__(self, path: str, poll_s: float = 0.002):
        self.path = path
        self.poll_s = poll_s
        os.makedirs(path, exist_ok=True)
        self._seq = 0

    def _fname(self, seq: int) -> str:
        return os.path.join(self.path, f"d{seq:08d}.npz")

    def publish(self, meta: dict, arrays: Optional[dict] = None) -> int:
        seq = self._seq
        buf = io.BytesIO()
        np.savez(
            buf,
            __meta__=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
            **(arrays or {}),
        )
        tmp = self._fname(seq) + f".{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(buf.getvalue())
            fh.flush()
        os.replace(tmp, self._fname(seq))
        self._seq = seq + 1
        return seq

    def publish_stop(self) -> int:
        return self.publish({"kind": KIND_STOP})

    def read(self, seq: int):
        with np.load(self._fname(seq), allow_pickle=False) as data:
            meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
            arrays = {k: np.array(data[k]) for k in data.files if k != "__meta__"}
        return meta, arrays

    def next_dispatch(self, after: int, timeout_s: Optional[float] = None):
        """Poll for sequence ``after + 1``; returns (seq, meta, arrays) or
        None on timeout. Sequences are dense, so waiting for exactly the
        next one keeps the dispatch order however far a follower lags."""
        want = after + 1
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        path = self._fname(want)
        while not os.path.exists(path):
            if deadline is not None and time.monotonic() > deadline:
                return None
            time.sleep(self.poll_s)
        # The writer renames atomically, so existence implies integrity.
        meta, arrays = self.read(want)
        return want, meta, arrays


def execute_dispatch(mesh, solver_config, meta: dict, arrays: dict):
    """Run one published dispatch — the ONE code path rank 0 and every
    follower share, so the program keys cannot diverge across the world.
    Returns the whole bucket's BatchedResult on every rank (followers drop
    it; rank 0 demuxes it)."""
    from distributedlpsolver_tpu_torch.backends.batched import solve_bucket
    from distributedlpsolver_tpu_torch.backends.first_order import solve_pdhg_bucket
    from distributedlpsolver_tpu_torch.ipm.state import IPMState
    from distributedlpsolver_tpu_torch.models.generators import BatchedLP

    cfg = solver_config.replace(tol=float(meta["tol"]))
    kwargs = {}
    if meta.get("max_iter"):
        kwargs["max_iter"] = int(meta["max_iter"])
    batch = BatchedLP(c=arrays["c"], A=arrays["A"], b=arrays["b"],
                      name=str(meta.get("name", "slice-bucket")))
    active = arrays["active"].astype(bool)
    if meta["engine"] == "pdhg":
        return solve_pdhg_bucket(batch, active, cfg, mesh=mesh, seeds=arrays.get("seeds"),
                                 **kwargs)
    warm = warm_mask = None
    if "wx" in arrays:
        warm = IPMState(x=arrays["wx"], y=arrays["wy"], s=arrays["ws"], w=arrays["ww"],
                        z=arrays["wz"])
        warm_mask = arrays["wm"].astype(bool)
    return solve_bucket(batch, active, cfg, mesh=mesh, warm=warm, warm_mask=warm_mask, **kwargs)


class SliceRunner:
    """Rank 0's dispatch seam: the SolveService hands every bucket
    dispatch here instead of placing and solving locally;
    publish-then-execute keeps the followers in lockstep."""

    def __init__(self, world: World, control: FileControlPlane, solver_config):
        self.world = world
        self.control = control
        self.solver_config = canonical_bucket_config(solver_config)
        self._mesh = world.mesh(axis="batch")
        self._lock = threading.Lock()  # publish order == execute order
        self.dispatches = 0  # guarded-by: _lock

    @property
    def mesh(self):
        return self._mesh

    def dispatch(self, spec, tol: float, engine: str, batch_host, active_host, warm_host=None,
                 warm_mask=None, max_iter: Optional[int] = None, seeds=None, trace=None):
        """Publish one bucket dispatch and execute it on the world's mesh.
        ``batch_host`` is the padded host BatchedLP, ``warm_host`` the host
        warm-lane IPMState (or None), ``seeds`` the PDHG lanes' start
        indices. ``trace`` (the members' trace headers) rides the meta,
        never a program key, so followers join the traces as their own
        child spans."""
        meta = {
            "kind": KIND_BUCKET, "m": int(spec.m), "n": int(spec.n), "batch": int(spec.batch),
            "tol": float(tol), "engine": engine, "max_iter": int(max_iter) if max_iter else 0,
            "name": getattr(batch_host, "name", "slice-bucket"),
        }
        if trace:
            meta["trace"] = list(trace)
        arrays = {
            "c": np.asarray(batch_host.c, dtype=np.float64),
            "A": np.asarray(batch_host.A, dtype=np.float64),
            "b": np.asarray(batch_host.b, dtype=np.float64),
            "active": np.asarray(active_host, dtype=bool),
        }
        if engine == "pdhg" and seeds is not None:
            arrays["seeds"] = np.asarray(seeds, dtype=np.int64)
        if engine != "pdhg" and warm_host is not None:
            arrays.update(
                wx=np.asarray(warm_host.x, dtype=np.float64),
                wy=np.asarray(warm_host.y, dtype=np.float64),
                ws=np.asarray(warm_host.s, dtype=np.float64),
                ww=np.asarray(warm_host.w, dtype=np.float64),
                wz=np.asarray(warm_host.z, dtype=np.float64),
                wm=np.asarray(warm_mask, dtype=bool),
            )
        with self._lock:
            self.control.publish(dict(meta), arrays)
            self.dispatches += 1
            try:
                return execute_dispatch(self._mesh, self.solver_config, meta, arrays)
            except RuntimeError as e:
                # A follower died: the world dies as a unit. Rank 0 never
                # retries or answers alone without its followers.
                exit_on_peer_loss(self.world, e)
                raise

    def stop(self) -> None:
        with self._lock:
            self.control.publish_stop()


def follower_loop(world: World, control: FileControlPlane, solver_config,
                  idle_timeout_s: Optional[float] = None) -> int:
    """A follower rank's serving loop: execute every published dispatch
    in order until a stop record (clean shutdown), the idle timeout, or
    rank 0's death (the world's heartbeat monitor ends the process).
    Between dispatches it polls the journal, never a collective. Returns
    the number of dispatches executed."""
    from distributedlpsolver_tpu_torch.obs import context as obs_context
    from distributedlpsolver_tpu_torch.obs import trace as obs_trace

    cfg = canonical_bucket_config(solver_config)
    mesh = world.mesh(axis="batch")
    seq, executed = -1, 0
    while True:
        nxt = control.next_dispatch(seq, timeout_s=idle_timeout_s)
        if nxt is None:
            return executed
        seq, meta, arrays = nxt
        if meta.get("kind") == KIND_STOP:
            return executed
        t0 = time.perf_counter()
        try:
            execute_dispatch(mesh, cfg, meta, arrays)
        except RuntimeError as e:
            exit_on_peer_loss(world, e)  # rank 0 (or a peer) died mid-gather
            raise
        executed += 1
        tr = obs_trace.get_tracer()
        if tr.enabled:
            # One follower-side span a dispatch, carrying every member's
            # trace id and the first context's child identity.
            ctxs = [c for c in (obs_context.parse(h) for h in (meta.get("trace") or []))
                    if c is not None]
            span_args = {"rank": world.rank, "dispatch": seq, "engine": meta.get("engine")}
            if ctxs:
                span_args.update(ctxs[0].span_args())
                span_args["trace_ids"] = [c.trace_id for c in ctxs]
            tr.complete(f"slice.execute #{seq}", time.perf_counter() - t0, cat="slice",
                        args=span_args)
