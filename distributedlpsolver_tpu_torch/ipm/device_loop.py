"""Run a masked loop body over a carry of device tensors — the port's
counterpart of ``lax.while_loop``.

The JAX package runs its fused IPM loop as one ``lax.while_loop``
program. :class:`DeviceLoop` runs ``body(carry, inputs) -> carry`` until
``cond(carry, inputs)`` is false:

* on the CPU it calls the body eagerly and tests ``cond`` on the host
  after each call;
* on a CUDA card it runs the first body eagerly (real work, which also
  initialises, on the loop's own stream, every library and kernel the
  body launches), then captures ONE body into a ``torch.cuda.CUDAGraph``
  over static copies of the carry and replays it. The host keeps
  ``DEPTH`` replays queued and reads each replay's packed meta (``meta``
  of the new carry and ``cond`` of it) through a pinned buffer and an
  event, so the device never waits on the host between iterations. Once a
  replay reports that the loop has exited, the host stops queuing: at most
  ``DEPTH - 1`` bodies run past the exit.

The body must mask every update with ``cond`` of its input carry, so a
body run after the exit leaves the carry bit for bit unchanged
(``core.fused_body`` does). ``inputs`` are device scalars the body and
``cond`` read (loop bounds); ``run`` sets them in place, so a new bound is
a fill, not a new capture. A failure to capture or replay raises: there
is no fallback to an eager loop on the card.

Launch counters: a kernel wrapper counts its launches in attributes such
as ``launches`` (``ops/kernel_build.count_launch``: process-wide, and per
thread). During capture the body's wrappers count launches that do not
run; the loop takes every one of those counts back (the capturing
thread's own, so another thread's launches meanwhile stay counted) and
adds them once per replay, so each counter stays the number of launches
that ran on the card.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from distributedlpsolver_tpu_torch.ops import kernel_build

# Replays in flight while the host waits on the oldest one's meta: two
# keep the device busy while the host reads, and let at most one body run
# past the exit.
DEPTH = 2


def flatten(tree):
    """The tensors of a carry (nested tuples and NamedTuples of tensors)
    in order, and a function that rebuilds the carry from new ones."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    leaves, parts = [], []
    for item in tree:
        sub, rebuild = flatten(item)
        parts.append((rebuild, len(sub)))
        leaves.extend(sub)
    make = getattr(type(tree), "_make", type(tree))

    def rebuild_all(new):
        out, i = [], 0
        for rebuild, n in parts:
            out.append(rebuild(new[i:i + n]))
            i += n
        return make(out)

    return leaves, rebuild_all


class DeviceLoop:
    """``while cond(carry): carry = body(carry)`` on the carry's device.

    ``body(carry, inputs)`` and ``cond(carry, inputs)`` take the carry and
    the dict ``inputs`` of device scalars; ``meta(carry)`` packs the
    scalars the caller reads after a run into a 1-D float tensor (launch
    counts: see the module note). One graph is captured at the first ``run`` that
    gets past its first body, and replayed by every later ``run`` until
    :meth:`close`.

    ``capture_on_exit`` captures the graph after the first eager body even
    when that body ends the loop, so a one-iteration first run (a serving
    bucket's warm-up) leaves the graph ready and later runs only replay.
    The capture is thread-local (``torch.cuda.graph``'s
    ``capture_error_mode="thread_local"``): other threads may use the card
    (allocate, copy, record events) while a loop captures, as the serve
    pack thread does.
    """

    def __init__(self, body, cond, meta, inputs: dict, capture_on_exit: bool = False):
        self._body, self._cond, self._meta = body, cond, meta
        self.inputs = inputs
        self.device = next(iter(inputs.values())).device
        self._capture_on_exit = capture_on_exit
        self.runs = self.eager = self.replays = self.masked = self.captures = 0
        # Device memory the capture reserved for the graph's private pool,
        # and the bytes of the static carry each replay updates in place.
        self.pool_bytes = self.carry_bytes = 0
        # Host-clock seconds of the eager first bodies (each read back), the
        # capture, and the replays (queued until the exit was read).
        self.eager_s, self.capture_s, self.replay_s = 0.0, None, 0.0
        self._graph = None
        self._static = None  # the carry's tensors the graph reads and writes
        self._out = None  # meta ++ [cond], written by each replay
        self._per_replay = {}
        self._stream = None
        self._pinned = None
        self._events = None

    def report(self) -> dict:
        """Runs, bodies run (eager + replays), replays past the exit, and
        the host-clock time of the eager bodies, the capture and the
        replays, of the loop so far."""
        return {
            "runs": self.runs,
            "captures": self.captures,
            "bodies": self.eager + self.replays,
            "eager": self.eager,
            "replays": self.replays,
            "masked": self.masked,
            "eager_ms": 1e3 * self.eager_s,
            "capture_ms": None if self.capture_s is None else 1e3 * self.capture_s,
            "replay_ms": 1e3 * self.replay_s,
        }

    def run(self, carry, **values):
        """Set ``inputs`` from ``values``, run the loop from ``carry``,
        and return ``(carry, meta)`` with ``meta`` on the host (numpy)."""
        self.runs += 1
        for name, v in values.items():
            self.inputs[name].fill_(v)
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            while bool(self._cond(carry, self.inputs)):
                carry = self._body(carry, self.inputs)
                self.eager += 1
            self.eager_s += time.perf_counter() - t0
            return carry, self._meta(carry).numpy()
        caller = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self._stream):
                return self._run_cuda(carry)
        finally:
            caller.wait_stream(self._stream)

    def close(self) -> None:
        """Free the graph and its memory pool. The carry a run returned
        stays valid (it was allocated outside the pool)."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._out = self._static = None
        self._pinned = self._events = None

    # -- CUDA ---------------------------------------------------------------
    def _step(self, leaves, rebuild):
        new = self._body(rebuild(leaves), self.inputs)
        meta = self._meta(new)
        go = self._cond(new, self.inputs).to(meta.dtype).reshape(1)
        return flatten(new)[0], torch.cat([meta.reshape(-1), go])

    def _run_cuda(self, carry):
        leaves, rebuild = flatten(carry)
        if self._graph is None:
            if not bool(self._cond(carry, self.inputs)):
                return carry, self._meta(carry).cpu().numpy()
            t0 = time.perf_counter()
            leaves, out = self._step(leaves, rebuild)
            self.eager += 1
            host = out.cpu().numpy()
            self.eager_s += time.perf_counter() - t0
            if host[-1] == 0:
                if self._capture_on_exit:
                    self._capture(leaves, rebuild)
                return rebuild(leaves), host[:-1]
            self._capture(leaves, rebuild)
        else:
            for st, v in zip(self._static, leaves):
                if st is not v:
                    st.copy_(v)
            if not bool(self._cond(rebuild(self._static), self.inputs)):
                return rebuild(self._static), self._meta(rebuild(self._static)).cpu().numpy()
        return rebuild(self._static), self._replay()

    def _capture(self, leaves, rebuild):
        t0 = time.perf_counter()
        self._static = [t.clone() for t in leaves]
        before = kernel_build.thread_counts()
        # torch.cuda.graph empties the allocator's cache on entry; doing it
        # first makes the reserved bytes' growth the graph pool's own.
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
            new, out = self._step(self._static, rebuild)
            for st, v in zip(self._static, new):
                st.copy_(v)
            self._out = out
        # The capture launched nothing: its calls become the per-replay count.
        self._per_replay = {key: n - before.get(key, 0)
                            for key, n in kernel_build.thread_counts().items()
                            if n != before.get(key, 0)}
        for (fn, attr), n in self._per_replay.items():
            kernel_build.count_launch(fn, -n, attr)
        self._graph = graph
        self.captures += 1
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.carry_bytes = sum(t.numel() * t.element_size() for t in self._static)
        slots = DEPTH + 1
        self._pinned = torch.empty((slots, out.numel()), dtype=out.dtype, pin_memory=True)
        self._events = [torch.cuda.Event() for _ in range(slots)]
        self.capture_s = time.perf_counter() - t0

    def _replay(self):
        """Replay until a replay reports the exit; its meta, on the host."""
        t0 = time.perf_counter()
        pending = collections.deque()
        queued, done = 0, None
        while True:
            if done is None:
                self._graph.replay()
                self.replays += 1
                for (fn, attr), n in self._per_replay.items():
                    kernel_build.count_launch(fn, n, attr)
                slot = queued % len(self._events)
                queued += 1
                self._pinned[slot].copy_(self._out, non_blocking=True)
                self._events[slot].record(self._stream)
                pending.append(slot)
                if len(pending) < DEPTH:
                    continue
            if not pending:
                self.replay_s += time.perf_counter() - t0
                return done
            slot = pending.popleft()
            self._events[slot].synchronize()
            if done is not None:
                self.masked += 1  # queued after the replay that exited
                continue
            vals = self._pinned[slot].numpy()
            if vals[-1] == 0:
                done = np.array(vals[:-1])
