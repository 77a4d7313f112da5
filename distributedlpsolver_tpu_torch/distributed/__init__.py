"""Multi-process runtime: ``torch.distributed`` process groups as
first-class citizens of the solver (the JAX package's ``distributed/``).

- :mod:`distributed.world` — the process-group runtime: the ``DLPS_*``
  env contract, the choice of device and backend (NCCL, or gloo when
  asked), small collectives, and the per-rank heartbeat files the death
  detectors read.
- :mod:`distributed.launcher` — single-machine N-process harness: the
  rendezvous port, rank/world env, log capture, and the coordinator-level
  recovery supervisor (a dead rank ends the world as a unit; recovery
  relaunches a SMALLER world that resumes from the checkpoint).
- :mod:`distributed.worker` — ``python -m …distributed.worker`` rank
  entry with a small registry of world tasks.

Not ported yet: ``distributed/slice.py`` (one service per slice,
ROADMAP Queue 1 item 13b).
"""

from distributedlpsolver_tpu_torch.distributed.world import (  # noqa: F401
    World,
    WorldConfig,
    init_world,
    world_from_env,
)
