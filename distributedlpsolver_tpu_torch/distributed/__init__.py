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
  entry with a small registry of world tasks: every task of the JAX
  package's worker, ``scenario_lanes`` (the scenario tier's lanes over the
  world) among them.
- :mod:`distributed.slice` — one SolveService per world: rank 0's HTTP
  front-end publishes each bucket dispatch to a file journal, every rank
  solves its lane block (``cli serve-slice``).
"""

from distributedlpsolver_tpu_torch.distributed.world import (  # noqa: F401
    World,
    WorldConfig,
    init_world,
    world_from_env,
)
