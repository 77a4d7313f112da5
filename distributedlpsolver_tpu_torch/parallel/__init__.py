"""Process-group meshes and the multi-process runtime (``torch.distributed``)."""

from distributedlpsolver_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    col_sharding,
    host_value,
    host_values,
    is_multiprocess,
    make_hybrid_mesh,
    make_mesh,
    reform_mesh,
    replicated,
    vec_sharding,
)
from distributedlpsolver_tpu_torch.parallel.runtime import (
    init_distributed,
    is_primary,
    probe_device,
    probe_devices,
    restore_devices,
    simulate_device_loss,
    simulated_lost_devices,
    world,
)

__all__ = [
    "Mesh",
    "Sharding",
    "batch_sharding",
    "make_mesh",
    "make_hybrid_mesh",
    "reform_mesh",
    "is_multiprocess",
    "host_values",
    "host_value",
    "col_sharding",
    "vec_sharding",
    "replicated",
    "init_distributed",
    "world",
    "is_primary",
    "simulate_device_loss",
    "restore_devices",
    "simulated_lost_devices",
    "probe_device",
    "probe_devices",
]
