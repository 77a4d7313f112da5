"""Process-group meshes and the multi-process runtime (``torch.distributed``)."""

from distributedlpsolver_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
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
    world,
)

__all__ = [
    "Mesh",
    "Sharding",
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
]
