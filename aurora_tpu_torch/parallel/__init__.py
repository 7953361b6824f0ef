"""Multi-device execution of the port (counterpart of ``aurora_tpu/parallel``): the process
runtime (:mod:`~aurora_tpu_torch.parallel.distributed`), the ``('data', 'lat', 'lon')`` mesh
of ranks (:mod:`~aurora_tpu_torch.parallel.mesh`) and the placement of batches and
parameters over it (:mod:`~aurora_tpu_torch.parallel.sharding`).

The data axis runs: each rank holds its slice of the batch, the ZeRO-split parameters are
gathered once before a forward, and the train steps average their gradients over ``data``.
The ``(lat, lon)`` split of the token grid is not ported yet: entering a mesh with ``lat``
or ``lon`` above 1 raises.
"""

from aurora_tpu_torch.parallel.distributed import (
    initialize,
    is_multi_host,
    local_device_count,
    process_summary,
)
from aurora_tpu_torch.parallel.mesh import MESH_AXES, Mesh, auto_mesh, current_mesh, make_mesh
from aurora_tpu_torch.parallel.sharding import (
    ATMOS_SPEC,
    STATIC_SPEC,
    SURF_SPEC,
    TOKENS_5D_SPEC,
    constrain,
    gather_batch,
    gathered_params,
    replicate,
    shard_batch_arrays,
    shard_params,
    zero_partition_spec,
)

__all__ = [
    "ATMOS_SPEC", "MESH_AXES", "Mesh", "STATIC_SPEC", "SURF_SPEC", "TOKENS_5D_SPEC",
    "auto_mesh", "constrain", "current_mesh", "gather_batch", "gathered_params", "initialize",
    "is_multi_host", "local_device_count", "make_mesh", "process_summary", "replicate",
    "shard_batch_arrays", "shard_params", "zero_partition_spec",
]
