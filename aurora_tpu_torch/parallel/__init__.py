"""Multi-device execution of the port (counterpart of ``aurora_tpu/parallel``): the process
runtime (:mod:`~aurora_tpu_torch.parallel.distributed`), the ``('data', 'lat', 'lon')`` mesh
of ranks (:mod:`~aurora_tpu_torch.parallel.mesh`), the placement of batches and parameters
over it (:mod:`~aurora_tpu_torch.parallel.sharding`) and the halo moves between the ranks'
blocks of the token grid (:mod:`~aurora_tpu_torch.parallel.halo`).

The data axis: each rank holds its slice of the batch, the ZeRO-split parameters are
gathered once before a forward, and the train steps average their gradients over ``data``.
The ``(lat, lon)`` split: each rank holds its block of the grid, the forward, the roll-outs
and the train steps run on it, thin halos move between blocks (and their gradients back, in
the backward), and the train steps sum their gradients over the ``(lat, lon)`` plane.

Serving under a ``(lat, lon)`` mesh, one process a rank::

    initialize(coordinator_address, num_processes, process_id)
    mesh = make_mesh(data=1, lat=2, lon=2)
    part = shard_batch(batch.crop(model.cfg.patch_size), mesh)
    with mesh:
        for pred in rollout(model, part, steps):
            whole = gather_batch(pred)
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
    gather_tensor,
    gathered_params,
    replicate,
    shard_batch,
    shard_batch_arrays,
    shard_params,
    shard_tensor,
    split_bounds,
    zero_partition_spec,
)
from aurora_tpu_torch.parallel import halo  # noqa: E402  (after sharding, which it uses)

__all__ = [
    "ATMOS_SPEC", "MESH_AXES", "Mesh", "STATIC_SPEC", "SURF_SPEC", "TOKENS_5D_SPEC",
    "auto_mesh", "constrain", "current_mesh", "gather_batch", "gather_tensor",
    "gathered_params", "halo", "initialize", "is_multi_host", "local_device_count",
    "make_mesh", "process_summary", "replicate", "shard_batch", "shard_batch_arrays",
    "shard_params", "shard_tensor", "split_bounds", "zero_partition_spec",
]
