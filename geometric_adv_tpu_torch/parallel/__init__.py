"""The process mesh and its sharding helpers
(``geometric_adv_tpu/parallel``).

The JAX package shards over a ``jax.sharding.Mesh`` of every chip. The port
runs one process per card under ``torch.distributed``: the mesh is the
process group, each pair-parallel stage (the attack's pair grid, the
chamfer matrix's pairs, the victim's eval-mode batched forward) gives each
rank its rows, and ``gather_global`` assembles the results on every rank.
Training under the mesh gives each rank its rows of every batch: the batch
norm sums its statistics over the ranks (``differentiable_all_reduce_sum``)
and the step sums the gradients (``all_reduce_sum``), over NCCL or gloo as
the layout allows (``device_backend``).
"""

from geometric_adv_tpu_torch.parallel.distributed import (
    all_reduce_sum,
    backend_for_layout,
    barrier,
    broadcast_object,
    device_backend,
    differentiable_all_reduce_sum,
    form_group,
    gather_global,
    host_local_batch_to_global,
    initialize_distributed,
    is_primary,
    make_global_replicated,
    maybe_initialize_from_env,
    shard_host_batch,
)
from geometric_adv_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    get_mesh,
    local_rows,
    pad_to_multiple,
    replicated,
    shard_batch,
)

__all__ = [
    "get_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "pad_to_multiple",
    "initialize_distributed",
    "maybe_initialize_from_env",
    "make_global_replicated",
    "shard_host_batch",
    "gather_global",
    "is_primary",
    "host_local_batch_to_global",
    "barrier",
    "local_rows",
    "all_reduce_sum",
    "differentiable_all_reduce_sum",
    "device_backend",
    "backend_for_layout",
    "form_group",
    "broadcast_object",
    "Mesh",
    "Sharding",
]
