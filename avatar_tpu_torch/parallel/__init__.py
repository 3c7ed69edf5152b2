"""Multi-device execution on ``torch.distributed`` (port of
``avatar_tpu/parallel``): one process per device, meshes of named process
groups, sequence, pipeline and tensor parallelism, and the placement
rules of the sharded training modes."""

from avatar_tpu_torch.parallel.distributed import (
    gather_to_host,
    global_batch_from_local,
    initialize,
    is_main_process,
    process_count,
    process_index,
    process_local_slice,
    put_global,
    shard_pytree_global,
    sync_processes,
)
from avatar_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    dit_apply_tp,
    dit_param_sharding,
    make_mesh,
    opt_state_sharding,
    param_sharding,
    replicated,
    shard_dit_params_tp,
    shard_pytree,
)
from avatar_tpu_torch.parallel.pipeline import (
    dit_apply_pp,
    make_pp_mesh,
    pp_param_sharding,
    stack_block_params,
    unstack_block_params,
)
from avatar_tpu_torch.parallel.sequence import (
    dit_apply_sp,
    ring_attention,
    ring_flash_attention,
    ulysses_attention,
    ulysses_cross_attention,
)

__all__ = [
    "Mesh",
    "dit_param_sharding",
    "dit_apply_tp",
    "shard_dit_params_tp",
    "make_mesh",
    "batch_sharding",
    "param_sharding",
    "opt_state_sharding",
    "replicated",
    "shard_pytree",
    "initialize",
    "is_main_process",
    "process_index",
    "process_count",
    "process_local_slice",
    "global_batch_from_local",
    "put_global",
    "shard_pytree_global",
    "gather_to_host",
    "sync_processes",
    "dit_apply_pp",
    "make_pp_mesh",
    "pp_param_sharding",
    "stack_block_params",
    "unstack_block_params",
    "dit_apply_sp",
    "ring_attention",
    "ring_flash_attention",
    "ulysses_attention",
    "ulysses_cross_attention",
]
