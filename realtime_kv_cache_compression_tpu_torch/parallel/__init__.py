"""Parallelism over `torch.distributed` process groups.

Port of the JAX package's `parallel/`, one process per rank where JAX
runs one process over a device mesh: rank meshes (`mesh.py`), every
parallel path's collectives (the package's leaf module
`comm.py`, re-exported here), tensor and data parallelism over a (data,
model) mesh (`sharding.py`: `shard_params` gives each rank its slice and
the prefill and decode functions of `models/llama.py` run on it), expert
parallelism (`expert_parallel.py`), ring prefill attention
(`ring_attention.py`) and the sequence-parallel compressed prefill with
its sharded compression (`seq_parallel.py`); `launch.run_ranks` runs a
function on N spawned ranks. Pipeline parallelism and the multi-host
helpers (the JAX package's `pipeline.py`, `multihost.py`) are not ported
yet (ROADMAP Queue 1, item 18).
"""

from .. import comm  # noqa: F401 (the collectives, a leaf module)
from .expert_parallel import ep_moe_mlp
from .launch import run_ranks
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, create_mesh,
                   single_device_mesh)
from .ring_attention import ring_prefill_attention
from .seq_parallel import (SEQ_AXIS, create_seq_mesh, gather_sharded_state,
                           seq_parallel_prefill)
from .sharding import (ShardedParams, ShardLayout, constrain_decode_state,
                       param_specs, shard_batch, shard_layout, shard_params,
                       tier_cache_specs)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh", "ShardLayout",
    "ShardedParams", "constrain_decode_state", "create_mesh",
    "create_seq_mesh", "ep_moe_mlp", "gather_sharded_state", "param_specs",
    "ring_prefill_attention", "run_ranks", "seq_parallel_prefill",
    "shard_batch", "shard_layout", "shard_params", "single_device_mesh",
    "tier_cache_specs",
]
