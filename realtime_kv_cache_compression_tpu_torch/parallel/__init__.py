"""Parallelism over `torch.distributed` process groups.

Port of the JAX package's `parallel/`, one process per rank where JAX
runs one process over a device mesh: rank meshes (`mesh.py`), every
parallel path's collectives (the package's leaf module
`comm.py`, re-exported here), tensor and data parallelism over a (data,
model) mesh (`sharding.py`: `shard_params` gives each rank its slice and
the prefill and decode functions of `models/llama.py` run on it), expert
parallelism (`expert_parallel.py`), ring prefill attention
(`ring_attention.py`), the sequence-parallel compressed prefill with
its sharded compression and the decode from the slot-sharded state
(`seq_parallel.py`), pipeline parallelism over a
`pipe` axis (`pipeline.py`: GPipe training and `PipelineInference`) and
the multi-process driver (`multihost.py`: bring-up over a TCP
coordinator, the SPMD and serving checks, `launch_local_sim`);
`launch.run_ranks` runs a function on N spawned ranks.
"""

from .. import comm  # noqa: F401 (the collectives, a leaf module)
from .expert_parallel import ep_moe_mlp
from .launch import run_ranks
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, create_mesh,
                   create_pipe_mesh, single_device_mesh)
from .multihost import (global_params, initialize, launch_local_sim,
                        run_serving_check, run_spmd_check)
from .pipeline import (PipelineInference, pipeline_lm_loss,
                       pipeline_train_step, stack_pipeline_params,
                       unstack_pipeline_params)
from .ring_attention import ring_prefill_attention
from .seq_parallel import (SEQ_AXIS, create_seq_mesh, gather_sharded_state,
                           merge_slot_partials, seq_parallel_prefill)
from .sharding import (ShardedParams, ShardLayout, constrain_decode_state,
                       param_specs, shard_batch, shard_layout, shard_params,
                       tier_cache_specs)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "SEQ_AXIS", "Mesh",
    "PipelineInference", "ShardLayout", "ShardedParams",
    "constrain_decode_state", "create_mesh", "create_pipe_mesh",
    "create_seq_mesh", "ep_moe_mlp", "gather_sharded_state",
    "global_params", "initialize", "launch_local_sim", "merge_slot_partials",
    "param_specs",
    "pipeline_lm_loss", "pipeline_train_step", "ring_prefill_attention",
    "run_ranks", "run_serving_check", "run_spmd_check",
    "seq_parallel_prefill", "shard_batch", "shard_layout", "shard_params",
    "single_device_mesh", "stack_pipeline_params", "tier_cache_specs",
    "unstack_pipeline_params",
]
