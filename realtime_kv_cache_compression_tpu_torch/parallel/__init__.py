"""Sequence parallelism over `torch.distributed` process groups.

Port of the sequence-parallel half of the JAX package's `parallel/`: rank
meshes (`mesh.py`), the collectives every parallel path issues
(the package's leaf module `comm.py`, re-exported here), ring prefill attention (`ring_attention.py`) and the
sequence-parallel compressed prefill with its sharded compression
(`seq_parallel.py`); `launch.run_ranks` runs a function on N spawned
ranks. Tensor, pipeline and expert parallelism and the multi-host helpers
(the JAX package's `sharding.py`, `pipeline.py`, `expert_parallel.py`,
`multihost.py`) are not ported yet (ROADMAP Queue 1, item 18).
"""

from .. import comm  # noqa: F401 (the collectives, a leaf module)
from .launch import run_ranks
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, create_mesh,
                   single_device_mesh)
from .ring_attention import ring_prefill_attention
from .seq_parallel import (SEQ_AXIS, create_seq_mesh, gather_sharded_state,
                           seq_parallel_prefill)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh", "create_mesh",
    "create_seq_mesh", "gather_sharded_state", "ring_prefill_attention",
    "run_ranks", "seq_parallel_prefill", "single_device_mesh",
]
