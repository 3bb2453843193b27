"""Parallel training of the port over ``torch.distributed``: the process
group and the five-axis mesh (``mesh``), the sharding rules and layouts
(``sharding``), and the collectives with the block-scaled int8 payloads
of EQuARX (``collectives``). Sequence and pipeline parallelism and the
mixture of experts come with ROADMAP Queue 1 items 7b and 8."""

from .mesh import (DATA_AXIS, EXPERT_AXIS, FSDP_AXIS,  # noqa: F401
                   MODEL_AXIS, SEQ_AXIS, Mesh, MeshConfig, build_mesh,
                   data_parallel_mesh, initialize_distributed)
from .sharding import (FSDP_RULES, TRANSFORMER_TP_RULES,  # noqa: F401
                       batch_sharding, batch_spec, make_global_array,
                       replicated, shard_params_tree)
