"""Parallel training of the port over ``torch.distributed``: the process
group and the five-axis mesh (``mesh``), the sharding rules and layouts
(``sharding``), the collectives with the block-scaled int8 payloads of
EQuARX and the differentiable ``ppermute`` / tiled all-to-all
(``collectives``), sequence parallelism inside the model (``ring_attention``,
``ulysses``), tensor parallelism (Megatron's column- and row-parallel ViT
blocks: ``sharding.bind_tensor_parallel``, ``collectives.copy_to_model`` /
``reduce_from_model``), the GPipe pipeline (``pipeline``,
``pipeline_train``) and the mixture of experts with expert parallelism
(``moe``: ``MoEMlp``, ``MOE_RULES``, ``bind_expert_parallel``)."""

from .mesh import (DATA_AXIS, EXPERT_AXIS, FSDP_AXIS,  # noqa: F401
                   MODEL_AXIS, SEQ_AXIS, Mesh, MeshConfig, build_mesh,
                   data_parallel_mesh, initialize_distributed)
from .sharding import (FSDP_RULES, TRANSFORMER_TP_RULES,  # noqa: F401
                       batch_sharding, batch_spec, make_global_array,
                       replicated, shard_params_tree)
from .ring_attention import (make_ring_attention,  # noqa: F401
                             make_ring_attn_fn, ring_attention)
from .ulysses import (make_ulysses_attention,  # noqa: F401
                      make_ulysses_attn_fn, ulysses_attention)
from .pipeline import (pack_stages, pipeline_apply,  # noqa: F401
                       pipeline_apply_heterogeneous, stack_stage_params)
from .moe import MOE_RULES, MoEMlp, bind_expert_parallel  # noqa: F401
from .pipeline_train import (make_pipeline_train_step,  # noqa: F401
                             make_vit_pipeline_forward,
                             shard_pipeline_state, split_vit_params,
                             vit_pipeline_module)
