"""Parallelism over the process group (port of fastvision_tpu/parallel):
FSDP, tensor parallel (channel-sharded convs and linears), time sharding (a
clip's frames over the mesh's time axis) and GPipe pipelines (stages over
the mesh's model axis)."""
from .fsdp import (
    fsdp_shard_module,
    fsdp_spec,
    full_state,
    load_full_state,
    rebind_optimizer,
)
from .pipeline import (
    pipeline_apply,
    pipeline_hetero_apply,
    pipeline_vit_apply,
    resnet_stage_split,
    stack_stage_params,
    vit_stage_split,
)
from .tensor_shard import shard_module, tp_spec
from .time_shard import halo_exchange_time, time_sharded_conv, time_sum

shard_variables = shard_module  # the JAX package's name for the same placement

__all__ = ["fsdp_shard_module", "fsdp_spec", "full_state", "load_full_state",
           "rebind_optimizer", "shard_module", "shard_variables", "tp_spec",
           "halo_exchange_time", "time_sharded_conv", "time_sum", "pipeline_apply",
           "pipeline_hetero_apply", "pipeline_vit_apply", "resnet_stage_split",
           "stack_stage_params", "vit_stage_split"]
