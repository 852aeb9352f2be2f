"""Parallelism over the process group (port of fastvision_tpu/parallel):
FSDP, tensor parallel (channel-sharded convs and linears) and time
sharding (a clip's frames over the mesh's time axis). The pipeline is not
ported yet (ROADMAP Queue 1, item 17)."""
from .fsdp import (
    fsdp_shard_module,
    fsdp_spec,
    full_state,
    load_full_state,
    rebind_optimizer,
)
from .tensor_shard import shard_module, tp_spec
from .time_shard import halo_exchange_time, time_sharded_conv, time_sum

shard_variables = shard_module  # the JAX package's name for the same placement

__all__ = ["fsdp_shard_module", "fsdp_spec", "full_state", "load_full_state",
           "rebind_optimizer", "shard_module", "shard_variables", "tp_spec",
           "halo_exchange_time", "time_sharded_conv", "time_sum"]
