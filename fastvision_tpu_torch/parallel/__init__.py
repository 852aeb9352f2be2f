"""Parallelism over the process group: FSDP (port of
fastvision_tpu/parallel; tensor parallel, time sharding and the pipeline
are not ported yet: ROADMAP Queue 1, item 17)."""
from .fsdp import (
    fsdp_shard_module,
    fsdp_spec,
    full_state,
    load_full_state,
    rebind_optimizer,
)

__all__ = ["fsdp_shard_module", "fsdp_spec", "full_state", "load_full_state",
           "rebind_optimizer"]
