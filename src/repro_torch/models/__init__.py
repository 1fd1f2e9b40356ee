"""Model stack of the port: attention, MoE, SSM mixers, family composition,
registry (port of ``repro.models``, forward passes)."""
from .registry import (  # noqa: F401
    ModelSettings,
    cache_spec,
    count_params,
    decode_step,
    init_params,
    input_batch_specs,
    lm_loss,
    param_specs,
    prefill,
)
