"""Model registry facade: params/loss/prefill/decode per ArchConfig
(port of ``repro.models.registry``)."""
from __future__ import annotations

import torch

from .transformer import (  # noqa: F401
    ModelSettings,
    cache_spec,
    count_params,
    decode_step,
    init_params,
    lm_loss,
    param_specs,
    prefill,
)


def input_batch_specs(cfg, shape, dtype_tokens="int32"):
    """``meta`` tensors standing in for every model input of a shape cell."""
    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": spec((B, S), torch.int32), "labels": spec((B, S), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = spec((B, cfg.enc_frames, cfg.d_model), torch.bfloat16)
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": spec((B, S), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = spec((B, cfg.enc_frames, cfg.d_model), torch.bfloat16)
        return batch
    # decode: one new token against a seq_len cache
    return {"token": spec((B, 1), torch.int32),
            "cache": cache_spec(cfg, B, S, mode="spec")}
