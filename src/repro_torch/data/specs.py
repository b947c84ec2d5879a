"""Meta-tensor stand-ins for every model input: the dry run's "data loader".

Port of ``repro.data.specs``. Nothing is allocated: the dry run runs the step
on these ``meta`` tensors, so a 314B-parameter (arch × shape × mesh) cell costs
dispatch time only.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingRules, to_placements


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Model inputs for one (arch × shape) cell, as ``meta`` tensors with the
    reference's shapes and dtypes.

    train/prefill: token batch (+ frontend stubs: VLM patch embeddings, whisper frame
    embeddings). decode: one token per sequence + the scalar position (the KV cache is
    a separate argument whose shapes come from ``models.lm.cache_shapes``).
    """
    B, S = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    f = lambda shp, dtype: torch.empty(shp, dtype=dtype, device="meta")
    if shape.mode == "decode":
        return {"tokens": f((B,), torch.int32), "pos": f((), torch.int32)}
    specs = {"tokens": f((B, S), torch.int32), "loss_mask": f((B, S), torch.float32)}
    if shape.mode == "train":
        specs["labels"] = f((B, S), torch.int32)
    if cfg.vlm:
        specs["patches"] = f((B, cfg.num_image_tokens, cfg.vit_dim), dt)
    if cfg.encdec:
        specs["frames"] = f((B, cfg.enc_seq, cfg.d_model), dt)
    return specs


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, rules: ShardingRules) -> dict:
    """Specs for the input batch: batch dim over dp, everything else local."""
    dp = rules.resolve("dp")
    if shape.mode == "decode":
        return {"tokens": (dp,), "pos": ()}
    specs = {"tokens": (dp, None), "loss_mask": (dp, None)}
    if shape.mode == "train":
        specs["labels"] = (dp, None)
    if cfg.vlm:
        specs["patches"] = (dp, None, None)
    if cfg.encdec:
        specs["frames"] = (dp, None, None)
    return specs


def batch_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: ShardingRules) -> dict:
    """The DTensor placements of each input on ``mesh``, by name."""
    return {k: to_placements(s, mesh) for k, s in batch_pspecs(cfg, shape, rules).items()}
