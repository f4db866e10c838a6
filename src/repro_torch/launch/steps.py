"""Serving steps of the LM on one card (port of the two step functions
of ``repro/launch/steps.py:build_serve_step``, without mesh or
sharding), and the step inputs of ``input_specs``. Each step returns
the last position's logits, for next-token sampling, and the cache,
which the step has written in place: the counterpart of the JAX step's
donated cache.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import forward


def cache_len(shape: ShapeConfig) -> int:
    """Cache allocation length, padded to a multiple of 512 (decode
    holds seq_len history plus the token being written)."""
    need = shape.seq_len if shape.kind == "prefill" else shape.seq_len + 1
    return ((need + 511) // 512) * 512


def input_specs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Seeded step inputs of the JAX package's ``input_specs`` shapes and
    dtypes, on ``device`` (CUDA unless the caller passes "cpu"):
    ``inputs`` int32 tokens (B, S) below the vocabulary, or bfloat16
    embeddings (B, S, D) of a standard normal; ``labels`` int32 (B, S)
    for a train step; M-RoPE ``positions`` int32 (P, B, S), the default
    positions (the sequence slots on every axis). S is the shape's
    seq_len for train and prefill and 1 for decode, whose token sits at
    slot seq_len."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = shape.global_batch
    S = shape.seq_len if shape.kind in ("train", "prefill") else 1
    if cfg.input_mode == "tokens":
        inputs = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=dev, dtype=torch.int32)
    else:
        inputs = torch.randn((B, S, cfg.d_model), generator=gen,
                             device=dev).to(torch.bfloat16)
    specs = {"inputs": inputs}
    if shape.kind == "train":
        specs["labels"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)
    if cfg.rope == "mrope":
        start = shape.seq_len if shape.kind == "decode" else 0
        pos = torch.arange(start, start + S, dtype=torch.int32, device=dev)
        specs["positions"] = pos.expand(cfg.num_position_dims, B,
                                        S).contiguous()
    return specs


@torch.no_grad()
def serve_prefill(params, cfg: ModelConfig, cache, inputs, positions=None):
    """Fill ``cache`` from position 0 with the prompts ``inputs``: tokens
    (B, S) or embeddings (B, S, D), with M-RoPE ``positions`` (P, B, S)
    where given; returns (logits (B, V) at the last prompt position,
    cache)."""
    logits, cache, _ = forward(params, cfg, inputs, positions=positions,
                               cache=cache, cache_index=0, mode="prefill")
    return logits[:, -1, :], cache


@torch.no_grad()
def serve_decode(params, cfg: ModelConfig, cache, inputs, cache_index,
                 positions=None):
    """One step: ``inputs`` (tokens (B, 1) or embeddings (B, 1, D)) at
    position ``cache_index`` (an int or a 0-d device tensor) against
    ``cache``; returns (logits (B, V), cache)."""
    logits, cache, _ = forward(params, cfg, inputs, positions=positions,
                               cache=cache, cache_index=cache_index,
                               mode="decode")
    return logits[:, -1, :], cache
