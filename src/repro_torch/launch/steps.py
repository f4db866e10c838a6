"""Serving steps of the LM on one card (port of the two step functions
of ``repro/launch/steps.py:build_serve_step``, without mesh or
sharding). Each returns the last position's logits, for next-token
sampling, and the cache, which the step has written in place: the
counterpart of the JAX step's donated cache.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models.transformer import forward


def cache_len(shape: ShapeConfig) -> int:
    """Cache allocation length, padded to a multiple of 512 (decode
    holds seq_len history plus the token being written)."""
    need = shape.seq_len if shape.kind == "prefill" else shape.seq_len + 1
    return ((need + 511) // 512) * 512


@torch.no_grad()
def serve_prefill(params, cfg: ModelConfig, cache, tokens):
    """Fill ``cache`` from position 0 with the prompts ``tokens`` (B, S);
    returns (logits (B, V) at the last prompt position, cache)."""
    logits, cache = forward(params, cfg, tokens, cache=cache, cache_index=0,
                            mode="prefill")
    return logits[:, -1, :], cache


@torch.no_grad()
def serve_decode(params, cfg: ModelConfig, cache, tokens, cache_index):
    """One step: ``tokens`` (B, 1) at position ``cache_index`` (an int or
    a 0-d device tensor) against ``cache``; returns (logits (B, V),
    cache)."""
    logits, cache = forward(params, cfg, tokens, cache=cache,
                            cache_index=cache_index, mode="decode")
    return logits[:, -1, :], cache
