"""Config registry of the port: ``get_config("<arch-id>")`` at full
scale and ``reduced_config("<arch-id>")`` for the CPU tests (same family
and topology, tiny dims). Copies of the JAX package's ``repro.configs``
for all ten architectures, in its order.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.config.base import MLAConfig, ModelConfig, SSMConfig
from repro_torch.configs.shapes import (SHAPES, ShapeConfig,  # noqa: F401
                                        applicable)

ARCH_IDS: List[str] = [
    "xlstm-125m",
    "smollm-135m",
    "starcoder2-3b",
    "olmo-1b",
    "yi-9b",
    "musicgen-large",
    "jamba-v0.1-52b",
    "llama4-scout-17b-a16e",
    "deepseek-v3-671b",
    "qwen2-vl-7b",
]

_MODULES = {
    "xlstm-125m": "xlstm_125m",
    "smollm-135m": "smollm_135m",
    "starcoder2-3b": "starcoder2_3b",
    "olmo-1b": "olmo_1b",
    "yi-9b": "yi_9b",
    "musicgen-large": "musicgen_large",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

_cache: Dict[str, ModelConfig] = {}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _cache:
        if arch_id not in _MODULES:
            raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
        mod = importlib.import_module(
            f"repro_torch.configs.{_MODULES[arch_id]}")
        _cache[arch_id] = mod.make_config()
    return _cache[arch_id]


def reduced_config(arch_id: str) -> ModelConfig:
    """The JAX package's reduction: at most 4 heads of width 16, d_ff
    4 * d_model, vocab 256, two periods, float32; M-RoPE sections (2, 3,
    3) (they sum to the reduced head dim / 2); MoE at 4 experts of d_ff
    2 * d_model with capacity factor 4 (drop-free routing, so decode
    equals teacher forcing; production keeps 1.25 and drops); MLA at
    ranks q 32 (where the arch has a query rank), kv 32, nope 16, rope 8
    and v 16 (head dim 24); and an SSM of state 8 for the ssm and hybrid
    families."""
    cfg = get_config(arch_id)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    if heads % kv:
        kv = 1
    d_model = 16 * heads
    changes = dict(
        name=cfg.name + "-reduced",
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=(4 * d_model) if cfg.d_ff else 0,
        vocab_size=256,
        max_position=4096,
        num_layers=len(cfg.prefix_pattern) + 2 * len(cfg.period_pattern),
        remat="none",
        fsdp=False,
        dtype="float32",
    )
    if cfg.mrope_sections:
        changes["mrope_sections"] = (2, 3, 3)
    if cfg.moe.num_experts:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff=2 * d_model, capacity_factor=4.0)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(
            q_lora_rank=32 if cfg.mla.q_lora_rank else 0,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16)
        changes["head_dim"] = 24
    if cfg.family in ("ssm", "hybrid"):
        changes["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
    return dataclasses.replace(cfg, **changes)
