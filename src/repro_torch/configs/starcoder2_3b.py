"""starcoder2-3b — GQA, RoPE [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152. LayerNorm + GELU
MLP (StarCoder2 keeps the classic transformer MLP).
"""
from repro_torch.config.base import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        norm="layernorm",
        rope="rope",
        rope_theta=100_000.0,
        mlp="gelu",
        period_pattern=(("attn", "mlp"),),
        sequence_parallel=True,
        remat="dots_nb",
    )
