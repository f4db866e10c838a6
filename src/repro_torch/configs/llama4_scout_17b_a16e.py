"""llama4-scout-17b-a16e — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1 with a
shared expert on every layer. (Early-fusion vision frontend is outside the
assigned backbone; text tokens exercise the vocab path.)
"""
from repro_torch.config.base import ModelConfig, MoEConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        norm="rmsnorm",
        rope="rope",
        rope_theta=500_000.0,
        mlp="swiglu",
        period_pattern=(("attn", "moe"),),
        moe=MoEConfig(num_experts=16, top_k=1, num_shared_experts=1,
                      d_ff=8192),
        fsdp=True,
        sequence_parallel=True,
        remat="dots_nb",
    )
