"""jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Period of 8: attention at index 4, Mamba elsewhere; MoE every 2nd layer.
No positional encodings (Mamba carries position). SSM-dominant hybrid ⇒
long_500k applies.
"""
from repro_torch.config.base import ModelConfig, MoEConfig, SSMConfig


def make_config() -> ModelConfig:
    period = tuple(
        ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "mlp")
        for i in range(8))
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        norm="rmsnorm",
        rope="none",
        mlp="swiglu",
        period_pattern=period,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        fsdp=True,
        sequence_parallel=True,
        remat="dots_nb",
    )
