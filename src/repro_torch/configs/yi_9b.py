"""yi-9b — llama-arch GQA [arXiv:2403.04652; hf].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.config.base import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        norm="rmsnorm",
        rope="rope",
        rope_theta=5_000_000.0,
        mlp="swiglu",
        period_pattern=(("attn", "mlp"),),
        fsdp=True,
        sequence_parallel=True,
        remat="dots_nb",
    )
