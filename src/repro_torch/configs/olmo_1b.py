"""olmo-1b — non-parametric LN [arXiv:2402.00838; hf].

16L d_model=2048 16H (MHA: kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.config.base import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        norm="nonparam_ln",
        rope="rope",
        mlp="swiglu",
        tie_embeddings=True,
        period_pattern=(("attn", "mlp"),),
        sequence_parallel=True,
        remat="dots_nb",
    )
