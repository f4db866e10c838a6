"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.config.base import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        norm="rmsnorm",
        rope="rope",
        rope_theta=10_000.0,
        mlp="swiglu",
        tie_embeddings=True,
        period_pattern=(("attn", "mlp"),),
        remat="dots_nb",
    )
