"""qwen2-vl-7b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. The vision
frontend is a STUB: ``input_specs()`` supplies pre-merged patch+text
embeddings (B, S, d_model) with 3-axis M-RoPE position ids (t, h, w).
"""
from repro_torch.config.base import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        norm="rmsnorm",
        rope="mrope",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        mlp="swiglu",
        input_mode="embeddings",
        num_position_dims=3,
        period_pattern=(("attn", "mlp"),),
        fsdp=True,
        sequence_parallel=True,
        remat="dots_nb",
    )
