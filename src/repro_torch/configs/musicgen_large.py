"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048. The EnCodec modality
frontend is a STUB: ``input_specs()`` supplies precomputed frame embeddings
(B, S, d_model); the LM head projects onto the 2048-entry codebook.
"""
from repro_torch.config.base import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        norm="layernorm",
        rope="none",
        pos_emb="learned",
        max_position=65_536,
        mlp="gelu",
        input_mode="embeddings",
        period_pattern=(("attn", "mlp"),),
        sequence_parallel=True,
        remat="dots_nb",
    )
