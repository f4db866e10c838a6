"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

61L d_model=7168 128H d_ff=2048(expert) vocab=129280, MoE 256e top-8.
First 3 layers dense (d_ff 18432), remaining 58 MoE. MLA latent cache
(kv_lora_rank 512 + 64 rope dims) is what makes decode_32k fit — see
EXPERIMENTS.md §Dry-run. MTP head enabled for training.
"""
from repro_torch.config.base import MLAConfig, ModelConfig, MoEConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=192,                  # qk_nope(128) + qk_rope(64)
        d_ff=18432,                    # dense prefix layers
        vocab_size=129280,
        norm="rmsnorm",
        rope="rope",
        rope_theta=10_000.0,
        mlp="swiglu",
        prefix_pattern=(("mla", "mlp"),) * 3,
        period_pattern=(("mla", "moe"),),
        moe=MoEConfig(num_experts=256, top_k=8, num_shared_experts=1,
                      d_ff=2048),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        mtp_depth=1,
        fsdp=True,
        sequence_parallel=True,
        remat="full",
        opt_8bit_moments=True,
    )
