"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H d_ff=0 vocab=50304. No separate FFN (d_ff=0): the mLSTM
block carries its own 2x up-projection. Block mix: 5 mLSTM + 1 sLSTM per
period (mLSTM-dominant, xLSTM[a:b] style). Recurrent state is O(1) in
context ⇒ long_500k applies.
"""
from repro_torch.config.base import ModelConfig, XLSTMConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        norm="layernorm",
        rope="none",
        mlp="gelu",
        tie_embeddings=True,
        period_pattern=(("mlstm", None),) * 5 + (("slstm", None),),
        xlstm=XLSTMConfig(proj_factor=2.0, conv_kernel=4),
        remat="dots_nb",
    )
