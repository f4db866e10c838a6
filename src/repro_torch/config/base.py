"""The configs the ported serving paths need: the decoder-only LM
(``ModelConfig`` and its sub-configs), the UNet variant and the per-tier
execution-latency profile e(b). Copies of the JAX package's classes of
the same names, with the same fields and defaults; ``ServingConfig`` and
the cascade specs come with the control plane. Pure data: nothing here
touches a device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

# A transformer stack is (prefix_pattern, period_pattern * n_periods).
# Each entry is (mixer, ffn): mixer in {"attn", "mla", "mamba", "mlstm",
# "slstm"}, ffn in {"mlp", "moe", None}.
BlockSpec = Tuple[str, Optional[str]]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff: int = 0                     # per-expert hidden dim
    router_aux_coef: float = 0.001    # load-balance loss coefficient
    router_dtype: str = "float32"
    capacity_factor: float = 1.25     # per-expert buffer slack (drops above)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""
    q_lora_rank: int = 0              # 0 => dense q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                  # 0 => ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0          # mLSTM up-projection
    conv_kernel: int = 4
    slstm_proj_factor: float = 4.0 / 3.0


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only LM. The port runs the "attn", "mamba", "mlstm" and
    "slstm" mixers with "mlp", "moe" or no FFN; the "mla" mixer and
    M-RoPE are listed in ROADMAP.md."""
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads

    # Norm / position / activations
    norm: str = "rmsnorm"             # rmsnorm | layernorm | nonparam_ln
    norm_eps: float = 1e-5
    rope: str = "rope"                # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()
    pos_emb: str = "none"             # none | learned
    mlp: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = False
    max_position: int = 1 << 20

    # Block layout
    prefix_pattern: Tuple[BlockSpec, ...] = ()
    period_pattern: Tuple[BlockSpec, ...] = (("attn", "mlp"),)

    # Sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: Optional[MLAConfig] = None
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)

    # Frontend
    input_mode: str = "tokens"        # tokens | embeddings
    num_position_dims: int = 1        # 3 for M-RoPE (t, h, w)

    # Multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0

    # Implementation knobs of the JAX package (sharding, remat, scan);
    # kept so that a config is the same data in both packages
    attn_impl: str = "xla"
    remat: str = "none"
    scan_layers: bool = True
    dtype: str = "bfloat16"
    fsdp: bool = False
    sequence_parallel: bool = False
    opt_8bit_moments: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def n_periods(self) -> int:
        body = self.num_layers - len(self.prefix_pattern)
        if body % max(len(self.period_pattern), 1) != 0:
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by period "
                f"{len(self.period_pattern)}")
        return body // len(self.period_pattern)

    def flat_pattern(self) -> Tuple[BlockSpec, ...]:
        return self.prefix_pattern + self.period_pattern * self.n_periods


@dataclass(frozen=True)
class DiffusionConfig:
    """Latent-diffusion UNet variant (the paper's served model class)."""
    name: str
    image_size: int = 64              # latent resolution
    in_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16, 8)
    num_heads: int = 4
    text_dim: int = 256               # cross-attention conditioning width
    num_steps: int = 50               # sampler steps (1 for distilled "turbo")
    sampler: str = "ddim"             # ddim | euler
    dtype: str = "float32"


@dataclass(frozen=True)
class LatencyProfile:
    """Per-model execution-latency profile e(b) (seconds for a batch of b).

    ``base_s`` is batch-1 latency; ``marginal_s`` the per-extra-query
    cost. In the port both come from ``ClusterRuntime.measure_profile``
    on the device that serves the tier.
    """
    base_s: float
    marginal_s: float

    def exec_latency(self, batch: int) -> float:
        return self.base_s + self.marginal_s * max(batch - 1, 0)

    def throughput(self, batch: int) -> float:
        return batch / self.exec_latency(batch)
