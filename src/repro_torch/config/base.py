"""The configs the diffusion serving path needs: the UNet variant and the
per-tier execution-latency profile e(b). Copies of the JAX package's
``DiffusionConfig`` and ``LatencyProfile``; ``ServingConfig`` and the
cascade specs come with the control plane. Pure data: nothing here
touches a device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
