"""Configuration dataclasses of the PyTorch port (own copies; the port
imports nothing from the JAX package)."""
from repro_torch.config.base import DiffusionConfig, LatencyProfile

__all__ = ["DiffusionConfig", "LatencyProfile"]
