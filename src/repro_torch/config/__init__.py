"""Configuration dataclasses of the PyTorch port (own copies; the port
imports nothing from the JAX package)."""
from repro_torch.config.base import (DiffusionConfig, LatencyProfile,
                                     MLAConfig, ModelConfig, MoEConfig,
                                     SSMConfig, XLSTMConfig)

__all__ = ["DiffusionConfig", "LatencyProfile", "MLAConfig", "ModelConfig",
           "MoEConfig", "SSMConfig", "XLSTMConfig"]
