"""The LM input shapes (copy of the JAX package's ``configs/shapes.py``).
``decode_*``/``long_*`` are one new token against a ``seq_len`` cache,
``prefill_32k`` fills a cache, ``train_4k`` is a training step;
``applicable`` is the skip rule of the dry run's cells.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int       # context length (cache length for decode)
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def applicable(cfg, shape: ShapeConfig) -> bool:
    """long_500k only for sub-quadratic archs (see DESIGN.md §4)."""
    if shape.name == "long_500k":
        return cfg.is_subquadratic
    return True
