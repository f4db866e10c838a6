"""Gradient compression for the data-parallel axis (port of
``repro/training/grad_compress.py``): top-k sparsification with error
feedback (memory-compensated SGD), plus int8 quantization. Cuts the
all-reduce's bytes 10-100x on slow links; the residual state keeps
convergence (Stich et al.).

Trees are the port's (``repro_torch/tree.py``). ``torch.topk`` may order
entries of equal magnitude otherwise than ``lax.top_k``; among distinct
magnitudes both keep the same entries in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.training.optimizer import dequantize8, quantize8
from repro_torch.tree import leaves, map_tree, unflatten


def compress_topk(g: torch.Tensor, frac: float = 0.01):
    """Keep the top-``frac`` entries by magnitude. Returns (idx, vals,
    shape), the wire format (int32 indices + values), 2 * frac of dense
    fp32."""
    flat = g.reshape(-1)
    k = max(int(frac * flat.numel()), 1)
    _, idx = torch.topk(flat.abs(), k)
    vals = flat[idx]
    return idx.to(torch.int32), vals, tuple(g.shape)


def decompress_topk(idx, vals, shape):
    flat = torch.zeros(math.prod(shape), dtype=vals.dtype,
                       device=vals.device)
    flat[idx.long()] = vals
    return flat.reshape(shape)


def compress_int8(g: torch.Tensor, block: int = 128):
    return quantize8(g.to(torch.float32), block)


def decompress_int8(q, scale, block: int = 128):
    return dequantize8(q, scale, block)


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: Any

    @classmethod
    def init(cls, grads):
        return cls(residual=map_tree(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads))


def ef_compress_step(grads, state: ErrorFeedbackState, frac: float = 0.01
                     ) -> Tuple[Any, ErrorFeedbackState]:
    """Error-feedback top-k: compress (grad + residual); the entries not
    sent become the next residual. Returns (the transmitted gradient as a
    dense tree, the new state); the (idx, vals) pairs are what crosses
    the link."""
    def one(g, r):
        corrected = g.to(torch.float32) + r
        idx, vals, shape = compress_topk(corrected, frac)
        sent = decompress_topk(idx, vals, shape)
        return sent, corrected - sent

    pairs = [one(g, r) for g, r in zip(leaves(grads),
                                       leaves(state.residual))]
    sent = unflatten(grads, [s for s, _ in pairs])
    resid = unflatten(grads, [r for _, r in pairs])
    return sent, ErrorFeedbackState(residual=resid)
