"""Workload traces: static (Poisson), Azure-Functions-like diurnal traces,
and shape-preserving scaling (paper §4.1: "scale the trace using
shape-preserving transformations to match the capacity of our system").

A trace is a per-second QPS array; arrivals are drawn as an inhomogeneous
Poisson process from it.

PyTorch-port copy of ``repro/serving/trace.py`` (framework-free; imports
rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Trace:
    qps: np.ndarray                 # per-second demand
    name: str = "trace"

    @property
    def duration_s(self) -> float:
        return float(len(self.qps))

    def rate_at(self, t: float) -> float:
        """True demand rate at time ``t`` (clamped to the trace window;
        the oracle demand estimator reads this)."""
        if len(self.qps) == 0:
            return 0.0
        return float(self.qps[min(max(int(t), 0), len(self.qps) - 1)])

    def scale(self, min_qps: float, max_qps: float) -> "Trace":
        """Shape-preserving affine rescale into [min_qps, max_qps]."""
        lo, hi = float(self.qps.min()), float(self.qps.max())
        if hi - lo < 1e-9:
            return Trace(np.full_like(self.qps, max_qps),
                         f"{self.name}_{min_qps}to{max_qps}qps")
        scaled = min_qps + (self.qps - lo) * (max_qps - min_qps) / (hi - lo)
        return Trace(scaled, f"{self.name}_{min_qps}to{max_qps}qps")

    def scaled(self, k: float) -> "Trace":
        """Multiplicative overload scaling: ``k``x the offered QPS at
        every second, shape preserved (the degradation-curve sweeps run
        the same trace at 1x/4x/16x/64x). ``scaled(1.0)`` returns an
        equal-QPS trace, so goldens replayed through it stay
        bit-identical."""
        if k < 0:
            raise ValueError(f"load scale must be >= 0, got {k}")
        return Trace(self.qps * float(k), f"{self.name}_x{k:g}")

    def arrivals(self, rng: np.random.Generator) -> np.ndarray:
        """Arrival timestamps over the trace (inhomogeneous Poisson)."""
        times: List[float] = []
        for sec, rate in enumerate(self.qps):
            n = rng.poisson(rate)
            times.extend(sec + rng.random(n))
        return np.sort(np.asarray(times))


def static_trace(qps: float, duration_s: int = 360,
                 name: Optional[str] = None) -> Trace:
    return Trace(np.full(duration_s, float(qps)), name or f"static_{qps}qps")


def azure_like_trace(duration_s: int = 360, seed: int = 0,
                     burst_prob: float = 0.02) -> Trace:
    """Azure-Functions-shaped trace: a diurnal backbone compressed into the
    experiment window plus heavy-tailed invocation bursts (Shahrad et al.
    2020 report strong diurnality + bursts)."""
    rng = np.random.default_rng(seed)
    t = np.arange(duration_s)
    base = 0.55 + 0.45 * np.sin(2 * np.pi * (t / duration_s) - np.pi / 2)
    wobble = 0.08 * np.sin(2 * np.pi * t / 47.0 + rng.random() * 6.28)
    bursts = np.zeros(duration_s)
    for s in np.where(rng.random(duration_s) < burst_prob)[0]:
        width = rng.integers(3, 12)
        amp = rng.pareto(2.5) * 0.4
        bursts[s:s + width] += amp
    qps = np.clip(base + wobble + bursts, 0.02, None)
    return Trace(qps, f"azure_like_s{seed}")


def incast_trace(duration_s: int = 120, base_qps: float = 4.0,
                 burst_qps: float = 64.0, burst_every_s: float = 30.0,
                 burst_width_s: float = 2.0, jitter_s: float = 0.0,
                 seed: int = 0) -> Trace:
    """Synchronized-burst (incast-style) trace: a flat base load with
    every client firing together every ``burst_every_s`` seconds — the
    cron-job / cache-expiry / retry-storm shape that defeats smooth
    demand estimators. ``jitter_s`` optionally de-synchronizes each
    burst's start by a seeded uniform offset (0 keeps them perfectly
    aligned, the worst case)."""
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    if burst_every_s <= 0:
        raise ValueError(f"burst_every_s must be > 0, got {burst_every_s}")
    rng = np.random.default_rng(seed)
    qps = np.full(int(duration_s), float(base_qps))
    t = float(burst_every_s)
    while t < duration_s:
        start = t
        if jitter_s > 0:
            start = t + float(rng.uniform(-jitter_s, jitter_s))
        s0 = min(max(int(start), 0), int(duration_s) - 1)
        s1 = min(s0 + max(int(math.ceil(burst_width_s)), 1), int(duration_s))
        qps[s0:s1] += float(burst_qps)
        t += float(burst_every_s)
    return Trace(qps, f"incast_b{burst_qps:g}_e{burst_every_s:g}")


def load_trace_file(path: str) -> Trace:
    """Paper-artifact format: one QPS value per line
    (trace_{A}to{B}qps.txt)."""
    vals = np.loadtxt(path).ravel()
    return Trace(vals, path.rsplit("/", 1)[-1].split(".")[0])
