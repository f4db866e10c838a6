"""Confidence scores and the deferral profile f(t).

f(t) = fraction of queries whose discriminator confidence is below the
threshold t — i.e. the fraction deferred across a cascade boundary to the
next (more capable) tier. An N-tier cascade carries one profile per
boundary (N-1 of them; see ``as_boundary_profiles``). Initialized from
offline profiling (a sample of confidence scores), updated online as the
controller observes fresh scores (paper §3.3).

PyTorch-port copy of ``repro/core/confidence.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence, Tuple

import numpy as np


class DeferralProfile:
    """Empirical CDF of confidence scores with bounded-size online updates."""

    def __init__(self, scores: Sequence[float], max_size: int = 20_000):
        self._scores: List[float] = sorted(float(s) for s in scores)
        self._max = max_size
        if not self._scores:
            raise ValueError("need at least one offline confidence score")

    def f(self, t: float) -> float:
        """Fraction deferred at threshold t (strictly below t)."""
        return bisect.bisect_left(self._scores, t) / len(self._scores)

    def inverse(self, frac: float) -> float:
        """Largest threshold t with f(t) <= frac (right-continuous)."""
        frac = min(max(frac, 0.0), 1.0)
        n = len(self._scores)
        k = int(frac * n)
        if k >= n:
            return 1.0
        return self._scores[k]

    def update(self, new_scores: Iterable[float]) -> None:
        for s in new_scores:
            bisect.insort(self._scores, float(s))
        if len(self._scores) > self._max:
            # subsample uniformly, preserving the distribution
            idx = np.linspace(0, len(self._scores) - 1, self._max).astype(int)
            self._scores = [self._scores[i] for i in idx]

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(np.asarray(self._scores), size=n, replace=True)

    def __len__(self):
        return len(self._scores)


def as_boundary_profiles(profiles, num_boundaries: int
                         ) -> Tuple[DeferralProfile, ...]:
    """Normalize a single profile or a sequence to one profile per cascade
    boundary. Missing deeper boundaries are filled with independent copies
    of the last given profile (same score distribution, separate online
    state — boundary updates must not alias)."""
    if isinstance(profiles, DeferralProfile):
        seq: List[DeferralProfile] = [profiles]
    else:
        seq = list(profiles)
    if not seq:
        raise ValueError("need at least one deferral profile")
    while len(seq) < num_boundaries:
        seq.append(DeferralProfile(list(seq[-1]._scores)))
    return tuple(seq[:num_boundaries])


def synthetic_confidence_scores(rng: np.random.Generator, n: int = 5000,
                                easy_fraction: float = 0.30) -> np.ndarray:
    """Offline-profiling stand-in: a bimodal confidence distribution —
    'easy' queries cluster near 1 (light output looks real), hard ones
    spread lower. Calibrated so ~easy_fraction of mass sits above 0.8."""
    n_easy = int(n * easy_fraction)
    easy = 1.0 - rng.beta(1.5, 8.0, size=n_easy) * 0.25
    hard = rng.beta(2.5, 2.0, size=n - n_easy) * 0.85
    return np.clip(np.concatenate([easy, hard]), 0.0, 1.0)


def token_uncertainty_confidence(logprobs: np.ndarray) -> np.ndarray:
    """LM-cascade confidence (paper §5 extension; Gupta et al. 2024):
    per-sequence mean top-token probability. logprobs: (B, S)."""
    return np.exp(logprobs).mean(axis=-1)
