"""Offline deferral profiles for the control plane: ``make_profile`` /
``make_profiles`` seed each cascade boundary's online ``DeferralProfile``
from the fitted ``BoundaryQualityModel`` (or, for query-agnostic
routing, from uniform scores).

PyTorch-port copy of those two functions of
``repro/serving/baselines.py`` (framework-free), held to the original by
``tests/test_torch_control.py``. The comparison systems' controller
bundles wait for the port's entry points (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.config.base import ServingConfig, as_cascade_spec
from repro_torch.core.confidence import DeferralProfile
from repro_torch.serving.autocascade import fit_boundary_models


def make_profile(serving: ServingConfig, seed: int = 0,
                 uniform: bool = False, boundary: int = 0) -> DeferralProfile:
    """One boundary's offline deferral profile (boundary 0 by default):
    the fitted ``BoundaryQualityModel``'s calibration scores seeded into
    an online ``DeferralProfile`` (core/quality.py is the single
    construction path; the scores are bit-identical to the legacy direct
    construction)."""
    if uniform:                      # Proteus: random routing => f(t) = t
        rng = np.random.default_rng(seed + 7919 * boundary)
        return DeferralProfile(rng.random(5000))
    spec = as_cascade_spec(serving.cascade)
    return fit_boundary_models(spec, seed)[boundary].deferral_profile()


def make_profiles(serving: ServingConfig, seed: int = 0,
                  uniform: bool = False) -> Tuple[DeferralProfile, ...]:
    """One DeferralProfile per cascade boundary (all boundaries fitted
    in one pass)."""
    spec = as_cascade_spec(serving.cascade)
    if uniform:
        return tuple(make_profile(serving, seed, True, b)
                     for b in range(spec.num_boundaries))
    return tuple(m.deferral_profile()
                 for m in fit_boundary_models(spec, seed))
