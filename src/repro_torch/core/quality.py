"""Response-quality metrics.

FID* — exact Fréchet distance between feature distributions (discriminator
penultimate features stand in for InceptionV3, which is unavailable offline;
the math is the real thing).

Simulator quality model — FID as a function of the cascade mix p and
router skill, calibrated to the paper's reported statistics:
  * first-tier / final-tier FID anchors per cascade,
  * non-monotone dip: best FID at a partial mix (paper Fig. 1a / §4.2),
  * router skill: discriminator > random > pickscore/clipscore (Fig. 1a).
For a two-tier cascade p is the deferred fraction; for an N-tier cascade
p is the mean normalized depth (final tier = 1) of served queries.

Boundary quality model — ``BoundaryQualityModel`` fits one cascade
boundary from calibration confidence scores plus the adjacent tiers' FID
anchors: it maps a discriminator-confidence threshold t to the deferred
mass f(t) *and* the expected quality Q(t) of serving at that threshold.
It is the learned object behind cascade auto-construction
(serving/autocascade.py): the builder fits one per boundary, the search
planner scores candidate cascades on the resulting quality/$ frontier,
and ``deferral_profile()`` is the single construction path for the
control plane's online ``DeferralProfile`` state (the profile's scores
are exactly the model's calibration scores, so fitting then profiling is
bit-identical to the legacy direct construction).

PyTorch-port copy of ``repro/core/quality.py`` (framework-free; imports
rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import pathlib
from typing import List, Optional, Sequence, Tuple

import numpy as np



# ---------------------------------------------------------------------------
# Exact Fréchet distance
# ---------------------------------------------------------------------------
def feature_stats(feats: np.ndarray):
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(cov)


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(C1 + C2 - 2 (C1 C2)^{1/2}).

    Matrix sqrt via eigendecomposition of the symmetrized product
    (C1^{1/2} C2 C1^{1/2} is PSD and shares the trace of (C1 C2)^{1/2})."""
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    cov1 = np.atleast_2d(cov1) + eps * np.eye(len(mu1))
    cov2 = np.atleast_2d(cov2) + eps * np.eye(len(mu2))
    diff = mu1 - mu2

    w1, v1 = np.linalg.eigh(cov1)
    sqrt1 = (v1 * np.sqrt(np.clip(w1, 0, None))) @ v1.T
    inner = sqrt1 @ cov2 @ sqrt1
    w = np.linalg.eigvalsh(inner)
    tr_sqrt = np.sum(np.sqrt(np.clip(w, 0, None)))
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * tr_sqrt)


def fid_from_features(real_feats: np.ndarray, gen_feats: np.ndarray) -> float:
    m1, c1 = feature_stats(real_feats)
    m2, c2 = feature_stats(gen_feats)
    return frechet_distance(m1, c1, m2, c2)


# ---------------------------------------------------------------------------
# Simulator quality model (calibrated to the paper)
# ---------------------------------------------------------------------------
ROUTER_SKILL = {
    # Fig. 1a ordering: trained discriminator best; CLIPScore/PickScore
    # routers are *worse than random* (the paper's surprising finding).
    "discriminator": 1.0,
    "random": 0.0,
    "pickscore": -0.15,
    "clipscore": -0.30,
    "oracle": 1.25,
}


@dataclasses.dataclass(frozen=True)
class QualityModel:
    """FID(p; skill): p = cascade mix in [0, 1] — the deferred fraction for
    a two-tier cascade, mean normalized tier depth for deeper ones."""
    fid_all_light: float
    fid_all_heavy: float
    fid_best_mix: float
    best_mix_p: float
    dip_width: float = 0.45

    def fid(self, p: float, router: str = "discriminator") -> float:
        p = min(max(p, 0.0), 1.0)
        skill = ROUTER_SKILL.get(router, 0.0)
        linear = self.fid_all_light + p * (self.fid_all_heavy
                                           - self.fid_all_light)
        # bell-shaped dip centred at the best mix, normalized so that a
        # skill-1.0 router hits exactly fid_best_mix at best_mix_p (only a
        # *good* router harvests the dip; a bad one pays it as a penalty)
        def shape(x):
            bell = math.exp(-0.5 * ((x - self.best_mix_p)
                                    / self.dip_width) ** 2)
            return bell * (4 * x * (1 - x) + 0.15)

        linear_best = self.fid_all_light + self.best_mix_p * (
            self.fid_all_heavy - self.fid_all_light)
        dip_at_best = linear_best - self.fid_best_mix
        return linear - skill * dip_at_best * shape(p) / shape(self.best_mix_p)

    @classmethod
    def from_cascade(cls, c) -> "QualityModel":
        """Accepts a CascadeSpec or legacy CascadeConfig (both expose the
        first/last-tier FID anchors)."""
        return cls(fid_all_light=c.fid_all_light,
                   fid_all_heavy=c.fid_all_heavy,
                   fid_best_mix=c.fid_best_mix,
                   best_mix_p=c.best_mix_defer_frac)


def pickscore_like(rng: np.random.Generator, n: int):
    """Per-query light-minus-heavy quality deltas with the paper's Fig. 1b
    shape: 20-40% of queries have delta >= 0 ("easy")."""
    return rng.normal(loc=-0.35, scale=0.7, size=n)


# ---------------------------------------------------------------------------
# Fitted per-boundary quality model (cascade auto-construction)
# ---------------------------------------------------------------------------
# Default dip coefficient for boundaries without a paper-reported best-mix
# anchor: the paper's three cascades put the best-mix FID 0.08-0.16x of the
# first/final anchor spread below the final tier; 0.12 is the midpoint.
BEST_MIX_DIP_COEF = 0.12
DEFAULT_BEST_MIX_FRAC = 0.65


@dataclasses.dataclass(frozen=True)
class BoundaryQualityModel:
    """One fitted cascade boundary: calibration confidence scores plus the
    adjacent tiers' FID anchors.

    ``fid_keep`` is the quality when the boundary keeps everything at the
    emitting tier; ``fid_defer`` when everything crosses to the deeper
    side. ``fid(t)`` composes the empirical deferral CDF with the
    calibrated mix-quality dip (``QualityModel``), so a threshold maps
    directly to expected quality — the object a threshold policy or a
    cascade search can optimize over without re-simulating.
    """
    scores: Tuple[float, ...]            # sorted calibration confidences
    fid_keep: float
    fid_defer: float
    fid_best_mix: float
    best_mix_defer_frac: float = DEFAULT_BEST_MIX_FRAC

    def __post_init__(self):
        if not self.scores:
            raise ValueError("need at least one calibration score")

    @classmethod
    def fit(cls, scores: Sequence[float], *, fid_keep: float,
            fid_defer: float, fid_best_mix: Optional[float] = None,
            best_mix_defer_frac: float = DEFAULT_BEST_MIX_FRAC
            ) -> "BoundaryQualityModel":
        """Fit from calibration confidences. Without a reported best-mix
        anchor, the dip is the ``BEST_MIX_DIP_COEF`` prior over the
        anchor spread (a *good* router beats serving everything deep)."""
        if fid_best_mix is None:
            spread = abs(fid_keep - fid_defer)
            fid_best_mix = min(fid_keep, fid_defer) \
                - BEST_MIX_DIP_COEF * spread
        return cls(scores=tuple(sorted(float(s) for s in scores)),
                   fid_keep=float(fid_keep), fid_defer=float(fid_defer),
                   fid_best_mix=float(fid_best_mix),
                   best_mix_defer_frac=float(best_mix_defer_frac))

    # ------- deferral side -------
    def defer_fraction(self, t: float) -> float:
        """f(t): calibration mass strictly below the threshold."""
        return bisect.bisect_left(self.scores, t) / len(self.scores)

    def threshold_for(self, frac: float) -> float:
        """Largest t with f(t) <= frac (right-continuous inverse)."""
        frac = min(max(frac, 0.0), 1.0)
        k = int(frac * len(self.scores))
        if k >= len(self.scores):
            return 1.0
        return self.scores[k]

    def easy_fraction(self, confident: float = 0.8) -> float:
        """Mass the discriminator scores 'easy' (kept) at a confident
        threshold — the statistic CascadeSpec.easy_fractions records."""
        return 1.0 - self.defer_fraction(confident)

    def deferral_profile(self) -> "DeferralProfile":
        """A fresh online ``DeferralProfile`` seeded with exactly the
        calibration scores (the control plane mutates it; the fitted
        model stays frozen). This is *the* construction path — backends
        and the planner share the object it returns."""
        from repro_torch.core.confidence import DeferralProfile
        return DeferralProfile(list(self.scores))

    # ------- quality side -------
    def _quality_model(self) -> QualityModel:
        return QualityModel(fid_all_light=self.fid_keep,
                            fid_all_heavy=self.fid_defer,
                            fid_best_mix=self.fid_best_mix,
                            best_mix_p=self.best_mix_defer_frac)

    def fid(self, t: float, router: str = "discriminator") -> float:
        """Expected quality of running this boundary at threshold t."""
        return self._quality_model().fid(self.defer_fraction(t), router)

    def frontier(self, grid: int = 21, router: str = "discriminator"
                 ) -> List[Tuple[float, float, float]]:
        """(t, f(t), FID(t)) on a threshold grid — the boundary's
        quality/deferral trade-off curve."""
        out = []
        for t in np.linspace(0.0, 1.0, max(grid, 2)):
            f = self.defer_fraction(float(t))
            out.append((float(t), f,
                        self._quality_model().fid(f, router)))
        return out


# ---------------------------------------------------------------------------
# Persistence (cluster-fitted models survive the process)
# ---------------------------------------------------------------------------
def save_quality_models(path, models: Sequence[BoundaryQualityModel]):
    """Persist per-boundary models as JSON (one dict per boundary).
    Floats go through ``repr`` via json, so ``load_quality_models``
    round-trips bit-identically — a cluster run's discriminator-fitted
    models can seed later simulator or cluster sessions."""
    payload = [{
        "scores": list(m.scores),
        "fid_keep": m.fid_keep,
        "fid_defer": m.fid_defer,
        "fid_best_mix": m.fid_best_mix,
        "best_mix_defer_frac": m.best_mix_defer_frac,
    } for m in models]
    pathlib.Path(path).write_text(json.dumps(payload, indent=1))


def load_quality_models(path) -> Tuple[BoundaryQualityModel, ...]:
    """Inverse of ``save_quality_models``: one fitted
    ``BoundaryQualityModel`` per boundary, scores and anchors exactly
    as saved."""
    payload = json.loads(pathlib.Path(path).read_text())
    return tuple(
        BoundaryQualityModel(
            scores=tuple(float(s) for s in d["scores"]),
            fid_keep=float(d["fid_keep"]),
            fid_defer=float(d["fid_defer"]),
            fid_best_mix=float(d["fid_best_mix"]),
            best_mix_defer_frac=float(d["best_mix_defer_frac"]))
        for d in payload)
