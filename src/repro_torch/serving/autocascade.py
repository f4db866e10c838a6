"""Automatic cascade construction (the paper's claim that DiffServe
"automatically constructs model cascades from available diffusion model
variants"), as three layers:

  * ``VariantCatalog`` — the available model variants, grouped into
    workload families (resolution/dataset pools sharing an SLO and a
    discriminator), each with a profiled latency curve and a calibrated
    solo quality score (FID proxy). Cluster mode rewrites the profiles
    from measured e(b) tables (``measure_class_profiles``); the builtin
    catalog carries the paper's A100 measurements.
  * ``CascadeBuilder`` — enumerates ordered variant chains (latency up,
    FID down), fits one ``BoundaryQualityModel`` per boundary from
    calibration confidences (core/quality.py), prunes Pareto-dominated
    chains on the quality/latency frontier, and emits ``CascadeSpec``s.
    The legacy ``CASCADES`` registry (serving/profiles.py) is a set of
    *pinned* catalog queries through this builder: every registered name
    resolves to a bit-identical spec (golden parity).
  * ``CascadeSearchPlanner`` — a ``PlannerPolicy`` that re-runs the
    cascade search every control epoch: each candidate cascade is solved
    for the estimated demand, scored on the quality/$-aware threshold
    frontier, and the control plane may *switch the serving cascade* —
    not just workers/batches/thresholds — under load. Restricted to a
    single candidate it reproduces ``SolverPlanner`` decisions exactly.

This module is jax-free: catalogs and builders are pure data/logic.

PyTorch-port copy of ``repro/serving/autocascade.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib
from typing import (Dict, List, Mapping, Optional, Sequence, Tuple, Union)

import numpy as np

from repro_torch.config.base import (CascadeSpec, LatencyProfile,
                                     ServingConfig, TierSpec,
                                     as_cascade_spec)
from repro_torch.core.allocator import AllocatorOptions, ResourceManager
from repro_torch.core.confidence import (DeferralProfile,
                                         synthetic_confidence_scores)
from repro_torch.core.milp import AllocationPlan, Telemetry
from repro_torch.core.quality import BoundaryQualityModel, QualityModel

# ---------------------------------------------------------------------------
# Reference measurement tables (paper §4.1, A100-80GB)
# ---------------------------------------------------------------------------
# model -> e(b) = base + marginal*(b-1). The catalog's builtin variants
# reference these; serving/profiles.py re-exports them (legacy import
# path).
MODEL_PROFILES: Dict[str, LatencyProfile] = {
    "sd-turbo": LatencyProfile(0.10, 0.055),
    "sdxs": LatencyProfile(0.05, 0.028),
    "sdv1.5": LatencyProfile(1.78, 0.95),
    "sdxl-lightning": LatencyProfile(0.50, 0.30),
    "sdxl": LatencyProfile(6.00, 3.40),
}

DISCRIMINATOR_LATENCY_S = {"efficientnet_s": 0.010, "resnet34": 0.002,
                           "vit_b16": 0.005}


# ---------------------------------------------------------------------------
# Catalog data model
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelVariant:
    """One servable model variant inside a workload family.

    ``fid`` is the calibrated solo quality (the FID when *all* queries
    stop at this variant — CascadeSpec.fid_per_tier anchors);
    ``easy_fraction`` the calibrated mass of queries whose output from
    this variant passes the discriminator (drives the boundary's
    synthetic calibration confidences when this variant emits one).
    """
    name: str
    family: str
    profile: LatencyProfile
    fid: float
    easy_fraction: float = 0.30


@dataclasses.dataclass(frozen=True)
class CatalogFamily:
    """A workload pool (dataset/resolution) sharing an SLO and a
    discriminator — chains never mix families (quality anchors are not
    comparable across datasets, and a mid-run cascade switch must keep
    the SLO every in-flight deadline was stamped with)."""
    name: str
    slo_s: float
    discriminator: str = "efficientnet_s"


@dataclasses.dataclass(frozen=True)
class PinnedCascade:
    """A pinned catalog query: a named chain plus its paper-reported
    best-mix calibration (auto-built chains get the fitted prior
    instead)."""
    name: str
    family: str
    chain: Tuple[str, ...]
    fid_best_mix: float
    best_mix_defer_frac: float


class VariantCatalog:
    """Model variants grouped into families, plus pinned named queries."""

    def __init__(self, families: Sequence[CatalogFamily],
                 variants: Sequence[ModelVariant],
                 pinned: Sequence[PinnedCascade] = ()):
        self._families = {f.name: f for f in families}
        if len(self._families) != len(families):
            raise ValueError("duplicate family names in catalog")
        self._variants: Dict[Tuple[str, str], ModelVariant] = {}
        for v in variants:
            if v.family not in self._families:
                raise ValueError(f"variant {v.name!r} references unknown "
                                 f"family {v.family!r}")
            key = (v.family, v.name)
            if key in self._variants:
                raise ValueError(f"duplicate variant {v.name!r} in family "
                                 f"{v.family!r}")
            self._variants[key] = v
        self._pinned = {p.name: p for p in pinned}
        for p in pinned:
            for m in p.chain:
                if (p.family, m) not in self._variants:
                    raise ValueError(f"pinned cascade {p.name!r} references "
                                     f"unknown variant {m!r} in family "
                                     f"{p.family!r}")

    # ------- queries -------
    def families(self) -> List[str]:
        return sorted(self._families)

    def family(self, name: str) -> CatalogFamily:
        try:
            return self._families[name]
        except KeyError:
            raise KeyError(f"unknown catalog family {name!r}; "
                           f"known {self.families()}") from None

    def variants_in(self, family: str) -> List[ModelVariant]:
        self.family(family)
        return [v for (f, _), v in sorted(self._variants.items())
                if f == family]

    def variant(self, family: str, name: str) -> ModelVariant:
        try:
            return self._variants[(family, name)]
        except KeyError:
            raise KeyError(f"unknown variant {name!r} in family "
                           f"{family!r}") from None

    def pinned_names(self) -> List[str]:
        return sorted(self._pinned)

    def pinned(self, name: str) -> PinnedCascade:
        try:
            return self._pinned[name]
        except KeyError:
            raise KeyError(f"unknown pinned cascade {name!r}; "
                           f"known {self.pinned_names()}") from None

    # ------- derived catalogs -------
    def with_profiles(self, measured: Mapping[str, LatencyProfile]
                      ) -> "VariantCatalog":
        """A copy whose variant latency profiles are replaced by measured
        e(b) fits (model name -> profile; e.g. from the cluster
        runtime's ``measure_profile``/``measure_class_profiles``).
        Unmeasured variants keep their reference profiles."""
        variants = [dataclasses.replace(v, profile=measured[v.name])
                    if v.name in measured else v
                    for v in self._variants.values()]
        return VariantCatalog(list(self._families.values()), variants,
                              list(self._pinned.values()))

    @classmethod
    def from_spec(cls, spec: CascadeSpec,
                  family: Optional[str] = None) -> "VariantCatalog":
        """The variant pool implied by an existing cascade: one variant
        per tier, carrying the spec's quality anchors — the catalog a
        cluster deployment gets for free from the cascade it already
        serves (every variant is executable wherever the spec is)."""
        spec = as_cascade_spec(spec)
        fam = family or spec.name
        n = spec.num_tiers
        fids = spec.fid_per_tier or tuple(
            spec.fid_all_light + i * (spec.fid_all_heavy
                                      - spec.fid_all_light) / max(n - 1, 1)
            for i in range(n))
        variants = []
        seen = set()
        for i, t in enumerate(spec.tiers):
            if t.model in seen:
                continue
            seen.add(t.model)
            easy = spec.easy_fraction_at(i) if i < n - 1 else 0.30
            variants.append(ModelVariant(name=t.model, family=fam,
                                         profile=t.profile, fid=fids[i],
                                         easy_fraction=easy))
        pinned = (PinnedCascade(
            name=spec.name, family=fam,
            chain=tuple(t.model for t in spec.tiers),
            fid_best_mix=spec.fid_best_mix,
            best_mix_defer_frac=spec.best_mix_defer_frac),)
        return cls((CatalogFamily(fam, spec.slo_s, spec.discriminator),),
                   variants, pinned)

    # ------- JSON round-trip (--catalog files) -------
    @classmethod
    def from_json(cls, source: Union[str, pathlib.Path, dict]
                  ) -> "VariantCatalog":
        """Load a catalog from a JSON file (or an already-parsed dict):

        {"families": {"coco512": {"slo_s": 5.0,
                                  "discriminator": "efficientnet_s"}},
         "variants": [{"name": "sdxs", "family": "coco512",
                       "base_s": 0.05, "marginal_s": 0.028,
                       "fid": 24.1, "easy_fraction": 0.25}, ...],
         "pinned": {"sdxs": {"family": "coco512",
                             "chain": ["sdxs", "sdv1.5"],
                             "fid_best_mix": 18.1,
                             "best_mix_defer_frac": 0.70}, ...}}
        """
        if not isinstance(source, dict):
            source = json.loads(pathlib.Path(source).read_text())
        families = [CatalogFamily(name=n, slo_s=float(f["slo_s"]),
                                  discriminator=f.get("discriminator",
                                                      "efficientnet_s"))
                    for n, f in source.get("families", {}).items()]
        variants = [ModelVariant(
            name=v["name"], family=v["family"],
            profile=LatencyProfile(float(v["base_s"]),
                                   float(v["marginal_s"])),
            fid=float(v["fid"]),
            easy_fraction=float(v.get("easy_fraction", 0.30)))
            for v in source.get("variants", ())]
        pinned = [PinnedCascade(
            name=n, family=p["family"], chain=tuple(p["chain"]),
            fid_best_mix=float(p["fid_best_mix"]),
            best_mix_defer_frac=float(p["best_mix_defer_frac"]))
            for n, p in source.get("pinned", {}).items()]
        return cls(families, variants, pinned)


def builtin_catalog() -> VariantCatalog:
    """The paper's variant pool: MS-COCO 512x512 (SLO 5 s) and
    DiffusionDB 1024x1024 (SLO 15 s) families, FID anchors as reported,
    pinned queries reproducing the legacy ``CASCADES`` registry."""
    families = (CatalogFamily("coco512", slo_s=5.0),
                CatalogFamily("diffdb1024", slo_s=15.0))
    variants = (
        ModelVariant("sdxs", "coco512", MODEL_PROFILES["sdxs"],
                     fid=24.1, easy_fraction=0.25),
        ModelVariant("sd-turbo", "coco512", MODEL_PROFILES["sd-turbo"],
                     fid=22.6, easy_fraction=0.35),
        ModelVariant("sdv1.5", "coco512", MODEL_PROFILES["sdv1.5"],
                     fid=18.55),
        ModelVariant("sdxs", "diffdb1024", MODEL_PROFILES["sdxs"],
                     fid=28.4, easy_fraction=0.20),
        ModelVariant("sdxl-lightning", "diffdb1024",
                     MODEL_PROFILES["sdxl-lightning"],
                     fid=27.3, easy_fraction=0.30),
        ModelVariant("sdxl", "diffdb1024", MODEL_PROFILES["sdxl"],
                     fid=21.0),
    )
    pinned = (
        PinnedCascade("sdturbo", "coco512", ("sd-turbo", "sdv1.5"),
                      fid_best_mix=17.9, best_mix_defer_frac=0.65),
        PinnedCascade("sdxs", "coco512", ("sdxs", "sdv1.5"),
                      fid_best_mix=18.1, best_mix_defer_frac=0.70),
        PinnedCascade("sdxlltn", "diffdb1024", ("sdxl-lightning", "sdxl"),
                      fid_best_mix=20.3, best_mix_defer_frac=0.60),
        PinnedCascade("sdxs3", "coco512", ("sdxs", "sd-turbo", "sdv1.5"),
                      fid_best_mix=17.9, best_mix_defer_frac=0.65),
        PinnedCascade("sdxl3", "diffdb1024",
                      ("sdxs", "sdxl-lightning", "sdxl"),
                      fid_best_mix=20.3, best_mix_defer_frac=0.60),
    )
    return VariantCatalog(families, variants, pinned)


def load_catalog(source: str = "builtin") -> VariantCatalog:
    """Resolve a ``ServingConfig.catalog`` / ``--catalog`` value:
    ``"builtin"`` or a JSON file path."""
    if source in ("", "builtin"):
        return builtin_catalog()
    return VariantCatalog.from_json(source)


# ---------------------------------------------------------------------------
# Boundary fitting (shared with serving/baselines.py:make_profiles)
# ---------------------------------------------------------------------------
def fit_boundary_models(spec, seed: int = 0, n: int = 5000
                        ) -> Tuple[BoundaryQualityModel, ...]:
    """One fitted ``BoundaryQualityModel`` per cascade boundary, from
    seeded synthetic calibration confidences (the offline-profiling
    stand-in) and the spec's adjacent-tier FID anchors. The per-boundary
    seed scheme (``seed + 7919 * boundary``) matches the legacy profile
    construction, so ``.deferral_profile()`` is bit-identical to it."""
    spec = as_cascade_spec(spec)
    fids = spec.fid_per_tier or None
    out = []
    for b in range(spec.num_boundaries):
        rng = np.random.default_rng(seed + 7919 * b)
        scores = synthetic_confidence_scores(rng, n,
                                             spec.easy_fraction_at(b))
        out.append(BoundaryQualityModel.fit(
            scores,
            fid_keep=fids[b] if fids else spec.fid_all_light,
            fid_defer=fids[b + 1] if fids else spec.fid_all_heavy,
            fid_best_mix=spec.fid_best_mix,
            best_mix_defer_frac=spec.best_mix_defer_frac))
    return tuple(out)


def expected_depth(num_tiers: int, profiles, thresholds) -> float:
    """Mean normalized cascade depth (final tier = 1) implied by running
    per-boundary thresholds over deferral profiles f(t): the quality
    model's mix variable p, computable *before* simulating."""
    reach = 1.0
    stop = []
    for b, prof in enumerate(profiles[:num_tiers - 1]):
        f = prof.f(thresholds[b]) if b < len(thresholds) else 0.0
        stop.append(reach * (1.0 - f))
        reach *= f
    stop.append(reach)
    return sum(p * (i / max(num_tiers - 1, 1)) for i, p in enumerate(stop))


# ---------------------------------------------------------------------------
# The builder
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChainSummary:
    """One enumerated chain with its fitted quality/latency curve."""
    spec: CascadeSpec
    pinned: bool
    # (expected latency per query, expected FID) on a defer-fraction grid
    curve: Tuple[Tuple[float, float], ...]
    dominated: bool = False

    @property
    def models(self) -> Tuple[str, ...]:
        return tuple(t.model for t in self.spec.tiers)

    @property
    def best_fid(self) -> float:
        return min(f for _, f in self.curve)

    @property
    def base_latency_s(self) -> float:
        return min(lat for lat, _ in self.curve)


class CascadeBuilder:
    """Enumerates ordered variant chains from a catalog, fits per-boundary
    quality models, prunes Pareto-dominated chains, emits CascadeSpecs."""

    def __init__(self, catalog: VariantCatalog, *, calib_seed: int = 0,
                 calib_n: int = 5000, curve_grid: int = 9,
                 max_depth: int = 3, worker_classes: Sequence = ()):
        self.catalog = catalog
        self.calib_seed = int(calib_seed)
        self.calib_n = int(calib_n)
        self.curve_grid = int(curve_grid)
        self.max_depth = int(max_depth)
        # declared hardware mix (config.base:WorkerClass): when given,
        # candidate scoring weights each tier's unit latency by the
        # fleet's per-class latency scales, so the frontier/pruning pick
        # chains per hardware mix (ROADMAP: per-class profiled latency
        # in the catalog search). Empty keeps the reference-A100 scoring
        # bit-identical (the pinned registry is built with no classes).
        self.worker_classes = tuple(worker_classes)

    # ------- spec construction -------
    def build(self, family: str, chain: Sequence[str], *,
              name: Optional[str] = None,
              fid_best_mix: Optional[float] = None,
              best_mix_defer_frac: Optional[float] = None) -> CascadeSpec:
        """A CascadeSpec for an ordered chain of variant names (cheapest
        first). Pinned calibration anchors override the fitted prior."""
        fam = self.catalog.family(family)
        variants = [self.catalog.variant(family, m) for m in chain]
        if len(variants) < 2:
            raise ValueError(f"a cascade chain needs >= 2 variants, "
                             f"got {list(chain)}")
        disc_s = DISCRIMINATOR_LATENCY_S[fam.discriminator]
        tiers = tuple(
            TierSpec(model=v.name, profile=v.profile,
                     disc_latency_s=disc_s if i < len(variants) - 1 else 0.0)
            for i, v in enumerate(variants))
        fids = tuple(v.fid for v in variants)
        if fid_best_mix is None:
            # fitted prior: the best mix dips below the final tier by the
            # calibration coefficient over the anchor spread
            from repro_torch.core.quality import BEST_MIX_DIP_COEF
            fid_best_mix = min(fids) - BEST_MIX_DIP_COEF * (max(fids)
                                                            - min(fids))
        if best_mix_defer_frac is None:
            from repro_torch.core.quality import DEFAULT_BEST_MIX_FRAC
            best_mix_defer_frac = DEFAULT_BEST_MIX_FRAC
        return CascadeSpec(
            name=name or ("auto:%s:%s" % (family, "+".join(chain))),
            tiers=tiers, discriminator=fam.discriminator, slo_s=fam.slo_s,
            fid_per_tier=fids, fid_best_mix=fid_best_mix,
            best_mix_defer_frac=best_mix_defer_frac,
            easy_fractions=tuple(v.easy_fraction for v in variants[:-1]))

    def build_pinned(self, name: str) -> CascadeSpec:
        """Resolve a pinned catalog query (the legacy registry names)."""
        p = self.catalog.pinned(name)
        return self.build(p.family, p.chain, name=p.name,
                          fid_best_mix=p.fid_best_mix,
                          best_mix_defer_frac=p.best_mix_defer_frac)

    def registry(self) -> Dict[str, CascadeSpec]:
        """All pinned queries by name — what ``CASCADES`` is built from."""
        return {n: self.build_pinned(n) for n in self.catalog.pinned_names()}

    # ------- boundary fitting -------
    def fit_boundaries(self, spec) -> Tuple[BoundaryQualityModel, ...]:
        return fit_boundary_models(spec, self.calib_seed, self.calib_n)

    def deferral_profiles(self, spec) -> Tuple[DeferralProfile, ...]:
        return tuple(m.deferral_profile() for m in self.fit_boundaries(spec))

    # ------- enumeration + pruning -------
    def chains(self, family: str) -> List[Tuple[str, ...]]:
        """Ordered chains (latency non-decreasing, FID strictly
        decreasing, 2..max_depth tiers) over the family's variants."""
        vs = sorted(self.catalog.variants_in(family),
                    key=lambda v: (v.profile.base_s, -v.fid, v.name))
        out = []
        for r in range(2, min(self.max_depth, len(vs)) + 1):
            for combo in itertools.combinations(vs, r):
                fids = [v.fid for v in combo]
                if all(b < a for a, b in zip(fids, fids[1:])):
                    out.append(tuple(v.name for v in combo))
        return out

    def _unit_latency(self, tier, last: bool) -> float:
        """Batch-1 tier latency for candidate scoring: fleet-weighted
        over the declared worker classes' per-model latency scales when
        a hardware mix is known, else the reference profile."""
        disc = 0.0 if last else tier.disc_latency_s
        if not self.worker_classes:
            return tier.profile.exec_latency(1) + disc
        total = sum(wc.count for wc in self.worker_classes)
        return sum(
            wc.count * (wc.tier_profile(tier).exec_latency(1)
                        + disc * wc.scale_for(tier.model).base)
            for wc in self.worker_classes) / max(total, 1)

    def _curve(self, spec: CascadeSpec) -> Tuple[Tuple[float, float], ...]:
        """(expected latency/query, expected FID) as every boundary sweeps
        a shared target defer fraction — the chain's achievable frontier
        under its fitted boundary models."""
        models = self.fit_boundaries(spec)
        qm = QualityModel.from_cascade(spec)
        n = spec.num_tiers
        pts = []
        for u in np.linspace(0.0, 1.0, max(self.curve_grid, 2)):
            ts = [m.threshold_for(float(u)) for m in models]
            fs = [m.defer_fraction(t) for m, t in zip(models, ts)]
            reach, lat = 1.0, 0.0
            stop = []
            for i, tier in enumerate(spec.tiers):
                lat += reach * self._unit_latency(tier, last=i == n - 1)
                if i < n - 1:
                    stop.append(reach * (1.0 - fs[i]))
                    reach *= fs[i]
            stop.append(reach)
            depth = sum(p * (i / max(n - 1, 1)) for i, p in enumerate(stop))
            pts.append((float(lat), float(qm.fid(depth))))
        return tuple(pts)

    @staticmethod
    def _dominates(a: Sequence[Tuple[float, float]],
                   b: Sequence[Tuple[float, float]]) -> bool:
        """Curve a Pareto-dominates curve b: every b point is weakly
        beaten (<= latency and <= FID) by some a point, strictly on at
        least one b point."""
        strict = False
        for lb, fb in b:
            hit = False
            for la, fa in a:
                if la <= lb + 1e-12 and fa <= fb + 1e-12:
                    hit = True
                    if la < lb - 1e-9 or fa < fb - 1e-9:
                        strict = True
                    break
            if not hit:
                return False
        return strict

    def frontier(self, family: str) -> List[ChainSummary]:
        """Every enumerated chain with its curve, dominated chains
        flagged (pinned chains are flagged too but never dropped by
        ``build_family`` — registry names must keep resolving)."""
        pinned_by_chain = {self.catalog.pinned(n).chain: n
                           for n in self.catalog.pinned_names()
                           if self.catalog.pinned(n).family == family}
        summaries = []
        for chain in self.chains(family):
            pin = pinned_by_chain.get(chain)
            spec = (self.build_pinned(pin) if pin
                    else self.build(family, chain))
            summaries.append(ChainSummary(spec=spec, pinned=pin is not None,
                                          curve=self._curve(spec)))
        out = []
        for i, s in enumerate(summaries):
            dominated = any(self._dominates(o.curve, s.curve)
                            for j, o in enumerate(summaries) if j != i)
            out.append(dataclasses.replace(s, dominated=dominated))
        return out

    def build_family(self, family: str, prune: bool = True
                     ) -> Dict[str, CascadeSpec]:
        """The family's servable cascade set: pinned queries always, plus
        auto-built chains surviving Pareto pruning."""
        out: Dict[str, CascadeSpec] = {}
        for s in self.frontier(family):
            if s.pinned or not (prune and s.dominated):
                out[s.spec.name] = s.spec
        return out


def subchain_specs(spec) -> Dict[str, CascadeSpec]:
    """Order-preserving sub-chains of a spec's own tiers (>= 2 tiers,
    keeping the final tier): candidate cascades that are executable
    wherever the parent is (cluster mode: every model already has a
    loaded stage). Quality anchors subset the parent's."""
    spec = as_cascade_spec(spec)
    n = spec.num_tiers
    fids = spec.fid_per_tier or tuple(
        spec.fid_all_light + i * (spec.fid_all_heavy - spec.fid_all_light)
        / max(n - 1, 1) for i in range(n))
    out: Dict[str, CascadeSpec] = {}
    for r in range(2, n):
        for idxs in itertools.combinations(range(n), r):
            if idxs[-1] != n - 1:
                continue
            tiers = tuple(
                dataclasses.replace(
                    spec.tiers[i],
                    disc_latency_s=(spec.tiers[i].disc_latency_s
                                    if pos < r - 1 else 0.0))
                for pos, i in enumerate(idxs))
            name = "%s:%s" % (spec.name, "+".join(t.model for t in tiers))
            out[name] = dataclasses.replace(
                spec, name=name, tiers=tiers,
                fid_per_tier=tuple(fids[i] for i in idxs),
                easy_fractions=tuple(spec.easy_fraction_at(i)
                                     for i in idxs[:-1]))
    return out


# ---------------------------------------------------------------------------
# Mid-run switch helpers (shared by both ExecutorBackends)
# ---------------------------------------------------------------------------
def tier_remap(old_spec: CascadeSpec, new_spec: CascadeSpec):
    """``(remap, kept)`` callables mapping old tier indexes onto a new
    cascade: a model the new cascade still serves keeps its identity
    (``kept(i)`` True — workers stay warm); a vanished model maps to the
    proportional depth. One definition shared by the simulator and the
    cluster backend, so a mid-run switch's conservation semantics cannot
    silently diverge across backends."""
    old_models = [t.model for t in old_spec.tiers]
    new_models = [t.model for t in new_spec.tiers]
    old_n, new_n = len(old_models), len(new_models)

    def kept(i: int) -> bool:
        return i < old_n and old_models[i] in new_models

    def remap(i: int) -> int:
        if kept(i):
            return new_models.index(old_models[i])
        return min(int(round(i * (new_n - 1) / max(old_n - 1, 1))),
                   new_n - 1)

    return remap, kept


def grow_tier_accounting(result, new_n: int) -> None:
    """Grow-only resize of a SimResult's per-tier/per-boundary counters
    after a cascade switch (tier indexes are positions in the *current*
    cascade; an earlier deeper cascade keeps its tail)."""
    for seq, n in ((result.completed_per_tier, new_n),
                   (result.tier_processed, new_n),
                   (result.deferred_per_boundary, new_n - 1)):
        seq.extend([0] * (n - len(seq)))


# ---------------------------------------------------------------------------
# The per-epoch cascade search planner
# ---------------------------------------------------------------------------
class CascadeSearchPlanner:
    """A ``PlannerPolicy`` that searches the cascade set every control
    epoch: each candidate is solved for the estimated demand and scored
    lexicographically on (feasibility, expected FID at the plan's
    thresholds, $/hour or worker count) — the quality/$-aware threshold
    frontier — with switch hysteresis so marginal wins don't thrash
    model reloads. ``chosen_cascade``/``chosen_profiles`` feed the
    ``ControlDecision`` so backends can enact a mid-run cascade switch.

    Candidates must share one SLO (deadlines are stamped at submit
    time). With a single candidate this reduces exactly to
    ``SolverPlanner``: one ``plan_for_demand`` call on the same
    ResourceManager arguments, no switch ever emitted.
    """

    needs_telemetry = True

    def __init__(self, serving: ServingConfig,
                 candidates: Mapping[str, CascadeSpec],
                 profiles_by_name: Mapping[str, Sequence[DeferralProfile]],
                 *, active: str,
                 allocator_options: Optional[AllocatorOptions] = None,
                 router: str = "discriminator",
                 switch_margin: float = 0.1, min_dwell: int = 8):
        if active not in candidates:
            raise ValueError(f"active cascade {active!r} not among "
                             f"candidates {sorted(candidates)}")
        slos = {round(as_cascade_spec(c).slo_s, 9)
                for c in candidates.values()}
        if len(slos) != 1:
            raise ValueError(f"cascade-search candidates must share one "
                             f"SLO (deadlines are stamped at submit "
                             f"time); got {sorted(slos)}")
        self.serving = serving
        self.candidates = {n: as_cascade_spec(c)
                           for n, c in candidates.items()}
        self.profiles = {n: tuple(profiles_by_name[n])
                         for n in self.candidates}
        self.router = router
        self.switch_margin = float(switch_margin)
        # a switch reloads models on every worker whose variant changed:
        # after switching, hold the choice for min_dwell epochs (unless
        # the active cascade goes infeasible) so marginal score flapping
        # cannot thrash reloads
        self.min_dwell = int(min_dwell)
        self._dwell = 0
        self.active = active
        self.rms = {n: ResourceManager(spec, serving, self.profiles[n],
                                       allocator_options)
                    for n, spec in self.candidates.items()}
        self.quality = {n: QualityModel.from_cascade(spec)
                        for n, spec in self.candidates.items()}
        self.chosen_cascade: CascadeSpec = self.candidates[active]
        self.chosen_profiles = self.profiles[active]
        self.switches = 0
        self.choice_log: List[str] = []

    @property
    def rm(self) -> ResourceManager:
        """The active candidate's solver wrapper (state snapshots and
        legacy inspection call sites)."""
        return self.rms[self.active]

    def restrict_to_models(self, models) -> List[str]:
        """Drop candidates the backend cannot enact (cluster mode: only
        models with a loaded jitted stage are switchable —
        ``ClusterBackend.serve`` calls this with its executable pool, so
        the search can never commit a switch the backend would refuse
        mid-run). The active candidate always stays. Returns the dropped
        names."""
        models = set(models)
        dropped = [n for n, spec in self.candidates.items()
                   if n != self.active
                   and any(t.model not in models for t in spec.tiers)]
        for n in dropped:
            del self.candidates[n], self.profiles[n], self.rms[n], \
                self.quality[n]
        return dropped

    # ------- telemetry projection -------
    def _project(self, telemetry: Telemetry, name: str) -> Telemetry:
        """Map the active cascade's per-tier telemetry onto a candidate:
        queue/arrival mass follows the model name; backlog on models the
        candidate does not serve lands on tier 0 (it would re-enter
        there after a switch)."""
        active_spec = self.candidates[self.active]
        spec = self.candidates[name]
        qmap = {t.model: (telemetry.queues[i]
                          if i < len(telemetry.queues) else 0.0)
                for i, t in enumerate(active_spec.tiers)}
        amap = {t.model: (telemetry.arrivals[i]
                          if i < len(telemetry.arrivals) else 0.0)
                for i, t in enumerate(active_spec.tiers)}
        models = [t.model for t in spec.tiers]
        queues = [qmap.get(m, 0.0) for m in models]
        arrivals = [amap.get(m, 0.0) for m in models]
        orphan = sum(q for m, q in qmap.items() if m not in models)
        queues[0] += orphan
        return dataclasses.replace(telemetry, queues=tuple(queues),
                                   arrivals=tuple(arrivals))

    # ------- scoring -------
    def _score(self, name: str, plan: AllocationPlan):
        spec = self.candidates[name]
        depth = expected_depth(spec.num_tiers, self.profiles[name],
                               plan.thresholds)
        fid = self.quality[name].fid(depth, self.router)
        cost = plan.cost if plan.cost is not None \
            else float(plan.total_workers)
        return (0 if plan.feasible else 1, round(fid, 9), cost,
                0 if name == self.active else 1, name)

    def plan(self, telemetry: Telemetry, demand: float) -> AllocationPlan:
        plans: Dict[str, AllocationPlan] = {}
        scores = {}
        for name in self.candidates:
            tel = telemetry if name == self.active \
                else self._project(telemetry, name)
            plans[name] = self.rms[name].plan_for_demand(tel, demand)
            scores[name] = self._score(name, plans[name])
        best = min(scores, key=lambda n: scores[n])
        if best != self.active and self._dwell > 0 \
                and plans[self.active].feasible:
            best = self.active         # dwell: hold a fresh choice
        if best != self.active:
            # hysteresis: switching reloads models; demand a real win
            sa, sb = scores[self.active], scores[best]
            if sa[0] == sb[0] and (sa[1] - sb[1]) < self.switch_margin:
                best = self.active
        self._dwell = max(self._dwell - 1, 0)
        if best != self.active:
            self.active = best
            self.switches += 1
            self._dwell = self.min_dwell
        self.choice_log.append(best)
        self.chosen_cascade = self.candidates[best]
        self.chosen_profiles = self.profiles[best]
        return plans[best]


def default_candidates(spec, serving: Optional[ServingConfig] = None,
                       registry: Optional[Mapping[str, CascadeSpec]] = None,
                       include_subchains: bool = True
                       ) -> Dict[str, CascadeSpec]:
    """The search planner's default candidate set for an active cascade:
    registry cascades sharing its SLO and final (anchor) model, plus the
    active spec's own sub-chains — deduped by tier-model chain, active
    first (its object may carry measured profiles)."""
    spec = as_cascade_spec(spec)
    out: Dict[str, CascadeSpec] = {spec.name: spec}
    seen = {tuple(t.model for t in spec.tiers)}

    def add(name, cand):
        key = tuple(t.model for t in cand.tiers)
        if key in seen:
            return
        seen.add(key)
        out[name] = cand

    for name, cand in (registry or {}).items():
        cand = as_cascade_spec(cand)
        if (abs(cand.slo_s - spec.slo_s) < 1e-9
                and cand.tiers[-1].model == spec.tiers[-1].model):
            add(name, cand)
    if include_subchains:
        for name, cand in subchain_specs(spec).items():
            add(name, cand)
    return out
