"""Latency/throughput profiles and the cascade registry.

Profiled numbers are the paper's A100-80GB measurements (§4.1):
  SD-Turbo  ~0.10 s/img (1 step)     SDXS ~0.05 s (1 step)
  SDv1.5    ~1.78 s (50 steps)       SDXL-Lightning ~0.5 s (2 steps)
  SDXL      ~6 s (50 steps)          discriminator ~10 ms
Batch scaling: diffusion latency grows near-linearly in batch with a
sub-linear startup term (profiled marginal costs below reproduce the
paper's 4.6x SDXL-vs-Lightning gap at batch 16).

The cascades themselves are auto-constructed: the variant pool lives in
``serving/autocascade.py`` (``VariantCatalog``), and ``CASCADES`` is the
set of *pinned* catalog queries resolved through ``CascadeBuilder`` —
every legacy name resolves to a bit-identical ``CascadeSpec`` (pinned by
tests/test_autocascade.py and the control-plane golden suite). Register
more cascades by extending the builtin catalog, loading a ``--catalog``
JSON file, or letting the builder enumerate the quality/latency frontier
(``--auto-cascade`` / ``--list-frontier``).

PyTorch-port copy of ``repro/serving/profiles.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.config.base import (CascadeSpec, ServingConfig,
                                     TierSpec, WorkerClass,
                                     parse_class_costs, parse_worker_classes)
from repro_torch.serving.autocascade import (DISCRIMINATOR_LATENCY_S,
                                             MODEL_PROFILES, CascadeBuilder,
                                             VariantCatalog, builtin_catalog,
                                             load_catalog)

# Diffusion-workload latency multipliers vs the A100-80GB the
# MODEL_PROFILES were measured on (paper §5's heterogeneous clusters):
# (batch-1 base scale, per-extra-image marginal scale). Batch-1 latency
# is dominated by kernel launch + memory traffic while the marginal cost
# tracks raw compute, so memory-light cards (a10g, t4) fall off faster
# on marginal cost than on batch-1. Used as profile defaults for
# `--worker-classes a100:4,a10g:12` syntax; explicit speeds
# (`a10g:12:0.5`) or `@model=BASExMARG` overrides always win.
GPU_CLASS_PROFILES: Dict[str, Tuple[float, float]] = {
    "h100": (0.63, 0.58), "a100": (1.00, 1.00), "l40s": (1.67, 1.85),
    "v100": (1.82, 2.00), "a10g": (2.22, 2.60), "t4": (4.00, 4.80),
}

# Legacy scalar view of the same table: throughput multipliers derived
# from the batch-1 base scale (kept for `speed`-only call sites).
GPU_CLASS_SPEEDS: Dict[str, float] = {
    name: round(1.0 / base, 4)
    for name, (base, _marg) in GPU_CLASS_PROFILES.items()
}

# On-demand $/hour reference prices (us-east, mid-2025 ballpark) for the
# cost-weighted allocation objective (`--cost-per-class a100,a10g`).
GPU_CLASS_COSTS: Dict[str, float] = {
    "h100": 6.98, "a100": 4.10, "l40s": 1.99, "v100": 3.06,
    "a10g": 1.21, "t4": 0.53,
}


def worker_classes_from_arg(text: str) -> Tuple[WorkerClass, ...]:
    """Parse a ``--worker-classes`` CLI value with the GPU latency-scale
    table as the wildcard default for speed-omitted known classes — also
    as the fallback behind explicit ``@model=`` pins, so ``a10g:12@sdxl=…``
    keeps the table's (base, marginal) for every other model. An explicit
    speed makes the class a pure scalar (the scalar speed table covers
    speed-omitted entries of unknown classes)."""
    return parse_worker_classes(text, speed_defaults=GPU_CLASS_SPEEDS,
                                profile_defaults=GPU_CLASS_PROFILES)


def class_costs_from_arg(text: str) -> Tuple[Tuple[str, float], ...]:
    """Parse a ``--cost-per-class`` CLI value with the GPU price table as
    defaults for omitted costs."""
    return parse_class_costs(text, cost_defaults=GPU_CLASS_COSTS)


def make_cascade(name: str, models: Sequence[str], *, slo_s: float,
                 fid_per_tier: Sequence[float], fid_best_mix: float,
                 best_mix_defer_frac: float,
                 easy_fractions: Sequence[float],
                 discriminator: str = "efficientnet_s") -> CascadeSpec:
    """Build a CascadeSpec from registered model names (cheapest first)."""
    disc_s = DISCRIMINATOR_LATENCY_S[discriminator]
    tiers = tuple(
        TierSpec(model=m, profile=MODEL_PROFILES[m],
                 disc_latency_s=disc_s if i < len(models) - 1 else 0.0)
        for i, m in enumerate(models))
    return CascadeSpec(name=name, tiers=tiers, discriminator=discriminator,
                       slo_s=slo_s, fid_per_tier=tuple(fid_per_tier),
                       fid_best_mix=fid_best_mix,
                       best_mix_defer_frac=best_mix_defer_frac,
                       easy_fractions=tuple(easy_fractions))


# The registry: pinned catalog queries resolved through the builder —
# "sdturbo" (SD-Turbo -> SDv1.5, SLO 5 s, MS-COCO 512), "sdxs",
# "sdxlltn" (SDXL-Lightning -> SDXL, SLO 15 s, DiffusionDB 1024), plus
# the 3-tier variant pools "sdxs3" / "sdxl3". Parity with the legacy
# hand-built specs is pinned by tests/test_autocascade.py.
CASCADES: Dict[str, CascadeSpec] = CascadeBuilder(builtin_catalog()).registry()


def resolve_cascade(name: str,
                    catalog: "VariantCatalog | str | None" = None
                    ) -> CascadeSpec:
    """Resolve a cascade name: a pinned query of ``catalog`` (a
    ``VariantCatalog``, a ``--catalog`` source string, or None for the
    builtin), the legacy ``CASCADES`` registry, or an auto-chain name of
    the form ``auto:<family>:<model>+<model>+...``."""
    if isinstance(catalog, VariantCatalog):
        cat = catalog
    else:
        cat = load_catalog(catalog or "builtin")
    builder = CascadeBuilder(cat)
    if name in cat.pinned_names():
        return builder.build_pinned(name)
    if name in CASCADES:
        return CASCADES[name]
    if name.startswith("auto:"):
        bits = name.split(":", 2)
        if len(bits) == 3 and bits[2]:
            return builder.build(bits[1], bits[2].split("+"))
    raise KeyError(f"unknown cascade {name!r}; known "
                   f"{sorted(set(CASCADES) | set(cat.pinned_names()))} "
                   f"or auto:<family>:<m1>+<m2>+...")


def list_cascades() -> List[Tuple[str, str, float, int]]:
    """(name, 'tier0 -> tier1 -> ...', slo_s, num_tiers) per registered
    cascade, for CLIs and docs."""
    return [(name, " -> ".join(t.model for t in c.tiers), c.slo_s,
             c.num_tiers)
            for name, c in sorted(CASCADES.items())]


def default_serving(cascade: "str | CascadeSpec" = "sdturbo",
                    num_workers: int = 16, **kw) -> ServingConfig:
    """ServingConfig for a registered cascade name (or an already-built
    ``CascadeSpec``, e.g. a catalog/auto-chain resolution). When
    ``worker_classes`` is given, ``num_workers`` is derived from the
    class counts.

    ``controller`` / ``estimator`` / ``admission`` kwargs select the
    control-plane policy bundle, demand estimator, and overload admission
    policy by registry name (serving/baselines.py:CONTROLLERS,
    serving/controlplane.py:TORCH_ESTIMATORS,
    serving/admission.py:TORCH_ADMISSIONS)
    — stored as plain strings so configs stay pure data and are resolved
    when a ControlPlane is built. Admission knobs (``ecn_k``,
    ``ecn_shed_mult``, ``admission_rate_qps``) ride along the same way."""
    wcs = kw.get("worker_classes") or ()
    if wcs:
        num_workers = sum(wc.count for wc in wcs)
    spec = CASCADES[cascade] if isinstance(cascade, str) else cascade
    return ServingConfig(cascade=spec, num_workers=num_workers, **kw)
