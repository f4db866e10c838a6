"""The paper's comparison systems (Table 1) and §4.5 ablations as named
control-plane policy bundles, generalized to N-tier cascades.

  Clipper-Light     static, query-agnostic, all tier-0
  Clipper-Heavy     static, query-agnostic, all final-tier
  Proteus           dynamic allocation, RANDOM routing (query-agnostic)
  DiffServe-Static  query-aware cascade, provisioned for peak, fixed t
  DiffServe         query-aware + dynamic cascade solver (this paper)

Each bundle names how the ControlPlane is assembled (estimator, planner,
fixed plan vs re-planning, allocator ablation mode) plus the backend
knobs (router skill, arrival tier) that define one comparison system.
``run_controller`` builds the bundle against any trace/ServingConfig;
``run_baseline``/``run_ablation`` are the legacy entry points, now thin
wrappers over the registry.

PyTorch-port copy of ``repro/serving/baselines.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``. Registries carry the port's own names,
apart from the JAX package's for the repo linter's index: the controller
registry is ``TORCH_CONTROLLERS``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.config.base import ServingConfig, as_cascade_spec
from repro_torch.core.allocator import AllocatorOptions
from repro_torch.core.confidence import DeferralProfile
from repro_torch.core.milp import (AllocationPlan, solve_cascade,
                                   solve_heterogeneous_cascade)
from repro_torch.serving.autocascade import (CascadeSearchPlanner,
                                             default_candidates,
                                             fit_boundary_models)
from repro_torch.serving.controlplane import build_control_plane
from repro_torch.serving.simulator import SimConfig, Simulator, SimResult
from repro_torch.serving.trace import Trace

BASELINES = ("clipper-light", "clipper-heavy", "proteus",
             "diffserve-static", "diffserve")
ABLATIONS = ("static_threshold", "aimd_batching", "no_queuing_model")


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


# ---------------------------------------------------------------------------
# Fixed-plan builders (the static bundles' one-shot provisioning solve)
# ---------------------------------------------------------------------------
def _all_to(serving: ServingConfig, n: int, tier: int) -> Tuple[dict, ...]:
    """Class split sending every worker class to one tier (static
    query-agnostic baselines on a heterogeneous cluster)."""
    split = [dict() for _ in range(n)]
    for wc in serving.worker_classes:
        split[tier][wc.name] = wc.count
    return tuple(split)


def _plan_all_light(spec, serving, profiles, peak) -> AllocationPlan:
    het = bool(serving.worker_classes)
    plan = solve_cascade(spec, serving, profiles, peak,
                         fixed_thresholds=(0.0,) * spec.num_boundaries,
                         num_workers=serving.num_workers)
    return dataclasses.replace(
        plan, workers=(serving.num_workers,) + (0,) * (spec.num_tiers - 1),
        thresholds=(0.0,) * spec.num_boundaries,
        class_workers=_all_to(serving, spec.num_tiers, 0) if het else None)


def _plan_all_heavy(spec, serving, profiles, peak) -> AllocationPlan:
    # largest batch whose execution latency still fits the SLO (on the
    # slowest class present — via its per-model latency scales, since
    # a steep marginal curve can blow the SLO at large batches even
    # when batch-1 fits — so heterogeneous runs stay comparable)
    het = bool(serving.worker_classes)
    n = spec.num_tiers
    final = spec.tiers[-1]

    def worst_lat(b: int) -> float:
        if not serving.worker_classes:
            return final.profile.exec_latency(b)
        return max(wc.tier_profile(final).exec_latency(b)
                   for wc in serving.worker_classes)

    choices = spec.tier_batch_choices(n - 1, serving.batch_choices)
    feas = [b for b in choices if worst_lat(b) <= spec.slo_s]
    b_last = max(feas) if feas else min(choices)
    batches = tuple(1 for _ in range(n - 1)) + (b_last,)
    return AllocationPlan(
        workers=(0,) * (n - 1) + (serving.num_workers,),
        batches=batches, thresholds=(1.0,) * spec.num_boundaries,
        expected_latency=final.profile.exec_latency(b_last),
        feasible=True,
        class_workers=_all_to(serving, n, n - 1) if het else None)


def _plan_peak_static(spec, serving, profiles, peak) -> AllocationPlan:
    # provisioned exactly for nominal peak (no burst margins, fixed
    # thresholds): good quality off-peak, but bursts above nominal peak
    # produce violations it cannot react to (paper Fig. 5: up to 19%
    # at peak for the static variant)
    s_nomargin = dataclasses.replace(serving, rho_light=1.0, rho_heavy=1.0)
    if serving.worker_classes:
        return solve_heterogeneous_cascade(spec, s_nomargin, profiles, peak)
    return solve_cascade(spec, s_nomargin, profiles, peak,
                         num_workers=serving.num_workers)


# ---------------------------------------------------------------------------
# The controller registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ControllerBundle:
    """A named control-plane policy bundle.

    ``plan_fn`` (signature ``(spec, serving, profiles, peak_qps) ->
    AllocationPlan``) makes the bundle *static*: one provisioning-time
    solve wrapped in a ``FixedPlanPolicy``, never re-planned. Without it
    the bundle is *dynamic*: a ``SolverPlanner`` re-plans every tick,
    optionally in an ``allocator_mode`` ablation (§4.5). ``router`` /
    ``arrival_stage`` / ``uniform_profile`` / ``random_confidence`` are
    the backend knobs that complete the comparison system.
    """
    name: str
    description: str = ""
    router: str = "discriminator"
    arrival_stage: int = 0            # -1: send arrivals straight to final
    uniform_profile: bool = False     # Proteus: deferral profile f(t) = t
    random_confidence: bool = False   # query-agnostic (random) routing
    allocator_mode: Optional[str] = None
    plan_fn: Optional[Callable] = None
    # per-epoch cascade search: the planner re-runs the cascade builder
    # against estimated demand and may switch the serving cascade
    cascade_search: bool = False
    # scaling-policy registry name (serving/autoscaler.py:TORCH_SCALERS)
    # overriding ``serving.scaler``; None keeps the config's choice
    scaler: Optional[str] = None
    # per-tier warm-pool standbys the scaler keeps pre-loaded (only
    # meaningful with an elastic scaler)
    warm_pool: Optional[int] = None
    # admission-policy registry name (serving/admission.py:TORCH_ADMISSIONS)
    # overriding ``serving.admission``; None keeps the config's choice
    admission: Optional[str] = None

    @property
    def dynamic(self) -> bool:
        return self.plan_fn is None


TORCH_CONTROLLERS = {
    "clipper-light": ControllerBundle(
        "clipper-light", "static, query-agnostic, all queries at tier 0",
        router="random", plan_fn=_plan_all_light),
    "clipper-heavy": ControllerBundle(
        "clipper-heavy", "static, query-agnostic, all queries at the "
        "final tier", router="random", arrival_stage=-1,
        plan_fn=_plan_all_heavy),
    "proteus": ControllerBundle(
        "proteus", "dynamic allocation with RANDOM (query-agnostic) "
        "routing", router="random", uniform_profile=True,
        random_confidence=True),
    "diffserve-static": ControllerBundle(
        "diffserve-static", "query-aware cascade provisioned once for "
        "nominal peak, fixed thresholds", plan_fn=_plan_peak_static),
    "diffserve": ControllerBundle(
        "diffserve", "the paper: query-aware cascade + dynamic solver "
        "re-planning every tick"),
    "cascade-search": ControllerBundle(
        "cascade-search", "diffserve + per-epoch cascade search over the "
        "variant catalog: may switch the serving cascade under load",
        cascade_search=True),
    # reactive-vs-predictive elastic provisioning (serving/autoscaler.py)
    "diffserve-reactive": ControllerBundle(
        "diffserve-reactive", "diffserve + reactive elastic scaling: "
        "capacity sized to the trailing EWMA rate, zero look-ahead",
        scaler="reactive"),
    "diffserve-predictive": ControllerBundle(
        "diffserve-predictive", "diffserve + predictive autoscaling: "
        "Holt-Winters forecast horizon covering the control epoch + "
        "model-load lead, per-tier warm pools", scaler="predictive",
        warm_pool=1),
    # overload hardening (serving/admission.py): diffserve + ECN-style
    # queue-depth admission — degrade early under congestion instead of
    # discovering overload at the deadline
    "diffserve-guarded": ControllerBundle(
        "diffserve-guarded", "diffserve + queue-depth (ECN-style) "
        "admission: lowers deferral thresholds as tier queues cross k "
        "and sheds at the door past k*shed_mult",
        admission="queue-depth"),
    # §4.5 resource-allocation ablations, as first-class bundles
    "static_threshold": ControllerBundle(
        "static_threshold", "ablation: re-plans allocation but pins the "
        "thresholds", allocator_mode="static_threshold"),
    "aimd_batching": ControllerBundle(
        "aimd_batching", "ablation: AIMD batch sizing instead of the "
        "solver's batch search", allocator_mode="aimd_batching"),
    "no_queuing_model": ControllerBundle(
        "no_queuing_model", "ablation: Proteus-style 2x headroom instead "
        "of the queuing model", allocator_mode="no_queuing_model"),
}


def list_controllers():
    """(name, description) per registered policy bundle, for CLIs/docs."""
    return [(name, b.description)
            for name, b in sorted(TORCH_CONTROLLERS.items())]


# ---------------------------------------------------------------------------
# Running a bundle
# ---------------------------------------------------------------------------
_UNSET = object()


def search_candidates(serving: ServingConfig, spec=None
                      ) -> "dict[str, object]":
    """The cascade-search candidate set for a ServingConfig: explicit
    ``candidate_cascades`` registry/catalog names when given, else the
    default pool (registry cascades sharing the active spec's SLO and
    final model, plus its sub-chains). The active cascade is always a
    candidate — and always by its own spec *object*, which may carry
    measured profiles."""
    from repro_torch.serving.profiles import CASCADES, resolve_cascade
    spec = spec if spec is not None else as_cascade_spec(serving.cascade)
    if serving.candidate_cascades:
        out = {spec.name: spec}
        for n in serving.candidate_cascades:
            if n != spec.name:
                out[n] = resolve_cascade(n, serving.catalog)
        return out
    return default_candidates(spec, serving, registry=CASCADES)


def _search_planner(bundle: ControllerBundle, serving: ServingConfig,
                    spec, profiles, seed: int,
                    allocator_options: Optional[AllocatorOptions]
                    ) -> CascadeSearchPlanner:
    """Assemble the per-epoch cascade-search planner: the active
    candidate shares the backend's DeferralProfile objects (online f(t)
    refreshes flow into the search); the others get their own fitted
    calibration profiles."""
    candidates = search_candidates(serving, spec)
    profiles_by = {}
    for n, cand in candidates.items():
        if n == spec.name:
            profiles_by[n] = tuple(profiles)
        else:
            profiles_by[n] = make_profiles(
                dataclasses.replace(serving, cascade=cand), seed,
                uniform=bundle.uniform_profile)
    return CascadeSearchPlanner(serving, candidates, profiles_by,
                                active=spec.name,
                                allocator_options=allocator_options,
                                router=bundle.router)


def assemble_bundle(name: Optional[str], trace: Trace,
                    serving: ServingConfig, *, seed: int = 0,
                    estimator: Optional[str] = None,
                    allocator_options: Optional[AllocatorOptions] = None,
                    fixed_plan=_UNSET, profiles=None):
    """Resolve a registry bundle into its runnable pieces — (bundle,
    profiles, fixed_plan, control, confidence_fn) — the single place
    bundle fields become a ControlPlane, shared by ``run_controller``
    and examples/serve_cascade.py so the wiring cannot drift.
    ``fixed_plan`` overrides the bundle's provisioning solve when given
    (``None`` forces a dynamic planner); ``profiles`` overrides the
    offline synthetic boundary fit (e.g. ``--quality-models`` loads a
    cluster run's discriminator-fitted calibration)."""
    name = (name or serving.controller).lower()
    try:
        bundle = TORCH_CONTROLLERS[name]
    except KeyError:
        raise KeyError(f"unknown controller {name!r}; "
                       f"known {sorted(TORCH_CONTROLLERS)}") from None
    if bundle.scaler is not None and serving.scaler != bundle.scaler:
        serving = dataclasses.replace(serving, scaler=bundle.scaler)
    if bundle.warm_pool is not None and not serving.warm_pool:
        serving = dataclasses.replace(serving, warm_pool=bundle.warm_pool)
    if bundle.admission is not None and serving.admission != bundle.admission:
        serving = dataclasses.replace(serving, admission=bundle.admission)
    spec = as_cascade_spec(serving.cascade)
    if profiles is None:
        profiles = make_profiles(serving, seed,
                                 uniform=bundle.uniform_profile)
    if fixed_plan is _UNSET:
        peak = float(np.max(trace.qps))
        fixed_plan = (bundle.plan_fn(spec, serving, profiles, peak)
                      if bundle.plan_fn else None)
    confidence_fn = None
    if bundle.random_confidence:
        rng = np.random.default_rng(seed + 1)
        confidence_fn = lambda n_, b_: rng.random(n_)   # noqa: E731
    if allocator_options is None and bundle.allocator_mode:
        allocator_options = AllocatorOptions(mode=bundle.allocator_mode)
    planner = (_search_planner(bundle, serving, spec, profiles, seed,
                               allocator_options)
               if bundle.cascade_search else None)
    control = build_control_plane(
        spec, serving, profiles, allocator_options=allocator_options,
        fixed_plan=fixed_plan, estimator=estimator, trace=trace,
        planner=planner)
    return bundle, profiles, fixed_plan, control, confidence_fn


def run_controller(name: Optional[str], trace: Trace, serving: ServingConfig,
                   *, seed: int = 0, sim_overrides: Optional[dict] = None,
                   overprovision: Optional[float] = None,
                   estimator: Optional[str] = None,
                   allocator_options: Optional[AllocatorOptions] = None
                   ) -> SimResult:
    """Build a registry bundle's ControlPlane + simulator backend and
    replay ``trace``. ``name`` defaults to ``serving.controller``;
    ``estimator`` (a registry name: ewma / sliding-window / oracle)
    defaults to ``serving.estimator``."""
    if overprovision is not None:
        serving = dataclasses.replace(serving, overprovision=overprovision)
    overrides = dict(sim_overrides or {})
    bundle, profiles, plan, control, confidence_fn = assemble_bundle(
        name, trace, serving, seed=seed, estimator=estimator,
        allocator_options=allocator_options,
        fixed_plan=overrides.get("fixed_plan", _UNSET))
    sim_kw = dict(seed=seed, router=bundle.router,
                  arrival_stage=bundle.arrival_stage, fixed_plan=plan)
    sim_kw.update(overrides)
    if getattr(serving, "stage_graph", "off") not in ("off", "", None):
        # stage-granular micro-serving (serving/microserve.py): the
        # stage engine replays the same trace through per-stage queues
        from repro_torch.serving.microserve import (StageGraphSimulator,
                                                    make_stage_graph)
        graph = make_stage_graph(serving.stage_graph, serving)
        eng = StageGraphSimulator(serving, profiles, graph,
                                  SimConfig(**sim_kw),
                                  confidence_fn=confidence_fn,
                                  control=control)
        return eng.run(trace)
    sim = Simulator(serving, profiles, SimConfig(**sim_kw),
                    confidence_fn=confidence_fn, control=control)
    return sim.run(trace)


def run_baseline(name: str, trace: Trace, serving: ServingConfig,
                 *, seed: int = 0, sim_overrides: Optional[dict] = None,
                 overprovision: Optional[float] = None,
                 estimator: Optional[str] = None) -> SimResult:
    """Legacy entry point for the five paper baselines (now registry
    bundles; any ``TORCH_CONTROLLERS`` name is accepted)."""
    return run_controller(name, trace, serving, seed=seed,
                          sim_overrides=sim_overrides,
                          overprovision=overprovision, estimator=estimator)


def run_ablation(mode: str, trace: Trace, serving: ServingConfig,
                 *, seed: int = 0, **alloc_kw) -> SimResult:
    """Resource-allocation ablations (paper §4.5): static_threshold,
    aimd_batching, no_queuing_model."""
    return run_controller(mode, trace, serving, seed=seed,
                          allocator_options=AllocatorOptions(mode=mode,
                                                             **alloc_kw))
