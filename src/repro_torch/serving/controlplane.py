"""Backend-agnostic control plane (paper §4: demand estimation → ILP
allocation → threshold setting → elastic scaling/fault handling).

The controller used to be fused into the discrete-event ``Simulator``;
this module extracts it into a ``ControlPlane`` that owns the control
tick and composes four small policy protocols:

  * ``DemandEstimator``  — EWMA (paper), sliding-window, oracle
  * ``PlannerPolicy``    — cascade solver (homogeneous / heterogeneous /
                           ablation modes) or a fixed plan that never
                           re-plans (the static baselines)
  * ``ThresholdPolicy``  — how plan thresholds become live thresholds
  * ``ScalingPolicy``    — heartbeat fault detection + elastic sizing

all driving an abstract ``ExecutorBackend`` (``apply_plan`` / ``census``
/ ``telemetry_window`` / ``submit`` / ``poll``). The simulator is one
backend (serving/simulator.py); a real cluster is another
(serving/cluster.py:ClusterBackend), so cluster mode runs the same
control loop over measured profiles. The named policy bundles that
reproduce the paper's comparison systems live in serving/baselines.py.

This module is jax-free: policies are pure control logic over
``Telemetry``/``AllocationPlan`` data.

PyTorch-port copy of ``repro/serving/controlplane.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``. The estimator registry is
``TORCH_ESTIMATORS`` (named apart from the JAX package's ``ESTIMATORS``
for the repo linter's index); the stage-graph planner and the predictive
autoscalers are not ported and raise ``NotImplementedError`` when a
config selects them.
"""
from __future__ import annotations

import copy
import dataclasses
from collections import deque
from typing import Dict, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.core.allocator import AllocatorOptions, ResourceManager
from repro_torch.core.confidence import DeferralProfile
from repro_torch.core.milp import AllocationPlan, Telemetry
from repro_torch.serving.admission import (AcceptAllAdmission,
                                           AdmissionPolicy, make_admission)


# ---------------------------------------------------------------------------
# Backend-facing data
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Census:
    """Worker inventory snapshot a backend reports at tick start."""
    now: float = 0.0
    active_slots: int = 0             # provisioned worker slots (elastic S)
    live_workers: int = 0             # alive workers within the active slots
    live_by_class: Tuple[Tuple[str, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class ControlDecision:
    """One control tick's output, handed to the backend to enact.

    ``cascade``/``profiles`` are set by cascade-searching planners
    (serving/autocascade.py:CascadeSearchPlanner): a non-None ``cascade``
    that differs from the backend's current spec instructs the backend
    to *switch the serving cascade* mid-run (tier remap + model reloads)
    and adopt ``profiles`` as its live per-boundary deferral state (the
    planner shares the same objects, so online f(t) refreshes keep
    flowing). ``None`` (every non-searching planner) means "keep the
    current cascade" — existing behavior, bit-identical.
    """
    plan: AllocationPlan
    thresholds: Tuple[float, ...]
    cascade: Optional[object] = None          # CascadeSpec | None
    profiles: Optional[Tuple[DeferralProfile, ...]] = None


@runtime_checkable
class ExecutorBackend(Protocol):
    """What a serving backend must expose to the control plane. The
    simulator and the cluster runtime both implement this."""

    def census(self) -> Census: ...

    def telemetry_window(self) -> Telemetry: ...

    def apply_plan(self, decision: ControlDecision) -> None: ...

    def detect_faults(self) -> None:
        """Heartbeat sweep: requeue work stranded on dead workers."""

    def submit(self, queries) -> None:
        """Enqueue queries for execution."""

    def poll(self):
        """Progress snapshot (backend-specific result object)."""


def windowed_telemetry(now: float, period_s: float, arrivals_window,
                       queues: Tuple[float, ...], profiles,
                       thresholds: Tuple[float, ...],
                       census: Census,
                       drops: Tuple[int, int, int] = (0, 0, 0)) -> Telemetry:
    """The shared telemetry math every backend reports with: prune the
    arrival window to the last control period, estimate qps from it, and
    cascade per-boundary arrival rates through the deferral profiles
    f(t). Queue lengths stay backend-specific (per-worker queues in the
    simulator, per-tier queues in the cluster backend). One definition,
    so the planner's inputs cannot silently diverge across backends.

    Mutates ``arrivals_window`` (a deque of arrival timestamps) in
    place, as the backends' windows are rolling state."""
    horizon = now - period_s
    while arrivals_window and arrivals_window[0] < horizon:
        arrivals_window.popleft()
    qps = len(arrivals_window) / max(period_s, 1e-9)
    arrivals = [qps]
    for b, p in enumerate(profiles):
        arrivals.append(arrivals[-1] * p.f(thresholds[b]))
    return Telemetry(demand_qps=qps, queues=tuple(queues),
                     arrivals=tuple(arrivals),
                     live_workers=census.live_workers,
                     live_by_class=census.live_by_class,
                     shed_admission=int(drops[0]),
                     dropped_predictive=int(drops[1]),
                     dropped_deadline=int(drops[2]))


# ---------------------------------------------------------------------------
# Demand estimators
# ---------------------------------------------------------------------------
class DemandEstimator(Protocol):
    def estimate(self, observed_qps: float, now: float = 0.0) -> float: ...


class EwmaEstimator:
    """The paper's estimator: exponentially weighted moving average of
    the per-control-period arrival rate, seeded with the first sample."""

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self._value: Optional[float] = None

    def estimate(self, observed_qps: float, now: float = 0.0) -> float:
        if self._value is None:
            self._value = float(observed_qps)
        else:
            self._value = (self.alpha * observed_qps
                           + (1 - self.alpha) * self._value)
        return self._value


class SlidingWindowEstimator:
    """Mean of the last ``window`` per-tick arrival rates: less laggy
    than EWMA on square-wave load, noisier on spiky traces."""

    def __init__(self, window: int = 5):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._obs: deque = deque(maxlen=int(window))

    def estimate(self, observed_qps: float, now: float = 0.0) -> float:
        self._obs.append(float(observed_qps))
        return float(np.mean(self._obs))


class OracleEstimator:
    """Perfect demand knowledge: reads the trace's true rate at the tick
    time (an upper bound for estimator ablations)."""

    def __init__(self, trace):
        self.trace = trace

    def estimate(self, observed_qps: float, now: float = 0.0) -> float:
        return float(self.trace.rate_at(now))


# Estimator registry: name -> factory(serving, trace). ``trace`` may be
# None for estimators that only observe (everything but the oracle).
TORCH_ESTIMATORS = {
    # ewma_alpha is the paper's pinned smoothing constant (§5, 0.6) —
    # a core-control knob deliberately not exposed on the CLI
    "ewma": lambda serving, trace=None: EwmaEstimator(
        serving.ewma_alpha),
    "sliding-window": lambda serving, trace=None: SlidingWindowEstimator(),
    "oracle": lambda serving, trace=None: OracleEstimator(
        _require_trace(trace)),
}


def _require_trace(trace):
    if trace is None:
        raise ValueError("the 'oracle' estimator needs the trace it is "
                         "an oracle for (pass trace=...)")
    return trace


def make_estimator(name: str, serving: ServingConfig,
                   trace=None) -> DemandEstimator:
    try:
        factory = TORCH_ESTIMATORS[name]
    except KeyError:
        raise KeyError(f"unknown estimator {name!r}; "
                       f"known {sorted(TORCH_ESTIMATORS)}") from None
    return factory(serving, trace)


# ---------------------------------------------------------------------------
# Planner policies
# ---------------------------------------------------------------------------
class PlannerPolicy(Protocol):
    needs_telemetry: bool

    def plan(self, telemetry: Telemetry, demand: float) -> AllocationPlan: ...


class SolverPlanner:
    """Re-plans every tick through the cascade solver (``solve_cascade``
    or ``solve_heterogeneous_cascade`` via ``ResourceManager``, including
    the §4.5 ablation modes of ``AllocatorOptions``)."""

    needs_telemetry = True

    def __init__(self, rm: ResourceManager):
        self.rm = rm

    def plan(self, telemetry: Telemetry, demand: float) -> AllocationPlan:
        return self.rm.plan_for_demand(telemetry, demand)


class FixedPlanPolicy:
    """Never re-plans: the static baselines (Clipper-Light/Heavy,
    DiffServe-Static) are one solve at provisioning time, frozen."""

    needs_telemetry = False

    def __init__(self, plan: AllocationPlan):
        self.fixed = plan

    def plan(self, telemetry: Telemetry, demand: float) -> AllocationPlan:
        return self.fixed


# ---------------------------------------------------------------------------
# Threshold policies
# ---------------------------------------------------------------------------
class ThresholdPolicy(Protocol):
    def select(self, plan: AllocationPlan,
               telemetry: Telemetry) -> Tuple[float, ...]: ...


class PlanThresholds:
    """Default: trust the solver's per-boundary thresholds verbatim."""

    def select(self, plan: AllocationPlan,
               telemetry: Telemetry) -> Tuple[float, ...]:
        return tuple(plan.thresholds)


class StaticThresholds:
    """Pin every boundary to one value regardless of the plan (note the
    paper's static-threshold *ablation* instead fixes thresholds inside
    the solver so the allocation stays consistent — that path is
    ``AllocatorOptions(mode='static_threshold')``)."""

    def __init__(self, value: float):
        self.value = float(value)

    def select(self, plan: AllocationPlan,
               telemetry: Telemetry) -> Tuple[float, ...]:
        return (self.value,) * len(plan.thresholds)


# ---------------------------------------------------------------------------
# Scaling / fault policies
# ---------------------------------------------------------------------------
class ScalingPolicy(Protocol):
    def on_tick(self, backend: ExecutorBackend, census: Census) -> None: ...


class HeartbeatScaling:
    """The paper's failure handling: a heartbeat sweep at tick start
    requeues work stranded on dead workers; elastic sizing is left to
    external scale events (the backend's census reflects them)."""

    def on_tick(self, backend: ExecutorBackend, census: Census) -> None:
        backend.detect_faults()


class NullScaling:
    """No fault detection (backends with no failure domain)."""

    def on_tick(self, backend: ExecutorBackend, census: Census) -> None:
        pass


# ---------------------------------------------------------------------------
# The control plane
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ControlPlane:
    """Owns the control tick: fault sweep → telemetry → demand estimate →
    plan → thresholds → enact on the backend. One instance drives exactly
    one backend's lifetime (estimator/planner state is sequential)."""

    estimator: DemandEstimator
    planner: PlannerPolicy
    thresholds: ThresholdPolicy = dataclasses.field(
        default_factory=PlanThresholds)
    scaling: ScalingPolicy = dataclasses.field(
        default_factory=HeartbeatScaling)
    # overload hardening (serving/admission.py): the backends consult
    # this policy per arrival (shedding), and each tick's freshly
    # selected thresholds pass through its ``degrade`` hook so a
    # congestion-aware policy can lower deferral thresholds *before*
    # deadlines are missed. The accept-all default is a bit-identical
    # no-op (golden-pinned).
    admission: AdmissionPolicy = dataclasses.field(
        default_factory=AcceptAllAdmission)
    # known starting demand (Trace.rate_at(0) on replay paths): the first
    # tick provisions for it instead of the blind nominal 1.0 qps, fixing
    # cold-start under-provisioning on traces that start hot. None keeps
    # the legacy nominal (bit-identical goldens).
    initial_demand: Optional[float] = None

    def tick(self, backend: ExecutorBackend,
             first: bool = False) -> ControlDecision:
        census = backend.census()
        self.scaling.on_tick(backend, census)
        if self.planner.needs_telemetry:
            # the first tick runs before any arrivals: plan for the known
            # starting demand when the trace was given, else nominal unit
            # demand, over the full provisioned slot count
            tel = (Telemetry(demand_qps=(1.0 if self.initial_demand is None
                                         else float(self.initial_demand)),
                             live_workers=census.active_slots)
                   if first else backend.telemetry_window())
            demand = self.estimator.estimate(tel.demand_qps, now=census.now)
            # a predictive scaler substitutes its forecast at enactment
            # time for the trailing estimate (absent on the classic
            # heartbeat/null policies -> unchanged demand)
            forecast = getattr(self.scaling, "plan_demand", None)
            if forecast is not None:
                demand = forecast(demand, census.now)
        else:
            tel, demand = Telemetry(demand_qps=0.0), 0.0
            if self.admission.needs_telemetry and not first:
                # fixed-plan bundles skip the telemetry window, but a
                # congestion-aware admission policy still needs queue
                # depths to degrade against
                tel = backend.telemetry_window()
        plan = self.planner.plan(tel, demand)
        chosen = getattr(self.planner, "chosen_cascade", None)
        chosen_profiles = getattr(self.planner, "chosen_profiles", None)
        decision = ControlDecision(plan=plan,
                                   thresholds=self.admission.degrade(
                                       self.thresholds.select(plan, tel),
                                       tel),
                                   cascade=chosen,
                                   profiles=tuple(chosen_profiles)
                                   if chosen_profiles is not None else None)
        backend.apply_plan(decision)
        return decision

    # ------- snapshot/restore (serving/faults.py) -------
    def state_dict(self) -> Dict:
        # deep-copied: a sliding-window estimator's deque must not alias
        # between the snapshot and the live object (an in-memory
        # checkpoint would otherwise drift as the run continues)
        state: Dict = {"estimator": copy.deepcopy(dict(vars(self.estimator)))}
        # admission policies may carry mutable state (token-bucket fill)
        state["admission"] = copy.deepcopy(dict(vars(self.admission)))
        rm = getattr(self.planner, "rm", None)
        if rm is not None:
            state["aimd_batches"] = list(rm._aimd_batches)
        return state

    def load_state(self, state: Dict) -> None:
        vars(self.estimator).update(
            copy.deepcopy(state.get("estimator", {})))
        vars(self.admission).update(
            copy.deepcopy(state.get("admission", {})))
        rm = getattr(self.planner, "rm", None)
        if rm is not None and "aimd_batches" in state:
            rm._aimd_batches = list(state["aimd_batches"])

    @property
    def rm(self) -> Optional[ResourceManager]:
        """The solver wrapper, when this plane re-plans (None for fixed
        plans) — legacy accessor for snapshot/inspection call sites."""
        return getattr(self.planner, "rm", None)


def build_control_plane(spec, serving: ServingConfig,
                        profiles: Sequence[DeferralProfile], *,
                        allocator_options: Optional[AllocatorOptions] = None,
                        fixed_plan: Optional[AllocationPlan] = None,
                        estimator: "DemandEstimator | str | None" = None,
                        trace=None,
                        planner: Optional[PlannerPolicy] = None,
                        thresholds: Optional[ThresholdPolicy] = None,
                        scaling: Optional[ScalingPolicy] = None,
                        admission: "AdmissionPolicy | str | None" = None
                        ) -> ControlPlane:
    """The default DiffServe control plane: EWMA estimation (or the
    ``serving.estimator`` registry name), solver re-planning (or a fixed
    plan, or an explicit ``planner`` policy such as a
    ``CascadeSearchPlanner``), plan-thresholds, heartbeat fault
    detection.

    ``profiles`` must be the backend's own ``DeferralProfile`` objects so
    online f(t) refreshes flow into the planner.

    ``scaling`` resolves from the ``serving.scaler`` registry name
    (serving/autoscaler.py:SCALERS) when not given explicitly; the
    default name is "heartbeat", the classic fault sweep. When
    ``serving.warm_start_demand`` is set and the trace is known, the
    first tick provisions for ``trace.rate_at(0)`` instead of the
    nominal 1.0 qps."""
    if estimator is None:
        estimator = serving.estimator
    if isinstance(estimator, str):
        estimator = make_estimator(estimator, serving, trace)
    if planner is not None:
        if fixed_plan is not None:
            raise ValueError("pass either an explicit planner or a "
                             "fixed_plan, not both")
    elif fixed_plan is not None:
        planner = FixedPlanPolicy(fixed_plan)
    else:
        if getattr(serving, "stage_graph", "off") not in (None, "", "off"):
            raise NotImplementedError(
                f"stage_graph={serving.stage_graph!r}: the stage-graph "
                "planner (serving/microserve.py) is not ported yet "
                "(ROADMAP.md, Queue 1 item 1)")
        planner = SolverPlanner(ResourceManager(spec, serving, profiles,
                                                allocator_options))
    if scaling is None:
        name = getattr(serving, "scaler", "heartbeat") or "heartbeat"
        if name == "heartbeat":
            scaling = HeartbeatScaling()
        elif name == "null":
            scaling = NullScaling()
        else:
            raise NotImplementedError(
                f"scaler={name!r}: the predictive autoscaler "
                "(serving/autoscaler.py) is not ported yet (ROADMAP.md, "
                "Queue 1 item 1); the port has 'heartbeat' and 'null'")
    if admission is None:
        admission = getattr(serving, "admission", "accept-all") \
            or "accept-all"
    if isinstance(admission, str):
        admission = make_admission(admission, serving)
    initial_demand = None
    if getattr(serving, "warm_start_demand", False) and trace is not None:
        initial_demand = float(trace.rate_at(0.0))
    return ControlPlane(estimator=estimator, planner=planner,
                        thresholds=thresholds or PlanThresholds(),
                        scaling=scaling,
                        admission=admission,
                        initial_demand=initial_demand)
