"""ResourceManager — the controller's brain (paper §3.3).

Wraps the N-tier cascade solver with: EWMA demand estimation, Little's-law
queueing inputs from live per-tier telemetry, elastic worker counts
(failures / scale events), and the ablation modes evaluated in §4.5
(static thresholds, AIMD batching, Proteus queuing heuristic).

PyTorch-port copy of ``repro/core/allocator.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.config.base import ServingConfig, as_cascade_spec
from repro_torch.core.confidence import (DeferralProfile,
                                         as_boundary_profiles)
from repro_torch.core.milp import (AllocationPlan, Telemetry, solve_cascade,
                                   solve_heterogeneous_cascade)


@dataclasses.dataclass
class AllocatorOptions:
    mode: str = "diffserve"       # diffserve | static_threshold |
    #                               aimd_batching | no_queuing_model
    static_threshold: float = 0.7
    aimd_increase: int = 1
    aimd_decrease: float = 0.5


class ResourceManager:
    def __init__(self, cascade, serving: ServingConfig,
                 profiles: "DeferralProfile | Sequence[DeferralProfile]",
                 options: Optional[AllocatorOptions] = None,
                 stage_graph=None):
        self.spec = as_cascade_spec(cascade)
        self.cascade = self.spec            # legacy alias
        self.serving = serving
        self.profiles = as_boundary_profiles(profiles,
                                             self.spec.num_boundaries)
        self.options = options or AllocatorOptions()
        # per-stage allocation mode (serving/microserve.py StageGraph):
        # plans carry stage_workers so the stage engine gets stage
        # fleets, not just tier fleets
        self.stage_graph = stage_graph
        # shed-feedback state: last cumulative door-shed count seen
        self._last_shed = 0
        self._demand_ewma: Optional[float] = None
        self._aimd_batches: List[int] = [
            max(self.spec.tier_batch_choices(i, serving.batch_choices))
            for i in range(self.spec.num_tiers)]
        self.solve_times_ms: List[float] = []
        self.last_plan: Optional[AllocationPlan] = None

    @property
    def profile(self) -> DeferralProfile:
        return self.profiles[0]

    # ------------------------------------------------------------------
    def estimate_demand(self, observed_qps: float) -> float:
        a = self.serving.ewma_alpha
        if self._demand_ewma is None:
            self._demand_ewma = observed_qps
        else:
            self._demand_ewma = a * observed_qps + (1 - a) * self._demand_ewma
        return self._demand_ewma

    def observe_slo_timeout(self):
        """AIMD ablation signal: multiplicative decrease on timeout."""
        self._aimd_batches = [max(1, int(b * self.options.aimd_decrease))
                              for b in self._aimd_batches]

    def observe_ok_tick(self):
        self._aimd_batches = [
            min(max(self.spec.tier_batch_choices(i,
                                                 self.serving.batch_choices)),
                b + self.options.aimd_increase)
            for i, b in enumerate(self._aimd_batches)]

    # ------------------------------------------------------------------
    def plan(self, telemetry: Telemetry) -> AllocationPlan:
        """Legacy entry point: estimate demand internally, then solve.
        The control plane instead owns estimation (a ``DemandEstimator``
        policy) and calls ``plan_for_demand`` directly."""
        demand = self.estimate_demand(telemetry.demand_qps)
        return self.plan_for_demand(telemetry, demand)

    def plan_for_demand(self, telemetry: Telemetry,
                        demand: float) -> AllocationPlan:
        opts = self.options
        demand = self._shed_adjusted(telemetry, demand)
        if self.serving.worker_classes:
            solver = solve_heterogeneous_cascade
            kw = dict(
                classes=self._live_classes(telemetry),
                queues=telemetry.queues,
                arrivals=telemetry.arrivals,
            )
        else:
            solver = solve_cascade
            kw = dict(
                num_workers=telemetry.live_workers
                or self.serving.num_workers,
                queues=telemetry.queues,
                arrivals=telemetry.arrivals,
            )
        if self.stage_graph is not None:
            kw["stage_graph"] = self.stage_graph
        if opts.mode == "static_threshold":
            plan = solver(
                self.spec, self.serving, self.profiles, demand,
                fixed_thresholds=(opts.static_threshold,)
                * self.spec.num_boundaries, **kw)
        elif opts.mode == "aimd_batching":
            plan = solver(self.spec, self.serving, self.profiles,
                          demand,
                          fixed_batches=tuple(self._aimd_batches),
                          **kw)
        elif opts.mode == "no_queuing_model":
            plan = solver(self.spec, self.serving, self.profiles,
                          demand, queuing_model="proteus_2x", **kw)
        else:
            plan = solver(self.spec, self.serving, self.profiles,
                          demand, **kw)
        self.solve_times_ms.append(plan.solve_ms)
        self.last_plan = plan
        return plan

    def _shed_adjusted(self, telemetry: Telemetry, demand: float) -> float:
        """Shed-adjusted QPS prior (``serving.shed_feedback``): queries
        the admission door turned away last period never reach the
        arrival window, so a shedding system plans for the *survivor*
        rate and can never provision its way out of overload. Fold the
        per-period shed delta back into the demand the solver sees —
        the door's decision becomes a solver signal, not a door-side
        secret. Off by default (bit-identical goldens)."""
        if not getattr(self.serving, "shed_feedback", False):
            return demand
        shed = int(getattr(telemetry, "shed_admission", 0) or 0)
        delta = max(shed - self._last_shed, 0)
        self._last_shed = shed
        period = max(self.serving.control_period_s, 1e-9)
        return demand + delta / period

    def _live_classes(self, telemetry: Telemetry) -> dict:
        """Worker-class table (``{name: WorkerClass}``, latency profiles
        intact) shrunk to the classes' live counts (failure detection /
        elastic scaling reduce a class's inventory). When the census is
        populated, a class absent from it is fully dead and must not be
        planned over; an empty census (first tick) means no failures
        observed yet."""
        live = dict(telemetry.live_by_class)
        table = {}
        for wc in self.serving.worker_classes:
            count = live.get(wc.name, 0) if telemetry.live_by_class \
                else wc.count
            if count > 0:
                table[wc.name] = dataclasses.replace(wc, count=count)
        return table or self.serving.class_map()
