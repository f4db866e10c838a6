"""The simulator's data: ``Query``, the conservation identity
``CONSERVATION_FIELDS`` and ``SimResult``, which every serving backend
reports into (``serving/cluster.py:ClusterBackend`` here).

PyTorch-port copy of those three definitions of
``repro/serving/simulator.py`` (framework-free), held to the original by
``tests/test_torch_control.py``. The discrete-event ``Simulator`` itself
is not ported yet (ROADMAP.md, Queue 1 item 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Query:
    qid: int
    arrival: float
    deadline: float
    stage: int = 0                # current tier index
    confidence: Optional[float] = None
    enqueued_at: float = 0.0
    done_at: Optional[float] = None
    dropped: bool = False
    deferred: bool = False
    hedged: bool = False


# The conservation identity: every offered query lands in exactly one
# of these buckets, so `total == sum(getattr(r, f) for f in
# CONSERVATION_FIELDS)` after every run. The overload battery asserts
# it (tests/test_overload.py) and the conservation-taxonomy lint rule
# enforces at AST level that no counter is incremented outside it —
# adding a drop bucket means extending this tuple (and the tests), not
# just declaring a field.
CONSERVATION_FIELDS: Tuple[str, ...] = (
    "completed", "shed_admission", "dropped_predictive",
    "dropped_deadline", "dropped_stage")


@dataclasses.dataclass
class SimResult:
    completed: int = 0
    # split drop taxonomy (serving/admission.py): shed at the admission
    # door / predicted deadline miss / lost to capacity or the deadline.
    # The legacy aggregate lives on as the `dropped` property below.
    shed_admission: int = 0
    dropped_predictive: int = 0
    dropped_deadline: int = 0
    # stage-graph runs (serving/microserve.py): queries still queued in
    # a micro-stage or riding a slot batch when the horizon closes;
    # always 0 on the classic whole-tier path (golden-pinned)
    dropped_stage: int = 0
    violations: int = 0
    total: int = 0
    deferred: int = 0
    completed_per_tier: List[int] = dataclasses.field(default_factory=list)
    tier_processed: List[int] = dataclasses.field(default_factory=list)
    deferred_per_boundary: List[int] = dataclasses.field(default_factory=list)
    fid_timeline: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    threshold_timeline: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    thresholds_timeline: List[Tuple[float, Tuple[float, ...]]] = \
        dataclasses.field(default_factory=list)
    violation_timeline: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    latencies: List[float] = dataclasses.field(default_factory=list)
    solve_ms: List[float] = dataclasses.field(default_factory=list)
    hedged: int = 0
    requeued_on_failure: int = 0
    # live per-class worker census: declared counts until run() ends,
    # then the end-of-run alive counts (failures/scaling show up here)
    workers_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per worker class: (batch size, wall-clock batch latency) samples
    class_batch_latencies: Dict[str, List[Tuple[int, float]]] = \
        dataclasses.field(default_factory=dict)
    # (t, $/hour) of each applied plan (cost-weighted objective runs)
    plan_cost_timeline: List[Tuple[float, float]] = \
        dataclasses.field(default_factory=list)
    # (t, cascade name) whenever a cascade-searching planner's choice
    # changes (first entry = the initial choice); empty for fixed-cascade
    # controllers
    cascade_timeline: List[Tuple[float, str]] = \
        dataclasses.field(default_factory=list)
    # (t, provisioned slots) step function of elastic capacity: the
    # initial fleet plus every set_capacity / scale-event change (the
    # autoscale benchmark integrates it into $-cost)
    capacity_timeline: List[Tuple[float, int]] = \
        dataclasses.field(default_factory=list)
    # discrete events pumped (BENCH_serving.json event-throughput metric)
    events_processed: int = 0
    # queries that exited denoise early on discriminator confidence
    # (stage-graph runs; serving/microserve.py)
    preempted_early: int = 0
    # (t, ((tier, stage, queued, in_service), ...)) per control tick —
    # the stage engine's per-stage occupancy timeline
    stage_timeline: List[Tuple[float, Tuple]] = \
        dataclasses.field(default_factory=list)

    @property
    def cascade_switches(self) -> int:
        return max(len(self.cascade_timeline) - 1, 0)

    @property
    def dropped(self) -> int:
        """Backward-compatible aggregate of the post-admission drops.
        Door-shedding is deliberately excluded: a shed query was never
        admitted, so it is neither a violation nor a drop — under the
        accept-all baseline this property is bit-identical to the old
        single counter (golden-pinned)."""
        return (self.dropped_predictive + self.dropped_deadline
                + self.dropped_stage)

    def conserved(self) -> bool:
        """The conservation identity over the split drop taxonomy."""
        return self.total == sum(getattr(self, f)
                                 for f in CONSERVATION_FIELDS)

    @property
    def violation_ratio(self) -> float:
        return self.violations / max(self.total, 1)

    @property
    def shed_fraction(self) -> float:
        return self.shed_admission / max(self.total, 1)

    @property
    def goodput(self) -> float:
        """Fraction of *offered* queries completed within their SLO —
        the degradation-curve y-axis that treats shed, dropped, and late
        queries uniformly as lost work."""
        late = self.violations - self.dropped
        return (self.completed - late) / max(self.total, 1)

    @property
    def defer_fraction(self) -> float:
        return self.deferred / max(self.completed, 1)

    def boundary_defer_fractions(self) -> List[float]:
        """Fraction of queries processed at tier i that were deferred
        across boundary i (one entry per boundary)."""
        return [d / max(p, 1) for d, p in
                zip(self.deferred_per_boundary, self.tier_processed)]

    @property
    def mean_fid(self) -> float:
        vals = [f for _, f in self.fid_timeline]
        return float(np.mean(vals)) if vals else float("nan")

    @property
    def mean_plan_cost_per_hour(self) -> float:
        vals = [c for _, c in self.plan_cost_timeline]
        return float(np.mean(vals)) if vals else float("nan")

    def class_latency_summary(self) -> Dict[str, float]:
        """Mean wall-clock batch latency per worker class (for reports)."""
        return {cls: round(float(np.mean([d for _, d in v])), 4)
                for cls, v in sorted(self.class_batch_latencies.items())
                if v}

    def record_decision(self, now: float, decision) -> None:
        """Log one control decision (shared by every backend so the
        decision timelines cannot diverge across backends)."""
        plan = decision.plan
        self.solve_ms.append(plan.solve_ms)
        self.threshold_timeline.append(
            (now, decision.thresholds[0] if decision.thresholds else 1.0))
        self.thresholds_timeline.append((now, tuple(decision.thresholds)))
        if getattr(plan, "cost", None) is not None:
            self.plan_cost_timeline.append((now, plan.cost))
        cascade = getattr(decision, "cascade", None)
        if cascade is not None and (
                not self.cascade_timeline
                or self.cascade_timeline[-1][1] != cascade.name):
            self.cascade_timeline.append((now, cascade.name))
