"""Discrete-event simulator for DiffServe (paper §4.1: the paper's headline
results come from its simulator; the testbed validated it to within 0.56 %
FID / 1.1 % SLO violations), generalized to N-tier cascades.

Entities: queries, workers (role = tier index, local queue, batched
execution with profiled latencies + straggler jitter), a load balancer
(least-loaded routing + hedged re-dispatch), and a controller (EWMA demand,
cascade-solver re-planning, failure detection via heartbeats, elastic
worker counts). A query enters at tier 0 (the cheapest model); after each
non-final tier a discriminator confidence below that boundary's threshold
defers it one tier deeper.

Confidence scores come from the calibrated per-boundary DeferralProfiles
(sim mode) or a real cascade (cluster mode via serving/cluster.py).

The controller itself lives in serving/controlplane.py: the simulator is
one ``ExecutorBackend`` (census / telemetry_window / apply_plan /
detect_faults / submit / poll), and its control tick is a
``ControlPlane.tick`` call.

PyTorch-port copy of ``repro/serving/simulator.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

import dataclasses
import heapq
import inspect
import itertools
import math
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.config.base import (LatencyProfile, ServingConfig,
                                     as_cascade_spec)
from repro_torch.core.allocator import AllocatorOptions, ResourceManager
from repro_torch.core.confidence import DeferralProfile, as_boundary_profiles
from repro_torch.core.milp import AllocationPlan, Telemetry
from repro_torch.core.quality import QualityModel
from repro_torch.serving.admission import AcceptAllAdmission
from repro_torch.serving.controlplane import (Census, ControlDecision,
                                              ControlPlane,
                                              build_control_plane,
                                              windowed_telemetry)
from repro_torch.serving.trace import Trace


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


@dataclasses.dataclass
class Worker:
    wid: int
    role: Optional[int] = None    # tier index; None while (re)loading
    batch_role: Optional[int] = None   # tier the in-flight batch started as
    batch_size: int = 1
    queue: deque = dataclasses.field(default_factory=deque)
    busy_until: float = 0.0
    alive: bool = True
    loading_until: float = 0.0
    in_flight: List[Query] = dataclasses.field(default_factory=list)
    batch_started: float = 0.0
    last_heartbeat: float = 0.0
    speed: float = 1.0            # hardware-class throughput multiplier
    wclass: str = ""              # worker-class name ("" = homogeneous);
    # per-model latency scales live in Simulator._class_tier, keyed by it


@dataclasses.dataclass
class SimConfig:
    seed: int = 0
    straggler_sigma: float = 0.06      # lognormal execution jitter
    straggler_prob: float = 0.01       # prob of a 3-8x straggler batch
    model_load_s: float = 2.0          # role-switch (model load) delay
    router: str = "discriminator"      # quality-model router skill
    quality_window_s: float = 30.0
    failure_times: Tuple[Tuple[float, int, float], ...] = ()
    #   (t_fail, worker_id, repair_duration_s)
    hedging: bool = True
    scale_events: Tuple[Tuple[float, int], ...] = ()   # (t, new_S) elastic
    arrival_stage: int = 0            # Clipper-Heavy sends straight to -1
    # static baselines: never re-plan (wrapped as a FixedPlanPolicy when
    # the simulator builds its default control plane)
    fixed_plan: Optional[AllocationPlan] = None


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


def _per_boundary_fn(fn: Optional[Callable]) -> Optional[Callable]:
    """Wrap a confidence callable so it is always called as f(n, boundary);
    a legacy single-argument f(n) is applied to every boundary."""
    if fn is None:
        return None
    try:
        nargs = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        nargs = 1
    if nargs >= 2:
        return fn
    return lambda n, boundary: fn(n)


class Simulator:
    ARRIVAL, BATCH_DONE, CONTROL, FAIL, RECOVER, SCALE = range(6)

    def __init__(self, serving: ServingConfig, profile, sim:
                 Optional[SimConfig] = None,
                 allocator_options: Optional[AllocatorOptions] = None,
                 confidence_fn: Optional[Callable] = None,
                 quality_model: Optional[QualityModel] = None,
                 control: Optional[ControlPlane] = None):
        self.serving = serving
        self.spec = as_cascade_spec(serving.cascade)
        self.cascade = self.spec            # legacy alias
        self.num_tiers = self.spec.num_tiers
        self.sim = sim or SimConfig()
        self.rng = np.random.default_rng(self.sim.seed)
        self.profiles = as_boundary_profiles(profile,
                                             self.spec.num_boundaries)
        if control is None:
            # default bundle: serving.estimator + solver re-planning (or
            # sim.fixed_plan frozen) + plan-thresholds + heartbeat faults.
            # Shares self.profiles so online f(t) refreshes reach the
            # planner.
            control = build_control_plane(
                self.spec, serving, self.profiles,
                allocator_options=allocator_options,
                fixed_plan=self.sim.fixed_plan)
        elif allocator_options is not None:
            raise ValueError(
                "allocator_options is consumed when the Simulator builds "
                "its default ControlPlane; with an explicit `control` it "
                "would be silently ignored — bake the options into the "
                "control plane's planner instead")
        self.control = control
        self.confidence_fn = _per_boundary_fn(confidence_fn)
        # a caller-supplied quality model is pinned; the default follows
        # the active cascade across mid-run switches
        self._default_quality = quality_model is None
        self.quality = quality_model or QualityModel.from_cascade(self.spec)

        self.workers: Dict[int, Worker] = {}
        if serving.worker_classes:
            wid = 0
            for wc in serving.worker_classes:
                for _ in range(wc.count):
                    self.workers[wid] = Worker(wid=wid, speed=wc.speed,
                                               wclass=wc.name)
                    wid += 1
        else:
            self.workers = {i: Worker(wid=i)
                            for i in range(serving.num_workers)}
        self.thresholds: Tuple[float, ...] = (0.8,) * self.spec.num_boundaries
        self.now = 0.0
        self._events: List[Tuple[float, int, int, object]] = []
        self._eid = itertools.count()
        self.result = SimResult(
            completed_per_tier=[0] * self.num_tiers,
            tier_processed=[0] * self.num_tiers,
            deferred_per_boundary=[0] * self.spec.num_boundaries,
            workers_by_class={wc.name: wc.count
                              for wc in serving.worker_classes})
        self._arrivals_window: deque = deque()
        self._recent_defer: deque = deque()
        self._window_done = 0
        self._active_S = serving.num_workers
        # overload hardening: the control plane owns the admission
        # policy; the backend consults it per arrival (getattr keeps
        # minimal ControlPlane stand-ins working)
        self.admission = getattr(self.control, "admission", None) \
            or AcceptAllAdmission()
        # incrementally maintained per-tier queued-query depths (the
        # admission hot path must not scan all workers per arrival)
        self._depth: List[int] = [0] * self.num_tiers
        # vectorized arrival stream (run()): a sorted timestamp array +
        # cursor replaces one heap event per arrival, and Query objects
        # materialize only *after* admission — the difference between
        # sustaining 100x overload and melting in it
        self._arrival_times: np.ndarray = np.empty(0)
        self._arrival_i: int = 0
        self._slo0: float = self.spec.slo_s
        # per-tier warm-pool targets (autoscaler prewarm): () disables
        self._warm_targets: Tuple[int, ...] = ()
        # per-(class, tier) scaled latency — (profile, disc seconds),
        # constant for the whole run: the routing / predictive-drop hot
        # paths evaluate it per live worker per query, so they must not
        # rebuild LatencyScale/LatencyProfile objects every call
        self._class_tier: Dict[Tuple[str, int],
                               Tuple[LatencyProfile, float]] = {}
        self._build_class_tier()

    def _build_class_tier(self):
        """(Re)build the per-(class, tier) scaled-latency cache for the
        active cascade (constant between cascade switches)."""
        self._class_tier = {}
        for role, tier in enumerate(self.spec.tiers):
            disc = tier.disc_latency_s if role < self.num_tiers - 1 else 0.0
            for wc in self.serving.worker_classes:
                self._class_tier[(wc.name, role)] = (
                    wc.tier_profile(tier),
                    disc * wc.scale_for(tier.model).base)
            self._class_tier[("", role)] = (tier.profile, disc)

    @property
    def profile(self) -> DeferralProfile:
        return self.profiles[0]

    @property
    def threshold(self) -> float:
        return self.thresholds[0] if self.thresholds else 1.0

    @property
    def rm(self) -> Optional[ResourceManager]:
        """The control plane's solver wrapper (None for fixed-plan
        bundles) — legacy accessor."""
        return self.control.rm

    # ------------------------------------------------------------------
    def push(self, t, kind, payload=None):
        heapq.heappush(self._events, (t, kind, next(self._eid), payload))

    def run(self, trace: Trace) -> SimResult:
        # arrivals stay a sorted numpy array consumed by a cursor in
        # _run_until (merged with the heap, same event order as when
        # each arrival was its own heap entry) — heap churn and Query
        # construction for queries the admission policy sheds would
        # dominate the 100x-overload hot path
        self._arrival_times = np.asarray(trace.arrivals(self.rng),
                                         dtype=float)
        self._arrival_i = 0
        self._slo0 = self.spec.slo_s
        self.result.total += len(self._arrival_times)
        self.push(0.0, self.CONTROL)
        for (tf, wid, dur) in self.sim.failure_times:
            self.push(tf, self.FAIL, (wid, dur))
        for (ts, new_s) in self.sim.scale_events:
            self.push(ts, self.SCALE, new_s)
        end_t = trace.duration_s + 4 * self.spec.slo_s
        self.result.capacity_timeline.append((0.0, self._active_S))

        # initial plan
        self._apply_plan_now(first=True)

        self._run_until(end_t)
        self._drain_unfinished()
        if self.serving.worker_classes:
            census = {wc.name: 0 for wc in self.serving.worker_classes}
            for w in self.workers.values():
                if w.alive and w.wid < self._active_S and w.wclass:
                    census[w.wclass] = census.get(w.wclass, 0) + 1
            self.result.workers_by_class = census
        return self.result

    def _run_until(self, end_t: float):
        """Pump the merged event stream — the sorted arrival array and
        the heap — up to ``end_t`` (also used by serving.faults.resume
        after a snapshot restore). Ordering matches the legacy
        one-heap-entry-per-arrival pump exactly: ARRIVAL is kind 0, so
        at equal timestamps an arrival precedes every other event kind,
        and equal-time arrivals retain submission (array) order."""
        INF = math.inf
        events = self._events
        times = self._arrival_times
        i, n = self._arrival_i, len(self._arrival_times)
        result = self.result
        while True:
            arr_t = times[i] if i < n else INF
            heap_t = events[0][0] if events else INF
            take_arrival = arr_t < heap_t or (
                arr_t == heap_t and heap_t != INF
                and events[0][1] > self.ARRIVAL)
            t = float(arr_t) if take_arrival else heap_t
            if t > end_t or t == INF:
                break
            self.now = t
            result.events_processed += 1
            if take_arrival:
                self._on_arrival_time(t, i)
                i += 1
            else:
                _, kind, _, payload = heapq.heappop(events)
                self._dispatch(kind, payload)
        self._arrival_i = i

    def _dispatch(self, kind: int, payload):
        if kind == self.ARRIVAL:
            self._on_arrival(payload)
        elif kind == self.BATCH_DONE:
            self._on_batch_done(payload)
        elif kind == self.CONTROL:
            self._on_control()
        elif kind == self.FAIL:
            self._on_fail(*payload)
        elif kind == self.RECOVER:
            self._on_recover(payload)
        elif kind == self.SCALE:
            self._on_scale(payload)

    def _drain_unfinished(self):
        """End-of-run accounting: queries still queued or in flight when
        the simulation horizon closes count as dropped SLO violations, so
        completed + dropped == total always holds (conservation)."""
        seen = set()
        for w in self.workers.values():
            for q in list(w.queue) + list(w.in_flight):
                if (id(q) not in seen and q.done_at is None
                        and not q.dropped):
                    seen.add(id(q))
                    q.dropped = True
                    self.result.dropped_deadline += 1
                    self.result.violations += 1

    # ------------------------------------------------------------------
    def _live(self, role: Optional[int] = None):
        ws = [w for w in self.workers.values()
              if w.alive and w.wid < self._active_S
              and self.now >= w.loading_until]
        if role is not None:
            ws = [w for w in ws if w.role == role]
        return ws

    def _route(self, q: Query, tier: int,
               exclude: Optional[int] = None) -> bool:
        ws = [w for w in self._live(tier) if w.wid != exclude]
        if not ws:
            # no live worker of that tier: park on a loading one if any
            ws = [w for w in self.workers.values()
                  if w.alive and w.wid < self._active_S and w.role == tier
                  and w.wid != exclude]
        if not ws:
            return False
        # least expected drain time: weight the backlog by the class's
        # per-item cost at its configured batch size, so a class with a
        # steep marginal curve takes proportionally longer to clear
        w = min(ws, key=lambda w: (len(w.queue) + len(w.in_flight))
                * self._per_item_cost(w, tier))
        q.enqueued_at = self.now
        w.queue.append(q)
        self._depth[tier] += 1
        self._maybe_start(w)
        return True

    def _on_arrival(self, q: Query):
        """Heap-event arrival (the ``submit`` protocol path)."""
        self._arrivals_window.append(q.arrival)
        q.stage = self.sim.arrival_stage % self.num_tiers
        if not self.admission.admit(q.arrival, self._depth, q.stage):
            self.result.shed_admission += 1
            return
        if q.stage > 0:
            q.deferred = True
        if not self._route(q, q.stage):
            q.dropped = True
            self.result.dropped_deadline += 1
            self.result.violations += 1

    def _on_arrival_time(self, t: float, qid: int):
        """Array-stream arrival (the ``run`` hot path): admission runs
        on the bare timestamp, and the Query object only exists for
        admitted queries — a shed arrival costs a counter bump."""
        self._arrivals_window.append(t)
        stage = self.sim.arrival_stage % self.num_tiers
        if not self.admission.admit(t, self._depth, stage):
            self.result.shed_admission += 1
            return
        q = Query(qid=qid, arrival=t, deadline=t + self._slo0,
                  stage=stage, deferred=stage > 0)
        if not self._route(q, stage):
            q.dropped = True
            self.result.dropped_deadline += 1
            self.result.violations += 1

    def _profiled_latency(self, w: Worker, role: int, n: int) -> float:
        """Deterministic class-profiled batch latency (exec + this tier's
        discriminator, a fixed-cost run scaled like batch-1 work)."""
        cached = self._class_tier.get((w.wclass, role))
        if cached is not None:
            prof, disc = cached
            return prof.exec_latency(n) + disc
        # defensive fallback for a worker outside the cached class table
        tier = self.spec.tiers[role]
        base = tier.profile.exec_latency(n) / max(w.speed, 1e-9)
        if role < self.num_tiers - 1:
            base += tier.disc_latency_s / max(w.speed, 1e-9)
        return base

    def _per_item_cost(self, w: Worker, role: int) -> float:
        """Expected seconds per query at the worker's configured batch
        size (routing weight; reduces to 1/speed ordering when the class
        has no per-model overrides)."""
        b = max(w.batch_size, 1)
        return self._profiled_latency(w, role, b) / b

    def _exec_latency(self, w: Worker, n: int) -> float:
        base = self._profiled_latency(w, w.role, n)
        jit = float(self.rng.lognormal(0.0, self.sim.straggler_sigma))
        if self.rng.random() < self.sim.straggler_prob:
            jit *= float(self.rng.uniform(3.0, 8.0))
        return base * jit

    def _maybe_start(self, w: Worker):
        if (not w.alive or w.role is None or self.now < w.loading_until
                or self.now < w.busy_until or w.in_flight or not w.queue):
            return
        # predictive drop (paper: queries predicted to miss are dropped)
        # — deterministic expected latency: sampling _exec_latency here
        # would consume RNG per candidate and bake straggler jitter into
        # the deadline estimate; constant for the whole batch assembly
        est_done = math.inf
        if self.serving.drop_predicted_misses:
            est_done = self.now \
                + self._profiled_latency(w, w.role, w.batch_size) * 0.9
        batch: List[Query] = []
        while w.queue and len(batch) < w.batch_size:
            q = w.queue.popleft()
            self._depth[q.stage] -= 1
            if q.done_at is not None or q.dropped:
                continue           # hedged duplicate already finished
            if (self.serving.drop_predicted_misses and est_done > q.deadline
                    and q.stage == w.role):
                q.dropped = True
                self.result.dropped_predictive += 1
                self.result.violations += 1
                continue
            batch.append(q)
        if not batch:
            return
        w.in_flight = batch
        w.batch_role = w.role
        w.batch_started = self.now
        dur = self._exec_latency(w, len(batch))
        w.busy_until = self.now + dur
        self.push(w.busy_until, self.BATCH_DONE, w.wid)

    def _confidences(self, n: int, boundary: int) -> np.ndarray:
        if self.confidence_fn is not None:
            return self.confidence_fn(n, boundary)
        return self.profiles[boundary].sample(self.rng, n)

    def _on_batch_done(self, wid: int):
        w = self.workers[wid]
        if not w.alive:
            return
        batch, w.in_flight = w.in_flight, []
        if not batch:
            return
        if w.wclass:
            self.result.class_batch_latencies.setdefault(
                w.wclass, []).append((len(batch),
                                      self.now - w.batch_started))
        # score against the tier the batch *started* as: a control-tick
        # role reassignment mid-flight must not shift the batch to another
        # boundary's profile/threshold (or skip a tier entirely)
        tier = w.batch_role if w.batch_role is not None else w.role
        if tier is not None and tier < self.num_tiers - 1:
            boundary = tier
            confs = self._confidences(len(batch), boundary)
            fresh = []
            for q, c in zip(batch, confs):
                if q.done_at is not None or q.dropped:
                    continue       # hedged duplicate finished elsewhere
                q.confidence = float(c)
                self.result.tier_processed[tier] += 1
                if c < self.thresholds[boundary]:
                    q.stage = tier + 1
                    q.deferred = True
                    self.result.deferred_per_boundary[boundary] += 1
                    if not self._route(q, q.stage):
                        # no deeper capacity: return this tier's output
                        # (quality hit)
                        q.stage = tier
                        q.deferred = tier > 0
                        self.result.deferred_per_boundary[boundary] -= 1
                        self._complete(q)
                    fresh.append(c)
                else:
                    self._complete(q)
                    fresh.append(c)
            if fresh:
                self.profiles[boundary].update(fresh)  # online f(t) refresh
        else:
            for q in batch:
                if q.done_at is None and not q.dropped:
                    self.result.tier_processed[q.stage] += 1
                    self._complete(q)
        self._maybe_start(w)

    def _complete(self, q: Query):
        q.done_at = self.now
        self.result.completed += 1
        self.result.completed_per_tier[q.stage] += 1
        self.result.latencies.append(self.now - q.arrival)
        if self.now > q.deadline:
            self.result.violations += 1
        if q.deferred:
            self.result.deferred += 1
        depth = q.stage / max(self.num_tiers - 1, 1)
        self._recent_defer.append((self.now, depth))
        self._window_done += 1

    # ---------------- ExecutorBackend protocol ------------------------
    def submit(self, queries: Iterable[Query]) -> None:
        """Enqueue queries as arrival events (counted into the total)."""
        for q in queries:
            self.result.total += 1
            self.push(q.arrival, self.ARRIVAL, q)

    def poll(self) -> SimResult:
        """Progress snapshot: the live result counters."""
        return self.result

    def census(self) -> Census:
        live = [w for w in self.workers.values()
                if w.alive and w.wid < self._active_S]
        by_class: Dict[str, int] = {}
        for w in live:
            if w.wclass:
                by_class[w.wclass] = by_class.get(w.wclass, 0) + 1
        return Census(now=self.now, active_slots=self._active_S,
                      live_workers=len(live),
                      live_by_class=tuple(sorted(by_class.items())))

    def telemetry_window(self) -> Telemetry:
        queues = tuple(float(sum(len(w.queue) for w in self._live(i)))
                       for i in range(self.num_tiers))
        return windowed_telemetry(self.now, self.serving.control_period_s,
                                  self._arrivals_window, queues,
                                  self.profiles, self.thresholds,
                                  self.census(),
                                  drops=(self.result.shed_admission,
                                         self.result.dropped_predictive,
                                         self.result.dropped_deadline))

    def _apply_plan_now(self, first=False):
        """One control tick: the ControlPlane plans and calls back into
        ``apply_plan`` with the decision."""
        self.control.tick(self, first=first)

    def apply_plan(self, decision: ControlDecision):
        """Enact a control decision: switch the serving cascade when the
        planner chose a different one, record the decision, set live
        thresholds, and (re)assign worker roles/batches (stable matching;
        reassigned workers' orphaned queues re-route after all roles
        settle)."""
        plan = decision.plan
        switch_orphans: List[Query] = []
        new_spec = getattr(decision, "cascade", None)
        if new_spec is not None and new_spec != self.spec:
            switch_orphans = self._switch_cascade(
                new_spec, getattr(decision, "profiles", None))
        self.thresholds = tuple(decision.thresholds)
        self.result.record_decision(self.now, decision)
        live = [w for w in self.workers.values()
                if w.alive and w.wid < self._active_S]
        class_workers = getattr(plan, "class_workers", None)
        if class_workers is not None and self.serving.worker_classes:
            # heterogeneous plan: each worker class gets its own per-tier
            # role quota so slow hardware lands on the tiers the solver
            # picked for it
            extras = self._warm_extras([
                sum(alloc.values()) for alloc in class_workers])
            n_cls = len(self.serving.worker_classes)
            orphans: List[Query] = list(switch_orphans)
            for ci, wc in enumerate(self.serving.worker_classes):
                live_c = [w for w in live if w.wclass == wc.name]
                want_c: List[Optional[int]] = [
                    i for i, alloc in enumerate(class_workers)
                    for _ in range(alloc.get(wc.name, 0))]
                want_c += extras[ci::n_cls]
                orphans += self._assign_roles(live_c, want_c)
            self._settle_orphans(orphans)
        else:
            want: List[Optional[int]] = [
                i for i, n in enumerate(plan.workers) for _ in range(n)]
            want += self._warm_extras(plan.workers)
            self._settle_orphans(switch_orphans
                                 + self._assign_roles(live, want))
        for w in live:
            if w.role is not None:
                w.batch_size = plan.batches[w.role]
            self._maybe_start(w)

    def _switch_cascade(self, new_spec,
                        new_profiles=None) -> List[Query]:
        """Mid-run cascade switch (CascadeSearchPlanner decisions): remap
        tiers between the old and new cascade by model name — a tier
        whose model the new cascade still serves keeps its position (and
        its workers stay warm); a vanished model maps queries to the
        proportional depth and forces its workers through a model reload
        (role ``None`` -> the plan's assignment charges ``model_load_s``,
        so every *variant change* pays the load). Returns orphaned
        queued work for the caller to settle once the new plan's roles
        land. Conservation: every query is remapped exactly once (hedged
        duplicates share the object) and orphans re-route or drop
        through ``_settle_orphans``."""
        from repro_torch.serving.autocascade import (grow_tier_accounting,
                                                     tier_remap)
        old = self.spec
        new_n = new_spec.num_tiers
        remap, kept = tier_remap(old, new_spec)
        self.spec = new_spec
        self.cascade = new_spec
        self.num_tiers = new_n
        if new_profiles is not None:
            # adopt the planner's per-boundary profiles (shared objects:
            # online f(t) refreshes keep flowing into the search)
            self.profiles = as_boundary_profiles(new_profiles,
                                                 new_spec.num_boundaries)
        else:
            self.profiles = as_boundary_profiles(self.profiles,
                                                 new_spec.num_boundaries)
        if self._default_quality:
            self.quality = QualityModel.from_cascade(new_spec)
        self._build_class_tier()
        grow_tier_accounting(self.result, new_n)
        # remap every un-finished query exactly once (hedged duplicates
        # appear in two queues but share the Query object)
        seen = set()
        orphans: List[Query] = []
        for w in self.workers.values():
            for q in list(w.queue) + list(w.in_flight):
                if id(q) in seen:
                    continue
                seen.add(id(q))
                if q.done_at is None and not q.dropped:
                    q.stage = remap(q.stage)
            if w.batch_role is not None:
                w.batch_role = remap(w.batch_role)
            if w.role is not None:
                if kept(w.role):
                    w.role = remap(w.role)
                else:
                    # variant change: this worker must reload a model
                    orphans.extend(w.queue)
                    w.queue.clear()
                    w.role = None
        # tier indices (and the tier count) just changed wholesale:
        # rebuild the admission depth counters from the queues
        self._recount_depth()
        return orphans

    def _recount_depth(self):
        """Rebuild the per-tier queued-depth counters from scratch. The
        incremental bookkeeping can drift on hedged duplicates (the
        shared Query's stage advances while a stale copy is still
        queued), so congestion-aware runs re-true the counters each
        control tick — cheap there, because admission bounds the
        queues."""
        d = [0] * self.num_tiers
        for w in self.workers.values():
            for q in w.queue:
                if q.stage < self.num_tiers:
                    d[q.stage] += 1
        self._depth = d

    def _assign_roles(self, live: List[Worker],
                      want: List[Optional[int]]) -> List[Query]:
        """Stable role assignment: keep matching roles to avoid reload
        churn; every worker switching onto a role pays the model-load
        delay (including scale-up / freshly recovered workers starting
        from role None). Returns the reassigned workers' orphaned queued
        work for the caller to ``_settle_orphans`` once *every* role in
        the plan has settled — a heterogeneous plan assigns class by
        class, and an orphan's tier may belong to a class that has not
        been assigned yet."""
        want = list(want) + [None] * max(len(live) - len(want), 0)
        unassigned = []
        remaining = list(want)
        for w in live:
            if w.role in remaining:
                remaining.remove(w.role)
            else:
                unassigned.append(w)
        orphans: List[Query] = []
        for w, role in zip(unassigned, remaining):
            if role is not None and w.role != role:
                w.loading_until = self.now + self.sim.model_load_s
            if w.role is not None and w.role != role and w.queue:
                orphans.extend(w.queue)
                for q in w.queue:
                    self._depth[q.stage] -= 1
                w.queue.clear()
            w.role = role
        return orphans

    def _settle_orphans(self, orphans: List[Query]):
        """Re-route work orphaned by role reassignment — or drop it as an
        SLO violation when no worker of its tier remains, preserving
        completed + dropped == total. Runs after all roles settle, so an
        orphan cannot be parked back on its old worker's now-reassigned
        queue (and cross-class tier moves re-route instead of dropping)."""
        for q in orphans:
            if q.done_at is not None or q.dropped:
                continue           # hedged duplicate already finished
            if not self._route(q, q.stage):
                q.dropped = True
                self.result.dropped_deadline += 1
                self.result.violations += 1

    def _on_control(self):
        if self.admission.needs_telemetry:
            self._recount_depth()
        if self.now > 0:
            self._apply_plan_now()     # tick: fault sweep + plan + apply
        else:
            # t=0 tick plans nothing (the initial plan ran before the
            # event pump) but still sweeps heartbeats, as before
            self.detect_faults()
        self._record_quality()
        if self.sim.hedging:
            self._hedge_stragglers()
        self.push(self.now + self.serving.control_period_s, self.CONTROL)

    def _record_quality(self):
        horizon = self.now - self.sim.quality_window_s
        while self._recent_defer and self._recent_defer[0][0] < horizon:
            self._recent_defer.popleft()
        if self._recent_defer:
            # p = mean normalized cascade depth of recent completions
            # (== the deferred fraction for a two-tier cascade)
            p = float(np.mean([d for _, d in self._recent_defer]))
            fid = self.quality.fid(p, self.sim.router)
            self.result.fid_timeline.append((self.now, fid))
        done_total = max(self.result.completed + self.result.dropped, 1)
        self.result.violation_timeline.append(
            (self.now, self.result.violations / max(done_total, 1)))

    def _hedge_stragglers(self):
        """Straggler mitigation: if a batch runs far past its expected
        (class-profiled) latency, re-dispatch its queries to the
        least-loaded *peer* — never back onto the straggler itself, which
        would double its queue instead of mitigating."""
        for w in list(self.workers.values()):
            if not w.alive or not w.in_flight:
                continue
            role = w.batch_role if w.batch_role is not None else w.role
            if role is None:
                continue
            expect = self._profiled_latency(w, role, len(w.in_flight))
            if (self.now - w.batch_started) > 2.5 * expect:
                for q in w.in_flight:
                    if not q.hedged and q.done_at is None and \
                            self._route(q, q.stage, exclude=w.wid):
                        q.hedged = True     # duplicate dispatched to a peer
                        self.result.hedged += 1

    # ------------------------------------------------------------------
    def _on_fail(self, wid: int, repair_s: float):
        w = self.workers[wid]
        w.alive = False
        self.push(self.now + repair_s, self.RECOVER, wid)

    def _detect_and_requeue(self, w: Worker):
        lost = list(w.queue) + list(w.in_flight)
        for q in w.queue:
            self._depth[q.stage] -= 1
        w.queue.clear()
        w.in_flight = []
        for q in lost:
            if q.done_at is None and not q.dropped:
                self.result.requeued_on_failure += 1
                if not self._route(q, q.stage):
                    q.dropped = True
                    self.result.dropped_deadline += 1
                    self.result.violations += 1

    def _on_recover(self, wid: int):
        w = self.workers[wid]
        w.alive = True
        w.role = None
        w.loading_until = self.now + self.sim.model_load_s
        if w.queue or w.in_flight:
            # failed and recovered within one control period: the
            # heartbeat requeue (which only fires while not alive) never
            # ran, so the stale queue/in-flight work would wedge the
            # worker forever (_maybe_start requires empty in_flight).
            # Release it now.
            self._detect_and_requeue(w)

    def _on_scale(self, new_s: int):
        self._active_S = new_s
        self.result.capacity_timeline.append((self.now, new_s))

    # ---------------- elastic provisioning (autoscaler) ----------------
    def _warm_extras(self, planned: List[int]) -> List[Optional[int]]:
        """Tier roles beyond the plan that keep warm-pool standbys loaded:
        the autoscaler's per-tier warm targets minus what the plan already
        assigns. Empty targets (every run without an autoscaler) extend
        nothing — the plan's `want` list is bit-identical to before."""
        if not self._warm_targets:
            return []
        return [i
                for i, tgt in enumerate(self._warm_targets)
                if i < self.num_tiers
                for _ in range(max(tgt - (planned[i]
                                          if i < len(planned) else 0), 0))]

    def prewarm(self, tier_counts: Tuple[int, ...]) -> None:
        """Autoscaler hook: desired per-tier worker totals *including*
        warm standbys. Enacted at the next ``apply_plan`` by extending
        the role-assignment want list, so a standby charges its
        ``model_load_s`` when it joins the pool — before the ramp that
        will need it — and then idles warm."""
        self._warm_targets = tuple(int(n) for n in tier_counts)

    def set_capacity(self, new_s: int) -> None:
        """Elastically resize the provisioned slot count mid-run.

        Growth past the existing worker inventory creates fresh workers
        (heterogeneous fleets cycle the declared class mix) that start
        role-less — their first role assignment charges ``model_load_s``
        exactly like a recovered worker. Shrinking re-routes the
        decommissioned workers' queued work (or drops it as SLO
        violations when no capacity remains — conservation holds either
        way); their in-flight batches run to completion, mirroring the
        cluster backend's staged decommission."""
        new_s = max(int(new_s), 0)
        if new_s == self._active_S:
            return
        if new_s > len(self.workers):
            mix = ([(wc.name, wc.speed)
                    for wc in self.serving.worker_classes
                    for _ in range(wc.count)]
                   or [("", 1.0)])
            for wid in range(len(self.workers), new_s):
                name, speed = mix[wid % len(mix)]
                self.workers[wid] = Worker(wid=wid, speed=speed,
                                           wclass=name)
        shrinking = new_s < self._active_S
        self._active_S = new_s
        self.result.capacity_timeline.append((self.now, new_s))
        if shrinking:
            orphans: List[Query] = []
            for w in self.workers.values():
                if w.wid >= new_s and w.queue:
                    orphans.extend(w.queue)
                    for q in w.queue:
                        self._depth[q.stage] -= 1
                    w.queue.clear()
            self._settle_orphans(orphans)

    # failure detection happens on control ticks via heartbeat timeout
    # (called by the control plane's ScalingPolicy at tick start)
    def detect_faults(self):
        for w in self.workers.values():
            if not w.alive and (w.queue or w.in_flight):
                self._detect_and_requeue(w)
