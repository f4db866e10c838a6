"""Disaggregated micro-serving (ROADMAP item 1): stage-granular queues,
continuous step batching, and confidence-based preemption.

The classic serving path routes whole queries between monolithic tier
workers: a query occupies one worker for an entire tier even though the
tier decomposes into text-encode → step-granular denoise → VAE-decode →
discriminator stages with wildly different compute profiles
(LegoDiffusion, PAPERS.md). This module splits each cascade tier into
independently queued, batched, placed, and scaled micro-stages:

  * ``StageSpec`` / ``StageGraph`` — the per-tier stage chains, each
    stage carrying its share of the tier's profiled latency. Registered
    graphs live in the ``TORCH_STAGES`` registry (the
    TORCH_ADMISSIONS/TORCH_SCALERS idiom): ``"off"`` (classic
    whole-tier path, the default), ``"whole-tier"`` (one stage per tier — the control graph the
    micro-serving benchmark compares against on the *same* engine), and
    ``"micro"`` (encode/denoise/decode/discriminate).
  * ``DenoiseQueue`` — step-granular denoise state supporting
    **continuous batching** (a query may join a running batch at step k
    whenever a slot frees — shapes bucket-match because a tier serves
    one resolution) and **confidence-based preemption** (when the
    discriminator stage already reports confidence above the boundary
    threshold mid-denoise, the query exits early to VAE-decode, freeing
    its slot — per-query step count becomes a second quality knob next
    to the cascade threshold, Argus-style).
  * ``StageGraphSimulator`` — a virtual-time ``ExecutorBackend``
    executing the stage graph under the same ``ControlPlane`` as the
    classic simulator, with per-stage conservation accounting
    (``stage_flow``) and ``SimResult.stage_timeline`` snapshots.
    End-of-horizon leftovers land in the ``dropped_stage`` bucket of
    the conservation identity.

The engine is deterministic (no straggler jitter, no hedging — service
times are the class-profiled latencies), so per-stage conservation is
exact and fuzzable. The solver side lives in ``core/milp.py``: plans
gain ``stage_workers`` (per-tier per-stage worker splits) via
``StageGraph.split_workers``, a waterfill on per-stage service demand.
When a tier's worker count is smaller than its stage count, the tier
degrades to *fused* execution — one worker runs a query's remaining
chain as a unit — so sparse allocations never strand a stage with no
server.

This module is jax-free: virtual-time control logic only. The cluster
backend's stage mode (discriminators decoupled onto their own queue and
device) lives in serving/cluster.py.

PyTorch-port copy of ``repro/serving/microserve.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``. Registries carry the port's own names,
apart from the JAX package's for the repo linter's index: the stage-
graph registry is ``TORCH_STAGES``.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config.base import ServingConfig, as_cascade_spec
from repro_torch.core.confidence import as_boundary_profiles
from repro_torch.core.quality import QualityModel
from repro_torch.serving.admission import AcceptAllAdmission
from repro_torch.serving.controlplane import (Census, ControlDecision,
                                              ControlPlane,
                                              build_control_plane,
                                              windowed_telemetry)
from repro_torch.serving.simulator import Query, SimConfig, SimResult
from repro_torch.serving.trace import Trace

STAGE_KINDS = ("serial", "denoise", "disc")


@dataclass(frozen=True)
class StageSpec:
    """One micro-stage of a tier's pipeline.

    ``share`` is the stage's fraction of the tier's profiled exec
    latency e(b); ``disc`` folds the tier's fixed-cost discriminator
    run into this stage (the whole-tier graph folds it into its single
    stage; the micro graph gives it a dedicated zero-share stage).
    ``steps`` quantizes a ``denoise`` stage into step-granular slots.
    """
    name: str
    kind: str = "serial"
    share: float = 1.0
    steps: int = 1
    disc: bool = False

    def __post_init__(self):
        if self.kind not in STAGE_KINDS:
            raise ValueError(f"stage kind must be one of {STAGE_KINDS}, "
                             f"got {self.kind!r}")
        if self.share < 0:
            raise ValueError(f"stage share must be >= 0, got {self.share}")
        if self.steps < 1:
            raise ValueError(f"stage steps must be >= 1, got {self.steps}")


@dataclass(frozen=True)
class StageGraph:
    """Per-tier stage chains plus the preemption knob. ``tiers[i]`` is
    tier i's ordered chain; serial+denoise shares must sum to 1 so the
    chain's total compute equals the tier's profiled latency."""
    name: str
    tiers: Tuple[Tuple[StageSpec, ...], ...]
    preempt_frac: float = 0.5

    def __post_init__(self):
        if not self.tiers or any(not chain for chain in self.tiers):
            raise ValueError(f"{self.name}: every tier needs >= 1 stage")
        if not 0 < self.preempt_frac <= 1:
            raise ValueError(f"preempt_frac must be in (0, 1], got "
                             f"{self.preempt_frac}")
        for i, chain in enumerate(self.tiers):
            total = sum(s.share for s in chain)
            if abs(total - 1.0) > 1e-9:
                raise ValueError(f"{self.name} tier {i}: stage shares sum "
                                 f"to {total}, expected 1.0")
            if sum(1 for s in chain if s.kind == "denoise") > 1:
                raise ValueError(f"{self.name} tier {i}: at most one "
                                 "denoise stage per tier")

    @property
    def num_tiers(self) -> int:
        return len(self.tiers)

    def denoise_index(self, tier: int) -> Optional[int]:
        for si, s in enumerate(self.tiers[tier]):
            if s.kind == "denoise":
                return si
        return None

    def split_workers(self, spec, batches, workers
                      ) -> Tuple[Tuple[int, ...], ...]:
        """Per-stage worker split of a tier-level allocation: waterfill
        each tier's workers over per-stage service demand (seconds of
        work per batch at the tier's planned batch size), maximizing the
        bottleneck stage's throughput. A tier with fewer workers than
        stages concentrates them on the heaviest stages; the engine
        runs such tiers fused."""
        spec = as_cascade_spec(spec)
        out = []
        for i, chain in enumerate(self.tiers):
            n = int(workers[i]) if i < len(workers) else 0
            b = int(batches[i]) if i < len(batches) else 1
            demands = [max(stage_latency(spec, i, s, b), 1e-9)
                       for s in chain]
            out.append(tuple(_waterfill(demands, n)))
        return tuple(out)


def _waterfill(demands: List[float], n: int) -> List[int]:
    """Greedy bottleneck waterfill: repeatedly grant a worker to the
    stage with the worst workers-per-demand ratio (ties: heavier demand
    first, then stage order). With n >= len(demands) every stage gets at
    least one worker before any gets two."""
    counts = [0] * len(demands)
    for _ in range(max(n, 0)):
        j = min(range(len(demands)),
                key=lambda i: (counts[i] / demands[i], -demands[i], i))
        counts[j] += 1
    return counts


def stage_latency(spec, tier: int, stage: StageSpec, batch: int) -> float:
    """Deterministic batch latency of one stage: its share of the tier's
    profiled exec latency, plus the tier's fixed-cost discriminator run
    when the stage carries it (matching Simulator._profiled_latency's
    per-batch disc convention)."""
    t = spec.tiers[tier]
    lat = stage.share * t.profile.exec_latency(batch)
    if stage.disc:
        lat += t.disc_latency_s
    return lat


def whole_tier_graph(spec) -> StageGraph:
    """One stage per tier — the classic execution shape on the stage
    engine (the control arm of the micro-serving benchmark)."""
    spec = as_cascade_spec(spec)
    tiers = tuple(
        (StageSpec("tier", "serial", 1.0,
                   disc=(i < spec.num_tiers - 1)),)
        for i in range(spec.num_tiers))
    return StageGraph("whole-tier", tiers)


# Compute shares of the diffusion pipeline's stages: text-encode and
# VAE-decode are a small, resolution-bound slice of a generation; the
# denoise loop dominates (LegoDiffusion's profiling motivates the split)
MICRO_SHARES: Tuple[Tuple[str, str, float], ...] = (
    ("encode", "serial", 0.05),
    ("denoise", "denoise", 0.80),
    ("decode", "serial", 0.15),
)


def micro_graph(spec, steps: int = 8,
                preempt_frac: float = 0.5) -> StageGraph:
    """encode → denoise (step-granular) → decode, plus a dedicated
    discriminator stage on non-final tiers."""
    spec = as_cascade_spec(spec)
    tiers = []
    for i in range(spec.num_tiers):
        chain = [StageSpec(name, kind, share,
                           steps=steps if kind == "denoise" else 1)
                 for name, kind, share in MICRO_SHARES]
        if i < spec.num_tiers - 1:
            chain.append(StageSpec("discriminate", "disc", 0.0, disc=True))
        tiers.append(tuple(chain))
    return StageGraph("micro", tuple(tiers), preempt_frac=preempt_frac)


# Registry: name -> factory(serving). "off" keeps the classic whole-tier
# serving path (bit-identical, golden-pinned); the others opt a run into
# the stage engine.
TORCH_STAGES = {
    "off": lambda serving: None,
    "whole-tier": lambda serving: whole_tier_graph(serving.cascade),
    "micro": lambda serving: micro_graph(
        serving.cascade,
        steps=serving.stage_denoise_steps,
        preempt_frac=serving.stage_preempt_frac),
}


def make_stage_graph(name: str, serving: ServingConfig
                     ) -> Optional[StageGraph]:
    try:
        factory = TORCH_STAGES[name]
    except KeyError:
        raise KeyError(f"unknown stage graph {name!r}; "
                       f"known {sorted(TORCH_STAGES)}") from None
    return factory(serving)


class DenoiseQueue:
    """Step-granular denoise state for one tier: a waiting line plus the
    join/advance mechanics each denoise worker's slot batch runs.

    Continuous batching: ``join`` tops a worker's slots from the waiting
    line at any step boundary, so a query enters a *running* batch at
    step k instead of waiting for the batch to finish (shapes
    bucket-match — a tier serves one resolution). Confidence-based
    preemption: ``advance`` exits an occupant early once the
    discriminator-reported confidence is already above the boundary
    threshold after at least ``ceil(steps * preempt_frac)`` steps — the
    query proceeds straight to decode and its slot frees for the next
    waiter.
    """

    def __init__(self, steps: int, preempt_frac: float, final: bool):
        self.steps = max(int(steps), 1)
        self.preempt_min = max(int(math.ceil(self.steps * preempt_frac)), 1)
        self.final = bool(final)
        self.waiting: deque = deque()
        self.joins_at_step = 0      # queries that joined a running batch

    def join(self, slots: List[Query], cap: int,
             admit: Optional[Callable[[Query], bool]] = None
             ) -> List[Query]:
        """Move waiting queries into free slots (up to ``cap`` total
        occupancy). ``admit`` may consume-and-reject a query (predictive
        drop). Returns the queries that joined."""
        joined: List[Query] = []
        mid_flight = any(q._steps_done > 0 for q in slots)
        while self.waiting and len(slots) + len(joined) < cap:
            q = self.waiting.popleft()
            if admit is not None and not admit(q):
                continue
            q._steps_done = 0
            if mid_flight:
                self.joins_at_step += 1
            joined.append(q)
        return joined

    def advance(self, slots: List[Query], threshold: float
                ) -> Tuple[List[Query], List[Query], List[Query]]:
        """One denoise step for every occupant. Returns ``(stay, done,
        preempted)``: ``done`` ran all steps; ``preempted`` exited early
        on confidence (never on the final tier — there is no boundary to
        be confident about)."""
        stay: List[Query] = []
        done: List[Query] = []
        preempted: List[Query] = []
        for q in slots:
            q._steps_done += 1
            if q._steps_done >= self.steps:
                done.append(q)
            elif (not self.final and q._steps_done >= self.preempt_min
                    and q.confidence is not None
                    and q.confidence >= threshold):
                q._preempted = True
                preempted.append(q)
            else:
                stay.append(q)
        return stay, done, preempted


class _StageWorker:
    """One stage server. Serial stages run whole batches; denoise
    workers hold slot batches advancing in step quanta; fused workers
    run a query's remaining chain as one unit."""
    __slots__ = ("wid", "tier", "si", "busy", "batch", "batch_si",
                 "batch_fused", "slots", "retired")

    def __init__(self, wid: int, tier: int, si: int):
        self.wid = wid
        self.tier = tier
        self.si = si
        self.busy = False
        self.batch: List[Query] = []
        self.batch_si = si
        self.batch_fused = False
        self.slots: List[Query] = []
        self.retired = False


class StageGraphSimulator:
    """Virtual-time stage-graph executor: an ``ExecutorBackend`` driven
    by the same ``ControlPlane`` as the classic ``Simulator``, but with
    per-(tier, stage) queues and worker pools instead of per-tier
    monoliths. Deterministic service times (no straggler jitter or
    hedging); failure/scale events are out of scope — faults belong to
    the classic path and the cluster backend."""

    ARRIVAL, STAGE_DONE, STEP_DONE, CONTROL = range(4)

    def __init__(self, serving: ServingConfig, profile,
                 graph: StageGraph, sim: Optional[SimConfig] = None,
                 confidence_fn: Optional[Callable] = None,
                 control: Optional[ControlPlane] = None):
        self.serving = serving
        self.spec = as_cascade_spec(serving.cascade)
        self.graph = graph
        self.num_tiers = self.spec.num_tiers
        if graph.num_tiers != self.num_tiers:
            raise ValueError(f"stage graph {graph.name!r} has "
                             f"{graph.num_tiers} tiers, cascade "
                             f"{self.spec.name!r} has {self.num_tiers}")
        self.sim = sim or SimConfig()
        self.rng = np.random.default_rng(self.sim.seed)
        self.profiles = as_boundary_profiles(profile,
                                             self.spec.num_boundaries)
        if control is None:
            control = build_control_plane(self.spec, serving, self.profiles,
                                          fixed_plan=self.sim.fixed_plan)
        self.control = control
        self.confidence_fn = confidence_fn
        self.quality = QualityModel.from_cascade(self.spec)
        self.thresholds: Tuple[float, ...] = \
            (0.8,) * self.spec.num_boundaries
        self.batches: Tuple[int, ...] = (1,) * self.num_tiers

        # per-(tier, stage) waiting lines; the denoise stage's deque is
        # its DenoiseQueue's waiting line (uniform enqueue path)
        self.denoise: Dict[int, DenoiseQueue] = {}
        self.queues: List[List[deque]] = []
        for i, chain in enumerate(graph.tiers):
            row = []
            for si, s in enumerate(chain):
                if s.kind == "denoise":
                    dq = DenoiseQueue(s.steps, graph.preempt_frac,
                                      final=(i == self.num_tiers - 1))
                    self.denoise[i] = dq
                    row.append(dq.waiting)
                else:
                    row.append(deque())
            self.queues.append(row)
        self.pools: Dict[Tuple[int, int], List[_StageWorker]] = {}
        self.fused: List[bool] = [False] * self.num_tiers
        self._tier_workers: Tuple[int, ...] = (0,) * self.num_tiers
        self._busy: set = set()
        self._wid = itertools.count()

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
        self._active_S = serving.num_workers
        self.admission = getattr(self.control, "admission", None) \
            or AcceptAllAdmission()
        self._depth: List[int] = [0] * self.num_tiers
        self._arrival_times: np.ndarray = np.empty(0)
        self._arrival_i = 0
        self._slo0 = self.spec.slo_s
        # per-stage flow accounting: entered == exited for every stage
        # after the end-of-run drain (the per-stage conservation fuzz)
        self.stage_entered: Dict[Tuple[int, int], int] = {}
        self.stage_exited: Dict[Tuple[int, int], int] = {}
        self.step_joins = 0          # continuous-batch joins (all tiers)
        # remaining-chain latency helpers for predictive drops:
        # (cumulative share from stage si, disc cost in the remainder)
        self._rem: List[List[Tuple[float, float]]] = []
        for i, chain in enumerate(graph.tiers):
            disc_s = self.spec.tiers[i].disc_latency_s \
                if i < self.num_tiers - 1 else 0.0
            row = []
            for si in range(len(chain)):
                share = sum(s.share for s in chain[si:])
                disc = disc_s if any(s.disc for s in chain[si:]) else 0.0
                row.append((share, disc))
            self._rem.append(row)

    # ------------------------------------------------------------------
    def push(self, t, kind, payload=None):
        heapq.heappush(self._events, (t, kind, next(self._eid), payload))

    def run(self, trace: Trace) -> SimResult:
        self._arrival_times = np.asarray(trace.arrivals(self.rng),
                                         dtype=float)
        self._arrival_i = 0
        self._slo0 = self.spec.slo_s
        self.result.total += len(self._arrival_times)
        self.push(0.0, self.CONTROL)
        end_t = trace.duration_s + 4 * self.spec.slo_s
        self.result.capacity_timeline.append((0.0, self._active_S))
        self.control.tick(self, first=True)
        self._run_until(end_t)
        self._drain_unfinished()
        return self.result

    def _run_until(self, end_t: float):
        """Merged arrival-array/heap pump (same ordering contract as
        Simulator._run_until: arrivals precede same-time heap events)."""
        INF = math.inf
        events = self._events
        times = self._arrival_times
        i, n = self._arrival_i, len(times)
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
        elif kind == self.STAGE_DONE:
            self._on_stage_done(payload)
        elif kind == self.STEP_DONE:
            self._on_step_done(payload)
        elif kind == self.CONTROL:
            self._on_control()

    def _drain_unfinished(self):
        """Horizon close: everything still queued in a stage or riding a
        slot/batch lands in the per-stage drop bucket, preserving the
        conservation identity (and per-stage entered == exited)."""
        for i, row in enumerate(self.queues):
            for si, queue in enumerate(row):
                while queue:
                    q = queue.popleft()
                    self._depth[i] -= 1
                    self._drop_stage(q, i, si)
        for w in list(self._busy):
            for q in list(w.batch) + list(w.slots):
                self._drop_stage(q, w.tier, w.batch_si)
            w.batch, w.slots = [], []

    def _drop_stage(self, q: Query, tier: int, si: int):
        if q.done_at is not None or q.dropped:
            return
        q.dropped = True
        self.result.dropped_stage += 1
        self.result.violations += 1
        self.stage_exited[(tier, si)] = \
            self.stage_exited.get((tier, si), 0) + 1

    # ---------------- arrivals / enqueue ------------------------------
    def _on_arrival(self, q: Query):
        """Heap-event arrival (the ``submit`` protocol path)."""
        self._arrivals_window.append(q.arrival)
        q.stage = self.sim.arrival_stage % self.num_tiers
        if not self.admission.admit(q.arrival, self._depth, q.stage):
            self.result.shed_admission += 1
            return
        if q.stage > 0:
            q.deferred = True
        self._enqueue(q, q.stage, 0)

    def _on_arrival_time(self, t: float, qid: int):
        self._arrivals_window.append(t)
        stage = self.sim.arrival_stage % self.num_tiers
        if not self.admission.admit(t, self._depth, stage):
            self.result.shed_admission += 1
            return
        q = Query(qid=qid, arrival=t, deadline=t + self._slo0,
                  stage=stage, deferred=stage > 0)
        self._enqueue(q, stage, 0)

    def _enqueue(self, q: Query, tier: int, si: int):
        q.enqueued_at = self.now
        self.queues[tier][si].append(q)
        self._depth[tier] += 1
        self.stage_entered[(tier, si)] = \
            self.stage_entered.get((tier, si), 0) + 1
        self._kick_tier(tier)

    # ---------------- execution ---------------------------------------
    def _est_done(self, tier: int, si: int) -> float:
        """Predictive-drop estimate: 0.9x the remaining chain's latency
        at the tier's planned batch (the classic engine's convention)."""
        if not self.serving.drop_predicted_misses:
            return -math.inf
        share, disc = self._rem[tier][si]
        b = self.batches[tier]
        lat = share * self.spec.tiers[tier].profile.exec_latency(b) + disc
        return self.now + 0.9 * lat

    def _pop_batch(self, tier: int, si: int, cap: int) -> List[Query]:
        queue = self.queues[tier][si]
        est = self._est_done(tier, si)
        batch: List[Query] = []
        while queue and len(batch) < cap:
            q = queue.popleft()
            self._depth[tier] -= 1
            if q.done_at is not None or q.dropped:
                continue
            if est > q.deadline:
                q.dropped = True
                self.result.dropped_predictive += 1
                self.result.violations += 1
                self.stage_exited[(tier, si)] = \
                    self.stage_exited.get((tier, si), 0) + 1
                continue
            batch.append(q)
        return batch

    def _kick_tier(self, tier: int):
        for (t, si), pool in self.pools.items():
            if t != tier:
                continue
            for w in pool:
                if not w.busy:
                    self._try_start(w)

    def _try_start(self, w: _StageWorker):
        if w.busy or w.retired:
            return
        chain = self.graph.tiers[w.tier]
        if self.fused[w.tier]:
            # earliest non-empty stage; run the remaining chain fused
            for si, queue in enumerate(self.queues[w.tier]):
                if not queue:
                    continue
                batch = self._pop_batch(w.tier, si, self.batches[w.tier])
                if batch:
                    self._start_fused(w, si, batch)
                    return
            return
        stage = chain[w.si]
        if stage.kind == "denoise":
            self._fill_denoise(w)
            if w.slots:
                self._schedule_step(w)
            return
        batch = self._pop_batch(w.tier, w.si, self.batches[w.tier])
        if not batch:
            return
        w.busy = True
        w.batch = batch
        w.batch_si = w.si
        w.batch_fused = False
        self._busy.add(w)
        lat = stage_latency(self.spec, w.tier, stage, len(batch))
        self.push(self.now + lat, self.STAGE_DONE, w)

    def _start_fused(self, w: _StageWorker, si: int, batch: List[Query]):
        w.busy = True
        w.batch = batch
        w.batch_si = si
        w.batch_fused = True
        self._busy.add(w)
        chain = self.graph.tiers[w.tier]
        lat = sum(stage_latency(self.spec, w.tier, s, len(batch))
                  for s in chain[si:])
        self.push(self.now + lat, self.STAGE_DONE, w)

    def _fill_denoise(self, w: _StageWorker):
        """Continuous batching: top the worker's slots from the waiting
        line. Joiners on non-final tiers get their discriminator
        confidence up front — that is what makes mid-denoise preemption
        decidable at step boundaries."""
        dq = self.denoise[w.tier]
        cap = self.batches[w.tier]
        tier, si = w.tier, w.si
        est = self._est_done(tier, si)

        def admit(q: Query) -> bool:
            self._depth[tier] -= 1
            if q.done_at is not None or q.dropped:
                return False
            if est > q.deadline:
                q.dropped = True
                self.result.dropped_predictive += 1
                self.result.violations += 1
                self.stage_exited[(tier, si)] = \
                    self.stage_exited.get((tier, si), 0) + 1
                return False
            return True

        joined = dq.join(w.slots, cap, admit)
        if joined and tier < self.num_tiers - 1:
            need = [q for q in joined if q.confidence is None]
            if need:
                confs = self._confidences(len(need), tier)
                for q, c in zip(need, confs):
                    q.confidence = float(c)
        w.slots.extend(joined)
        self.step_joins = self.denoise_joins()

    def denoise_joins(self) -> int:
        return sum(dq.joins_at_step for dq in self.denoise.values())

    def _schedule_step(self, w: _StageWorker):
        stage = self.graph.tiers[w.tier][w.si]
        w.busy = True
        w.batch_si = w.si
        w.batch_fused = False
        self._busy.add(w)
        lat = stage_latency(self.spec, w.tier, stage,
                            len(w.slots)) / stage.steps
        self.push(self.now + lat, self.STEP_DONE, w)

    def _on_step_done(self, w: _StageWorker):
        if not w.slots:
            self._idle(w)
            return
        dq = self.denoise[w.tier]
        boundary = w.tier if w.tier < self.num_tiers - 1 else None
        threshold = self.thresholds[boundary] if boundary is not None \
            else 1.0
        stay, done, preempted = dq.advance(w.slots, threshold)
        w.slots = stay
        if preempted:
            self.result.preempted_early += len(preempted)
        exits = done + preempted
        if exits:
            self.stage_exited[(w.tier, w.si)] = \
                self.stage_exited.get((w.tier, w.si), 0) + len(exits)
            self._advance_chain(exits, w.tier, w.si)
        if not w.retired:
            self._fill_denoise(w)
        if w.slots:
            self._schedule_step(w)
        else:
            self._idle(w)

    def _on_stage_done(self, w: _StageWorker):
        batch, w.batch = w.batch, []
        si = w.batch_si
        live = [q for q in batch
                if q.done_at is None and not q.dropped]
        self.stage_exited[(w.tier, si)] = \
            self.stage_exited.get((w.tier, si), 0) + len(batch)
        if w.batch_fused:
            self._finish_tier(live, w.tier)
        else:
            self._advance_chain(live, w.tier, si)
        self._idle(w)

    def _idle(self, w: _StageWorker):
        w.busy = False
        self._busy.discard(w)
        if w.retired:
            return
        self._try_start(w)

    def _advance_chain(self, qs: List[Query], tier: int, si_done: int):
        """Route queries leaving stage ``si_done``: the next stage's
        queue, skipping the discriminator for preempted queries (their
        confidence was already reported mid-denoise), or the tier exit."""
        chain = self.graph.tiers[tier]
        finish: List[Query] = []
        for q in qs:
            j = si_done + 1
            if (j < len(chain) and chain[j].kind == "disc"
                    and getattr(q, "_preempted", False)):
                j += 1
            if j >= len(chain):
                finish.append(q)
            else:
                self._enqueue(q, tier, j)
        if finish:
            self._finish_tier(finish, tier)

    def _confidences(self, n: int, boundary: int) -> np.ndarray:
        if self.confidence_fn is not None:
            return self.confidence_fn(n, boundary)
        return self.profiles[boundary].sample(self.rng, n)

    def _tier_live(self, tier: int) -> bool:
        return self._tier_workers[tier] > 0 if \
            tier < len(self._tier_workers) else False

    def _finish_tier(self, batch: List[Query], tier: int):
        """Tier exit — the scoring/defer point. Preempted queries keep
        this tier's output unconditionally (their confidence already
        cleared the threshold); others defer below it, unless no deeper
        tier has workers (then ship this tier's output — quality hit)."""
        if not batch:
            return
        if tier >= self.num_tiers - 1:
            for q in batch:
                self.result.tier_processed[tier] += 1
                self._complete(q)
            return
        boundary = tier
        need = [q for q in batch if q.confidence is None]
        if need:
            confs = self._confidences(len(need), boundary)
            for q, c in zip(need, confs):
                q.confidence = float(c)
        fresh = []
        for q in batch:
            self.result.tier_processed[tier] += 1
            fresh.append(q.confidence)
            if getattr(q, "_preempted", False):
                self._complete(q)
            elif q.confidence < self.thresholds[boundary]:
                if self._tier_live(tier + 1):
                    q.stage = tier + 1
                    q.deferred = True
                    self.result.deferred_per_boundary[boundary] += 1
                    self._enqueue(q, tier + 1, 0)
                else:
                    self._complete(q)
            else:
                self._complete(q)
        if fresh:
            self.profiles[boundary].update(fresh)   # online f(t) refresh

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

    # ---------------- control -----------------------------------------
    def _on_control(self):
        if self.now > 0:
            self.control.tick(self)
        else:
            self.detect_faults()
        self._record_quality()
        self.result.stage_timeline.append(
            (self.now, self._stage_snapshot()))
        self.push(self.now + self.serving.control_period_s, self.CONTROL)

    def _stage_snapshot(self) -> Tuple[Tuple[int, int, int, int], ...]:
        """(tier, stage, queued, in_service) per stage."""
        in_service: Dict[Tuple[int, int], int] = {}
        for w in self._busy:
            key = (w.tier, w.batch_si)
            in_service[key] = in_service.get(key, 0) \
                + len(w.batch) + len(w.slots)
        return tuple(
            (i, si, len(queue), in_service.get((i, si), 0))
            for i, row in enumerate(self.queues)
            for si, queue in enumerate(row))

    def stage_flow(self) -> Dict[Tuple[int, int], Tuple[int, int]]:
        """Per-stage (entered, exited) counters for conservation tests."""
        keys = set(self.stage_entered) | set(self.stage_exited)
        return {k: (self.stage_entered.get(k, 0),
                    self.stage_exited.get(k, 0)) for k in sorted(keys)}

    def _record_quality(self):
        horizon = self.now - self.sim.quality_window_s
        while self._recent_defer and self._recent_defer[0][0] < horizon:
            self._recent_defer.popleft()
        if self._recent_defer:
            p = float(np.mean([d for _, d in self._recent_defer]))
            fid = self.quality.fid(p, self.sim.router)
            self.result.fid_timeline.append((self.now, fid))
        done_total = max(self.result.completed + self.result.dropped, 1)
        self.result.violation_timeline.append(
            (self.now, self.result.violations / max(done_total, 1)))

    # ---------------- ExecutorBackend protocol ------------------------
    def submit(self, queries) -> None:
        for q in queries:
            self.result.total += 1
            self.push(q.arrival, self.ARRIVAL, q)

    def poll(self) -> SimResult:
        return self.result

    def detect_faults(self) -> None:
        """No failure domain: deterministic virtual-time workers."""

    def census(self) -> Census:
        by_class = tuple(sorted((wc.name, wc.count)
                                for wc in self.serving.worker_classes))
        return Census(now=self.now, active_slots=self._active_S,
                      live_workers=self._active_S,
                      live_by_class=by_class)

    def telemetry_window(self):
        queues = tuple(float(d) for d in self._depth)
        return windowed_telemetry(self.now, self.serving.control_period_s,
                                  self._arrivals_window, queues,
                                  self.profiles, self.thresholds,
                                  self.census(),
                                  drops=(self.result.shed_admission,
                                         self.result.dropped_predictive,
                                         self.result.dropped_deadline))

    def apply_plan(self, decision: ControlDecision) -> None:
        self.thresholds = tuple(decision.thresholds)
        self.result.record_decision(self.now, decision)
        plan = decision.plan
        n = self.num_tiers
        workers = tuple(int(plan.workers[i]) if i < len(plan.workers)
                        else 0 for i in range(n))
        batches = tuple(max(int(plan.batches[i]), 1)
                        if i < len(plan.batches) else 1 for i in range(n))
        self.batches = batches
        self._tier_workers = workers
        self._reconcile(workers, getattr(plan, "stage_workers", None))
        for tier in range(n):
            self._kick_tier(tier)

    def _reconcile(self, workers: Tuple[int, ...], stage_workers):
        """Retarget the per-stage pools: a tier with at least as many
        workers as stages runs staged (the plan's ``stage_workers``
        split when valid, else the graph's waterfill); a sparser tier
        runs fused. Busy workers leaving a pool retire after their
        in-flight batch — the work is never dropped mid-service."""
        targets: Dict[Tuple[int, int], int] = {}
        for i, chain in enumerate(self.graph.tiers):
            n = workers[i]
            if n >= len(chain):
                row = None
                if stage_workers is not None and i < len(stage_workers):
                    cand = tuple(int(c) for c in stage_workers[i])
                    if (len(cand) == len(chain) and sum(cand) == n
                            and min(cand) >= 1):
                        row = cand
                if row is None:
                    row = self.graph.split_workers(
                        self.spec, self.batches, workers)[i]
                self.fused[i] = False
                for si, c in enumerate(row):
                    targets[(i, si)] = c
            else:
                self.fused[i] = True
                if n > 0:
                    targets[(i, 0)] = n
        for key in list(self.pools):
            if key not in targets:
                for w in self.pools.pop(key):
                    w.retired = True
        for key, want in targets.items():
            pool = self.pools.setdefault(key, [])
            pool[:] = [w for w in pool if not w.retired]
            while len(pool) > want:
                idle = next((w for w in pool if not w.busy), None)
                w = idle if idle is not None else pool[-1]
                pool.remove(w)
                w.retired = True
            while len(pool) < want:
                w = _StageWorker(next(self._wid), key[0], key[1])
                pool.append(w)
