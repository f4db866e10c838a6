"""Cluster mode: DiffServe workers as slices of the CUDA devices.

Port of ``repro/serving/cluster.py``. ``measure_profile`` builds the
per-tier e(b) tables by timing the real cascade stages on the card (in
place of the paper's offline A100 profiling); ``measure_class_profiles``
does it once per distinct worker class so heterogeneous clusters plan
from measured per-class tables instead of the static GPU table.

``ClusterBackend`` implements the control plane's ``ExecutorBackend``
protocol (serving/controlplane.py) over a ``ClusterRuntime``: the same
``ControlPlane`` re-plans every control period from live telemetry,
while execution latencies are the measured wall times of the real stage
calls and confidences come from the real discriminator on the real tier
outputs. On one card every slice is ``cuda:0``: each batch runs alone on
the card and its wall is charged to its slice's virtual clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.base import (LatencyProfile, LatencyScale,
                                     ServingConfig, WorkerClass,
                                     as_cascade_spec)
from repro_torch.core.confidence import as_boundary_profiles
from repro_torch.core.milp import Telemetry
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.admission import (AcceptAllAdmission,
                                           AdmissionPolicy)
from repro_torch.serving.controlplane import (Census, ControlDecision,
                                              ControlPlane,
                                              windowed_telemetry)
from repro_torch.serving.simulator import Query, SimResult


@dataclasses.dataclass
class WorkerSlice:
    """A slice of the devices assigned to one cascade tier.

    ``alive`` is ground truth (fault injection flips it); the control
    plane only ever learns about it through the *heartbeat*: an alive
    slice beats every serve period, and ``ClusterBackend.detect_faults``
    quarantines slices whose last beat is stale (paper §3.3 failure
    handling)."""
    wid: int
    role: Optional[int] = None        # tier index; None while loading
    devices: tuple = ()
    class_name: str = ""              # hardware class ("" = homogeneous)
    speed: float = 1.0                # throughput multiplier vs reference
    # full class spec (per-model latency scales); None = homogeneous
    wc: Optional[WorkerClass] = None
    alive: bool = True
    last_heartbeat: float = 0.0

    def expected_latency(self, profile: LatencyProfile, batch: int,
                         model: str = "") -> float:
        """Class-adjusted expected execution latency for a batch (the
        measured reference profile through this slice's latency scales)."""
        if self.wc is not None:
            return self.wc.scale_for(model).apply(profile).exec_latency(batch)
        return profile.exec_latency(batch) / max(self.speed, 1e-9)


def _device_list(device: torch.device) -> List[torch.device]:
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _slice_devices(devs: Sequence[torch.device], wid: int,
                   tp: int) -> tuple:
    """Modular wrap: every slice gets exactly tp devices even when the
    window passes the end of the device list (on one H100 every slice is
    device 0)."""
    return tuple(devs[(wid * tp + j) % len(devs)] for j in range(tp))


def _on(devices: tuple):
    """Make the slice's first CUDA device current for the call."""
    if devices and devices[0].type == "cuda":
        return torch.cuda.device(devices[0])
    return contextlib.nullcontext()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device: torch.device, fn, *args):
    """(wall seconds, result) of one call, with the device drained on
    both sides."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return time.perf_counter() - t0, out


class ClusterRuntime:
    """Executes real batched cascade queries; measures execution
    profiles. The serving config's ``kernel_impl`` / ``batch_buckets``
    configure the cascade's hot path; ``num_workers``,
    ``worker_tp_size`` and ``worker_classes`` lay out the slices."""

    def __init__(self, cascade, serving: ServingConfig, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cascade = cascade
        self.serving = serving
        # duck-typed: tests drive the runtime with stub cascades that
        # only expose stage_fns()
        casc_dev = getattr(cascade, "device", None)
        if casc_dev is not None and casc_dev != self.device:
            raise ValueError(f"cascade lives on {casc_dev}, runtime on "
                             f"{self.device}")
        if hasattr(cascade, "configure_kernels"):
            cascade.configure_kernels(serving.kernel_impl,
                                      serving.batch_buckets)
        devs = _device_list(self.device)
        tp = max(serving.worker_tp_size, 1)
        # heterogeneous clusters: wid order follows the declared class
        # order, matching the simulator's worker numbering
        class_of: List[Optional[WorkerClass]] = []
        for wc in serving.worker_classes:
            class_of += [wc] * wc.count
        class_of += [None] * (serving.num_workers - len(class_of))
        self.slices: List[WorkerSlice] = [
            WorkerSlice(wid=i, devices=_slice_devices(devs, i, tp),
                        class_name=class_of[i].name if class_of[i] else "",
                        speed=class_of[i].speed if class_of[i] else 1.0,
                        wc=class_of[i])
            for i in range(serving.num_workers)]
        self.last_stage_times: List[List[Tuple[int, float]]] = []

    def class_devices(self, class_name: str) -> tuple:
        """Devices backing the first slice of a worker class (profile
        measurement runs there)."""
        for sl in self.slices:
            if sl.class_name == class_name:
                return sl.devices
        return ()

    def measure_profile(self, batches=(1, 2, 4), prompt_len: int = 8,
                        repeats: int = 2,
                        devices: tuple = ()) -> List[LatencyProfile]:
        """Time each real cascade stage -> per-tier LatencyProfile fits
        (tier order matches ``cascade.stages``); the best-of-``repeats``
        seconds per (tier, batch) stay in ``last_stage_times``.
        ``devices`` pins the measurement to a slice's hardware (per-class
        tables). Every (stage, batch) runs once untimed first (the kernel
        libraries are built and loaded at their first launch); a new
        batch shape during the timed repeats raises, since it would fold
        first-call time into service time."""
        stages = self.cascade.stage_fns()
        calls = [[(b, torch.zeros((b, prompt_len), dtype=torch.int64,
                                  device=self.device)) for b in batches]
                 for _ in stages]
        out = []
        with _on(devices):
            for (_, fn, params), row in zip(stages, calls):
                for _, toks in row:
                    fn(params, toks)
            _sync(self.device)
            pre = self.cascade.shape_counts()
            for (cfg, fn, params), row in zip(stages, calls):
                ts = []
                for b, toks in row:
                    best = min(_timed(self.device, fn, params, toks)[0]
                               for _ in range(repeats))
                    if self.cascade.shape_counts() != pre:
                        raise RuntimeError(
                            f"stage {getattr(cfg, 'name', cfg)} ran a new "
                            f"shape during timed repeats at batch {b}: the "
                            "e(b) profile would fold first-call time into "
                            "service time")
                    ts.append((b, best))
                out.append(ts)
        self.last_stage_times = out
        return [_fit(ts) for ts in out]

    def measure_class_profiles(self, batches=(1, 2, 4), prompt_len: int = 8,
                               repeats: int = 2
                               ) -> Dict[str, List[LatencyProfile]]:
        """Measured per-class e(b) tables: ``measure_profile`` once per
        distinct worker class present in ``slices``, on that class's
        devices. A declared class with no slice cannot be measured and
        falls back to its static latency scales over the spec's reference
        profiles (``wc.tier_profile``). Homogeneous clusters get a single
        ``""`` entry."""
        spec = as_cascade_spec(self.serving.cascade)
        if not self.serving.worker_classes:
            return {"": self.measure_profile(batches, prompt_len, repeats)}
        present = {sl.class_name for sl in self.slices}
        out: Dict[str, List[LatencyProfile]] = {}
        for wc in self.serving.worker_classes:
            if wc.name in present:
                out[wc.name] = self.measure_profile(
                    batches, prompt_len, repeats,
                    devices=self.class_devices(wc.name))
            else:
                out[wc.name] = [wc.tier_profile(t) for t in spec.tiers]
        return out

    def serve_batch(self, prompt_tokens, thresholds):
        return self.cascade.run_batch(prompt_tokens, thresholds)


def _fit(ts: List[Tuple[int, float]]) -> LatencyProfile:
    """e(b) = base + marginal * (b - 1) through the first and last point."""
    base = ts[0][1]
    if len(ts) > 1:
        marg = max((ts[-1][1] - base) / (ts[-1][0] - 1), 1e-4)
    else:
        marg = base * 0.5
    return LatencyProfile(base_s=base, marginal_s=marg)


def measured_worker_classes(serving: ServingConfig,
                            class_profiles: Dict[str, List[LatencyProfile]]
                            ) -> Tuple[WorkerClass, ...]:
    """Rewrite each worker class's per-model latency scales from measured
    per-class e(b) tables (``measure_class_profiles`` output), so the
    heterogeneous solver plans from measurements instead of the static
    GPU table. Scales are measured/reference ratios against the spec's
    tier profiles."""
    spec = as_cascade_spec(serving.cascade)
    out = []
    for wc in serving.worker_classes:
        profs = class_profiles[wc.name]
        overrides, seen = [], set()
        for tier, mp in zip(spec.tiers, profs):
            if tier.model in seen:
                continue
            seen.add(tier.model)
            overrides.append((tier.model, LatencyScale(
                base=max(mp.base_s, 1e-9) / max(tier.profile.base_s, 1e-9),
                marginal=max(mp.marginal_s, 1e-9)
                / max(tier.profile.marginal_s, 1e-9))))
        out.append(dataclasses.replace(wc, profiles=tuple(overrides)))
    return tuple(out)


# ---------------------------------------------------------------------------
# The cluster executor backend
# ---------------------------------------------------------------------------
class ClusterBackend:
    """``ExecutorBackend`` over a ``ClusterRuntime``.

    Virtual-clock executor over real execution: arrivals replay a trace
    in simulated time, but each batch actually runs the cascade stage on
    the device (its measured wall time is the batch's service time) and
    each boundary scores real outputs with the real discriminator.
    Per-tier FIFO queues feed the slices the current plan assigned to
    each tier; backlog left at a control-period boundary shows up in the
    telemetry the ControlPlane re-plans from. ``device`` must be the
    runtime's (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, runtime: ClusterRuntime, serving: ServingConfig,
                 profiles, *, seed: int = 0, prompt_len: int = 8,
                 model_load_s: float = 2.0, router: str = "discriminator",
                 arrival_stage: int = 0, quality_window_s: float = 30.0,
                 confidence_fn=None,
                 failure_times: Tuple[Tuple[float, int, float], ...] = (),
                 device: DeviceLike = None):
        # model_load_s matches SimConfig's default so cross-backend
        # comparisons charge role-switch reloads identically;
        # failure_times matches SimConfig's (t_fail, wid, repair_s) shape
        self.device = resolve_device(device)
        if self.device != runtime.device:
            raise ValueError(f"backend on {self.device}, runtime on "
                             f"{runtime.device}")
        self.runtime = runtime
        self.serving = serving
        self.router = router              # quality-model skill for FID*
        self.arrival_stage = arrival_stage   # Clipper-Heavy enters at -1
        self.quality_window_s = quality_window_s
        # query-agnostic bundles (Proteus) override the real
        # discriminator: f(n, boundary) -> confidences
        self.confidence_fn = confidence_fn
        self.spec = as_cascade_spec(serving.cascade)
        self.num_tiers = self.spec.num_tiers
        self.profiles = as_boundary_profiles(profiles,
                                             self.spec.num_boundaries)
        self.prompt_len = prompt_len
        self.model_load_s = model_load_s
        self.rng = np.random.default_rng(seed)
        self.now = 0.0
        self.thresholds: Tuple[float, ...] = \
            (0.8,) * self.spec.num_boundaries
        self.batches: Tuple[int, ...] = (1,) * self.num_tiers
        self.queues: List[deque] = [deque() for _ in range(self.num_tiers)]
        self.busy_until: Dict[int, float] = {sl.wid: 0.0
                                             for sl in runtime.slices}
        self._arrivals_window: deque = deque()
        self._recent_depth: deque = deque()
        # executable stages keyed by model name: a mid-run cascade switch
        # re-selects stages for the new spec's tiers (staged slice
        # reload); only models with a loaded stage are switchable
        stage_fns = runtime.cascade.stage_fns()
        self._stages_by_model = {t.model: stage_fns[i]
                                 for i, t in enumerate(self.spec.tiers)
                                 if i < len(stage_fns)}
        self._stage_fns = list(stage_fns)
        # (stage fn id, bucket) pairs already executed once: _run_stage
        # warms unseen shapes untimed so first launches never leak into
        # walls
        self._warmed: set = set()
        # failure domain: injected crash/repair events in virtual time;
        # quarantine is what detect_faults *discovered* via heartbeats
        self._fault_events: List[Tuple[float, str, int]] = sorted(
            [(t, "fail", wid) for (t, wid, _r) in failure_times]
            + [(t + r, "recover", wid) for (t, wid, r) in failure_times])
        self._quarantined: set = set()
        # staged decommission (autoscaler scale-down): a decommissioned
        # slice leaves the schedulable pool but its slot object stays in
        # runtime.slices (wids index that list), ready for re-activation
        # on a later scale-up; per-tier queues mean no work strands
        self._decommissioned: set = set()
        # per-tier warm-pool targets (autoscaler prewarm): () disables
        self._warm_targets: Tuple[int, ...] = ()
        # overload hardening: serve() adopts the control plane's policy;
        # direct submit() callers get the accept-all baseline
        self.admission: AdmissionPolicy = AcceptAllAdmission()
        # real discriminator confidences observed per boundary (only when
        # the real discriminator scored them) — the calibration corpus
        # ``fitted_quality_models`` fits
        self._conf_samples: List[List[float]] = [
            [] for _ in range(self.spec.num_boundaries)]
        # stage-granular micro-serving: the discriminator decouples from
        # the tier worker onto per-boundary disc queues drained by a
        # dedicated clock on the *cheapest* class present — tier slices
        # free up as soon as images exist, and routing decisions land at
        # disc-done time
        self.stage_mode = getattr(serving, "stage_graph", "off") \
            not in ("off", "", None)
        # (ready_t, batch, confs, wall_s) awaiting the boundary's disc
        self.disc_queues: List[deque] = [
            deque() for _ in range(self.spec.num_boundaries)]
        self._disc_busy: List[float] = [0.0] * self.spec.num_boundaries
        cheap = min(serving.worker_classes, key=lambda wc: wc.speed,
                    default=None)
        self._disc_speed = cheap.speed if cheap else 1.0
        self.disc_class = cheap.name if cheap else ""
        self.result = SimResult(
            completed_per_tier=[0] * self.num_tiers,
            tier_processed=[0] * self.num_tiers,
            deferred_per_boundary=[0] * self.spec.num_boundaries,
            workers_by_class={wc.name: wc.count
                              for wc in serving.worker_classes})
        # (t, per-tier workers, per-tier batches) of each applied plan —
        # the live re-planning record cluster mode demonstrates
        self.plan_timeline: List[Tuple[float, Tuple[int, ...],
                                       Tuple[int, ...]]] = []

    # ---------------- ExecutorBackend protocol ------------------------
    def _live_slices(self) -> List[WorkerSlice]:
        """Slices the control plane may plan over: everything not yet
        quarantined. A crashed-but-undetected slice still counts — the
        controller only knows what the heartbeat sweep has discovered."""
        return [sl for sl in self.runtime.slices
                if sl.wid not in self._quarantined
                and sl.wid not in self._decommissioned]

    def _schedulable(self, sl: WorkerSlice) -> bool:
        """Slices execution may land batches on (ground truth: a crashed
        slice runs nothing even before detection)."""
        return (sl.alive and sl.wid not in self._quarantined
                and sl.wid not in self._decommissioned)

    def census(self) -> Census:
        live = self._live_slices()
        by_class: Dict[str, int] = {}
        for sl in live:
            if sl.class_name:
                by_class[sl.class_name] = by_class.get(sl.class_name, 0) + 1
        active = len(self.runtime.slices) - len(self._decommissioned)
        return Census(now=self.now, active_slots=active,
                      live_workers=len(live),
                      live_by_class=tuple(sorted(by_class.items())))

    def telemetry_window(self) -> Telemetry:
        # queries parked at a boundary's disc queue still belong to the
        # emitting tier's backlog (they hold no downstream decision yet)
        disc_depth = [0.0] * self.num_tiers
        for b, dq in enumerate(self.disc_queues):
            disc_depth[b] += sum(len(entry[1]) for entry in dq)
        return windowed_telemetry(self.now, self.serving.control_period_s,
                                  self._arrivals_window,
                                  tuple(float(len(q)) + disc_depth[i]
                                        for i, q in enumerate(self.queues)),
                                  self.profiles, self.thresholds,
                                  self.census(),
                                  drops=(self.result.shed_admission,
                                         self.result.dropped_predictive,
                                         self.result.dropped_deadline))

    def detect_faults(self) -> None:
        """Heartbeat sweep (``HeartbeatScaling`` calls this at tick
        start): quarantine slices whose last beat is older than the
        heartbeat timeout — strip their role so no batch lands on them
        and the census excludes them (the next plan reallocates around
        the failure). Work queued at a tier the dead slice was the only
        server of is counted as requeued (it waits for the re-plan).
        A quarantined slice that heartbeats again (repair) rejoins with
        no role — the planner reassigns it, paying the model reload."""
        timeout = self.serving.heartbeat_timeout_s
        for sl in self.runtime.slices:
            stale = (self.now - sl.last_heartbeat) > timeout
            if sl.wid in self._quarantined:
                if not stale:          # fresh beats: repaired, rejoin
                    self._quarantined.discard(sl.wid)
                    sl.role = None
                continue
            if stale:
                self._quarantined.add(sl.wid)
                role, sl.role = sl.role, None
                if role is not None and not any(
                        o.role == role and self._schedulable(o)
                        for o in self.runtime.slices):
                    # its tier lost the last server: that backlog is
                    # displaced until the next plan restores capacity
                    self.result.requeued_on_failure += \
                        len(self.queues[role]) if role < len(self.queues) \
                        else 0

    def _advance_faults(self, now: float) -> None:
        """Apply injected crash/repair events up to ``now`` and beat the
        heartbeats of alive slices (called once per serve period)."""
        while self._fault_events and self._fault_events[0][0] <= now:
            _t, kind, wid = self._fault_events.pop(0)
            sl = self.runtime.slices[wid]
            if kind == "fail":
                sl.alive = False
            else:
                sl.alive = True
                sl.role = None         # model state lost; reload on assign
        for sl in self.runtime.slices:
            if sl.alive:
                sl.last_heartbeat = now

    def submit(self, queries: Sequence[Query]) -> None:
        adm = self.admission
        for q in queries:
            self.result.total += 1
            self._arrivals_window.append(q.arrival)
            q.stage = q.stage % self.num_tiers
            if not adm.admit(q.arrival,
                             [len(dq) for dq in self.queues], q.stage):
                self.result.shed_admission += 1
                continue
            q.enqueued_at = q.arrival
            self.queues[q.stage].append(q)

    def poll(self) -> SimResult:
        return self.result

    def apply_plan(self, decision: ControlDecision) -> None:
        plan = decision.plan
        new_spec = getattr(decision, "cascade", None)
        if new_spec is not None and new_spec != self.spec:
            self._switch_cascade(new_spec,
                                 getattr(decision, "profiles", None))
        self.thresholds = tuple(decision.thresholds)
        self.result.record_decision(self.now, decision)
        self.batches = tuple(plan.batches)
        live = self._live_slices()
        class_workers = getattr(plan, "class_workers", None)
        if class_workers is not None and self.serving.worker_classes:
            extras = self._warm_extras([
                sum(alloc.values()) for alloc in class_workers])
            n_cls = len(self.serving.worker_classes)
            for ci, wc in enumerate(self.serving.worker_classes):
                group = [sl for sl in live if sl.class_name == wc.name]
                want = [i for i, alloc in enumerate(class_workers)
                        for _ in range(alloc.get(wc.name, 0))]
                want += extras[ci::n_cls]
                self._assign_group(group, want)
        else:
            want = [i for i, n in enumerate(plan.workers)
                    for _ in range(n)]
            want += self._warm_extras(plan.workers)
            self._assign_group(live, want)
        self.plan_timeline.append((self.now, tuple(plan.workers),
                                   tuple(plan.batches)))

    def _switch_cascade(self, new_spec, new_profiles=None) -> None:
        """Mid-run cascade switch with a *staged* slice reload: a slice
        whose model the new cascade still serves keeps serving it at its
        new tier position (warm, no stall); a slice on a vanished model
        drops its role and pays ``model_load_s`` when the plan assigns
        one. Per-tier queues remap by model name; backlog on vanished
        models re-enters at the proportional depth. Every tier of the
        new cascade must have a loaded stage (``executable_models``)."""
        from repro_torch.serving.autocascade import (grow_tier_accounting,
                                                     tier_remap)
        missing = [t.model for t in new_spec.tiers
                   if t.model not in self._stages_by_model]
        if missing:
            raise ValueError(
                f"cannot switch to cascade {new_spec.name!r}: no loaded "
                f"stage for models {missing}; executable: "
                f"{sorted(self._stages_by_model)}")
        new_n = new_spec.num_tiers
        # scored-but-unrouted disc batches were judged against the old
        # boundary: route them now at their ready time, then rebuild the
        # disc queues at the new boundary count
        for b, dq in enumerate(self.disc_queues):
            while dq:
                ready_t, batch, confs, _w = dq.popleft()
                self._route_scored(b, batch, confs, ready_t)
        remap, kept = tier_remap(self.spec, new_spec)
        new_queues: List[deque] = [deque() for _ in range(new_n)]
        for i, q in enumerate(self.queues):
            for qq in q:
                qq.stage = remap(i)
                new_queues[qq.stage].append(qq)
        self.queues = new_queues
        for sl in self.runtime.slices:
            if sl.role is None:
                continue
            if kept(sl.role):
                sl.role = remap(sl.role)
            else:
                sl.role = None         # variant change: staged reload
        self.spec = new_spec
        self.num_tiers = new_n
        self.disc_queues = [deque() for _ in range(new_spec.num_boundaries)]
        self._disc_busy = [0.0] * new_spec.num_boundaries
        self._conf_samples = [
            (self._conf_samples[b] if b < len(self._conf_samples) else [])
            for b in range(new_spec.num_boundaries)]
        self._stage_fns = [self._stages_by_model[t.model]
                           for t in new_spec.tiers]
        if new_profiles is not None:
            self.profiles = as_boundary_profiles(new_profiles,
                                                 new_spec.num_boundaries)
        else:
            self.profiles = as_boundary_profiles(self.profiles,
                                                 new_spec.num_boundaries)
        grow_tier_accounting(self.result, new_n)

    @property
    def executable_models(self) -> Tuple[str, ...]:
        """Models with a loaded stage (switch candidates must stay within
        this pool)."""
        return tuple(sorted(self._stages_by_model))

    # ---------------- elastic provisioning (autoscaler) ----------------
    def _warm_extras(self, planned: List[int]) -> List[Optional[int]]:
        """Tier roles beyond the plan that keep warm-pool standbys
        loaded (mirrors the simulator backend; empty targets extend
        nothing, so runs without an autoscaler are untouched)."""
        if not self._warm_targets:
            return []
        return [i
                for i, tgt in enumerate(self._warm_targets)
                if i < self.num_tiers
                for _ in range(max(tgt - (planned[i]
                                          if i < len(planned) else 0), 0))]

    def prewarm(self, tier_counts: Tuple[int, ...]) -> None:
        """Autoscaler hook: desired per-tier slice totals *including*
        warm standbys, enacted at the next ``apply_plan`` by extending
        the role want list — the standby's ``model_load_s`` is charged
        to its virtual clock when it joins the pool, before the ramp."""
        self._warm_targets = tuple(int(n) for n in tier_counts)

    def set_capacity(self, new_s: int) -> None:
        """Staged slice provision/decommission mid-run.

        Scale-up re-activates decommissioned slices first (role ``None``
        — the next plan reassigns them, paying the model reload), then
        appends fresh slices with the modular device wrap and declared
        class mix of the initial fleet. Scale-down decommissions the
        highest-wid active slices: they leave the schedulable pool while
        every other slice keeps serving warm (staged, like the cascade
        switch's reload); their tier queues are shared, so no work
        strands."""
        new_s = max(int(new_s), 0)
        active = len(self.runtime.slices) - len(self._decommissioned)
        if new_s == active:
            return
        if new_s > active:
            grow = new_s - active
            for wid in sorted(self._decommissioned):
                if grow == 0:
                    break
                self._decommissioned.discard(wid)
                self.runtime.slices[wid].role = None
                grow -= 1
            if grow > 0:
                devs = _device_list(self.runtime.device)
                tp = max(self.serving.worker_tp_size, 1)
                mix = ([wc for wc in self.serving.worker_classes
                        for _ in range(wc.count)]
                       or [None])
                for _ in range(grow):
                    wid = len(self.runtime.slices)
                    wc = mix[wid % len(mix)]
                    sl = WorkerSlice(
                        wid=wid, devices=_slice_devices(devs, wid, tp),
                        class_name=wc.name if wc else "",
                        speed=wc.speed if wc else 1.0,
                        wc=wc, last_heartbeat=self.now)
                    self.runtime.slices.append(sl)
                    self.busy_until[wid] = self.now
        else:
            for sl in sorted(self.runtime.slices,
                             key=lambda s: -s.wid):
                if active <= new_s:
                    break
                if sl.wid in self._decommissioned:
                    continue
                self._decommissioned.add(sl.wid)
                sl.role = None
                active -= 1
        self.result.capacity_timeline.append(
            (self.now, len(self.runtime.slices)
             - len(self._decommissioned)))

    def _assign_group(self, group: List[WorkerSlice],
                      want: List[Optional[int]]) -> None:
        """Stable role matching (keep matching roles to avoid reload
        churn); a role switch charges ``model_load_s`` to the slice's
        virtual clock. Queues are per-tier, so reassignment strands no
        work."""
        want = list(want) + [None] * max(len(group) - len(want), 0)
        remaining = list(want)
        unassigned = []
        for sl in group:
            if sl.role in remaining:
                remaining.remove(sl.role)
            else:
                unassigned.append(sl)
        for sl, role in zip(unassigned, remaining):
            if role is not None and sl.role != role and self.model_load_s:
                self.busy_until[sl.wid] = (
                    max(self.busy_until[sl.wid], self.now)
                    + self.model_load_s)
            sl.role = role

    # ---------------- execution ---------------------------------------
    def _run_stage(self, sl: WorkerSlice, tier: int,
                   batch_n: int) -> Tuple[float, torch.Tensor]:
        """Really execute tier ``tier`` for a batch of ``batch_n`` on the
        slice's own devices (so per-class wall times match the per-class
        measured profiles the planner uses): returns (measured wall
        seconds, outputs). Each unseen (stage, bucket) runs once untimed
        first, so the timed call never runs a new shape."""
        cfg, fn, params = self._stage_fns[tier]
        toks = torch.zeros((batch_n, self.prompt_len), dtype=torch.int64,
                           device=self.runtime.device)
        with _on(sl.devices):
            bucket = batch_n
            if hasattr(self.runtime.cascade, "bucket_for"):
                bucket = self.runtime.cascade.bucket_for(batch_n)
            wkey = (id(fn), bucket)
            if wkey not in self._warmed:
                # the first call at this (stage, bucket) shape loads the
                # kernels and the libraries' plans; keep it out of the
                # measured wall so service times stay comparable to the
                # planner's steady-state e(b) profile
                fn(params, toks)
                _sync(self.runtime.device)
                self._warmed.add(wkey)
            return _timed(self.runtime.device, fn, params, toks)

    def _drain(self, t_end: float) -> None:
        """Run batches on every slice whose virtual clock is inside the
        period; deferred queries may hop tiers within the same period
        when downstream slices still have clock budget."""
        progress = True
        while progress:
            progress = False
            for tier in range(self.num_tiers):
                if not self.queues[tier]:
                    continue
                slices = sorted((sl for sl in self.runtime.slices
                                 if sl.role == tier
                                 and self._schedulable(sl)),
                                key=lambda sl: self.busy_until[sl.wid])
                for sl in slices:
                    if not self.queues[tier]:
                        break
                    if self.busy_until[sl.wid] >= t_end:
                        continue
                    if self._run_batch_on(sl, tier, t_end):
                        progress = True
            if self.stage_mode and self._drain_disc(t_end):
                progress = True

    def _run_batch_on(self, sl: WorkerSlice, tier: int,
                      t_end: float) -> bool:
        q = self.queues[tier]
        cap = max(self.batches[tier], 1)
        # take ready queries (arrived/deferred by t_end) without letting
        # a not-yet-ready head block them: deferrals from concurrent
        # slices land in non-monotonic enqueued_at order
        batch: List[Query] = []
        not_ready: List[Query] = []
        while q and len(batch) < cap:
            qq = q.popleft()
            (batch if qq.enqueued_at <= t_end else not_ready).append(qq)
        for qq in reversed(not_ready):
            q.appendleft(qq)
        if not batch:
            return False
        start = max(self.busy_until[sl.wid],
                    max(b.enqueued_at for b in batch))
        wall, imgs = self._run_stage(sl, tier, len(batch))
        done_t = start + wall
        self.busy_until[sl.wid] = done_t
        if sl.class_name:
            self.result.class_batch_latencies.setdefault(
                sl.class_name, []).append((len(batch), wall))
        if tier < self.num_tiers - 1:
            if self.confidence_fn is not None:
                confs = self.confidence_fn(len(batch), tier)
                disc_wall = self.spec.tiers[tier].disc_latency_s
            else:
                disc_wall, confs = _timed(self.runtime.device,
                                          self.runtime.cascade.confidence,
                                          imgs)
                self._conf_samples[tier].extend(float(c) for c in confs)
            if self.stage_mode:
                # disc stage decoupled: the tier slice is free at done_t;
                # the routing decision waits for the boundary's disc
                # clock (a cheap-class device pays the scoring time)
                self.disc_queues[tier].append(
                    (done_t, batch, confs, disc_wall))
            else:
                self._route_scored(tier, batch, confs, done_t)
        else:
            for qq in batch:
                self.result.tier_processed[tier] += 1
                self._complete(qq, done_t)
        return True

    def _route_scored(self, tier: int, batch: List[Query], confs,
                      done_t: float) -> None:
        """Apply the boundary's threshold to scored outputs: keep
        (complete at this tier) or defer to tier+1 at ``done_t``."""
        fresh = []
        for qq, c in zip(batch, confs):
            qq.confidence = float(c)
            self.result.tier_processed[tier] += 1
            if c < self.thresholds[tier]:
                qq.stage = tier + 1
                qq.deferred = True
                qq.enqueued_at = done_t
                self.result.deferred_per_boundary[tier] += 1
                self.queues[tier + 1].append(qq)
            else:
                self._complete(qq, done_t)
            fresh.append(float(c))
        if fresh:
            self.profiles[tier].update(fresh)   # online f(t) refresh

    def _drain_disc(self, t_end: float) -> bool:
        """Stage mode: drain per-boundary disc queues on the dedicated
        disc clock (scaled to the cheapest class's speed) — scored
        batches route at disc-done time, not tier-done time."""
        progress = False
        for b, dq in enumerate(self.disc_queues):
            while dq and dq[0][0] <= t_end and self._disc_busy[b] < t_end:
                ready_t, batch, confs, disc_wall = dq.popleft()
                start = max(self._disc_busy[b], ready_t)
                wall = disc_wall / max(self._disc_speed, 1e-9)
                done_t = start + wall
                self._disc_busy[b] = done_t
                self._route_scored(b, batch, confs, done_t)
                progress = True
        return progress

    def _complete(self, q: Query, done_t: float) -> None:
        q.done_at = done_t
        self.result.completed += 1
        self.result.completed_per_tier[q.stage] += 1
        self.result.latencies.append(done_t - q.arrival)
        if done_t > q.deadline:
            self.result.violations += 1
        if q.deferred:
            self.result.deferred += 1
        depth = q.stage / max(self.num_tiers - 1, 1)
        self._recent_depth.append((done_t, depth))

    # ---------------- the serve loop ----------------------------------
    def serve(self, control: ControlPlane, trace,
              quality_model=None) -> SimResult:
        """Replay ``trace`` under ``control``: one tick per control
        period, real execution in between — the full DiffServe loop
        (estimate → solve → thresholds → enact) against measured
        profiles."""
        from repro_torch.core.quality import QualityModel
        # a cascade-searching planner may only switch within the loaded
        # stage pool: drop unenactable candidates up front, so the search
        # can never commit a switch apply_plan would refuse mid-run
        restrict = getattr(control.planner, "restrict_to_models", None)
        if restrict is not None:
            restrict(self._stages_by_model)
        # adopt the control plane's admission policy for this run
        self.admission = getattr(control, "admission", None) \
            or AcceptAllAdmission()
        arrivals = trace.arrivals(self.rng)
        stage = self.arrival_stage % self.num_tiers
        pending = deque(
            Query(qid=i, arrival=float(t),
                  deadline=float(t) + self.spec.slo_s,
                  stage=stage, deferred=stage > 0)
            for i, t in enumerate(arrivals))
        self._advance_faults(0.0)
        self.result.capacity_timeline.append(
            (0.0, len(self.runtime.slices) - len(self._decommissioned)))
        control.tick(self, first=True)
        period = self.serving.control_period_s
        end_t = trace.duration_s + 4 * self.spec.slo_s
        t = 0.0
        while t < end_t:
            t_end = t + period
            batch = []
            while pending and pending[0].arrival < t_end:
                batch.append(pending.popleft())
            self.submit(batch)
            self.now = t_end
            self._advance_faults(t_end)
            self._prune_window()
            control.tick(self)
            self._drain(t_end)
            # the default quality model follows the *active* cascade
            # across mid-run switches; an explicit one stays pinned
            self._record_quality(
                quality_model or QualityModel.from_cascade(self.spec),
                t_end)
            t = t_end
            if (not pending and not any(self.queues)
                    and not any(self.disc_queues)):
                break
        # grace drain to exhaustion past the horizon (the simulator
        # backend drains its event queue the same way). Each pass opens
        # the window past every slice clock and every deferral time, so
        # backlogged-but-servable work always progresses (a batch wall
        # time above the control period must not read as a stall); only
        # queues whose tier no slice holds are left over, dropped as
        # violations
        t_grace = end_t
        while any(self.queues) or any(self.disc_queues):
            servable = any(
                q and any(sl.role == tier and self._schedulable(sl)
                          for sl in self.runtime.slices)
                for tier, q in enumerate(self.queues)) \
                or any(self.disc_queues)   # disc clocks always exist
            if not servable:
                break
            horizon = max(
                [max(self.busy_until.values(), default=t_grace)]
                + [qq.enqueued_at for q in self.queues for qq in q]
                + [entry[0] for dq in self.disc_queues for entry in dq]
                + list(self._disc_busy))
            t_grace = max(t_grace, horizon) + period
            before = self._progress_state()
            self._drain(t_grace)
            if self._progress_state() == before:
                break              # safety valve against unforeseen stalls
        leftovers = [qq for queue in self.queues for qq in queue]
        leftovers += [qq for dq in self.disc_queues
                      for entry in dq for qq in entry[1]]
        for q in leftovers:
            q.dropped = True
            self.result.dropped_deadline += 1
            self.result.violations += 1
        for queue in self.queues:
            queue.clear()
        for dq in self.disc_queues:
            dq.clear()
        return self.result

    def _progress_state(self):
        """Drain-progress fingerprint: completions, backlog size, and
        cascade depth all count (a pass that only defers queries deeper
        is progress — they complete on a later pass)."""
        return (self.result.completed,
                sum(len(q) for q in self.queues)
                + sum(len(e[1]) for dq in self.disc_queues for e in dq),
                sum(qq.stage for q in self.queues for qq in q))

    def fitted_quality_models(self):
        """Per-boundary ``BoundaryQualityModel``s fitted from this run's
        *real* discriminator confidences (``_conf_samples``), with the
        same FID-anchor scheme as ``autocascade.fit_boundary_models``, so
        a later run can plan from measured calibration instead of
        the synthetic stand-in. Boundaries the run never scored (e.g.
        everything kept at tier 0) fall back to the offline synthetic
        fit."""
        from repro_torch.core.quality import BoundaryQualityModel
        from repro_torch.serving.autocascade import fit_boundary_models
        spec = self.spec
        fids = spec.fid_per_tier or None
        fallback = fit_boundary_models(spec)
        out = []
        for b in range(spec.num_boundaries):
            if not self._conf_samples[b]:
                out.append(fallback[b])
                continue
            out.append(BoundaryQualityModel.fit(
                self._conf_samples[b],
                fid_keep=fids[b] if fids else spec.fid_all_light,
                fid_defer=fids[b + 1] if fids else spec.fid_all_heavy,
                fid_best_mix=spec.fid_best_mix,
                best_mix_defer_frac=spec.best_mix_defer_frac))
        return tuple(out)

    def _prune_window(self):
        """Bound the arrival window even when the planner never reads
        telemetry (fixed-plan bundles): one control period of history is
        all any consumer uses."""
        horizon = self.now - self.serving.control_period_s
        while self._arrivals_window and self._arrivals_window[0] < horizon:
            self._arrivals_window.popleft()

    def _record_quality(self, quality, t_end: float) -> None:
        horizon = t_end - self.quality_window_s
        while self._recent_depth and self._recent_depth[0][0] < horizon:
            self._recent_depth.popleft()
        if self._recent_depth:
            p = float(np.mean([d for _, d in self._recent_depth]))
            self.result.fid_timeline.append(
                (t_end, quality.fid(p, self.router)))
        done = max(self.result.completed + self.result.dropped, 1)
        self.result.violation_timeline.append(
            (t_end, self.result.violations / done))
