"""The port's cluster mode against the JAX package's: every test of
``tests/test_cluster.py`` on the port (slice layout, measured per-class
profiles, grace drain, staged cascade switch, the search restricted to
loaded stages, heartbeat fault handling, and the full control loop over
a toy cascade really executed on the CPU); the rule that ``_run_stage``
runs an unseen (stage, bucket) once untimed before it takes a wall; and
backend parity: the reference's and the port's ``ClusterBackend`` with
``_run_stage`` stubbed to one deterministic (wall, outputs) table and
the same seeded ``confidence_fn``, replaying one trace, give an equal
``SimResult`` and plan timeline, with only ``solve_ms`` (the solver's
own ``time.perf_counter`` wall) left out.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.milp as R_milp
import repro.serving.autocascade as R_auto
import repro.serving.baselines as R_base
import repro.serving.cluster as R_cluster
import repro.serving.controlplane as R_cp
import repro.serving.profiles as R_prof
import repro.serving.trace as R_trace
import repro_torch.core.milp as T_milp
import repro_torch.serving.autocascade as T_auto
import repro_torch.serving.baselines as T_base
import repro_torch.serving.cluster as T_cluster
import repro_torch.serving.controlplane as T_cp
import repro_torch.serving.profiles as T_prof
import repro_torch.serving.trace as T_trace
from repro_torch.config.base import (DiffusionConfig, LatencyProfile,
                                     LatencyScale, TierSpec, WorkerClass,
                                     as_cascade_spec)
from repro_torch.core.cascade import DiffusionCascade
from repro_torch.core.milp import AllocationPlan
from repro_torch.models.efficientnet import (DiscriminatorConfig,
                                             init_discriminator)
from repro_torch.models.unet import init_unet
from repro_torch.serving.autocascade import (CascadeSearchPlanner,
                                             subchain_specs)
from repro_torch.serving.baselines import make_profiles
from repro_torch.serving.cluster import (ClusterBackend, ClusterRuntime,
                                         measured_worker_classes)
from repro_torch.serving.controlplane import (ControlDecision, ControlPlane,
                                              EwmaEstimator, ExecutorBackend,
                                              build_control_plane)
from repro_torch.serving.profiles import CASCADES, default_serving
from repro_torch.serving.simulator import Query
from repro_torch.serving.trace import static_trace
from test_torch_control import plain
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")


def _rt(cascade, sv):
    return ClusterRuntime(cascade, sv, device="cpu")


def _backend(rt, sv, profiles, **kw):
    return ClusterBackend(rt, sv, profiles, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Device assignment
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp,workers", [(1, 3), (2, 3), (4, 5)])
def test_every_slice_gets_exactly_tp_devices(tp, workers):
    """A slice window that wraps past the end of the device list wraps
    modularly: every slice has exactly tp devices."""
    sv = default_serving("sdturbo", num_workers=workers)
    sv = dataclasses.replace(sv, worker_tp_size=tp)
    rt = _rt(object(), sv)      # cascade unused by __init__
    assert len(rt.slices) == workers
    for sl in rt.slices:
        assert sl.devices == (CPU,) * tp


def test_heterogeneous_slice_classes_follow_declaration_order():
    wcs = (WorkerClass("a", 2, 1.0), WorkerClass("b", 1, 0.5))
    sv = default_serving("sdturbo", worker_classes=wcs)
    rt = _rt(object(), sv)
    assert [sl.class_name for sl in rt.slices] == ["a", "a", "b"]
    assert [sl.speed for sl in rt.slices] == [1.0, 1.0, 0.5]
    assert rt.slices[2].wc == wcs[1]
    assert rt.class_devices("b") == rt.slices[2].devices
    assert rt.class_devices("missing") == ()


def test_runtime_rejects_a_cascade_on_another_device():
    class OnCuda:
        device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="cascade lives on"):
        _rt(OnCuda(), default_serving("sdturbo"))


# ---------------------------------------------------------------------------
# Measured per-class profiles
# ---------------------------------------------------------------------------
def test_measured_worker_classes_scales_are_ratios():
    wcs = (WorkerClass("fast", 1, 1.0), WorkerClass("slow", 1, 0.5))
    sv = default_serving("sdturbo", worker_classes=wcs)
    spec = as_cascade_spec(sv.cascade)
    ref = [t.profile for t in spec.tiers]
    measured = {
        "fast": [LatencyProfile(p.base_s * 1.5, p.marginal_s * 2.0)
                 for p in ref],
        "slow": [LatencyProfile(p.base_s * 3.0, p.marginal_s * 4.0)
                 for p in ref],
    }
    out = measured_worker_classes(sv, measured)
    by_name = {wc.name: wc for wc in out}
    for tier in spec.tiers:
        assert by_name["fast"].scale_for(tier.model).base == \
            pytest.approx(1.5)
        assert by_name["fast"].scale_for(tier.model).marginal == \
            pytest.approx(2.0)
        assert by_name["slow"].scale_for(tier.model).base == \
            pytest.approx(3.0)
    t0 = spec.tiers[0]
    assert by_name["slow"].tier_profile(t0).base_s == \
        pytest.approx(measured["slow"][0].base_s)
    # the same scales as the reference's on the same tables
    r_sv = R_prof.default_serving("sdturbo", worker_classes=tuple(
        R_cluster.WorkerClass(wc.name, wc.count, wc.speed) for wc in wcs))
    r_out = R_cluster.measured_worker_classes(r_sv, {
        k: [R_cluster.LatencyProfile(p.base_s, p.marginal_s) for p in v]
        for k, v in measured.items()})
    assert [(wc.name, [(m, (s.base, s.marginal)) for m, s in wc.profiles])
            for wc in out] == \
        [(wc.name, [(m, (s.base, s.marginal)) for m, s in wc.profiles])
         for wc in r_out]


def test_measured_worker_classes_dedups_repeated_models():
    prof = LatencyProfile(0.1, 0.01)
    tiers = (TierSpec(model="m", profile=prof),
             TierSpec(model="m", profile=prof),
             TierSpec(model="n", profile=prof))
    sv = default_serving("sdturbo", worker_classes=(WorkerClass("c", 1),))
    spec = dataclasses.replace(as_cascade_spec(sv.cascade), tiers=tiers,
                               fid_per_tier=(), easy_fractions=(0.3, 0.3))
    sv = dataclasses.replace(sv, cascade=spec)
    out = measured_worker_classes(
        sv, {"c": [LatencyProfile(0.2, 0.02)] * 3})
    assert [m for m, _ in out[0].profiles] == ["m", "n"]


def test_fallback_class_uses_static_scales():
    """A declared class with no slice present cannot be measured: its
    table falls back to wc.scale_for over the spec reference profiles."""
    wcs = (WorkerClass("real", 2, 1.0),
           WorkerClass("ghost", 1, 0.5,
                       profiles=(("*", LatencyScale(2.0, 2.0)),)))
    sv = default_serving("sdturbo", worker_classes=wcs)
    rt = _rt(object(), sv)
    rt.slices = [sl for sl in rt.slices if sl.class_name == "real"]
    spec = as_cascade_spec(sv.cascade)
    seen = []

    def stub(*a, **kw):
        seen.append(kw.get("devices"))
        return [dataclasses.replace(t.profile) for t in spec.tiers]
    rt.measure_profile = stub
    profs = rt.measure_class_profiles(batches=(1,))
    for i, t in enumerate(spec.tiers):
        assert profs["ghost"][i].base_s == \
            pytest.approx(t.profile.base_s * 2.0)
        assert profs["real"][i].base_s == pytest.approx(t.profile.base_s)
    assert seen == [(CPU,)]          # measured once, on the class's slice


class _StubCascade:
    """Minimal cascade for backend-mechanics tests (execution itself is
    stubbed)."""

    def __init__(self, n: int = 2):
        self.n = n

    def stage_fns(self):
        return [(None, None, None)] * self.n

    def confidence(self, imgs):
        return np.ones(len(imgs))


def _stub_stage(wall):
    return lambda sl, tier, n: (wall, np.zeros((n, 1, 1, 1)))


def test_grace_drain_completes_slow_batches():
    """Backlog whose batch wall time exceeds the control period still
    drains to completion after the trace ends: a busy slice is not an
    unroutable queue."""
    sv = default_serving("sdturbo", num_workers=2)
    rt = _rt(_StubCascade(), sv)
    profiles = make_profiles(sv, 0)
    plan = AllocationPlan(workers=(1, 1), batches=(1, 1),
                          thresholds=(0.5,), expected_latency=1.0,
                          feasible=True)
    control = build_control_plane(sv.cascade, sv, profiles,
                                  fixed_plan=plan)
    backend = _backend(rt, sv, profiles, seed=0, model_load_s=0.0,
                       confidence_fn=lambda n, b: np.ones(n))
    backend._run_stage = _stub_stage(6.0)
    r = backend.serve(control, static_trace(1.0, 10))
    assert r.total > 0
    assert r.completed + r.dropped == r.total
    assert r.dropped == 0
    assert r.completed == r.total
    assert max(backend.busy_until.values()) > 30.0   # grace path ran


# ---------------------------------------------------------------------------
# Mid-run cascade switch: staged slice reload
# ---------------------------------------------------------------------------
def test_cluster_switch_cascade_staged_reload():
    """sdxs3 -> its (sdxs, sdv1.5) sub-chain: slices whose model
    survives keep serving it warm at its new tier position; the
    sd-turbo slice reloads (model_load_s on its virtual clock); per-tier
    queues remap with no lost queries."""
    sv = default_serving("sdxs3", num_workers=3)
    rt = _rt(_StubCascade(3), sv)
    profiles = make_profiles(sv, 0)
    plan3 = AllocationPlan(workers=(1, 1, 1), batches=(1, 1, 1),
                           thresholds=(0.5, 0.5), expected_latency=1.0,
                           feasible=True)
    backend = _backend(rt, sv, profiles, seed=0)
    backend.apply_plan(ControlDecision(plan=plan3, thresholds=(0.5, 0.5)))
    assert sorted(sl.role for sl in rt.slices) == [0, 1, 2]
    by_role = {sl.role: sl for sl in rt.slices}
    busy0 = dict(backend.busy_until)
    backend.queues[1].append(Query(qid=0, arrival=0.0, deadline=9.0,
                                   stage=1))
    backend.queues[2].append(Query(qid=1, arrival=0.0, deadline=9.0,
                                   stage=2))

    sub = subchain_specs(sv.cascade)["sdxs3:sdxs+sdv1.5"]
    prof2 = make_profiles(dataclasses.replace(sv, cascade=sub), 0)
    plan2 = AllocationPlan(workers=(2, 1), batches=(1, 1),
                           thresholds=(0.5,), expected_latency=1.0,
                           feasible=True)
    backend.now = 4.0
    backend.apply_plan(ControlDecision(plan=plan2, thresholds=(0.5,),
                                       cascade=sub, profiles=prof2))
    assert backend.num_tiers == 2
    assert backend.thresholds == (0.5,)
    assert by_role[0].role == 0
    assert by_role[2].role == 1
    assert backend.busy_until[by_role[0].wid] == busy0[by_role[0].wid]
    assert backend.busy_until[by_role[2].wid] == busy0[by_role[2].wid]
    assert by_role[1].role == 0
    assert backend.busy_until[by_role[1].wid] == \
        max(busy0[by_role[1].wid], 4.0) + backend.model_load_s
    assert sum(len(q) for q in backend.queues) == 2
    assert len(backend.queues[1]) >= 1
    assert len(backend.result.completed_per_tier) == 3   # grow-only
    with pytest.raises(ValueError):
        backend._switch_cascade(CASCADES["sdxlltn"])


def test_cluster_serve_restricts_search_to_loaded_stages():
    """A cascade-searching planner driving the cluster backend loses the
    candidates whose models have no loaded stage before the first
    tick."""
    sv = default_serving("sdturbo", num_workers=2)
    rt = _rt(_StubCascade(), sv)      # stages: sd-turbo, sdv1.5
    profiles = make_profiles(sv, 0)
    cands = {n: CASCADES[n] for n in ("sdturbo", "sdxs", "sdxs3")}
    prof_by = {n: (profiles if n == "sdturbo" else
                   make_profiles(dataclasses.replace(sv, cascade=c), 0))
               for n, c in cands.items()}
    planner = CascadeSearchPlanner(sv, cands, prof_by, active="sdturbo")
    control = ControlPlane(estimator=EwmaEstimator(0.6), planner=planner)
    backend = _backend(rt, sv, profiles, seed=0, model_load_s=0.0,
                       confidence_fn=lambda n, b: np.ones(n))
    backend._run_stage = _stub_stage(0.05)
    r = backend.serve(control, static_trace(1.0, 10))
    assert set(planner.candidates) == {"sdturbo"}
    assert backend.executable_models == ("sd-turbo", "sdv1.5")
    assert r.completed + r.dropped == r.total


# ---------------------------------------------------------------------------
# Failure domain and elastic capacity
# ---------------------------------------------------------------------------
def test_cluster_heartbeat_fault_detection_and_recovery():
    """A crashed slice stops heartbeating, detect_faults quarantines it
    (the planner re-plans around the failure), and after repair it
    rejoins; accounting stays conserved."""
    sv = default_serving("sdturbo", num_workers=3)
    rt = _rt(_StubCascade(), sv)
    profiles = make_profiles(sv, 0)
    control = build_control_plane(sv.cascade, sv, profiles)
    backend = _backend(rt, sv, profiles, seed=0, model_load_s=0.0,
                       confidence_fn=lambda n, b: np.ones(n),
                       failure_times=((5.0, 0, 14.0),))
    backend._run_stage = _stub_stage(0.05)
    r = backend.serve(control, static_trace(2.0, 40))
    assert r.total > 0
    assert r.completed + r.dropped == r.total
    assert r.completed == r.total
    worker_sums = [sum(w) for _, w, _ in backend.plan_timeline]
    assert min(worker_sums) <= 2
    assert worker_sums[-1] == 3
    assert rt.slices[0].alive
    assert not backend._quarantined


def test_cluster_heartbeat_detection_without_repair():
    """A crash with no repair stays quarantined: census reports the
    shrunken fleet and the dead slice never executes again."""
    sv = default_serving("sdturbo", num_workers=2)
    rt = _rt(_StubCascade(), sv)
    profiles = make_profiles(sv, 0)
    control = build_control_plane(sv.cascade, sv, profiles)
    backend = _backend(rt, sv, profiles, seed=0, model_load_s=0.0,
                       confidence_fn=lambda n, b: np.ones(n),
                       failure_times=((4.0, 1, 1e9),))
    executed = []
    backend._run_stage = lambda sl, tier, n: (
        executed.append((backend.now, sl.wid)),
        (0.05, np.zeros((n, 1, 1, 1))))[1]
    r = backend.serve(control, static_trace(1.0, 30))
    assert r.completed + r.dropped == r.total
    assert 1 in backend._quarantined
    assert backend.census().live_workers == 1
    deadline = 4.0 + sv.heartbeat_timeout_s + 2 * sv.control_period_s
    assert all(wid != 1 for t, wid in executed if t > deadline)


def test_set_capacity_and_prewarm_match_the_reference():
    """Scale down (decommission the highest wids), scale up (re-activate
    first, then append slices with the class mix and the modular device
    wrap), and warm-pool standbys, enacted the same in both packages."""
    out = []
    for side in ("ref", "port"):
        prof, base, cl, milp = ((R_prof, R_base, R_cluster, R_milp)
                                if side == "ref" else
                                (T_prof, T_base, T_cluster, T_milp))
        wcs = prof.worker_classes_from_arg("a100:2:1.0,a10g:2:0.5")
        sv = prof.default_serving("sdturbo", worker_classes=wcs)
        rt = (cl.ClusterRuntime(_StubCascade(), sv) if side == "ref"
              else _rt(_StubCascade(), sv))
        kw = {} if side == "ref" else dict(device="cpu")
        be = cl.ClusterBackend(rt, sv, base.make_profiles(sv, 0), **kw)
        plan = milp.AllocationPlan(workers=(1, 1), batches=(1, 1),
                                   thresholds=(0.5,), expected_latency=1.0,
                                   feasible=True)
        dec = (R_cp if side == "ref" else T_cp).ControlDecision(
            plan=plan, thresholds=(0.5,))
        be.now = 2.0
        be.set_capacity(2)
        be.prewarm((2, 1))
        be.apply_plan(dec)
        be.now = 4.0
        be.set_capacity(6)
        be.apply_plan(dec)
        out.append(([(s.wid, s.role, s.class_name, s.speed, len(s.devices))
                     for s in rt.slices], sorted(be._decommissioned),
                    dict(be.busy_until), be.result.capacity_timeline,
                    be.census().active_slots, be.census().live_by_class))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# Backend parity with the reference
# ---------------------------------------------------------------------------
def _wall(sl, tier, n):
    """The deterministic stage table both backends replay: per-tier base
    and marginal seconds, scaled by the slice's class speed."""
    base = (0.03, 0.4, 1.1)[tier]
    marg = (0.004, 0.06, 0.25)[tier]
    return (base + marg * (n - 1)) / sl.speed


CASES = {
    "homogeneous": dict(cascade="sdturbo", workers=4, n_stages=2),
    "classes": dict(cascade="sdturbo", classes="a100:1:1.0,a10g:4:0.7",
                    n_stages=2, load=2.0),
    "failures": dict(cascade="sdturbo", workers=4, n_stages=2,
                     failure_times=((5.0, 0, 12.0), (14.0, 3, 1e9))),
    "cascade_switch": dict(cascade="sdxs3", workers=5, n_stages=3,
                           search=True),
}


def _run_side(side, case):
    prof, base, cl, cp, auto, trace = (
        (R_prof, R_base, R_cluster, R_cp, R_auto, R_trace) if side == "ref"
        else (T_prof, T_base, T_cluster, T_cp, T_auto, T_trace))
    kw = {}
    if "classes" in case:
        kw["worker_classes"] = prof.worker_classes_from_arg(case["classes"])
    sv = prof.default_serving(case["cascade"],
                              num_workers=case.get("workers", 0), **kw)
    profiles = base.make_profiles(sv, 0)
    if case.get("search"):
        cands = auto.default_candidates(sv.cascade)
        by = {n: (profiles if n == case["cascade"] else base.make_profiles(
            dataclasses.replace(sv, cascade=c), 0))
            for n, c in cands.items()}
        planner = auto.CascadeSearchPlanner(sv, cands, by,
                                            active=case["cascade"],
                                            min_dwell=2)
        control = cp.build_control_plane(sv.cascade, sv, profiles,
                                         planner=planner)
    else:
        control = cp.build_control_plane(sv.cascade, sv, profiles)
    stub = _StubCascade(case["n_stages"])
    if side == "ref":
        rt = cl.ClusterRuntime(stub, sv)
        extra = {}
    else:
        rt = _rt(stub, sv)
        extra = dict(device="cpu")
    rng = np.random.default_rng(17)
    backend = cl.ClusterBackend(
        rt, sv, profiles, seed=3,
        confidence_fn=lambda n, b: rng.random(n),
        failure_times=case.get("failure_times", ()), **extra)
    backend._run_stage = lambda sl, tier, n: (_wall(sl, tier, n),
                                              np.zeros((n, 1, 1, 1)))
    tr = trace.azure_like_trace(40, seed=2).scale(1, 8) \
        .scaled(case.get("load", 1.0))
    if case.get("search"):
        tr = trace.Trace(np.concatenate([tr.qps, tr.qps * 6]))
    r = backend.serve(control, tr)
    return r, backend


@pytest.mark.parametrize("case", list(CASES))
def test_backend_parity_with_the_reference(case):
    r_ref, b_ref = _run_side("ref", CASES[case])
    r_port, b_port = _run_side("port", CASES[case])
    assert b_port.plan_timeline == b_ref.plan_timeline
    assert plain(r_port) == plain(r_ref)
    # the case exercises what it names
    assert r_ref.total > 50 and r_ref.completed + r_ref.dropped \
        == r_ref.total
    assert len(b_ref.plan_timeline) >= 3
    if case == "classes":
        assert set(r_ref.class_batch_latencies) == {"a100", "a10g"}
    if case == "failures":
        assert min(sum(w) for _, w, _ in b_ref.plan_timeline) <= 3
    if case == "cascade_switch":
        assert r_ref.cascade_switches >= 1
        assert b_port.spec == T_prof.CASCADES["sdxs3"] \
            or b_port.spec.name != "sdxs3"


# ---------------------------------------------------------------------------
# ClusterBackend: the full control loop over real execution on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def toy_cascade():
    stages = []
    for i in range(2):
        cfg = DiffusionConfig(
            name=f"tiny-tier{i}", image_size=16, in_channels=3,
            base_channels=8, channel_mults=(1,), num_res_blocks=1,
            attn_resolutions=(), num_steps=1 + i, text_dim=16)
        stages.append((cfg, init_unet(cfg, seed=i, device="cpu")))
    dcfg = DiscriminatorConfig(in_channels=3,
                               stages=((16, 1, 1, 1), (24, 1, 2, 4)),
                               head_channels=32)
    return DiffusionCascade(stages, dcfg,
                            init_discriminator(dcfg, seed=2, device="cpu"),
                            kernel_impl="fused", batch_buckets=(1, 2, 4, 8),
                            device="cpu", seed=0)


def test_run_stage_warms_an_unseen_bucket_untimed(toy_cascade):
    """The first ``_run_stage`` at a fresh (stage, bucket) runs the
    stage once untimed, then times a second call: the timed call never
    runs a new shape."""
    sv = default_serving("sdturbo", num_workers=2, batch_choices=(1, 2),
                         kernel_impl="fused", batch_buckets=(1, 2, 4, 8))
    rt = _rt(toy_cascade, sv)
    rt.measure_profile(batches=(1, 2), repeats=1)
    backend = _backend(rt, sv, make_profiles(sv, 0), seed=0,
                       model_load_s=0.0)
    cfg, fn, params = backend._stage_fns[0]
    calls = []

    def counted(p, toks):
        calls.append((toks.shape[0], tuple(toy_cascade.shape_counts())))
        return fn(p, toks)
    backend._stage_fns[0] = (cfg, counted, params)
    sl = rt.slices[0]
    w1, imgs1 = backend._run_stage(sl, 0, 3)     # bucket 4: never run
    assert [n for n, _ in calls] == [3, 3]
    assert calls[1][1] == tuple(toy_cascade.shape_counts())
    w2, _ = backend._run_stage(sl, 0, 3)
    backend._run_stage(sl, 0, 4)                 # same bucket: no warm-up
    assert [n for n, _ in calls] == [3, 3, 3, 4]
    assert imgs1.shape == (3, 16, 16, 3) and w1 > 0 and w2 > 0


def test_cluster_backend_full_control_loop(toy_cascade):
    """Measured per-class profiles feed solve_heterogeneous_cascade
    re-planning across control ticks while the backend really executes
    every batch (plain versions on the CPU)."""
    wcs = (WorkerClass("fast", 2, 1.0), WorkerClass("slow", 2, 0.5))
    sv = default_serving("sdturbo", worker_classes=wcs,
                         batch_choices=(1, 2), kernel_impl="fused")
    rt = _rt(toy_cascade, sv)
    prof = rt.measure_profile(batches=(1, 2), repeats=1)
    spec = as_cascade_spec(sv.cascade)
    tiers = tuple(dataclasses.replace(t, profile=prof[i])
                  for i, t in enumerate(spec.tiers))
    spec = dataclasses.replace(spec, tiers=tiers,
                               slo_s=max(20 * prof[-1].base_s, 1.0))
    sv = dataclasses.replace(sv, cascade=spec)
    class_profs = rt.measure_class_profiles(batches=(1, 2), repeats=1)
    assert set(class_profs) == {"fast", "slow"}
    assert all(len(v) == spec.num_tiers for v in class_profs.values())
    sv = dataclasses.replace(
        sv, worker_classes=measured_worker_classes(sv, class_profs))
    rt = _rt(toy_cascade, sv)

    qps = 0.5 / prof[0].base_s
    trace = static_trace(min(max(qps, 1.0), 25.0), 16)
    profiles = make_profiles(sv, 0)
    control = build_control_plane(spec, sv, profiles)
    backend = _backend(rt, sv, profiles, seed=0)
    assert isinstance(backend, ExecutorBackend)
    r = backend.serve(control, trace)

    assert r.total > 0
    assert r.completed + r.dropped == r.total
    assert r.completed > 0.5 * r.total
    assert len(backend.plan_timeline) >= 3
    assert len(r.threshold_timeline) == len(backend.plan_timeline)
    assert any(sum(w) > 0 for _, w, _ in backend.plan_timeline)
    assert r.latencies and min(r.latencies) > 0.0
    assert set(r.class_batch_latencies) <= {"fast", "slow"}
    assert r.class_batch_latencies
    # the real discriminator's scores were kept and fit per boundary
    assert backend._conf_samples[0]
    fitted = backend.fitted_quality_models()
    assert len(fitted) == 1 and len(fitted[0].scores) == \
        len(backend._conf_samples[0])
