"""The port's copies of the framework-free control side against their
originals in the JAX package: the serving configs and cascade specs,
deferral profiles and quality models, the branch-and-bound MILP and the
cascade solvers, the resource manager, traces, admission policies,
estimators, the control plane, the cascade builder and search planner,
the cascade registry, and the simulator's result type.

Two kinds of pins. The source pins parse each copy and its original
and require the same syntax tree once imports are renamed (``repro`` ->
``repro_torch``), the port's registries carry their own names
(``TORCH_ADMISSIONS``, ``TORCH_ESTIMATORS``) and docstrings are set
aside; the only definition left out is ``build_control_plane``, whose
two unported branches raise, and which is held by behaviour instead. The
behaviour pins feed the same seeded inputs to both packages and compare
the results with ``==``, leaving out only ``solve_ms`` (the solver's own
wall time from ``time.perf_counter``).
"""
import ast
import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest

import repro.config.base as R_cfg
import repro.core.allocator as R_alloc
import repro.core.bnb as R_bnb
import repro.core.confidence as R_conf
import repro.core.milp as R_milp
import repro.core.quality as R_qual
import repro.serving.admission as R_adm
import repro.serving.autocascade as R_auto
import repro.serving.baselines as R_base
import repro.serving.controlplane as R_cp
import repro.serving.profiles as R_prof
import repro.serving.simulator as R_sim
import repro.serving.trace as R_trace
import repro_torch.config.base as T_cfg
import repro_torch.core.allocator as T_alloc
import repro_torch.core.bnb as T_bnb
import repro_torch.core.confidence as T_conf
import repro_torch.core.milp as T_milp
import repro_torch.core.quality as T_qual
import repro_torch.serving.admission as T_adm
import repro_torch.serving.autocascade as T_auto
import repro_torch.serving.baselines as T_base
import repro_torch.serving.controlplane as T_cp
import repro_torch.serving.profiles as T_prof
import repro_torch.serving.simulator as T_sim
import repro_torch.serving.trace as T_trace
from repro_torch.kernels.impls import resolve_kernel_impl

SRC = Path(__file__).resolve().parents[1] / "src"
CASCADE_NAMES = sorted(R_prof.CASCADES)
# fields derived from the solver's wall clock (time.perf_counter)
WALL_FIELDS = ("solve_ms",)


def plain(x, drop=WALL_FIELDS):
    """A package-free value for ``==``: dataclasses become (class name,
    fields) with the wall-time fields dropped, arrays become (dtype,
    shape, values), deferral profiles their sorted scores."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name), drop)
                 for f in dataclasses.fields(x) if f.name not in drop})
    if isinstance(x, (R_conf.DeferralProfile, T_conf.DeferralProfile)):
        return ("DeferralProfile", list(x._scores), x._max)
    if isinstance(x, dict):
        return {k: plain(v, drop) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v, drop) for v in x)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


# ---------------------------------------------------------------------------
# Source pins
# ---------------------------------------------------------------------------
RENAMES = {"TORCH_ADMISSIONS": "ADMISSIONS",
           "TORCH_ESTIMATORS": "ESTIMATORS"}


class _Normalize(ast.NodeTransformer):
    """Map the port's spelling onto the reference's and drop
    docstrings."""

    def visit_ImportFrom(self, node):
        if node.module and node.module.split(".")[0] == "repro_torch":
            node.module = "repro" + node.module[len("repro_torch"):]
        return node

    def visit_Name(self, node):
        node.id = RENAMES.get(node.id, node.id)
        return node

    def _strip_doc(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = _strip_doc


def _defs(path: str):
    """name -> normalized dump of each top-level statement (imports and
    ``from __future__`` under the key of their position)."""
    tree = _Normalize().visit(ast.parse((SRC / path).read_text()))
    out = {}
    for i, node in enumerate(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            key = node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            tgt = node.targets[0] if isinstance(node, ast.Assign) \
                else node.target
            key = ast.unparse(tgt)
        else:
            key = f"#{ast.dump(node)}"
        out[key] = ast.dump(node)
    return out


WHOLE = ["core/confidence.py", "core/quality.py", "core/bnb.py",
         "core/milp.py", "core/allocator.py", "serving/trace.py",
         "serving/admission.py", "serving/autocascade.py",
         "serving/profiles.py", "serving/controlplane.py"]
# (module, definitions copied) for the partial copies and the extended
# config module
PARTIAL = [
    ("config/base.py", ("LatencyProfile", "TierSpec", "CascadeSpec",
                        "CascadeConfig", "as_cascade_spec", "tier_rho",
                        "LatencyScale", "WorkerClass", "as_worker_class",
                        "_parse_scale", "parse_worker_classes",
                        "parse_class_costs", "ServingConfig", "replace",
                        "DiffusionConfig")),
    ("serving/simulator.py", ("Query", "CONSERVATION_FIELDS", "SimResult")),
    ("serving/baselines.py", ("make_profile", "make_profiles")),
]
# the one definition whose port differs: its unported branches raise
DIFFERS = {"serving/controlplane.py": ("build_control_plane",)}


@pytest.mark.parametrize("path", WHOLE)
def test_whole_module_copy_matches_its_original(path):
    ref = _defs(f"repro/{path}")
    port = _defs(f"repro_torch/{path}")
    for name in DIFFERS.get(path, ()):
        assert name in ref and name in port
        del ref[name], port[name]
    assert list(port) == list(ref)
    bad = [k for k in ref if ref[k] != port[k]]
    assert bad == []


@pytest.mark.parametrize("path,names", PARTIAL,
                         ids=[p for p, _ in PARTIAL])
def test_partial_copy_matches_its_original(path, names):
    ref = _defs(f"repro/{path}")
    port = _defs(f"repro_torch/{path}")
    bad = [n for n in names if n not in port or ref[n] != port[n]]
    assert bad == []


# ---------------------------------------------------------------------------
# Configs and the cascade registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CASCADE_NAMES)
def test_registered_cascades_match(name):
    assert plain(T_prof.CASCADES[name]) == plain(R_prof.CASCADES[name])
    assert plain(T_prof.resolve_cascade(name)) == \
        plain(R_prof.resolve_cascade(name))


def test_cascade_listing_and_class_tables_match():
    assert T_prof.list_cascades() == R_prof.list_cascades()
    for table in ("GPU_CLASS_PROFILES", "GPU_CLASS_SPEEDS",
                  "GPU_CLASS_COSTS"):
        assert getattr(T_prof, table) == getattr(R_prof, table)
    assert plain(T_auto.MODEL_PROFILES) == plain(R_auto.MODEL_PROFILES)
    text = "a100:2,a10g:3@sdxl=2.2x3.1,t4:1:0.3"
    assert plain(T_prof.worker_classes_from_arg(text)) == \
        plain(R_prof.worker_classes_from_arg(text))
    assert T_prof.class_costs_from_arg("a100,a10g=1.5") == \
        R_prof.class_costs_from_arg("a100,a10g=1.5")


def _field_table(cls):
    def default(f):
        if f.default is not dataclasses.MISSING:
            return f.default
        if f.default_factory is not dataclasses.MISSING:
            return plain(f.default_factory())
        return "required"
    return [(f.name, default(f), str(f.type))
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("cls", ["ServingConfig", "TierSpec",
                                 "CascadeSpec", "CascadeConfig",
                                 "WorkerClass", "LatencyScale",
                                 "LatencyProfile", "DiffusionConfig"])
def test_config_fields_and_defaults_match(cls):
    assert _field_table(getattr(T_cfg, cls)) == \
        _field_table(getattr(R_cfg, cls))


SERVING_KW = [
    dict(),
    dict(num_workers=4, batch_choices=(1, 2, 4, 8), kernel_impl="fused",
         batch_buckets=(1, 2, 4, 8)),
    dict(worker_classes="a100:2,a10g:2"),
    dict(worker_classes="a100:1,t4:3", class_costs="a100,t4"),
]


def _serving(mod_prof, cascade, kw):
    kw = dict(kw)
    if "worker_classes" in kw:
        kw["worker_classes"] = mod_prof.worker_classes_from_arg(
            kw["worker_classes"])
    if "class_costs" in kw:
        kw["class_costs"] = mod_prof.class_costs_from_arg(kw["class_costs"])
    return mod_prof.default_serving(cascade, **kw)


@pytest.mark.parametrize("kw", SERVING_KW, ids=range(len(SERVING_KW)))
def test_default_serving_matches(kw):
    ref = _serving(R_prof, "sdturbo", kw)
    port = _serving(T_prof, "sdturbo", kw)
    assert plain(port) == plain(ref)
    assert port.class_table() == ref.class_table()
    assert plain(port.class_map()) == plain(ref.class_map())


BAD_SERVING = [dict(ecn_k=0.0), dict(stage_denoise_steps=0),
               dict(stage_preempt_frac=0.0), dict(ecn_shed_mult=0.5),
               dict(admission_rate_qps=-1.0),
               dict(admission="token-bucket"),
               dict(forecast_horizon_s=-1.0), dict(warm_pool=-1),
               dict(class_costs=(("a", 1.0),)),
               dict(batch_buckets=(0, 1)), dict(batch_buckets=(2, 1)),
               dict(worker_classes=(("a", 1, 1.0), ("a", 1, 1.0))),
               dict(worker_classes=(("a", 3, 1.0),)),
               dict(worker_classes=(("a", 2, 1.0),),
                    class_costs=(("b", 1.0),)),
               dict(worker_classes=(("a", 1, 1.0), ("b", 1, 1.0)),
                    class_costs=(("a", 1.0),))]


@pytest.mark.parametrize("kw", BAD_SERVING, ids=range(len(BAD_SERVING)))
def test_serving_config_checks_match(kw):
    msgs = []
    for cfg in (R_cfg, T_cfg):
        kw_ = dict(kw)
        if "worker_classes" in kw_:
            kw_["worker_classes"] = tuple(cfg.WorkerClass(*wc)
                                          for wc in kw_["worker_classes"])
        spec = cfg.CascadeConfig("c", "l", "h")
        with pytest.raises(ValueError) as err:
            cfg.ServingConfig(cascade=spec, num_workers=2, **kw_)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_port_registries_have_the_reference_keys():
    assert list(T_adm.TORCH_ADMISSIONS) == list(R_adm.ADMISSIONS)
    assert list(T_cp.TORCH_ESTIMATORS) == list(R_cp.ESTIMATORS)
    # the linter's first-definition index must see both registries
    assert not hasattr(T_adm, "ADMISSIONS")
    assert not hasattr(T_cp, "ESTIMATORS")


def test_serving_config_defaults_name_registered_keys():
    sv = T_prof.default_serving("sdturbo")
    assert sv.admission in T_adm.TORCH_ADMISSIONS
    assert sv.estimator in T_cp.TORCH_ESTIMATORS
    assert resolve_kernel_impl(sv.kernel_impl) == "fused"
    assert sv.scaler == "heartbeat" and sv.stage_graph == "off"
    # every registered name builds, as the reference's does
    for name in T_adm.TORCH_ADMISSIONS:
        sv_ = dataclasses.replace(sv, admission=name,
                                  admission_rate_qps=2.0)
        assert type(T_adm.make_admission(name, sv_)).__name__ == \
            type(R_adm.make_admission(name, sv_)).__name__


# ---------------------------------------------------------------------------
# Deferral profiles and quality models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CASCADE_NAMES)
@pytest.mark.parametrize("seed", [0, 3])
def test_boundary_models_and_profiles_match(name, seed):
    spec_r, spec_t = R_prof.CASCADES[name], T_prof.CASCADES[name]
    ref = R_auto.fit_boundary_models(spec_r, seed)
    port = T_auto.fit_boundary_models(spec_t, seed)
    assert plain(port) == plain(ref)
    sv_r = R_prof.default_serving(name)
    sv_t = T_prof.default_serving(name)
    for uniform in (False, True):
        pr = R_base.make_profiles(sv_r, seed, uniform)
        pt = T_base.make_profiles(sv_t, seed, uniform)
        assert [p._scores for p in pt] == [p._scores for p in pr]
    assert T_base.make_profile(sv_t, seed, boundary=0)._scores == \
        R_base.make_profile(sv_r, seed, boundary=0)._scores


def test_deferral_profile_updates_match():
    rng = np.random.default_rng(5)
    scores = rng.random(300)
    r = R_conf.DeferralProfile(scores, max_size=400)
    t = T_conf.DeferralProfile(scores, max_size=400)
    for _ in range(4):
        fresh = rng.random(60)
        r.update(fresh)
        t.update(fresh)
        assert plain(t) == plain(r)
        for th in (0.0, 0.3, 0.71, 1.0):
            assert t.f(th) == r.f(th) and t.inverse(th) == r.inverse(th)
    got = T_conf.as_boundary_profiles(t, 3)
    want = R_conf.as_boundary_profiles(r, 3)
    assert plain(got) == plain(want)


@pytest.mark.parametrize("name", CASCADE_NAMES)
def test_quality_models_match(name, tmp_path):
    qr = R_qual.QualityModel.from_cascade(R_prof.CASCADES[name])
    qt = T_qual.QualityModel.from_cascade(T_prof.CASCADES[name])
    for p in np.linspace(0.0, 1.0, 11):
        for router in R_qual.ROUTER_SKILL:
            assert qt.fid(p, router) == qr.fid(p, router)
    # a quality-model file written by the reference loads in the port
    models = R_auto.fit_boundary_models(R_prof.CASCADES[name], 1)
    R_qual.save_quality_models(tmp_path / "q.json", models)
    assert plain(T_qual.load_quality_models(tmp_path / "q.json")) == \
        plain(models)


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------
def _milp(mod, rng, n):
    c = -rng.integers(1, 9, n).astype(float)
    A = rng.integers(0, 6, (3, n)).astype(float)
    b = rng.integers(8, 30, 3).astype(float)
    return mod.MILP(c=c, A_ub=A, b_ub=b, upper=np.full(n, 6.0),
                    integer=tuple(range(n)))


@pytest.mark.parametrize("seed", range(4))
def test_branch_and_bound_matches(seed):
    ref = R_bnb.solve_milp(_milp(R_bnb, np.random.default_rng(seed), 4))
    port = T_bnb.solve_milp(_milp(T_bnb, np.random.default_rng(seed), 4))
    assert plain(port) == plain(ref)


def _tel(mod, demand, n_tiers, workers):
    return mod.Telemetry(demand_qps=demand,
                         queues=tuple(float(i + 1) for i in range(n_tiers)),
                         arrivals=(demand,) * n_tiers, live_workers=workers)


@pytest.mark.parametrize("name", CASCADE_NAMES)
@pytest.mark.parametrize("demand", [0.5, 6.0, 40.0])
def test_solve_cascade_matches(name, demand):
    plans = []
    for milp, prof, base in ((R_milp, R_prof, R_base),
                             (T_milp, T_prof, T_base)):
        sv = prof.default_serving(name, num_workers=12)
        profiles = base.make_profiles(sv, 0)
        n = sv.cascade.num_tiers
        plans.append(plain(milp.solve_cascade(
            sv.cascade, sv, profiles, demand, num_workers=12,
            queues=[float(i + 1) for i in range(n)],
            arrivals=[demand] * n)))
    assert plans[1] == plans[0]


CLASS_MIXES = ["a100:3,a10g:5", "h100:2,t4:6@sdxl=3x4",
               "a100:4:1.0,l40s:2"]


@pytest.mark.parametrize("name", CASCADE_NAMES)
@pytest.mark.parametrize("mix", CLASS_MIXES)
@pytest.mark.parametrize("demand", [2.0, 12.0])
def test_solve_heterogeneous_cascade_matches(name, mix, demand):
    plans = []
    for milp, prof, base in ((R_milp, R_prof, R_base),
                             (T_milp, T_prof, T_base)):
        wcs = prof.worker_classes_from_arg(mix)
        sv = prof.default_serving(name, worker_classes=wcs)
        profiles = base.make_profiles(sv, 0)
        n = sv.cascade.num_tiers
        plans.append(plain(milp.solve_heterogeneous_cascade(
            sv.cascade, sv, profiles, demand,
            queues=[float(i + 1) for i in range(n)],
            arrivals=[demand] * n)))
    assert plans[1] == plans[0]


def test_solve_heterogeneous_with_costs_matches():
    plans = []
    for milp, prof, base in ((R_milp, R_prof, R_base),
                             (T_milp, T_prof, T_base)):
        wcs = prof.worker_classes_from_arg("a100:3,a10g:5")
        sv = prof.default_serving("sdxs3", worker_classes=wcs,
                                  class_costs=prof.class_costs_from_arg(
                                      "a100,a10g"))
        profiles = base.make_profiles(sv, 0)
        plans.append(plain(milp.solve_heterogeneous_cascade(
            sv.cascade, sv, profiles, 5.0, queues=[1.0, 2.0, 3.0])))
    assert plans[1] == plans[0]


@pytest.mark.parametrize("mode", ["diffserve", "static_threshold",
                                  "aimd_batching", "no_queuing_model"])
def test_resource_manager_sequence_matches(mode):
    out = []
    for alloc, milp, prof, base in ((R_alloc, R_milp, R_prof, R_base),
                                    (T_alloc, T_milp, T_prof, T_base)):
        sv = prof.default_serving("sdturbo", num_workers=10)
        rm = alloc.ResourceManager(sv.cascade, sv,
                                   base.make_profiles(sv, 0),
                                   alloc.AllocatorOptions(mode=mode))
        plans = []
        for demand in (1.0, 3.0, 9.0, 2.0, 15.0):
            tel = _tel(milp, demand, 2, 10)
            plans.append(plain(rm.plan_for_demand(tel, demand)))
        out.append(plans)
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# Traces, telemetry, admission, estimators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 2, 7])
def test_traces_match(seed):
    ref = R_trace.azure_like_trace(40, seed=seed).scale(1, 8)
    port = T_trace.azure_like_trace(40, seed=seed).scale(1, 8)
    assert plain(port) == plain(ref)
    assert plain(port.scaled(2.5)) == plain(ref.scaled(2.5))
    np.testing.assert_array_equal(
        port.arrivals(np.random.default_rng(seed)),
        ref.arrivals(np.random.default_rng(seed)))
    assert plain(T_trace.static_trace(3.0, 20)) == \
        plain(R_trace.static_trace(3.0, 20))
    assert plain(T_trace.incast_trace(30, jitter_s=1.0, seed=seed)) == \
        plain(R_trace.incast_trace(30, jitter_s=1.0, seed=seed))
    assert [port.rate_at(t) for t in (-1, 0, 13.5, 99)] == \
        [ref.rate_at(t) for t in (-1, 0, 13.5, 99)]


def _windowed(cp, conf, now):
    window = __import__("collections").deque([0.1, 0.5, 1.2, 2.9, 3.3,
                                              3.8, 3.9])
    profiles = (conf.DeferralProfile(np.linspace(0, 1, 50)),
                conf.DeferralProfile(np.linspace(0.2, 0.9, 30)))
    census = cp.Census(now=now, active_slots=5, live_workers=4,
                       live_by_class=(("a", 2), ("b", 2)))
    tel = cp.windowed_telemetry(now, 2.0, window, (3.0, 1.0, 0.0),
                                profiles, (0.4, 0.6), census,
                                drops=(1, 2, 3))
    return plain(tel), list(window)


@pytest.mark.parametrize("now", [2.0, 4.0, 9.0])
def test_windowed_telemetry_matches(now):
    assert _windowed(T_cp, T_conf, now) == _windowed(R_cp, R_conf, now)


ADMISSION_CASES = [("accept-all", {}),
                   ("token-bucket", dict(admission_rate_qps=2.0,
                                         admission_burst_s=1.5)),
                   ("queue-depth", dict(ecn_k=3.0, ecn_shed_mult=2.0))]


@pytest.mark.parametrize("name,kw", ADMISSION_CASES,
                         ids=[n for n, _ in ADMISSION_CASES])
def test_admission_decisions_match(name, kw):
    rng = np.random.default_rng(11)
    steps = [(float(t), tuple(int(d) for d in rng.integers(0, 12, 3)),
              int(rng.integers(0, 3)))
             for t in np.cumsum(rng.random(80) * 0.3)]
    out = []
    for prof, adm, milp in ((R_prof, R_adm, R_milp),
                            (T_prof, T_adm, T_milp)):
        sv = prof.default_serving("sdxs3", admission=name, **kw)
        policy = adm.make_admission(name, sv)
        got = [policy.admit(t, depths, tier) for t, depths, tier in steps]
        for q in ((0.0, 1.0, 2.0), (0.0, 9.0, 30.0)):
            tel = milp.Telemetry(demand_qps=3.0, queues=q)
            got.append(policy.degrade((0.7, 0.5), tel))
        out.append((got, plain(vars(policy))))
    assert out[1] == out[0]


@pytest.mark.parametrize("name", ["ewma", "sliding-window", "oracle"])
def test_estimators_match(name):
    out = []
    for prof, cp, trace in ((R_prof, R_cp, R_trace),
                            (T_prof, T_cp, T_trace)):
        sv = prof.default_serving("sdturbo")
        est = cp.make_estimator(name, sv, trace.azure_like_trace(30, 1))
        out.append([est.estimate(q, now=float(i))
                    for i, q in enumerate((1.0, 4.0, 2.5, 9.0, 0.0, 3.0))])
    assert out[1] == out[0]


def test_unported_control_branches_raise():
    sv = T_prof.default_serving("sdturbo")
    profiles = T_base.make_profiles(sv, 0)
    with pytest.raises(NotImplementedError, match="microserve"):
        T_cp.build_control_plane(
            sv.cascade, dataclasses.replace(sv, stage_graph="denoise"),
            profiles)
    with pytest.raises(NotImplementedError, match="autoscaler"):
        T_cp.build_control_plane(
            sv.cascade, dataclasses.replace(sv, scaler="predictive"),
            profiles)
    # the branches that are ported build the reference's policies
    for scaler in ("heartbeat", "null"):
        for est in ("ewma", "sliding-window"):
            sv_ = dataclasses.replace(sv, scaler=scaler, estimator=est)
            got = T_cp.build_control_plane(sv.cascade, sv_, profiles)
            want = R_cp.build_control_plane(
                R_prof.CASCADES["sdturbo"],
                dataclasses.replace(R_prof.default_serving("sdturbo"),
                                    scaler=scaler, estimator=est),
                R_base.make_profiles(R_prof.default_serving("sdturbo"), 0))
            assert [type(getattr(got, f)).__name__ for f in
                    ("estimator", "planner", "thresholds", "scaling",
                     "admission")] == \
                [type(getattr(want, f)).__name__ for f in
                 ("estimator", "planner", "thresholds", "scaling",
                  "admission")]


def test_build_control_plane_signature_matches():
    assert str(inspect.signature(T_cp.build_control_plane)) == \
        str(inspect.signature(R_cp.build_control_plane))


# ---------------------------------------------------------------------------
# Cascade construction and the search planner
# ---------------------------------------------------------------------------
def test_cascade_builder_matches():
    br = R_auto.CascadeBuilder(R_auto.builtin_catalog())
    bt = T_auto.CascadeBuilder(T_auto.builtin_catalog())
    assert plain(bt.registry()) == plain(br.registry())
    for family in br.catalog.families():
        assert plain(bt.frontier(family)) == plain(br.frontier(family))


@pytest.mark.parametrize("name", ["sdxs3", "sdxl3"])
def test_subchains_and_tier_remap_match(name):
    sr = R_auto.subchain_specs(R_prof.CASCADES[name])
    st = T_auto.subchain_specs(T_prof.CASCADES[name])
    assert plain(st) == plain(sr)
    for sub in sr:
        rm, rk = R_auto.tier_remap(R_prof.CASCADES[name], sr[sub])
        tm, tk = T_auto.tier_remap(T_prof.CASCADES[name], st[sub])
        n = R_prof.CASCADES[name].num_tiers
        assert [(tm(i), tk(i)) for i in range(n)] == \
            [(rm(i), rk(i)) for i in range(n)]
    assert plain(T_auto.default_candidates(T_prof.CASCADES[name],
                                           registry=T_prof.CASCADES)) == \
        plain(R_auto.default_candidates(R_prof.CASCADES[name],
                                        registry=R_prof.CASCADES))


def test_search_planner_sequence_matches():
    out = []
    for prof, auto, base, milp in ((R_prof, R_auto, R_base, R_milp),
                                   (T_prof, T_auto, T_base, T_milp)):
        sv = prof.default_serving("sdxs3", num_workers=6)
        cands = auto.default_candidates(sv.cascade)
        by = {n: base.make_profiles(dataclasses.replace(sv, cascade=c), 0)
              for n, c in cands.items()}
        planner = auto.CascadeSearchPlanner(sv, cands, by, active="sdxs3",
                                            min_dwell=1)
        seq = []
        for demand in (0.5, 2.0, 8.0, 30.0, 1.0, 0.2):
            tel = _tel(milp, demand, planner.chosen_cascade.num_tiers, 6)
            seq.append((plain(planner.plan(tel, demand)), planner.active))
        out.append((seq, planner.switches, planner.choice_log))
    assert out[1] == out[0]
    assert out[0][1] >= 1          # the sequence switches cascades


def test_simresult_accounting_matches():
    kw = dict(completed=7, shed_admission=1, dropped_predictive=2,
              dropped_deadline=3, violations=4, total=13, deferred=3,
              deferred_per_boundary=[3, 1], tier_processed=[10, 3],
              fid_timeline=[(1.0, 20.0), (2.0, 19.0)],
              class_batch_latencies={"a": [(2, 0.5), (1, 0.25)]},
              cascade_timeline=[(0.0, "x"), (5.0, "y")])
    r, t = R_sim.SimResult(**kw), T_sim.SimResult(**kw)
    for prop in ("cascade_switches", "dropped", "violation_ratio",
                 "shed_fraction", "goodput", "defer_fraction", "mean_fid"):
        assert getattr(t, prop) == getattr(r, prop)
    assert t.conserved() == r.conserved()
    assert t.boundary_defer_fractions() == r.boundary_defer_fractions()
    assert t.class_latency_summary() == r.class_latency_summary()
    assert T_sim.CONSERVATION_FIELDS == R_sim.CONSERVATION_FIELDS
