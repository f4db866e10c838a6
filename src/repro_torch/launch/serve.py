"""End-to-end serving driver (the paper's kind of system), on the
PyTorch port: the port of ``repro/launch/serve.py``.

Runs the full DiffServe pipeline (controller + cascade solver + N-tier
cascade + trace) in simulator mode: paper-profile latencies through the
port's copies of the serving stack (``serving/{admission, autocascade,
autoscaler, baselines, controlplane, forecast, microserve, profiles,
trace}.py``), which are exact, so the same arguments print the JSON
report of ``python -m repro.launch.serve``, key for key and value for
value. The flags, defaults and ``ap.error`` messages are the
reference's; ``--kernel-impl`` chooses from ``TORCH_KERNEL_IMPLS``
(and ``auto``). A real cascade measured on the card is
``examples/serve_cascade_torch.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --cascade sdturbo \
      --baseline diffserve --workers 16 --trace-min 4 --trace-max 32
  PYTHONPATH=src python -m repro_torch.launch.serve --list-cascades
  PYTHONPATH=src python -m repro_torch.launch.serve --cascade sdxs3 \
      --workers 24
  PYTHONPATH=src python -m repro_torch.launch.serve --list-frontier
  PYTHONPATH=src python -m repro_torch.launch.serve --auto-cascade \
      --trace-min 4 --trace-max 32       # per-epoch cascade search
  PYTHONPATH=src python -m repro_torch.launch.serve --catalog my_pool.json \
      --cascade auto:coco512:sdxs+sdv1.5
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from repro_torch.kernels.impls import TORCH_KERNEL_IMPLS
from repro_torch.serving.admission import TORCH_ADMISSIONS
from repro_torch.serving.autocascade import CascadeBuilder, load_catalog
from repro_torch.serving.autoscaler import TORCH_SCALERS, provisioned_cost
from repro_torch.serving.baselines import (BASELINES, TORCH_CONTROLLERS,
                                           list_controllers,
                                           run_controller)
from repro_torch.serving.controlplane import TORCH_ESTIMATORS
from repro_torch.serving.forecast import TORCH_FORECASTERS
from repro_torch.serving.microserve import TORCH_STAGES
from repro_torch.serving.profiles import (class_costs_from_arg,
                                          default_serving, list_cascades,
                                          resolve_cascade,
                                          worker_classes_from_arg)
from repro_torch.serving.trace import (azure_like_trace, load_trace_file,
                                       static_trace)


# the registry's routes and "auto" (resolve_kernel_impl maps it to
# "fused"; TORCH_KERNEL_IMPLS holds the concrete routes only)
KERNEL_IMPL_CHOICES = sorted(TORCH_KERNEL_IMPLS) + ["auto"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cascade", default="sdturbo",
                    help="a registered cascade name (see --list-cascades), "
                    "a pinned name of --catalog, or an auto-chain "
                    "auto:<family>:<model>+<model>+...")
    ap.add_argument("--catalog", default=None,
                    help="variant catalog: 'builtin' (default) or a JSON "
                    "file path (families/variants/pinned; see "
                    "serving/autocascade.py)")
    ap.add_argument("--auto-cascade", action="store_true",
                    help="per-epoch cascade search: the controller may "
                    "switch the serving cascade under load (candidates = "
                    "the catalog family's pruned frontier; supersedes "
                    "--controller/--baseline)")
    ap.add_argument("--list-cascades", action="store_true",
                    help="print the registered cascades and exit")
    ap.add_argument("--list-frontier", action="store_true",
                    help="print the builder's quality/latency cascade "
                    "frontier per catalog family and exit")
    ap.add_argument("--list-controllers", action="store_true",
                    help="print the control-plane policy bundles and exit")
    ap.add_argument("--baseline", default="diffserve",
                    choices=list(BASELINES))
    ap.add_argument("--controller", default=None,
                    choices=sorted(TORCH_CONTROLLERS),
                    help="control-plane policy bundle (supersedes "
                    "--baseline; also covers the §4.5 ablations)")
    ap.add_argument("--estimator", default=None,
                    choices=sorted(TORCH_ESTIMATORS),
                    help="demand estimator policy (default ewma)")
    ap.add_argument("--scaler", default=None, choices=sorted(TORCH_SCALERS),
                    help="scaling policy (serving/autoscaler.py): "
                    "heartbeat (default, fixed fleet) / reactive / "
                    "predictive / predictive-oracle / null")
    ap.add_argument("--forecaster", default=None,
                    choices=sorted(TORCH_FORECASTERS),
                    help="demand forecaster behind the predictive scaler "
                    "(default holt-winters)")
    ap.add_argument("--forecast-horizon", type=float, default=0.0,
                    help="forecast lead seconds (0 = one control epoch "
                    "+ model-load time)")
    ap.add_argument("--warm-pool", type=int, default=0,
                    help="per-tier pre-loaded standby workers the scaler "
                    "keeps warm ahead of ramps")
    ap.add_argument("--warm-start", action="store_true",
                    help="provision the first control tick for the "
                    "trace's known t=0 rate instead of nominal 1 qps")
    ap.add_argument("--admission", default=None,
                    choices=sorted(TORCH_ADMISSIONS),
                    help="overload admission policy "
                    "(serving/admission.py): accept-all (default) / "
                    "token-bucket / queue-depth (ECN-style early "
                    "degradation + door shedding)")
    ap.add_argument("--ecn-k", type=float, default=30.0,
                    help="queue-depth admission: per-tier ECN mark "
                    "threshold k (sweep like k10/k30/k60; shedding "
                    "starts at k * --ecn-shed-mult)")
    ap.add_argument("--ecn-shed-mult", type=float, default=4.0,
                    help="queue-depth admission: hard-shed depth as a "
                    "multiple of the ECN mark threshold k (default 4)")
    ap.add_argument("--stage-graph", default="off",
                    choices=sorted(TORCH_STAGES),
                    help="stage-granular micro-serving "
                    "(serving/microserve.py): off (default, classic "
                    "whole-tier path) / whole-tier (stage engine, one "
                    "stage per tier) / micro (encode/denoise/decode "
                    "split with continuous step batching + "
                    "confidence-based preemption)")
    ap.add_argument("--stage-denoise-steps", type=int, default=8,
                    help="micro stage graph: denoise step count per "
                    "tier (per-query steps become a second quality "
                    "knob via preemption)")
    ap.add_argument("--stage-preempt-frac", type=float, default=0.5,
                    help="micro stage graph: earliest preemption point "
                    "as a fraction of the denoise steps (confident "
                    "queries exit to decode after ceil(frac*steps))")
    ap.add_argument("--kernel-impl", default="auto",
                    choices=KERNEL_IMPL_CHOICES,
                    help="kernel hot path for the cascade stages "
                    "(kernels/impls.py): auto (= fused) / fused (the "
                    "Hopper kernels on CUDA, their plain versions on the "
                    "CPU) / unfused (the per-op PyTorch baseline)")
    ap.add_argument("--batch-buckets", default="1,2,4,8",
                    help="comma-separated batch bucket ladder samplers "
                    "pad to (bounds compiled programs to one per bucket "
                    "per stage); empty string disables bucketing")
    ap.add_argument("--shed-feedback", action="store_true",
                    help="fold the admission door's shed rate back "
                    "into the solver's demand prior (plan for offered "
                    "load, not just survivors)")
    ap.add_argument("--admission-rate", type=float, default=0.0,
                    help="token-bucket admission: sustained admit rate "
                    "in qps (required for --admission token-bucket)")
    ap.add_argument("--admission-burst", type=float, default=2.0,
                    help="token-bucket admission: bucket depth in "
                    "seconds of sustained rate (default 2.0)")
    ap.add_argument("--load-scale", type=float, default=1.0,
                    help="multiply the trace's offered QPS by this "
                    "factor (overload sweeps: 16, 64, 100, ...)")
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--worker-classes", default=None,
                    help="heterogeneous cluster as "
                    "name:count[:speed][@model=BASExMARG],... e.g. "
                    "a100:4:1.0,a10g:12:0.45 or a10g:12@sdxl=2.2x2.6 "
                    "(per-class latency scales default from the GPU "
                    "class table; overrides --workers)")
    ap.add_argument("--cost-per-class", default=None,
                    help="cost-weighted allocation objective: $/hour per "
                    "class as name[=cost],... e.g. a100=4.10,a10g=1.21 "
                    "(omitted costs default from the GPU price table); "
                    "threshold ties then break by dollar cost instead of "
                    "worker count")
    ap.add_argument("--duration", type=int, default=360)
    ap.add_argument("--trace-min", type=float, default=4.0)
    ap.add_argument("--trace-max", type=float, default=32.0)
    ap.add_argument("--trace-file", default=None)
    ap.add_argument("--static-qps", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.list_cascades:
        print(f"{'name':10s} {'tiers':40s} {'SLO':>6s}")
        for name, chain, slo, _n in list_cascades():
            print(f"{name:10s} {chain:40s} {slo:5.1f}s")
        return

    if args.list_controllers:
        print(f"{'name':18s} description")
        for name, desc in list_controllers():
            print(f"{name:18s} {desc}")
        return

    wcs = (worker_classes_from_arg(args.worker_classes)
           if args.worker_classes else ())
    catalog = load_catalog(args.catalog or "builtin")
    # the declared hardware mix steers candidate scoring, so the
    # frontier/auto-cascade pick chains per hardware mix (pinned-name
    # resolution is mix-independent and stays bit-identical)
    builder = CascadeBuilder(catalog, worker_classes=wcs)

    if args.list_frontier:
        print(f"{'name':32s} {'tiers':34s} {'kind':7s} {'SLO':>6s} "
              f"{'bestFID':>8s} {'minLat':>7s} {'frontier':8s}")
        for fam in catalog.families():
            for s in builder.frontier(fam):
                chain = " -> ".join(s.models)
                kind = "pinned" if s.pinned else "auto"
                keep = "dominated" if s.dominated else "yes"
                print(f"{s.spec.name:32s} {chain:34s} {kind:7s} "
                      f"{s.spec.slo_s:5.1f}s {s.best_fid:8.2f} "
                      f"{s.base_latency_s:6.3f}s {keep:8s}")
        return

    if args.trace_file:
        trace = load_trace_file(args.trace_file)
    elif args.static_qps is not None:
        if args.static_qps < 0:
            ap.error(f"--static-qps must be >= 0, got {args.static_qps}")
        trace = static_trace(args.static_qps, args.duration)
    else:
        trace = azure_like_trace(args.duration, seed=3).scale(
            args.trace_min, args.trace_max)
    if args.load_scale < 0:
        ap.error(f"--load-scale must be >= 0, got {args.load_scale}")
    if args.load_scale != 1.0:
        trace = trace.scaled(args.load_scale)
    if args.admission == "token-bucket" and args.admission_rate <= 0:
        ap.error("--admission token-bucket requires --admission-rate > 0")
    if args.ecn_shed_mult < 1.0:
        ap.error(f"--ecn-shed-mult must be >= 1 (shed at or above the "
                 f"mark threshold), got {args.ecn_shed_mult}")
    if args.admission_burst <= 0:
        ap.error(f"--admission-burst must be > 0, got "
                 f"{args.admission_burst}")
    if args.cost_per_class and not wcs:
        ap.error("--cost-per-class requires --worker-classes")
    costs = (class_costs_from_arg(args.cost_per_class)
             if args.cost_per_class else ())
    try:
        spec = resolve_cascade(args.cascade, catalog)
    except KeyError as e:
        ap.error(str(e.args[0] if e.args else e))
    controller = args.controller or args.baseline
    candidates = ()
    if args.auto_cascade:
        controller = "cascade-search"
        # candidates: the catalog family's pruned frontier (same SLO as
        # the active cascade, so in-flight deadlines survive a switch)
        fam = None
        if args.cascade in catalog.pinned_names():
            fam = catalog.pinned(args.cascade).family
        elif args.cascade.startswith("auto:"):
            fam = args.cascade.split(":", 2)[1]
        if fam is not None:
            candidates = tuple(
                n for n, c in sorted(builder.build_family(fam).items())
                if abs(c.slo_s - spec.slo_s) < 1e-9)
    if args.forecast_horizon < 0:
        ap.error(f"--forecast-horizon must be >= 0, got "
                 f"{args.forecast_horizon}")
    if args.warm_pool < 0:
        ap.error(f"--warm-pool must be >= 0, got {args.warm_pool}")
    if args.stage_denoise_steps < 1:
        ap.error(f"--stage-denoise-steps must be >= 1, got "
                 f"{args.stage_denoise_steps}")
    if not 0 < args.stage_preempt_frac <= 1:
        ap.error(f"--stage-preempt-frac must be in (0, 1], got "
                 f"{args.stage_preempt_frac}")
    try:
        buckets = tuple(int(b) for b in args.batch_buckets.split(",")
                        if b.strip())
    except ValueError:
        ap.error(f"--batch-buckets must be a comma-separated int list, "
                 f"got {args.batch_buckets!r}")
    serving = default_serving(cascade=spec, num_workers=args.workers,
                              worker_classes=wcs, class_costs=costs,
                              controller=controller,
                              estimator=args.estimator or "ewma",
                              catalog=args.catalog or "builtin",
                              candidate_cascades=candidates,
                              scaler=args.scaler or "heartbeat",
                              forecaster=args.forecaster or "holt-winters",
                              forecast_horizon_s=args.forecast_horizon,
                              warm_pool=args.warm_pool,
                              warm_start_demand=args.warm_start,
                              admission=args.admission or "accept-all",
                              ecn_k=args.ecn_k,
                              ecn_shed_mult=args.ecn_shed_mult,
                              admission_rate_qps=args.admission_rate,
                              admission_burst_s=args.admission_burst,
                              stage_graph=args.stage_graph,
                              stage_denoise_steps=args.stage_denoise_steps,
                              stage_preempt_frac=args.stage_preempt_frac,
                              shed_feedback=args.shed_feedback,
                              kernel_impl=args.kernel_impl,
                              batch_buckets=buckets)
    r = run_controller(controller, trace, serving, seed=args.seed,
                       estimator=args.estimator)

    report = {
        "cascade": args.cascade,
        "tiers": [t.model for t in spec.tiers],
        "controller": controller,
        "estimator": args.estimator or serving.estimator,
        "workers": serving.num_workers, "trace": trace.name,
        "total_queries": r.total, "completed": r.completed,
        "dropped": r.dropped, "slo_violation_ratio": round(r.violation_ratio, 4),
        "admission": serving.admission, "load_scale": args.load_scale,
        "shed_admission": r.shed_admission,
        "dropped_predictive": r.dropped_predictive,
        "dropped_deadline": r.dropped_deadline,
        "goodput": round(r.goodput, 4),
        "mean_fid": round(r.mean_fid, 3),
        "defer_fraction": round(r.defer_fraction, 3),
        "boundary_defer_fractions": [
            round(f, 3) for f in r.boundary_defer_fractions()],
        "completed_per_tier": list(r.completed_per_tier),
        "p50_latency_s": round(float(np.percentile(r.latencies, 50)), 3)
        if r.latencies else None,
        "p99_latency_s": round(float(np.percentile(r.latencies, 99)), 3)
        if r.latencies else None,
        "mean_milp_ms": round(float(np.mean(r.solve_ms)), 3)
        if r.solve_ms else None,
        "hedged": r.hedged,
        "threshold_timeline": r.threshold_timeline[:: max(
            len(r.threshold_timeline) // 50, 1)],
    }
    if serving.stage_graph != "off":
        report["stage_graph"] = serving.stage_graph
        report["dropped_stage"] = r.dropped_stage
        report["preempted_early"] = r.preempted_early
        report["stage_denoise_steps"] = serving.stage_denoise_steps
        report["stage_preempt_frac"] = serving.stage_preempt_frac
    if serving.shed_feedback:
        report["shed_feedback"] = True
    if serving.admission == "queue-depth":
        report["ecn_k"] = serving.ecn_k
        report["ecn_shed_mult"] = serving.ecn_shed_mult
    elif serving.admission == "token-bucket":
        report["admission_rate_qps"] = serving.admission_rate_qps
        report["admission_burst_s"] = serving.admission_burst_s
    if args.scaler and args.scaler not in ("heartbeat", "null"):
        caps = [n for _, n in r.capacity_timeline]
        report["scaler"] = args.scaler
        report["forecaster"] = args.forecaster or serving.forecaster
        report["warm_pool"] = serving.warm_pool
        report["capacity_changes"] = max(len(r.capacity_timeline) - 1, 0)
        report["capacity_min_max"] = ([min(caps), max(caps)]
                                      if caps else None)
        report["provisioned_node_hours"] = round(
            provisioned_cost(r.capacity_timeline, trace.duration_s, 1.0),
            4)
    if r.cascade_timeline:
        report["cascade_switches"] = r.cascade_switches
        report["cascade_timeline"] = [
            [round(t, 1), n] for t, n in r.cascade_timeline]
    if wcs:
        report["worker_classes"] = {
            wc.name: {"count": wc.count, "speed": wc.speed,
                      "profiles": {m: [sc.base, sc.marginal]
                                   for m, sc in wc.profiles}}
            for wc in wcs}
        report["workers_by_class"] = r.workers_by_class
        report["class_mean_batch_latency_s"] = r.class_latency_summary()
    if costs and r.plan_cost_timeline:
        mean_rate = r.mean_plan_cost_per_hour         # $/hour
        report["cost_per_class"] = dict(costs)
        report["mean_cost_per_hour"] = round(mean_rate, 3)
        report["cost_per_1k_queries"] = round(
            mean_rate / 3600.0 * trace.duration_s
            / max(r.completed, 1) * 1000.0, 4)
    print(json.dumps(report, indent=1))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
