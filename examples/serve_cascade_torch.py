"""End-to-end serving driver on the PyTorch port: a real cascade run on
the card (CUDA unless ``--device cpu``), its latencies measured there,
then the full DiffServe control loop replays a bursty trace against
those profiles.

The port's counterpart of ``examples/serve_cascade.py``, with the same
flags (plus ``--device``) and the same JSON report. Builds one toy UNet
per tier of the chosen cascade (3-tier registries such as ``sdxs3`` run
the tier-recursive pipeline) and trains the discriminator with the
port's offline phase (``repro_torch.training.discriminator``).

Two modes share one ControlPlane (serving/controlplane.py):

  --mode sim      measured profiles feed the discrete-event simulator
                  backend (default; the paper's own methodology)
  --mode cluster  the ClusterBackend really executes every batch on the
                  card: measured per-class profiles feed
                  solve_heterogeneous_cascade re-planning every control
                  tick, confidences come from the trained discriminator

  PYTHONPATH=src python examples/serve_cascade_torch.py
  PYTHONPATH=src python examples/serve_cascade_torch.py --mode cluster
  PYTHONPATH=src python examples/serve_cascade_torch.py --device cpu \\
      --mode cluster --workers 2 --duration 8
  PYTHONPATH=src python examples/serve_cascade_torch.py --mode cluster \\
      --cascade sdturbo --worker-classes a100:2:1.0,a10g:6:0.45
"""
import argparse
import dataclasses
import json

import numpy as np

from repro_torch.config.base import DiffusionConfig, as_cascade_spec
from repro_torch.core.cascade import DiffusionCascade
from repro_torch.core.quality import load_quality_models, save_quality_models
from repro_torch.device import resolve_device
from repro_torch.kernels.impls import TORCH_KERNEL_IMPLS
from repro_torch.models.unet import init_unet
from repro_torch.serving.baselines import TORCH_CONTROLLERS, assemble_bundle
from repro_torch.serving.cluster import (ClusterBackend, ClusterRuntime,
                                         measured_worker_classes)
from repro_torch.serving.controlplane import TORCH_ESTIMATORS
from repro_torch.serving.microserve import TORCH_STAGES
from repro_torch.serving.profiles import (CASCADES, class_costs_from_arg,
                                          default_serving,
                                          worker_classes_from_arg)
from repro_torch.serving.simulator import SimConfig, Simulator
from repro_torch.serving.trace import azure_like_trace
from repro_torch.training.discriminator import train_discriminator


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cascade", default="sdturbo", choices=sorted(CASCADES))
    ap.add_argument("--mode", default="sim", choices=("sim", "cluster"),
                    help="sim: measured profiles drive the simulator "
                    "backend; cluster: the ClusterBackend really executes "
                    "every batch")
    ap.add_argument("--controller", default="diffserve",
                    choices=sorted(TORCH_CONTROLLERS),
                    help="control-plane policy bundle "
                    "(serving/baselines.py)")
    ap.add_argument("--estimator", default=None,
                    choices=sorted(TORCH_ESTIMATORS),
                    help="demand estimator (default: the serving config's, "
                    "i.e. ewma)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--worker-classes", default=None,
                    help="name:count[:speed][@model=BASExMARG],... e.g. "
                    "a100:2:1.0,a10g:6:0.45 (overrides --workers)")
    ap.add_argument("--cost-per-class", default=None,
                    help="$/hour per class as name[=cost],... — switches "
                    "the allocator to the cost-weighted objective")
    ap.add_argument("--stage-graph", default="off",
                    choices=sorted(TORCH_STAGES),
                    help="stage-granular micro-serving: in cluster mode "
                    "the discriminator decouples onto per-boundary disc "
                    "queues drained by the cheapest class present")
    ap.add_argument("--stage-denoise-steps", type=int, default=8,
                    help="micro stage graph: denoise steps per tier")
    ap.add_argument("--stage-preempt-frac", type=float, default=0.5,
                    help="micro stage graph: earliest preemption fraction")
    ap.add_argument("--kernel-impl", default="auto",
                    choices=sorted(TORCH_KERNEL_IMPLS) + ["auto"],
                    help="kernel route of the stages: fused (the Hopper "
                    "kernels on CUDA, their plain versions on the CPU), "
                    "unfused (per-op baseline), auto (= fused)")
    ap.add_argument("--batch-buckets", default="1,2,4,8",
                    help="batch bucket ladder samplers pad to (empty "
                    "string disables bucketing)")
    ap.add_argument("--save-quality-models", default=None,
                    help="cluster mode: persist per-boundary quality "
                    "models fitted from this run's real discriminator "
                    "confidences as JSON (core/quality.py round-trip)")
    ap.add_argument("--quality-models", default=None,
                    help="seed the control plane's deferral profiles from "
                    "a saved quality-models JSON instead of the synthetic "
                    "offline fit")
    ap.add_argument("--duration", type=int, default=90)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain "
                    "versions)")
    return ap, ap.parse_args(argv)


def main(argv=None) -> dict:
    ap, args = parse_args(argv)
    dev = resolve_device(args.device)
    wcs = (worker_classes_from_arg(args.worker_classes)
           if args.worker_classes else ())
    if args.cost_per_class and not wcs:
        ap.error("--cost-per-class requires --worker-classes")
    costs = (class_costs_from_arg(args.cost_per_class)
             if args.cost_per_class else ())
    serving = default_serving(cascade=args.cascade,
                              num_workers=args.workers,
                              worker_classes=wcs, class_costs=costs,
                              controller=args.controller,
                              estimator=args.estimator or "ewma",
                              stage_graph=args.stage_graph,
                              stage_denoise_steps=args.stage_denoise_steps,
                              stage_preempt_frac=args.stage_preempt_frac,
                              kernel_impl=args.kernel_impl,
                              batch_buckets=tuple(
                                  int(b) for b in
                                  args.batch_buckets.split(",")
                                  if b.strip()))
    spec = as_cascade_spec(serving.cascade)
    n_tiers = spec.num_tiers

    stages = []
    for i in range(n_tiers):
        # deeper tiers: wider UNet, more sampler steps (cheap -> heavy)
        cfg = DiffusionConfig(
            name=f"toy-tier{i}", image_size=16, in_channels=3,
            base_channels=16 + 8 * i, channel_mults=(1, 2),
            num_res_blocks=1 if i == 0 else 2, attn_resolutions=(),
            num_steps=max(1, round(1 + 7 * i / max(n_tiers - 1, 1))),
            text_dim=32)
        stages.append((cfg, init_unet(cfg, seed=args.seed * 1000 + i,
                                      device=dev)))

    disc_params, disc_cfg, _ = train_discriminator(
        args.seed * 1000 + n_tiers, steps=40, batch_size=16, image_size=16,
        lr=3e-3, device=dev)
    cascade = DiffusionCascade(stages, disc_cfg, disc_params, device=dev,
                               seed=args.seed)

    runtime = ClusterRuntime(cascade, serving, device=dev)
    print("measuring on-device execution profiles ...")
    prof = runtime.measure_profile(batches=(1, 2))
    print([(round(p.base_s, 4), round(p.marginal_s, 4)) for p in prof])

    # feed measured per-tier profiles into the controller and serve a trace
    tiers = tuple(dataclasses.replace(t, profile=prof[i])
                  for i, t in enumerate(spec.tiers))
    spec = dataclasses.replace(spec, tiers=tiers,
                               slo_s=max(10 * prof[-1].base_s, 1.0))
    serving = dataclasses.replace(serving, cascade=spec)
    if args.mode == "cluster" and wcs:
        # measured per-class e(b) tables (once per class present in
        # slices) replace the static GPU latency-scale table in the solver
        class_profs = runtime.measure_class_profiles(batches=(1, 2))
        serving = dataclasses.replace(
            serving, worker_classes=measured_worker_classes(serving,
                                                            class_profs))
    if args.mode == "cluster":
        # every plan batch size must already have run (measure_profile
        # ran b=1,2), so re-planning never times a first call
        serving = dataclasses.replace(serving, batch_choices=(1, 2))
        runtime = ClusterRuntime(cascade, serving, device=dev)

    # capacity in speed-weighted worker-equivalents (a10g:0.45 is not an
    # a100)
    worker_eq = (sum(wc.count * wc.speed for wc in wcs) if wcs
                 else serving.num_workers)
    cap = worker_eq / prof[0].base_s * 0.25
    trace = azure_like_trace(args.duration, seed=2).scale(
        max(cap / 8, 0.5), max(cap, 1.0))

    # one shared assembly path with run_controller: bundle fields (fixed
    # plan, allocator ablation mode, random-confidence RNG) cannot drift
    loaded_profiles = None
    if args.quality_models:
        loaded_models = load_quality_models(args.quality_models)
        loaded_profiles = tuple(m.deferral_profile() for m in loaded_models)
    bundle, profiles, fixed, control, bundle_conf = assemble_bundle(
        args.controller, trace, serving, seed=0, estimator=args.estimator,
        profiles=loaded_profiles)

    # query-agnostic bundles (Proteus) route on the bundle's random
    # confidences; the others score with the trained discriminator
    def real_conf(n):
        return cascade.confidence(np.random.default_rng(0).normal(
            size=(n, 16, 16, 3)).astype(np.float32))

    if args.mode == "cluster":
        backend = ClusterBackend(
            runtime, serving, profiles, seed=0, router=bundle.router,
            arrival_stage=bundle.arrival_stage, confidence_fn=bundle_conf,
            device=dev)
        r = backend.serve(control, trace)
    else:
        sim = Simulator(serving, profiles,
                        SimConfig(seed=0, router=bundle.router,
                                  arrival_stage=bundle.arrival_stage,
                                  fixed_plan=fixed),
                        control=control,
                        confidence_fn=bundle_conf or real_conf)
        r = sim.run(trace)

    report = {
        "mode": args.mode,
        "cascade": args.cascade,
        "controller": args.controller,
        "estimator": args.estimator or serving.estimator,
        "tiers": [t.model for t in spec.tiers],
        "workers": serving.num_workers,
        "served": r.completed, "total": r.total,
        "slo_violation_ratio": round(r.violation_ratio, 3),
        "defer_fraction": round(r.defer_fraction, 2),
        "fid_star": round(r.mean_fid, 2),
    }
    if wcs:
        report["worker_classes"] = {wc.name: {"count": wc.count,
                                              "speed": wc.speed}
                                    for wc in wcs}
        report["workers_by_class"] = r.workers_by_class
        report["class_mean_batch_latency_s"] = r.class_latency_summary()
    if args.mode == "cluster":
        if wcs:
            report["measured_class_scales"] = {
                wc.name: {m: [round(sc.base, 3), round(sc.marginal, 3)]
                          for m, sc in wc.profiles}
                for wc in serving.worker_classes}
        plans = backend.plan_timeline
        report["control_ticks"] = len(plans)
        report["distinct_plans"] = len({p[1:] for p in plans})
        report["plan_timeline_head"] = [
            {"t": round(t, 1), "workers": list(w), "batches": list(b)}
            for t, w, b in plans[:8]]
        if args.stage_graph != "off":
            report["stage_graph"] = args.stage_graph
            report["disc_class"] = backend.disc_class or "(homogeneous)"
        if args.save_quality_models:
            models = backend.fitted_quality_models()
            save_quality_models(args.save_quality_models, models)
            report["saved_quality_models"] = args.save_quality_models
            report["quality_model_samples"] = [
                len(s) for s in backend._conf_samples]
    if args.quality_models:
        report["quality_models"] = args.quality_models
    if costs and r.plan_cost_timeline:
        report["mean_cost_per_hour"] = round(r.mean_plan_cost_per_hour, 3)
    if r.cascade_timeline:
        report["cascade_switches"] = r.cascade_switches
        report["cascade_timeline"] = [[round(t, 1), n]
                                      for t, n in r.cascade_timeline]
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
