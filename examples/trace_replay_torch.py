"""Replay a dynamic trace against every baseline (paper Fig. 5) with fault
injection and a mid-run snapshot/restore — the fault-tolerance tour, on
the PyTorch port's copies of the serving stack.

The port's counterpart of ``examples/trace_replay.py``: the simulator,
baselines and faults are exact copies, so it prints what the reference
prints. Nothing here touches a device.

  PYTHONPATH=src python examples/trace_replay_torch.py
"""
import tempfile

import numpy as np

from repro_torch.serving.baselines import BASELINES, make_profile, run_baseline
from repro_torch.serving.faults import poisson_failures, restore, resume, snapshot
from repro_torch.serving.profiles import default_serving
from repro_torch.serving.simulator import SimConfig, Simulator
from repro_torch.serving.trace import azure_like_trace

serving = default_serving("sdturbo", num_workers=16)
trace = azure_like_trace(240, seed=3).scale(4, 32)

print(f"{'system':18s} {'FID*':>7s} {'SLO-viol':>9s} {'defer':>6s}")
for b in BASELINES:
    r = run_baseline(b, trace, serving, seed=0)
    print(f"{b:18s} {r.mean_fid:7.2f} {r.violation_ratio:9.3f} "
          f"{r.defer_fraction:6.2f}")

# --- fault injection: 4 worker failures + elastic scale-down ---
rng = np.random.default_rng(0)
fails = tuple(poisson_failures(rng, 16, 240.0, mtbf_s=300.0))
sim = Simulator(serving, make_profile(serving, 0),
                SimConfig(seed=0, failure_times=fails,
                          scale_events=((120.0, 12),)))
r = sim.run(trace)
print(f"\nwith {len(fails)} failures + scale-down to 12 workers:")
print(f"  completed {r.completed}/{r.total}, violations "
      f"{r.violation_ratio:.3f}, requeued {r.requeued_on_failure}, "
      f"hedged {r.hedged}")

# --- checkpoint/restart determinism ---
snap = tempfile.mktemp(suffix=".snap")
sim2 = Simulator(serving, make_profile(serving, 0), SimConfig(seed=7))
arrivals = trace.arrivals(sim2.rng)
sim2.result.total = len(arrivals)
from repro_torch.serving.simulator import Query
for i, t in enumerate(arrivals):
    sim2.push(float(t), sim2.ARRIVAL,
              Query(qid=i, arrival=float(t),
                    deadline=float(t) + serving.cascade.slo_s))
sim2.push(0.0, sim2.CONTROL)
sim2._apply_plan_now(first=True)
resume(sim2, end_t=120.0)
snapshot(sim2, snap)
sim3 = Simulator(serving, make_profile(serving, 0), SimConfig(seed=7))
restore(sim3, snap)
final = resume(sim3, end_t=trace.duration_s + 20, final=True)
print(f"\nsnapshot@120s -> restored run completed {final.completed} "
      f"queries, violations {final.violation_ratio:.3f} "
      "(deterministic continuation)")
