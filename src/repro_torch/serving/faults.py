"""Fault tolerance for the serving plane.

* ``snapshot``/``restore`` — full simulator/controller state (queues,
  in-flight work, stats, RNG, deferral profile) with atomic writes; a
  restored run continues deterministically (property-tested).
* ``FailureInjector`` — Poisson worker failures with repair times.
* Failure *detection* is heartbeat-based in the control plane (the
  ScalingPolicy calls ``Simulator.detect_faults`` at tick start);
  recovery re-enqueues lost queries and re-solves the MILP with the
  reduced worker count.

PyTorch-port copy of ``repro/serving/faults.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import List, Tuple

import numpy as np

from repro_torch.serving.simulator import Simulator


def snapshot(sim: Simulator, path: str) -> None:
    state = {
        "now": sim.now,
        "thresholds": sim.thresholds,
        "workers": sim.workers,
        "events": sim._events,
        "eid_next": next(sim._eid),
        "result": sim.result,
        "arrivals_window": sim._arrivals_window,
        "recent_defer": sim._recent_defer,
        "active_S": sim._active_S,
        # the pending arrival stream (run() keeps arrivals in a sorted
        # array + cursor, not the heap — losing these would silently
        # truncate a restored run's remaining workload)
        "arrival_times": sim._arrival_times,
        "arrival_i": sim._arrival_i,
        "slo0": sim._slo0,
        "rng_state": sim.rng.bit_generator.state,
        "profile_scores": [list(p._scores) for p in sim.profiles],
        "control": sim.control.state_dict(),
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)          # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore(sim: Simulator, path: str) -> Simulator:
    """Load a snapshot into a freshly-constructed Simulator (same configs)."""
    import itertools
    with open(path, "rb") as f:
        state = pickle.load(f)
    sim.now = state["now"]
    sim.thresholds = tuple(state["thresholds"])
    sim.workers = state["workers"]
    sim._events = state["events"]
    sim._eid = itertools.count(state["eid_next"])
    sim.result = state["result"]
    sim._arrivals_window = state["arrivals_window"]
    sim._recent_defer = state["recent_defer"]
    sim._active_S = state["active_S"]
    sim._arrival_times = state.get("arrival_times", sim._arrival_times)
    sim._arrival_i = state.get("arrival_i", sim._arrival_i)
    sim._slo0 = state.get("slo0", sim._slo0)
    sim._recount_depth()
    sim.rng.bit_generator.state = state["rng_state"]
    for p, scores in zip(sim.profiles, state["profile_scores"]):
        p._scores = scores
    sim.control.load_state(state["control"])
    return sim


def resume(sim: Simulator, end_t: float, *, final: bool = False):
    """Continue a restored simulation until the event queue drains.

    ``final=True`` runs the end-of-run unfinished-query accounting (what
    ``Simulator.run`` does); leave it off when snapshotting mid-run.
    """
    sim._run_until(end_t)
    if final:
        sim._drain_unfinished()
    return sim.result


def poisson_failures(rng: np.random.Generator, num_workers: int,
                     duration_s: float, mtbf_s: float = 600.0,
                     repair_s: Tuple[float, float] = (20.0, 60.0)
                     ) -> List[Tuple[float, int, float]]:
    """Failure schedule: exponential inter-failure times per worker."""
    events = []
    for wid in range(num_workers):
        t = float(rng.exponential(mtbf_s))
        while t < duration_s:
            dur = float(rng.uniform(*repair_s))
            events.append((t, wid, dur))
            t += dur + float(rng.exponential(mtbf_s))
    return sorted(events)
