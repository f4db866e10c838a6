"""The DiffServe resource-allocation MILP (paper §3.3), generalized from
the paper's light/heavy pair to an N-tier cascade, with an exact solver.

For an ordered cascade of tiers 0..N-1 (tier 0 sees every query, each
boundary i defers a query-aware fraction f_i(t_i) of tier i's load to
tier i+1):

    max_{x, b, t}  (t_0, t_1, ..., t_{N-2})        lexicographic
    s.t.  sum_i e_i(b_i) + q_i + disc_i  <=  SLO          (latency, Eq.1)
          x_0 * T_0(b_0)  >=  λD                          (Eq.2)
          x_{i+1} * T_{i+1}(b_{i+1})  >=  λ_i * f_i(t_i)  (Eq.3, per tier)
          sum_i x_i       <=  S                           (Eq.4)
    with  λ_0 = λD,  λ_{i+1} = λ_i * f_i(t_i).

Decision space: b_i from small discrete sets; x_i integers; t_i in [0,1].
Because each f_i is monotone non-decreasing, the optimal thresholds for a
fixed batch tuple close tier-by-tier: t_i is found exactly by inverting
f_i at the residual downstream capacity, then tier i+1's worker count is
the capacity ceiling for the deferred load. Full enumeration over batch
tuples therefore gives the global optimum; the paper's two-tier solver is
the N=2 special case (``two_tier_reference``, property-tested). A generic
branch-and-bound solver (core/bnb.py) cross-checks the integer parts.

PyTorch-port copy of ``repro/core/milp.py`` (framework-free; imports
rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.config.base import (CascadeConfig, CascadeSpec,
                                     ServingConfig, WorkerClass,
                                     as_cascade_spec, as_worker_class,
                                     tier_rho)
from repro_torch.core.confidence import DeferralProfile


@dataclasses.dataclass(frozen=True)
class AllocationPlan:
    """Per-tier allocation vectors: ``workers[i]`` workers run tier i with
    batch size ``batches[i]``; ``thresholds[i]`` gates boundary i->i+1.

    Heterogeneous plans additionally carry ``class_workers[i]``, the
    per-worker-class split of ``workers[i]`` (name -> count; classes with
    zero workers are omitted). ``class_workers`` is ``None`` for
    homogeneous plans.
    """
    workers: Tuple[int, ...]
    batches: Tuple[int, ...]
    thresholds: Tuple[float, ...]
    expected_latency: float
    feasible: bool
    solve_ms: float = 0.0
    objective: float = -1.0
    class_workers: Optional[Tuple[Mapping[str, int], ...]] = None
    # $/hour of the chosen assignment (only when the solver was given
    # per-class costs); the cost-weighted objective's tie-break value
    cost: Optional[float] = None
    # per-tier per-stage worker split (serving/microserve.py): only set
    # when the solver was handed a StageGraph — the stage engine plans
    # stage fleets from it, not just tier fleets. None for tier-level
    # plans (the classic path, bit-identical).
    stage_workers: Optional[Tuple[Tuple[int, ...], ...]] = None

    def cost_per_query(self, demand_qps: float) -> Optional[float]:
        """$/query at the given demand (cost rate / arrival rate)."""
        if self.cost is None or demand_qps <= 0:
            return None
        return self.cost / 3600.0 / demand_qps

    @property
    def num_tiers(self) -> int:
        return len(self.workers)

    @property
    def total_workers(self) -> int:
        return sum(self.workers)

    # ------- two-tier accessors (legacy call sites / tests) -------
    @property
    def x1(self) -> int:
        return self.workers[0]

    @property
    def x2(self) -> int:
        return self.workers[1] if len(self.workers) > 1 else 0

    @property
    def b1(self) -> int:
        return self.batches[0]

    @property
    def b2(self) -> int:
        return self.batches[1] if len(self.batches) > 1 else self.batches[0]

    @property
    def threshold(self) -> float:
        return self.thresholds[0] if self.thresholds else 1.0


@dataclasses.dataclass
class Telemetry:
    """Controller inputs gathered from workers each tick: per-tier queue
    lengths and arrival-rate estimates (index = tier)."""
    demand_qps: float
    queues: Tuple[float, ...] = ()
    arrivals: Tuple[float, ...] = ()
    live_workers: int = 0
    live_by_class: Tuple[Tuple[str, int], ...] = ()   # (class, alive count)
    # split drop taxonomy (serving/admission.py): cumulative counters so
    # controllers can tell door-shedding from deadline pathology
    shed_admission: int = 0
    dropped_predictive: int = 0
    dropped_deadline: int = 0

    # ------- two-tier accessors -------
    @property
    def queue_light(self) -> float:
        return self.queues[0] if self.queues else 0.0

    @property
    def queue_heavy(self) -> float:
        return self.queues[1] if len(self.queues) > 1 else 0.0

    @property
    def arrival_light_qps(self) -> float:
        return self.arrivals[0] if self.arrivals else 0.0

    @property
    def arrival_heavy_qps(self) -> float:
        return self.arrivals[1] if len(self.arrivals) > 1 else 0.0


def queuing_delay(queue_len: float, arrival_qps: float) -> float:
    """Little's law: W = L / λ (paper Eq. before Eq.1)."""
    if arrival_qps <= 1e-9:
        return 0.0
    return queue_len / arrival_qps


def _pad(vals: Optional[Sequence[float]], n: int) -> Tuple[float, ...]:
    out = tuple(float(v) for v in (vals or ()))
    return (out + (0.0,) * n)[:n]


def _with_stage_split(plan: AllocationPlan, stage_graph,
                      spec) -> AllocationPlan:
    """Per-stage allocation mode: attach the stage graph's waterfill
    split of the tier-level worker counts (duck-typed — the graph lives
    in serving/microserve.py; core stays serving-free)."""
    if stage_graph is None or plan.stage_workers is not None:
        return plan
    return dataclasses.replace(
        plan, stage_workers=stage_graph.split_workers(
            spec, plan.batches, plan.workers))


def solve_cascade(
    cascade: "CascadeSpec | CascadeConfig",
    serving: ServingConfig,
    profiles: Sequence[DeferralProfile],
    demand_qps: float,
    *,
    num_workers: Optional[int] = None,
    queues: Optional[Sequence[float]] = None,
    arrivals: Optional[Sequence[float]] = None,
    queuing_model: str = "littles_law",   # | "proteus_2x" (ablation)
    fixed_thresholds: Optional[Sequence[float]] = None,
    fixed_batches: Optional[Sequence[int]] = None,
    stage_graph=None,
) -> AllocationPlan:
    """Exact N-tier solver: enumerate batch tuples, close the integer
    worker counts and deferral thresholds tier-by-tier from residual
    capacity (see module docstring). ``stage_graph`` (a
    serving/microserve.py ``StageGraph``) additionally splits each
    tier's workers into per-stage fleets on the returned plan."""
    t0 = time.perf_counter()
    spec = as_cascade_spec(cascade)
    if isinstance(profiles, DeferralProfile):
        profiles = [profiles]
    n = spec.num_tiers
    if len(profiles) < spec.num_boundaries:
        raise ValueError(f"{spec.name}: need {spec.num_boundaries} deferral "
                         f"profiles, got {len(profiles)}")
    S = num_workers if num_workers is not None else serving.num_workers
    lam_D = serving.overprovision * max(demand_qps, 1e-9)
    queues = _pad(queues, n)
    arrivals = _pad(arrivals, n)
    profs = [spec.tiers[i].profile for i in range(n)]
    rhos = [tier_rho(spec, serving, i) for i in range(n)]
    discs = [spec.tiers[i].disc_latency_s if i < n - 1 else 0.0
             for i in range(n)]
    disc_total = sum(discs)
    drains = [q / max(spec.slo_s, 1e-9) for q in queues]

    if fixed_thresholds is not None and \
            len(fixed_thresholds) != spec.num_boundaries:
        raise ValueError(f"{spec.name}: fixed_thresholds needs "
                         f"{spec.num_boundaries} entries (one per "
                         f"boundary), got {len(fixed_thresholds)}")
    if fixed_batches is not None:
        if len(fixed_batches) != n:
            raise ValueError(f"{spec.name}: fixed_batches needs {n} "
                             f"entries (one per tier), got "
                             f"{len(fixed_batches)}")
        batch_tuples = [tuple(fixed_batches)]
    else:
        batch_tuples = itertools.product(
            *[spec.tier_batch_choices(i, serving.batch_choices)
              for i in range(n)])

    best: Optional[AllocationPlan] = None
    for batches in batch_tuples:
        if queuing_model == "littles_law":
            qd = [queuing_delay(queues[0], max(arrivals[0], lam_D))]
            qd += [queuing_delay(queues[i], arrivals[i]) if queues[i] else 0.0
                   for i in range(1, n)]
        else:                               # Proteus heuristic (ablation)
            qd = [2 * profs[i].exec_latency(batches[i]) for i in range(n)]
        latency = sum(profs[i].exec_latency(batches[i])
                      for i in range(n)) + sum(qd) + disc_total
        if latency > spec.slo_s:
            continue
        if any(spec.tiers[i].slo_budget_s is not None
               and profs[i].exec_latency(batches[i]) + discs[i]
               > spec.tiers[i].slo_budget_s + 1e-12 for i in range(n)):
            continue                    # a tier blows its SLO budget
        # utilization caps keep queues stable (ρ<1 — Little's law blows up
        # at ρ=1); backlog drains within one SLO window
        x0 = max(int(math.ceil(
            (lam_D / rhos[0] + drains[0])
            / profs[0].throughput(batches[0]))), 1)
        if x0 > S:
            continue
        residual = S - x0
        workers = [x0]
        thresholds = []
        lam = lam_D
        ok = True
        for b in range(spec.num_boundaries):
            j = b + 1                        # tier fed by boundary b
            eff_T = profs[j].throughput(batches[j]) * rhos[j]
            drain = drains[j]
            if fixed_thresholds is not None:
                t = fixed_thresholds[b]
                need = lam * profiles[b].f(t) + drain
                x = int(math.ceil(need / eff_T)) if need > 0 else 0
                if x > residual:
                    ok = False
                    break
            else:
                # largest t whose deferred load fits the residual capacity
                cap_frac = max(residual * eff_T - drain, 0.0) / max(lam, 1e-12)
                t = profiles[b].inverse(cap_frac)
                x = int(math.ceil((lam * profiles[b].f(t) + drain) / eff_T)) \
                    if profiles[b].f(t) > 0 or drain > 0 else 0
                x = min(x, residual)
            workers.append(x)
            thresholds.append(t)
            residual -= x
            lam = lam * profiles[b].f(t)
        if not ok:
            continue
        cand = AllocationPlan(workers=tuple(workers), batches=tuple(batches),
                              thresholds=tuple(thresholds),
                              expected_latency=latency, feasible=True,
                              objective=thresholds[0])
        if (best is None or cand.thresholds > best.thresholds
                or (cand.thresholds == best.thresholds
                    and cand.total_workers < best.total_workers)):
            best = cand

    ms = (time.perf_counter() - t0) * 1e3
    if best is None:
        # infeasible: degrade to all-tier-0 at max batch (SLO-pressure mode)
        batches = tuple(max(spec.tier_batch_choices(i, serving.batch_choices))
                        for i in range(n))
        x0 = min(S, max(int(math.ceil(
            lam_D / profs[0].throughput(batches[0]))), 1))
        workers = (x0, max(S - x0, 0)) + (0,) * (n - 2)
        return _with_stage_split(
            AllocationPlan(workers=workers, batches=batches,
                           thresholds=(0.0,) * spec.num_boundaries,
                           expected_latency=profs[0].exec_latency(
                               batches[0]),
                           feasible=False, solve_ms=ms, objective=0.0),
            stage_graph, spec)
    return _with_stage_split(dataclasses.replace(best, solve_ms=ms),
                             stage_graph, spec)


def solve_allocation(
    cascade: "CascadeSpec | CascadeConfig",
    serving: ServingConfig,
    profile: "DeferralProfile | Sequence[DeferralProfile]",
    demand_qps: float,
    *,
    num_workers: Optional[int] = None,
    queue_light: float = 0.0,
    queue_heavy: float = 0.0,
    arrival_light: float = 0.0,
    arrival_heavy: float = 0.0,
    queuing_model: str = "littles_law",
    fixed_threshold: Optional[float] = None,
    fixed_batches: Optional[Tuple[int, int]] = None,
) -> AllocationPlan:
    """Two-tier-shaped wrapper over ``solve_cascade`` (N=2 legacy entry
    point; scalar telemetry kwargs map onto the first two tiers)."""
    spec = as_cascade_spec(cascade)
    profiles = ([profile] if isinstance(profile, DeferralProfile)
                else list(profile))
    fixed_ts = None
    if fixed_threshold is not None:
        fixed_ts = (fixed_threshold,) * spec.num_boundaries
    return solve_cascade(
        spec, serving, profiles, demand_qps, num_workers=num_workers,
        queues=(queue_light, queue_heavy), arrivals=(arrival_light,
                                                     arrival_heavy),
        queuing_model=queuing_model, fixed_thresholds=fixed_ts,
        fixed_batches=fixed_batches)


def two_tier_reference(
    cascade: "CascadeSpec | CascadeConfig",
    serving: ServingConfig,
    profile: DeferralProfile,
    demand_qps: float,
    *,
    num_workers: Optional[int] = None,
    queue_light: float = 0.0,
    queue_heavy: float = 0.0,
    arrival_light: float = 0.0,
    arrival_heavy: float = 0.0,
    queuing_model: str = "littles_law",
    fixed_threshold: Optional[float] = None,
    fixed_batches: Optional[Tuple[int, int]] = None,
) -> AllocationPlan:
    """The paper's original two-tier closed-form solver, kept verbatim as
    the N=2 reference implementation (property-tested against
    ``solve_cascade``). Do not extend — extend ``solve_cascade``."""
    t0 = time.perf_counter()
    spec = as_cascade_spec(cascade)
    S = num_workers if num_workers is not None else serving.num_workers
    lam_D = serving.overprovision * max(demand_qps, 1e-9)
    e1 = spec.light_profile.exec_latency
    e2 = spec.heavy_profile.exec_latency
    T1 = spec.light_profile.throughput
    T2 = spec.heavy_profile.throughput

    best: Optional[AllocationPlan] = None
    batch_pairs = ([fixed_batches] if fixed_batches else
                   [(a, b) for a in serving.batch_choices
                    for b in serving.batch_choices])

    for b1, b2 in batch_pairs:
        if queuing_model == "littles_law":
            q1 = queuing_delay(queue_light, max(arrival_light, lam_D))
            q2 = queuing_delay(queue_heavy, max(arrival_heavy, 1e-9)) \
                if queue_heavy else 0.0
        else:
            q1, q2 = 2 * e1(b1), 2 * e2(b2)
        latency = e1(b1) + q1 + e2(b2) + q2 + spec.disc_latency_s
        if latency > spec.slo_s:
            continue
        drain1 = queue_light / max(spec.slo_s, 1e-9)
        drain2 = queue_heavy / max(spec.slo_s, 1e-9)
        x1 = max(int(math.ceil(
            (lam_D / serving.rho_light + drain1) / T1(b1))), 1)
        if x1 > S:
            continue
        remaining = S - x1
        eff_T2 = T2(b2) * serving.rho_heavy
        if fixed_threshold is not None:
            t = fixed_threshold
            need2 = lam_D * profile.f(t) + drain2
            x2 = int(math.ceil(need2 / eff_T2)) if need2 > 0 else 0
            if x2 > remaining:
                continue
        else:
            cap_frac = max(remaining * eff_T2 - drain2, 0.0) / lam_D
            t = profile.inverse(cap_frac)
            x2 = int(math.ceil((lam_D * profile.f(t) + drain2) / eff_T2)) \
                if profile.f(t) > 0 or drain2 > 0 else 0
            x2 = min(x2, remaining)
        cand = AllocationPlan(workers=(x1, x2), batches=(b1, b2),
                              thresholds=(t,), expected_latency=latency,
                              feasible=True, objective=t)
        if (best is None or cand.objective > best.objective
                or (cand.objective == best.objective
                    and cand.total_workers < best.total_workers)):
            best = cand

    ms = (time.perf_counter() - t0) * 1e3
    if best is None:
        b1 = max(serving.batch_choices)
        x1 = min(S, max(int(math.ceil(lam_D / T1(b1))), 1))
        return AllocationPlan(workers=(x1, max(S - x1, 0)),
                              batches=(b1, max(serving.batch_choices)),
                              thresholds=(0.0,), expected_latency=e1(b1),
                              feasible=False, solve_ms=ms, objective=0.0)
    return dataclasses.replace(best, solve_ms=ms)


def solve_heterogeneous(
    cascade: "CascadeSpec | CascadeConfig",
    serving: ServingConfig,
    profile: DeferralProfile,
    demand_qps: float,
    classes: Dict[str, Tuple[int, float]],
    threshold_grid: int = 41,
) -> Dict[str, object]:
    """Heterogeneous-cluster extension (paper §5): worker classes c with
    (count_c, speed_c). Solved as a true MILP via core/bnb.py:
      max t  ≅  for t on a grid: feasibility ILP over x_{model,class}.
    Returns the best feasible plan (first/last tier of the cascade)."""
    from repro_torch.core.bnb import MILP, solve_milp
    import numpy as np

    if threshold_grid < 2:
        raise ValueError(f"threshold_grid must be >= 2 points, got "
                         f"{threshold_grid}")
    spec = as_cascade_spec(cascade)
    names = sorted(classes)
    counts = [classes[c][0] for c in names]
    speeds = [classes[c][1] for c in names]
    lam_D = serving.overprovision * max(demand_qps, 1e-9)
    best = None
    for k in range(threshold_grid - 1, -1, -1):
        t = k / (threshold_grid - 1)
        need2 = lam_D * profile.f(t)
        # vars: x1_c..., x2_c...  minimize total workers subject to capacity
        n = len(names)
        b1 = max(serving.batch_choices)
        b2 = max(serving.batch_choices)
        T1 = spec.light_profile.throughput(b1)
        T2 = spec.heavy_profile.throughput(b2)
        c_obj = np.ones(2 * n)
        A, rhs = [], []
        # -sum(x1_c * T1 * speed_c) <= -lam_D
        A.append([-T1 * s for s in speeds] + [0.0] * n)
        rhs.append(-lam_D)
        A.append([0.0] * n + [-T2 * s for s in speeds])
        rhs.append(-need2)
        for i in range(n):                       # class capacity
            row = [0.0] * (2 * n)
            row[i] = 1.0
            row[n + i] = 1.0
            A.append(row)
            rhs.append(counts[i])
        sol = solve_milp(MILP(c=c_obj, A_ub=np.array(A), b_ub=np.array(rhs),
                              integer=list(range(2 * n)),
                              upper=np.array(counts + counts, float)))
        if sol.status == "optimal":
            best = {"threshold": t,
                    "x1": {names[i]: int(round(sol.x[i])) for i in range(n)},
                    "x2": {names[i]: int(round(sol.x[n + i]))
                           for i in range(n)},
                    "objective": t, "feasible": True}
            break
    # explicit infeasibility flag: callers must not mistake the empty
    # fallback for a legitimate zero-threshold plan
    return best or {"threshold": 0.0, "x1": {}, "x2": {}, "objective": 0.0,
                    "feasible": False}


# ---------------------------------------------------------------------------
# N-tier heterogeneous allocation (paper §5 generalized)
# ---------------------------------------------------------------------------
def _normalize_classes(serving: ServingConfig,
                       classes) -> "Dict[str, WorkerClass]":
    """Resolve the worker-class table to ``{name: WorkerClass}`` (full
    per-class latency profiles): explicit arg > ServingConfig > single
    unit-speed class. Mapping values may be ``WorkerClass``es, ``(count,
    speed)`` pairs, or ``(count, speed, profiles)`` triples; mapping form
    is sorted by name for determinism, WorkerClass tuples keep their
    declared order."""
    if classes is None:
        return serving.class_map()
    if isinstance(classes, Mapping):
        return {c: as_worker_class(c, classes[c]) for c in sorted(classes)}
    return {wc.name: wc for wc in classes}


def _tier_budgets(spec: CascadeSpec, profs, discs, batches,
                  qd_total: float) -> Optional[Sequence[float]]:
    """Per-tier latency budgets for one batch tuple.

    Explicitly budgeted tiers keep their ``slo_budget_s`` (a per-tier
    cap, independent of the transient queuing delay — mirroring
    ``solve_cascade``, which checks budgets and the queue-inclusive SLO
    separately). When every tier is budgeted, CascadeSpec validation
    (budgets sum <= slo) bounds the worst-case path and only the
    reference-latency SLO check remains. Otherwise unbudgeted tiers
    split the leftover slack proportionally to their reference latency,
    with each budgeted tier consuming ``max(budget, reference)`` from
    that slack so the derived caps can never push the worst-case path
    past the SLO, even when a budget grants a tier more room than its
    reference latency. ``None`` when no split exists. With a single
    unit-speed class and no explicit budgets this reduces exactly to the
    homogeneous check ``sum_i e_i(b_i) + disc + qd <= slo``."""
    n = spec.num_tiers
    ell = [profs[i].exec_latency(batches[i]) + discs[i] for i in range(n)]
    fixed = [spec.tiers[i].slo_budget_s for i in range(n)]
    unset = [i for i in range(n) if fixed[i] is None]
    if not unset:
        ok = spec.slo_s - qd_total - sum(ell) >= -1e-12
        return fixed if ok else None
    slack = spec.slo_s - qd_total - sum(max(fixed[i], ell[i])
                                        for i in range(n)
                                        if fixed[i] is not None)
    if slack <= 0:
        return None
    scale = slack / sum(ell[i] for i in unset)
    return [fixed[i] if fixed[i] is not None else ell[i] * scale
            for i in range(n)]


def _solve_assignment(coefs, reqs, counts, elig, *, maximize_tier=None,
                      pinned=None, weights=None):
    """Class-assignment ILP over x[tier][class] (core/bnb.py).

    ``coefs[i][c]``: capacity one class-c worker contributes to tier i;
    ``reqs[i]``: required capacity (rows emitted only when > 0);
    ``elig[i]``: eligible class indices (others pinned to 0);
    ``pinned``: {tier: per-class counts} rows frozen to exact values
    (drain-dominated tiers that soak up all spare capacity);
    ``weights``: per-class objective weights for the minimize direction
    ($/hour — the cost-weighted objective), default 1 per worker.
    Minimizes total weight, or maximizes tier ``maximize_tier``'s
    capacity. Returns the integer x matrix, or None when infeasible.
    """
    from repro_torch.core.bnb import MILP, solve_milp
    import numpy as np

    nt, nc = len(coefs), len(counts)
    nv = nt * nc
    pinned = pinned or {}
    A, rhs = [], []
    for i in range(nt):
        if i < len(reqs) and reqs[i] > 0 and i not in pinned:
            row = [0.0] * nv
            for c in range(nc):
                row[i * nc + c] = -coefs[i][c]
            A.append(row)
            rhs.append(-reqs[i])
    for c in range(nc):                      # class inventory
        row = [0.0] * nv
        for i in range(nt):
            row[i * nc + c] = 1.0
        A.append(row)
        rhs.append(counts[c])
    upper = np.zeros(nv)
    lower = np.zeros(nv)
    for i in range(nt):
        for c in elig[i]:
            upper[i * nc + c] = counts[c]
    for i, row in pinned.items():
        if i >= nt:
            continue
        for c in range(nc):
            upper[i * nc + c] = row[c]
            lower[i * nc + c] = row[c]
    if maximize_tier is None:
        c_obj = np.ones(nv)
        if weights is not None:
            # put $/hour weights on an integer lattice when a power-of-ten
            # scale makes them exact (4.10 -> 410 cents): the argmin is
            # unchanged and bnb's objective-lattice pruning kicks in
            ws = list(weights)
            for scale in (1.0, 10.0, 100.0, 1e4, 1e6):
                scaled_w = [w * scale for w in weights]
                if all(abs(v - round(v)) < 1e-9 * max(scale, 1.0)
                       for v in scaled_w):
                    ws = [float(round(v)) for v in scaled_w]
                    break
            for i in range(nt):
                for c in range(nc):
                    c_obj[i * nc + c] = ws[c]
    else:
        c_obj = np.zeros(nv)
        for c in range(nc):
            c_obj[maximize_tier * nc + c] = -coefs[maximize_tier][c]
    prob = MILP(c=np.asarray(c_obj), A_ub=np.asarray(A, float),
                b_ub=np.asarray(rhs, float),
                integer=list(range(nv)), upper=upper, lower=lower)
    seed = None
    if maximize_tier is None and weights is not None:
        # the $-weighted relaxation is highly fractional and branches
        # deep; a fast min-worker solve (near-integral relaxation) gives
        # a feasible incumbent so the weighted search prunes from node 1
        warm = solve_milp(dataclasses.replace(prob, c=np.ones(nv)))
        if warm.status == "optimal":
            seed = warm.x
    sol = solve_milp(prob, incumbent=seed)
    if sol.status != "optimal":
        return None
    return [[int(round(sol.x[i * nc + c])) for c in range(nc)]
            for i in range(nt)]


def solve_heterogeneous_cascade(
    cascade: "CascadeSpec | CascadeConfig",
    serving: ServingConfig,
    profiles: Sequence[DeferralProfile],
    demand_qps: float,
    *,
    classes=None,
    queues: Optional[Sequence[float]] = None,
    arrivals: Optional[Sequence[float]] = None,
    queuing_model: str = "littles_law",
    fixed_thresholds: Optional[Sequence[float]] = None,
    fixed_batches: Optional[Sequence[int]] = None,
    threshold_grid: Optional[int] = None,
    class_costs: Optional[Mapping[str, float]] = None,
    stage_graph=None,
) -> AllocationPlan:
    """Exact N-tier heterogeneous solver (paper §5 generalized from the
    hardwired light/heavy pair): an ILP over ``x[tier][class]`` with
    per-class latency profiles, per-tier batch search, and per-tier SLO
    budgets.

    For each batch tuple, boundaries close tier-by-tier exactly as in
    ``solve_cascade``: maximize the next tier's deliverable capacity (a
    small ILP over the class inventory, holding upstream requirements),
    invert the deferral profile at that capacity, then fix the deferred
    load and move one tier deeper. A final ILP minimizes total workers at
    the chosen thresholds. With a single unit-speed class this reproduces
    ``solve_cascade`` decision-for-decision (property-tested); at N=2 with
    pinned batches and ``threshold_grid`` it reproduces the legacy
    ``solve_heterogeneous`` grid solver (property-tested).

    ``classes``: ``{name: WorkerClass | (count, speed[, profiles])}`` or
    WorkerClass tuple; default is ``serving.worker_classes`` (or one
    unit-speed class). Each class's per-model ``LatencyScale`` overrides
    give it its own ``(base, marginal)`` latency curve per tier — batch-1
    and marginal cost scale independently, so the optimal batch size now
    interacts with the class mix — with plain ``speed`` classes falling
    back to the uniform ``e(b)/speed`` scaling. A class is eligible for
    a tier only if its scaled (exec + discriminator) latency fits the
    tier's SLO budget.

    ``class_costs``: optional ``{name: $/hour}``. When present (or set on
    ``serving.class_costs``), threshold ties break by dollar cost instead
    of worker count and the final assignment ILP minimizes $/hour; the
    returned plan carries ``cost`` (and ``cost_per_query(demand)``).
    """
    t0 = time.perf_counter()
    spec = as_cascade_spec(cascade)
    if isinstance(profiles, DeferralProfile):
        profiles = [profiles]
    n = spec.num_tiers
    if len(profiles) < spec.num_boundaries:
        raise ValueError(f"{spec.name}: need {spec.num_boundaries} deferral "
                         f"profiles, got {len(profiles)}")
    table = _normalize_classes(serving, classes)
    names = list(table)
    wcs = [table[c] for c in names]
    counts = [wc.count for wc in wcs]
    S = sum(counts)
    if class_costs is None and serving.class_costs:
        # the caller may pass a live (failure-shrunken) class table; a
        # class that died out of it entirely has no workers to price, so
        # drop its entry instead of raising mid-run
        class_costs = {c: v for c, v in serving.class_costs if c in table}
    costs = None
    if class_costs:
        unknown = [c for c in class_costs if c not in table]
        if unknown:
            raise ValueError(f"class_costs names {unknown} not in class "
                             f"table {names}")
        missing = [c for c in names if c not in class_costs]
        if missing:
            # a $0 default would make the class free to the minimizing
            # objective and silently under-report plan.cost
            raise ValueError(f"class_costs missing prices for {missing}; "
                             f"every class in the table must be priced")
        costs = [float(class_costs[c]) for c in names]
    lam_D = serving.overprovision * max(demand_qps, 1e-9)
    queues = _pad(queues, n)
    arrivals = _pad(arrivals, n)
    profs = [spec.tiers[i].profile for i in range(n)]
    rhos = [tier_rho(spec, serving, i) for i in range(n)]
    discs = [spec.tiers[i].disc_latency_s if i < n - 1 else 0.0
             for i in range(n)]
    disc_total = sum(discs)
    drains = [q / max(spec.slo_s, 1e-9) for q in queues]

    if fixed_thresholds is not None and \
            len(fixed_thresholds) != spec.num_boundaries:
        raise ValueError(f"{spec.name}: fixed_thresholds needs "
                         f"{spec.num_boundaries} entries (one per "
                         f"boundary), got {len(fixed_thresholds)}")
    if threshold_grid is not None and threshold_grid < 2:
        raise ValueError(f"threshold_grid must be >= 2 points, got "
                         f"{threshold_grid}")
    if fixed_batches is not None:
        if len(fixed_batches) != n:
            raise ValueError(f"{spec.name}: fixed_batches needs {n} "
                             f"entries (one per tier), got "
                             f"{len(fixed_batches)}")
        batch_tuples = [tuple(fixed_batches)]
    else:
        batch_tuples = itertools.product(
            *[spec.tier_batch_choices(i, serving.batch_choices)
              for i in range(n)])

    # per-(tier, class) latency curves: each class runs tier i's model
    # under its own (base, marginal) scaling; uniform 1/speed without
    # explicit overrides
    scaled = [[wc.tier_profile(spec.tiers[i]) for wc in wcs]
              for i in range(n)]
    disc_scale = [[wc.scale_for(spec.tiers[i].model).base for wc in wcs]
                  for i in range(n)]

    best: Optional[AllocationPlan] = None
    for batches in batch_tuples:
        if queuing_model == "littles_law":
            qd = [queuing_delay(queues[0], max(arrivals[0], lam_D))]
            qd += [queuing_delay(queues[i], arrivals[i]) if queues[i] else 0.0
                   for i in range(1, n)]
        else:                               # Proteus heuristic (ablation)
            qd = [2 * profs[i].exec_latency(batches[i]) for i in range(n)]
        latency = sum(profs[i].exec_latency(batches[i])
                      for i in range(n)) + sum(qd) + disc_total
        budgets = _tier_budgets(spec, profs, discs, batches, sum(qd))
        if budgets is None:
            continue
        # the discriminator runs on the worker too (a fixed-cost model
        # run, so it scales with the class's batch-1 base scale; matches
        # Simulator._profiled_latency)
        elig = [[c for c in range(len(names))
                 if scaled[i][c].exec_latency(batches[i])
                 + discs[i] * disc_scale[i][c] <= budgets[i] + 1e-9]
                for i in range(n)]
        if not elig[0]:
            continue
        # capacity coefficients: tier 0 is constrained in raw-throughput
        # units (lam/rho + drain, matching solve_cascade); deferred tiers
        # in rho-derated units
        coefs = [[scaled[0][c].throughput(batches[0])
                  for c in range(len(names))]]
        coefs += [[scaled[j][c].throughput(batches[j]) * rhos[j]
                   for c in range(len(names))] for j in range(1, n)]
        reqs = [lam_D / rhos[0] + drains[0]]
        thresholds = []
        pinned: Dict[int, list] = {}
        lam = lam_D
        ok = True
        for b in range(spec.num_boundaries):
            j = b + 1
            drain = drains[j]
            if fixed_thresholds is not None:
                t = fixed_thresholds[b]
                need = lam * profiles[b].f(t) + drain
                reqs.append(need if profiles[b].f(t) > 0 or drain > 0
                            else 0.0)
            else:
                x = _solve_assignment(coefs[:j + 1], reqs, counts,
                                      elig[:j + 1], maximize_tier=j,
                                      pinned=pinned)
                if x is None:           # upstream tiers unservable
                    ok = False
                    break
                cap = sum(x[j][c] * coefs[j][c] for c in range(len(names)))
                cap_frac = max(cap - drain, 0.0) / max(lam, 1e-12)
                if threshold_grid:
                    t = 0.0
                    for k in range(threshold_grid - 1, -1, -1):
                        tk = k / (threshold_grid - 1)
                        if lam * profiles[b].f(tk) + drain <= cap + 1e-12:
                            t = tk
                            break
                else:
                    t = profiles[b].inverse(cap_frac)
                need = lam * profiles[b].f(t) + drain
                E = need if profiles[b].f(t) > 0 or drain > 0 else 0.0
                if E > cap:
                    # drain-dominated tier: the backlog outstrips all
                    # spare capacity; throw every leftover worker at it
                    # (mirrors solve_cascade's min(x, residual) clamp)
                    pinned[j] = x[j]
                    reqs.append(0.0)
                else:
                    reqs.append(E)
            thresholds.append(t)
            lam = lam * profiles[b].f(t)
        if not ok:
            continue
        # thresholds are fixed by the tier-by-tier closing above, before
        # the final assignment ILP runs — so a tuple that already loses
        # the lexicographic threshold comparison can never become the
        # plan, and skipping its (expensive, $-weighted) assignment solve
        # changes nothing
        if best is not None and tuple(thresholds) < best.thresholds:
            continue
        x = _solve_assignment(coefs, reqs, counts, elig, pinned=pinned,
                              weights=costs)
        if x is None:                   # fixed thresholds may not fit
            continue
        workers = tuple(sum(row) for row in x)
        class_workers = tuple(
            {names[c]: row[c] for c in range(len(names)) if row[c] > 0}
            for row in x)
        cand = AllocationPlan(workers=workers, batches=tuple(batches),
                              thresholds=tuple(thresholds),
                              expected_latency=latency, feasible=True,
                              objective=thresholds[0],
                              class_workers=class_workers,
                              cost=sum(x[i][c] * costs[c]
                                       for i in range(n)
                                       for c in range(len(names)))
                              if costs is not None else None)
        # lexicographic thresholds first (quality); ties break by dollar
        # cost when costs are given, else by worker count
        if best is None or cand.thresholds > best.thresholds:
            best = cand
        elif cand.thresholds == best.thresholds:
            if costs is not None and cand.cost != best.cost:
                if cand.cost < best.cost:
                    best = cand
            elif cand.total_workers < best.total_workers:
                best = cand

    ms = (time.perf_counter() - t0) * 1e3
    if best is None:
        # infeasible: degrade like solve_cascade — enough workers on tier 0
        # for the raw demand at max batch, the rest on tier 1 (SLO-pressure
        # mode), with the explicit feasible=False flag
        batches = tuple(max(spec.tier_batch_choices(i, serving.batch_choices))
                        for i in range(n))
        x0 = min(S, max(int(math.ceil(
            lam_D / profs[0].throughput(batches[0]))), 1))
        workers = (x0, max(S - x0, 0)) + (0,) * (n - 2)
        class_workers = [dict() for _ in range(n)]
        left = x0
        # fastest classes (by scaled tier-0 batch latency) on tier 0 first
        order = sorted(names, key=lambda c: table[c].tier_profile(
            spec.tiers[0]).exec_latency(batches[0]))
        for c in order:
            take = min(table[c].count, left)
            if take:
                class_workers[0][c] = take
            spill = table[c].count - take
            if spill and n > 1:
                class_workers[1][c] = class_workers[1].get(c, 0) + spill
            left -= take
        fb_cost = None
        if costs is not None:
            fb_cost = sum(alloc.get(names[c], 0) * costs[c]
                          for alloc in class_workers
                          for c in range(len(names)))
        return _with_stage_split(
            AllocationPlan(workers=workers, batches=batches,
                           thresholds=(0.0,) * spec.num_boundaries,
                           expected_latency=profs[0].exec_latency(
                               batches[0]),
                           feasible=False, solve_ms=ms, objective=0.0,
                           class_workers=tuple(class_workers),
                           cost=fb_cost),
            stage_graph, spec)
    return _with_stage_split(dataclasses.replace(best, solve_ms=ms),
                             stage_graph, spec)


def plan_tier_latencies(cascade: "CascadeSpec | CascadeConfig",
                        plan: AllocationPlan,
                        classes=None,
                        serving: Optional[ServingConfig] = None
                        ) -> "list[Optional[float]]":
    """Worst-case execution latency (exec + discriminator) per tier under
    ``plan``: the slowest worker class actually assigned to each tier,
    evaluated through that class's per-model latency scales. ``None`` for
    tiers with no workers. Unit speeds when the plan carries no class
    split."""
    spec = as_cascade_spec(cascade)
    table = None
    if classes is not None or (serving is not None
                               and serving.worker_classes):
        # serving is only consulted when classes is None, in which case
        # the condition guarantees it is present
        table = _normalize_classes(serving, classes)
    out: "list[Optional[float]]" = []
    for i in range(spec.num_tiers):
        disc = spec.tiers[i].disc_latency_s if i < spec.num_tiers - 1 else 0.0
        base = spec.tiers[i].profile.exec_latency(plan.batches[i]) + disc
        if plan.class_workers is not None and table is not None:
            assigned = [table[c] for c, k in plan.class_workers[i].items()
                        if k > 0 and c in table]
            if not assigned:
                out.append(None if plan.workers[i] == 0 else base)
                continue
            out.append(max(
                wc.tier_profile(spec.tiers[i]).exec_latency(plan.batches[i])
                + disc * wc.scale_for(spec.tiers[i].model).base
                for wc in assigned))
        else:
            out.append(base if plan.workers[i] > 0 else None)
    return out
