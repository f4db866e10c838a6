"""Predictive autoscaling: a real ``ScalingPolicy`` (ROADMAP item 1).

``HeartbeatScaling`` only sweeps faults — provisioned capacity never
moves mid-run, so the paper's allocator always solves over a fixed
fleet and a demand ramp is absorbed entirely by queues.
``PredictiveScaling`` closes that loop:

  * a ``Forecaster`` (serving/forecast.py) predicts arrival rate at
    ``now + horizon`` where the horizon covers the control epoch plus
    the ``model_load_s`` lead time;
  * provisioned capacity is sized to the *forecast* via the same
    utilization-capped capacity math the solver uses (per-tier arrival
    rates cascaded through the live deferral profiles f(t));
  * per-tier warm pools keep pre-loaded standby workers on tier roles,
    so when the plan grows a tier the extra worker is already warm —
    the cold start landed *before* the ramp;
  * scale-down is damped by hysteresis (a margin below current
    capacity) and a min-dwell (consecutive low ticks) so bursts don't
    thrash the fleet, and an optional $/hour budget (GPU_CLASS_COSTS)
    caps the fleet a forecast can buy.

The policy drives backends through two *optional* capabilities —
``set_capacity(n)`` and ``prewarm(tier_counts)`` — discovered with
``getattr`` so any ``ExecutorBackend`` without them still works (the
policy just re-plans for forecast demand). Both the simulator and the
cluster backend implement them (elastic provisioning with conservation
preserved; staged slice provision/decommission).

This module is jax-free: pure control logic over census/telemetry.

PyTorch-port copy of ``repro/serving/autoscaler.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``. Registries carry the port's own names,
apart from the JAX package's for the repo linter's index: the scaler
registry is ``TORCH_SCALERS``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.serving.forecast import (Forecaster, TrailingForecaster,
                                          default_horizon_s, make_forecaster)


def required_workers(serving, demand_qps: float, profiles,
                     thresholds: Sequence[float],
                     speed: float = 1.0) -> List[int]:
    """Per-tier worker counts needed to serve ``demand_qps``: cascade
    the rate through the deferral profiles f(t) at the live thresholds,
    then size each tier at its utilization cap (rho_light for tier 0,
    rho_heavy beyond — the solver's convention) against max-batch
    throughput of a ``speed``-scaled worker."""
    tiers = serving.cascade.tiers
    batch = max(serving.batch_choices)
    rate = max(float(demand_qps), 0.0)
    counts: List[int] = []
    for i, tier in enumerate(tiers):
        rho = serving.rho_light if i == 0 else serving.rho_heavy
        unit = (tier.profile.exec_latency(batch)
                + tier.disc_latency_s * batch) / max(speed, 1e-9)
        tput = batch / unit
        counts.append(int(math.ceil(rate / max(rho * tput, 1e-9)))
                      if rate > 0 else 0)
        if i < len(profiles):
            t = thresholds[i] if i < len(thresholds) else 1.0
            rate *= profiles[i].f(t)
    return counts


def fleet_speed(serving) -> float:
    """Count-weighted mean throughput multiplier of the declared worker
    classes (1.0 for a homogeneous fleet)."""
    wcs = getattr(serving, "worker_classes", ()) or ()
    total = sum(wc.count for wc in wcs)
    if not total:
        return 1.0
    return sum(wc.count * wc.speed for wc in wcs) / total


def provisioned_cost(capacity_timeline: Sequence[Tuple[float, int]],
                     end_t: float, cost_per_slot_hour: float) -> float:
    """$-cost of a provisioned-capacity step function: integrate
    slot-seconds over [first step, end_t] and price at $/slot-hour."""
    if not capacity_timeline:
        return 0.0
    slot_seconds = 0.0
    for (t0, n), (t1, _) in zip(capacity_timeline,
                                list(capacity_timeline[1:])
                                + [(end_t, 0)]):
        slot_seconds += max(t1 - t0, 0.0) * n
    return slot_seconds / 3600.0 * cost_per_slot_hour


class PredictiveScaling:
    """Forecast-driven elastic provisioning with per-tier warm pools.

    Implements ``ScalingPolicy.on_tick`` and additionally exposes
    ``plan_demand(demand, now)`` — the control plane (when present)
    substitutes it for the trailing estimate so the allocator plans for
    demand at *enactment* time.
    """

    def __init__(self, serving, forecaster: "Forecaster | str" = None, *,
                 trace=None, horizon_s: Optional[float] = None,
                 warm_pool: int = 0, min_workers: int = 1,
                 max_workers: Optional[int] = None, down_dwell: int = 3,
                 down_margin: float = 0.15,
                 cost_budget_per_hour: Optional[float] = None,
                 cost_per_slot_hour: float = 0.0,
                 initial_demand: Optional[float] = None,
                 use_forecast_for_plan: bool = True,
                 detect_faults: bool = True):
        if forecaster is None:
            forecaster = getattr(serving, "forecaster", "holt-winters")
        if isinstance(forecaster, str):
            forecaster = make_forecaster(forecaster, serving, trace)
        self.serving = serving
        self.forecaster = forecaster
        self.horizon_s = (float(horizon_s) if horizon_s
                          else default_horizon_s(serving))
        self.warm_pool = max(int(warm_pool), 0)
        self.min_workers = max(int(min_workers), 1)
        self.max_workers = int(max_workers) if max_workers else None
        self.down_dwell = max(int(down_dwell), 1)
        self.down_margin = float(down_margin)
        self.cost_budget_per_hour = cost_budget_per_hour
        self.cost_per_slot_hour = float(cost_per_slot_hour)
        self.use_forecast_for_plan = bool(use_forecast_for_plan)
        self._detect_faults = bool(detect_faults)
        self.last_forecast: Optional[float] = None
        self._low_ticks = 0
        self._seeded = initial_demand is not None
        if self._seeded:
            # charge the seed as the t=0 observation so the first real
            # tick already extrapolates from the trace's hot start
            self.last_forecast = self.forecaster.step(
                float(initial_demand), 0.0, self.horizon_s)

    # ---- ScalingPolicy ----
    def on_tick(self, backend, census) -> None:
        if self._detect_faults:
            backend.detect_faults()
        if census.now <= 0.0:
            # provisioning tick: no arrivals observed yet; keep the
            # provisioned fleet (the seed forecast, if any, flows into
            # plan_demand instead of resizing blind)
            return
        tel = backend.telemetry_window()
        self.last_forecast = self.forecaster.step(
            tel.demand_qps, census.now, self.horizon_s)
        profiles = getattr(backend, "profiles", ())
        thresholds = getattr(backend, "thresholds", ())
        per_tier = required_workers(self.serving, self.last_forecast,
                                    profiles, thresholds,
                                    fleet_speed(self.serving))
        warm = [n + self.warm_pool if n or self.warm_pool else 0
                for n in per_tier]
        target = max(sum(warm), self.min_workers)
        if self.max_workers:
            target = min(target, self.max_workers)
        if self.cost_budget_per_hour and self.cost_per_slot_hour > 0:
            afford = int(self.cost_budget_per_hour
                         // self.cost_per_slot_hour)
            target = min(target, max(afford, self.min_workers))
        current = census.active_slots
        if target > current:
            self._low_ticks = 0
            self._resize(backend, target, warm)
        elif target < current * (1.0 - self.down_margin):
            self._low_ticks += 1
            if self._low_ticks >= self.down_dwell:
                self._low_ticks = 0
                self._resize(backend, target, warm)
            else:
                self._prewarm(backend, warm)
        else:
            self._low_ticks = 0
            self._prewarm(backend, warm)

    def _resize(self, backend, target: int, warm: List[int]) -> None:
        set_capacity = getattr(backend, "set_capacity", None)
        if set_capacity is not None:
            set_capacity(target)
        self._prewarm(backend, warm)

    def _prewarm(self, backend, warm: List[int]) -> None:
        prewarm = getattr(backend, "prewarm", None)
        if prewarm is not None and self.warm_pool > 0:
            prewarm(tuple(warm))

    # ---- control-plane hook ----
    def plan_demand(self, demand: float, now: float) -> float:
        """Demand the allocator should plan for: the forecast at
        enactment time when available, else the trailing estimate."""
        if self.use_forecast_for_plan and self.last_forecast is not None:
            return max(self.last_forecast, 0.0)
        return demand


class ReactiveScaling(PredictiveScaling):
    """Ablation baseline: the same elastic machinery sized to the
    *trailing* EWMA rate with zero look-ahead — discovers every ramp
    after it happened. The planner keeps its own trailing estimate
    (``use_forecast_for_plan=False``)."""

    def __init__(self, serving, **kw):
        kw.setdefault("use_forecast_for_plan", False)
        super().__init__(serving,
                         TrailingForecaster(serving.ewma_alpha),
                         horizon_s=kw.pop("horizon_s", 1e-9), **kw)


# Registry: name -> factory(serving, trace). "null"/"heartbeat" resolve
# to the classic policies (imported lazily; controlplane imports us).
def _classic(name: str):
    def factory(serving, trace=None):
        from repro_torch.serving.controlplane import (HeartbeatScaling,
                                                      NullScaling)
        return NullScaling() if name == "null" else HeartbeatScaling()
    return factory


def _predictive(serving, trace=None, **kw):
    kw.setdefault("warm_pool", getattr(serving, "warm_pool", 0))
    kw.setdefault("horizon_s",
                  getattr(serving, "forecast_horizon_s", 0.0) or None)
    if getattr(serving, "warm_start_demand", False) and trace is not None:
        kw.setdefault("initial_demand", float(trace.rate_at(0.0)))
    return PredictiveScaling(serving, trace=trace, **kw)


def _reactive(serving, trace=None):
    kw = {"warm_pool": getattr(serving, "warm_pool", 0)}
    if getattr(serving, "warm_start_demand", False) and trace is not None:
        kw["initial_demand"] = float(trace.rate_at(0.0))
    return ReactiveScaling(serving, **kw)


TORCH_SCALERS = {
    "null": _classic("null"),
    "heartbeat": _classic("heartbeat"),
    "reactive": _reactive,
    "predictive": _predictive,
    "predictive-oracle": lambda serving, trace=None: _predictive(
        serving, trace, forecaster="oracle"),
}


def make_scaler(name: str, serving, trace=None):
    try:
        factory = TORCH_SCALERS[name]
    except KeyError:
        raise KeyError(f"unknown scaler {name!r}; "
                       f"known {sorted(TORCH_SCALERS)}") from None
    return factory(serving, trace)
