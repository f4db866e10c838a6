"""Demand forecasting for predictive autoscaling (ROADMAP item 1).

A reactive controller discovers a ramp only after queues build, then
pays ``model_load_s`` cold-starts exactly when it can least afford
them. The fix is to plan for demand at *enactment* time: a
``Forecaster`` ingests the per-tick observed arrival rate and predicts
the rate at ``now + horizon``, where the horizon covers the control
epoch plus the model-load lead time — so capacity provisioned from the
forecast is warm before the demand it was provisioned for arrives
(serving/autoscaler.py:PredictiveScaling).

Three forecaster families, mirroring the structure of
``azure_like_trace`` (diurnal backbone + heavy-tailed bursts):

  * ``EwmaTrendForecaster``  — Holt's double exponential smoothing
    (level + trend): extrapolates ramps the plain EWMA only chases.
  * ``HoltWintersForecaster`` — adds an additive seasonal component on
    a bucketed period: fits the diurnal backbone, so the second day's
    morning ramp is predicted from the first day's.
  * ``QuantileHeadroomForecaster`` — wraps any base forecaster with a
    sliding-quantile burst headroom (the spread between the q-quantile
    and the median of recent rates), covering the bursts no smooth
    model extrapolates.

``OracleForecaster`` reads the trace's true future rate (the upper
bound for ablations, like the oracle demand estimator).

This module is jax-free: pure control logic over floats.

PyTorch-port copy of ``repro/serving/forecast.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``. Registries carry the port's own names,
apart from the JAX package's for the repo linter's index: the forecaster
registry is ``TORCH_FORECASTERS``.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Protocol, runtime_checkable

import numpy as np

# Matches SimConfig.model_load_s / ClusterBackend model_load_s defaults:
# the lead time a forecast horizon must cover so a cold start charged at
# provisioning time completes before the predicted demand arrives.
DEFAULT_MODEL_LOAD_S = 2.0


def default_horizon_s(serving) -> float:
    """The default forecast horizon: one control epoch (the decision is
    only enacted next tick) plus the model-load lead time."""
    h = float(getattr(serving, "forecast_horizon_s", 0.0) or 0.0)
    if h > 0:
        return h
    return float(serving.control_period_s) + DEFAULT_MODEL_LOAD_S


@runtime_checkable
class Forecaster(Protocol):
    """One ``step`` per control tick: ingest the tick's observed arrival
    rate, return the predicted rate at ``now + horizon_s``."""

    def step(self, observed_qps: float, now: float,
             horizon_s: float) -> float: ...


class TrailingForecaster:
    """No look-ahead: an EWMA of the observations (exactly the paper's
    estimator) reported as the 'forecast'. This is the reactive
    baseline every real forecaster must beat."""

    def __init__(self, alpha: float = 0.6):
        self.alpha = float(alpha)
        self._value: Optional[float] = None

    def step(self, observed_qps: float, now: float,
             horizon_s: float) -> float:
        if self._value is None:
            self._value = float(observed_qps)
        else:
            self._value = (self.alpha * observed_qps
                           + (1 - self.alpha) * self._value)
        return self._value


class EwmaTrendForecaster:
    """Holt's linear (double exponential) smoothing: a smoothed level
    plus a smoothed per-second trend, extrapolated ``horizon_s`` ahead.
    On a ramp the trend term leads where a plain EWMA lags."""

    def __init__(self, alpha: float = 0.5, beta: float = 0.2):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.level: Optional[float] = None
        self.trend = 0.0
        self._last_now: Optional[float] = None

    def step(self, observed_qps: float, now: float,
             horizon_s: float) -> float:
        q = float(observed_qps)
        if self.level is None:
            self.level, self.trend = q, 0.0
        else:
            dt = max(now - (self._last_now
                            if self._last_now is not None else now), 1e-6)
            prev = self.level
            self.level = (self.alpha * q
                          + (1 - self.alpha) * (self.level
                                                + self.trend * dt))
            self.trend = (self.beta * (self.level - prev) / dt
                          + (1 - self.beta) * self.trend)
        self._last_now = now
        return max(self.level + self.trend * horizon_s, 0.0)


class HoltWintersForecaster:
    """Holt-Winters additive seasonal smoothing on a bucketed season:
    a slow-moving level plus a per-bucket seasonal component indexed by
    ``(t mod season_s)``. Fits the diurnal backbone of
    ``azure_like_trace`` — once a season has been observed, the forecast
    at ``now + horizon`` reads the seasonal shape at the *future*
    bucket instead of extrapolating blindly.

    The first season is the warm-up: observations are recorded (and a
    Holt trend model forecasts meanwhile — without a full season the
    seasonal shape is unknowable), then the level initializes to the
    season mean and the seasonal to per-bucket deviations. Without
    that split initialization the level chases the seasonal swing and
    the two confound (the classical HW pitfall)."""

    def __init__(self, season_s: float = 360.0, bucket_s: float = 2.0,
                 alpha: float = 0.2, gamma: float = 0.5,
                 warmup: Optional[Forecaster] = None):
        if season_s <= 0 or bucket_s <= 0:
            raise ValueError("season_s and bucket_s must be > 0")
        self.season_s = float(season_s)
        self.bucket_s = float(bucket_s)
        self.alpha, self.gamma = float(alpha), float(gamma)
        self.n_buckets = max(int(round(season_s / bucket_s)), 1)
        self.seasonal = np.zeros(self.n_buckets)
        self.level: Optional[float] = None
        self._first: dict = {}            # bucket -> first-season obs
        self._warmup = warmup or EwmaTrendForecaster()

    def _bucket(self, t: float) -> int:
        return int(t / self.bucket_s) % self.n_buckets

    def step(self, observed_qps: float, now: float,
             horizon_s: float) -> float:
        q = float(observed_qps)
        b = self._bucket(now)
        if self.level is None:
            # first season: record the shape, forecast with Holt trend
            self._first.setdefault(b, q)
            out = self._warmup.step(q, now, horizon_s)
            if now + self.bucket_s >= self.season_s:
                mean = float(np.mean(list(self._first.values())))
                self.level = mean
                for bb, qq in self._first.items():
                    self.seasonal[bb] = qq - mean
            return out
        s = self.seasonal[b]
        self.level = (self.alpha * (q - s) + (1 - self.alpha) * self.level)
        self.seasonal[b] = (self.gamma * (q - self.level)
                            + (1 - self.gamma) * s)
        fb = self._bucket(now + horizon_s)
        return max(self.level + self.seasonal[fb], 0.0)


class QuantileHeadroomForecaster:
    """Burst headroom over any base forecaster: the sliding
    ``q``-quantile-minus-median spread of recent observed rates is the
    burst mass a smooth model cannot extrapolate; provisioning for
    ``forecast + headroom`` absorbs it."""

    def __init__(self, base: Forecaster, q: float = 0.9,
                 window: int = 30):
        if not 0.5 <= q <= 1.0:
            raise ValueError(f"headroom quantile must be in [0.5, 1], "
                             f"got {q}")
        self.base = base
        self.q = float(q)
        self._obs: deque = deque(maxlen=int(window))

    def step(self, observed_qps: float, now: float,
             horizon_s: float) -> float:
        self._obs.append(float(observed_qps))
        f = self.base.step(observed_qps, now, horizon_s)
        if len(self._obs) < 3:
            return f
        arr = np.asarray(self._obs)
        headroom = max(float(np.quantile(arr, self.q))
                       - float(np.median(arr)), 0.0)
        return f + headroom


class OracleForecaster:
    """Perfect foresight: reads the trace's true rate at ``now +
    horizon`` (upper bound for forecaster ablations)."""

    def __init__(self, trace):
        if trace is None:
            raise ValueError("the 'oracle' forecaster needs the trace it "
                             "is an oracle for (pass trace=...)")
        self.trace = trace

    def step(self, observed_qps: float, now: float,
             horizon_s: float) -> float:
        return float(self.trace.rate_at(now + horizon_s))


# Registry: name -> factory(serving, trace). ``trace`` may be None for
# forecasters that only observe; when present it supplies the
# Holt-Winters season length (the diurnal backbone of a compressed
# trace spans the trace window).
def _season_of(serving, trace) -> float:
    if trace is not None and trace.duration_s > 0:
        return float(trace.duration_s)
    return 360.0


# ewma_alpha / control_period_s below are core-control constants (the
# paper's pinned smoothing factor and the control-epoch length), shared
# with the estimator/control loop — deliberately not CLI-exposed.
TORCH_FORECASTERS = {
    "trailing": lambda serving, trace=None: TrailingForecaster(
        serving.ewma_alpha),  # staticlint: ignore[registry-threading]
    "ewma-trend": lambda serving, trace=None: EwmaTrendForecaster(),
    "holt-winters": lambda serving, trace=None: HoltWintersForecaster(
        season_s=_season_of(serving, trace),
        bucket_s=float(serving.control_period_s)),  # staticlint: ignore[registry-threading]
    "holt-winters-headroom": lambda serving, trace=None:
        QuantileHeadroomForecaster(HoltWintersForecaster(
            season_s=_season_of(serving, trace),
            bucket_s=float(serving.control_period_s))),  # staticlint: ignore[registry-threading]
    "oracle": lambda serving, trace=None: OracleForecaster(trace),
}


def make_forecaster(name: str, serving, trace=None) -> Forecaster:
    try:
        factory = TORCH_FORECASTERS[name]
    except KeyError:
        raise KeyError(f"unknown forecaster {name!r}; "
                       f"known {sorted(TORCH_FORECASTERS)}") from None
    return factory(serving, trace)


def forecast_mae(forecaster: Forecaster, trace, period_s: float,
                 horizon_s: float) -> float:
    """Mean absolute error of one-step-per-period forecasts against the
    trace's true rate at ``t + horizon`` (skipping the first season's
    worth of warm-up is the caller's concern — this scores every tick)."""
    errs = []
    t = 0.0
    while t < trace.duration_s:
        f = forecaster.step(trace.rate_at(t), t, horizon_s)
        target = t + horizon_s
        if target < trace.duration_s:
            errs.append(abs(f - trace.rate_at(target)))
        t += period_s
    return float(np.mean(errs)) if errs else 0.0
