"""Admission control + congestion-aware early degradation (overload
hardening; ROADMAP item 4).

DiffServe's deferral clamps and predictive drops only discover overload
at the *deadline*: when offered load exceeds cluster capacity, queues
grow until every query either misses its SLO or is predictively dropped
— a quality/violation cliff. This module adds the degradation layer that
turns the cliff into a curve, as an ``AdmissionPolicy`` protocol the
``ControlPlane`` owns and both backends consult per arrival:

  accept-all    the no-op baseline (bit-identical to pre-admission runs)
  token-bucket  classic rate limiting: admit while tokens last
  queue-depth   ECN-style per-tier marking (cloud-dcn-ecn's k10/k30/k60
                sweeps): when a tier's queue depth crosses ``k`` the
                policy degrades *early* — boundary thresholds feeding the
                congested tier scale down (fewer deferrals -> cheaper
                variants serve more of the mix), and once the arrival
                tier's backlog passes ``k * shed_mult`` new queries are
                shed at admission instead of missing deadlines later.

Drop taxonomy (split accounting in ``SimResult``/``Telemetry``):

  shed_admission      refused at the door by the admission policy
  dropped_predictive  admitted, then dropped because the backend
                      predicted a deadline miss (paper §3.2)
  dropped_deadline    admitted, then lost to capacity/deadline — queue
                      drops when no worker serves a tier, end-of-run
                      backlog, failure-requeue fallbacks

Conservation: ``total == completed + shed_admission + dropped_predictive
+ dropped_deadline`` after every run (property-tested across the
randomized overload battery in tests/test_overload.py).

The registry mirrors serving/autoscaler.py:SCALERS — ``TORCH_ADMISSIONS``
maps names to factories over a ``ServingConfig`` and ``make_admission``
resolves ``serving.admission`` when a ControlPlane is built, so configs
stay pure data.

PyTorch-port copy of ``repro/serving/admission.py`` (framework-free;
imports rewritten to ``repro_torch``), held to the original by
``tests/test_torch_control.py``. The registry is named
``TORCH_ADMISSIONS`` so that the repo linter's first-definition index
keeps the JAX package's ``ADMISSIONS`` too.
"""
from __future__ import annotations

from typing import Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class AdmissionPolicy(Protocol):
    """Per-arrival admission + per-tick early degradation.

    ``admit`` is the backend's hot-path gate: called once per arriving
    query with the live per-tier queue depths and the arrival tier; a
    ``False`` sheds the query at the door (counted as
    ``shed_admission``, never routed, never a deadline statistic). It
    must not consume backend RNG — admission runs inside seeded
    simulations whose goldens pin the RNG stream.

    ``degrade`` is the control-plane hook: each tick the freshly
    selected boundary thresholds pass through it with the tick's
    telemetry, so a congestion-aware policy can lower deferral
    thresholds *before* deadlines are missed. ``needs_telemetry`` makes
    fixed-plan bundles (which normally skip the telemetry window) fetch
    one anyway when the policy depends on queue depths.
    """

    name: str
    needs_telemetry: bool

    def admit(self, now: float, depths: Sequence[float],
              tier: int = 0) -> bool: ...

    def degrade(self, thresholds: Tuple[float, ...],
                telemetry) -> Tuple[float, ...]: ...


class AcceptAllAdmission:
    """The baseline: every query is admitted, thresholds pass through
    untouched — pre-admission behavior, bit-identical (golden-pinned)."""

    name = "accept-all"
    needs_telemetry = False

    def admit(self, now: float, depths: Sequence[float],
              tier: int = 0) -> bool:
        return True

    def degrade(self, thresholds: Tuple[float, ...],
                telemetry) -> Tuple[float, ...]:
        return thresholds


class TokenBucketAdmission:
    """Classic token bucket: ``rate_qps`` tokens/s refill up to a burst
    allowance of ``burst_s`` seconds' worth; each admitted query spends
    one token. Deterministic (lazy refill from elapsed virtual time, no
    RNG), so seeded runs stay reproducible. Rate limiting is congestion-
    *blind*: it bounds offered load but cannot react to where queues
    actually build — the queue-depth policy below is the aware one."""

    name = "token-bucket"
    needs_telemetry = False

    def __init__(self, rate_qps: float, burst_s: float = 2.0):
        if rate_qps <= 0:
            raise ValueError(f"token-bucket rate_qps must be > 0, "
                             f"got {rate_qps}")
        if burst_s <= 0:
            raise ValueError(f"token-bucket burst_s must be > 0, "
                             f"got {burst_s}")
        self.rate = float(rate_qps)
        self.capacity = float(rate_qps) * float(burst_s)
        self.tokens = self.capacity
        self.last = 0.0

    def admit(self, now: float, depths: Sequence[float],
              tier: int = 0) -> bool:
        if now > self.last:
            self.tokens = min(self.capacity,
                              self.tokens + (now - self.last) * self.rate)
            self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def degrade(self, thresholds: Tuple[float, ...],
                telemetry) -> Tuple[float, ...]:
        return thresholds


class QueueDepthAdmission:
    """ECN-style congestion marking over per-tier queue depths.

    Two early signals, both keyed to the mark threshold ``k`` (swept
    like cloud-dcn-ecn's k10/k30/k60 grid via ``--ecn-k``):

    * *Early degradation*: a boundary whose downstream tier's queue
      exceeds ``k`` gets its deferral threshold scaled by ``k / depth``
      — deferrals into the congested tier taper off smoothly, queries
      complete at the cheaper variant (a quality hit, paid gradually)
      instead of queueing toward a deadline miss.
    * *Admission shedding*: once the arrival tier's backlog passes
      ``k * shed_mult`` the system is past what early degradation can
      absorb, and new arrivals are shed at the door — bounding queue
      delay for everything already admitted.

    Both signals are deterministic functions of queue state, so seeded
    overload runs reproduce exactly.
    """

    name = "queue-depth"
    needs_telemetry = True

    def __init__(self, k: float = 30.0, shed_mult: float = 4.0):
        if k <= 0:
            raise ValueError(f"ecn k must be > 0, got {k}")
        if shed_mult < 1.0:
            raise ValueError(f"shed_mult must be >= 1 (shedding before "
                             f"marking inverts the policy), got {shed_mult}")
        self.k = float(k)
        self.shed_mult = float(shed_mult)

    @property
    def shed_at(self) -> float:
        return self.k * self.shed_mult

    def admit(self, now: float, depths: Sequence[float],
              tier: int = 0) -> bool:
        if not depths:
            return True
        d = depths[tier] if 0 <= tier < len(depths) else depths[-1]
        return d < self.shed_at

    def degrade(self, thresholds: Tuple[float, ...],
                telemetry) -> Tuple[float, ...]:
        queues = getattr(telemetry, "queues", ()) or ()
        if not queues:
            return thresholds
        out = list(thresholds)
        for b in range(len(out)):
            nxt = b + 1
            if nxt < len(queues) and queues[nxt] > self.k:
                # ECN mark on the downstream tier: scale the boundary
                # threshold feeding it toward 0 as the backlog grows
                out[b] = out[b] * (self.k / float(queues[nxt]))
        return tuple(out)


# Registry: name -> factory(serving). Mirrors SCALERS/TORCH_ESTIMATORS so the
# CLI/config surface is uniform: ``--admission queue-depth --ecn-k 30``.
TORCH_ADMISSIONS = {
    "accept-all": lambda serving: AcceptAllAdmission(),
    "token-bucket": lambda serving: TokenBucketAdmission(
        rate_qps=serving.admission_rate_qps,
        burst_s=serving.admission_burst_s),
    "queue-depth": lambda serving: QueueDepthAdmission(
        k=serving.ecn_k, shed_mult=serving.ecn_shed_mult),
}


def make_admission(name: str, serving) -> AdmissionPolicy:
    try:
        factory = TORCH_ADMISSIONS[name]
    except KeyError:
        raise KeyError(f"unknown admission policy {name!r}; "
                       f"known {sorted(TORCH_ADMISSIONS)}") from None
    return factory(serving)
