"""The configs the ported paths need: the decoder-only LM
(``ModelConfig`` and its sub-configs), the UNet variant, the per-tier
execution-latency profile e(b), and the serving side: the N-tier
``CascadeSpec`` of ``TierSpec`` tiers (with the two-tier
``CascadeConfig`` front-end), worker classes with their latency scales,
and ``ServingConfig``. Copies of the JAX package's classes of the same
names, with the same fields, defaults and checks
(``tests/test_torch_control.py`` holds them to the originals). Pure
data: nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Optional, Tuple

# A transformer stack is (prefix_pattern, period_pattern * n_periods).
# Each entry is (mixer, ffn): mixer in {"attn", "mla", "mamba", "mlstm",
# "slstm"}, ffn in {"mlp", "moe", None}.
BlockSpec = Tuple[str, Optional[str]]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff: int = 0                     # per-expert hidden dim
    router_aux_coef: float = 0.001    # load-balance loss coefficient
    router_dtype: str = "float32"
    capacity_factor: float = 1.25     # per-expert buffer slack (drops above)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""
    q_lora_rank: int = 0              # 0 => dense q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                  # 0 => ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0          # mLSTM up-projection
    conv_kernel: int = 4
    slstm_proj_factor: float = 4.0 / 3.0


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only LM: the "attn", "mla", "mamba", "mlstm" and
    "slstm" mixers with "mlp", "moe" or no FFN; token or embedding
    inputs; RoPE, M-RoPE or learned positions."""
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads

    # Norm / position / activations
    norm: str = "rmsnorm"             # rmsnorm | layernorm | nonparam_ln
    norm_eps: float = 1e-5
    rope: str = "rope"                # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()
    pos_emb: str = "none"             # none | learned
    mlp: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = False
    max_position: int = 1 << 20

    # Block layout
    prefix_pattern: Tuple[BlockSpec, ...] = ()
    period_pattern: Tuple[BlockSpec, ...] = (("attn", "mlp"),)

    # Sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: Optional[MLAConfig] = None
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)

    # Frontend
    input_mode: str = "tokens"        # tokens | embeddings
    num_position_dims: int = 1        # 3 for M-RoPE (t, h, w)

    # Multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0

    # Implementation knobs (sharding, scan) of the JAX package, kept so
    # that a config is the same data in both packages; ``remat`` is the
    # train step's recomputation in both: none | full | dots | dots_nb
    # (``repro_torch/remat.py``)
    attn_impl: str = "xla"
    remat: str = "none"
    scan_layers: bool = True
    dtype: str = "bfloat16"
    fsdp: bool = False
    sequence_parallel: bool = False
    opt_8bit_moments: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def n_periods(self) -> int:
        body = self.num_layers - len(self.prefix_pattern)
        if body % max(len(self.period_pattern), 1) != 0:
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by period "
                f"{len(self.period_pattern)}")
        return body // len(self.period_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True when per-token decode cost does not grow with context length
        (SSM / SSM-dominant hybrid). Used for the long_500k skip rule."""
        mixers = [m for m, _ in self.prefix_pattern + self.period_pattern]
        n_attn = sum(m in ("attn", "mla") for m in mixers)
        return n_attn == 0 or (n_attn / len(mixers)) <= 0.25

    def flat_pattern(self) -> Tuple[BlockSpec, ...]:
        return self.prefix_pattern + self.period_pattern * self.n_periods


@dataclass(frozen=True)
class DiffusionConfig:
    """Latent-diffusion UNet variant (the paper's served model class)."""
    name: str
    image_size: int = 64              # latent resolution
    in_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16, 8)
    num_heads: int = 4
    text_dim: int = 256               # cross-attention conditioning width
    num_steps: int = 50               # sampler steps (1 for distilled "turbo")
    sampler: str = "ddim"             # ddim | euler
    dtype: str = "float32"


@dataclass(frozen=True)
class LatencyProfile:
    """Per-model execution-latency profile e(b) (seconds for a batch of b).

    ``base_s`` is batch-1 latency; ``marginal_s`` the per-extra-query
    cost. In the port both come from ``ClusterRuntime.measure_profile``
    on the device that serves the tier.
    """
    base_s: float
    marginal_s: float

    def exec_latency(self, batch: int) -> float:
        return self.base_s + self.marginal_s * max(batch - 1, 0)

    def throughput(self, batch: int) -> float:
        return batch / self.exec_latency(batch)


@dataclass(frozen=True)
class TierSpec:
    """One tier of a model cascade.

    ``disc_latency_s`` is the discriminator run on *this tier's outputs*
    (ignored on the final tier — nothing defers past it). ``batch_choices``
    empty means "use ``ServingConfig.batch_choices``"; ``rho`` ``None``
    means "use the ServingConfig utilization caps" (``rho_light`` for tier
    0, ``rho_heavy`` for deeper tiers). ``slo_budget_s`` reserves a slice
    of the cascade SLO for this tier: no plan may run the tier (exec +
    its discriminator) slower than the budget on any worker class it is
    assigned to. ``None`` means the solver splits the leftover SLO slack
    across unbudgeted tiers proportionally to their reference latency.
    """
    model: str                        # model name in the repository
    profile: LatencyProfile = field(
        default_factory=lambda: LatencyProfile(0.10, 0.01))
    batch_choices: Tuple[int, ...] = ()
    disc_latency_s: float = 0.010     # EfficientNet on A100 (paper §4.4)
    rho: Optional[float] = None       # utilization cap (queue stability)
    slo_budget_s: Optional[float] = None   # per-tier latency budget


@dataclass(frozen=True)
class CascadeSpec:
    """An ordered N-tier cascade: tier 0 (cheapest) sees every query; a
    per-boundary confidence threshold defers low-confidence queries from
    tier i to tier i+1. N-1 boundaries for N tiers.

    Quality anchors generalize the paper's two-tier FID statistics:
    ``fid_per_tier[i]`` is the FID when *all* queries stop at tier i;
    ``easy_fractions[i]`` the fraction of queries the boundary-i
    discriminator scores as "easy" (kept at tier i).
    """
    name: str
    tiers: Tuple[TierSpec, ...]
    discriminator: str = "efficientnet_s"
    slo_s: float = 5.0
    # FID* calibration anchors (paper-reported statistics; see DESIGN.md §7)
    # — empty means "use the sdturbo paper anchors for first/last tier",
    # so cascades of any depth construct without quality calibration
    fid_per_tier: Tuple[float, ...] = ()
    fid_best_mix: float = 17.9
    best_mix_defer_frac: float = 0.65
    easy_fractions: Tuple[float, ...] = (0.30,)

    def __post_init__(self):
        if len(self.tiers) < 2:
            raise ValueError(f"{self.name}: a cascade needs >= 2 tiers")
        if len(self.fid_per_tier) not in (0, len(self.tiers)):
            raise ValueError(f"{self.name}: fid_per_tier must have one "
                             f"entry per tier")
        budgets = [t.slo_budget_s for t in self.tiers
                   if t.slo_budget_s is not None]
        if any(b <= 0 for b in budgets):
            raise ValueError(f"{self.name}: tier slo_budget_s must be > 0")
        if sum(budgets) > self.slo_s + 1e-9:
            raise ValueError(
                f"{self.name}: per-tier SLO budgets sum to "
                f"{sum(budgets):.3f}s > slo_s={self.slo_s:.3f}s")

    # ---------------- structure ----------------
    @property
    def num_tiers(self) -> int:
        return len(self.tiers)

    @property
    def num_boundaries(self) -> int:
        return len(self.tiers) - 1

    def tier_batch_choices(self, i: int,
                           default: Tuple[int, ...]) -> Tuple[int, ...]:
        return self.tiers[i].batch_choices or default

    def easy_fraction_at(self, boundary: int) -> float:
        if not self.easy_fractions:
            return 0.30
        return self.easy_fractions[min(boundary,
                                       len(self.easy_fractions) - 1)]

    # ------- two-tier accessors (first/last tier; legacy call sites) -------
    @property
    def light_profile(self) -> LatencyProfile:
        return self.tiers[0].profile

    @property
    def heavy_profile(self) -> LatencyProfile:
        return self.tiers[-1].profile

    @property
    def disc_latency_s(self) -> float:
        return self.tiers[0].disc_latency_s

    @property
    def easy_fraction(self) -> float:
        return self.easy_fraction_at(0)

    @property
    def fid_all_light(self) -> float:
        return self.fid_per_tier[0] if self.fid_per_tier else 22.6

    @property
    def fid_all_heavy(self) -> float:
        return self.fid_per_tier[-1] if self.fid_per_tier else 18.55


@dataclass(frozen=True)
class CascadeConfig:
    """Legacy two-tier cascade front-end; convert with ``as_cascade_spec``."""
    name: str
    light: str                        # model name in the repository
    heavy: str
    discriminator: str = "efficientnet_s"
    slo_s: float = 5.0
    light_profile: LatencyProfile = field(default_factory=lambda: LatencyProfile(0.10, 0.01))
    heavy_profile: LatencyProfile = field(default_factory=lambda: LatencyProfile(1.78, 0.70))
    disc_latency_s: float = 0.010     # EfficientNet on A100 (paper §4.4)
    # FID* calibration anchors (paper-reported statistics; see DESIGN.md §7)
    fid_all_heavy: float = 18.55
    fid_all_light: float = 22.6
    fid_best_mix: float = 17.9
    best_mix_defer_frac: float = 0.65
    easy_fraction: float = 0.30       # 20-40% of queries are "easy"

    def as_spec(self) -> CascadeSpec:
        return CascadeSpec(
            name=self.name,
            tiers=(TierSpec(model=self.light, profile=self.light_profile,
                            disc_latency_s=self.disc_latency_s),
                   TierSpec(model=self.heavy, profile=self.heavy_profile,
                            disc_latency_s=0.0)),
            discriminator=self.discriminator, slo_s=self.slo_s,
            fid_per_tier=(self.fid_all_light, self.fid_all_heavy),
            fid_best_mix=self.fid_best_mix,
            best_mix_defer_frac=self.best_mix_defer_frac,
            easy_fractions=(self.easy_fraction,))


def as_cascade_spec(cascade) -> CascadeSpec:
    """Normalize a ``CascadeSpec`` | ``CascadeConfig`` to a spec."""
    if isinstance(cascade, CascadeSpec):
        return cascade
    if isinstance(cascade, CascadeConfig):
        return cascade.as_spec()
    raise TypeError(f"not a cascade: {type(cascade).__name__}")


def tier_rho(spec: CascadeSpec, serving: "ServingConfig", i: int) -> float:
    """Utilization cap for tier i: per-tier override, else the ServingConfig
    caps (tier 0 -> rho_light, deeper tiers -> rho_heavy)."""
    rho = spec.tiers[i].rho
    if rho is not None:
        return rho
    return serving.rho_light if i == 0 else serving.rho_heavy


@dataclass(frozen=True)
class LatencyScale:
    """Per-class latency scaling against the reference hardware the model
    profiles were measured on: batch-1 latency multiplies by ``base``,
    the per-extra-query marginal cost by ``marginal``. Real GPUs scale
    the two differently (an a10g runs SDXL batch-1 at ~2.2x an A100 but
    its marginal per-image cost at ~2.6x), which a single throughput
    multiplier cannot express.
    """
    base: float
    marginal: float

    def __post_init__(self):
        if self.base <= 0 or self.marginal <= 0:
            raise ValueError(f"latency scales must be > 0, got "
                             f"({self.base}, {self.marginal})")

    def apply(self, profile: LatencyProfile) -> LatencyProfile:
        return LatencyProfile(base_s=profile.base_s * self.base,
                              marginal_s=profile.marginal_s * self.marginal)


@dataclass(frozen=True)
class WorkerClass:
    """A homogeneous group of workers in a heterogeneous cluster.

    ``speed`` is a throughput multiplier relative to the reference
    hardware the latency profiles were measured on: a worker of speed
    ``s`` runs every tier's batch in ``e(b) / s`` seconds and therefore
    contributes ``s * T(b)`` throughput (paper §5: mixed GPU classes).

    ``profiles`` optionally refines that single multiplier into
    per-model ``LatencyScale`` overrides (``(model_name, scale)`` pairs;
    ``"*"`` matches every model). A model without an override falls back
    to the uniform ``(1/speed, 1/speed)`` scaling, so plain
    ``name:count:speed`` classes behave exactly as before.
    """
    name: str
    count: int
    speed: float = 1.0
    profiles: Tuple[Tuple[str, LatencyScale], ...] = ()

    def __post_init__(self):
        if not self.name:
            raise ValueError("worker class name must be non-empty "
                             "(\"\" is the homogeneous sentinel)")
        if self.count < 1:
            raise ValueError(f"worker class {self.name!r}: count must "
                             f"be >= 1, got {self.count}")
        if self.speed <= 0:
            raise ValueError(f"worker class {self.name!r}: speed must "
                             f"be > 0, got {self.speed}")
        models = [m for m, _ in self.profiles]
        if len(set(models)) != len(models):
            raise ValueError(f"worker class {self.name!r}: duplicate "
                             f"model overrides in {models}")

    def scale_for(self, model: str) -> LatencyScale:
        """Latency scale for ``model``: exact override > ``"*"`` wildcard
        > uniform ``1/speed``."""
        wild = None
        for m, sc in self.profiles:
            if m == model:
                return sc
            if m == "*":
                wild = sc
        if wild is not None:
            return wild
        inv = 1.0 / self.speed
        return LatencyScale(inv, inv)

    def tier_profile(self, tier: "TierSpec") -> LatencyProfile:
        """The tier's latency profile as executed on this class."""
        return self.scale_for(tier.model).apply(tier.profile)

    def tier_latency(self, tier: "TierSpec", batch: int,
                     with_disc: bool = True) -> float:
        """Class-scaled execution latency for a batch, optionally plus
        the discriminator (a fixed-cost model run, scaled like batch-1
        work)."""
        lat = self.tier_profile(tier).exec_latency(batch)
        if with_disc:
            lat += tier.disc_latency_s * self.scale_for(tier.model).base
        return lat

    def tier_throughput(self, tier: "TierSpec", batch: int) -> float:
        return batch / self.tier_latency(tier, batch, with_disc=False)


def as_worker_class(name: str, value) -> WorkerClass:
    """Normalize a class-table entry: a ``WorkerClass``, a ``(count,
    speed)`` pair, or a ``(count, speed, profiles)`` triple."""
    if isinstance(value, WorkerClass):
        return value
    count, speed = value[0], value[1]
    profiles = tuple(value[2]) if len(value) > 2 else ()
    return WorkerClass(name=name, count=int(count), speed=float(speed),
                       profiles=profiles)


def _parse_scale(value: str, entry: str) -> LatencyScale:
    """``BASExMARGINAL`` (e.g. ``2.2x2.6``) or a single multiplier."""
    bits = value.split("x")
    try:
        nums = [float(b) for b in bits]
    except ValueError:
        nums = None
    if nums is None or len(nums) not in (1, 2):
        raise ValueError(f"bad latency scale {value!r} in {entry!r}; "
                         f"expected BASExMARGINAL, e.g. 2.2x2.6")
    # range errors (<= 0) propagate from LatencyScale as such — a
    # well-formed value must not be reported as a syntax problem
    return LatencyScale(nums[0], nums[-1])


def parse_worker_classes(text: str,
                         speed_defaults: Optional[Mapping[str, float]] = None,
                         profile_defaults: Optional[
                             Mapping[str, Tuple[float, float]]] = None,
                         ) -> Tuple[WorkerClass, ...]:
    """Parse a ``--worker-classes`` CLI value:
    ``name:count[:speed][@model=BASExMARG]...,...``
    e.g. ``a100:4:1.0,a10g:12:0.45`` or
    ``a10g:12@*=2.2x2.6@sdxl=2.2x3.1``. Each ``@model=`` term pins a
    per-model ``LatencyScale`` (``*`` matches every model). Omitted
    speeds resolve through ``speed_defaults`` (else 1.0); when the speed
    is omitted and no explicit ``*`` override is given,
    ``profile_defaults`` (name -> ``(base, marginal)`` latency
    multipliers) supplies the wildcard scale — also as the fallback
    behind explicit per-model pins — and the speed becomes ``1/base``."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        head, *over = part.split("@")
        profiles = []
        for term in over:
            if "=" not in term:
                raise ValueError(f"bad model override {term!r} in {part!r}; "
                                 f"expected model=BASExMARGINAL")
            model, _, value = term.partition("=")
            profiles.append((model, _parse_scale(value, part)))
        bits = head.split(":")
        if len(bits) == 2:
            name, count = bits
            speed = (speed_defaults or {}).get(name, 1.0)
            default = (profile_defaults or {}).get(name)
            # speed omitted: the class table's (base, marginal) wildcard
            # applies — also alongside explicit per-model pins, so
            # `a10g:12@sdxl=...` keeps the table scaling for every other
            # model rather than silently degrading them to 1/speed
            if default is not None \
                    and not any(m == "*" for m, _ in profiles):
                profiles.append(("*", LatencyScale(*default)))
                speed = 1.0 / default[0]
        elif len(bits) == 3:
            name, count, speed = bits
        else:
            raise ValueError(f"bad worker-class entry {part!r}; expected "
                             f"name:count[:speed][@model=BASExMARG]")
        out.append(WorkerClass(name=name, count=int(count),
                               speed=float(speed),
                               profiles=tuple(profiles)))
    if not out:
        raise ValueError(f"no worker classes in {text!r}")
    names = [wc.name for wc in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate worker-class names in {text!r}")
    return tuple(out)


def parse_class_costs(text: str,
                      cost_defaults: Optional[Mapping[str, float]] = None
                      ) -> Tuple[Tuple[str, float], ...]:
    """Parse a ``--cost-per-class`` CLI value: ``name[=dollars_per_hour]``
    entries, comma-separated (e.g. ``a100=4.10,a10g=1.21``). Omitted
    costs resolve through ``cost_defaults``."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, value = part.partition("=")
        if sep:
            cost = float(value)
        elif cost_defaults and name in cost_defaults:
            cost = float(cost_defaults[name])
        else:
            raise ValueError(f"no cost for class {name!r} in {text!r} and "
                             f"no default available")
        if cost <= 0:
            raise ValueError(f"class {name!r}: cost must be > 0, got {cost}")
        out.append((name, cost))
    if not out:
        raise ValueError(f"no class costs in {text!r}")
    names = [n for n, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate class names in {text!r}")
    return tuple(out)


@dataclass(frozen=True)
class ServingConfig:
    cascade: "CascadeSpec | CascadeConfig"
    num_workers: int = 16
    batch_choices: Tuple[int, ...] = (1, 2, 4, 8, 16)
    control_period_s: float = 2.0
    ewma_alpha: float = 0.6
    overprovision: float = 1.05       # λ in the paper
    threshold_grid: int = 101         # discretization of t ∈ [0, 1]
    drop_predicted_misses: bool = True
    hedge_quantile: float = 0.99      # straggler hedging trigger
    heartbeat_timeout_s: float = 4.0
    worker_tp_size: int = 1           # devices per worker (slice width)
    rho_light: float = 0.90           # utilization cap (queue stability)
    rho_heavy: float = 0.85
    worker_classes: Tuple[WorkerClass, ...] = ()   # () => homogeneous
    # optional $/hour per worker class: when set, the heterogeneous
    # solver breaks threshold ties by dollar cost instead of worker count
    class_costs: Tuple[Tuple[str, float], ...] = ()
    # control-plane policy bundle + demand-estimator registry names
    # (serving/baselines.py:CONTROLLERS, serving/controlplane.py:
    # TORCH_ESTIMATORS); resolved at ControlPlane build time, so configs stay
    # pure data
    controller: str = "diffserve"
    estimator: str = "ewma"
    # cascade auto-construction (serving/autocascade.py): the variant
    # catalog source ("builtin" or a JSON file path) and the cascade
    # names the per-epoch search may switch between (registry names,
    # catalog pinned names, or "auto:<family>:<m1>+<m2>" chains; empty
    # means the default pool derived from the active cascade). Stored as
    # plain strings — resolved when the search planner is assembled.
    catalog: str = "builtin"
    candidate_cascades: Tuple[str, ...] = ()
    # predictive autoscaling (serving/autoscaler.py:SCALERS,
    # serving/forecast.py:FORECASTERS): the scaling-policy and demand-
    # forecaster registry names, the forecast horizon (0 => one control
    # epoch + model_load_s lead), the per-tier warm pool of pre-loaded
    # standby workers, and whether the first control tick provisions for
    # the trace's known t=0 rate instead of the blind nominal 1.0 qps.
    scaler: str = "heartbeat"
    forecaster: str = "holt-winters"
    forecast_horizon_s: float = 0.0
    warm_pool: int = 0
    warm_start_demand: bool = False
    # overload hardening (serving/admission.py:TORCH_ADMISSIONS): the
    # admission-policy registry name plus its knobs — the ECN-style mark
    # threshold k and shed multiplier for "queue-depth" (shed when the
    # arrival tier's backlog passes k * shed_mult), and the token rate /
    # burst allowance for "token-bucket". Resolved at ControlPlane build
    # time like the other registries.
    admission: str = "accept-all"
    ecn_k: float = 30.0
    ecn_shed_mult: float = 4.0
    admission_rate_qps: float = 0.0
    admission_burst_s: float = 2.0
    # disaggregated micro-serving (serving/microserve.py:STAGES): the
    # stage-graph registry name ("off" keeps the classic whole-tier
    # path), the denoise step quantization, and the minimum fraction of
    # steps a query must run before confidence-based preemption may
    # exit it early to decode. Resolved at ControlPlane build time.
    stage_graph: str = "off"
    stage_denoise_steps: int = 8
    stage_preempt_frac: float = 0.5
    # feed the admission door's shed rate back into the solver as a
    # shed-adjusted QPS prior (core/allocator.py); off by default so
    # goldens stay bit-identical
    shed_feedback: bool = False
    # kernel hot path (kernels/impls.py:TORCH_KERNEL_IMPLS): how the
    # cascade's UNet/discriminator stages execute ("fused" through the
    # hand-written kernels, "auto" = "fused", "unfused" the per-op
    # baseline), plus the batch bucket ladder samplers pad to so each
    # stage runs O(#buckets) batch shapes. () disables bucketing (one
    # shape per batch size).
    kernel_impl: str = "auto"
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)

    def __post_init__(self):
        if self.ecn_k <= 0:
            raise ValueError(f"ecn_k must be > 0, got {self.ecn_k}")
        if self.stage_denoise_steps < 1:
            raise ValueError(f"stage_denoise_steps must be >= 1, got "
                             f"{self.stage_denoise_steps}")
        if not 0 < self.stage_preempt_frac <= 1:
            raise ValueError(f"stage_preempt_frac must be in (0, 1], got "
                             f"{self.stage_preempt_frac}")
        if self.ecn_shed_mult < 1.0:
            raise ValueError(f"ecn_shed_mult must be >= 1, got "
                             f"{self.ecn_shed_mult}")
        if self.admission_rate_qps < 0:
            raise ValueError(f"admission_rate_qps must be >= 0, got "
                             f"{self.admission_rate_qps}")
        if self.admission == "token-bucket" and self.admission_rate_qps <= 0:
            raise ValueError("token-bucket admission requires "
                             "admission_rate_qps > 0")
        if self.forecast_horizon_s < 0:
            raise ValueError(f"forecast_horizon_s must be >= 0, got "
                             f"{self.forecast_horizon_s}")
        if self.warm_pool < 0:
            raise ValueError(f"warm_pool must be >= 0, got "
                             f"{self.warm_pool}")
        if self.class_costs and not self.worker_classes:
            raise ValueError("class_costs requires worker_classes")
        bks = tuple(self.batch_buckets)
        if any(b < 1 for b in bks):
            raise ValueError(f"batch_buckets must be >= 1, got {bks}")
        if list(bks) != sorted(set(bks)):
            raise ValueError(f"batch_buckets must be strictly ascending, "
                             f"got {bks}")
        if not self.worker_classes:
            return
        names = [wc.name for wc in self.worker_classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker-class names: {names}")
        total = sum(wc.count for wc in self.worker_classes)
        if total != self.num_workers:
            raise ValueError(
                f"worker_classes counts sum to {total} but "
                f"num_workers={self.num_workers}")
        unknown = [n for n, _ in self.class_costs if n not in names]
        if unknown:
            raise ValueError(f"class_costs names {unknown} not in "
                             f"worker_classes {names}")
        if self.class_costs:
            priced = {n for n, _ in self.class_costs}
            missing = [n for n in names if n not in priced]
            if missing:
                # an unpriced class would be free to the cost-minimizing
                # objective; demand a price for every class up front
                raise ValueError(f"class_costs missing prices for "
                                 f"classes {missing}")

    def class_table(self) -> "dict[str, Tuple[int, float]]":
        """``{name: (count, speed)}`` (legacy scalar form); a single
        unit-speed 'default' class when the cluster is homogeneous."""
        if not self.worker_classes:
            return {"default": (self.num_workers, 1.0)}
        return {wc.name: (wc.count, wc.speed) for wc in self.worker_classes}

    def class_map(self) -> "dict[str, WorkerClass]":
        """``{name: WorkerClass}`` with full latency profiles; a single
        unit-speed 'default' class when the cluster is homogeneous, empty
        when there are no workers at all (a phantom worker here would let
        the solver return 'feasible' plans nothing can run)."""
        if not self.worker_classes:
            if self.num_workers <= 0:
                return {}
            return {"default": WorkerClass("default", self.num_workers, 1.0)}
        return {wc.name: wc for wc in self.worker_classes}


def replace(cfg, **kw):
    """dataclasses.replace that works through our frozen configs."""
    return dataclasses.replace(cfg, **kw)
