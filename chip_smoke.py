#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the
numbers in PERF.md).

    python3 chip_smoke.py [--out details.json]

Phases, each of which fails the run if it fails:

1. Header: the card's name and power limit (nvidia-smi), then the
   kernels' build from the repository's sources (nvcc for the CUDA C++
   flash attention; Triton compiles the GroupNorm kernel at first use).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the served path gives it (recorded from one full-width UNet
   forward and one discriminator forward at batch 8), with its stated
   tolerance; times of the kernel, the plain version and one PyTorch
   library call (a yardstick the port never calls), beside the least
   time the card could take.
3. The slice: the full-width two-tier cascade (64x64x4 latent, base 128,
   tier 0 at 1 DDIM step, tier 1 at 50) behind ``ClusterRuntime``:
   per-tier e(b) from ``measure_profile``, then ``serve_batch`` on
   batches of 1, 3 and 8 with thresholds that defer some queries, with
   every launch counter zeroed just before and read just after; the
   counts must equal the path's. A small cascade served on the card and
   on the CPU (plain versions) must agree. Then ``torch.profiler`` traces
   one tier-0 stage call at batches 1 and 8: device busy time, the idle
   share of the wall, device time by kernel.
4. One JSON line listing every ported kernel, then, last, the result
   line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without CUDA or without the
repository's ``src/repro_torch`` beside it. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "bfloat16": 989e12}
FLASH_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GN_TOL = dict(atol=3e-5, rtol=3e-5)
# DDIM divides eps by sqrt(alpha_bar(999)) = sqrt(1e-5): 316 x the
# 5e-5 model tolerance (tests/test_torch_models.py)
DDIM_TOL = dict(atol=316 * 5e-5, rtol=0)
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)
BUCKETS = (1, 2, 4, 8)
SERVE_SIZES = (1, 3, 8)
PROMPT_LEN = 8
DEV = "cuda"
# kernel calls per forward on the full-width path
PATH_GN = {"unet": 41, "disc": 22}      # 35 of the UNet's with SiLU
PATH_FA = {"unet": 6, "disc": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Median ms of one call, by CUDA events around each call, with the
    L2 cache (50 MB) flushed before each so inputs come from HBM."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------------------------
# phase 1: header and build
# ---------------------------------------------------------------------------
def header_and_build(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import fused_groupnorm as tgn
    t0 = time.perf_counter()
    (lib,) = build.build(["flash_attention"])
    t_nvcc = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"ptxas: {ln}")
    t0 = time.perf_counter()
    x = torch.randn(2, 8, 8, 32, device=DEV)
    ops.fused_groupnorm(x, torch.ones(32, device=DEV),
                        torch.zeros(32, device=DEV), groups=8)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    log(f"build: nvcc flash_attention {t_nvcc:.3f} s; triton first "
        f"fused_groupnorm compile {t_triton:.3f} s "
        f"(specialisations so far {len(tgn.fused_groupnorm.specializations)})")
    return {"nvcc_s": t_nvcc, "triton_first_s": t_triton, "ptxas": ptxas}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def record_path_calls(torch, full_cfg, dcfg):
    """(kind, args) of every kernel call in one full-width UNet forward
    and one discriminator forward at batch 8."""
    from repro_torch.kernels import ops
    from repro_torch.models.efficientnet import (apply_discriminator,
                                                 init_discriminator)
    from repro_torch.models.unet import apply_unet, init_unet
    calls = {"unet": [], "disc": []}
    where = ["unet"]
    orig_gn, orig_fa = ops.fused_groupnorm, ops.flash_attention

    def gn(x, scale, bias, *, groups, act=True, eps=1e-5):
        calls[where[0]].append(("gn", tuple(x.shape), groups, act))
        return orig_gn(x, scale, bias, groups=groups, act=act, eps=eps)

    def fa(q, k, v, *, causal=True, kv_len=None):
        calls[where[0]].append(("fa", tuple(q.shape), tuple(k.shape),
                                causal))
        return orig_fa(q, k, v, causal=causal, kv_len=kv_len)
    g = torch.Generator(device=DEV).manual_seed(7)
    p = init_unet(full_cfg, seed=7, device=DEV)
    dp = init_discriminator(dcfg, seed=8, device=DEV)
    x = torch.randn((8, full_cfg.image_size, full_cfg.image_size,
                     full_cfg.in_channels), generator=g, device=DEV)
    toks = torch.randint(0, 1024, (8, PROMPT_LEN), generator=g,
                         device=DEV)
    ops.fused_groupnorm, ops.flash_attention = gn, fa
    try:
        eps_fused = apply_unet(p, full_cfg, x, torch.full((8,), 999,
                                                          device=DEV),
                               toks, impl="fused")
        where[0] = "disc"
        logits_fused, _ = apply_discriminator(dp, dcfg, x.clamp(-1, 1),
                                              impl="fused")
    finally:
        ops.fused_groupnorm, ops.flash_attention = orig_gn, orig_fa
    # the fused path against the per-op PyTorch path at full width
    eps_plain = apply_unet(p, full_cfg, x, torch.full((8,), 999,
                                                      device=DEV),
                           toks, impl="unfused")
    logits_plain, _ = apply_discriminator(dp, dcfg, x.clamp(-1, 1),
                                          impl="unfused")
    err_eps = (eps_fused - eps_plain).abs().max().item()
    err_logit = (logits_fused - logits_plain).abs().max().item()
    log(f"full width b=8: UNet eps fused vs unfused max |diff| {err_eps:.3e}"
        f" (scale {eps_plain.abs().max().item():.3e}); discriminator logits"
        f" {err_logit:.3e}; tolerance {MODEL_TOL}")
    if not torch.isfinite(eps_fused).all():
        fail("full-width UNet eps not finite")
    torch.testing.assert_close(eps_fused, eps_plain, **MODEL_TOL)
    torch.testing.assert_close(logits_fused, logits_plain, **MODEL_TOL)
    return calls, {"unet_eps_max_abs_diff": err_eps,
                   "disc_logit_max_abs_diff": err_logit}


def check_flash(torch, calls):
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels.ref import flash_attention_ref
    F = torch.nn.functional
    g = torch.Generator(device=DEV).manual_seed(11)
    path = Counter((q, k, c) for kind, q, k, c in calls["unet"]
                   if kind == "fa")
    if len(path) != 1:
        fail(f"expected one attention shape on the path, got {path}")
    (qs, ks, causal), per_forward = next(iter(path.items()))
    cases = [("path", qs, ks, False, None, "float32"),
             ("kv_len<Sk", qs, (ks[0], 384, ks[2], ks[3]), False, ks[1],
              "float32"),
             ("causal GQA", (2, 512, 8, 64), (2, 512, 2, 64), True, None,
              "float32"),
             ("causal GQA bf16", (2, 512, 8, 64), (2, 512, 2, 64), True,
              None, "bfloat16")]
    rows, worst = [], 0.0
    for name, qshape, kshape, causal, kv, dtype in cases:
        dt = getattr(torch, dtype)
        q = torch.randn(qshape, generator=g, device=DEV).to(dt)
        k = torch.randn(kshape, generator=g, device=DEV).to(dt)
        v = torch.randn(kshape, generator=g, device=DEV).to(dt)
        got = tflash.flash_attention(q, k, v, causal=causal, kv_len=kv)
        want = flash_attention_ref(q, k, v, causal=causal, kv_len=kv)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got, want, **FLASH_TOL[dtype])
        worst = max(worst, err) if dtype == "float32" else worst
        B, Sq, H, D = qshape
        kvl = kv or kshape[1]
        pairs = (Sq * (Sq + 1) // 2) if causal else Sq * kvl
        flops = 4.0 * B * H * pairs * D
        # q and o once, the kv_len rows of k and v once
        nbytes = (2 * q.numel() + 2 * B * kvl * kshape[2] * D) \
            * q.element_size()
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        row = {"case": name, "q": qshape, "k": kshape, "causal": causal,
               "kv_len": kv, "dtype": dtype, "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: tflash.flash_attention(
                   q, k, v, causal=causal, kv_len=kv)),
               "plain_ms": cuda_ms(torch, lambda: flash_attention_ref(
                   q, k, v, causal=causal, kv_len=kv)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if kshape[2] == qshape[2] and not causal:
            kk, vv = k[:, :kvl], v[:, :kvl]
            row["library_ms"] = cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kk.transpose(1, 2),
                    vv.transpose(1, 2)))
        rows.append(row)
        log(f"flash_attention {name}: q {qshape} k {kshape} {dtype} "
            f"causal={causal} kv_len={kv}: max|err| {err:.3e} "
            f"(tol {FLASH_TOL[dtype]}); kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    p = rows[0]
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:82",
             "max_abs_err": worst,
             "per": f"one UNet forward at b=8: {per_forward} launches at "
                    f"q {qs} k/v {ks}"}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        entry[key] = p[key] * per_forward
    entry["bound_by"] = p["bound_by"]
    return entry, rows


def check_groupnorm(torch, calls):
    from repro_torch.kernels import fused_groupnorm as tgn
    from repro_torch.kernels.ref import group_count, groupnorm_silu_ref
    F = torch.nn.functional
    g = torch.Generator(device=DEV).manual_seed(12)
    mult = Counter()
    for part in ("unet", "disc"):
        for kind, shape, groups, act in calls[part]:
            if kind == "gn":
                mult[(shape, groups, act)] += 1
    rows, worst = [], 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               t_bytes=0.0, t_ops=0.0)
    for (shape, groups, act), n in sorted(mult.items()):
        C = shape[-1]
        x = torch.randn(shape, generator=g, device=DEV) * 2 + 0.5
        s = torch.rand(C, generator=g, device=DEV) + 0.5
        b = torch.randn(C, generator=g, device=DEV) * 0.1
        got = tgn.fused_groupnorm(x, s, b, groups=groups, act=act)
        want = groupnorm_silu_ref(x, s, b, groups=groups, act=act)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **GN_TOL)
        worst = max(worst, err)
        gg = group_count(groups, C)
        xc = x.permute(0, 3, 1, 2)

        def library():
            y = F.group_norm(xc, gg, s, b, 1e-5)
            return F.silu(y) if act else y
        nbytes = 2 * x.numel() * 4 + 2 * C * 4
        flops = (12 if act else 8) * x.numel()
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        row = {"shape": shape, "groups": gg, "act": act, "per_path": n,
               "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: tgn.fused_groupnorm(
                   x, s, b, groups=groups, act=act)),
               "plain_ms": cuda_ms(torch, lambda: groupnorm_silu_ref(
                   x, s, b, groups=groups, act=act)),
               "library_ms": cuda_ms(torch, library),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            tot[key] += n * row[key]
        tot["t_bytes"] += n * nbytes / PEAK_BYTES_S * 1e3
        tot["t_ops"] += n * flops / PEAK_FLOPS_S["float32"] * 1e3
        log(f"fused_groupnorm {shape} g={gg} act={act} x{n}: max|err| "
            f"{err:.3e} (tol {GN_TOL}); kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms,"
            f" bound {b_ms:.4f} ms ({b_by})")
    n_calls = sum(mult.values())
    entry = {"name": "fused_groupnorm", "route": "triton",
             "source": "src/repro_torch/kernels/fused_groupnorm.py",
             "replaces": "src/repro/kernels/fused_groupnorm.py:36",
             "max_abs_err": worst,
             "ms": tot["ms"], "plain_ms": tot["plain_ms"],
             "bound_ms": tot["bound_ms"],
             "bound_by": "bytes" if tot["t_bytes"] >= tot["t_ops"]
             else "operations",
             "library_ms": tot["library_ms"],
             "per": f"one UNet + one discriminator forward at b=8: "
                    f"{n_calls} launches over {len(mult)} shapes"}
    return entry, rows


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------
def small_cascade_agrees_with_cpu(torch, np):
    """A small cascade served through the kernels on the card and through
    the plain versions on the CPU, same weights and noise."""
    from repro_torch.config.base import DiffusionConfig
    from repro_torch.core.cascade import DiffusionCascade
    from repro_torch.models.efficientnet import (DiscriminatorConfig,
                                                 init_discriminator)
    from repro_torch.models.unet import init_unet
    kw = dict(image_size=16, base_channels=32, channel_mults=(1, 2),
              num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
              text_dim=32)
    cfgs = [DiffusionConfig(name="s0", num_steps=1, **kw),
            DiffusionConfig(name="s1", num_steps=4, **kw)]
    dcfg = DiscriminatorConfig(in_channels=4)
    params = [init_unet(c, seed=20 + i, device="cpu")
              for i, c in enumerate(cfgs)]
    dparams = init_discriminator(dcfg, seed=22, device="cpu")
    rng = np.random.default_rng(23)
    noise = [rng.standard_normal((8, 16, 16, 4)).astype(np.float32)
             for _ in cfgs]
    toks = rng.integers(0, 1024, (5, PROMPT_LEN))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return None if tree is None else tree.to(dev)

    def cascade(dev):
        return DiffusionCascade(
            [(c, to(p, dev)) for c, p in zip(cfgs, params)], dcfg,
            to(dparams, dev), kernel_impl="fused", batch_buckets=BUCKETS,
            device=dev,
            noise_fn=lambda i, shape: torch.from_numpy(noise[i]).to(dev))
    probe = cascade("cpu").run_batch(toks, 1.0)
    s = np.sort(probe.confidences)
    gap = int(np.argmax(np.diff(s)))
    th = float((s[gap] + s[gap + 1]) / 2)
    want = cascade("cpu").run_batch(toks, th)
    got = cascade(DEV).run_batch(toks, th)
    err = float(np.abs(got.outputs - want.outputs).max())
    cerr = float(np.abs(got.confidences - want.confidences).max())
    log(f"small cascade cuda vs cpu: deferred {got.deferred.astype(int)} vs "
        f"{want.deferred.astype(int)}; output max|diff| {err:.3e} (tol "
        f"{DDIM_TOL}); score max|diff| {cerr:.3e}")
    if not (np.array_equal(got.deferred, want.deferred)
            and np.array_equal(got.stage_index, want.stage_index)):
        fail("small cascade: cuda and cpu deferred different queries")
    np.testing.assert_allclose(got.outputs, want.outputs, **DDIM_TOL)
    np.testing.assert_allclose(got.confidences, want.confidences,
                               atol=1e-4, rtol=1e-4)
    return {"small_cascade_output_max_abs_diff": err,
            "small_cascade_score_max_abs_diff": cerr}


def serve_slice(torch, np, full_cfg, dcfg):
    from repro_torch.core.cascade import DiffusionCascade
    from repro_torch.kernels import ops
    from repro_torch.models.efficientnet import init_discriminator
    from repro_torch.models.unet import init_unet
    from repro_torch.serving.cluster import ClusterRuntime
    tier0 = dataclasses.replace(full_cfg, name="tier0-turbo", num_steps=1)
    tier1 = dataclasses.replace(full_cfg, name="tier1-ddim50", num_steps=50)
    stages = [(tier0, init_unet(tier0, seed=0, device=DEV)),
              (tier1, init_unet(tier1, seed=1, device=DEV))]
    casc = DiffusionCascade(stages, dcfg,
                            init_discriminator(dcfg, seed=2, device=DEV),
                            kernel_impl="fused", batch_buckets=BUCKETS,
                            device=DEV, seed=0)
    rt = ClusterRuntime(casc, num_workers=2, kernel_impl="fused",
                        batch_buckets=BUCKETS, device=DEV)
    profiles = rt.measure_profile(batches=BUCKETS, prompt_len=PROMPT_LEN,
                                  repeats=2)
    eb = []
    for cfg, prof, pts in zip((tier0, tier1), profiles, rt.last_stage_times):
        eb.append({"tier": cfg.name, "steps": cfg.num_steps,
                   "e_b_s": {str(b): t for b, t in pts},
                   "base_s": prof.base_s, "marginal_s": prof.marginal_s})
        log(f"e(b) {cfg.name}: " + ", ".join(f"b={b} {t * 1e3:.2f} ms"
                                             for b, t in pts)
            + f"; fit base {prof.base_s * 1e3:.2f} ms marginal "
            f"{prof.marginal_s * 1e3:.2f} ms")
    rng = np.random.default_rng(31)
    batches = {n: rng.integers(0, 1024, (n, PROMPT_LEN)) for n in SERVE_SIZES}
    # thresholds from a tier-0 probe with the same noise (reseeded), so
    # that some queries defer and some do not
    thresholds = {}
    for n, toks in batches.items():
        casc.generator.manual_seed(100 + n)
        cfg0, fn0, p0 = casc.stage_fns()[0]
        conf = casc.confidence(fn0(p0, toks))
        s = np.sort(conf)
        k = n // 2
        thresholds[n] = 1.0 if n == 1 else float((s[k - 1] + s[k]) / 2)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    results = {}
    t0 = time.perf_counter()
    for n, toks in batches.items():
        casc.generator.manual_seed(100 + n)
        results[n] = rt.serve_batch(toks, thresholds[n])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    served = []
    for n, res in results.items():
        nd = int(res.deferred.sum())
        log(f"serve_batch n={n} (bucket {casc.bucket_for(n)}): threshold "
            f"{thresholds[n]:.6f}, scores {np.round(res.confidences, 6)}, "
            f"deferred {nd}")
        if res.outputs.shape != (n, tier0.image_size, tier0.image_size,
                                 tier0.in_channels) \
                or res.confidences.shape != (n,):
            fail(f"serve n={n}: shapes {res.outputs.shape} "
                 f"{res.confidences.shape}")
        if not (np.isfinite(res.outputs).all()
                and np.abs(res.outputs).max() <= 1.0
                and ((res.confidences >= 0) & (res.confidences <= 1)).all()):
            fail(f"serve n={n}: outputs not finite in [-1, 1] or scores "
                 "outside [0, 1]")
        want_def = n if n == 1 else (1, n - 1)
        if (n == 1 and nd != 1) or (n > 1 and not 1 <= nd <= n - 1):
            fail(f"serve n={n}: {nd} deferred, expected {want_def}")
        deferred = res.stage_index == 1
        if not np.array_equal(res.outputs[~deferred],
                              res.light_outputs[~deferred]):
            fail(f"serve n={n}: a kept query's output is not its tier-0 "
                 "output")
        served.append({"n": n, "bucket": casc.bucket_for(n),
                       "deferred": nd, "threshold": thresholds[n]})
    # per serve with a deferral: tier-0 UNet (41 GN + 6 attention), the
    # discriminator (22 GN), tier-1 DDIM50 over the whole batch (50 UNet)
    gn_u, gn_d, fa_u = PATH_GN["unet"], PATH_GN["disc"], PATH_FA["unet"]
    steps = tier0.num_steps + tier1.num_steps
    want = {"fused_groupnorm": len(SERVE_SIZES) * (steps * gn_u + gn_d),
            "flash_attention": len(SERVE_SIZES) * steps * fa_u}
    log(f"launches over {len(SERVE_SIZES)} serves: {counts} (expected "
        f"{want}, total {sum(want.values())}); serve wall {serve_s:.3f} s")
    if counts != want:
        fail(f"launch counts {counts} != expected {want}")
    return counts, {"e_b": eb, "served": served,
                    "serve_wall_s": serve_s}, casc


def profile_stage(torch, casc, batches=(1, 8)):
    """torch.profiler over one tier-0 stage call (one UNet forward and
    the DDIM step) per batch: host wall, device busy time (union of the
    card's kernel intervals), the idle share of the wall, and device time
    by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    cfg, fn, params = casc.stage_fns()[0]
    out = []
    for b in batches:
        toks = torch.zeros((b, PROMPT_LEN), dtype=torch.int64, device=DEV)
        fn(params, toks)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(params, toks)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in kernels)
        busy, end = 0.0, float("-inf")
        for s0, s1 in spans:
            if s1 > end:
                busy += s1 - max(s0, end)
                end = s1
        by_name = {}
        for e in kernels:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        row = {"batch": b, "wall_us": wall_us, "device_busy_us": busy,
               "idle_share": 1.0 - busy / wall_us,
               "device_launches": len(kernels),
               "top": [{"name": n[:90], "count": c, "us": t}
                       for n, (c, t) in top]}
        out.append(row)
        log(f"profile tier-0 stage b={b}: wall {wall_us:.0f} us (profiled),"
            f" device busy {busy:.0f} us, idle share "
            f"{row['idle_share']:.3f}, {len(kernels)} device launches")
        for t in row["top"]:
            log(f"  {t['us']:9.1f} us x{t['count']:4d}  {t['name']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write per-shape details as JSON here")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config.base import DiffusionConfig
    from repro_torch.device import resolve_device
    from repro_torch.models.efficientnet import DiscriminatorConfig
    resolve_device("cuda")           # float32 matmuls and convs: no TF32
    t_start = time.perf_counter()
    details = {"build": header_and_build(torch)}
    full_cfg = DiffusionConfig(name="full-width")
    dcfg = DiscriminatorConfig(in_channels=4)
    calls, details["full_width_check"] = record_path_calls(torch, full_cfg,
                                                           dcfg)
    n_gn = {p: sum(c[0] == "gn" for c in calls[p]) for p in calls}
    n_fa = {p: sum(c[0] == "fa" for c in calls[p]) for p in calls}
    log(f"path calls per forward: groupnorm {n_gn}, attention {n_fa}")
    if (n_gn, n_fa) != (PATH_GN, PATH_FA):
        fail("the path's kernel calls per forward changed")
    fa_entry, fa_rows = check_flash(torch, calls)
    gn_entry, gn_rows = check_groupnorm(torch, calls)
    details["flash_attention"], details["fused_groupnorm"] = fa_rows, gn_rows
    details["small_cascade"] = small_cascade_agrees_with_cpu(torch, np)
    counts, details["slice"], casc = serve_slice(torch, np, full_cfg, dcfg)
    details["profile"] = profile_stage(torch, casc)
    fa_entry["launches"] = counts["flash_attention"]
    gn_entry["launches"] = counts["fused_groupnorm"]
    kernels = []
    for e in (fa_entry, gn_entry):
        kernels.append({k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "per")})
    details["wall_s"] = time.perf_counter() - t_start
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(details, indent=1, default=str))
    log(f"wall {details['wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
