#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the
numbers in PERF.md).

    python3 chip_smoke.py [--out details.json]

Phases, each of which fails the run if it fails:

1. Header: the card's name and power limit (nvidia-smi), then the
   kernels' build from the repository's sources (nvcc for the CUDA C++
   flash attention (three kernels: CUDA cores; tensor cores for bf16 at
   head dims 64 and 128 on wgmma; tensor cores for float32 at head dims
   64 and 128 as 3xTF32 on mma.sync), GroupNorm, decode attention, the
   mLSTM and the selective scan, one process each, in parallel; Triton
   compiles the RMSNorm and SwiGLU kernels at first use). Each CUDA
   kernel's ptxas report (registers, spills) and, where the toolkit has
   ``cuobjdump``, its SASS's count of tensor-core (``HGMMA``, ``HMMA``)
   and asynchronous copy (``UTMALDG``, ``LDGSTS``) instructions; the bf16
   tensor-core flash kernel must hold ``HGMMA`` and ``UTMALDG``, the
   float32 one ``HMMA`` and ``UTMALDG``, decode attention and the mLSTM
   ``HMMA`` and ``LDGSTS``, GroupNorm and the selective scan ``LDGSTS``.

Diffusion path (slice 1):

2. Each kernel against its plain PyTorch version on the card, at the
   shapes the served path gives it (recorded from one full-width UNet
   forward and one discriminator forward at batch 8), with its stated
   tolerance; times of the kernel, the plain version and one PyTorch
   library call (a yardstick the port never calls), beside the least
   time the card could take; flash attention also at b = 1 and, as its
   earlier time, through the CUDA-core kernel at the same inputs; each
   GroupNorm shape's plan (cluster size, mode) is logged, and every path
   shape must hold x in shared memory (mode ``resident``).
3. The slice: the full-width two-tier cascade (64x64x4 latent, base 128,
   tier 0 at 1 DDIM step, tier 1 at 50) behind ``ClusterRuntime``:
   per-tier e(b) from ``measure_profile``, then ``serve_batch`` on
   batches of 1, 3 and 8 with thresholds that defer some queries, with
   every launch counter zeroed just before and read just after; the
   counts must equal the path's. A small cascade served on the card and
   on the CPU (plain versions) must agree. Then ``torch.profiler`` traces
   one tier-0 stage call at batches 1 and 8: device busy time, the idle
   share of the wall, device time by kernel.
4. The live control loop over that cascade and its e(b):
   ``ClusterBackend`` with 4 workers (every slice on this card, each
   batch's measured wall charged to its slice's virtual clock) replays
   ``azure_like_trace(40, seed=2)`` scaled into 1-8 qps under the
   DiffServe control plane (EWMA, the MILP planner over the measured
   e(b), heartbeat, accept-all; SLO = max(10 x tier-1 e(1), 1 s)), with
   every launch counter zeroed just before and read just after. It logs
   the control ticks, distinct plans and the head of the plan timeline;
   total, completed and dropped; violation ratio, goodput, latency p50
   and p99 (virtual clock), defer fraction and FID*; each tier's
   batches by bucket; and each (tier, bucket)'s median in-loop wall
   against the e(b) the planner used. It fails unless
   completed + dropped = total, more than half completed, at least 3
   plans were applied, both tiers ran and a query deferred, and the
   launches equal those of the recorded stage calls (the untimed first
   call at a new bucket included) and scored batches.

Dense LM path (slice 2), after the diffusion path's tensors are freed:

5. Yi-9B at full width but 2 layers in float32: the prefill logits and
   the first decode logits through the kernels against the same forward
   with every ``ops`` function swapped for its plain version (relative
   1e-4).
6. Random Yi-9B at full width and depth in bfloat16 (seeded
   ``torch.Generator``): one prefill of 4 x 512 tokens and one decode
   step through the kernels against the plain versions (relative 5e-2
   on the last-position logits; the share of greedy tokens that agree
   is printed), with every kernel call recorded.
7. Each LM kernel against its plain version at the recorded shapes
   (held in bfloat16 and float32, timed in bfloat16, the path's dtype),
   plus decode attention at one layer of decode_32k, with kernel,
   plain, library and bound times. Times are device times of calls
   queued back to back (``cuda_ms``).
8. The slice: ``serve_prefill`` of 4 prompts of 512 tokens into a cache
   of 1024, then 32 greedy ``serve_decode`` steps, with every launch
   counter zeroed just before and read just after; the counts must
   equal the path's. Prefill time, per-token decode latency (median of
   CUDA events) against the decode step's bytes bound, then
   ``torch.profiler`` traces of one decode step and one prefill.

Recurrent-state paths: xlstm-125m at full width and depth
(mLSTM kernel), then Jamba at full width (Mamba scan kernel, attention
without RoPE, MoE), each after the previous model's tensors are freed:

9. Full width in float32 (xlstm-125m at full depth; Jamba at 2 layers,
   one ("mamba", "moe") and one ("attn", "mlp")): prefill and first
   decode logits through the kernels against the plain versions
   (relative 1e-4).
10. Random bfloat16 weights (xlstm-125m at full depth; Jamba at 16 of
   its 32 layers, 2 of 4 periods, 52 GB): the same against the plain
   versions (relative 5e-2), with every kernel call recorded.
11. The recurrence kernel against its plain version at the recorded
    shapes, held in float32 and in the path's dtypes, timed in the latter
    (``cuda_ms``), beside its bound; no single PyTorch call computes
    either recurrence, so no library time. Each recorded call must have
    taken its length's route (``REC_ROUTES``: the prompt ``chunkwise`` /
    ``scan``, a decode step ``recurrent`` / ``step``); the chunkwise
    mLSTM's bound counts its products on TF32 tensor cores at float32
    accuracy, and the scan's prefill logs its special-function floor
    beside its bytes bound. Jamba's flash and decode attention calls (KH
    8, G 4) are held and timed there as Yi-9B's are in 7.
12. The served run, as in 8: 4 prompts of 512 tokens, 32 greedy decode
    steps (Jamba's attention cache 1024 rows), launch counters zeroed
    just before and read just after and equal to the path's, and the
    recurrence's launches by route equal to one prompt and 32 steps a
    layer; prefill time, median decode step against its bytes bound,
    ``torch.profiler`` traces of one decode step and one prefill.

13. The wall time and the card's line again, one JSON line listing
    every ported kernel, with its launches by path (diffusion, live,
    lm, xlstm, jamba) and, for flash attention, its three routes
    (``tf32x3`` over one UNet forward, ``wgmma`` over one Yi-9B prefill,
    ``cuda_core`` at the UNet's inputs) and, for the mLSTM and the
    selective scan, their two routes, with their times and launches;
    flash attention's float32 route and GroupNorm carry ``was_ms``,
    their earlier kernel's time where this run measured it; then, last,
    the result line
    ``{"ok": true, "device": {...}}``.

Every served run also checks flash attention's launches by route: the
diffusion path's all on ``tf32x3`` (float32, head dim 128), the LM
paths' all on ``wgmma`` (bfloat16, head dim 128).

Exits non-zero, printing no result, without CUDA or without the
repository's ``src/repro_torch`` beside it. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
# float32 attention on TF32 tensor cores at fp32 accuracy takes three
# TF32 products for each one (hi*hi + hi*lo + lo*hi)
TF32_PRODUCTS = 3
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
# the live control loop: workers, and the trace azure_like_trace(40,
# seed=2) scaled into 1-8 qps
LIVE_WORKERS = 4
LIVE_TRACE_S = 40
LIVE_TRACE_SEED = 2
LIVE_QPS = (1, 8)
DEV = "cuda"
CUDA_SOURCES = ("flash_attention", "flash_attention_tc",
                "flash_attention_tf32", "fused_groupnorm", "decode_attention",
                "mlstm_chunk", "mamba_scan")
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")
SASS_NEEDS = {"flash_attention_tc": ("HGMMA", "UTMALDG"),
              "flash_attention_tf32": ("HMMA", "UTMALDG"),
              "fused_groupnorm": ("LDGSTS",),
              "decode_attention": ("HMMA", "LDGSTS"),
              "mlstm_chunk": ("HMMA", "LDGSTS"),
              "mamba_scan": ("LDGSTS",)}
# kernel calls per forward on the full-width path
PATH_GN = {"unet": 41, "disc": 22}      # 35 of the UNet's with SiLU
PATH_FA = {"unet": 6, "disc": 0}
# the LM slice: Yi-9B, 4 prompts of 512 tokens, 32 greedy decode steps
LM_ARCH = "yi-9b"
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 512, 32
EW_TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
          "bfloat16": dict(atol=2e-2, rtol=2e-2)}
LM_FP32_REL = 1e-4      # max |diff| / max |logit|, 2 layers, float32
LM_BF16_REL = 5e-2      # the same at full depth in bfloat16
# the recurrent slices: the same traffic; Jamba cut to 2 of its 4 periods
# (16 layers, 52 GB of bf16 weights) to fit one 80 GB card, and to one
# ("mamba", "moe") and one ("attn", "mlp") layer in float32
REC_ARCHS = ("xlstm-125m", "jamba-v0.1-52b")
JAMBA_LAYERS = 16
JAMBA_FP32_PATTERN = (("mamba", "moe"), ("attn", "mlp"))
# the recurrences carry fp32 state in both versions: fp32 outputs and
# states at 1e-4 (sums over up to 384 rows in another order, over up to
# 512 steps), bf16 outputs at one bf16 rounding
REC_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# the route each served recurrence call takes: a prompt (T > 1) and a
# decode step (T = 1)
REC_ROUTES = {"mlstm": {"prompt": "chunkwise", "step": "recurrent"},
              "mamba": {"prompt": "scan", "step": "step"}}
# a plain recurrence is a host loop of ~15 launches a step: time it over
# fewer calls
PLAIN_REC_ITERS = 3
# decode_32k's outputs are means over 32769 values (typically ~0.01):
# its bf16 atol is 2e-2 of the largest |output|, not 2e-2 absolute
DECODE_32K_REL_ATOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
_CYCLES_PER_MS = []


def _spin(torch, ms: float) -> None:
    """Keep the card busy for about ``ms`` (``torch.cuda._sleep``, its
    clock rate measured at the first call)."""
    if not _CYCLES_PER_MS:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1 << 20)
        e0.record()
        torch.cuda._sleep(1 << 24)
        e1.record()
        e1.synchronize()
        _CYCLES_PER_MS.append((1 << 24) / e0.elapsed_time(e1))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def cuda_ms(torch, fn, iters: int = 20, reps: int = 3) -> float:
    """Device ms of one call. ``iters`` calls, each after a 64 MB write
    that evicts the 50 MB L2 so inputs come from HBM, are queued behind
    a spin kernel long enough for the host to queue them all, so they
    run back to back and the host's launch cost is off the clock; one
    pair of CUDA events spans them. The same run of L2 writes alone is
    subtracted, the difference divided by ``iters``: the median of
    ``reps`` such runs. Where the host cannot queue the calls ahead of
    the card (``fn`` waits for it, as the caching allocator does when
    it must free memory), each call is timed alone between two events
    after its flush, and the median taken; that is logged."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        flush.zero_()
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()

    def run(body):
        for spin_ms in (2 * host_ms + 1, 8 * host_ms + 4):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            _spin(torch, spin_ms)
            e0.record()
            for _ in range(iters):
                flush.zero_()
                body()
            e1.record()
            queued = not e0.query()      # the card still spinning
            e1.synchronize()
            if queued:
                return e0.elapsed_time(e1)
        return None

    per = []
    for _ in range(reps):
        both, alone = run(fn), run(lambda: None)
        if both is None or alone is None:
            break
        per.append(both - alone)
    else:
        per.sort()
        return per[len(per) // 2] / iters
    times = []
    for _ in range(iters):
        flush.zero_()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    log(f"cuda_ms: the host could not queue {iters} calls ahead of the "
        f"card ({host_ms / iters:.3f} ms of host time a call); timed call "
        f"by call: median {times[len(times) // 2]:.4f} ms")
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
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build(CUDA_SOURCES)
    t_nvcc = time.perf_counter() - t0
    ptxas = ptxas_report(libs)
    for ln in ptxas:
        log(f"ptxas: {ln}")
    sass = sass_counts(libs)
    log(f"build: nvcc of the {len(CUDA_SOURCES)} CUDA sources in parallel "
        f"{t_nvcc:.3f} s")
    return {"card": card, "nvcc_s": t_nvcc, "ptxas": ptxas, "sass": sass}


def ptxas_report(libs):
    """One line per kernel instantiation of each library's ptxas log:
    its (mangled) entry name, registers, shared memory and spills."""
    import re
    rows = []
    for lib in libs:
        fn, spill = None, ""
        for ln in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                fn = m.group(1)
            elif "spill" in ln:
                spill = ln.strip()
            elif "registers" in ln and fn:
                rows.append(f"{lib.name.split('-')[0]}: {fn}: "
                            f"{ln.split(':', 1)[-1].strip()}; {spill}")
    return rows


def sass_counts(libs):
    """Per library, the count of tensor-core and asynchronous-copy
    instructions in its SASS (``cuobjdump -sass``); fails where the
    ones named in ``SASS_NEEDS`` lack their tensor-core or asynchronous-
    copy instructions. None where the toolkit has no cuobjdump."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or str(
        Path(build.nvcc()).with_name("cuobjdump"))
    if not Path(tool).is_file():
        log("sass: no cuobjdump in the toolkit; not checked")
        return None
    out = {}
    for lib in libs:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120).stdout
        name = lib.name.split("-")[0]
        out[name] = {op: text.count(op) for op in SASS_OPS}
        log(f"sass {name}: " + ", ".join(f"{op} {n}" for op, n in
                                         out[name].items()))
    for name, ops_ in SASS_NEEDS.items():
        for op in ops_:
            if not out[name][op]:
                fail(f"{name}: no {op} in its SASS")
    return out


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


def _flash_cuda_core(torch, q, k, v, causal, kv_len):
    """The CUDA-core flash kernel (``csrc/flash_attention.cu``), which
    still builds every head dim, called past the wrapper's route: the
    float32 route's earlier kernel, timed beside it at the same inputs.
    Not a launch of the path, so not counted."""
    import math
    from repro_torch.kernels import flash_attention as tflash
    fn, errstr = tflash._forward()
    out = torch.empty_like(q)
    B, Sq, H, D = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
             k.shape[1], H, k.shape[2], D, kv_len or k.shape[1], int(causal),
             1.0 / math.sqrt(D), 0, torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"flash_attention cuda_core: {errstr(err).decode()}")
    return out


def check_flash(torch, calls):
    from repro_torch.device import sm_count
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
             ("path b=1", (1, *qs[1:]), (1, *ks[1:]), False, None,
              "float32"),
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
        way = tflash.route(dt, qshape[-1])
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
        if way == "tf32x3":
            b_ms, b_by = bound_ms(nbytes, TF32_PRODUCTS * flops, "tf32")
        else:
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
        row = {"case": name, "q": qshape, "k": kshape, "causal": causal,
               "kv_len": kv, "dtype": dtype, "route": way,
               "max_abs_err": err,
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
        was = ""
        if way == "tf32x3":
            row["key_groups"] = tflash.plan_key_groups(
                B, H, Sq, sm_count(q.device))
            was = f"; {row['key_groups']} key groups"
            old = _flash_cuda_core(torch, q, k, v, causal, kv)
            torch.testing.assert_close(old, want, **FLASH_TOL[dtype])
            row["was_max_abs_err"] = (old - want).abs().max().item()
            row["was_ms"] = cuda_ms(torch, lambda: _flash_cuda_core(
                torch, q, k, v, causal, kv))
            row["was_bound_ms"] = bound_ms(nbytes, flops, dtype)[0]
            was += (f"; was (cuda_core) {row['was_ms']:.4f} ms, max|err| "
                   f"{row['was_max_abs_err']:.3e}, bound "
                   f"{row['was_bound_ms']:.4f} ms")
        rows.append(row)
        log(f"flash_attention {name}: q {qshape} k {kshape} {dtype} "
            f"causal={causal} kv_len={kv} route {way}: max|err| {err:.3e} "
            f"(tol {FLASH_TOL[dtype]}); kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms, "
            f"bound {b_ms:.4f} ms ({b_by}){was}")
    p = rows[0]
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_tf32.cu",
             "replaces": "src/repro/kernels/flash_attention.py:82",
             "max_abs_err": worst,
             "per": f"one UNet forward at b=8: {per_forward} launches at "
                    f"q {qs} k/v {ks}; was_ms: the CUDA-core kernel there"}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms", "was_ms",
                "was_bound_ms"):
        entry[key] = p[key] * per_forward
    entry["bound_by"] = p["bound_by"]
    entry["was_max_abs_err"] = p["was_max_abs_err"]
    return entry, rows


def check_groupnorm(torch, calls):
    from repro_torch.device import sm_count
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
    sms = sm_count(torch.device(DEV))
    for (shape, groups, act), n in sorted(mult.items()):
        C = shape[-1]
        plan = tgn.plan(shape, groups, sms)
        if plan.mode != "resident":
            fail(f"fused_groupnorm {shape}: planned {plan}; every path "
                 "shape should hold x in shared memory")
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
               "cluster": plan.cluster, "rows": plan.rows, "mode": plan.mode,
               "vec": plan.vec, "smem": plan.smem, "max_abs_err": err,
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
        log(f"fused_groupnorm {shape} g={gg} act={act} x{n} cluster "
            f"{plan.cluster} x {plan.rows} rows, {plan.mode}, vec "
            f"{plan.vec}, {plan.smem} B shared: max|err| "
            f"{err:.3e} (tol {GN_TOL}); kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms,"
            f" bound {b_ms:.4f} ms ({b_by})")
    n_calls = sum(mult.values())
    entry = {"name": "fused_groupnorm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/fused_groupnorm.cu",
             "replaces": "src/repro/kernels/fused_groupnorm.py:36",
             "max_abs_err": worst,
             "ms": tot["ms"], "plain_ms": tot["plain_ms"],
             "bound_ms": tot["bound_ms"],
             "bound_by": "bytes" if tot["t_bytes"] >= tot["t_ops"]
             else "operations",
             "library_ms": tot["library_ms"],
             # the earlier (Triton) kernel is gone from the repository:
             # its time is the parent commit's run, in PERF.md
             "was_ms": None,
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
    from repro_torch.serving.profiles import default_serving
    tier0 = dataclasses.replace(full_cfg, name="tier0-turbo", num_steps=1)
    tier1 = dataclasses.replace(full_cfg, name="tier1-ddim50", num_steps=50)
    stages = [(tier0, init_unet(tier0, seed=0, device=DEV)),
              (tier1, init_unet(tier1, seed=1, device=DEV))]
    casc = DiffusionCascade(stages, dcfg,
                            init_discriminator(dcfg, seed=2, device=DEV),
                            kernel_impl="fused", batch_buckets=BUCKETS,
                            device=DEV, seed=0)
    serving = default_serving("sdturbo", num_workers=LIVE_WORKERS,
                              batch_choices=BUCKETS, kernel_impl="fused",
                              batch_buckets=BUCKETS)
    rt = ClusterRuntime(casc, serving, device=DEV)
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
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({"fused_groupnorm": len(SERVE_SIZES) * (steps * gn_u + gn_d),
                 "flash_attention": len(SERVE_SIZES) * steps * fa_u})
    log(f"launches over {len(SERVE_SIZES)} serves: {counts} (expected "
        f"{want}, total {sum(want.values())}); serve wall {serve_s:.3f} s")
    if counts != want:
        fail(f"launch counts {counts} != expected {want}")
    # the UNet's attention: float32 q (b, 256, 4, 128), head dim 128
    routes = check_routes(torch, "diffusion", full_cfg.dtype, 128, "tf32x3",
                          counts["flash_attention"])
    return counts, {"e_b": eb, "served": served, "serve_wall_s": serve_s,
                    "flash_routes": routes}, casc, rt, profiles


def live_loop(torch, np, casc, rt, profiles):
    """The live control loop at full width: ``ClusterBackend`` replays a
    trace in virtual time under the DiffServe control plane (EWMA demand,
    the MILP planner, heartbeat, accept-all), planning from the e(b) the
    slice phase measured on this card, and runs every batch of the
    cascade for real, charging its measured wall to its slice's clock.
    Every stage call is recorded (the untimed first call at a new bucket
    too), so the kernels' launches can be held to the calls."""
    from repro_torch.config.base import as_cascade_spec
    from repro_torch.kernels import ops
    from repro_torch.serving.baselines import make_profiles
    from repro_torch.serving.cluster import ClusterBackend
    from repro_torch.serving.controlplane import build_control_plane
    from repro_torch.serving.trace import azure_like_trace
    spec = as_cascade_spec(rt.serving.cascade)
    tiers = tuple(dataclasses.replace(t, profile=profiles[i])
                  for i, t in enumerate(spec.tiers))
    spec = dataclasses.replace(spec, tiers=tiers,
                               slo_s=max(10 * profiles[-1].base_s, 1.0))
    serving = dataclasses.replace(rt.serving, cascade=spec)
    deferral = make_profiles(serving, 0)
    control = build_control_plane(spec, serving, deferral)
    backend = ClusterBackend(rt, serving, deferral, seed=0,
                             prompt_len=PROMPT_LEN, device=DEV)
    trace = azure_like_trace(LIVE_TRACE_S, seed=LIVE_TRACE_SEED).scale(
        *LIVE_QPS)
    calls = Counter()                 # (tier, bucket) -> stage calls
    walls = {}                        # (tier, bucket) -> timed walls
    run_stage = backend._run_stage

    def recording(sl, tier, n):
        warmed = len(backend._warmed)
        wall, out = run_stage(sl, tier, n)
        key = (tier, casc.bucket_for(n))
        calls[key] += 1 + len(backend._warmed) - warmed
        walls.setdefault(key, []).append(wall)
        return wall, out
    backend._run_stage = recording
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = backend.serve(control, trace)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    plans = backend.plan_timeline
    distinct = len({p[1:] for p in plans})
    log(f"live loop: slo {spec.slo_s:.3f} s, trace {trace.name} "
        f"({trace.duration_s:.0f} s, {LIVE_QPS[0]}-{LIVE_QPS[1]} qps), "
        f"{serving.num_workers} workers; wall {loop_s:.1f} s")
    log(f"live loop: {len(plans)} control ticks, {distinct} distinct "
        f"plans; head " + "; ".join(
            f"t={t:.0f} w={list(w)} b={list(b)}" for t, w, b in plans[:8]))
    lat = np.percentile(r.latencies, (50, 99)) if r.latencies else (0, 0)
    log(f"live loop: total {r.total}, completed {r.completed}, dropped "
        f"{r.dropped}; violation ratio {r.violation_ratio:.4f}, goodput "
        f"{r.goodput:.4f}, defer fraction {r.defer_fraction:.4f}, FID* "
        f"{r.mean_fid:.4f}; latency p50 {lat[0]:.3f} s, p99 {lat[1]:.3f} s "
        f"(virtual clock); thresholds "
        f"{sorted({th for _, th in r.threshold_timeline})}")
    timed = {k: len(v) for k, v in walls.items()}
    n_tiers = spec.num_tiers
    fit_vs_wall = []
    for tier in range(n_tiers):
        by_bucket = {b: timed[(t, b)] for t, b in sorted(timed) if t == tier}
        log(f"live loop: tier {tier} batches by bucket {by_bucket}")
        points = dict(rt.last_stage_times[tier])
        for (t, b) in sorted(walls):
            if t != tier:
                continue
            med = float(np.median(walls[(t, b)]))
            planned = profiles[tier].exec_latency(b)
            fit_vs_wall.append({"tier": tier, "bucket": b,
                                "batches": timed[(t, b)],
                                "median_wall_s": med,
                                "planner_e_b_s": planned,
                                "measured_e_b_s": points.get(b)})
            log(f"  tier {tier} bucket {b}: median in-loop wall "
                f"{med * 1e3:.2f} ms over {timed[(t, b)]} batches; planner "
                f"e(b) {planned * 1e3:.2f} ms (fit), measured point "
                + (f"{points[b] * 1e3:.2f} ms" if b in points else "none")
                + f"; wall / planner {med / planned:.3f}")
    # launches: a tier-0 call 41 GN + 6 attention per UNet step, a scored
    # batch 22 GN (the discriminator), a tier-1 call 50 UNet steps
    gn_u, gn_d, fa_u = PATH_GN["unet"], PATH_GN["disc"], PATH_FA["unet"]
    steps = [cfg.num_steps for cfg, _ in casc.stages]
    scored = sum(n for (t, _), n in timed.items() if t < n_tiers - 1)
    stage_calls = [sum(n for (t, _), n in calls.items() if t == tier)
                   for tier in range(n_tiers)]
    untimed = [c - sum(n for (t, _), n in timed.items() if t == tier)
               for tier, c in enumerate(stage_calls)]
    want = dict.fromkeys(ops.KERNELS, 0)
    want["fused_groupnorm"] = scored * gn_d + sum(
        c * s * gn_u for c, s in zip(stage_calls, steps))
    want["flash_attention"] = sum(c * s * fa_u
                                  for c, s in zip(stage_calls, steps))
    log(f"live loop launches: {counts} (expected {want}: stage calls per "
        f"tier {stage_calls}, of them untimed first calls {untimed}, "
        f"scored batches {scored})")
    if r.completed + r.dropped != r.total:
        fail(f"live loop: completed {r.completed} + dropped {r.dropped} != "
             f"total {r.total}")
    if not r.completed > 0.5 * r.total:
        fail(f"live loop: only {r.completed} of {r.total} completed")
    if len(plans) < 3:
        fail(f"live loop: {len(plans)} plans applied, expected >= 3")
    if any(c == 0 for c in stage_calls) or r.deferred < 1:
        fail(f"live loop: stage calls per tier {stage_calls}, "
             f"{r.deferred} deferred: every tier must run and a query "
             "must defer")
    if counts != want:
        fail(f"live loop launch counts {counts} != expected {want}")
    routes = check_routes(torch, "live loop", "float32", 128, "tf32x3",
                          counts["flash_attention"])
    return counts, {
        "slo_s": spec.slo_s, "trace": trace.name,
        "workers": serving.num_workers, "wall_s": loop_s,
        "control_ticks": len(plans), "distinct_plans": distinct,
        "plan_timeline": [[t, list(w), list(b)] for t, w, b in plans],
        "total": r.total, "completed": r.completed, "dropped": r.dropped,
        "violation_ratio": r.violation_ratio, "goodput": r.goodput,
        "latency_p50_s": float(lat[0]), "latency_p99_s": float(lat[1]),
        "defer_fraction": r.defer_fraction, "fid_star": r.mean_fid,
        "thresholds": [[t, list(th)] for t, th in r.thresholds_timeline],
        "completed_per_tier": r.completed_per_tier,
        "stage_calls": stage_calls, "scored_batches": scored,
        "e_b_against_wall": fit_vs_wall, "flash_routes": routes}


def check_routes(torch, what, dtype, head_dim, way, n_flash):
    """Flash attention's launches by route since the counters were last
    zeroed: all ``n_flash`` on ``way``, which must be the route of
    ``dtype`` at ``head_dim`` where there are any."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ops
    if n_flash and tflash.route(getattr(torch, dtype), head_dim) != way:
        fail(f"{what}: {dtype} at head dim {head_dim} is routed to "
             f"{tflash.route(getattr(torch, dtype), head_dim)}, not {way}")
    routes = ops.route_counts()
    want = dict.fromkeys(tflash.ROUTES, 0)
    want[way] = n_flash
    log(f"flash attention launches by route over the {what} run: {routes} "
        f"(expected {want})")
    if routes != want:
        fail(f"{what}: flash attention routes {routes} != expected {want}")
    return routes


def trace_call(torch, fn):
    """torch.profiler over one call of ``fn`` (warmed up first): host
    wall, device busy time (union of the card's kernel intervals), the
    idle share of the wall, and device time and launches by kernel name,
    largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s0, s1 in spans:
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"wall_us": wall_us, "device_busy_us": busy,
            "idle_share": 1.0 - busy / wall_us,
            "device_launches": len(kernels),
            "by_kernel": [{"name": n[:90], "count": c, "us": t}
                          for n, (c, t) in ranked]}


def log_trace(what: str, row) -> None:
    log(f"profile {what}: wall {row['wall_us']:.0f} us (profiled), device "
        f"busy {row['device_busy_us']:.0f} us, idle share "
        f"{row['idle_share']:.3f}, {row['device_launches']} device launches")
    for t in row["by_kernel"][:12]:
        log(f"  {t['us']:9.1f} us x{t['count']:4d}  {t['name']}")


def profile_stage(torch, casc, batches=(1, 8)):
    """``trace_call`` over one tier-0 stage call (one UNet forward and
    the DDIM step) per batch."""
    cfg, fn, params = casc.stage_fns()[0]
    out = []
    for b in batches:
        toks = torch.zeros((b, PROMPT_LEN), dtype=torch.int64, device=DEV)
        row = {"batch": b, **trace_call(torch, lambda: fn(params, toks))}
        out.append(row)
        log_trace(f"tier-0 stage b={b}", row)
    return out


# ---------------------------------------------------------------------------
# the dense LM path (slice 2)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def plain_ops():
    """Every ``ops`` function swapped for its plain version
    (``ops.PLAIN``), on whatever device the tensors are."""
    from repro_torch.kernels import ops
    saved = {name: getattr(ops, name) for name in ops.PLAIN}
    for name, plain in ops.PLAIN.items():
        setattr(ops, name, plain)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def recorded_calls(calls):
    """Appends (kind, shapes, dtype, extra) of every LM kernel call (the
    recurrences' too, whose extra ends with the route the call took) to
    ``calls`` and passes the call on to the kernel."""
    from repro_torch.kernels import ops
    saved = {name: getattr(ops, name) for name in ops.PLAIN}

    def dt(t):
        return str(t.dtype).split(".")[-1]

    def rms(x, scale, *, residual=None, eps=1e-5):
        calls.append(("rmsnorm_res" if residual is not None else "rmsnorm",
                      tuple(x.shape), dt(x), None))
        return saved["fused_rmsnorm"](x, scale, residual=residual, eps=eps)

    def swiglu(g, u):
        calls.append(("swiglu", tuple(g.shape), dt(g), None))
        return saved["swiglu"](g, u)

    def flash(q, k, v, *, causal=True, kv_len=None):
        calls.append(("flash", (tuple(q.shape), tuple(k.shape)), dt(q),
                      causal))
        return saved["flash_attention"](q, k, v, causal=causal,
                                        kv_len=kv_len)

    def decode(q, k, v, valid_len):
        calls.append(("decode", (tuple(q.shape), tuple(k.shape)), dt(q),
                      tuple(valid_len.tolist())))
        return saved["decode_attention"](q, k, v, valid_len)

    def took(kernel, call):
        """``call``'s result and the route it launched ``kernel`` on (None
        where no route moved: a plain version on a CPU tensor)."""
        before = ops.route_counts(kernel)
        out = call()
        moved = [w for w, c in ops.route_counts(kernel).items()
                 if c != before[w]]
        return out, (moved[0] if moved else None)

    def mlstm(q, k, v, i_pre, f_pre, C, n, m):
        h, way = took("mlstm_chunk", lambda: saved["mlstm_chunk"](
            q, k, v, i_pre, f_pre, C, n, m))
        calls.append(("mlstm", (tuple(q.shape), tuple(v.shape)), dt(q),
                      (dt(i_pre), way)))
        return h

    def mamba(u, dt_, A, B, C, D, h):
        y, way = took("mamba_scan", lambda: saved["mamba_scan"](
            u, dt_, A, B, C, D, h))
        calls.append(("mamba", (tuple(u.shape), tuple(A.shape)), dt(u),
                      (dt(dt_), dt(B), dt(C), way)))
        return y
    ops.fused_rmsnorm, ops.swiglu = rms, swiglu
    ops.flash_attention, ops.decode_attention = flash, decode
    ops.mlstm_chunk, ops.mamba_scan = mlstm, mamba
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def prefill_and_first_decode(torch, cfg, params, prompts, next_tok=None):
    """(prefill logits, first decode logits, the decoded token, the
    decode step's greedy token) on a fresh cache; ``next_tok`` fixes the
    decoded token (else the prefill's greedy one)."""
    from repro_torch.launch.steps import serve_decode, serve_prefill
    from repro_torch.models.kvcache import init_cache
    B, S = prompts.shape
    cache = init_cache(cfg, B, 2 * S, DEV)
    lp, cache = serve_prefill(params, cfg, cache, prompts)
    tok = lp.argmax(-1, keepdim=True) if next_tok is None else next_tok
    ld, cache = serve_decode(params, cfg, cache, tok, S)
    return lp.float(), ld.float(), tok, ld.argmax(-1)


def rel_diff(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def lm_logits_check(torch, cfg, params, prompts, rel_tol, what):
    """The kernel path's prefill and first decode logits against the same
    forward through the plain versions; returns the kernel path's calls
    and the numbers."""
    calls = []
    with recorded_calls(calls):
        kp, kd, tok, ktok = prefill_and_first_decode(torch, cfg, params,
                                                     prompts)
    with plain_ops():
        pp, pd, _, ptok = prefill_and_first_decode(torch, cfg, params,
                                                   prompts, tok)
    torch.cuda.synchronize()
    for name, t in (("prefill", kp), ("decode", kd)):
        if not torch.isfinite(t).all() or t.shape != (prompts.shape[0],
                                                      cfg.vocab_size):
            fail(f"{what}: {name} logits not finite of shape "
                 f"{(prompts.shape[0], cfg.vocab_size)}")
    err_p, err_d = rel_diff(kp, pp), rel_diff(kd, pd)
    agree = torch.cat([tok[:, 0] == pp.argmax(-1), ktok == ptok]).float()
    log(f"{what}: kernels vs plain versions, max|diff|/max|logit| prefill "
        f"{err_p:.3e}, first decode {err_d:.3e} (tolerance {rel_tol}); "
        f"greedy tokens agree {agree.mean().item():.3f} of {agree.numel()}; "
        f"max|logit| {pp.abs().max().item():.3f}")
    if max(err_p, err_d) > rel_tol:
        fail(f"{what}: logits differ from the plain path by "
             f"{max(err_p, err_d):.3e} > {rel_tol}")
    return calls, {"prefill_rel_diff": err_p, "decode_rel_diff": err_d,
                   "greedy_agree": agree.mean().item()}


def path_counts(cfg, prefills: int, decodes: int):
    """Launches of every kernel over ``prefills`` prefill and ``decodes``
    decode forwards of ``cfg``'s path: per forward, with RMSNorm, one
    a layer for ``ln1``, one for ``ln2`` fused with the residual add
    (layers with an FFN) and one for the final norm; SwiGLU once per
    SwiGLU MLP or MoE layer; attention once per attention layer (flash
    in prefill, decode attention at S = 1); each recurrence once per
    layer of its mixer."""
    from repro_torch.kernels import ops
    specs = cfg.flat_pattern()
    fwd = prefills + decodes
    mixers = Counter(mixer for mixer, _ in specs)
    n_ffn = sum(ffn is not None for _, ffn in specs)
    n_swiglu = sum(ffn == "moe" or (ffn == "mlp" and cfg.mlp == "swiglu")
                   for _, ffn in specs)
    rms = cfg.norm == "rmsnorm"
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({"flash_attention": mixers["attn"] * prefills,
                 "decode_attention": mixers["attn"] * decodes,
                 "fused_rmsnorm": (len(specs) + n_ffn + 1) * fwd if rms
                 else 0,
                 "swiglu": n_swiglu * fwd,
                 "mlstm_chunk": mixers["mlstm"] * fwd,
                 "mamba_scan": mixers["mamba"] * fwd})
    return want


def path_calls(calls, cfg):
    """Check the recorded calls of one prefill and one decode forward
    against the path's (``path_counts``), RMSNorm's two variants apart."""
    n = dict(Counter(kind for kind, *_ in calls))
    c = path_counts(cfg, 1, 1)
    specs = cfg.flat_pattern()
    n_res = sum(ffn is not None for _, ffn in specs) * 2 \
        if cfg.norm == "rmsnorm" else 0
    want = {"rmsnorm": c["fused_rmsnorm"] - n_res, "rmsnorm_res": n_res,
            "swiglu": c["swiglu"], "flash": c["flash_attention"],
            "decode": c["decode_attention"], "mlstm": c["mlstm_chunk"],
            "mamba": c["mamba_scan"]}
    want = {k: v for k, v in want.items() if v}
    log(f"{cfg.name} path calls in one prefill + one decode step: {n} "
        f"(expected {want})")
    if n != want:
        fail(f"{cfg.name}: the path's kernel calls per forward changed")


def _time_rows(torch, kernel, plain, library, nbytes, flops, dtype):
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    return {"ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain),
            "library_ms": None if library is None else cuda_ms(torch,
                                                               library),
            "bound_ms": b_ms, "bound_by": b_by}


def _sdpa(torch, q, k, v, causal):
    """One ``scaled_dot_product_attention`` call on (B, S, H, D) layouts
    with GQA, through the flash or memory-efficient backends only (the
    math backend would repeat K/V for every query head); None when
    neither takes the shapes."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    def call():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(*args, is_causal=causal,
                                                  enable_gqa=True)
    try:
        call()
    except RuntimeError as err:
        log(f"library attention: no flash/efficient SDPA backend for q "
            f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}: "
            f"{str(err).splitlines()[0][:120]}")
        return None
    return call


def _decode_inputs(torch, g, qs, ks, valid, dt):
    """Decode-attention inputs and the bytes and flops the call needs:
    q and the output once, the live rows of K and V once."""
    q = torch.randn(qs, generator=g, device=DEV).to(dt)
    k = torch.randn(ks, generator=g, device=DEV).to(dt)
    v = torch.randn(ks, generator=g, device=DEV).to(dt)
    vl = torch.tensor(valid, dtype=torch.int32, device=DEV)
    B, H, D = qs
    el = q.element_size()
    live = sum(valid)
    nbytes = 2 * q.numel() * el + 2 * live * ks[2] * D * el + 4 * B
    return q, k, v, vl, nbytes, 4.0 * live * H * D


def _hold(torch, name, got, want, dtype, tol=None):
    """Hold a kernel's output (or tuple of outputs) against its plain
    version's; returns (max |error|, tolerance)."""
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) \
        else [(got, want)]
    err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    tol = tol or (FLASH_TOL if "attention" in name else EW_TOL)[dtype]
    for a, b in pairs:
        torch.testing.assert_close(a, b, **tol)
    return err, tol


def _report(name, row, what):
    lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    log(f"{name} {what}: max|err| {row['max_abs_err']:.3e}; kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
        f"{lib} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")


def _lm_case(torch, g, kind, shape, extra, dt, timed):
    """(kernel name, kernel call, plain call, library call or None, bytes
    and flops of the function) for one recorded LM kernel call, on fresh
    inputs; the attention library calls are probed only for a row that
    is ``timed``."""
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import fused_rmsnorm as trms
    from repro_torch.kernels import ref
    from repro_torch.kernels import swiglu as tsw
    F = torch.nn.functional
    el = torch.tensor([], dtype=dt).element_size()
    if kind in ("rmsnorm", "rmsnorm_res"):
        D = shape[-1]
        x = (torch.randn(shape, generator=g, device=DEV) * 3).to(dt)
        r = torch.randn(shape, generator=g, device=DEV).to(dt) \
            if kind == "rmsnorm_res" else None
        s = torch.rand(D, generator=g, device=DEV) + 0.5
        sl = s.to(dt)
        return ("fused_rmsnorm",
                lambda: trms.fused_rmsnorm(x, s, residual=r),
                lambda: ref.rmsnorm_ref(x, s, residual=r),
                lambda: F.rms_norm(x if r is None else x + r, (D,), sl, 1e-5),
                (2 if r is None else 4) * x.numel() * el + 4 * D,
                (4 if r is None else 5) * x.numel())
    if kind == "swiglu":
        gate = (torch.randn(shape, generator=g, device=DEV) * 4).to(dt)
        up = torch.randn(shape, generator=g, device=DEV).to(dt)
        return ("swiglu", lambda: tsw.swiglu(gate, up),
                lambda: ref.swiglu_ref(gate, up),
                lambda: F.silu(gate) * up,
                3 * gate.numel() * el, 5 * gate.numel())
    if kind == "flash":
        (qs, ks), causal = shape, extra
        q = torch.randn(qs, generator=g, device=DEV).to(dt)
        k = torch.randn(ks, generator=g, device=DEV).to(dt)
        v = torch.randn(ks, generator=g, device=DEV).to(dt)
        B, Sq, H, D = qs
        return ("flash_attention",
                lambda: tflash.flash_attention(q, k, v, causal=causal),
                lambda: ref.flash_attention_ref(q, k, v, causal=causal),
                _sdpa(torch, q, k, v, causal) if timed else None,
                (2 * q.numel() + 2 * k.numel()) * el,
                4.0 * B * H * Sq * (Sq + 1) / 2 * D)
    (qs, ks), valid = shape, extra
    q, k, v, vl, nbytes, flops = _decode_inputs(torch, g, qs, ks, valid, dt)
    top = max(valid)
    return ("decode_attention",
            lambda: tdec.decode_attention(q, k, v, vl),
            lambda: ref.decode_attention_ref(q, k, v, vl),
            _sdpa(torch, q[:, None], k[:, :top], v[:, :top], False)
            if timed and len(set(valid)) == 1 else None, nbytes, flops)


def hold_lm_calls(torch, g, calls, kinds, what=""):
    """Each recorded LM kernel call of the given kinds against its plain
    version, once per distinct shape: in bfloat16 (the path's dtype;
    held and timed) and float32 (held only). Returns the bf16 rows by
    kernel name and the worst float32 error by kernel name."""
    from repro_torch.kernels import flash_attention as tflash
    mult = Counter((kind, shape, extra) for kind, shape, _, extra in calls
                   if kind in kinds)
    rows, worst = {}, {}
    for (kind, shape, extra), n in sorted(mult.items(), key=str):
        for dtype in ("bfloat16", "float32"):
            name, kernel, plain, library, nbytes, flops = _lm_case(
                torch, g, kind, shape, extra, getattr(torch, dtype),
                dtype == "bfloat16")
            err, tol = _hold(torch, name, kernel(), plain(), dtype)
            label = f"{what}{kind} {shape} {extra or ''} {dtype} x{n} " \
                    f"(tol {tol})"
            if dtype == "float32":
                worst[name] = max(worst.get(name, 0.0), err)
                log(f"{name} {label}: max|err| {err:.3e}")
                continue
            row = {"kind": kind, "shape": shape, "extra": extra,
                   "dtype": dtype, "per_path": n, "max_abs_err": err,
                   "route": tflash.route(getattr(torch, dtype), shape[0][-1])
                   if kind == "flash" else None,
                   **_time_rows(torch, kernel, plain, library, nbytes,
                                flops, dtype)}
            rows.setdefault(name, []).append(row)
            _report(name, row, label)
    return rows, worst


def check_lm_kernels(torch, calls):
    """Each LM kernel against its plain version at the path's shapes, in
    bfloat16 (the path's dtype; timed) and float32 (held only); decode
    attention also at one layer of decode_32k, in bfloat16 at a
    tolerance set from its outputs' scale. Returns the kernel-line
    entries (times summed over one prefill forward and one decode step,
    bf16) and the per-shape rows."""
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import ref
    from repro_torch.launch.steps import cache_len
    g = torch.Generator(device=DEV).manual_seed(13)
    # path_calls has checked that every kind below was recorded
    rows, worst = hold_lm_calls(
        torch, g, calls, ("rmsnorm", "rmsnorm_res", "swiglu", "flash",
                          "decode"))
    # one layer of decode_32k: B 128, 32768 tokens of history plus the
    # one being written, in a cache of cache_len(decode_32k) rows
    shp = SHAPES["decode_32k"]
    B, T, valid = shp.global_batch, cache_len(shp), shp.seq_len + 1
    gc.collect()
    torch.cuda.empty_cache()
    q, k, v, vl, nbytes, flops = _decode_inputs(
        torch, g, (B, 32, 128), (B, T, 4, 128), (valid,) * B,
        torch.bfloat16)
    want = ref.decode_attention_ref(q, k, v, vl)
    tol = dict(atol=DECODE_32K_REL_ATOL * want.abs().max().item(),
               rtol=FLASH_TOL["bfloat16"]["rtol"])
    err, tol = _hold(torch, "decode_attention",
                     tdec.decode_attention(q, k, v, vl), want, "bfloat16",
                     tol)
    del want
    t = _time_rows(torch, lambda: tdec.decode_attention(q, k, v, vl),
                   lambda: ref.decode_attention_ref(q, k, v, vl),
                   _sdpa(torch, q[:, None], k[:, :valid], v[:, :valid],
                         False), nbytes, flops, "bfloat16")
    row = {"kind": "decode_32k one layer",
           "shape": ((B, 32, 128), (B, T, 4, 128)), "extra": valid,
           "dtype": "bfloat16", "per_path": 0, "max_abs_err": err,
           "tol": tol, "gb_per_s": nbytes / t["ms"] / 1e6, **t}
    rows["decode_attention"].append(row)
    _report("decode_attention", row, f"decode_32k one layer q {(B, 32, 128)}"
           f" k/v {(B, T, 4, 128)} valid {valid} bfloat16 (tol {tol}, "
           f"{row['gb_per_s']:.0f} GB/s)")
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    source = {"decode_attention": (
                  "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                  "src/repro/kernels/decode_attention.py:62"),
              # its wgmma route; main() folds it into flash's entry
              "flash_attention": (
                  "cuda", "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                  "src/repro/kernels/flash_attention.py:82"),
              "fused_rmsnorm": ("triton",
                                "src/repro_torch/kernels/fused_rmsnorm.py",
                                "src/repro/kernels/fused_rmsnorm.py:30"),
              "swiglu": ("triton", "src/repro_torch/kernels/swiglu.py",
                         "src/repro/kernels/swiglu.py:17")}
    # the wgmma route takes the bf16 calls only: its error is theirs
    worst["flash_attention"] = max(r["max_abs_err"]
                                   for r in rows["flash_attention"])
    entries = {}
    for name, (route, src, replaces) in source.items():
        path = [r for r in rows[name] if r["dtype"] == "bfloat16"
                and r["per_path"]]
        tot = {key: sum(r["per_path"] * (r[key] or 0.0) for r in path)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        if any(r["library_ms"] is None for r in path):
            tot["library_ms"] = None
        t_bytes = sum(r["per_path"] * r["bound_ms"] for r in path
                      if r["bound_by"] == "bytes")
        entries[name] = {
            "name": name, "route": route, "source": src,
            "replaces": replaces, "max_abs_err": worst[name], **tot,
            "bound_by": "bytes" if 2 * t_bytes >= tot["bound_ms"]
            else "operations",
            "per": f"one {LM_ARCH} prefill ({LM_BATCH}x{LM_PROMPT}) and "
                   f"one decode step, bfloat16: "
                   f"{sum(r['per_path'] for r in path)} launches"}
    return entries, rows


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def serve_lm(torch, cfg, params):
    """The slice: one prefill of LM_BATCH prompts of LM_PROMPT tokens and
    LM_STEPS greedy decode steps, launch counters zeroed just before and
    read just after; then a profiled decode step."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import cache_len, serve_decode, serve_prefill
    from repro_torch.models import layers as L
    from repro_torch.models.kvcache import init_cache
    T = cache_len(ShapeConfig("smoke_decode", "decode",
                              LM_PROMPT + LM_STEPS, LM_BATCH))
    g = torch.Generator(device=DEV).manual_seed(50)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=g, device=DEV)
    cache = init_cache(cfg, LM_BATCH, T, DEV)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(LM_STEPS)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = serve_prefill(params, cfg, cache, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tokens = [logits.argmax(-1, keepdim=True)]
    finite = [torch.isfinite(logits).all()]
    # every MoE call of the decode steps keeps its router and input (a
    # reference each, no device work), so that the bound below counts
    # the experts this run's tokens are routed to
    moe_apply, routed = L.moe_apply, []

    def recording_moe(p, c, x):
        routed.append((p["router"], x))
        return moe_apply(p, c, x)
    L.moe_apply = recording_moe
    t0 = time.perf_counter()
    try:
        for step, (e0, e1) in enumerate(events):
            e0.record()
            logits, cache = serve_decode(params, cfg, cache, tokens[-1],
                                         LM_PROMPT + step)
            e1.record()
            tokens.append(logits.argmax(-1, keepdim=True))
            finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
    finally:
        L.moe_apply = moe_apply
    decode_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = path_counts(cfg, 1, LM_STEPS)
    step_ms = sorted(e0.elapsed_time(e1) for e0, e1 in events)
    median = step_ms[len(step_ms) // 2]
    gen = torch.cat(tokens, dim=1)
    log(f"slice {cfg.name} {cfg.dtype}: prefill {LM_BATCH}x{LM_PROMPT} "
        f"{prefill_s * 1e3:.2f} ms; {LM_STEPS} decode steps: per-token "
        f"latency median {median:.3f} ms (min {step_ms[0]:.3f}, max "
        f"{step_ms[-1]:.3f}; CUDA events), host wall "
        f"{decode_s * 1e3 / LM_STEPS:.3f} ms a step")
    log(f"launches over the {cfg.name} slice: {counts} (expected {want})")
    if counts != want:
        fail(f"{cfg.name} launch counts {counts} != expected {want}")
    routes = check_routes(torch, cfg.name, cfg.dtype, cfg.resolved_head_dim,
                          "wgmma", counts["flash_attention"])
    rec_routes = {}
    for name, kind in (("mlstm_chunk", "mlstm"), ("mamba_scan", "mamba")):
        layers = sum(mixer == kind for mixer, _ in cfg.flat_pattern())
        if not layers:
            continue
        rec_routes[name] = ops.route_counts(name)
        exp = {REC_ROUTES[kind]["prompt"]: layers,
               REC_ROUTES[kind]["step"]: layers * LM_STEPS}
        log(f"{name} launches by route over the {cfg.name} run: "
            f"{rec_routes[name]} (expected {exp})")
        if rec_routes[name] != exp:
            fail(f"{cfg.name}: {name} routes {rec_routes[name]} != {exp}")
    if not bool(torch.stack(finite).all()) or logits.shape != (
            LM_BATCH, cfg.vocab_size):
        fail(f"{cfg.name} slice: logits not finite or of the wrong shape")
    if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        fail(f"{cfg.name} slice: generated tokens outside the vocabulary")
    # the decode step's bytes bound: every weight but the embedding table
    # (the step gathers 4 of its rows) and the experts no token of the
    # step is routed to, the live K/V rows once, and every recurrent
    # state read and written once
    experts = ("e_wi", "e_wg", "e_wo")
    e_bytes = sum(t.numel() * t.element_size() for name, t in _named(params)
                  if name.rsplit("/", 1)[-1] in experts)
    w_bytes = sum(t.numel() * t.element_size() for name, t in _named(params)
                  if name != "embed/embedding") - e_bytes
    n_attn = sum(mixer == "attn" for mixer, _ in cfg.flat_pattern())
    kv_bytes = 2 * n_attn * LM_BATCH * (LM_PROMPT + LM_STEPS // 2) \
        * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    state_bytes = 2 * sum(t.numel() * t.element_size() for entry in cache
                          for name, t in entry.items()
                          if name not in ("k", "v"))
    routed_bytes = [0.0] * LM_STEPS
    n_moe = sum(ffn == "moe" for _, ffn in cfg.flat_pattern())
    if n_moe:
        if len(routed) != n_moe * LM_STEPS:
            fail(f"{cfg.name}: {len(routed)} MoE calls recorded over the "
                 f"decode steps, expected {n_moe * LM_STEPS}")
        per_expert = e_bytes / (n_moe * cfg.moe.num_experts)
        for i, (router, x) in enumerate(routed):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router,
                                  dim=-1)
            hit = torch.topk(probs, cfg.moe.top_k, dim=-1).indices.unique()
            routed_bytes[i // n_moe] += hit.numel() * per_expert
    step_bounds = [(w_bytes + r + kv_bytes + state_bytes) / PEAK_BYTES_S
                   * 1e3 for r in routed_bytes]
    step_bound = sum(step_bounds) / LM_STEPS
    mean_routed = sum(routed_bytes) / LM_STEPS
    log(f"decode step bound (mean of the {LM_STEPS} steps): "
        f"{w_bytes / 1e9:.2f} GB of weights but experts + "
        f"{mean_routed / 1e9:.2f} GB of the experts the step routes to + "
        f"{kv_bytes / 1e9:.3f} GB of live K/V (mean step) + "
        f"{state_bytes / 1e9:.4f} GB of recurrent state in and out at "
        f"{PEAK_BYTES_S / 1e12:.2f} TB/s = {step_bound:.3f} ms (steps "
        f"{min(step_bounds):.3f}..{max(step_bounds):.3f}); the median "
        f"step takes {median / step_bound:.2f}x the bound")
    if n_moe:
        disp = (w_bytes + e_bytes + kv_bytes + state_bytes) / PEAK_BYTES_S \
            * 1e3
        log(f"the capacity dispatch reads all {cfg.moe.num_experts} experts "
            f"of each MoE layer: {e_bytes / 1e9:.2f} GB of experts, not "
            f"{mean_routed / 1e9:.2f}; its step reads {disp:.3f} ms of "
            f"bytes, {disp / step_bound:.2f}x the step's bound")
    prof = trace_call(torch, lambda: serve_decode(
        params, cfg, cache, tokens[-1], LM_PROMPT + LM_STEPS - 1))
    log_trace(f"{cfg.name} decode step b={LM_BATCH}", prof)
    # the same prompts again: rows 0..LM_PROMPT-1 get the same K/V (a
    # recurrent state just runs on: the work is the same)
    prof_prefill = trace_call(torch, lambda: serve_prefill(
        params, cfg, cache, prompts))
    log_trace(f"{cfg.name} prefill {LM_BATCH}x{LM_PROMPT}", prof_prefill)
    return counts, {"prefill_ms": prefill_s * 1e3, "decode_step_ms": step_ms,
                    "decode_step_median_ms": median,
                    "decode_host_wall_ms": decode_s * 1e3 / LM_STEPS,
                    "decode_step_bound_ms": step_bound,
                    "decode_step_bounds_ms": step_bounds,
                    "weight_bytes": w_bytes, "routed_expert_bytes":
                    routed_bytes, "expert_bytes": e_bytes,
                    "state_bytes": state_bytes,
                    "cache_len": T,
                    "generated": gen.tolist(), "profile_decode": prof,
                    "profile_prefill": prof_prefill, "flash_routes": routes,
                    "rec_routes": rec_routes}


def lm_phase(torch):
    """Slice 2: the logits checks, the kernels at the path's shapes, the
    served prefill and decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    full = get_config(LM_ARCH)
    g = torch.Generator(device=DEV).manual_seed(60)
    prompts = torch.randint(0, full.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=g, device=DEV)
    details = {}
    # (a) full width, 2 layers, float32
    small = dataclasses.replace(full, num_layers=2, dtype="float32")
    params = init_params(small, seed=61, device=DEV)
    _, details["fp32_2_layers"] = lm_logits_check(
        torch, small, params, prompts, LM_FP32_REL,
        f"{LM_ARCH} full width 2 layers float32")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (b) full width and depth, bfloat16
    t0 = time.perf_counter()
    params = init_params(full, seed=62, device=DEV)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for _, t in _named(params))
    log(f"{LM_ARCH} random init: {n_bytes / 1e9:.2f} GB bfloat16 in "
        f"{time.perf_counter() - t0:.2f} s")
    calls, details["bf16_full_depth"] = lm_logits_check(
        torch, full, params, prompts, LM_BF16_REL,
        f"{LM_ARCH} full width and depth bfloat16")
    path_calls(calls, full)
    entries, details["kernels"] = check_lm_kernels(torch, calls)
    counts, details["slice"] = serve_lm(torch, full, params)
    for name, e in entries.items():
        e["launches"] = counts[name]
    return entries, counts, details


# ---------------------------------------------------------------------------
# the recurrent-state paths: xlstm-125m and Jamba
# ---------------------------------------------------------------------------
def _rec_case(torch, g, kind, shape, dt, extra, fp32):
    """(kernel call, plain call, bytes, flops, the peak they run at
    (``PEAK_FLOPS_S``), the kernel's state, the plain version's state) of
    one recorded recurrence call on fresh inputs, in the path's dtypes or
    (``fp32``) all float32. The state is zero (m = -inf) for a prompt and
    one reached mid-sequence for a decode step; each call of the pair
    gets its own copy, since both overwrite it."""
    from repro_torch.kernels import mamba_scan as tmamba
    from repro_torch.kernels import mlstm_chunk as tmlstm
    from repro_torch.kernels import ref
    f32 = torch.float32

    def typed(name):
        return f32 if fp32 else getattr(torch, name)

    def rand(shp, dtype=f32, scale=1.0):
        return (torch.randn(shp, generator=g, device=DEV) * scale).to(dtype)
    if kind == "mlstm":
        (B, T, H, dk), (_, _, _, dv) = shape
        q, v = rand((B, T, H, dk), typed(dt)), rand((B, T, H, dv), typed(dt))
        k = rand((B, T, H, dk), typed(dt), dk ** -0.5)
        ip, fp = rand((B, T, H), typed(extra[0])), \
            (rand((B, T, H)) + 2.0).to(typed(extra[0]))
        if T == 1:
            state = (rand((B, H, dk, dv), scale=0.3),
                     rand((B, H, dk)).abs() + 0.1, rand((B, H)))
        else:
            state = (torch.zeros(B, H, dk, dv, device=DEV),
                     torch.zeros(B, H, dk, device=DEV),
                     torch.full((B, H), float("-inf"), device=DEV))
        mine, plain = [t.clone() for t in state], [t.clone() for t in state]
        el = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * el \
            + 2 * ip.numel() * ip.element_size() \
            + 2 * sum(t.numel() * 4 for t in state)
        if tmlstm.route(T) == "chunkwise":
            # on tensor cores: C's update and read-out, 2 dk dv a step and
            # head each, at float32 accuracy (3 TF32 products; 2 where the
            # other operand is a bfloat16 input, exact in TF32)
            flops = 4.0 * dk * dv * B * T * H * (3 if q.dtype == f32 else 2)
            return (lambda: tmlstm.mlstm_chunk(q, k, v, ip, fp, *mine),
                    lambda: ref.mlstm_chunk_ref(q, k, v, ip, fp, *plain),
                    nbytes, flops, "tf32", mine, plain)
        # one step on the CUDA cores, per head: C's update and read-out (a
        # multiply and two FMAs an element), n's (an FMA and a multiply,
        # an FMA a row), ig v and the division (a column each)
        flops = (5.0 * dk * dv + 5 * dk + 2 * dv) * B * T * H
        return (lambda: tmlstm.mlstm_chunk(q, k, v, ip, fp, *mine),
                lambda: ref.mlstm_chunk_ref(q, k, v, ip, fp, *plain),
                nbytes, flops, "float32", mine, plain)
    (Bt, T, E), (_, N) = shape
    u = rand((Bt, T, E), typed(dt), 0.5)
    dtv = (torch.nn.functional.softplus(rand((Bt, T, E))) * 0.1).to(
        typed(extra[0]))
    A = -rand((E, N)).abs()
    Bm, Cm = rand((Bt, T, N), typed(extra[1]), 0.3), \
        rand((Bt, T, N), typed(extra[2]), 0.3)
    D = torch.ones(E, device=DEV)
    h0 = rand((Bt, E, N)) if T == 1 else torch.zeros(Bt, E, N, device=DEV)
    mine, plain = h0.clone(), h0.clone()
    nbytes = sum(t.numel() * t.element_size() for t in (u, dtv, Bm, Cm, A,
                                                         D)) \
        + u.numel() * u.element_size() + 2 * h0.numel() * 4
    flops = (7.0 * N + 3) * Bt * T * E
    return (lambda: tmamba.mamba_scan(u, dtv, A, Bm, Cm, D, mine),
            lambda: ref.mamba_scan_ref(u, dtv, A, Bm, Cm, D, plain),
            nbytes, flops, "float32", [mine], [plain])


def check_recurrent_kernel(torch, calls, arch):
    """The slice's recurrence against its plain version at the recorded
    shapes: held in float32 and in the path's dtypes (bf16 inputs, fp32
    state), outputs and final states; timed in the path's dtypes. Each
    recorded call must have taken its length's route (``REC_ROUTES``).
    The bound takes the peak of the route's arithmetic: the chunkwise
    mLSTM's products on TF32 tensor cores at float32 accuracy, the rest on
    the fp32 CUDA cores; the selective scan's prefill also logs its
    special-function floor. Returns the kernel-line entry (times summed
    over one prefill and one decode step, and per route) and the rows."""
    from repro_torch.device import sm_count
    from repro_torch.kernels import mamba_scan as tmamba
    name, kind, src, replaces = {
        "xlstm-125m": ("mlstm_chunk", "mlstm",
                       "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                       "src/repro/kernels/mlstm_chunk.py:57"),
        "jamba-v0.1-52b": ("mamba_scan", "mamba",
                           "src/repro_torch/kernels/csrc/mamba_scan.cu",
                           "src/repro/kernels/mamba_scan.py:48")}[arch]
    g = torch.Generator(device=DEV).manual_seed(70)
    mult = Counter((k, shape, dt, extra) for k, shape, dt, extra in calls
                   if k == kind)
    rows, worst = [], 0.0
    for (_, shape, dt, extra), n in sorted(mult.items(), key=str):
        T, way = shape[0][1], extra[-1]
        want_way = REC_ROUTES[kind]["step" if T == 1 else "prompt"]
        log(f"{name} {shape}: x{n} took route {way} (expected {want_way})")
        if way != want_way:
            fail(f"{name} {shape}: a served call took route {way}, not "
                 f"{want_way}")
        for fp32 in (True, False):
            kernel, plain, nbytes, flops, peak, st_k, st_p = _rec_case(
                torch, g, kind, shape, dt, extra, fp32)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            tol = REC_TOL["float32" if fp32 else "bfloat16"]
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got).all():
                fail(f"{name} {shape}: output not finite")
            torch.testing.assert_close(got, want, **tol)
            for a, b in zip(st_k, st_p):         # final states, fp32
                torch.testing.assert_close(a, b, **REC_TOL["float32"])
            what = f"{name} {shape} {'float32' if fp32 else (dt, extra)} x{n}"
            if fp32:
                worst, err32 = max(worst, err), err
                log(f"{what}: max|err| {err:.3e} (tol {tol})")
                continue
            b_ms, b_by = bound_ms(nbytes, flops, peak)
            row = {"kind": kind, "shape": shape, "dtype": dt, "extra": extra,
                   "route": way, "per_path": n, "max_abs_err": err,
                   "max_abs_err_float32": err32,
                   "ms": cuda_ms(torch, kernel),
                   "plain_ms": cuda_ms(torch, plain, iters=PLAIN_REC_ITERS,
                                       reps=1),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            floor = ""
            if kind == "mamba" and T > 1:
                (Bt, _, E), (_, N) = shape
                row["sfu_floor_ms"] = tmamba.sfu_floor_ms(
                    Bt, T, E, N, sm_count(torch.device(DEV)), max_sm_ghz())
                floor = (f"; special-function floor of its "
                         f"{Bt * T * E * N / 1e6:.0f} M exponentials "
                         f"{row['sfu_floor_ms']:.4f} ms")
            rows.append(row)
            log(f"{what} (tol {tol}): max|err| {err:.3e}; kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"library none, bound {b_ms:.4f} ms ({b_by}; "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the "
                f"{peak} peak){floor}")
    tot = {key: sum(r["per_path"] * r[key] for r in rows)
           for key in ("ms", "plain_ms", "bound_ms")}
    ops_ms = sum(r["per_path"] * r["bound_ms"] for r in rows
                 if r["bound_by"] == "operations")
    routes = {}
    for r in rows:       # one served shape a route: its per-launch numbers
        routes[r["route"]] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "sfu_floor_ms") if k in r}
        routes[r["route"]].update(max_abs_err=r["max_abs_err_float32"],
                                  per=f"one launch at {r['shape']}")
    entry = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "max_abs_err": worst, **tot,
             "library_ms": None,
             "bound_by": "operations" if 2 * ops_ms >= tot["bound_ms"]
             else "bytes", "routes": routes,
             "per": f"one {arch} prefill ({LM_BATCH}x{LM_PROMPT}) and one "
                    f"decode step, path dtypes: "
                    f"{sum(r['per_path'] for r in rows)} launches"}
    return entry, rows


def max_sm_ghz() -> float:
    """The card's highest SM clock (nvidia-smi), GHz."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) / 1e3


def recurrent_phase(torch, arch):
    """One recurrent model: the float32 and bfloat16 logits checks, its
    recurrence kernel at the recorded shapes, the served run."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import count_params, init_params
    full = get_config(arch)
    g = torch.Generator(device=DEV).manual_seed(80)
    prompts = torch.randint(0, full.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=g, device=DEV)
    jamba = arch == "jamba-v0.1-52b"
    details = {}
    # (a) full width in float32: xLSTM at full depth, Jamba at 2 layers
    small = dataclasses.replace(full, dtype="float32")
    if jamba:
        small = dataclasses.replace(small, num_layers=2,
                                    period_pattern=JAMBA_FP32_PATTERN)
    params = init_params(small, seed=81, device=DEV)
    _, details["fp32"] = lm_logits_check(
        torch, small, params, prompts, LM_FP32_REL,
        f"{arch} full width {small.num_layers} layers float32 "
        f"({count_params(small) / 1e9:.3f} B parameters)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (b) bfloat16: xLSTM at full depth, Jamba at 16 of 32 layers
    cfg = dataclasses.replace(full, num_layers=JAMBA_LAYERS) if jamba \
        else full
    t0 = time.perf_counter()
    params = init_params(cfg, seed=82, device=DEV)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for _, t in _named(params))
    log(f"{arch} random init, {cfg.num_layers} layers: "
        f"{count_params(cfg) / 1e9:.3f} B parameters, "
        f"{n_bytes / 1e9:.2f} GB bfloat16 in "
        f"{time.perf_counter() - t0:.2f} s")
    calls, details["bf16"] = lm_logits_check(
        torch, cfg, params, prompts, LM_BF16_REL,
        f"{arch} full width {cfg.num_layers} layers bfloat16")
    path_calls(calls, cfg)
    entry, details["kernel"] = check_recurrent_kernel(torch, calls, arch)
    if jamba:
        # its attention layers' flash and decode calls (KH 8, G 4), held
        # and timed as Yi-9B's are
        details["attention"], _ = hold_lm_calls(
            torch, torch.Generator(device=DEV).manual_seed(83), calls,
            ("flash", "decode"), f"{arch} ")
    counts, details["slice"] = serve_lm(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return entry, counts, details


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
    counts, details["slice"], casc, rt, profiles = serve_slice(
        torch, np, full_cfg, dcfg)
    live_counts, details["live"] = live_loop(torch, np, casc, rt, profiles)
    del rt
    details["profile"] = profile_stage(torch, casc)
    del casc
    gc.collect()
    torch.cuda.empty_cache()
    lm_entries, lm_counts, details["lm"] = lm_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    rec_entries, rec_counts = [], {}
    for arch in REC_ARCHS:
        entry, rec_counts[arch], details[arch] = recurrent_phase(torch, arch)
        rec_entries.append(entry)
    # flash attention's three routes: the diffusion path's float32 calls
    # on tf32x3, the LM paths' bf16 calls on wgmma; cuda_core (no path's
    # head dim) timed at the UNet's inputs as the float32 route's earlier
    # kernel
    routes = {"diffusion": details["slice"]["flash_routes"],
              "live": details["live"]["flash_routes"],
              "lm": details["lm"]["slice"]["flash_routes"],
              **{a: details[a]["slice"]["flash_routes"] for a in REC_ARCHS}}
    lm_flash = lm_entries.pop("flash_attention")
    fa_entry["routes"] = {}
    for way, e in (("tf32x3", fa_entry), ("wgmma", lm_flash)):
        fa_entry["routes"][way] = {
            **{k: e[k] for k in ("source", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "per")},
            "launches": sum(r[way] for r in routes.values())}
    fa_entry["routes"]["cuda_core"] = {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "max_abs_err": fa_entry["was_max_abs_err"],
        "ms": fa_entry["was_ms"], "plain_ms": fa_entry["plain_ms"],
        "bound_ms": fa_entry["was_bound_ms"], "bound_by": "operations",
        "library_ms": fa_entry["library_ms"], "per": fa_entry["per"],
        "launches": sum(r["cuda_core"] for r in routes.values())}
    for e in rec_entries:      # the recurrences' launches by route
        for way, r in e["routes"].items():
            r["launches"] = sum(
                details[a]["slice"]["rec_routes"].get(e["name"], {}).get(
                    way, 0) for a in REC_ARCHS)
    kernels = []
    for e in (fa_entry, gn_entry, *lm_entries.values(), *rec_entries):
        by_path = {"diffusion": counts[e["name"]],
                   "live": live_counts[e["name"]],
                   "lm": lm_counts[e["name"]],
                   "xlstm": rec_counts[REC_ARCHS[0]][e["name"]],
                   "jamba": rec_counts[REC_ARCHS[1]][e["name"]]}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        kernels.append({k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "was_ms",
            "per", "launches_by_path", "routes") if k in e})
    details["wall_s"] = time.perf_counter() - t_start
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(details, indent=1, default=str))
    log(f"wall {details['wall_s']:.1f} s; card: {details['build']['card']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
