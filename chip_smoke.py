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
3b. The offline phase (paper §3.2) over that cascade: seeded pools of
   64 + 32 held-out tier-0 outputs ("fake") and as many tier-1 outputs
   ("real", the JAX package's ``real_fn`` setting) at b = 8 through the
   kernels, timed; the full-width discriminator trained on the card by
   ``train_discriminator`` (200 steps at batch 32 from the pools, each
   image flipped, turned and shifted at random; the unfused route, so
   no kernel launches; checkpoints in a temporary directory), its loss
   and accuracy every 50 steps and its median step time (CUDA events);
   the newest checkpoint reloaded from its file; the held-out pools
   scored through the kernel route and held against the plain route at
   the GroupNorm tolerance. It fails unless no kernel launched while
   training, the final loss is below the first, held-out accuracy is
   >= 0.9, the mean confidence on "real" exceeds that on "fake" by
   >= 0.1, the reloaded tree equals the trained one bit for bit, and
   the pools' and scoring's launches equal their forwards'.
4. The live control loop over that cascade and its e(b), serving with
   the trained discriminator (its f(t) from the held-out tier-0
   scores): ``ClusterBackend`` with 4 workers (every slice on this
   card, each batch's measured wall charged to its slice's virtual
   clock) replays ``azure_like_trace(40, seed=2)`` scaled into 1-8 qps
   under the DiffServe control plane (EWMA, the MILP planner over the
   measured e(b), heartbeat, accept-all; SLO = max(10 x tier-1 e(1),
   1 s)), with every launch counter zeroed just before and read just
   after. It logs
   the control ticks, distinct plans and the head of the plan timeline;
   total, completed and dropped; violation ratio, goodput, latency p50
   and p99 (virtual clock), defer fraction and FID*; each tier's
   batches by bucket; and each (tier, bucket)'s median in-loop wall
   against the e(b) the planner used. It fails unless
   completed + dropped = total, more than half completed, at least 3
   plans were applied, both tiers ran and a query deferred, and the
   launches equal those of the recorded stage calls (the untimed first
   call at a new bucket included) and scored batches.
4b. The comparison systems by the paper's method, the simulator, on this
   card's numbers: diffserve, clipper-light, clipper-heavy and proteus
   over ``azure_like_trace(120, seed=2)`` scaled into 1-8 qps, 4
   workers, the measured e(b), the trained f(t) (proteus keeps its
   uniform one); each one's violation ratio, FID*, defer fraction and
   goodput. It fails unless every run conserves its queries.

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
   queued back to back (``cuda_ms``). Decode attention's log-sum-exp
   output (``with_lse``) at the path's largest decode call: (output,
   lse) against the plain version, the output against the launch
   without lse, then the split the distribution layer runs over a
   sequence-sharded cache, on this one card: 16 row blocks, one launch
   each at its shifted valid_len, joined by ``ref.combine_partials``
   and held against the whole-cache launch; the lse launch timed beside
   the launch without it (the kernel line's ``lse`` under decode
   attention).
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

The rest of the LM family (``lm_family_phase``), each model freed
before the next, in bfloat16 with random weights:

13. qwen2-vl-7b at full size (28 layers, no embedding table): 4 x 512
    prompt embeddings with M-RoPE positions t = 0 and (h, w) over a
    16 x 32 patch grid, 32 decode steps fed the last embedding at text
    positions 32, 33, ...; the logits check (relative 5e-2), its kernel
    calls held and timed at the recorded shapes (GQA group 7; the decode
    calls at valid_len t + 1 = 33, below slot + 1 = 513), the served run
    as in 8. The causal mask follows the query positions (t): the
    prefill's flash calls take the ``wgmma`` route's position tensor,
    held against the plain version at the recorded positions and timed
    beside SDPA with the explicit mask. Then the same prompt prefilled in
    4 chunks of 128 (cache_index 0, 128, 256, 384), twice, counters
    zeroed just before and read just after each: at its positions (every
    chunk on the position tensor, 112 launches) and at the slots (the
    later chunks on the query offset, 84 launches); the last-position
    logits within 5e-2 of the one-shot prefill's with the same
    positions; the chunks' calls held and timed on their route.
14. deepseek-v3 at full width (MLA ranks q 1536, kv 512, rope 64; 256
    experts top-8 and 1 shared; vocab 129280), depth cut to its 3 dense
    prefix layers and 1 MoE layer, plus the multi-token prediction
    block (53 GB): the logits check, its RMSNorm (MLA's query and latent
    norms too) and SwiGLU calls held and timed, the served run with 16
    absorbed decode steps, then ``mtp_logits`` from the prefill's hidden
    state through the kernels against the plain versions, with its
    launches and both aux losses.
15. ``LMCascade`` over ``greedy_lm_step`` stages, smollm-135m at full
    size then yi-9b at full width and depth: 8 prompts of 64 tokens, 16
    new tokens, the threshold the median of stage 0's confidences;
    counters zeroed around ``run_batch``; each output must be its
    stage's own, and some but not all queries deferred. Then the serving
    CLI (``repro_torch.launch.serve.main``, ``--cascade sdturbo
    --duration 60``) in process, its report logged.
16. Training on the card (``training_phase``), on the ``unfused`` route
    (no kernel has a backward; the JAX package's train steps run none),
    every launch counter zeroed just before and read just after (all
    must stay 0): ``python -m repro_torch.launch.train``'s ``main`` at its
    defaults (reduced smollm-135m, 8 x 128) for 4 steps with checkpoints
    every 2, then resumed from step 4 for 2 more; smollm-135m at full
    size (30 layers, d_model 576, vocab 49152, bf16), 16 AdamW steps of
    8 x 512 Zipf tokens through ``make_train_step``, each between CUDA
    events (the median step time), the loss falling, a checkpoint at
    step 8 loaded into fresh trees and the next step taken from both
    (deterministic algorithms on): trees, metrics and new trees equal bit
    for bit; that step once over ``meta`` under the dry run's memory
    record (``analysis.count.Live``) and once on the card, the record's
    peak printed beside ``max_memory_allocated`` after
    ``reset_peak_memory_stats`` (``step memory`` line, with the card's
    name and power limit); the same step (one 8 x 512 batch) under
    ``remat="none"``, the config's ``dots_nb`` and ``full`` with
    deterministic algorithms on (``remat_training``): metrics and new
    trees equal bit for bit, each policy's median of 8 steps (CUDA
    events), a profiler trace of one step (device busy time, host op
    calls) and ``step memory`` line, the checkpointed steps holding less
    above the resident bytes; then the chunks' checkpoints nested in the
    periods' (``nested_remat``: xlstm-125m at 2 x 512 steps and
    smollm-135m at 2 x 2048 tokens, full width and depth, bfloat16,
    ``dots_nb`` against ``none`` bit for bit, a ``step memory`` line
    each); reduced deepseek-v3 (MTP, z-loss, 8-bit
    moments) for one step in 2 microbatches on the card and on the CPU,
    metrics within 1e-3; 6 ``diffusion_loss`` AdamW steps of the served
    tier-0 UNet at full width, batch 4, timed.
17. The float32 flash routes with a query offset and query positions
    (``float32_routes_phase``): ``tf32x3`` at qwen2-vl's chunk shape in
    float32 (q (4,128,28,128), k/v (4,512,4,128)) at offsets 128, 256,
    384 and at a grid-then-text chunk's positions, ``cuda_core`` at head
    dim 32, each against its plain version (1e-4) and timed beside SDPA
    with the explicit mask and its bound; then a float32 LM (head dims
    128 and 32) prefilled in 4 chunks of 64 (index 0, an int index, a
    0-d device index, explicit positions), counters zeroed just before
    and read just after: logits within 1e-4 of the plain versions', each
    chunk on the route, offset and position launches as expected.
18. The distribution layer on a one-rank NCCL group over the (1, 1)
    ("data", "model") worker mesh (``distribution_phase``; one card, and
    NCCL refuses two ranks on one GPU): ``build_train_step`` for
    smollm-135m at full size on one 8 x 512 batch against the unsharded
    step under deterministic algorithms (metrics and new trees bit for
    bit), and its ``step memory`` line as in 16 over ``meta`` DTensors on
    the same mesh; ``build_serve_step`` for Yi-9B at full width (8 of its 48
    layers) for a 4 x 512 prefill and 8 decode steps, counters zeroed
    just before and read just after, against ``serve_prefill`` /
    ``serve_decode`` (logits and cache bit for bit, the same launches
    every step, flash on ``wgmma``); ``allgather_matmul``,
    ``reduce_scatter_grads`` and ``run_pipeline`` on the one-rank ring
    against dense torch; the host wall each built step adds, median of 5
    in turns. No multi-GPU claim: no collective crosses cards.
19. The analysis (``analysis_phase``): Yi-9B at full width and depth
    (bf16) prefilled with 4 x 512 tokens and one decode step at B 4
    through the kernels, and the smollm-135m train step at 8 x 512
    (unfused), each one untimed call under ``analysis.count.Count`` on
    the card (counters zeroed just before and read just after) and the
    same call on ``meta``: the card's dot flops must equal meta's
    (relative 1e-9). For each path it logs the time an earlier phase
    measured (the lm phase's prefill and decode median, the training
    phase's step median) beside its compute and memory terms at the H100
    SXM5 peaks (989 TFLOP/s bf16, 3.35 TB/s), the dominant one,
    ``model_flops``, its ratio to the dot flops, and the roofline
    fraction (``model_flops`` at peak over the measured time), with the
    card's name and power limit. Then ``python -m
    repro_torch.launch.dryrun --arch yi-9b --shape decode_32k`` in a
    subprocess on the 16 x 16 mesh and with ``--multi-pod`` (256 and 512
    fake ranks, meta tensors, on the host's CPU): each record must be
    ``ok`` with nonzero dot flops and a nonzero all-gather or all-reduce
    count.
20. The wall time and the card's line again, one JSON line listing
    every ported kernel, with its launches by path (diffusion, offline,
    live, lm, xlstm, jamba, lm_family, train, float32_chunks,
    distribution, analysis) and, for flash attention,
    its routes (``tf32x3`` over one UNet forward, ``wgmma`` over one
    Yi-9B prefill, ``cuda_core`` at the UNet's inputs, ``wgmma_offset``
    over one chunked qwen2-vl prompt at the slots, ``wgmma_positions``
    over one qwen2-vl prefill and one chunked prompt at its positions,
    ``tf32x3_offset``, ``tf32x3_positions``, ``cuda_core_offset`` and
    ``cuda_core_positions`` at phase 17's shapes)
    and, for the mLSTM and the selective scan, their two routes, with
    their times and launches;
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
import math
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
# the offline phase: pools of 64 + 32 held-out outputs per tier at b = 8,
# 200 train steps at batch 32 (the discriminator as served, 64x64x4)
OFFLINE_POOL = 64
OFFLINE_HELDOUT = 32
OFFLINE_BATCH = 8
OFFLINE_STEPS = 200
OFFLINE_TRAIN_BATCH = 32
OFFLINE_LR = 1e-3
OFFLINE_SEED = 40
OFFLINE_WARMUP, OFFLINE_TIMED = 3, 20     # the step-time loop
# the comparison systems, simulated over the live loop's trace shape
CONTROLLER_NAMES = ("diffserve", "clipper-light", "clipper-heavy", "proteus")
CONTROLLERS_TRACE_S = 120
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
# the production meshes' model axis (16 x 16 and 2 x 16 x 16): a rank of
# it holds a quarter of the 384 value columns of one of xlstm-125m's 4
# heads, so its mLSTM call is at one head, dk 384, dv 96 (``local_calls``
# column plan); the rank held here is the sixth (head 1, columns 96-191)
SPLIT_MODEL_AXIS, SPLIT_RANK = 16, 5
# decode_32k's outputs are means over 32769 values (typically ~0.01):
# its bf16 atol is 2e-2 of the largest |output|, not 2e-2 absolute
DECODE_32K_REL_ATOL = 2e-2
# decode attention's log-sum-exp: float32 in both versions from the same
# scores, summed in another order (scores of order 10 at most); the
# split of a sequence-sharded cache over a 16-way model axis, run on one
# card as 16 row blocks
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
LSE_BLOCKS = 16
# the rest of the LM family: qwen2-vl-7b at full size (embedding inputs,
# M-RoPE over a 16 x 32 patch grid at t = 0, then text positions from
# 32); deepseek-v3 at full width, its depth cut to the 3 dense prefix
# layers, 1 MoE layer and the multi-token prediction block; a prompt
# prefilled in chunks of 128; the LM cascade smollm-135m -> yi-9b at
# batch 8 with 16 new tokens; the serving CLI in process
QWEN_ARCH, QWEN_GRID = "qwen2-vl-7b", (16, 32)
DS_ARCH, DS_LAYERS, DS_STEPS = "deepseek-v3-671b", 4, 16
CHUNK = 128
CASCADE_ARCHS = ("smollm-135m", "yi-9b")
CASCADE_BATCH, CASCADE_PROMPT, CASCADE_NEW = 8, 64, 16
SERVE_ARGV = ["--cascade", "sdturbo", "--duration", "60"]
# training on the card (the unfused route: plain PyTorch differentiated
# by autograd, no kernel launches): smollm-135m at full size, the
# default arch of the JAX package's launch/train.py, TRAIN_STEPS AdamW
# steps of TRAIN_BATCH x TRAIN_SEQ Zipf tokens with a checkpoint at
# TRAIN_CKPT_STEP (1.35 GB of bf16 weights and fp32 moments through
# zlib: one save, one load); the
# entry point at its defaults (the reduced config, batch 8 x seq 128) for
# LAUNCH_STEPS steps with checkpoints every 2, then resumed for 2 more;
# reduced deepseek-v3 (MTP, z-loss, 8-bit moments) in 2
# microbatches of DS_TRAIN_BATCH / 2 x DS_TRAIN_SEQ, on the card and on
# the CPU; DIFF_TRAIN_STEPS diffusion_loss steps of the full-width UNet
# at batch DIFF_TRAIN_BATCH
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "smollm-135m", 8, 512
TRAIN_STEPS, TRAIN_CKPT_STEP, TRAIN_LR, TRAIN_SEED = 16, 8, 1e-3, 95
LAUNCH_STEPS = 4
# the same TRAIN_ARCH step under remat "none", under its config's policy
# ("dots_nb") and under "full": REMAT_STEPS timed calls each
REMAT_STEPS = 8
# checkpoints nested in the periods': (arch at its full width and dtype,
# batch, tokens a sequence, whether to take the record over meta) whose
# plain recurrence or attention runs in more than one chunk; xlstm-125m
# takes no record: its sLSTM's step loop over meta under the record
# takes ~1 min a policy on the host
NESTED_REMAT = (("xlstm-125m", 2, 512, False), ("smollm-135m", 2, 2048, True))
DS_TRAIN_BATCH, DS_TRAIN_SEQ = 4, 32
DIFF_TRAIN_BATCH, DIFF_TRAIN_STEPS, DIFF_TRAIN_LR = 4, 6, 1e-4
# the float32 flash routes with a query offset and query positions:
# (route, kind, q shape, k/v shape, q_offset or kv_len); tf32x3 at
# qwen2-vl's chunk shape in float32, at each later chunk's offset and at
# a grid-then-text chunk's positions; cuda_core at head dim 32; then a
# float32 LM prefilled in chunks of F32_PATH_CHUNK at batch F32_PATH_B
F32_CASES = (
    ("tf32x3", "offset", (4, 128, 28, 128), (4, 512, 4, 128), 128),
    ("tf32x3", "offset", (4, 128, 28, 128), (4, 512, 4, 128), 256),
    ("tf32x3", "offset", (4, 128, 28, 128), (4, 512, 4, 128), 384),
    ("tf32x3", "positions", (4, 128, 28, 128), (4, 512, 4, 128), 256),
    ("cuda_core", "offset", (4, 128, 8, 32), (4, 512, 2, 32), 256),
    ("cuda_core", "positions", (4, 128, 8, 32), (4, 512, 2, 32), 256),
)
F32_PATH_B, F32_PATH_CHUNK = 2, 64
# the distribution layer on a one-rank NCCL group: the built train step
# at TRAIN_ARCH's full size on one TRAIN_BATCH x TRAIN_SEQ batch; the
# built serve steps for Yi-9B at full width, depth cut to DIST_LM_LAYERS,
# a LM_BATCH x LM_PROMPT prefill then DIST_DECODES decode steps; host
# walls as medians of DIST_REPS calls in turns
DIST_LM_LAYERS, DIST_DECODES, DIST_REPS = 8, 8, 5
# the analysis: the card's dot flops of each path must equal meta's (both
# exact sums of integers in float64; the margin is for float sums), and
# the dry-run CLI's cell, run on both production meshes
ANALYSIS_REL = 1e-9
DRYRUN_ARGV = ["--arch", "yi-9b", "--shape", "decode_32k"]
# the sharded train and prefill steps the dry run repaired, at full
# widths and cut depth (arch, shape, multi-pod, overrides): each in its
# own process, all started together as phase 19 begins, each under
# DRYRUN_CELL_TIMEOUT seconds; every record must say ok
DRYRUN_CELLS = (
    ("yi-9b", "train_4k", False, ("num_layers=1",)),
    ("qwen2-vl-7b", "train_4k", False, ("num_layers=1",)),
    ("jamba-v0.1-52b", "train_4k", False, ("num_layers=8",)),
    ("xlstm-125m", "train_4k", False, ("num_layers=6",)),
    ("deepseek-v3-671b", "train_4k", False,
     ("prefix_pattern=()", "num_layers=1")),
    ("yi-9b", "prefill_32k", False, ("num_layers=1",)),
    ("yi-9b", "train_4k", True, ("num_layers=1",)),
)
DRYRUN_CELL_TIMEOUT = 600


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
             1.0 / math.sqrt(D), 0, 0, None,
             torch.cuda.current_stream().cuda_stream)
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


def measured_serving(rt, profiles):
    """The slice's serving config with each tier's e(b) measured on this
    card and SLO = max(10 x tier-1 e(1), 1 s)."""
    from repro_torch.config.base import as_cascade_spec
    spec = as_cascade_spec(rt.serving.cascade)
    tiers = tuple(dataclasses.replace(t, profile=profiles[i])
                  for i, t in enumerate(spec.tiers))
    spec = dataclasses.replace(spec, tiers=tiers,
                               slo_s=max(10 * profiles[-1].base_s, 1.0))
    return dataclasses.replace(rt.serving, cascade=spec)


def live_loop(torch, np, casc, rt, profiles, deferral):
    """The live control loop at full width: ``ClusterBackend`` replays a
    trace in virtual time under the DiffServe control plane (EWMA demand,
    the MILP planner, heartbeat, accept-all), planning from the e(b) the
    slice phase measured on this card and the deferral profile f(t) of
    the trained discriminator, which scores every tier-0 batch; every
    batch of the cascade runs for real, its measured wall charged to its
    slice's clock. Every stage call is recorded (the untimed first call
    at a new bucket too), so the kernels' launches can be held to the
    calls."""
    from repro_torch.kernels import ops
    from repro_torch.serving.cluster import ClusterBackend
    from repro_torch.serving.controlplane import build_control_plane
    from repro_torch.serving.trace import azure_like_trace
    serving = measured_serving(rt, profiles)
    spec = serving.cascade
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


def offline_phase(torch, np, casc, card):
    """DiffServe's offline phase (paper §3.2) on the slice's full-width
    cascade: seeded pools of tier-0 outputs ("fake") and tier-1 outputs
    ("real", the JAX package's ``real_fn`` setting) at b = 8 through the
    kernels, the full-width discriminator trained on the card with the
    port's ``train_discriminator`` (the unfused route: no kernel
    launches) with checkpoints, the newest checkpoint reloaded from its
    file, and the held-out pools scored through the kernel route against
    the plain route. Returns the trained parameters, the held-out tier-0
    scores (the deferral profile f(t)), the launches of the pools and
    the scoring, and the details."""
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.models.efficientnet import apply_discriminator
    from repro_torch.training import checkpoint
    from repro_torch.training import discriminator as tdisc
    from repro_torch.training.data import DiscriminatorBatcher
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.tree import leaves, map_tree
    dcfg = casc.disc_cfg
    stages = casc.stage_fns()
    n_pool = OFFLINE_POOL + OFFLINE_HELDOUT
    rng = np.random.default_rng(OFFLINE_SEED)
    toks = rng.integers(0, 1024, (n_pool, PROMPT_LEN))

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pools = []
    with torch.inference_mode():
        for tier, (cfg, fn, params) in enumerate(stages):
            casc.generator.manual_seed(OFFLINE_SEED + tier)
            out = [fn(params, toks[i:i + OFFLINE_BATCH]).float().cpu()
                   for i in range(0, n_pool, OFFLINE_BATCH)]
            pools.append(torch.cat(out).numpy())
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    pool_counts = ops.launch_counts()
    fake, real = pools
    for name, pool in (("fake (tier 0)", fake), ("real (tier 1)", real)):
        if pool.shape != (n_pool, casc.stages[0][0].image_size,
                          casc.stages[0][0].image_size, dcfg.in_channels) \
                or not np.isfinite(pool).all():
            fail(f"offline: the {name} pool has shape {pool.shape} or is "
                 "not finite")
    log(f"offline: pools of {n_pool} tier-0 and {n_pool} tier-1 outputs at "
        f"b={OFFLINE_BATCH} in {pool_s:.3f} s ({card}); fake mean "
        f"{fake.mean():.4f} std {fake.std():.4f}, real mean "
        f"{real.mean():.4f} std {real.std():.4f}")
    train_fake, held_fake = fake[:OFFLINE_POOL], fake[OFFLINE_POOL:]
    train_real, held_real = real[:OFFLINE_POOL], real[OFFLINE_POOL:]
    draw = np.random.default_rng(OFFLINE_SEED + 7)

    def sampler(pool):
        """``n`` images of ``pool``, each flipped, turned and shifted at
        random on the host: 64 images a class are few, and unaugmented
        the discriminator learns them by heart (train loss ~0, held-out
        accuracy ~0.7 in a CPU rehearsal at a small width)."""
        def draw_n(n):
            out = pool[draw.choice(len(pool), n, replace=False)].copy()
            for i in range(n):
                img = out[i, :, ::-1] if draw.random() < 0.5 else out[i]
                img = np.rot90(img, int(draw.integers(4)), axes=(0, 1))
                out[i] = np.roll(img, tuple(draw.integers(0, img.shape[0],
                                                          2)), axis=(0, 1))
            return out
        return draw_n

    tmp = tempfile.TemporaryDirectory(prefix="disc_ckpt_")
    ckpt_dir = tmp.name
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, _, hist = tdisc.train_discriminator(
        OFFLINE_SEED, cfg=dcfg, steps=OFFLINE_STEPS,
        batch_size=OFFLINE_TRAIN_BATCH,
        image_size=casc.stages[0][0].image_size,
        fake_fn=sampler(train_fake), real_fn=sampler(train_real),
        seed=OFFLINE_SEED, lr=OFFLINE_LR, log_every=1,
        checkpoint_dir=ckpt_dir, device=DEV)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = ops.launch_counts()
    loss_first, loss_last = hist[0]["loss"], hist[-1]["loss"]
    for h in hist:
        if h["step"] % 50 == 0:
            log(f"offline: step {h['step']:4d} loss {h['loss']:.4f} acc "
                f"{h['acc']:.3f} ({card})")
    # the step time: the same train step (train_discriminator's optimizer
    # settings), each between two CUDA events, on a copy of the trained
    # parameters and the same pools, after a warm-up
    opt_init, step_fn = tdisc.make_disc_train_step(dcfg, OptimizerConfig(
        peak_lr=OFFLINE_LR, warmup_steps=20, total_steps=OFFLINE_STEPS,
        weight_decay=1e-4))
    p_t = map_tree(torch.clone, params)
    o_t = opt_init(p_t)
    batches = iter(DiscriminatorBatcher(
        rng=np.random.default_rng(OFFLINE_SEED + 8),
        size=OFFLINE_TRAIN_BATCH, image_size=casc.stages[0][0].image_size,
        fake_fn=sampler(train_fake), real_fn=sampler(train_real)))
    events = []
    for i in range(OFFLINE_WARMUP + OFFLINE_TIMED):
        x, y = next(batches)
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(DEV)
        y = torch.from_numpy(y).to(DEV)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        p_t, o_t, _ = step_fn(p_t, o_t, x, y)
        e1.record()
        if i >= OFFLINE_WARMUP:
            events.append((e0, e1))
    torch.cuda.synchronize()
    step_ms = sorted(e0.elapsed_time(e1) for e0, e1 in events)
    train_counts = {k: v + ops.launch_counts()[k]
                    for k, v in train_counts.items()}
    log(f"offline: {OFFLINE_STEPS} train steps at batch "
        f"{OFFLINE_TRAIN_BATCH} in {train_s:.3f} s (wall, a host read of "
        f"loss and accuracy each step); median of {OFFLINE_TIMED} steps "
        f"{step_ms[len(step_ms) // 2]:.3f} ms (CUDA events; min "
        f"{step_ms[0]:.3f}, max {step_ms[-1]:.3f}) ({card}); loss step 1 "
        f"{loss_first:.4f}, step {OFFLINE_STEPS} {loss_last:.4f}; "
        f"launches while training {train_counts}")
    if any(train_counts.values()):
        fail(f"offline: kernels launched while training {train_counts}: "
             "the train step must take the unfused route")
    if not loss_last < loss_first:
        fail(f"offline: final loss {loss_last} not below the first "
             f"{loss_first}")
    newest = checkpoint.latest_step(ckpt_dir)
    loaded, step, extra = checkpoint.load(ckpt_dir, params, device=DEV)
    same = all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a, b)
               for a, b in zip(leaves(loaded), leaves(params)))
    log(f"offline: checkpoints {checkpoint.sorted_steps(ckpt_dir)}; "
        f"reloaded step {step} ({extra}) from its file: "
        f"{'bit for bit equal' if same else 'DIFFERENT'}")
    tmp.cleanup()
    if newest != OFFLINE_STEPS or step != OFFLINE_STEPS or not same:
        fail("offline: the reloaded checkpoint is not the trained tree")

    def forward(pool, impl):
        """(logits, pooled features) of ``pool`` on the given route."""
        with torch.inference_mode():
            outs = [apply_discriminator(loaded, dcfg, torch.from_numpy(
                pool[i:i + OFFLINE_BATCH]).to(DEV), impl=impl)
                for i in range(0, len(pool), OFFLINE_BATCH)]
            return [torch.cat(o).cpu() for o in zip(*outs)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    k_fake, k_real = forward(held_fake, "fused"), forward(held_real, "fused")
    torch.cuda.synchronize()
    score_counts = ops.launch_counts()
    u_fake = forward(held_fake, "unfused")
    u_real = forward(held_real, "unfused")
    # the kernel route against the plain route before the softmax, which
    # saturates: logits and the head's pooled features (the last
    # GroupNorm's output, averaged)
    errs = {}
    for i, what in enumerate(("logits", "features")):
        got = torch.cat([k_fake[i], k_real[i]])
        want = torch.cat([u_fake[i], u_real[i]])
        errs[what] = float((got - want).abs().max())
        torch.testing.assert_close(got, want, **GN_TOL)
    # P('real'), as confidence_score computes it
    s_fake, s_real = (torch.softmax(k[0], dim=-1)[:, 1].numpy()
                      for k in (k_fake, k_real))
    acc = float(((s_real > 0.5).sum() + (s_fake <= 0.5).sum())
                / (len(s_real) + len(s_fake)))
    gap = float(s_real.mean() - s_fake.mean())
    log(f"offline: held-out {len(s_real)} real + {len(s_fake)} fake: "
        f"accuracy {acc:.4f}, mean confidence real {s_real.mean():.4f} "
        f"fake {s_fake.mean():.4f} (gap {gap:.4f}); kernel route vs plain "
        f"route max |diff| logits {errs['logits']:.3e} (|logit| up to "
        f"{float(torch.cat([k_fake[0], k_real[0]]).abs().max()):.3f}), "
        f"features {errs['features']:.3e} (tol {GN_TOL})")
    if acc < 0.9:
        fail(f"offline: held-out accuracy {acc} < 0.9")
    if gap < 0.1:
        fail(f"offline: mean confidence gap {gap} < 0.1")
    # launches: the pools (a UNet forward per DDIM step of each batch) and
    # the held-out scoring through the kernel route
    gn_u, gn_d, fa_u = PATH_GN["unet"], PATH_GN["disc"], PATH_FA["unet"]
    n_batches = -(-n_pool // OFFLINE_BATCH)
    unet = n_batches * sum(cfg.num_steps for cfg, _, _ in stages)
    scored = 2 * -(-OFFLINE_HELDOUT // OFFLINE_BATCH)
    counts = {k: pool_counts[k] + score_counts[k] for k in pool_counts}
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({"fused_groupnorm": unet * gn_u + scored * gn_d,
                 "flash_attention": unet * fa_u})
    log(f"offline launches: {counts} (expected {want}: {unet} UNet "
        f"forwards, {scored} scored batches)")
    if counts != want:
        fail(f"offline launch counts {counts} != expected {want}")
    return params, s_fake, counts, {
        "card": card, "pool_s": pool_s, "pool_images": 2 * n_pool,
        "train_s": train_s, "steps": OFFLINE_STEPS,
        "train_batch": OFFLINE_TRAIN_BATCH,
        "step_ms_median": step_ms[len(step_ms) // 2],
        "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
        "loss_first": loss_first, "loss_last": loss_last,
        "history": [h for h in hist
                    if h["step"] == 1 or h["step"] % 50 == 0],
        "train_launches": train_counts, "checkpoint_step": step,
        "heldout_accuracy": acc, "mean_conf_real": float(s_real.mean()),
        "mean_conf_fake": float(s_fake.mean()),
        "logits_max_abs_diff": errs["logits"],
        "features_max_abs_diff": errs["features"]}


def controllers_phase(np, serving, deferral, card):
    """The paper's comparison (§5) by its own method, the simulator, on
    this card's numbers: DiffServe against Clipper-Light, Clipper-Heavy
    and Proteus over one trace, through ``assemble_bundle`` (the
    assembly ``run_controller`` goes through; ``run_controller`` itself
    fits the synthetic profile, so the trained one is passed here) and
    ``Simulator``. Tier profiles are the e(b) measured on the card; the
    query-aware bundles' deferral profile is the trained
    discriminator's, Proteus keeps its uniform f(t) = t. Host work."""
    from repro_torch.serving.baselines import (TORCH_CONTROLLERS,
                                               assemble_bundle)
    from repro_torch.serving.simulator import SimConfig, Simulator
    from repro_torch.serving.trace import azure_like_trace
    trace = azure_like_trace(CONTROLLERS_TRACE_S,
                             seed=LIVE_TRACE_SEED).scale(*LIVE_QPS)
    rows = []
    for name in CONTROLLER_NAMES:
        given = None if TORCH_CONTROLLERS[name].uniform_profile \
            else tuple(deferral)
        t0 = time.perf_counter()
        bundle, profiles, fixed, control, conf = assemble_bundle(
            name, trace, serving, seed=0, profiles=given)
        sim = Simulator(serving, profiles,
                        SimConfig(seed=0, router=bundle.router,
                                  arrival_stage=bundle.arrival_stage,
                                  fixed_plan=fixed),
                        confidence_fn=conf, control=control)
        r = sim.run(trace)
        wall = time.perf_counter() - t0
        row = {"controller": name, "total": r.total,
               "completed": r.completed, "dropped": r.dropped,
               "violation_ratio": r.violation_ratio, "fid_star": r.mean_fid,
               "defer_fraction": r.defer_fraction, "goodput": r.goodput,
               "host_s": wall}
        rows.append(row)
        log(f"controllers: {name}: total {r.total}, completed "
            f"{r.completed}, dropped {r.dropped}; violation ratio "
            f"{r.violation_ratio:.4f}, FID* {r.mean_fid:.4f}, defer "
            f"fraction {r.defer_fraction:.4f}, goodput {r.goodput:.4f} "
            f"(simulator over {trace.name}, {trace.duration_s:.0f} s; "
            f"e(b) from {card}; host {wall:.3f} s)")
        if r.completed + r.dropped != r.total or not r.conserved():
            fail(f"controllers: {name}: completed {r.completed} + dropped "
                 f"{r.dropped} != total {r.total}")
    return rows


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


def trace_call(torch, fn, host_ops=0):
    """torch.profiler over one call of ``fn`` (warmed up first): host
    wall, device busy time (union of the card's kernel intervals), the
    idle share of the wall, and device time and launches by kernel name,
    largest first. With ``host_ops`` > 0 also the host side: the calls
    of ``aten::`` ops, the host time attributed to ops (self time summed
    over every thread) and the ``host_ops`` ops with the most of it."""
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
    row = {"wall_us": wall_us, "device_busy_us": busy,
           "idle_share": 1.0 - busy / wall_us,
           "device_launches": len(kernels),
           "by_kernel": [{"name": n[:90], "count": c, "us": t}
                         for n, (c, t) in ranked]}
    if host_ops:
        ops = sorted(prof.key_averages(),
                     key=lambda a: -a.self_cpu_time_total)
        row["host"] = {
            "aten_calls": sum(a.count for a in ops
                              if a.key.startswith("aten::")),
            "self_us": sum(a.self_cpu_time_total for a in ops),
            "by_op": [{"name": a.key[:60], "count": a.count,
                       "self_us": a.self_cpu_time_total}
                      for a in ops[:host_ops]]}
    return row


def log_trace(what: str, row) -> None:
    log(f"profile {what}: wall {row['wall_us']:.0f} us (profiled), device "
        f"busy {row['device_busy_us']:.0f} us, idle share "
        f"{row['idle_share']:.3f}, {row['device_launches']} device launches")
    for t in row["by_kernel"][:12]:
        log(f"  {t['us']:9.1f} us x{t['count']:4d}  {t['name']}")
    if "host" in row:
        h = row["host"]
        log(f"  host: {h['aten_calls']} aten op calls, {h['self_us']:.0f} "
            f"us of host time attributed to ops (all threads); most:")
        for t in h["by_op"]:
            log(f"  {t['self_us']:9.1f} us x{t['count']:5d}  {t['name']}")


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

    def flash(q, k, v, *, causal=True, kv_len=None, q_offset=0,
              q_positions=None):
        if q_positions is not None:
            calls.append(("flash_positions", (tuple(q.shape),
                                              tuple(k.shape)), dt(q),
                          (kv_len, tuple(map(tuple,
                                             q_positions.tolist())))))
        elif q_offset:
            calls.append(("flash_offset", (tuple(q.shape), tuple(k.shape)),
                          dt(q), (q_offset, kv_len)))
        else:
            calls.append(("flash", (tuple(q.shape), tuple(k.shape)), dt(q),
                          causal))
        return saved["flash_attention"](q, k, v, causal=causal,
                                        kv_len=kv_len, q_offset=q_offset,
                                        q_positions=q_positions)

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


def prefill_and_first_decode(torch, cfg, params, prompts, next_tok=None,
                             feed=None):
    """(prefill logits, first decode logits, the decoded token, the
    decode step's greedy token) on a fresh cache; ``next_tok`` fixes the
    decoded token (else the prefill's greedy one). An embedding-input
    model's ``feed`` is (prompt positions, the decode step's input, its
    positions): its prompts are embeddings."""
    from repro_torch.launch.steps import serve_decode, serve_prefill
    from repro_torch.models.kvcache import init_cache
    B, S = prompts.shape[:2]
    pos, step_in, step_pos = feed or (None, None, None)
    cache = init_cache(cfg, B, 2 * S, DEV)
    lp, cache = serve_prefill(params, cfg, cache, prompts, pos)
    tok = lp.argmax(-1, keepdim=True) if next_tok is None else next_tok
    ld, cache = serve_decode(params, cfg, cache,
                             tok if step_in is None else step_in, S,
                             step_pos)
    return lp.float(), ld.float(), tok, ld.argmax(-1)


def rel_diff(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def lm_logits_check(torch, cfg, params, prompts, rel_tol, what, feed=None):
    """The kernel path's prefill and first decode logits against the same
    forward through the plain versions; returns the kernel path's calls
    and the numbers. ``feed``: as ``prefill_and_first_decode``'s."""
    calls = []
    with recorded_calls(calls):
        kp, kd, tok, ktok = prefill_and_first_decode(torch, cfg, params,
                                                     prompts, feed=feed)
    with plain_ops():
        pp, pd, _, ptok = prefill_and_first_decode(torch, cfg, params,
                                                   prompts, tok, feed)
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
    (layers with an FFN), one for the final norm, and an MLA layer's
    latent and (with a query rank) query norms; SwiGLU once per SwiGLU
    MLP or MoE layer, and once more for an MoE layer's shared expert;
    attention once per attention layer (flash in prefill, decode
    attention at S = 1; MLA's is plain); each recurrence once per layer
    of its mixer."""
    from repro_torch.kernels import ops
    specs = cfg.flat_pattern()
    fwd = prefills + decodes
    mixers = Counter(mixer for mixer, _ in specs)
    n_ffn = sum(ffn is not None for _, ffn in specs)
    swiglu = cfg.mlp == "swiglu"
    n_swiglu = sum(ffn == "moe" or (ffn == "mlp" and swiglu)
                   for _, ffn in specs)
    if cfg.moe.num_shared_experts and swiglu:
        n_swiglu += sum(ffn == "moe" for _, ffn in specs)
    n_mla_norms = mixers["mla"] * (
        1 + bool(cfg.mla and cfg.mla.q_lora_rank))
    rms = cfg.norm == "rmsnorm"
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({"flash_attention": mixers["attn"] * prefills,
                 "decode_attention": mixers["attn"] * decodes,
                 "fused_rmsnorm": (len(specs) + n_ffn + 1 + n_mla_norms)
                 * fwd if rms else 0,
                 "swiglu": n_swiglu * fwd,
                 "mlstm_chunk": mixers["mlstm"] * fwd,
                 "mamba_scan": mixers["mamba"] * fwd})
    return want


def path_calls(calls, cfg):
    """Check the recorded calls of one prefill and one decode forward
    against the path's (``path_counts``), RMSNorm's two variants apart."""
    n = dict(Counter("flash" if kind == "flash_positions" else kind
                     for kind, *_ in calls))
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


def hold_decode_lse(torch, g, calls):
    """Decode attention's log-sum-exp output at the path's largest
    recorded decode call (bfloat16): (output, lse) against the plain
    version's, the output against the launch without lse; then the
    split that ``parallel/local_calls`` runs over a sequence-sharded
    cache, on one card: the cache cut into LSE_BLOCKS row blocks, one
    launch each at its valid_len shifted by the block's first row and
    clipped to its rows, joined by ``ref.combine_partials`` (the same
    function), against the whole-cache launch; the lse launch timed
    beside the launch without it. Returns the kernel-line entry."""
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import ref
    dt = torch.bfloat16
    shape, valid = max(((shape, extra) for kind, shape, _, extra in calls
                        if kind == "decode"), key=lambda c: max(c[1]))
    (qs, ks) = shape
    q, k, v, vl, nbytes, flops = _decode_inputs(torch, g, qs, ks, valid, dt)
    B, H, _ = qs
    T = ks[1]
    got, lse = tdec.decode_attention(q, k, v, vl, with_lse=True)
    want, want_lse = ref.decode_attention_ref(q, k, v, vl, with_lse=True)
    err, tol = _hold(torch, "decode_attention", got, want, "bfloat16")
    lse_err, _ = _hold(torch, "decode_attention", lse, want_lse, "float32",
                       LSE_TOL)
    whole = tdec.decode_attention(q, k, v, vl)
    _hold(torch, "decode_attention", got, whole, "bfloat16")
    same = torch.equal(got, whole)
    if T % LSE_BLOCKS:
        raise SystemExit(f"decode lse: T {T} is not {LSE_BLOCKS} row blocks")
    rows = T // LSE_BLOCKS
    parts = [tdec.decode_attention(
        q, k[:, r * rows:(r + 1) * rows].contiguous(),
        v[:, r * rows:(r + 1) * rows].contiguous(),
        (vl - r * rows).clamp(0, rows).to(torch.int32), with_lse=True)
        for r in range(LSE_BLOCKS)]
    joined = ref.combine_partials(
        torch.stack([o for o, _ in parts]), torch.stack([s for _, s in parts]),
        lambda t: t.amax(0, keepdim=True),
        lambda t: t.sum(0, keepdim=True))[0]
    comb_err, _ = _hold(torch, "decode_attention", joined, whole, "bfloat16")
    del parts, joined
    sdpa = _sdpa(torch, q[:, None], k[:, :max(valid)], v[:, :max(valid)],
                 False) if len(set(valid)) == 1 else None
    t = _time_rows(torch,
                   lambda: tdec.decode_attention(q, k, v, vl, with_lse=True),
                   lambda: ref.decode_attention_ref(q, k, v, vl,
                                                    with_lse=True),
                   sdpa, nbytes + 4 * B * H, flops, "bfloat16")
    t["no_lse_ms"] = cuda_ms(torch, lambda: tdec.decode_attention(q, k, v,
                                                                  vl))
    entry = {"shape": (qs, ks), "valid": valid, "max_abs_err": err,
             "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
             "output_equals_launch_without_lse": same,
             "blocks": LSE_BLOCKS, "combine_max_abs_err": comb_err,
             "combine_tol": tol, **t}
    lib = "-" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
    log(f"decode_attention with lse q {qs} k/v {ks} valid {valid} bfloat16: "
        f"max|err| {err:.3e} (tol {tol}), lse max|err| {lse_err:.3e} (tol "
        f"{LSE_TOL}), output equal to the launch without lse: {same}; "
        f"{LSE_BLOCKS} row blocks of {rows} joined by combine_partials vs "
        f"the whole cache: max|err| {comb_err:.3e}; kernel with lse "
        f"{t['ms']:.4f} ms, without {t['no_lse_ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library {lib} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return entry


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
    lse = hold_decode_lse(torch, g, calls)
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
    entries["decode_attention"]["lse"] = lse
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


def serve_lm(torch, cfg, params, steps=LM_STEPS, feed=None):
    """The slice: one prefill of LM_BATCH prompts of LM_PROMPT tokens and
    ``steps`` greedy decode steps, launch counters zeroed just before and
    read just after; then a profiled decode step. An embedding-input
    model's ``feed`` is (prompt embeddings, their positions, the decode
    steps' positions by step): each step is fed the last prompt
    embedding."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import cache_len, serve_decode, serve_prefill
    from repro_torch.models import layers as L
    from repro_torch.models.kvcache import init_cache
    T = cache_len(ShapeConfig("smoke_decode", "decode",
                              LM_PROMPT + steps, LM_BATCH))
    g = torch.Generator(device=DEV).manual_seed(50)
    if feed is None:
        prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                                generator=g, device=DEV)
        pos, step_pos = None, [None] * steps
    else:
        prompts, pos, step_pos = feed

    def step_input(tokens):
        return tokens[-1] if feed is None else prompts[:, -1:]
    cache = init_cache(cfg, LM_BATCH, T, DEV)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = serve_prefill(params, cfg, cache, prompts, pos)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tokens = [logits.argmax(-1, keepdim=True)]
    finite = [torch.isfinite(logits).all()]
    # every MoE call of the decode steps keeps its router and input (a
    # reference each, no device work), so that the bound below counts
    # the experts this run's tokens are routed to
    moe_apply, routed = L.moe_apply, []

    def recording_moe(p, c, x, *rest):
        routed.append((p["router"], x))
        return moe_apply(p, c, x, *rest)
    L.moe_apply = recording_moe
    t0 = time.perf_counter()
    try:
        for step, (e0, e1) in enumerate(events):
            e0.record()
            logits, cache = serve_decode(params, cfg, cache,
                                         step_input(tokens),
                                         LM_PROMPT + step, step_pos[step])
            e1.record()
            tokens.append(logits.argmax(-1, keepdim=True))
            finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
    finally:
        L.moe_apply = moe_apply
    decode_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    pos_launches = ops.position_launches()
    want = path_counts(cfg, 1, steps)
    step_ms = sorted(e0.elapsed_time(e1) for e0, e1 in events)
    median = step_ms[len(step_ms) // 2]
    gen = torch.cat(tokens, dim=1)
    log(f"slice {cfg.name} {cfg.dtype}: prefill {LM_BATCH}x{LM_PROMPT} "
        f"{prefill_s * 1e3:.2f} ms; {steps} decode steps: per-token "
        f"latency median {median:.3f} ms (min {step_ms[0]:.3f}, max "
        f"{step_ms[-1]:.3f}; CUDA events), host wall "
        f"{decode_s * 1e3 / steps:.3f} ms a step")
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
               REC_ROUTES[kind]["step"]: layers * steps}
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
    # (the step gathers 4 of its rows), the experts no token of the step
    # is routed to and the multi-token prediction block (training only),
    # the live K/V (MLA: latent) rows once, and every recurrent state
    # read and written once
    experts = ("e_wi", "e_wg", "e_wo")
    served = [(name, t) for name, t in _named(params)
              if not name.startswith("mtp/")]
    e_bytes = sum(t.numel() * t.element_size() for name, t in served
                  if name.rsplit("/", 1)[-1] in experts)
    w_bytes = sum(t.numel() * t.element_size() for name, t in served
                  if name != "embed/embedding") - e_bytes
    mixers = Counter(mixer for mixer, _ in cfg.flat_pattern())
    live = LM_BATCH * (LM_PROMPT + steps // 2)
    kv_bytes = 2 * mixers["attn"] * live * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 2
    if mixers["mla"]:
        kv_bytes += mixers["mla"] * live * (cfg.mla.kv_lora_rank
                                            + cfg.mla.qk_rope_head_dim) * 2
    state_bytes = 2 * sum(t.numel() * t.element_size() for entry in cache
                          for name, t in entry.items()
                          if name not in ("k", "v", "c_kv", "k_rope"))
    routed_bytes = [0.0] * steps
    n_moe = sum(ffn == "moe" for _, ffn in cfg.flat_pattern())
    if n_moe:
        if len(routed) != n_moe * steps:
            fail(f"{cfg.name}: {len(routed)} MoE calls recorded over the "
                 f"decode steps, expected {n_moe * steps}")
        per_expert = e_bytes / (n_moe * cfg.moe.num_experts)
        for i, (router, x) in enumerate(routed):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router,
                                  dim=-1)
            hit = torch.topk(probs, cfg.moe.top_k, dim=-1).indices.unique()
            routed_bytes[i // n_moe] += hit.numel() * per_expert
    step_bounds = [(w_bytes + r + kv_bytes + state_bytes) / PEAK_BYTES_S
                   * 1e3 for r in routed_bytes]
    step_bound = sum(step_bounds) / steps
    mean_routed = sum(routed_bytes) / steps
    log(f"decode step bound (mean of the {steps} steps): "
        f"{w_bytes / 1e9:.2f} GB of weights but experts + "
        f"{mean_routed / 1e9:.2f} GB of the experts the step routes to + "
        f"{kv_bytes / 1e9:.3f} GB of live K/V or latent (mean step) + "
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
        params, cfg, cache, step_input(tokens), LM_PROMPT + steps - 1,
        step_pos[-1]))
    log_trace(f"{cfg.name} decode step b={LM_BATCH}", prof)
    # the same prompts again: rows 0..LM_PROMPT-1 get the same K/V (a
    # recurrent state just runs on: the work is the same)
    prof_prefill = trace_call(torch, lambda: serve_prefill(
        params, cfg, cache, prompts, pos))
    log_trace(f"{cfg.name} prefill {LM_BATCH}x{LM_PROMPT}", prof_prefill)
    return counts, {"prefill_ms": prefill_s * 1e3, "steps": steps,
                    "decode_step_ms": step_ms,
                    "decode_step_median_ms": median,
                    "decode_host_wall_ms": decode_s * 1e3 / steps,
                    "decode_step_bound_ms": step_bound,
                    "decode_step_bounds_ms": step_bounds,
                    "weight_bytes": w_bytes, "routed_expert_bytes":
                    routed_bytes, "expert_bytes": e_bytes,
                    "state_bytes": state_bytes,
                    "cache_len": T,
                    "generated": gen.tolist(), "profile_decode": prof,
                    "profile_prefill": prof_prefill, "flash_routes": routes,
                    "position_launches": pos_launches,
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
def _rec_case(torch, g, kind, shape, dt, extra, fp32, cut=None):
    """(kernel call, plain call, bytes, flops, the peak they run at
    (``PEAK_FLOPS_S``), the kernel's state, the plain version's state) of
    one recorded recurrence call on fresh inputs, in the path's dtypes or
    (``fp32``) all float32. The state is zero (m = -inf) for a prompt and
    one reached mid-sequence for a decode step; each call of the pair
    gets its own copy, since both overwrite it. ``cut`` (the mLSTM: the
    whole model's heads and dv, a head and a first column) makes the
    state that whole one and hands each call its slice at one head and
    ``shape``'s dv columns, copied as the column plan on a mesh copies it
    (``local_calls.copied_slice``)."""
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
        Hs, dvs = (H, dv) if cut is None else cut[:2]
        if T == 1:
            state = (rand((B, Hs, dk, dvs), scale=0.3),
                     rand((B, Hs, dk)).abs() + 0.1, rand((B, Hs)))
        else:
            state = (torch.zeros(B, Hs, dk, dvs, device=DEV),
                     torch.zeros(B, Hs, dk, device=DEV),
                     torch.full((B, Hs), float("-inf"), device=DEV))
        if cut is not None:
            from repro_torch.parallel.local_calls import copied_slice
            head, c0 = cut[2:]
            state = (copied_slice(state[0], (1, head, 1), (3, c0, dv)),
                     *(copied_slice(t, (1, head, 1)) for t in state[1:]))
        mine, plain = [t.clone() for t in state], [t.clone() for t in state]
        el = q.element_size()
        nbytes = (q.numel() + k.numel() + 2 * v.numel()) * el \
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


def check_split_mlstm(torch, calls):
    """The mLSTM kernel at what one model rank of xlstm-125m is given on
    the production meshes (``SPLIT_MODEL_AXIS``): the recorded prompt
    and decode batches at one head, dk 384 and dv 96, its state a copied
    slice of the whole model's (``_rec_case``'s ``cut``), on both routes;
    held against the plain version (h and the final state) in float32 and
    in the path's dtypes, timed in the path's, each case's time and bound
    logged. Returns the rows."""
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-125m")
    E = int(cfg.xlstm.proj_factor * cfg.d_model)
    H = cfg.num_heads
    dh = E // H                             # dk = dv
    per_head = SPLIT_MODEL_AXIS // H
    dvl = dh // per_head
    head, c0 = SPLIT_RANK // per_head, (SPLIT_RANK % per_head) * dvl
    g = torch.Generator(device=DEV).manual_seed(71)
    rows = []
    seen = sorted({(shape[0][:2], dt, extra) for k, shape, dt, extra
                   in calls if k == "mlstm"}, key=str)
    for (B, T), dt, extra in seen:
        shape = ((B, T, 1, dh), (B, T, 1, dvl))
        way = REC_ROUTES["mlstm"]["step" if T == 1 else "prompt"]
        for fp32 in (True, False):
            kernel, plain, nbytes, flops, peak, st_k, st_p = _rec_case(
                torch, g, "mlstm", shape, dt, extra, fp32,
                cut=(H, dh, head, c0))
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            tol = REC_TOL["float32" if fp32 else "bfloat16"]
            if not torch.isfinite(got).all():
                fail(f"mlstm_chunk split {shape}: output not finite")
            torch.testing.assert_close(got, want, **tol)
            for a, b in zip(st_k, st_p):
                torch.testing.assert_close(a, b, **REC_TOL["float32"])
            err = (got.float() - want.float()).abs().max().item()
            what = (f"mlstm_chunk split ({SPLIT_MODEL_AXIS}-way model axis, "
                    f"head {head} columns {c0}-{c0 + dvl - 1}) {shape} "
                    f"{way} {'float32' if fp32 else (dt, extra)}")
            if fp32:
                err32 = err
                log(f"{what}: max|err| {err:.3e} (tol {tol})")
                continue
            b_ms, b_by = bound_ms(nbytes, flops, peak)
            row = {"shape": shape, "route": way, "head": head,
                   "columns": (c0, c0 + dvl), "max_abs_err": err,
                   "max_abs_err_float32": err32,
                   "ms": cuda_ms(torch, kernel),
                   "plain_ms": cuda_ms(torch, plain, iters=PLAIN_REC_ITERS,
                                       reps=1),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            log(f"{what} (tol {tol}): max|err| {err:.3e}; kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.3f} GFLOP at the {peak} peak)")
    if {r["route"] for r in rows} != set(REC_ROUTES["mlstm"].values()):
        fail(f"mlstm_chunk split: routes {[r['route'] for r in rows]}, not "
             f"both of {sorted(REC_ROUTES['mlstm'].values())}")
    return rows


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
    if not jamba:
        details["kernel_split"] = check_split_mlstm(torch, calls)
        entry["split"] = {r["route"]: {k: r[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err_float32")} for r in details["kernel_split"]}
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


# ---------------------------------------------------------------------------
# the rest of the LM family: qwen2-vl (M-RoPE, embedding inputs),
# chunked prefill, deepseek-v3 (MLA, MTP), LMCascade, the serving CLI
# ---------------------------------------------------------------------------
def qwen_feed(torch, cfg, g, steps):
    """qwen2-vl's prompt and positions: LM_BATCH x LM_PROMPT embeddings of
    a standard normal (bf16); M-RoPE positions t = 0 and (h, w) over the
    QWEN_GRID patch grid row by row (three distinct axes); each decode
    step at text position max + 1 + step on every axis."""
    rows, cols = QWEN_GRID
    if rows * cols != LM_PROMPT:
        fail(f"the patch grid {QWEN_GRID} is not {LM_PROMPT} tokens")
    emb = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), generator=g,
                      device=DEV).to(torch.bfloat16)
    r = torch.arange(LM_PROMPT, device=DEV)
    pos = torch.stack([torch.zeros_like(r), r // cols, r % cols])
    pos = pos[:, None, :].expand(3, LM_BATCH, LM_PROMPT).contiguous()
    start = max(rows, cols)
    step_pos = [torch.full((3, LM_BATCH, 1), start + i, device=DEV)
                for i in range(steps)]
    return emb, pos, step_pos


def _offset_case(torch, g, qs, ks, q_off, dt=None):
    """Inputs, calls, bytes and flops of one flash call with a query
    offset: the chunk's queries against the cache's first q_off + Sq
    rows, in ``dt`` (bfloat16 by default). The library call is SDPA with
    the offset's causal mask given explicitly (a boolean mask; GQA by
    ``enable_gqa``)."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref
    F = torch.nn.functional
    dt = dt or torch.bfloat16
    B, Sq, H, D = qs
    kv = q_off + Sq
    q = torch.randn(qs, generator=g, device=DEV).to(dt)
    k = torch.randn(ks, generator=g, device=DEV).to(dt)
    v = torch.randn(ks, generator=g, device=DEV).to(dt)
    mask = torch.ones(Sq, kv, dtype=torch.bool, device=DEV).tril(q_off)
    qt, kt, vt = (q.transpose(1, 2), k[:, :kv].transpose(1, 2),
                  v[:, :kv].transpose(1, 2))
    pairs = sum(q_off + r + 1 for r in range(Sq))
    return (lambda: tflash.flash_attention(q, k, v, causal=True, kv_len=kv,
                                           q_offset=q_off),
            lambda: ref.flash_attention_ref(q, k, v, causal=True, kv_len=kv,
                                            q_offset=q_off),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask,
                                                   enable_gqa=True),
            (2 * q.numel() + 2 * B * kv * ks[2] * D) * q.element_size(),
            4.0 * B * H * pairs * D)


def _position_case(torch, g, qs, ks, kv, positions, dt=None):
    """Inputs, calls, bytes and flops of one flash call with a query
    position tensor (the recorded one): the queries against the first kv
    rows, key j visible to row r of sequence b where j <= positions[b,
    r]. The library call is SDPA with that mask given explicitly (a
    boolean (B, 1, Sq, kv) mask; GQA by ``enable_gqa``). The bytes count
    the K/V rows these positions need (sequence b's first
    min(kv, max_r positions[b, r] + 1)), the flops the (query, key)
    pairs they let through."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref
    F = torch.nn.functional
    dt = dt or torch.bfloat16
    B, Sq, H, D = qs
    q = torch.randn(qs, generator=g, device=DEV).to(dt)
    k = torch.randn(ks, generator=g, device=DEV).to(dt)
    v = torch.randn(ks, generator=g, device=DEV).to(dt)
    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    mask = (torch.arange(kv, device=DEV)[None, None, :]
            <= pos[:, :, None])[:, None]
    qt, kt, vt = (q.transpose(1, 2), k[:, :kv].transpose(1, 2),
                  v[:, :kv].transpose(1, 2))
    pairs = torch.clamp(pos.long() + 1, max=kv).sum().item()
    kv_rows = torch.clamp(pos.long().amax(dim=1) + 1, max=kv).sum().item()
    return (lambda: tflash.flash_attention(q, k, v, causal=True, kv_len=kv,
                                           q_positions=pos),
            lambda: ref.flash_attention_ref(q, k, v, causal=True, kv_len=kv,
                                            q_positions=pos),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask,
                                                   enable_gqa=True),
            (2 * q.numel() + 2 * kv_rows * ks[2] * D) * q.element_size()
            + 4 * B * Sq,
            4.0 * H * pairs * D)


def check_chunk_route(torch, calls, what, kind):
    """The wgmma route with a query offset (``kind`` "flash_offset") or a
    query-position tensor ("flash_positions") against its plain version
    at each recorded call of that kind, at its shapes and offset or
    positions (bf16: held and timed; float32 is not its route), with SDPA
    under the explicit mask as the library time. Returns the rows."""
    mult = Counter((shape, extra) for k, shape, _, extra in calls
                   if k == kind)
    if not mult:
        fail(f"{what}: no {kind} call was recorded")
    g = torch.Generator(device=DEV).manual_seed(91)
    rows = []
    for ((qs, ks), extra), n in sorted(mult.items(), key=str):
        if kind == "flash_offset":
            q_off, kv = extra
            case = _offset_case(torch, g, qs, ks, q_off)
            info = {"q_offset": q_off, "kv_len": kv}
            label = f"offset route q {qs} k/v {ks} q_offset {q_off} " \
                    f"kv_len {kv}"
        else:
            kv, positions = extra
            kv = ks[1] if kv is None else kv
            case = _position_case(torch, g, qs, ks, kv, positions)
            t = sorted({p for row in positions for p in row})
            info = {"kv_len": kv,
                    "positions": f"{len(t)} distinct, {t[0]}..{t[-1]}"}
            label = f"position route q {qs} k/v {ks} kv_len {kv} " \
                    f"positions {info['positions']}"
        kernel, plain, library, nbytes, flops = case
        err, tol = _hold(torch, "flash_attention", kernel(), plain(),
                         "bfloat16")
        row = {"kind": kind, "q": qs, "k": ks, **info, "dtype": "bfloat16",
               "per_path": n, "max_abs_err": err, "route": "wgmma",
               **_time_rows(torch, kernel, plain, library, nbytes, flops,
                            "bfloat16")}
        rows.append(row)
        _report("flash_attention", row, f"{what} {label} bfloat16 x{n} "
                f"(tol {tol})")
    return rows


def chunked_prefill(torch, cfg, params, emb, pos, one_shot):
    """The prompt prefilled in chunks of CHUNK at cache_index 0, CHUNK,
    ...; every launch counter zeroed just before and read just after.
    With ``pos`` (the prompt's positions) every chunk's attention takes
    the wgmma route's query positions; without (the default positions,
    the slots) the later chunks take its query offset. Their
    last-position logits must equal the one-shot prefill's (``one_shot``,
    with the same positions) within LM_BF16_REL."""
    from repro_torch.kernels import ops
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.transformer import forward
    chunks = LM_PROMPT // CHUNK
    cache = init_cache(cfg, LM_BATCH, LM_PROMPT, DEV)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(chunks):
            sl = slice(i * CHUNK, (i + 1) * CHUNK)
            logits, cache, _ = forward(
                params, cfg, emb[:, sl],
                positions=None if pos is None else pos[..., sl],
                cache=cache, cache_index=i * CHUNK, mode="prefill")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    offset, at_pos = ops.offset_launches(), ops.position_launches()
    routes = ops.route_counts()
    want = path_counts(cfg, chunks, 0)
    n_attn = sum(m == "attn" for m, _ in cfg.flat_pattern())
    want_off, want_pos = ((chunks - 1) * n_attn, 0) if pos is None \
        else (0, chunks * n_attn)
    how = "the slots" if pos is None else "the prompt's positions"
    last = logits[:, -1].float()
    err = rel_diff(last, one_shot)
    log(f"chunked prefill {cfg.name} at {how}: {chunks} chunks of {CHUNK} "
        f"at cache_index {[i * CHUNK for i in range(chunks)]} in "
        f"{wall * 1e3:.2f} ms; last-position logits vs the one-shot "
        f"prefill max|diff|/max|logit| {err:.3e} (tolerance {LM_BF16_REL}); "
        f"launches {counts} (expected {want}); flash by route {routes}, "
        f"with a query offset {offset} (expected {want_off}), with query "
        f"positions {at_pos} (expected {want_pos})")
    if counts != want or (offset, at_pos) != (want_off, want_pos) \
            or routes["wgmma"] != chunks * n_attn:
        fail(f"chunked prefill {cfg.name}: launches {counts}, offset "
             f"{offset}, positions {at_pos}, routes {routes}")
    if not torch.isfinite(last).all() or err > LM_BF16_REL:
        fail(f"chunked prefill {cfg.name}: logits differ from the one-shot "
             f"prefill by {err:.3e} > {LM_BF16_REL}")
    return counts, {"wall_ms": wall * 1e3, "rel_diff": err,
                    "offset_launches": offset, "position_launches": at_pos,
                    "flash_routes": routes}


def qwen_phase(torch):
    """qwen2-vl-7b at full size in bf16: the logits check (embeddings and
    M-RoPE positions), its kernels at the path's shapes (GQA group 7),
    the served run, and the chunked prefill with the offset route held
    and timed at its shapes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import serve_prefill
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.transformer import count_params, init_params
    cfg = get_config(QWEN_ARCH)
    details = {}
    t0 = time.perf_counter()
    params = init_params(cfg, seed=70, device=DEV)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for _, t in _named(params))
    log(f"{QWEN_ARCH} random init at full size, {cfg.num_layers} layers: "
        f"{count_params(cfg) / 1e9:.3f} B parameters, {n_bytes / 1e9:.2f} GB "
        f"bfloat16 in {time.perf_counter() - t0:.2f} s (no embedding "
        f"table: the inputs are embeddings)")
    details["param_bytes"] = n_bytes
    g = torch.Generator(device=DEV).manual_seed(71)
    emb, pos, step_pos = qwen_feed(torch, cfg, g, LM_STEPS)
    calls, details["bf16"] = lm_logits_check(
        torch, cfg, params, emb, LM_BF16_REL,
        f"{QWEN_ARCH} full size bfloat16 (M-RoPE t=0, (h, w) over "
        f"{QWEN_GRID[0]}x{QWEN_GRID[1]})", feed=(pos, emb[:, -1:],
                                                step_pos[0]))
    path_calls(calls, cfg)
    details["kernels"], _ = hold_lm_calls(
        torch, torch.Generator(device=DEV).manual_seed(72), calls,
        ("rmsnorm", "rmsnorm_res", "swiglu", "flash", "decode"),
        f"{QWEN_ARCH} ")
    counts, details["slice"] = serve_lm(torch, cfg, params, steps=LM_STEPS,
                                        feed=(emb, pos, step_pos))
    # the decode steps sit at t = max(grid) + step, below their slots:
    # the recorded decode calls (held above) ran at valid_len t + 1
    valid = sorted({v for kind, _, _, extra in calls if kind == "decode"
                    for v in extra})
    log(f"{QWEN_ARCH} decode at t {step_pos[0][0, 0, 0].item()} < slot "
        f"{LM_PROMPT}: decode attention held at valid_len {valid} (slot + 1 "
        f"= {LM_PROMPT + 1})")
    if not valid or max(valid) >= LM_PROMPT + 1:
        fail(f"{QWEN_ARCH}: the decode call's valid_len {valid} does not "
             f"follow t < slot")
    details["positions_route"] = check_chunk_route(
        torch, calls, f"{QWEN_ARCH} prefill", "flash_positions")
    # held only (no launch of the path): the prefill's shapes with the
    # grid's t = 0 on the first half of the prompt and text after it
    # (t = max(grid) + i), so the mask and the tiles' key ends above key
    # 0 are held at full width too
    shapes = next(shape for kind, shape, _, _ in calls
                  if kind == "flash_positions")
    half = LM_PROMPT // 2
    text = tuple([0] * half + [max(QWEN_GRID) + i
                               for i in range(LM_PROMPT - half)])
    held = check_chunk_route(
        torch, [("flash_positions", shapes, None,
                 (None, (text,) * shapes[0][0]))],
        f"{QWEN_ARCH} grid then text (held only)", "flash_positions")
    details["positions_route"] += [dict(r, per_path=0) for r in held]
    # the one-shot prefill, then the same prompt in chunks: at the
    # prompt's positions (the position route), then at the slots (the
    # offset route)
    ccounts = dict.fromkeys(counts, 0)
    for key, p in (("chunked", pos), ("chunked_slots", None)):
        cache = init_cache(cfg, LM_BATCH, LM_PROMPT, DEV)
        one_shot, _ = serve_prefill(params, cfg, cache, emb, p)
        del cache
        c, details[key] = chunked_prefill(torch, cfg, params, emb, p,
                                          one_shot.float())
        ccounts = {k: ccounts[k] + c[k] for k in counts}
        chunk_calls = []
        with recorded_calls(chunk_calls):
            chunked_prefill(torch, cfg, params, emb, p, one_shot.float())
        if p is None:
            details["offset_route"] = check_chunk_route(
                torch, chunk_calls, QWEN_ARCH, "flash_offset")
        else:
            details["positions_route"] += check_chunk_route(
                torch, chunk_calls, f"{QWEN_ARCH} chunked", "flash_positions")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] + ccounts[k] for k in counts}, details


def deepseek_phase(torch):
    """deepseek-v3 at full width, depth cut to DS_LAYERS (the 3 dense
    prefix layers and 1 MoE layer) plus the multi-token prediction block:
    the logits check, its RMSNorm and SwiGLU calls at the path's shapes,
    the served run (DS_STEPS absorbed decode steps), then ``mtp_logits``
    from the prefill's hidden state through the kernels and the plain
    versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.transformer import (count_params, forward,
                                                init_params, mtp_logits)
    full = get_config(DS_ARCH)
    cfg = dataclasses.replace(full, num_layers=DS_LAYERS)
    details = {"layers": DS_LAYERS, "pattern": [list(s) for s in
                                                cfg.flat_pattern()]}
    t0 = time.perf_counter()
    params = init_params(cfg, seed=75, device=DEV)
    torch.cuda.synchronize()
    parts = Counter()
    for name, t in _named(params):
        head = name.split("/")[0]
        key = head if head != "layers" else f"layer {name.split('/')[1]}"
        parts[key] += t.numel() * t.element_size()
    n_bytes = sum(parts.values())
    log(f"{DS_ARCH} random init at full width, depth cut to {DS_LAYERS} "
        f"layers {cfg.flat_pattern()} + the MTP block: "
        f"{count_params(cfg) / 1e9:.3f} B parameters, {n_bytes / 1e9:.2f} GB "
        f"bfloat16 in {time.perf_counter() - t0:.2f} s; by part (GB): "
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items()))
    details["param_bytes"] = dict(parts)
    g = torch.Generator(device=DEV).manual_seed(76)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=g, device=DEV)
    calls, details["bf16"] = lm_logits_check(
        torch, cfg, params, prompts, LM_BF16_REL,
        f"{DS_ARCH} full width {DS_LAYERS} layers bfloat16")
    path_calls(calls, cfg)
    details["kernels"], _ = hold_lm_calls(
        torch, torch.Generator(device=DEV).manual_seed(77), calls,
        ("rmsnorm", "rmsnorm_res", "swiglu"), f"{DS_ARCH} ")
    counts, details["slice"] = serve_lm(torch, cfg, params, steps=DS_STEPS)
    # the multi-token prediction head from the prefill's hidden state:
    # hidden_i with the embedding of token i+1 predicts token i+2
    nxt = torch.cat([prompts[:, 1:], prompts[:, :1]], dim=1)

    def mtp():
        with torch.no_grad():
            cache = init_cache(cfg, LM_BATCH, LM_PROMPT, DEV)
            _, _, aux, hidden = forward(params, cfg, prompts, cache=cache,
                                        mode="prefill", return_hidden=True)
            lg, mtp_aux = mtp_logits(params, cfg, hidden, nxt)
        return lg[:, -1].float(), aux.float(), mtp_aux.float()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    k_lg, k_aux, k_maux = mtp()
    torch.cuda.synchronize()
    mtp_ms = (time.perf_counter() - t0) * 1e3
    mcounts = ops.launch_counts()
    want = path_counts(cfg, 1, 0)
    block = dataclasses.replace(cfg, num_layers=1, prefix_pattern=(),
                                period_pattern=(cfg.period_pattern[-1],))
    for name, n in path_counts(block, 1, 0).items():
        # the MTP block, its two input norms; no final norm of its own
        # beyond the shared one it applies again
        want[name] += n
    want["fused_rmsnorm"] += 2
    with plain_ops():
        p_lg, p_aux, p_maux = mtp()
    err = rel_diff(k_lg, p_lg)
    log(f"{DS_ARCH} prefill + mtp_logits from its hidden state "
        f"{mtp_ms:.2f} ms: kernels vs plain versions, max|diff|/max|logit| "
        f"{err:.3e} (tolerance {LM_BF16_REL}); aux loss {k_aux.item():.6f} "
        f"(plain {p_aux.item():.6f}), MTP aux {k_maux.item():.6f} (plain "
        f"{p_maux.item():.6f}); launches {mcounts} (expected {want})")
    if mcounts != want:
        fail(f"{DS_ARCH} mtp: launches {mcounts} != expected {want}")
    if not torch.isfinite(k_lg).all() or err > LM_BF16_REL \
            or not (k_aux > 0 and k_maux > 0):
        fail(f"{DS_ARCH} mtp: logits or aux losses wrong ({err:.3e})")
    details["mtp"] = {"ms": mtp_ms, "rel_diff": err, "aux": k_aux.item(),
                      "mtp_aux": k_maux.item()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] + mcounts[k] for k in counts}, details


def cascade_phase(torch, np):
    """``LMCascade`` over ``greedy_lm_step`` stages: smollm-135m at full
    size, then yi-9b at full width and depth, bf16; CASCADE_BATCH prompts
    of CASCADE_PROMPT tokens below the smaller vocabulary, CASCADE_NEW
    new tokens; the threshold the median of stage 0's confidences, so
    both stages serve. Counters zeroed just before ``run_batch`` and read
    just after. Each output must be its stage's own output."""
    from repro_torch.configs import get_config
    from repro_torch.core.cascade import LMCascade, greedy_lm_step
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    cfgs = [get_config(a) for a in CASCADE_ARCHS]
    t0 = time.perf_counter()
    params = [init_params(c, seed=85 + i, device=DEV)
              for i, c in enumerate(cfgs)]
    torch.cuda.synchronize()
    log(f"LM cascade {' -> '.join(CASCADE_ARCHS)}: random init "
        f"{time.perf_counter() - t0:.2f} s")
    steps = [greedy_lm_step(p, c, CASCADE_NEW, device=DEV)
             for p, c in zip(params, cfgs)]
    vocab = min(c.vocab_size for c in cfgs)
    g = torch.Generator(device=DEV).manual_seed(86)
    prompts = torch.randint(0, vocab, (CASCADE_BATCH, CASCADE_PROMPT),
                            generator=g, device=DEV).cpu().numpy()
    alone = [step(prompts) for step in steps]
    conf0 = np.exp(alone[0][1]).mean(axis=-1)
    thr = float(np.median(conf0))
    casc = LMCascade(*steps)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = casc.run_batch(prompts, thr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    for c in cfgs:
        for name, n in path_counts(c, 1, CASCADE_NEW - 1).items():
            want[name] += n
    stage_out = np.stack([alone[st][0][j]
                          for j, st in enumerate(res.stage_index)])
    own = np.array([np.array_equal(res.outputs[j], stage_out[j])
                    for j in range(CASCADE_BATCH)])
    n_heavy = int((res.stage_index == 1).sum())
    log(f"LM cascade {' -> '.join(CASCADE_ARCHS)} b={CASCADE_BATCH} "
        f"prompt {CASCADE_PROMPT} new {CASCADE_NEW}: threshold {thr:.4f} "
        f"(median of stage-0 confidences "
        f"{[float(f'{c:.5e}') for c in conf0]}); "
        f"{n_heavy} of {CASCADE_BATCH} deferred to {CASCADE_ARCHS[1]}; "
        f"run_batch {wall * 1e3:.2f} ms; each output its stage's own: "
        f"{bool(own.all())}; launches {counts} (expected {want})")
    if not own.all() or not 0 < n_heavy < CASCADE_BATCH:
        fail(f"LM cascade: outputs {own.tolist()}, {n_heavy} deferred")
    if not np.array_equal(res.confidences, conf0) or counts != want:
        fail(f"LM cascade: confidences or launches differ ({counts} != "
             f"{want})")
    routes = check_routes(torch, "LM cascade", "bfloat16", 128, "wgmma",
                          counts["flash_attention"])
    del params, steps, casc
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"threshold": thr, "confidences": conf0.tolist(),
                    "stage_index": res.stage_index.tolist(),
                    "run_batch_ms": wall * 1e3, "flash_routes": routes}


def serve_cli_phase():
    """``repro_torch.launch.serve.main`` in process (the simulator; no
    kernel runs)."""
    import io
    from repro_torch.launch import serve
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        report = serve.main(SERVE_ARGV)
    wall = time.perf_counter() - t0
    log(f"serving CLI {' '.join(SERVE_ARGV)} ({wall:.2f} s host): "
        + json.dumps({k: v for k, v in report.items()
                      if k != "threshold_timeline"}))
    if report["completed"] + report["dropped"] + report["shed_admission"] \
            != report["total_queries"] or not report["completed"]:
        fail(f"serving CLI: the report does not conserve queries: {report}")
    return report


def lm_family_phase(torch, np):
    """The rest of the LM family, one model after another, each freed
    before the next. Returns the offset route's kernel-line entry, the
    launches of the family's main-path runs, and the details."""
    details = {}
    counts, details[QWEN_ARCH] = qwen_phase(torch)
    ds_counts, details[DS_ARCH] = deepseek_phase(torch)
    c_counts, details["lm_cascade"] = cascade_phase(torch, np)
    details["serve_cli"] = serve_cli_phase()
    total = {k: counts[k] + ds_counts[k] + c_counts[k] for k in counts}
    qd = details[QWEN_ARCH]
    entries = {}
    for way, rows, launches, per in (
            ("wgmma_offset", qd["offset_route"],
             qd["chunked_slots"]["offset_launches"],
             f"one {QWEN_ARCH} prompt ({LM_BATCH}x{LM_PROMPT}) at the "
             f"slots in chunks of {CHUNK}"),
            ("wgmma_positions", qd["positions_route"],
             qd["slice"]["position_launches"]
             + qd["chunked"]["position_launches"],
             f"one {QWEN_ARCH} prefill and the same prompt in chunks of "
             f"{CHUNK}, at its M-RoPE positions (t = 0)")):
        path = [r for r in rows if r["per_path"]]
        entries[way] = {
            "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{key: sum(r["per_path"] * (r[key] or 0.0) for r in path)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "launches": launches,
            "per": f"{per}: {sum(r['per_path'] for r in path)} launches"}
    return entries, total, details


def _step_events(torch, n):
    return [(torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True)) for _ in range(n)]


def _median_ms(events):
    ms = sorted(e0.elapsed_time(e1) for e0, e1 in events)
    return ms[len(ms) // 2], ms


def _bitwise_equal(torch, a, b) -> bool:
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def train_entry_point(torch):
    """``repro_torch.launch.train.main`` as a user calls it (on the card by
    default; the reduced config, batch and sequence at their defaults):
    LAUNCH_STEPS steps with checkpoints every 2, then the same command
    with 2 more steps resumes from the newest checkpoint."""
    import io
    import tempfile
    from repro_torch.launch import train as launch_train
    from repro_torch.training import checkpoint
    out = []
    with tempfile.TemporaryDirectory() as ck:
        for steps in (LAUNCH_STEPS, LAUNCH_STEPS + 2):
            argv = ["--arch", TRAIN_ARCH, "--steps", str(steps), "--lr",
                    str(TRAIN_LR), "--ckpt", ck, "--ckpt-every", "2",
                    "--seed", str(TRAIN_SEED)]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                launch_train.main(argv)
            torch.cuda.synchronize()
            out.append(buf.getvalue().splitlines())
            log(f"train entry point {' '.join(argv)} "
                f"({time.perf_counter() - t0:.2f} s host): "
                + " | ".join(out[-1]))
        saved = [st for st, _ in checkpoint.sorted_steps(ck)]
    want_saved = [LAUNCH_STEPS - 2, LAUNCH_STEPS, LAUNCH_STEPS + 2]
    if f"resumed from step {LAUNCH_STEPS}" not in out[1] \
            or out[0][-1] != "done" or out[1][-1] != "done" \
            or saved != want_saved:
        fail(f"train entry point: no resume from step {LAUNCH_STEPS}, or "
             f"checkpoints {saved} != {want_saved}: {out}")
    return {"stdout": out, "checkpoints": saved}


def _card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if DEV != "cuda":
        return "no card (a CPU rehearsal)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def step_memory(torch, label, step, args, meta_args):
    """One call of ``step`` over ``meta`` arguments under the dry run's
    memory record (``analysis.count.Live``: peak live bytes of what the
    step allocates, its arguments not counted) beside one call on the
    card over ``args``: ``torch.cuda.max_memory_allocated()`` after
    ``reset_peak_memory_stats()``, whole and less the bytes allocated
    before the call (the arguments and whatever else is resident).
    ``meta_args`` None: the card's bytes alone, no record."""
    from repro_torch.analysis.count import Live
    live = None
    if meta_args is not None:
        with Live() as live:
            step(*meta_args)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    card = _card_line()
    record = "no record over meta" if live is None else (
        f"the record over meta {live.peak} bytes (largest allocation "
        f"{live.largest})")
    log(f"step memory {label}: {record}; on the card max_memory_allocated "
        f"{peak} bytes, {peak - base} above the {base} allocated before the "
        f"step ({card})")
    if live is not None and not 0 < live.peak:
        fail(f"step memory {label}: the record counted nothing")
    return {"record_peak_bytes": None if live is None else live.peak,
            "record_largest": None if live is None else live.largest,
            "card_peak_bytes": peak, "card_base_bytes": base,
            "card_peak_above_base": peak - base, "card": card}


def lm_training(torch, np, cfg):
    """TRAIN_STEPS AdamW steps of ``make_train_step`` on the full-size
    model, each between CUDA events, with a checkpoint at
    TRAIN_CKPT_STEP; that checkpoint loaded into fresh trees, and the next
    step taken from both the loaded and the kept state (deterministic
    algorithms on, so both run the same sums): the loaded trees, the
    step's metrics and the new trees must equal the kept ones bit for
    bit. The loss must fall."""
    import tempfile
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import count_params, init_params
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    tcfg = TrainConfig(opt=OptimizerConfig(
        peak_lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10, 1),
        total_steps=TRAIN_STEPS + 1))
    params = init_params(cfg, seed=TRAIN_SEED, device=DEV)
    opt_init, step = make_train_step(cfg, tcfg)
    opt = opt_init(params)
    rng = np.random.default_rng(TRAIN_SEED)
    batches = [launch_train.make_batch(cfg, rng, TRAIN_BATCH, TRAIN_SEQ,
                                       TRAIN_SEED, i, DEV)
               for i in range(TRAIN_STEPS + 1)]
    events = _step_events(torch, TRAIN_STEPS)
    losses, kept = [], None
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as ck:
        for i, (e0, e1) in enumerate(events):
            e0.record()
            params, opt, m = step(params, opt, batches[i])
            e1.record()
            losses.append(m["loss"])
            if i + 1 == TRAIN_CKPT_STEP:
                checkpoint.save(ck, (params, opt), i + 1, cfg=cfg)
                kept = (params, opt)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        median, step_ms = _median_ms(events)
        losses = [x.item() for x in losses]
        fresh = init_params(cfg, seed=TRAIN_SEED + 1, device=DEV)
        (lp, lo), at, _ = checkpoint.load(ck, (fresh, opt_init(fresh)),
                                          device=DEV, cfg=cfg)
    loaded_equal = _bitwise_equal(torch, (lp, lo), kept)
    nxt = batches[TRAIN_CKPT_STEP]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = step(*kept, nxt)
        b = step(lp, lo, nxt)
    finally:
        torch.use_deterministic_algorithms(False)
    metrics_equal = all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    next_equal = _bitwise_equal(torch, a[:2], b[:2])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"train {cfg.name} at full size ({count_params(cfg) / 1e6:.1f} M "
        f"parameters, {cfg.dtype}), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"AdamW lr {TRAIN_LR}: loss by step "
        f"{[round(x, 4) for x in losses]}; step time median "
        f"{median:.3f} ms (min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}; "
        f"CUDA events over {TRAIN_STEPS} steps), "
        f"{tokens / median * 1e3:.0f} tokens/s; peak device memory "
        f"{peak / 1e9:.2f} GB")
    log(f"train checkpoint round trip at step {at}: loaded trees equal the "
        f"kept ones bit for bit {loaded_equal}; the next step from both: "
        f"metrics equal {metrics_equal}, new trees equal {next_equal} "
        f"(loss {a[2]['loss'].item():.6f})")
    if not all(np.isfinite(losses)) or np.mean(losses[-4:]) \
            >= np.mean(losses[:4]):
        fail(f"train {cfg.name}: the loss did not fall: {losses}")
    if at != TRAIN_CKPT_STEP or not (loaded_equal and metrics_equal
                                     and next_equal):
        fail(f"train {cfg.name}: the checkpoint round trip differs")
    del a, b, lp, lo, kept
    meta_p = _on_meta(torch, params)
    memory = step_memory(torch, f"train {cfg.name} {TRAIN_BATCH} x "
                         f"{TRAIN_SEQ}", step, (params, opt, nxt),
                         (meta_p, opt_init(meta_p), _on_meta(torch, nxt)))
    return {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
            "losses": losses, "step_ms": step_ms, "step_median_ms": median,
            "tokens_per_s": tokens / median * 1e3, "peak_bytes": peak,
            "checkpoint_step": at, "memory": memory}


def remat_training(torch, np, cfg):
    """The TRAIN_ARCH step (TRAIN_BATCH x TRAIN_SEQ) from one set of
    parameters, optimizer state and batch, under ``remat="none"``, under
    the config's policy (``dots_nb``: each period checkpointed, its
    weight products saved) and under ``full`` (nothing saved but each
    period's input; no selective-checkpoint dispatch mode), deterministic
    algorithms on: the metrics and the new trees must be equal bit for
    bit. For each policy, the median of REMAT_STEPS calls between CUDA
    events, a ``torch.profiler`` trace of one step (device busy time and
    the host's op calls, where the step's time goes) and a ``step
    memory`` line (the record over ``meta`` beside
    ``max_memory_allocated`` above the resident bytes). The checkpointed
    steps must hold less above them than the ``none`` step."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    tcfg = TrainConfig(opt=OptimizerConfig(peak_lr=TRAIN_LR))
    params = init_params(cfg, seed=TRAIN_SEED, device=DEV)
    batch = launch_train.make_batch(cfg, np.random.default_rng(TRAIN_SEED),
                                    TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED, 0,
                                    DEV)
    meta_p, meta_b = _on_meta(torch, params), _on_meta(torch, batch)
    card, out, firsts = _card_line(), {}, {}
    policies = ("none", cfg.remat, "full")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for policy in policies:
            pcfg = dataclasses.replace(cfg, remat=policy)
            opt_init, step = make_train_step(pcfg, tcfg)
            opt = opt_init(params)
            firsts[policy] = step(params, opt, batch)
            events = _step_events(torch, REMAT_STEPS)
            for e0, e1 in events:
                e0.record()
                step(params, opt, batch)
                e1.record()
            torch.cuda.synchronize()
            median, step_ms = _median_ms(events)
            trace = trace_call(torch, lambda: step(params, opt, batch),
                               host_ops=8)
            log_trace(f"train {cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} remat "
                      f"{policy}", trace)
            memory = step_memory(
                torch, f"train {cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} "
                f"remat {policy}", step, (params, opt, batch),
                (meta_p, opt_init(meta_p), meta_b))
            out[policy] = {"median_ms": median, "step_ms": step_ms,
                           "trace": trace, "memory": memory}
            log(f"train {cfg.name} remat {policy}: step median "
                f"{median:.3f} ms (min {step_ms[0]:.3f}, max "
                f"{step_ms[-1]:.3f}; CUDA events over {REMAT_STEPS} "
                f"steps), profiled step: wall {trace['wall_us']:.0f} us, "
                f"device busy {trace['device_busy_us']:.0f} us, "
                f"{trace['device_launches']} device launches, "
                f"{trace['host']['aten_calls']} aten op calls; "
                f"max_memory_allocated "
                f"{memory['card_peak_above_base']} bytes above the resident "
                f"{memory['card_base_bytes']}, the record over meta "
                f"{memory['record_peak_bytes']} ({card})")
            del opt
    finally:
        torch.use_deterministic_algorithms(False)
    a, bad = firsts.pop("none"), []
    base = out["none"]
    for policy, b in firsts.items():
        metrics_equal = set(a[2]) == set(b[2]) and all(
            torch.equal(a[2][k], b[2][k]) for k in a[2])
        trees_equal = _bitwise_equal(torch, a[:2], b[:2])
        row = out[policy]
        held = (base["memory"]["card_peak_above_base"],
                row["memory"]["card_peak_above_base"])
        row.update(metrics_equal=metrics_equal, trees_equal=trees_equal)
        # (a CPU rehearsal's trace has no device time)
        ratio = {k: row["trace"][k] / max(base["trace"][k], 1e-9)
                 for k in ("wall_us", "device_busy_us", "device_launches")}
        ratio["aten_calls"] = (row["trace"]["host"]["aten_calls"]
                               / base["trace"]["host"]["aten_calls"])
        log(f"train {cfg.name} remat {policy} against none: metrics equal "
            f"{metrics_equal}, new trees equal {trees_equal} (bit for bit); "
            f"above the resident bytes {held[1]} against {held[0]} "
            f"({held[1] / held[0]:.4f} x); step median "
            f"{row['median_ms']:.3f} against {base['median_ms']:.3f} ms "
            f"({row['median_ms'] / base['median_ms']:.4f} x); profiled "
            f"step x none: wall {ratio['wall_us']:.4f}, device busy "
            f"{ratio['device_busy_us']:.4f}, device launches "
            f"{ratio['device_launches']:.4f}, aten op calls "
            f"{ratio['aten_calls']:.4f} ({card})")
        if not (metrics_equal and trees_equal):
            bad.append(f"remat {policy} changed the step")
        if not held[1] < held[0]:
            bad.append(f"remat {policy} held no less memory ({held[1]} "
                       f"against {held[0]} bytes)")
    if bad:
        fail(f"train {cfg.name}: {'; '.join(bad)}")
    del a, firsts
    return {"policies": policies, "nested": nested_remat(torch), **out}


@contextlib.contextmanager
def _counted_recompute():
    """Counts ``remat.recompute``'s calls (each checkpoint run, forward
    or recomputed) while the context is open."""
    from repro_torch import remat
    real, n = remat.recompute, {"calls": 0}

    def counted(fn, *args, **kwargs):
        n["calls"] += 1
        return real(fn, *args, **kwargs)
    remat.recompute = counted
    try:
        yield n
    finally:
        remat.recompute = real


def nested_remat(torch):
    """Checkpoints inside checkpoints on the card's torch, at the
    configs' full widths and dtype (NESTED_REMAT): xlstm-125m at 512
    steps (two 256-step chunks of the plain mLSTM in each mLSTM layer)
    and smollm-135m at 2048 tokens (two 1024-row query chunks of the
    plain attention in each layer), one train step under ``remat="none"``
    (the chunks' own checkpoints) and under the config's ``dots_nb``
    (those nested in each period's), deterministic algorithms on:
    metrics and new trees must be equal bit for bit, and the ``dots_nb``
    step must have run more checkpoints. A ``step memory`` line for
    each, with the record over ``meta`` where NESTED_REMAT asks for
    it."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    tcfg = TrainConfig(opt=OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                           total_steps=10))
    rows = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arch, B, seq, record in NESTED_REMAT:
            got, memory = {}, {}
            full = get_config(arch)
            for policy in ("none", full.remat):
                cfg = dataclasses.replace(full, remat=policy)
                params = init_params(cfg, seed=96, device=DEV)
                g = torch.Generator(device=DEV).manual_seed(96)
                toks = torch.randint(0, cfg.vocab_size, (B, seq + 1),
                                     generator=g, device=DEV)
                batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
                opt_init, step = make_train_step(cfg, tcfg)
                with _counted_recompute() as n:
                    got[policy] = step(params, opt_init(params), batch)
                torch.cuda.synchronize()
                got[policy] += (n["calls"],)
                meta_p = _on_meta(torch, params)
                memory[policy] = step_memory(
                    torch, f"train {arch} {B} x {seq} remat {policy} "
                    f"(nested checkpoints)", step,
                    (params, opt_init(params), batch),
                    (meta_p, opt_init(meta_p), _on_meta(torch, batch))
                    if record else None)
                del params, meta_p
            a, b = got["none"], got[full.remat]
            equal = all(torch.equal(a[2][k], b[2][k]) for k in a[2]) \
                and _bitwise_equal(torch, a[:2], b[:2])
            held = {p: m["card_peak_above_base"] for p, m in memory.items()}
            rows[arch] = {"batch": B, "seq": seq, "dtype": str(full.dtype),
                          "equal": equal, "memory": memory,
                          "checkpoints": {"none": a[3], full.remat: b[3]}}
            log(f"nested checkpoints {arch} at full width, {B} x {seq} "
                f"tokens, {full.dtype}, torch {torch.__version__}: "
                f"{full.remat} step equals the none step bit for bit "
                f"{equal}; checkpoints run {a[3]} (none: the chunks') and "
                f"{b[3]} ({full.remat}: the periods' with the chunks' nested "
                f"in them and recomputed); above the resident bytes "
                f"{held[full.remat]} against {held['none']} "
                f"({held[full.remat] / held['none']:.4f} x)")
            if not equal or not 0 < a[3] < b[3]:
                fail(f"nested checkpoints {arch}: {rows[arch]}")
            del got, a, b
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return rows


def deepseek_training(torch, np):
    """One train step of reduced deepseek-v3 (float32; MTP, z-loss, its
    8-bit moments) in 2 microbatches, on the card and on the CPU from the
    same parameters and batch: the metrics and the gradient norm within
    MODEL_TOL's rtol. The gradients are held through the 8-bit first and
    second moments this first step writes (0.1 g and 0.03162 |g|, after
    the 2-microbatch accumulation and the clip): each block's scale (its
    largest |g| / 127) within that rtol of the leaf's largest, each code
    within one step (a value may sit on a rounding boundary). The update
    of step 1 is lr * g / (|g| + eps), +-lr wherever |g| >> eps, so where
    the CPU's first-moment code is at least 2 (|g| >= 1.5 / 127 of its
    block's largest, far above the rtol of the gradients) the card's new
    parameters are held within rtol * lr of the CPU's; below that a
    gradient's sign may differ within tolerance, and the update with
    it."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.convert import hwio_to_oihw
    from repro_torch.models.transformer import init_params
    from repro_torch.training.data import zipf_tokens
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.tree import leaves, map_tree
    cfg = reduced_config(DS_ARCH)
    tcfg = TrainConfig(opt=OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                           total_steps=10), microbatches=2)
    inp, lab = zipf_tokens(np.random.default_rng(97), DS_TRAIN_BATCH,
                           DS_TRAIN_SEQ, cfg.vocab_size)
    cpu_params = init_params(cfg, seed=97, device="cpu")
    out = {}
    for dev in (DEV, "cpu"):
        params = map_tree(lambda t: t.to(dev), cpu_params)
        opt_init, step = make_train_step(cfg, tcfg)
        batch = {"inputs": torch.as_tensor(inp, device=dev),
                 "labels": torch.as_tensor(lab, device=dev)}
        new, opt, m = step(params, opt_init(params), batch)
        out[dev] = (params, new, opt, {k: v.item() for k, v in m.items()})
    params, new, opt, m = out[DEV]
    _, cnew, copt, pm = out["cpu"]
    rtol = MODEL_TOL["rtol"]
    moved = sum(not torch.equal(a, b) for a, b in zip(leaves(params),
                                                      leaves(new)))
    err = max(abs(m[k] - pm[k]) / max(abs(pm[k]), 1e-12)
              for k in ("ce", "mtp_ce", "aux", "loss", "grad_norm"))
    eight = opt.m_scale is not None and all(
        t.dtype == torch.int8 for t in leaves(opt.m))
    if not eight:
        fail(f"train reduced {DS_ARCH}: the moments are not 8-bit")
    scale_err = max(
        ((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        for f in ("m_scale", "v_scale")
        for a, b in zip(leaves(getattr(opt, f)), leaves(getattr(copt, f))))
    code_gap = max((a.cpu().int() - b.int()).abs().max().item()
                   for f in ("m", "v")
                   for a, b in zip(leaves(getattr(opt, f)),
                                   leaves(getattr(copt, f))))
    upd_gap, held = 0.0, 0
    for a, b, q in zip(leaves(new), leaves(cnew), leaves(copt.m)):
        sure = hwio_to_oihw(q).abs() >= 2
        held += int(sure.sum())
        if sure.any():
            upd_gap = max(upd_gap, (a.cpu() - b)[sure].abs().max().item()
                          / m["lr"])
    log(f"train reduced {DS_ARCH} (MTP, z-loss {tcfg.z_loss}, 8-bit "
        f"moments {eight}), 2 microbatches of {DS_TRAIN_BATCH // 2} x "
        f"{DS_TRAIN_SEQ}: card {m}; CPU {pm}; largest relative difference "
        f"of the metrics and the gradient norm {err:.3e}, of the moments' "
        f"block scales {scale_err:.3e} (tolerance {rtol}); moment codes "
        f"within {code_gap} (at most 1); the update at {held} of "
        f"{sum(t.numel() for t in leaves(new))} parameters (first-moment "
        f"code >= 2) within {upd_gap:.3e} x lr (tolerance {rtol}); "
        f"{moved} of {len(leaves(params))} parameter leaves moved")
    if set(m) != {"ce", "aux", "mtp_ce", "loss", "lr", "grad_norm"} \
            or err > rtol or scale_err > rtol or code_gap > 1 \
            or upd_gap > rtol or not held or not m["aux"] > 0 \
            or moved < len(leaves(params)) // 2:
        fail(f"train reduced {DS_ARCH}: metrics {m} vs {pm}, block "
             f"scales {scale_err:.3e}, codes {code_gap}, update "
             f"{upd_gap:.3e} x lr")
    return {"card": m, "cpu": pm, "rel_diff": err, "moved": moved,
            "scale_rel_diff": scale_err, "code_gap": code_gap,
            "update_gap_lr": upd_gap, "update_held": held}


def diffusion_training(torch, full_cfg):
    """DIFF_TRAIN_STEPS AdamW steps of ``diffusion_loss`` (t and noise
    from a seeded generator) on the served tier-0 UNet at its full width,
    each between CUDA events."""
    from repro_torch.models.diffusion import diffusion_loss
    from repro_torch.models.unet import init_unet
    from repro_torch.training.optimizer import OptimizerConfig, make_adamw
    from repro_torch.tree import leaves, unflatten
    cfg = dataclasses.replace(full_cfg, name="tier0-turbo", num_steps=1)
    params = init_unet(cfg, seed=0, device=DEV)
    opt_init, opt_update = make_adamw(OptimizerConfig(
        peak_lr=DIFF_TRAIN_LR, warmup_steps=1,
        total_steps=DIFF_TRAIN_STEPS))
    opt = opt_init(params)
    g = torch.Generator(device=DEV).manual_seed(99)
    shape = (DIFF_TRAIN_BATCH, cfg.image_size, cfg.image_size,
             cfg.in_channels)
    x0 = torch.randn(shape, generator=g, device=DEV).clamp(-1, 1)
    toks = torch.randint(0, 1024, (DIFF_TRAIN_BATCH, PROMPT_LEN),
                         generator=g, device=DEV)
    events = _step_events(torch, DIFF_TRAIN_STEPS)
    losses = []
    torch.cuda.synchronize()
    for e0, e1 in events:
        e0.record()
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = diffusion_loss(unflatten(params, flat), cfg, x0, toks,
                              generator=g)
        grads = torch.autograd.grad(loss, flat)
        params, opt, _ = opt_update(unflatten(params, list(grads)), opt,
                                    params)
        e1.record()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    median, step_ms = _median_ms(events)
    losses = [x.item() for x in losses]
    log(f"train {cfg.name} UNet at full width (base {cfg.base_channels}, "
        f"{cfg.image_size}x{cfg.image_size}x{cfg.in_channels}) with "
        f"diffusion_loss, batch {DIFF_TRAIN_BATCH}, AdamW lr "
        f"{DIFF_TRAIN_LR}: loss by step {[round(x, 4) for x in losses]}; "
        f"step time median {median:.3f} ms (min {step_ms[0]:.3f}; CUDA "
        f"events over {DIFF_TRAIN_STEPS} steps)")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train {cfg.name}: losses not finite: {losses}")
    return {"batch": DIFF_TRAIN_BATCH, "losses": losses, "step_ms": step_ms,
            "step_median_ms": median}


def training_phase(torch, np, full_cfg):
    """Training on the card, on the unfused route (no kernel has a
    backward; the JAX package's train steps run none): the entry point,
    the timed full-size LM steps with the checkpoint round trip, reduced
    deepseek-v3 against the CPU, the full-width UNet's diffusion_loss
    steps. Every launch counter zeroed just before and read just after:
    no kernel may launch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config(TRAIN_ARCH)
    details = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    details["entry_point"] = train_entry_point(torch)
    details["lm"] = lm_training(torch, np, cfg)
    gc.collect()
    details["remat"] = remat_training(torch, np, cfg)
    details["deepseek"] = deepseek_training(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    details["diffusion"] = diffusion_training(torch, full_cfg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"training launches: {counts} (expected none: the unfused route)")
    if any(counts.values()):
        fail(f"training launched kernels: {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts, details


# ---------------------------------------------------------------------------
# phase 17: the float32 flash routes with a query offset and positions
# ---------------------------------------------------------------------------
def _grid_text(torch, B, Sq):
    """int32 (B, Sq) positions of a grid-then-text prompt chunk: the
    first half image patches at t = 0, then text at 7, 8, ..."""
    r = torch.arange(Sq, device=DEV, dtype=torch.int32)
    pos = torch.where(r < Sq // 2, 0, r - Sq // 2 + 7).to(torch.int32)
    return pos.expand(B, Sq).contiguous()


def check_float32_routes(torch):
    """The tf32x3 and cuda_core routes with a query offset and with query
    positions (F32_CASES) against their plain versions at the float32
    flash tolerance, timed beside SDPA with the explicit mask and their
    bound (tf32x3's operations as 3xTF32 products). Returns the rows."""
    g = torch.Generator(device=DEV).manual_seed(93)
    rows = []
    for way, kind, qs, ks, at in F32_CASES:
        if kind == "offset":
            case = _offset_case(torch, g, qs, ks, at, torch.float32)
            label = f"q_offset {at} kv_len {at + qs[1]}"
        else:
            pos = _grid_text(torch, qs[0], qs[1]).tolist()
            case = _position_case(torch, g, qs, ks, at, pos, torch.float32)
            label = f"kv_len {at} grid-then-text positions"
        kernel, plain, library, nbytes, flops = case
        from repro_torch.kernels import ops
        ops.reset_launch_counts()
        got = kernel()
        torch.cuda.synchronize()
        routes = ops.route_counts()
        if routes[way] != 1:
            fail(f"float32 {kind} q {qs}: took {routes}, not {way}")
        err, tol = _hold(torch, "flash_attention", got, plain(), "float32")
        b_ms, b_by = bound_ms(nbytes, (TF32_PRODUCTS if way == "tf32x3"
                                       else 1) * flops,
                              "tf32" if way == "tf32x3" else "float32")
        row = {"route": way, "kind": kind, "q": qs, "k": ks, "at": at,
               "dtype": "float32", "max_abs_err": err,
               "ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain),
               "library_ms": cuda_ms(torch, library), "bound_ms": b_ms,
               "bound_by": b_by}
        rows.append(row)
        _report("flash_attention", row, f"{way} {kind} route q {qs} k/v {ks} "
                f"{label} float32 (tol {tol})")
    return rows


def _f32_lm(torch, head_dim):
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(reduced_config(LM_ARCH), num_heads=8,
                              num_kv_heads=2, d_model=256, head_dim=head_dim,
                              d_ff=512)
    return cfg, init_params(cfg, seed=97, device=DEV)


def float32_chunks(torch, cfg, params):
    """A float32 LM prompt of 4 x F32_PATH_CHUNK tokens prefilled in
    chunks: at 0, at an int cache_index (the offset), at a 0-d device
    cache_index (positions min(slot, last slot), nothing read on the
    host) and with explicit positions (a grid at t = 0, then text).
    Returns the chunks' last-position logits."""
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.transformer import forward
    C, B = F32_PATH_CHUNK, F32_PATH_B
    g = torch.Generator(device=DEV).manual_seed(98)
    toks = torch.randint(0, cfg.vocab_size, (B, 4 * C), generator=g,
                         device=DEV)
    pos = (_grid_text(torch, B, C) + 3 * C).long()
    cache = init_cache(cfg, B, 4 * C, DEV)
    out = []
    with torch.no_grad():
        for i, (index, p) in enumerate((
                (0, None), (C, None),
                (torch.tensor(2 * C, device=DEV), None), (3 * C, pos))):
            lg, cache, _ = forward(params, cfg, toks[:, i * C:(i + 1) * C],
                                   positions=p, cache=cache,
                                   cache_index=index, mode="prefill")
            out.append(lg[:, -1].float())
    return torch.stack(out)


def float32_routes_phase(torch):
    """The float32 flash routes' query offset and positions: the kernels
    against their plain versions at F32_CASES, then a float32 LM at head
    dims 128 (tf32x3) and 32 (cuda_core) prefilled in chunks
    (``float32_chunks``) with every launch counter zeroed just before and
    read just after: the logits against the plain versions (relative
    LM_FP32_REL), each chunk's flash launch on the route, offset and
    position launches as expected. Returns the routes' kernel-line
    entries, the launches and the details."""
    from repro_torch.kernels import ops
    rows = check_float32_routes(torch)
    counts, details = None, {"rows": rows}
    for head_dim, way in ((128, "tf32x3"), (32, "cuda_core")):
        cfg, params = _f32_lm(torch, head_dim)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = float32_chunks(torch, cfg, params)
        torch.cuda.synchronize()
        c = ops.launch_counts()
        off, at_pos = ops.offset_launches(way), ops.position_launches(way)
        routes = ops.route_counts()
        with plain_ops():
            want = float32_chunks(torch, cfg, params)
        err = rel_diff(got, want)
        L = cfg.num_layers
        log(f"float32 chunks head dim {head_dim}: 4 chunks of "
            f"{F32_PATH_CHUNK} (index 0, int, 0-d tensor, positions) "
            f"vs plain max|diff|/max|logit| {err:.3e} (tolerance "
            f"{LM_FP32_REL}); flash by route {routes}, offset {off} "
            f"(expected {L}), positions {at_pos} (expected {2 * L})")
        if routes[way] != 4 * L or off != L or at_pos != 2 * L \
                or not torch.isfinite(got).all() or err > LM_FP32_REL:
            fail(f"float32 chunks head dim {head_dim}: routes {routes}, "
                 f"offset {off}, positions {at_pos}, rel diff {err:.3e}")
        details[way] = {"rel_diff": err, "offset_launches": off,
                        "position_launches": at_pos, "flash_routes": routes}
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
        del params
    entries = {}
    for way in ("tf32x3", "cuda_core"):
        for kind in ("offset", "positions"):
            sel = [r for r in rows if r["route"] == way and r["kind"] == kind]
            src = "flash_attention_tf32.cu" if way == "tf32x3" \
                else "flash_attention.cu"
            entries[f"{way}_{kind}"] = {
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "max_abs_err": max(r["max_abs_err"] for r in sel),
                **{key: sum(r[key] for r in sel)
                   for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
                "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                           for r in sel) else "operations",
                "launches": details[way]["offset_launches" if kind == "offset"
                                         else "position_launches"],
                "per": f"{len(sel)} float32 call(s) at "
                       f"{[(r['q'], r['k'], r['at']) for r in sel]}"}
    return entries, counts, details


# ---------------------------------------------------------------------------
# phase 18: the distribution layer on a one-rank NCCL group
# ---------------------------------------------------------------------------
def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _paired_medians(torch, plain, built, reps=DIST_REPS):
    """Median host walls (ms) of two step calls taken in turns."""
    a, b = [], []
    for _ in range(reps):
        a.append(_wall_ms(torch, plain)[0])
        b.append(_wall_ms(torch, built)[0])
    return sorted(a)[reps // 2], sorted(b)[reps // 2]


def dist_train(torch, np, mesh):
    """``build_train_step`` for smollm-135m at full size on one 8 x 512
    batch against the unsharded ``make_train_step`` step, deterministic
    algorithms on: metrics and new trees bit for bit; the host walls of
    both, median of DIST_REPS in turns."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.sharding import distribute, full
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(opt=OptimizerConfig(peak_lr=TRAIN_LR, warmup_steps=1,
                                           total_steps=10))
    params = init_params(cfg, seed=TRAIN_SEED, device=DEV)
    opt_init, step = make_train_step(cfg, tcfg)
    opt = opt_init(params)
    batch = launch_train.make_batch(cfg, np.random.default_rng(TRAIN_SEED),
                                    TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED, 0,
                                    DEV)
    built, (ps, os_, _), specs = steps.build_train_step(cfg, mesh, tcfg)
    dp = distribute(params, steps.named_safe(mesh, specs["params"], ps))
    do = distribute(opt, steps.named_safe(mesh, specs["opt"], os_))
    db = distribute(batch, steps.named_safe(mesh, specs["batch"], batch))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = step(params, opt, batch)
        got = built(dp, do, db)
        plain_ms, built_ms = _paired_medians(
            torch, lambda: step(params, opt, batch),
            lambda: built(dp, do, db))
    finally:
        torch.use_deterministic_algorithms(False)
    g_p, g_o, g_m = full(got[0]), full(got[1]), full(got[2])
    metrics_equal = all(torch.equal(g_m[k], want[2][k]) for k in want[2])
    trees_equal = _bitwise_equal(torch, (g_p, g_o), want[:2])
    log(f"distribution train {cfg.name} at full size, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} on the (1, 1) mesh: metrics equal the unsharded "
        f"step's bit for bit {metrics_equal}, new trees {trees_equal} "
        f"(loss {g_m['loss'].item():.6f}); host wall median of {DIST_REPS} "
        f"in turns: unsharded {plain_ms:.3f} ms, built {built_ms:.3f} ms "
        f"(+{built_ms - plain_ms:.3f} ms)")
    if not (metrics_equal and trees_equal):
        fail("distribution train: the built step differs from the "
             "unsharded one")
    del want, got, g_p, g_o, g_m
    from repro_torch.launch.dryrun import laid_out
    meta_b = _on_meta(torch, batch)
    memory = step_memory(
        torch, f"distribution train {cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} "
        "on the (1, 1) mesh", built, (dp, do, db),
        [laid_out(t, steps.named_safe(mesh, specs[n], t)) for t, n in
         ((ps, "params"), (os_, "opt"), (meta_b, "batch"))])
    return {"metrics_equal": metrics_equal, "trees_equal": trees_equal,
            "plain_ms": plain_ms, "built_ms": built_ms,
            "added_ms": built_ms - plain_ms, "memory": memory}


def dist_serve(torch, mesh):
    """``build_serve_step`` for Yi-9B at full width (DIST_LM_LAYERS of its
    layers) against ``serve_prefill`` / ``serve_decode``: a 4 x 512
    prefill then DIST_DECODES decode steps, logits bit for bit, the
    launches of each step equal (every counter zeroed just before the
    built steps and read just after: the phase's path launches), flash on
    wgmma; the host walls of a prefill and of a decode step, median of
    DIST_REPS in turns."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.sharding import distribute, full
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=DIST_LM_LAYERS)
    params = init_params(cfg, seed=99, device=DEV)
    B, S = LM_BATCH, LM_PROMPT
    pre = ShapeConfig("dist_prefill", "prefill", S + DIST_DECODES, B)
    T = steps.cache_len(pre)
    dec = ShapeConfig("dist_decode", "decode", T - 1, B)
    pstep, pargs, specs = steps.build_serve_step(cfg, mesh, pre)
    dstep, _, _ = steps.build_serve_step(cfg, mesh, dec)
    g = torch.Generator(device=DEV).manual_seed(99)
    toks = torch.randint(0, cfg.vocab_size, (B, S + DIST_DECODES),
                         generator=g, device=DEV, dtype=torch.int32)

    def plain_run():
        cache = init_cache(cfg, B, T, DEV)
        per, out = [], []
        for i in range(DIST_DECODES + 1):
            ops.reset_launch_counts()
            if i == 0:
                lg, cache = steps.serve_prefill(params, cfg, cache,
                                                toks[:, :S])
            else:
                lg, cache = steps.serve_decode(
                    params, cfg, cache, toks[:, S + i - 1:S + i], S + i - 1)
            torch.cuda.synchronize()
            per.append(ops.launch_counts())
            out.append(lg)
        return out, per, cache

    dp = distribute(params, steps.named_safe(mesh, specs["params"],
                                             pargs[0]))
    c_sh = steps.named_safe(mesh, specs["cache"], pargs[1])
    b_sh = steps.named_safe(mesh, specs["batch"], {"inputs": toks[:, :S]})

    def batch(i):
        return distribute({"inputs": toks[:, :S] if i == 0
                           else toks[:, S + i - 1:S + i]}, b_sh)

    def built_run():
        cache = distribute(init_cache(cfg, B, T, DEV), c_sh)
        per, out = [], []
        total = None
        for i in range(DIST_DECODES + 1):
            before = ops.launch_counts()
            if i == 0:
                lg, cache = pstep(dp, cache, batch(0))
            else:
                lg, cache = dstep(dp, cache, batch(i), S + i - 1)
            torch.cuda.synchronize()
            now = ops.launch_counts()
            per.append({k: now[k] - before[k] for k in now})
            total = now
            out.append(lg)
        return out, per, cache, total

    want, want_per, want_cache = plain_run()
    routes_before = ops.route_counts()
    ops.reset_launch_counts()
    got, got_per, got_cache, counts = built_run()
    routes = ops.route_counts()
    same = [torch.equal(full(a), b) for a, b in zip(got, want)]
    cache_same = _bitwise_equal(torch, full(got_cache), want_cache)
    c0, c1 = init_cache(cfg, B, T, DEV), distribute(init_cache(cfg, B, T,
                                                               DEV), c_sh)
    pre_ms = _paired_medians(
        torch, lambda: steps.serve_prefill(params, cfg, c0, toks[:, :S]),
        lambda: pstep(dp, c1, batch(0)))
    dec_ms = _paired_medians(
        torch, lambda: steps.serve_decode(params, cfg, c0, toks[:, S:S + 1],
                                          S),
        lambda: dstep(dp, c1, batch(1), S))
    del routes_before
    log(f"distribution serve {cfg.name} at full width ({DIST_LM_LAYERS} "
        f"layers, bf16) on the (1, 1) mesh: prefill {B} x {S} and "
        f"{DIST_DECODES} decode steps; logits equal bit for bit {same}, "
        f"cache {cache_same}; launches per step equal {got_per == want_per} "
        f"(prefill {got_per[0]}, decode {got_per[1]}); flash by route "
        f"{routes}; host wall median of {DIST_REPS} in turns: prefill "
        f"{pre_ms[0]:.3f} -> {pre_ms[1]:.3f} ms, decode {dec_ms[0]:.3f} -> "
        f"{dec_ms[1]:.3f} ms")
    if not all(same) or not cache_same or got_per != want_per \
            or routes["wgmma"] != cfg.num_layers or any(
                counts[k] == 0 for k in ("flash_attention",
                                         "decode_attention", "fused_rmsnorm",
                                         "swiglu")):
        fail("distribution serve: the built steps differ from the "
             "unsharded ones")
    return counts, {"logits_equal": same, "cache_equal": cache_same,
                    "launches_per_step": got_per, "flash_routes": routes,
                    "prefill_ms": pre_ms, "decode_ms": dec_ms}


def dist_collectives(torch, mesh):
    """``allgather_matmul``, ``reduce_scatter_grads`` and ``run_pipeline``
    on the one-rank ring against dense torch at smollm's MLP shapes."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.collectives import (allgather_matmul,
                                                  reduce_scatter_grads)
    from repro_torch.parallel.pipeline import run_pipeline
    g = torch.Generator(device=DEV).manual_seed(100)
    x = torch.randn(TRAIN_BATCH * TRAIN_SEQ, 576, generator=g, device=DEV)
    w = torch.randn(576, 1536, generator=g, device=DEV) / 24
    agmm = allgather_matmul(x, w, mesh=mesh, axis="model")
    e1 = (agmm - x @ w).abs().max().item()
    rs = reduce_scatter_grads({"w": w}, mesh=mesh, axis="data")
    e2 = (rs["w"] - w).abs().max().item()
    stage = init_device_mesh(DEV, (1,), mesh_dim_names=("stage",))
    W = torch.randn(1, 576, 576, generator=g, device=DEV) / 24
    xs = torch.randn(4, 8, 576, generator=g, device=DEV)
    pipe = run_pipeline(lambda p, v: torch.tanh(v @ p), W, xs, mesh=stage)
    e3 = (pipe - torch.tanh(xs @ W[0])).abs().max().item()
    ms = {"allgather_matmul": cuda_ms(torch, lambda: allgather_matmul(
              x, w, mesh=mesh, axis="model")),
          "dense_matmul": cuda_ms(torch, lambda: x @ w)}
    log(f"distribution collectives on the one-rank ring: allgather_matmul "
        f"vs x @ w max|diff| {e1:.3e} ({ms['allgather_matmul']:.4f} ms vs "
        f"{ms['dense_matmul']:.4f} ms), reduce_scatter_grads vs g "
        f"{e2:.3e}, run_pipeline (1 stage, 4 microbatches) vs dense "
        f"{e3:.3e}")
    if max(e1, e2, e3) > 1e-5:
        fail("distribution collectives differ from dense")
    return {"allgather_matmul_err": e1, "reduce_scatter_err": e2,
            "pipeline_err": e3, **ms}


def distribution_phase(torch, np):
    """The distribution layer on a one-rank NCCL group (the card has one
    GPU; NCCL refuses two ranks on one) over the (1, 1) ("data",
    "model") worker mesh: the built train step (``dist_train``), the
    built serve steps (``dist_serve``, whose launches are the phase's
    path launches) and the collectives (``dist_collectives``). Returns
    the launches and the details."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_worker_mesh
    t0 = time.perf_counter()
    # gloo only where the phase is rehearsed on the CPU (DEV = "cpu")
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_worker_mesh(1, device_type=DEV)
        details = {"mesh": [list(mesh.mesh_dim_names),
                            list(mesh.mesh.shape)]}
        details["train"] = dist_train(torch, np, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        counts, details["serve"] = dist_serve(torch, mesh)
        details["collectives"] = dist_collectives(torch, mesh)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    details["wall_s"] = time.perf_counter() - t0
    log(f"distribution phase wall {details['wall_s']:.1f} s")
    return counts, details


# ---------------------------------------------------------------------------
# phase 19: the analysis (work counted on the card and on meta, the
# roofline at H100 peaks) and the dry run
# ---------------------------------------------------------------------------
def _counted(torch, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` once under ``analysis.count.Count``, then
    synchronised: the count's result."""
    from repro_torch.analysis.count import count_call
    _, got = count_call(fn, *args, **kwargs)
    if DEV == "cuda":
        torch.cuda.synchronize()
    return got


def _on_meta(torch, tree):
    from repro_torch.tree import map_tree
    return map_tree(lambda t: torch.empty_like(t, device="meta"), tree)


def analysis_paths(torch, np):
    """Each path's count on the card and on ``meta``: Yi-9B (full width
    and depth, bf16) prefill of LM_BATCH x LM_PROMPT and one decode step
    through the kernels, and the TRAIN_ARCH train step at TRAIN_BATCH x
    TRAIN_SEQ on the unfused route, each one untimed call."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import cache_len, serve_decode, serve_prefill
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    out = {}
    cfg = get_config(LM_ARCH)
    T = cache_len(ShapeConfig("smoke_decode", "decode", LM_PROMPT + LM_STEPS,
                              LM_BATCH))
    g = torch.Generator(device=DEV).manual_seed(70)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=g, device=DEV)
    tok = prompts[:, -1:]
    for dev in (DEV, "meta"):
        params = init_params(cfg, seed=71, device=dev) if dev != "meta" \
            else init_params(cfg, device="meta")
        cache = init_cache(cfg, LM_BATCH, T, dev)
        p_in = prompts if dev != "meta" else _on_meta(torch, prompts)
        t_in = tok if dev != "meta" else _on_meta(torch, tok)
        out[("prefill", dev)] = _counted(torch, serve_prefill, params, cfg,
                                         cache, p_in)
        out[("decode", dev)] = _counted(torch, serve_decode, params, cfg,
                                        cache, t_in, LM_PROMPT)
        del params, cache
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
    train_cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(opt=OptimizerConfig(peak_lr=TRAIN_LR, warmup_steps=1,
                                           total_steps=TRAIN_STEPS + 1))
    opt_init, step = make_train_step(train_cfg, tcfg)
    batch = launch_train.make_batch(train_cfg, np.random.default_rng(72),
                                    TRAIN_BATCH, TRAIN_SEQ, 72, 0, DEV)
    for dev in (DEV, "meta"):
        params = init_params(train_cfg, seed=73, device=dev) \
            if dev != "meta" else init_params(train_cfg, device="meta")
        b = batch if dev != "meta" else _on_meta(torch, batch)
        out[("train", dev)] = _counted(torch, step, params, opt_init(params),
                                       b)
        del params
        gc.collect()
    shapes = {"prefill": ShapeConfig("smoke_prefill", "prefill", LM_PROMPT,
                                     LM_BATCH),
              "decode": ShapeConfig("smoke_decode", "decode", LM_PROMPT,
                                    LM_BATCH),
              "train": ShapeConfig("smoke_train", "train", TRAIN_SEQ,
                                   TRAIN_BATCH)}
    archs = {"prefill": cfg, "decode": cfg, "train": train_cfg}
    return out, shapes, archs


def analysis_dryrun():
    """``python -m repro_torch.launch.dryrun --arch yi-9b --shape
    decode_32k`` in a subprocess, on the 16 x 16 mesh and with
    ``--multi-pod``: each record must have status ok, nonzero dot flops
    and a nonzero all-gather or all-reduce count."""
    import os
    from repro_torch.analysis import roofline
    out_dir = ROOT / "experiments" / "dryrun_torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    recs = {}
    for mesh, extra in (("16x16", []), ("2x16x16", ["--multi-pod"])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            *DRYRUN_ARGV, *extra, "--out-dir", str(out_dir)],
                           capture_output=True, text=True, env=env, cwd=ROOT,
                           timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"dry run on {mesh}: exit {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        rec = json.loads((out_dir / mesh / "yi-9b__decode_32k.json")
                         .read_text())
        coll = rec.get("collectives", {})
        row = roofline.analyze(rec) if rec.get("status") == "ok" else None
        log(f"dry run yi-9b decode_32k on {mesh} ({rec.get('n_devices')} "
            f"fake ranks, subprocess wall {wall:.1f} s, build "
            f"{rec.get('build_s')} s, trace {rec.get('trace_s')} s): status "
            f"{rec['status']}, per device dot_flops "
            f"{rec.get('dot_flops', 0):.6e}, traffic "
            f"{rec.get('traffic_bytes', 0):.6e} B, arguments "
            f"{rec.get('argument_size_in_bytes', 0) / 2**30:.3f} GiB, "
            f"collectives {coll}"
            + (f"; roofline at H100 peaks: compute {row['compute_s']:.6f} s, "
               f"memory {row['memory_s']:.6f} s, collective "
               f"{row['collective_s']:.6f} s ({row['dominant']}), "
               f"roofline fraction {row['roofline_frac']:.4e}"
               if row else ""))
        n = sum(coll.get(k, {}).get("count", 0)
                for k in ("all-gather", "all-reduce"))
        if rec["status"] != "ok" or not rec.get("dot_flops") or not n:
            fail(f"dry run on {mesh}: {rec.get('status')} "
                 f"{rec.get('error', '')}")
        recs[mesh] = {k: rec.get(k) for k in (
            "status", "n_devices", "build_s", "trace_s", "dot_flops",
            "traffic_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "collectives")}
        recs[mesh]["wall_s"] = wall
        recs[mesh]["roofline"] = row
    return recs


def start_dryrun_cells():
    """Each ``DRYRUN_CELLS`` cell's ``python -m repro_torch.launch.dryrun``
    started in its own process: [(cell, process, record path, start)]."""
    import os
    out_dir = ROOT / "experiments" / "dryrun_torch" / "cells"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    started = []
    for arch, shape, multi_pod, overrides in DRYRUN_CELLS:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--out-dir", str(out_dir)]
        argv += ["--multi-pod"] if multi_pod else []
        for ov in overrides:
            argv += ["--override", ov]
        mesh = "2x16x16" if multi_pod else "16x16"
        started.append(((arch, shape, mesh, overrides),
                        subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                                         stderr=subprocess.PIPE, text=True,
                                         env=env, cwd=ROOT),
                        out_dir / mesh / f"{arch}__{shape}.json",
                        time.perf_counter()))
    return started


def finish_dryrun_cells(started):
    """Wait for ``start_dryrun_cells``' processes (each within
    DRYRUN_CELL_TIMEOUT of its start) and log each record: status,
    build and trace seconds, per-device dot flops, collectives. Fails
    unless every record says ok with nonzero dot flops and a collective.
    Returns the records' fields by cell."""
    import torch
    from repro_torch.analysis import roofline
    out = {}
    for (arch, shape, mesh, overrides), proc, path, t0 in started:
        left = DRYRUN_CELL_TIMEOUT - (time.perf_counter() - t0)
        try:
            _, err = proc.communicate(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            fail(f"dry run {arch} {shape} on {mesh}: not done in "
                 f"{DRYRUN_CELL_TIMEOUT} s")
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or not path.exists():
            fail(f"dry run {arch} {shape} on {mesh}: exit {proc.returncode}: "
                 f"{err[-2000:]}")
        rec = json.loads(path.read_text())
        coll = rec.get("collectives", {})
        n_coll = sum(c.get("count", 0) for c in coll.values())
        row = roofline.analyze(rec) if rec.get("status") == "ok" else None
        log(f"dry run cell {arch} {shape} on {mesh} ({' '.join(overrides)}; "
            f"torch {torch.__version__}): status {rec['status']}, build "
            f"{rec.get('build_s')} s, trace {rec.get('trace_s')} s, read "
            f"{wall:.1f} s after its start, per device dot_flops "
            f"{rec.get('dot_flops', 0):.6e}, collectives "
            f"{ {k: int(v['count']) for k, v in coll.items()} }, temp "
            f"{rec.get('temp_size_in_bytes')} bytes, largest allocation "
            f"{rec.get('largest_allocation')}"
            + (f", dominant {row['dominant']}" if row else "")
            + ("" if rec["status"] == "ok"
               else f": {rec.get('error', '')[:1500]}"))
        if rec["status"] != "ok" or not rec.get("dot_flops") or not n_coll:
            fail(f"dry run {arch} {shape} on {mesh}: {rec.get('status')} "
                 f"{rec.get('error', '')[:1500]}")
        out[f"{arch} {shape} {mesh}"] = {
            "overrides": list(overrides), "read_after_s": wall,
            "dominant": row["dominant"], **{k: rec.get(k) for k in (
                "status", "build_s", "trace_s", "dot_flops",
                "traffic_bytes", "collectives", "temp_size_in_bytes",
                "largest_allocation")}}
    return out


def analysis_phase(torch, np, details):
    """Phase 19: (a) each path's work counted under ``analysis.count`` on
    the card (one untimed call, the LM steps through the kernels, every
    launch counter zeroed just before and read just after) and on
    ``meta``: the card's dot flops must equal meta's (within
    ANALYSIS_REL); (b) each path's measured time (from the phase that
    timed it) against its roofline terms at H100 peaks, ``model_flops``
    and the roofline fraction; (c) the dry-run CLI on both production
    meshes (``analysis_dryrun``); (d) the sharded train and prefill
    cells at full widths and cut depth (``DRYRUN_CELLS``), started as
    the phase begins and read at its end (``finish_dryrun_cells``).
    Returns the launches and the details."""
    # the repaired cells run on the host's other cores meanwhile: this
    # phase times nothing
    started = start_dryrun_cells()
    try:
        return _analysis_phase(torch, np, details, started)
    finally:
        for _, proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _analysis_phase(torch, np, details, started):
    from repro_torch.analysis import roofline
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    card = details["build"]["card"]
    if DEV == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    counted, shapes, archs = analysis_paths(torch, np)
    counts = ops.launch_counts()
    measured = {
        "prefill": (details["lm"]["slice"]["prefill_ms"],
                    "one host-timed call, lm phase"),
        "decode": (details["lm"]["slice"]["decode_step_median_ms"],
                   f"median of {LM_STEPS} steps, CUDA events, lm phase"),
        "train": (details["training"]["lm"]["step_median_ms"],
                  f"median of {TRAIN_STEPS} steps, CUDA events, training "
                  "phase")}
    info = {"card": card, "paths": {}}
    bad = []
    for path in ("prefill", "decode", "train"):
        card_c, meta_c = counted[(path, DEV)], counted[(path, "meta")]
        fl, fl_meta = card_c["dot_flops"], meta_c["dot_flops"]
        rel = abs(fl - fl_meta) / max(fl_meta, 1.0)
        t = roofline.terms(fl, card_c["traffic_bytes"])
        mf = roofline.model_flops(archs[path], shapes[path])
        ms, how = measured[path]
        frac = (mf / roofline.PEAK_FLOPS * 1e3) / ms
        log(f"analysis {path} ({archs[path].name}, {shapes[path].kind} "
            f"B {shapes[path].global_batch} S {shapes[path].seq_len}) on "
            f"{card}: dot_flops card {fl:.6e} vs meta {fl_meta:.6e} "
            f"(relative {rel:.3e}); traffic card "
            f"{card_c['traffic_bytes']:.6e} vs meta "
            f"{meta_c['traffic_bytes']:.6e} B; at H100 peaks compute "
            f"{t['compute_s'] * 1e3:.4f} ms, memory "
            f"{t['memory_s'] * 1e3:.4f} ms ({t['dominant']}); model_flops "
            f"{mf:.6e}, model/dot {mf / fl:.4f}; measured {ms:.3f} ms "
            f"({how}); roofline fraction {frac:.4e}")
        if rel > ANALYSIS_REL or fl <= 0:
            bad.append(path)
        info["paths"][path] = {
            "dot_flops": fl, "dot_flops_meta": fl_meta,
            "traffic_bytes": card_c["traffic_bytes"],
            "traffic_bytes_meta": meta_c["traffic_bytes"], **t,
            "model_flops": mf, "measured_ms": ms, "measured_by": how,
            "roofline_frac": frac}
    log(f"analysis launches: {counts} (the Yi-9B prefill and decode step "
        "through the kernels; the train step launches none)")
    if bad:
        fail(f"analysis: the card's dot flops differ from meta's: {bad}")
    if any(counts[k] == 0 for k in ("flash_attention", "decode_attention",
                                    "fused_rmsnorm", "swiglu")):
        fail(f"analysis: an LM kernel did not launch: {counts}")
    info["dryrun"] = analysis_dryrun()
    info["dryrun_cells"] = finish_dryrun_cells(started)
    info["wall_s"] = time.perf_counter() - t0
    log(f"analysis phase wall {info['wall_s']:.1f} s")
    return counts, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write per-shape details as JSON here")
    args = ap.parse_args(argv)
    # cuBLAS's workspace as PyTorch's deterministic mode asks for it (the
    # training phase's checkpoint round trip turns that mode on)
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    card = details["build"]["card"]
    trained, heldout_fake, offline_counts, details["offline"] = \
        offline_phase(torch, np, casc, card)
    # the live loop serves with the trained discriminator, its f(t) from
    # the held-out tier-0 scores
    from repro_torch.core.confidence import DeferralProfile
    casc.disc_params = trained
    deferral = (DeferralProfile(heldout_fake.tolist()),)
    live_counts, details["live"] = live_loop(torch, np, casc, rt, profiles,
                                             deferral)
    details["controllers"] = controllers_phase(
        np, measured_serving(rt, profiles), deferral, card)
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
    family_entries, family_counts, details["lm_family"] = lm_family_phase(
        torch, np)
    train_counts, details["training"] = training_phase(torch, np, full_cfg)
    f32_entries, f32_counts, details["float32_routes"] = \
        float32_routes_phase(torch)
    dist_counts, details["distribution"] = distribution_phase(torch, np)
    analysis_counts, details["analysis"] = analysis_phase(torch, np, details)
    # flash attention's three routes: the diffusion path's float32 calls
    # on tf32x3, the LM paths' bf16 calls on wgmma; cuda_core (no path's
    # head dim) timed at the UNet's inputs as the float32 route's earlier
    # kernel
    routes = {"diffusion": details["slice"]["flash_routes"],
              "live": details["live"]["flash_routes"],
              "lm": details["lm"]["slice"]["flash_routes"],
              **{a: details[a]["slice"]["flash_routes"] for a in REC_ARCHS},
              "qwen": details["lm_family"][QWEN_ARCH]["slice"]["flash_routes"],
              **{key: details["lm_family"][QWEN_ARCH][key]["flash_routes"]
                 for key in ("chunked", "chunked_slots")},
              "cascade": details["lm_family"]["lm_cascade"]["flash_routes"],
              **{f"float32_{way}": details["float32_routes"][way][
                  "flash_routes"] for way in ("tf32x3", "cuda_core")},
              "distribution": details["distribution"]["serve"][
                  "flash_routes"]}
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
    # the wgmma route with a query offset and with query positions (their
    # launches are also among wgmma's)
    fa_entry["routes"].update(family_entries)
    # the float32 routes with a query offset and with query positions
    fa_entry["routes"].update(f32_entries)
    for e in rec_entries:      # the recurrences' launches by route
        for way, r in e["routes"].items():
            r["launches"] = sum(
                details[a]["slice"]["rec_routes"].get(e["name"], {}).get(
                    way, 0) for a in REC_ARCHS)
    kernels = []
    for e in (fa_entry, gn_entry, *lm_entries.values(), *rec_entries):
        by_path = {"diffusion": counts[e["name"]],
                   "offline": offline_counts[e["name"]],
                   "live": live_counts[e["name"]],
                   "lm": lm_counts[e["name"]],
                   "xlstm": rec_counts[REC_ARCHS[0]][e["name"]],
                   "jamba": rec_counts[REC_ARCHS[1]][e["name"]],
                   "lm_family": family_counts[e["name"]],
                   "train": train_counts[e["name"]],
                   "float32_chunks": f32_counts[e["name"]],
                   "distribution": dist_counts[e["name"]],
                   "analysis": analysis_counts[e["name"]]}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        kernels.append({k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "was_ms",
            "per", "launches_by_path", "routes", "lse") if k in e})
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
