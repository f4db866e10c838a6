#!/usr/bin/env python3
"""Prefill and decode-step times of one LM of the PyTorch port on a CUDA
card, with seeded random bf16 weights: one prefill of B prompts of S
tokens (embeddings for an embedding-input model, M-RoPE positions t = 0
and (h, w) over a patch grid), then greedy decode steps, each between
CUDA events. Prints one JSON line: the card, its power limit, the
prefill's host wall and the decode steps' median.

    PYTHONPATH=src python scripts/lm_step_times_torch.py --arch qwen2-vl-7b

It uses only ``init_params``, ``init_cache``, ``serve_prefill`` and
``serve_decode``, so the same script times any checkout of the port: put
that checkout's ``src`` first on PYTHONPATH, and run two checkouts in
turns in one session to compare them on one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-vl-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--grid-cols", type=int, default=32,
                    help="M-RoPE patch-grid width (rows = prompt / cols)")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=70)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import serve_decode, serve_prefill
    from repro_torch.models.kvcache import init_cache
    from repro_torch.models.transformer import init_params
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = "cuda"
    cfg = get_config(args.arch)
    params = init_params(cfg, seed=args.seed, device=dev)
    B, S = args.batch, args.prompt
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    pos = step_pos = None
    if cfg.input_mode == "embeddings":
        prompts = torch.randn((B, S, cfg.d_model), generator=g,
                              device=dev).to(torch.bfloat16)
    else:
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                device=dev)
    if cfg.rope == "mrope":
        r = torch.arange(S, device=dev)
        cols = args.grid_cols
        pos = torch.stack([torch.zeros_like(r), r // cols, r % cols])
        pos = pos[:, None, :].expand(3, B, S).contiguous()
        start = max(-(-S // cols), cols)
        step_pos = [torch.full((3, B, 1), start + i, device=dev)
                    for i in range(args.steps)]
    cache = init_cache(cfg, B, S + args.steps, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = serve_prefill(params, cfg, cache, prompts, pos)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(args.steps)]
    tok = logits.argmax(-1, keepdim=True)
    with torch.no_grad():
        for i, (e0, e1) in enumerate(events):
            inp = prompts[:, -1:] if cfg.input_mode == "embeddings" else tok
            e0.record()
            logits, cache = serve_decode(params, cfg, cache, inp, S + i,
                                         None if step_pos is None
                                         else step_pos[i])
            e1.record()
            tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    ms = sorted(e0.elapsed_time(e1) for e0, e1 in events)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"arch": args.arch, "card": card, "batch": B,
                      "prompt": S, "steps": args.steps,
                      "prefill_ms": prefill_ms,
                      "decode_median_ms": ms[len(ms) // 2],
                      "decode_min_ms": ms[0],
                      "finite": bool(torch.isfinite(logits).all())}),
          flush=True)


if __name__ == "__main__":
    main()
