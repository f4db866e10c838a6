#!/usr/bin/env python3
"""Device times of the port's bf16 flash-attention kernel (the ``wgmma``
route) at the LM paths' shapes, for whichever checkout of the port is
first on PYTHONPATH: Yi-9B's causal prefill (q (4,512,32,128), k/v
(4,512,4,128)) and qwen2-vl's prompt chunks against its cache with a
query offset of 128, 256 and 384 (q (4,128,28,128), k/v (4,512,4,128)),
and, where the checkout's kernel takes query positions, qwen2-vl's
prefill at an image grid's t = 0 (q (4,512,28,128), k/v (4,512,4,128)).
Each time is device time: ``--iters`` launches queued behind a spin
kernel long enough for the host to queue them all, so they run back to
back, between one pair of CUDA events, divided by the count (inputs stay
in L2); the median of ``--reps`` such runs. Prints one JSON line with
the card and its power limit.

    PYTHONPATH=src python scripts/flash_times_torch.py

Run two checkouts in turns in one session to compare them on one card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--spin-ms", type=float, default=40.0,
                    help="the spin that lets the host queue every launch")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.kernels import flash_attention as tflash
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(shape):
        return torch.randn(shape, generator=g,
                           device="cuda").to(torch.bfloat16)
    cases = {"yi_prefill_causal": (rnd((4, 512, 32, 128)),
                                   rnd((4, 512, 4, 128)),
                                   rnd((4, 512, 4, 128)), {})}
    kv = (rnd((4, 512, 4, 128)), rnd((4, 512, 4, 128)))
    for off in (128, 256, 384):
        cases[f"qwen_chunk_offset_{off}"] = (
            rnd((4, 128, 28, 128)), *kv,
            {"kv_len": off + 128, "q_offset": off})
    if "q_positions" in inspect.signature(
            tflash.flash_attention).parameters:
        cases["qwen_prefill_positions_t0"] = (
            rnd((4, 512, 28, 128)), *kv,
            {"q_positions": torch.zeros((4, 512), dtype=torch.int32,
                                        device="cuda")})
    out = {}
    for name, (q, k, v, kw) in cases.items():
        def call():
            return tflash.flash_attention(q, k, v, causal=True, **kw)
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        runs = []
        for _ in range(args.reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(args.spin_ms * 2e6))   # ~2 GHz cycles
            e0.record()
            for _ in range(args.iters):
                call()
            e1.record()
            torch.cuda.synchronize()
            runs.append(e0.elapsed_time(e1) / args.iters)
        out[name] = sorted(runs)[len(runs) // 2]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
