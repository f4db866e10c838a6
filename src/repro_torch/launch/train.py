"""LM training entry point (port of ``repro/launch/train.py``): a synthetic
Zipf token stream, AdamW, checkpoints and resume, on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --batch 8 --seq 128 --ckpt /tmp/ck

The train step is ``training/train_loop.make_train_step`` (the
``"unfused"`` route: plain PyTorch that autograd differentiates). The
parameters come from the port's seeded ``init_params``, so they are not
the JAX package's numbers for the same seed; the token stream is
(``training/data.zipf_tokens`` from ``default_rng(seed + start)``).
Checkpoints are in the JAX package's format and layout
(``training/checkpoint.py``), so either package's entry point resumes
the other's checkpoints.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.training import checkpoint
from repro_torch.training.data import zipf_tokens
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import TrainConfig, make_train_step


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s embedding inputs: seeded from
    (seed, step) alone, so a resumed run draws what an unbroken one
    does (the JAX package's ``fold_in(key, step)``)."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)


def make_batch(cfg, rng: np.random.Generator, batch: int, seq: int,
               seed: int, step: int, device):
    """One step's batch: Zipf tokens and labels from ``rng``; for an
    embedding-input model standard-normal inputs instead; M-RoPE
    positions ``arange(seq)`` on every axis."""
    inp, lab = zipf_tokens(rng, batch, seq, cfg.vocab_size)
    out = {"inputs": torch.as_tensor(inp, device=device),
           "labels": torch.as_tensor(lab, device=device)}
    if cfg.input_mode == "embeddings":
        out["inputs"] = torch.randn(
            (batch, seq, cfg.d_model),
            generator=step_generator(seed, step, device), device=device)
    if cfg.rope == "mrope":
        out["positions"] = torch.arange(
            seq, dtype=torch.int32, device=device)[None, None].expand(
            cfg.num_position_dims, batch, seq)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--full-scale", action="store_true",
                    help="use the full config (default reduced)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_scale \
        else reduced_config(args.arch)
    params = init_params(cfg, seed=args.seed, device=dev)
    tcfg = TrainConfig(opt=OptimizerConfig(
        peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps))
    opt_init, step = make_train_step(cfg, tcfg)
    opt_state = opt_init(params)
    start = 0
    if args.ckpt and os.path.isdir(args.ckpt) \
            and checkpoint.latest_step(args.ckpt) is not None:
        (params, opt_state), start, _ = checkpoint.load(
            args.ckpt, (params, opt_state), device=dev, cfg=cfg)
        print(f"resumed from step {start}")

    rng = np.random.default_rng(args.seed + start)
    t0 = time.time()
    for i in range(start, args.steps):
        batch = make_batch(cfg, rng, args.batch, args.seq, args.seed, i, dev)
        params, opt_state, m = step(params, opt_state, batch)
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i+1:4d} loss {float(m['loss']):.4f} "
                  f"ce {float(m['ce']):.4f} "
                  f"({(time.time()-t0)/(i-start+1):.2f}s/step)", flush=True)
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt, (params, opt_state), i + 1, cfg=cfg)
    if args.ckpt:
        checkpoint.save(args.ckpt, (params, opt_state), args.steps, cfg=cfg)
    print("done")
    return params, opt_state


if __name__ == "__main__":
    main()
