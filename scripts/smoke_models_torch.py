"""Smoke run of every architecture on the PyTorch port: at
``reduced_config`` size, a train forward, a prefill into a cache and a
one-token decode with no NaN (and, for deepseek-v3, the multi-token
prediction head); then ``count_params`` of the full-size config, all and
active. The port's counterpart of ``scripts/smoke_models.py``; runs on
CUDA unless ``--device cpu``.

  PYTHONPATH=src python scripts/smoke_models_torch.py
  PYTHONPATH=src python scripts/smoke_models_torch.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import (count_params, forward,
                                            init_params, mtp_logits)


def smoke(arch: str, dev: torch.device, B: int = 2, S: int = 16) -> dict:
    """One arch at reduced size on ``dev``; raises on a NaN or a wrong
    shape. Returns the full config's parameter counts."""
    cfg = reduced_config(arch)
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if cfg.input_mode == "tokens":
        inputs = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=dev)
    else:
        inputs = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        logits, _, aux, hidden = forward(params, cfg, inputs, mode="train",
                                         return_hidden=True)
        if logits.shape != (B, S, cfg.vocab_size):
            raise AssertionError(f"{arch}: train logits {logits.shape}")
        if torch.isnan(logits).any() or torch.isnan(aux):
            raise AssertionError(f"{arch}: NaN train logits")
        if cfg.mtp_depth:
            lg, _ = mtp_logits(params, cfg, hidden, inputs)
            if torch.isnan(lg).any():
                raise AssertionError(f"{arch}: NaN MTP logits")
        cache = init_cache(cfg, B, S + 4, dev)
        logits_p, cache, _ = forward(params, cfg, inputs, cache=cache,
                                     cache_index=0, mode="prefill")
        if torch.isnan(logits_p).any():
            raise AssertionError(f"{arch}: NaN prefill")
        logits_d, cache, _ = forward(params, cfg, inputs[:, -1:],
                                     cache=cache, cache_index=S,
                                     mode="decode")
        if logits_d.shape != (B, 1, cfg.vocab_size):
            raise AssertionError(f"{arch}: decode logits {logits_d.shape}")
        if torch.isnan(logits_d).any():
            raise AssertionError(f"{arch}: NaN decode")
    full = get_config(arch)
    return {"params": count_params(full),
            "active": count_params(full, active_only=True)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        out[arch] = smoke(arch, dev)
        print(f"{arch:26s} ok ({time.perf_counter() - t0:5.1f}s)  "
              f"full params={out[arch]['params'] / 1e9:8.3f}B "
              f"active={out[arch]['active'] / 1e9:8.3f}B")
    print("ALL OK")
    return out


if __name__ == "__main__":
    main()
