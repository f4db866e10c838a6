"""Adversarial-style discriminator training (paper §3.2 offline phase),
PyTorch.

Port of ``repro/training/discriminator.py``. Binary classification:
ground-truth images = 'real', diffusion outputs = 'fake'; the trained
net's softmax P(real) becomes the cascade confidence. The loss is the
NLL of ``log_softmax`` (plus accuracy), as in the JAX package.

The train step runs the discriminator on the ``"unfused"`` route (the
counterpart of the JAX package's default ``impl="xla"``): no kernel of
either package has a backward, and the kernel wrappers refuse inputs
that need one on CUDA. The trained parameters serve through the fused
route like any others. Training runs on CUDA unless the caller passes
``device="cpu"``; checkpoints go through ``training/checkpoint.py``
(the JAX package's file format) at the JAX package's steps.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.efficientnet import (DiscriminatorConfig,
                                             apply_discriminator,
                                             init_discriminator)
from repro_torch.training import checkpoint
from repro_torch.training.data import DiscriminatorBatcher
from repro_torch.training.optimizer import OptimizerConfig, make_adamw
from repro_torch.tree import leaves, map_tree, unflatten


def disc_loss(params, cfg: DiscriminatorConfig, x, y):
    """(NLL of ``log_softmax``, accuracy) of the discriminator on images
    ``x`` (B,H,W,C) with labels ``y`` (B,) (1 = real, 0 = fake)."""
    logits, _ = apply_discriminator(params, cfg, x, impl="unfused")
    logp = torch.log_softmax(logits, dim=-1)
    y = y.long()
    nll = -logp.gather(-1, y[:, None]).mean()
    acc = (logits.argmax(dim=-1) == y).to(torch.float32).mean()
    return nll, acc


def loss_and_grads(params, cfg: DiscriminatorConfig, x, y):
    """(loss, accuracy, gradient tree shaped like ``params``)."""
    with torch.enable_grad():
        p = map_tree(lambda t: t.detach().requires_grad_(True), params)
        loss, acc = disc_loss(p, cfg, x, y)
        flat = leaves(p)
        # a leaf the forward never reads gets a zero gradient, as in JAX
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), acc, unflatten(params, list(grads))


def make_disc_train_step(cfg: DiscriminatorConfig, opt_cfg: OptimizerConfig):
    opt_init, opt_update = make_adamw(opt_cfg)

    def step(params, opt_state, x, y):
        loss, acc, grads = loss_and_grads(params, cfg, x, y)
        params, opt_state, om = opt_update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "acc": acc, **om}

    return opt_init, step


def train_discriminator(
        init_seed: int = 0, cfg: Optional[DiscriminatorConfig] = None,
        steps: int = 200, batch_size: int = 32, image_size: int = 32,
        fake_fn: Optional[Callable] = None,
        real_fn: Optional[Callable] = None, seed: int = 0,
        lr: float = 1e-3, log_every: int = 50,
        checkpoint_dir: Optional[str] = None, params=None,
        device: DeviceLike = None):
    """Returns (params, cfg, history). ``init_seed`` seeds the
    ``torch.Generator`` of ``init_discriminator`` (the JAX package's
    ``key``), unless ``params`` gives the starting parameters; ``seed``
    seeds the batcher, as there."""
    dev = resolve_device(device)
    cfg = cfg or DiscriminatorConfig()
    if params is None:
        params = init_discriminator(cfg, seed=init_seed, device=dev)
    else:
        params = map_tree(lambda t: t.detach().to(dev, copy=True), params)
    opt_cfg = OptimizerConfig(peak_lr=lr, warmup_steps=20, total_steps=steps,
                              weight_decay=1e-4)
    opt_init, step_fn = make_disc_train_step(cfg, opt_cfg)
    opt_state = opt_init(params)
    batcher = iter(DiscriminatorBatcher(
        rng=np.random.default_rng(seed), size=batch_size,
        image_size=image_size, fake_fn=fake_fn, real_fn=real_fn))
    history = []
    for i in range(steps):
        x, y = next(batcher)
        params, opt_state, m = step_fn(
            params, opt_state, torch.from_numpy(np.ascontiguousarray(
                x, dtype=np.float32)).to(dev),
            torch.from_numpy(y).to(dev))
        if (i + 1) % log_every == 0 or i == steps - 1:
            history.append({"step": i + 1,
                            "loss": float(m["loss"]),
                            "acc": float(m["acc"])})
        if checkpoint_dir and ((i + 1) % 100 == 0 or i == steps - 1):
            checkpoint.save(checkpoint_dir, params, i + 1,
                            extra={"acc": float(m["acc"])})
    return params, cfg, history
