"""Loss and train-step construction, microbatched (port of
``repro/training/train_loop.py``).

The same interface as the JAX package's: ``make_train_step(cfg, tcfg)``
returns ``(init_fn(params) -> opt_state, step_fn(params, opt_state,
batch) -> (params, opt_state, metrics))``. Gradients come from
``torch.autograd`` over the port's ``forward``, on the ``"unfused"``
route (``TRAIN_IMPL``): no kernel of the JAX package has a backward, and
its train steps run none (the LM layers are plain XLA there), so the
port's train step computes what the JAX one computes, through the plain
versions, which autograd differentiates on any device. The steps are
functional, as the optimizer's (``training/optimizer.py``): new
parameter and state trees come back, the given ones are not written.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.transformer import forward, mtp_logits
from repro_torch.parallel.sharding import gather_last
from repro_torch.training.optimizer import OptimizerConfig, make_adamw
from repro_torch.tree import leaves, map_tree, unflatten

TRAIN_IMPL = "unfused"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    microbatches: int = 1
    z_loss: float = 1e-4
    mtp_weight: float = 0.3


def cross_entropy(logits, labels, z_coef: float = 0.0):
    """Mean CE over all tokens (fp32), with optional z-loss."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    # vocab-sharded logits (a step built on a mesh) are gathered along
    # the vocabulary for the label pick
    ll = torch.gather(gather_last(lg), -1, labels[..., None].long())[..., 0]
    loss = torch.mean(lse - ll)
    if z_coef:
        loss = loss + z_coef * torch.mean(torch.square(lse))
    return loss


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """``loss_fn(params, batch) -> (total, metrics)``: the CE (with
    z-loss) of ``forward`` in ``train`` mode, plus ``mtp_weight`` times
    the multi-token prediction CE where the model has the head, plus the
    MoE aux losses; metrics ``ce``, ``aux`` (the trunk's), ``mtp_ce``
    (with the head) and ``loss``."""
    def loss_fn(params, batch):
        want_mtp = bool(cfg.mtp_depth) and cfg.input_mode == "tokens"
        out = forward(params, cfg, batch["inputs"],
                      positions=batch.get("positions"), mode="train",
                      return_hidden=want_mtp, impl=TRAIN_IMPL)
        if want_mtp:
            logits, _, aux, hidden = out
        else:
            logits, _, aux = out
        loss = cross_entropy(logits, batch["labels"], tcfg.z_loss)
        metrics = {"ce": loss, "aux": aux}
        if want_mtp:
            # predict t_{i+2} from h_i and emb(t_{i+1}); the labels are the
            # shifted stream (the final position drops by truncation)
            nt = batch["labels"]
            lg2, aux2 = mtp_logits(params, cfg, hidden[:, :-1], nt[:, :-1],
                                   impl=TRAIN_IMPL)
            l2 = cross_entropy(lg2, nt[:, 1:], 0.0)
            loss = loss + tcfg.mtp_weight * l2
            aux = aux + aux2
            metrics["mtp_ce"] = l2
        total = loss + aux
        metrics["loss"] = total
        return total, metrics
    return loss_fn


def split_batch(batch: Dict[str, torch.Tensor], k: int
                ) -> List[Dict[str, torch.Tensor]]:
    """``k`` microbatches of consecutive rows: every leaf cut on axis 0,
    M-RoPE positions (P, B, S) on axis 1 (the JAX package's
    ``split_leaf``)."""
    def cut(name, x):
        axis = 1 if name == "positions" and x.ndim == 3 else 0
        if x.shape[axis] % k:
            raise ValueError(f"batch leaf {name!r} of {x.shape[axis]} rows "
                             f"does not split into {k} microbatches")
        return x.chunk(k, dim=axis)
    parts = {name: cut(name, x) for name, x in batch.items()}
    return [{name: p[i] for name, p in parts.items()} for i in range(k)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns (init_fn(params) -> opt_state, step_fn(params, opt_state,
    batch) -> (params, opt_state, metrics)). With ``microbatches`` k > 1
    the gradients of the k microbatches are summed, in the gradient's
    own dtype under 8-bit moments (bf16 weights give bf16 sums) and in
    float32 otherwise, then divided by k; the metrics are the means of
    the microbatches'. The optimizer's metrics (``lr``, ``grad_norm``)
    are merged in."""
    opt_cfg = dataclasses.replace(
        tcfg.opt, eight_bit_moments=tcfg.opt.eight_bit_moments
        or cfg.opt_8bit_moments)
    opt_init, opt_update = make_adamw(opt_cfg)
    loss_fn = make_loss_fn(cfg, tcfg)
    k = tcfg.microbatches

    def grads_of(params, batch):
        with torch.enable_grad():
            flat = [p.detach().requires_grad_(True) for p in leaves(params)]
            total, metrics = loss_fn(unflatten(params, flat), batch)
            grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return unflatten(params, grads), {key: v.detach()
                                          for key, v in metrics.items()}

    def step(params, opt_state, batch):
        if k == 1:
            grads, metrics = grads_of(params, batch)
        else:
            def acc_dtype(p):
                return p.dtype if opt_cfg.eight_bit_moments \
                    else torch.float32
            gsum = map_tree(lambda p: torch.zeros(
                p.shape, dtype=acc_dtype(p), device=p.device), params)
            ms = []
            for mb in split_batch(batch, k):
                g, m = grads_of(params, mb)
                gsum = map_tree(torch.add, gsum, g)
                ms.append(m)
            grads = map_tree(lambda g: g / k, gsum)
            metrics = {key: torch.stack([m[key] for m in ms]).mean()
                       for key in ms[0]}
        new_params, new_opt, om = opt_update(grads, opt_state, params)
        metrics.update(om)
        return new_params, new_opt, metrics

    return opt_init, step
