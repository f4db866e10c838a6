"""Step builders, input specs and shardings for every (arch x shape)
cell (port of ``repro/launch/steps.py``).

``serve_prefill`` / ``serve_decode`` are the serving steps on one card:
each returns the last position's logits, for next-token sampling, and
the cache, which the step has written in place (the counterpart of the
JAX step's donated cache). ``input_specs`` gives seeded step inputs of
the JAX package's shapes and dtypes; ``input_shapes`` the same as
``meta`` tensors.

``build_train_step`` and ``build_serve_step`` return (step, argument
shapes, specs) as the JAX package's do, shapes ``meta`` tensors where it
has ShapeDtypeStructs. A built step takes trees of DTensors laid out by
``named_safe(mesh, specs, shapes)`` (``parallel/sharding.distribute``
puts full trees there) and runs the port's step under the rules and the
mesh: the model's ``constrain`` points redistribute activations, DTensor
propagates the plain ops between them, and each kernel call runs on
local shards (``parallel/local_calls``). Plain tensors created inside
the step (positions, slots, masks) stand for replicated ones
(``implicit_replication``). The step's outputs are redistributed to the
specs (the JAX step's out_shardings). The train step runs
``training/train_loop.make_train_step`` on the ``unfused`` route; the
serve steps run ``serve_prefill`` / ``serve_decode`` through the
kernels, and write the cache DTensors in place. The same code runs on a
gloo group on the CPU and an NCCL group on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import kvcache
from repro_torch.models.transformer import forward, init_params
from repro_torch.parallel.sharding import (NamedSharding, P, is_spec,
                                           make_rules, mesh_sizes,
                                           param_pspecs, redistribute,
                                           safe_spec, sharding_rules)
from repro_torch.training.optimizer import make_adamw, opt_state_pspecs
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.tree import map_tree

# per-arch grad-accumulation, the JAX package's (chosen there so per-device
# temp fits a 16 GB HBM under SP + remat)
MICROBATCHES = {"deepseek-v3-671b": 8, "llama4-scout-17b-a16e": 4,
                "jamba-v0.1-52b": 4, "yi-9b": 4, "qwen2-vl-7b": 2,
                "starcoder2-3b": 2, "musicgen-large": 2}


def cache_len(shape: ShapeConfig) -> int:
    """Cache allocation length, padded to a multiple of 512 (decode
    holds seq_len history plus the token being written)."""
    need = shape.seq_len if shape.kind == "prefill" else shape.seq_len + 1
    return ((need + 511) // 512) * 512


def input_specs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Seeded step inputs of the JAX package's ``input_specs`` shapes and
    dtypes, on ``device`` (CUDA unless the caller passes "cpu"):
    ``inputs`` int32 tokens (B, S) below the vocabulary, or bfloat16
    embeddings (B, S, D) of a standard normal; ``labels`` int32 (B, S)
    for a train step; M-RoPE ``positions`` int32 (P, B, S), the default
    positions (the sequence slots on every axis). S is the shape's
    seq_len for train and prefill and 1 for decode, whose token sits at
    slot seq_len."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = shape.global_batch
    S = shape.seq_len if shape.kind in ("train", "prefill") else 1
    if cfg.input_mode == "tokens":
        inputs = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=dev, dtype=torch.int32)
    else:
        inputs = torch.randn((B, S, cfg.d_model), generator=gen,
                             device=dev).to(torch.bfloat16)
    specs = {"inputs": inputs}
    if shape.kind == "train":
        specs["labels"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)
    if cfg.rope == "mrope":
        start = shape.seq_len if shape.kind == "decode" else 0
        pos = torch.arange(start, start + S, dtype=torch.int32, device=dev)
        specs["positions"] = pos.expand(cfg.num_position_dims, B,
                                        S).contiguous()
    return specs


@torch.no_grad()
def serve_prefill(params, cfg: ModelConfig, cache, inputs, positions=None):
    """Fill ``cache`` from position 0 with the prompts ``inputs``: tokens
    (B, S) or embeddings (B, S, D), with M-RoPE ``positions`` (P, B, S)
    where given; returns (logits (B, V) at the last prompt position,
    cache)."""
    logits, cache, _ = forward(params, cfg, inputs, positions=positions,
                               cache=cache, cache_index=0, mode="prefill")
    return logits[:, -1, :], cache


@torch.no_grad()
def serve_decode(params, cfg: ModelConfig, cache, inputs, cache_index,
                 positions=None):
    """One step: ``inputs`` (tokens (B, 1) or embeddings (B, 1, D)) at
    position ``cache_index`` (an int or a 0-d device tensor) against
    ``cache``; returns (logits (B, V), cache)."""
    logits, cache, _ = forward(params, cfg, inputs, positions=positions,
                               cache=cache, cache_index=cache_index,
                               mode="decode")
    return logits[:, -1, :], cache


def input_shapes(cfg: ModelConfig, shape: ShapeConfig
                 ) -> Dict[str, torch.Tensor]:
    """``input_specs``' shapes and dtypes as ``meta`` tensors."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind in ("train", "prefill") else 1

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    specs = {"inputs": meta((B, S), torch.int32)
             if cfg.input_mode == "tokens"
             else meta((B, S, cfg.d_model), torch.bfloat16)}
    if shape.kind == "train":
        specs["labels"] = meta((B, S), torch.int32)
    if cfg.rope == "mrope":
        specs["positions"] = meta((cfg.num_position_dims, B, S), torch.int32)
    return specs


def param_shapes(cfg: ModelConfig):
    """The parameter tree of ``init_params`` as ``meta`` tensors."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# Sharding rules per (cfg, mesh)
# ---------------------------------------------------------------------------
def rules_for(cfg: ModelConfig, mesh, *, fsdp: Optional[bool] = None,
              sequence_parallel: Optional[bool] = None,
              serve: bool = False):
    da = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return make_rules(
        data_axes=da, model_axis="model",
        fsdp=cfg.fsdp if fsdp is None else fsdp,
        sequence_parallel=(cfg.sequence_parallel if sequence_parallel is None
                           else sequence_parallel),
        serve=serve)


def batch_pspec(rules) -> P:
    return P(rules["batch"])


def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, rules) -> Dict[str, P]:
    dp = rules["batch"]
    out: Dict[str, P] = {}
    if cfg.input_mode == "tokens":
        out["inputs"] = P(dp, None)
    else:
        out["inputs"] = P(dp, None, None)
    if shape.kind == "train":
        out["labels"] = P(dp, None)
    if cfg.rope == "mrope":
        out["positions"] = P(None, dp, None)
    return out


def named_safe(mesh, specs, shapes):
    """``NamedSharding``s with the divisibility fallback: any dim whose
    size its assigned mesh-axis product does not divide takes the longest
    suffix of its still-unused axes that does, else is replicated (3 KV
    heads on a 16-way model axis are replicated; 16 experts on ("data",
    "model") = 256 fall back to "model", freeing "data" for the expert
    FFN dim). ``specs``: a spec or a tree of them (``None`` for
    replicated) matching ``shapes`` (tensors, ``meta`` ones included)."""
    sizes = mesh_sizes(mesh)

    def one(spec, shp):
        if spec is None:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, safe_spec(spec, tuple(shp.shape), sizes))
    if is_spec(specs) or specs is None:
        return one(specs, shapes)
    return map_tree(one, specs, shapes, is_leaf=is_spec)


@contextlib.contextmanager
def _on_mesh(rules, mesh):
    from torch.distributed.tensor.experimental import implicit_replication
    with sharding_rules(rules, mesh), implicit_replication():
        yield


def _train_shape(cfg):
    return SHAPES["train_4k"]


def build_train_step(cfg: ModelConfig, mesh,
                     tcfg: Optional[TrainConfig] = None):
    """Returns (step, (param shapes, opt-state shapes, batch shapes),
    {"params", "opt", "batch", "rules"} specs). ``step(params, opt_state,
    batch)`` takes and returns trees laid out by ``named_safe`` of those
    specs; its metrics come back replicated."""
    tcfg = tcfg or TrainConfig(microbatches=MICROBATCHES.get(cfg.name, 1))
    rules = rules_for(cfg, mesh)
    _, step = make_train_step(cfg, tcfg)
    pshapes = param_shapes(cfg)
    p_specs = param_pspecs(pshapes, rules)
    ocfg = dataclasses.replace(tcfg.opt,
                               eight_bit_moments=tcfg.opt.eight_bit_moments
                               or cfg.opt_8bit_moments)
    opt_init, _ = make_adamw(ocfg)
    oshapes = opt_init(pshapes)
    o_specs = opt_state_pspecs(oshapes, p_specs)
    ispec = input_shapes(cfg, _train_shape(cfg))
    b_specs = input_pspecs(cfg, _train_shape(cfg), rules)
    p_sh = named_safe(mesh, p_specs, pshapes)
    o_sh = named_safe(mesh, o_specs, oshapes)

    def sharded_step(params, opt_state, batch):
        with _on_mesh(rules, mesh):
            new_p, new_o, metrics = step(params, opt_state, batch)
        rep = NamedSharding(mesh, P())
        return (redistribute(new_p, p_sh), redistribute(new_o, o_sh),
                redistribute(metrics, map_tree(lambda _: rep, metrics)))
    return sharded_step, (pshapes, oshapes, ispec), \
        {"params": p_specs, "opt": o_specs, "batch": b_specs, "rules": rules}


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig, rules=None):
    """Prefill or decode step for serving: (step, argument shapes, specs
    {"params", "cache", "batch", "rules"}). ``step(params, cache, batch)``
    (prefill) or ``step(params, cache, batch, cache_index)`` (decode, an
    int or a 0-d tensor) writes the cache in place and returns
    (last-position logits laid out as ``P(batch, vocab)``, cache)."""
    rules = rules or rules_for(cfg, mesh, serve=True)
    model_size = mesh_sizes(mesh)["model"]
    pshapes = param_shapes(cfg)
    p_specs = param_pspecs(pshapes, rules)
    cshapes = kvcache.cache_specs(cfg, shape.global_batch, cache_len(shape))
    c_specs = kvcache.cache_pspecs(cshapes, rules, model_size)
    ispec = input_shapes(cfg, shape)
    b_specs = input_pspecs(cfg, shape, rules)
    logit_shape = torch.empty((shape.global_batch, cfg.vocab_size),
                              dtype=torch.bfloat16, device="meta")
    l_sh = named_safe(mesh, P(rules["batch"], rules.get("vocab")),
                      logit_shape)

    if shape.kind == "prefill":
        def serve(params, cache, batch):
            with _on_mesh(rules, mesh):
                logits, cache = serve_prefill(params, cfg, cache,
                                              batch["inputs"],
                                              batch.get("positions"))
            return redistribute(logits, l_sh), cache
        args: Any = (pshapes, cshapes, ispec)
    else:
        def serve(params, cache, batch, cache_index):
            with _on_mesh(rules, mesh):
                logits, cache = serve_decode(params, cfg, cache,
                                             batch["inputs"], cache_index,
                                             batch.get("positions"))
            return redistribute(logits, l_sh), cache
        args = (pshapes, cshapes, ispec,
                torch.empty((), dtype=torch.int32, device="meta"))
    return serve, args, {"params": p_specs, "cache": c_specs,
                         "batch": b_specs, "rules": rules}
