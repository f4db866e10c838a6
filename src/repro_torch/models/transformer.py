"""Decoder-only LM (port of ``repro/models/transformer.py``).

Each block is (mixer, ffn) with mixer in {attn, mla, mamba, mlstm,
slstm} and ffn in {mlp, moe, None}. Parameters: ``{"embed"?, "layers":
[block, ...], "final_norm", "lm_head"?, "mtp"?}`` with one block per
layer of ``cfg.flat_pattern()``; the JAX package's scan over stacked
periods is a Python loop over this list. A model takes int tokens
(B, S) or, with ``input_mode="embeddings"``, float embeddings (B, S, D)
(an embedding-input model has no embedding table; its ``embed`` holds
only learned positions, where it has them). ``forward`` runs in three
modes, as there:

  * ``train``   — the full sequence, no cache;
  * ``prefill`` — the sequence written into the cache at
    ``cache_index`` (0 for a whole prompt, > 0 for a later chunk);
  * ``decode``  — S new tokens (1 when served) at ``cache_index``.

It returns ``(logits, cache, aux[, hidden])``: aux the summed MoE
load-balance losses, hidden the last block's output before the final
norm (the multi-token prediction head's input, ``mtp_logits``).

Kernels per forward (``kernels/ops.py``): with RMSNorm, one launch a
layer for ``ln1``, one for ``ln2`` fused with the mixer's residual add
(blocks with an FFN), one for the final norm, and MLA's latent norm and
(with a query rank) query norm; SwiGLU once per SwiGLU MLP, and once for
an MoE layer's experts plus once for its shared expert; attention once
per attention layer (flash in train/prefill, decode attention at S = 1,
flash with a query offset for a prompt chunk at ``cache_index`` > 0);
``mamba_scan`` once per Mamba layer and ``mlstm_chunk`` once per mLSTM
layer. LayerNorm, GELU, the sLSTM and MLA's attention are plain
PyTorch. Remat has no counterpart. ``impl="unfused"`` runs every kernel
call as its plain version on any device instead: the route autograd
differentiates, which the train steps take (``training/train_loop.py``).

The causal mask follows the query positions, as in the JAX package:
M-RoPE's t axis or the (B, S) positions a caller passes. A forward given
no positions masks by the sequence slots, which its default positions
are.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.parallel.sharding import constrain, foldable

MODES = ("train", "prefill", "decode")


_MIXERS = {"mamba": (SSM.mamba_init, SSM.mamba_apply),
           "mlstm": (XL.mlstm_init, XL.mlstm_apply),
           "slstm": (XL.slstm_init, XL.slstm_apply)}


def _check_spec(spec) -> None:
    mixer, ffn = spec
    if mixer not in ("attn", "mla") and mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn not in ("mlp", "moe", None):
        raise ValueError(f"unknown ffn {ffn!r}")


def block_init(gen, cfg: ModelConfig, spec, device=None) -> Dict[str, Any]:
    _check_spec(spec)
    mixer, ffn = spec
    p: Dict[str, Any] = {"ln1": L.norm_init(cfg.norm, cfg.d_model, device)}
    if mixer == "attn":
        p["attn"] = L.attn_init(gen, cfg, device)
    elif mixer == "mla":
        p["attn"] = MLA.mla_init(gen, cfg, device)
    else:
        p["mixer"] = _MIXERS[mixer][0](gen, cfg, device)
    if ffn is not None:
        p["ln2"] = L.norm_init(cfg.norm, cfg.d_model, device)
        p["ffn"] = (L.moe_init(gen, cfg, device) if ffn == "moe"
                    else L.mlp_init(gen, cfg, device=device))
    return p


def block_apply(params, cfg: ModelConfig, spec, x, *, positions,
                cache_entry, cache_index, mode: str = "train", slots=None,
                valid_len=None, q_positions=None, slot_mask: bool = False,
                impl: str = "fused"):
    """Returns (x, cache_entry, aux); the entry, when given, is written in
    place, and aux is the MoE layer's load-balance loss (0.0 for other
    blocks). The MLA mixer runs its absorbed decode in ``decode`` mode
    and its prefill otherwise, as the JAX package dispatches. The
    residual add after the mixer is fused into the ``ln2`` norm:
    ``(h, x) = norm(y, residual=x)``. ``slots``, ``valid_len``,
    ``q_positions`` and ``slot_mask`` are ``layers.attn_apply``'s."""
    mixer, ffn = spec
    h = foldable(L.norm_apply(params["ln1"], x, cfg.norm, cfg.norm_eps,
                              impl=impl))
    if mixer == "attn":
        y, entry = L.attn_apply(params["attn"], cfg, h, positions=positions,
                                cache=cache_entry, cache_index=cache_index,
                                slots=slots, valid_len=valid_len,
                                q_positions=q_positions, slot_mask=slot_mask,
                                impl=impl)
    elif mixer == "mla":
        if mode == "decode":
            y, entry = MLA.mla_decode(params["attn"], cfg, h, positions,
                                      cache_entry, cache_index, impl=impl)
        else:
            y, entry = MLA.mla_prefill(params["attn"], cfg, h, positions,
                                       cache=cache_entry,
                                       cache_index=cache_index, impl=impl)
    else:
        y, entry = _MIXERS[mixer][1](params["mixer"], cfg, h,
                                     state=cache_entry, impl=impl)
    if ffn is None:
        return x + y, entry, 0.0
    h, x = L.norm_apply(params["ln2"], y, cfg.norm, cfg.norm_eps,
                        residual=x, impl=impl)
    h = foldable(h)
    aux = 0.0
    if ffn == "moe":
        y, aux = L.moe_apply(params["ffn"], cfg, h, impl)
    else:
        y = L.mlp_apply(params["ffn"], cfg, h, impl)
    return x + y, entry, aux


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters (the JAX package's structure and distributions)
    from a seeded ``torch.Generator`` on ``device`` (CUDA unless the
    caller passes "cpu")."""
    dev = resolve_device(device)
    # a "meta" tree (shapes only) draws nothing: any generator will do
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    dt = L.torch_dtype(cfg.dtype)
    p: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        p["embed"] = L.embed_init(gen, cfg, dev)
    elif cfg.pos_emb == "learned":
        p["embed"] = {"pos_embedding": L.dense_init(
            gen, (cfg.max_position, cfg.d_model), scale=0.02, dtype=dt,
            device=dev)}
    p["layers"] = [block_init(gen, cfg, spec, dev)
                   for spec in cfg.flat_pattern()]
    p["final_norm"] = L.norm_init(cfg.norm, cfg.d_model, dev)
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        p["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                    scale=cfg.d_model ** -0.5, dtype=dt,
                                    device=dev)
    if cfg.mtp_depth:
        p["mtp"] = {
            "proj": L.dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                 dtype=dt, device=dev),
            "norm_h": L.norm_init(cfg.norm, cfg.d_model, dev),
            "norm_e": L.norm_init(cfg.norm, cfg.d_model, dev),
            "block": block_init(gen, cfg, cfg.period_pattern[-1], dev),
        }
    return p


def default_positions(cfg: ModelConfig, batch: int, slots):
    """The positions of tokens at sequence slots ``slots`` (S,): (B, S)
    int64, broadcast to (P, B, S) for M-RoPE (every axis the slot)."""
    pos = slots[None, :].expand(batch, slots.shape[0])
    if cfg.rope == "mrope":
        pos = pos[None].expand(cfg.num_position_dims, *pos.shape)
    return pos


def _aux(aux, device) -> torch.Tensor:
    if torch.is_tensor(aux):
        return aux
    return torch.zeros((), dtype=torch.float32, device=device)


def _logits(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        return x @ params["embed"]["embedding"].T
    return x @ params["lm_head"]


def forward(params, cfg: ModelConfig, inputs, *, positions=None, cache=None,
            cache_index=0, mode: str = "train", return_hidden: bool = False,
            impl: str = "fused"):
    """inputs: int tokens (B, S) or float embeddings (B, S, D).
    ``positions``: (B, S), or (P, B, S) with M-RoPE (default: the slots
    ``cache_index + arange(S)`` on every axis); the causal mask follows
    them (M-RoPE's first axis). ``cache``: the list of ``init_cache``,
    needed in ``prefill`` and ``decode`` and written in place;
    ``cache_index``: the slot of the first token, an int or a 0-d device
    tensor. ``impl``: ``fused`` (the kernels) or ``unfused`` (their plain
    versions, which autograd differentiates). Returns (logits (B, S, V),
    cache, aux[, hidden])."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if (cache is None) != (mode == "train"):
        raise ValueError(f"mode {mode!r} with cache={cache is not None}: "
                         "train takes no cache, prefill and decode need one")
    embeds = inputs.is_floating_point()
    B, S = inputs.shape[:2]
    slots = L.slots_for(S, cache_index, inputs.device)
    slot_mask = positions is None
    if slot_mask:
        positions = default_positions(cfg, B, slots)
        qpos = None
    else:
        qpos = L.query_positions(positions)
    if not embeds:
        x = L.embed_apply(params["embed"], cfg, inputs, positions)
    else:
        x = inputs.to(L.torch_dtype(cfg.dtype))
        if cfg.pos_emb == "learned":
            pos = positions if positions.ndim == 2 else positions[0]
            x = x + L.lookup(pos, params["embed"]["pos_embedding"])
    x = constrain(x, "batch", "seq", "act_embed")
    valid_len = None
    if cache is not None and S == 1:
        valid_len = L.decode_valid_len(slots, B, qpos)
    aux = 0.0
    for i, (spec, lp) in enumerate(zip(cfg.flat_pattern(),
                                       params["layers"])):
        x, _, a = block_apply(lp, cfg, spec, x, positions=positions,
                              cache_entry=None if cache is None else cache[i],
                              cache_index=cache_index, mode=mode, slots=slots,
                              valid_len=valid_len, q_positions=qpos,
                              slot_mask=slot_mask, impl=impl)
        aux = aux + a
    hidden = x
    x = L.norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps,
                     impl=impl)
    logits = constrain(_logits(params, cfg, foldable(x)), "batch", None,
                       "vocab")
    out = (logits, cache, _aux(aux, x.device))
    return out + (hidden,) if return_hidden else out


def mtp_logits(params, cfg: ModelConfig, hidden, next_tokens,
               positions=None, impl: str = "fused"):
    """DeepSeek-V3's multi-token prediction head (depth 1): predicts
    token i+2 from hidden_i (``forward(..., return_hidden=True)``) and
    the embedding of token i+1 (``next_tokens`` (B, S)), through one
    more block of the period's last kind. Returns (logits, aux)."""
    mp = params["mtp"]
    B, S, _ = hidden.shape
    slot_mask = positions is None
    if slot_mask:
        positions = default_positions(cfg, B,
                                      L.slots_for(S, 0, hidden.device))
    emb = L.lookup(next_tokens, params["embed"]["embedding"])
    h = torch.cat([L.norm_apply(mp["norm_h"], hidden, cfg.norm,
                                cfg.norm_eps, impl=impl),
                   L.norm_apply(mp["norm_e"], emb, cfg.norm, cfg.norm_eps,
                                impl=impl)],
                  dim=-1)
    h = foldable(h) @ mp["proj"]
    h, _, aux = block_apply(mp["block"], cfg, cfg.period_pattern[-1], h,
                            positions=positions, cache_entry=None,
                            cache_index=0, mode="train", slot_mask=slot_mask,
                            impl=impl)
    h = foldable(L.norm_apply(params["final_norm"], h, cfg.norm,
                              cfg.norm_eps, impl=impl))
    if cfg.tie_embeddings:
        lg = h @ params["embed"]["embedding"].T
    else:
        lg = h @ params["lm_head"]
    return lg, _aux(aux, h.device)


def _norm_size(kind: str, dim: int) -> int:
    return {"rmsnorm": dim, "layernorm": 2 * dim, "nonparam_ln": 0}[kind]


def _mixer_size(cfg: ModelConfig, mixer: str) -> int:
    D = cfg.d_model
    if mixer == "attn":
        H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        return 2 * D * H * hd + 2 * D * KH * hd
    if mixer == "mla":
        m, H = cfg.mla, cfg.num_heads
        dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                         m.v_head_dim, m.kv_lora_rank)
        # w_dkv, kv_norm, w_uk, w_uv, w_kr, wo; then the query path
        n = D * r + r + r * H * dn + r * H * dv + D * dr + H * dv * D
        if m.q_lora_rank:
            rq = m.q_lora_rank
            return n + D * rq + rq + rq * H * (dn + dr)
        return n + D * H * (dn + dr)
    if mixer == "mamba":
        E, N, R = SSM._dims(cfg)
        W = cfg.ssm.d_conv
        # in_proj, conv kernel + bias, x_proj, dt_proj + dt_bias, A_log,
        # D, out_proj
        return D * 2 * E + W * E + E + E * (R + 2 * N) + R * E + E \
            + E * N + E + E * D
    if mixer == "mlstm":
        E, H, _ = XL._mlstm_dims(cfg)
        W = cfg.xlstm.conv_kernel
        # wi_up, conv kernel + bias, wq/wk/wv, w_if, i/f biases, ogate
        # scale, out_proj
        return D * 2 * E + W * E + E + 3 * E * E + E * 2 * H + 2 * H + E \
            + E * D
    up = XL.slstm_up_dim(cfg)                      # slstm
    dh = D // cfg.num_heads
    return D * 4 * D + cfg.num_heads * dh * 4 * dh + 4 * D + 2 * D * up


def _ffn_size(cfg: ModelConfig, ffn: str, active_only: bool) -> int:
    """Parameters of one FFN; ``active_only`` counts the routed experts'
    weights at top_k of num_experts (the JAX package's rule)."""
    D = cfg.d_model
    mats = 3 if cfg.mlp == "swiglu" else 2
    if ffn == "mlp":
        return mats * D * cfg.d_ff
    m = cfg.moe
    Fd = m.d_ff or cfg.d_ff
    experts = m.num_experts * D * Fd
    if active_only:
        experts = experts * m.top_k // max(m.num_experts, 1)
    n = D * m.num_experts + 3 * experts
    if m.num_shared_experts:
        n += mats * D * Fd * m.num_shared_experts
    return n


def _block_size(cfg: ModelConfig, spec, active_only: bool) -> int:
    _check_spec(spec)
    mixer, ffn = spec
    n = _norm_size(cfg.norm, cfg.d_model) + _mixer_size(cfg, mixer)
    if ffn is not None:
        n += _norm_size(cfg.norm, cfg.d_model) + _ffn_size(cfg, ffn,
                                                           active_only)
    return n


def count_params(cfg: ModelConfig, active_only: bool = False,
                 include_embedding: bool = True) -> int:
    """Parameters of ``init_params(cfg)``, from the config alone (the
    JAX package's ``count_params``): ``active_only`` counts the routed
    experts at top_k of num_experts; ``include_embedding=False`` leaves
    out the embedding table and learned positions."""
    D, V = cfg.d_model, cfg.vocab_size
    n = _norm_size(cfg.norm, D)
    if include_embedding:
        if cfg.input_mode == "tokens":
            n += V * D
        if cfg.pos_emb == "learned":
            n += cfg.max_position * D
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        n += D * V
    for spec in cfg.flat_pattern():
        n += _block_size(cfg, spec, active_only)
    if cfg.mtp_depth:
        n += 2 * D * D + 2 * _norm_size(cfg.norm, D) \
            + _block_size(cfg, cfg.period_pattern[-1], active_only)
    return n
