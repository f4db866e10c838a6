"""Latent-diffusion UNet — the served model class of the paper, PyTorch.

Port of ``repro/models/unet.py``: ResBlocks (GroupNorm+SiLU) with a
timestep embedding, self+cross attention at the configured resolutions,
text conditioning through a toy prompt embedding. Activations are NHWC
at every public function; parameters are a nested dict of tensors in
the layout of ``models/efficientnet.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config.base import DiffusionConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.efficientnet import (_conv_init, _gn_init, conv,
                                             gn_act, groupnorm)


def timestep_embedding(t, dim: int):
    """Sinusoidal embedding, cos half first then sin half."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _dense_init(gen, cin, cout, device):
    return torch.randn((cin, cout), generator=gen, device=device) \
        / math.sqrt(cin)


def _resblock_init(gen, cin, cout, temb_dim, device):
    p = {"gn1": _gn_init(cin, device),
         "w1": _conv_init(gen, 3, 3, cin, cout, device),
         "temb": _dense_init(gen, temb_dim, cout, device),
         "gn2": _gn_init(cout, device),
         "w2": _conv_init(gen, 3, 3, cout, cout, device)}
    if cin != cout:
        p["skip"] = _conv_init(gen, 1, 1, cin, cout, device)
    return p


def _resblock(p, x, temb, groups=8, impl="fused"):
    h = gn_act(x, p["gn1"], groups, impl=impl)
    h = conv(h, p["w1"])
    h = h + (F.silu(temb) @ p["temb"])[:, None, None, :]
    h = gn_act(h, p["gn2"], groups, impl=impl)
    h = conv(h, p["w2"])
    skip = conv(x, p["skip"]) if "skip" in p else x
    return h + skip


def _attn_init(gen, c, text_dim, device):
    return {"gn": _gn_init(c, device),
            "wq": _dense_init(gen, c, c, device),
            "wk": _dense_init(gen, c, c, device),
            "wv": _dense_init(gen, c, c, device),
            "wo": _dense_init(gen, c, c, device),
            "ck": _dense_init(gen, text_dim, c, device),
            "cv": _dense_init(gen, text_dim, c, device)}


def _attn(p, x, ctx, num_heads, groups=8, impl="fused"):
    """Self-attention over pixels + cross-attention to the text context
    ctx (B, L, T): K/V is concat(pixels, ctx), length H*W + L,
    non-causal. Both routes normalise without a SiLU first."""
    B, H, W, C = x.shape
    if impl == "unfused":
        h = groupnorm(x, p["gn"]["scale"], p["gn"]["bias"], groups)
    else:
        h = gn_act(x, p["gn"], groups, act=False, impl=impl)
    seq = h.reshape(B, H * W, C)
    q = seq @ p["wq"]
    k = torch.cat([seq @ p["wk"], ctx @ p["ck"]], dim=1)
    v = torch.cat([seq @ p["wv"], ctx @ p["cv"]], dim=1)
    hd = C // num_heads

    if impl == "unfused":
        def split(a):
            return a.reshape(B, -1, num_heads, hd).transpose(1, 2)
        qh, kh, vh = split(q), split(k), split(v)
        att = torch.softmax(
            torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", att, vh)
        out = out.transpose(1, 2).reshape(B, H * W, C)
    else:
        # the JAX route pads Sk to a block multiple and masks it with
        # kv_len; the Hopper kernel masks the ragged edge itself
        out = ops.flash_attention(q.reshape(B, -1, num_heads, hd),
                                  k.reshape(B, -1, num_heads, hd),
                                  v.reshape(B, -1, num_heads, hd),
                                  causal=False)
        out = out.reshape(B, H * W, C)
    out = out @ p["wo"]
    return x + out.reshape(B, H, W, C)


def init_unet(cfg: DiffusionConfig, seed: int = 0,
              device: DeviceLike = None):
    """Random UNet parameters (the JAX package's structure and
    distributions) from a seeded ``torch.Generator`` on ``device`` (CUDA
    unless the caller passes "cpu")."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c0 = cfg.base_channels
    temb_dim = 4 * c0
    p = {
        "temb1": _dense_init(gen, c0, temb_dim, dev),
        "temb2": _dense_init(gen, temb_dim, temb_dim, dev),
        "text_embed": torch.randn((1024, cfg.text_dim), generator=gen,
                                  device=dev) * 0.02,
        "in": _conv_init(gen, 3, 3, cfg.in_channels, c0, dev),
    }
    res = cfg.image_size
    chans = [c0]
    cin = c0
    downs = []
    for lvl, mult in enumerate(cfg.channel_mults):
        cout = c0 * mult
        level = {"blocks": [], "attns": []}
        for _ in range(cfg.num_res_blocks):
            level["blocks"].append(
                _resblock_init(gen, cin, cout, temb_dim, dev))
            level["attns"].append(
                _attn_init(gen, cout, cfg.text_dim, dev)
                if res in cfg.attn_resolutions else None)
            cin = cout
            chans.append(cin)
        if lvl < len(cfg.channel_mults) - 1:
            level["down"] = _conv_init(gen, 3, 3, cin, cin, dev)
            chans.append(cin)
            res //= 2
        downs.append(level)
    p["downs"] = downs
    p["mid1"] = _resblock_init(gen, cin, cin, temb_dim, dev)
    p["mid_attn"] = _attn_init(gen, cin, cfg.text_dim, dev)
    p["mid2"] = _resblock_init(gen, cin, cin, temb_dim, dev)
    ups = []
    for lvl, mult in reversed(list(enumerate(cfg.channel_mults))):
        cout = c0 * mult
        level = {"blocks": [], "attns": []}
        for _ in range(cfg.num_res_blocks + 1):
            level["blocks"].append(
                _resblock_init(gen, cin + chans.pop(), cout, temb_dim, dev))
            level["attns"].append(
                _attn_init(gen, cout, cfg.text_dim, dev)
                if res in cfg.attn_resolutions else None)
            cin = cout
        if lvl > 0:
            level["up"] = _conv_init(gen, 3, 3, cin, cin, dev)
            res *= 2
        ups.append(level)
    p["ups"] = ups
    p["out_gn"] = _gn_init(cin, dev)
    p["out"] = _conv_init(gen, 3, 3, cin, cfg.in_channels, dev)
    return p


def apply_unet(params, cfg: DiffusionConfig, x, t, prompt_tokens,
               impl: str = "fused"):
    """x: (B,H,W,Cin) noisy latent; t: (B,) timesteps in [0, 1000);
    prompt_tokens: (B, L) int. Returns the epsilon prediction. ``impl``
    routes GroupNorm+SiLU and attention through ``kernels/ops.py``
    ("fused") or the per-op baseline ("unfused")."""
    temb = timestep_embedding(t, cfg.base_channels)
    temb = F.silu(temb @ params["temb1"]) @ params["temb2"]
    ctx = params["text_embed"][prompt_tokens.long() % 1024]

    h = conv(x, params["in"])
    skips = [h]
    for level in params["downs"]:
        for bp, ap in zip(level["blocks"], level["attns"]):
            h = _resblock(bp, h, temb, impl=impl)
            if ap is not None:
                h = _attn(ap, h, ctx, cfg.num_heads, impl=impl)
            skips.append(h)
        if "down" in level:
            h = conv(h, level["down"], stride=2)
            skips.append(h)
    h = _resblock(params["mid1"], h, temb, impl=impl)
    h = _attn(params["mid_attn"], h, ctx, cfg.num_heads, impl=impl)
    h = _resblock(params["mid2"], h, temb, impl=impl)
    for level in params["ups"]:
        for bp, ap in zip(level["blocks"], level["attns"]):
            h = _resblock(bp, torch.cat([h, skips.pop()], dim=-1), temb,
                          impl=impl)
            if ap is not None:
                h = _attn(ap, h, ctx, cfg.num_heads, impl=impl)
        if "up" in level:
            # 2x nearest, on the NCHW view of the NHWC activations
            h = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2,
                              mode="nearest").permute(0, 2, 3, 1)
            h = conv(h, level["up"])
    h = gn_act(h, params["out_gn"], 8, impl=impl)
    return conv(h, params["out"])
