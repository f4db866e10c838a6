"""EfficientNetV2-style discriminator (the paper's §3.2 design), PyTorch.

Port of ``repro/models/efficientnet.py``. Binary classifier 'real' vs
'fake'; the softmax P(real) is the cascade confidence score. GroupNorm
replaces BatchNorm. Activations stay channels-last (NHWC) at every
public function, as in the JAX package; convolutions run on the
NCHW view of that memory (PyTorch's channels-last format), so no copy
is made. Parameters are a nested dict of tensors: conv weights in
PyTorch's OIHW layout, dense weights (cin, cout) used as ``x @ w``
(``models/convert.py`` turns a JAX tree into this form).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import group_count


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    name: str = "efficientnet_s"
    in_channels: int = 3
    stem_channels: int = 24
    # (channels, depth, stride, expand) per stage — EfficientNetV2-S-ish,
    # scaled down for 32-64px inputs
    stages: Tuple[Tuple[int, int, int, int], ...] = (
        (24, 1, 1, 1), (48, 2, 2, 4), (64, 2, 2, 4), (96, 2, 2, 4))
    head_channels: int = 256
    num_classes: int = 2
    se_ratio: float = 0.25
    gn_groups: int = 8


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA "SAME" padding (before, after) of one spatial dim: at stride 2
    on an even size the odd pixel goes after (bottom/right)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride: int = 1, groups: int = 1):
    """x: (B,H,W,Cin) NHWC; w: (Cout, Cin/groups, kh, kw). "SAME"
    padding as in the JAX package."""
    (pt, pb), (pl, pr) = (_same_pad(x.shape[1], w.shape[2], stride),
                          _same_pad(x.shape[2], w.shape[3], stride))
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, w, stride=stride, padding=(pt, pl), groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), w, stride=stride,
                     groups=groups)
    return y.permute(0, 2, 3, 1)


def groupnorm(x, scale, bias, groups: int):
    """The unfused GroupNorm of the JAX package (fp32 statistics)."""
    B, H, W, C = x.shape
    g = group_count(groups, C)
    xg = x.reshape(B, H, W, g, C // g).float()
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mu).square().mean(dim=(1, 2, 4), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + 1e-5)
    return (xg.reshape(B, H, W, C) * scale + bias).to(x.dtype)


def gn_act(x, p, groups: int, *, act: bool = True, impl: str = "fused"):
    """GroupNorm (+ optional SiLU): "unfused" keeps the per-op baseline;
    "fused" goes through ``kernels.ops.fused_groupnorm``."""
    if impl == "unfused":
        h = groupnorm(x, p["scale"], p["bias"], groups)
        return F.silu(h) if act else h
    return ops.fused_groupnorm(x, p["scale"], p["bias"], groups=groups,
                               act=act)


# ---------------------------------------------------------------------------
# init (same structure and distributions as the JAX package; PyTorch draws)
# ---------------------------------------------------------------------------
def _conv_init(gen, kh, kw, cin, cout, device):
    return torch.randn((cout, cin, kh, kw), generator=gen, device=device) \
        * math.sqrt(2.0 / (kh * kw * cin))


def _gn_init(c, device):
    return {"scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device)}


def _mbconv_init(gen, cin, cout, expand, se_ratio, device):
    mid = cin * expand
    p = {"gn0": _gn_init(cin, device)}
    if expand > 1:
        p["w_exp"] = _conv_init(gen, 1, 1, cin, mid, device)
        p["gn1"] = _gn_init(mid, device)
    p["w_dw"] = torch.randn((mid, 1, 3, 3), generator=gen, device=device) \
        * math.sqrt(2.0 / 9.0)
    p["gn2"] = _gn_init(mid, device)
    se = max(int(cin * se_ratio), 4)
    p["w_se1"] = _conv_init(gen, 1, 1, mid, se, device)
    p["w_se2"] = _conv_init(gen, 1, 1, se, mid, device)
    p["w_out"] = _conv_init(gen, 1, 1, mid, cout, device)
    p["gn3"] = _gn_init(cout, device)
    return p


def init_discriminator(cfg: DiscriminatorConfig, seed: int = 0,
                       device: DeviceLike = None):
    """Random discriminator parameters from a seeded ``torch.Generator``
    on ``device`` (CUDA unless the caller passes "cpu")."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {"stem": _conv_init(gen, 3, 3, cfg.in_channels, cfg.stem_channels,
                            dev),
         "stem_gn": _gn_init(cfg.stem_channels, dev)}
    cin = cfg.stem_channels
    for i, (c, depth, _, expand) in enumerate(cfg.stages):
        blocks = []
        for d in range(depth):
            blocks.append(_mbconv_init(gen, cin if d == 0 else c, c, expand,
                                       cfg.se_ratio, dev))
            cin = c
        p[f"stage{i}"] = blocks
    p["head"] = _conv_init(gen, 1, 1, cin, cfg.head_channels, dev)
    p["head_gn"] = _gn_init(cfg.head_channels, dev)
    p["fc"] = torch.randn((cfg.head_channels, cfg.num_classes), generator=gen,
                          device=dev) / math.sqrt(cfg.head_channels)
    p["fc_b"] = torch.zeros(cfg.num_classes, device=dev)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _mbconv_apply(p, x, stride, expand, gn_groups, impl="fused"):
    cin = x.shape[-1]
    h = gn_act(x, p["gn0"], gn_groups, act=False, impl=impl)
    if expand > 1:
        h = gn_act(conv(h, p["w_exp"]), p["gn1"], gn_groups, impl=impl)
    mid = h.shape[-1]
    h = conv(h, p["w_dw"], stride=stride, groups=mid)
    h = gn_act(h, p["gn2"], gn_groups, impl=impl)
    # squeeze-excite, on the post-SiLU activations
    s = h.mean(dim=(1, 2), keepdim=True)
    s = F.silu(conv(s, p["w_se1"]))
    s = torch.sigmoid(conv(s, p["w_se2"]))
    h = conv(h * s, p["w_out"])
    if stride == 1 and h.shape[-1] == cin:
        h = h + x
    return h


def apply_discriminator(params, cfg: DiscriminatorConfig, images,
                        impl: str = "fused"):
    """images: (B, H, W, C) in [-1, 1]. Returns (logits (B,2), features
    (B, head_channels))."""
    x = gn_act(conv(images, params["stem"], stride=2), params["stem_gn"],
               cfg.gn_groups, impl=impl)
    for i, (_, _, stride, expand) in enumerate(cfg.stages):
        for d, bp in enumerate(params[f"stage{i}"]):
            x = _mbconv_apply(bp, x, stride if d == 0 else 1, expand,
                              cfg.gn_groups, impl=impl)
    x = gn_act(conv(x, params["head"]), params["head_gn"], cfg.gn_groups,
               impl=impl)
    feats = x.mean(dim=(1, 2))
    logits = feats @ params["fc"] + params["fc_b"]
    return logits, feats


def confidence_score(params, cfg: DiscriminatorConfig, images,
                     impl: str = "fused"):
    """P('real') — the paper's confidence score (softmax over 2 classes)."""
    logits, _ = apply_discriminator(params, cfg, images, impl=impl)
    return torch.softmax(logits, dim=-1)[:, 1]
