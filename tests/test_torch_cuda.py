"""The port's Hopper kernels against their plain PyTorch versions, on a
CUDA card. Every test skips without one (the kernels have no CPU mode);
on the card run them with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: float32 GroupNorm, RMSNorm and SwiGLU 3e-5 (the kernel
tolerance of the JAX package); float32 attention 1e-4 (fp32 sums over
up to 512 keys and a 128-wide head in another order than the plain
version's matmuls); bfloat16 2e-2 (one bfloat16 rounding of outputs of
order 1).
"""
import dataclasses

import pytest
import torch

from repro_torch.config.base import DiffusionConfig
from repro_torch.configs import reduced_config
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import fused_groupnorm as tgn
from repro_torch.kernels import fused_rmsnorm as trms
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swiglu as tswiglu
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import forward, init_params
from repro_torch.models.unet import apply_unet, init_unet

FA_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
          torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
GN_TOL = dict(atol=3e-5, rtol=3e-5)
EW_TOL = {torch.float32: GN_TOL,
          torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,kv", [
    (8, 256, 264, 4, 4, 128, False, None),    # the UNet's attention
    (2, 256, 384, 4, 4, 128, False, 264),     # padded K/V, kv_len mask
    (2, 200, 200, 8, 2, 64, True, None),      # causal GQA, ragged tiles
    (1, 128, 128, 8, 1, 32, True, 100),       # MQA, causal + kv_len
    (3, 70, 90, 2, 2, 16, False, None),       # small ragged
])
def test_flash_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, KH, D,
                                    causal, kv):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(g, (B, Sq, H, D), cuda, dtype)
    k = _randn(g, (B, Sk, KH, D), cuda, dtype)
    v = _randn(g, (B, Sk, KH, D), cuda, dtype)
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=causal, kv_len=kv)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, want, **FA_TOL[dtype])


@pytest.mark.parametrize("shape,groups,act", [
    ((8, 64, 64, 128), 8, True),      # UNet top level
    ((8, 16, 16, 1024), 8, True),     # UNet bottom, widest
    ((8, 16, 16, 512), 8, False),     # attention pre-norm
    ((8, 32, 32, 24), 8, True),       # discriminator stem
    ((8, 4, 4, 384), 8, True),        # discriminator, ragged channel block
    ((3, 6, 6, 10), 8, True),         # group shrink 10 -> 5
    ((5, 8, 24), 4, False),           # pre-flattened (B, HW, C)
])
def test_groupnorm_kernel_matches_plain(cuda, shape, groups, act):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = _randn(g, shape, cuda) * 3 + 1
    s = torch.rand(shape[-1], generator=g, device=cuda) + 0.5
    b = torch.randn(shape[-1], generator=g, device=cuda) * 0.1
    before = tgn.fused_groupnorm.launches
    got = tgn.fused_groupnorm(x, s, b, groups=groups, act=act)
    torch.cuda.synchronize()
    assert tgn.fused_groupnorm.launches == before + 1
    want = ref.groupnorm_silu_ref(x, s, b, groups=groups, act=act)
    torch.testing.assert_close(got, want, **GN_TOL)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)          # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="kv_len"):
        tflash.flash_attention(q, q, q, kv_len=9)
    with pytest.raises(ValueError, match="contiguous"):
        tgn.fused_groupnorm(torch.zeros(1, 4, 4, 8, device=cuda)
                            .transpose(1, 2), torch.ones(8, device=cuda),
                            torch.zeros(8, device=cuda), groups=4)


def test_cuda_dispatch_launches_the_kernels(cuda):
    ops.reset_launch_counts()
    q = torch.randn(1, 8, 2, 16, device=cuda)
    ops.flash_attention(q, q, q)
    ops.fused_groupnorm(torch.randn(1, 4, 4, 8, device=cuda),
                        torch.ones(8, device=cuda),
                        torch.zeros(8, device=cuda), groups=4)
    ops.decode_attention(q[:, 0], q, q,
                         torch.full((1,), 8, dtype=torch.int32, device=cuda))
    ops.fused_rmsnorm(q, torch.ones(16, device=cuda), residual=q)
    ops.swiglu(q, q)
    assert ops.launch_counts() == {"flash_attention": 1,
                                   "fused_groupnorm": 1,
                                   "decode_attention": 1,
                                   "fused_rmsnorm": 1, "swiglu": 1}


def test_unet_fused_matches_unfused_on_cuda(cuda):
    cfg = DiffusionConfig(name="s", image_size=16, base_channels=32,
                          channel_mults=(1, 2), num_res_blocks=1,
                          attn_resolutions=(8,), num_heads=2, text_dim=32)
    p = init_unet(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = _randn(g, (3, 16, 16, 4), cuda)
    t = torch.tensor([0, 500, 999], device=cuda)
    toks = torch.randint(0, 1024, (3, 8), generator=g, device=cuda)
    ops.reset_launch_counts()
    a = apply_unet(p, cfg, x, t, toks, impl="fused")
    assert ops.launch_counts() == {"flash_attention": 4,
                                   "fused_groupnorm": 21,
                                   "decode_attention": 0,
                                   "fused_rmsnorm": 0, "swiglu": 0}
    b = apply_unet(p, cfg, x, t, toks, impl="unfused")
    torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-5)


# ---------------------------------------------------------------------------
# The LM kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,D,T,valid", [
    (4, 32, 4, 128, 1024, (513, 520, 530, 544)),   # Yi-9B served decode
    (2, 32, 4, 128, 1000, (1000, 999)),            # T not a multiple of 64
    (3, 6, 1, 64, 190, (1, 64, 65)),               # MQA G = 6, tile edges
    (2, 16, 1, 32, 77, (77, 3)),                   # the largest group
    (2, 4, 4, 16, 40, (40, 17)),                   # MHA, one ragged tile
])
def test_decode_kernel_matches_plain(cuda, dtype, B, H, KH, D, T, valid):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(g, (B, H, D), cuda, dtype)
    k = _randn(g, (B, T, KH, D), cuda, dtype)
    v = _randn(g, (B, T, KH, D), cuda, dtype)
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    before = tdecode.decode_attention.launches
    got = tdecode.decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert tdecode.decode_attention.launches == before + 1
    want = ref.decode_attention_ref(q, k, v, vl)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, want, **FA_TOL[dtype])


def test_decode_kernel_valid_len_zero_gives_zeros(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(g, (3, 8, 128), cuda)
    k = _randn(g, (3, 100, 1, 128), cuda)
    vl = torch.tensor([0, 100, 0], dtype=torch.int32, device=cuda)
    got = tdecode.decode_attention(q, k, k, vl)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not got[0].any() and not got[2].any()
    torch.testing.assert_close(got, ref.decode_attention_ref(q, k, k, vl),
                               **FA_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 512, 4096), (4, 1, 4096),
                                   (3, 5, 576), (8, 96)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = _randn(g, shape, cuda, dtype) * 3
    r = _randn(g, shape, cuda, dtype)
    s = torch.rand(shape[-1], generator=g, device=cuda) + 0.5
    before = trms.fused_rmsnorm.launches
    got = trms.fused_rmsnorm(x, s)
    got_n, got_sum = trms.fused_rmsnorm(x, s, residual=r)
    torch.cuda.synchronize()
    assert trms.fused_rmsnorm.launches == before + 2
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, s), **EW_TOL[dtype])
    want_n, want_sum = ref.rmsnorm_ref(x, s, residual=r)
    torch.testing.assert_close(got_n, want_n, **EW_TOL[dtype])
    torch.testing.assert_close(got_sum, want_sum, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 512, 11008), (4, 1, 11008),
                                   (3, 1000)])
def test_swiglu_kernel_matches_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(6)
    gate = _randn(g, shape, cuda, dtype) * 4
    up = _randn(g, shape, cuda, dtype)
    before = tswiglu.swiglu.launches
    got = tswiglu.swiglu(gate, up)
    torch.cuda.synchronize()
    assert tswiglu.swiglu.launches == before + 1
    torch.testing.assert_close(got, ref.swiglu_ref(gate, up),
                               **EW_TOL[dtype])


def test_lm_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 48, device=cuda)                  # head dim 48
    k = torch.zeros(1, 4, 2, 48, device=cuda)
    vl = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tdecode.decode_attention(q, k, k, vl)
    q, k = torch.zeros(1, 34, 16, device=cuda), \
        torch.zeros(1, 4, 2, 16, device=cuda)               # G = 17
    with pytest.raises(ValueError, match="group"):
        tdecode.decode_attention(q, k, k, vl)
    q = torch.zeros(1, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        tdecode.decode_attention(q, k, k, vl.long())
    with pytest.raises(ValueError, match="contiguous"):
        trms.fused_rmsnorm(torch.zeros(4, 8, device=cuda).T,
                           torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match="shape or dtype"):
        trms.fused_rmsnorm(torch.zeros(4, 8, device=cuda),
                           torch.ones(8, device=cuda),
                           residual=torch.zeros(4, 8, device=cuda).bfloat16())
    with pytest.raises(ValueError, match="differ"):
        tswiglu.swiglu(torch.zeros(4, device=cuda),
                       torch.zeros(5, device=cuda))


def _lm(cuda, **over):
    cfg = dataclasses.replace(reduced_config("yi-9b"), num_heads=8,
                              num_kv_heads=2, d_model=256, head_dim=128,
                              d_ff=512, **over)
    return cfg, init_params(cfg, seed=0, device=cuda)


def test_lm_kernel_path_matches_plain_path(cuda, monkeypatch):
    """A small LM (head dim 128, G = 4) in float32: prefill and decode
    logits through the kernels equal those with every ``ops`` function
    swapped for its plain version, and the kernels ran."""
    cfg, p = _lm(cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (3, 20), generator=g,
                         device=cuda)

    def run():
        cache = init_cache(cfg, 3, 64, cuda)
        lp, cache = forward(p, cfg, toks[:, :19], cache=cache,
                            mode="prefill")
        ld, _ = forward(p, cfg, toks[:, 19:], cache=cache, cache_index=19,
                        mode="decode")
        return lp, ld
    ops.reset_launch_counts()
    got = run()
    counts = ops.launch_counts()
    assert counts["fused_rmsnorm"] == 2 * (2 * cfg.num_layers + 1)
    assert counts["decode_attention"] == counts["flash_attention"] \
        == cfg.num_layers
    for name, plain in ops.PLAIN.items():
        monkeypatch.setattr(ops, name, plain)
    want = run()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_chunked_prefill_has_no_kernel_on_cuda(cuda):
    cfg, p = _lm(cuda)
    cache = init_cache(cfg, 1, 32, cuda)
    toks = torch.zeros(1, 4, dtype=torch.long, device=cuda)
    forward(p, cfg, toks, cache=cache, mode="prefill")
    with pytest.raises(NotImplementedError, match="cache_index > 0"):
        forward(p, cfg, toks, cache=cache, cache_index=4, mode="decode")
