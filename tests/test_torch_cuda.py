"""The port's Hopper kernels against their plain PyTorch versions, on a
CUDA card. Every test skips without one (the kernels have no CPU mode);
on the card run them with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: float32 GroupNorm 3e-5 (the kernel tolerance of the JAX
package); float32 attention 1e-4 (fp32 sums over up to 512 keys and a
128-wide head in another order than the plain version's matmuls);
bfloat16 attention 2e-2 (one bfloat16 rounding of outputs of order 1).
"""
import pytest
import torch

from repro_torch.config.base import DiffusionConfig
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import fused_groupnorm as tgn
from repro_torch.kernels import ops, ref
from repro_torch.models.unet import apply_unet, init_unet

FA_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
          torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
GN_TOL = dict(atol=3e-5, rtol=3e-5)


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
    assert ops.launch_counts() == {"flash_attention": 1,
                                   "fused_groupnorm": 1}


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
                                   "fused_groupnorm": 21}
    b = apply_unet(p, cfg, x, t, toks, impl="unfused")
    torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-5)
