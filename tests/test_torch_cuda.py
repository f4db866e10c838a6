"""The port's Hopper kernels against their plain PyTorch versions, on a
CUDA card. Every test skips without one (the kernels have no CPU mode);
on the card run them with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: float32 GroupNorm, RMSNorm and SwiGLU 3e-5 (the kernel
tolerance of the JAX package); float32 attention 1e-4 (fp32 sums over
up to 512 keys and a 128-wide head in another order than the plain
version's matmuls); bfloat16 2e-2 (one bfloat16 rounding of outputs of
order 1). The recurrences (mLSTM, selective scan) carry fp32 state in
both versions, so their fp32 outputs and final states are held at 1e-4
(sums over up to 384 rows in another order, compounded over up to 512
steps) and their bf16 outputs at 2e-2.
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
from repro_torch.kernels import mamba_scan as tmamba
from repro_torch.kernels import mlstm_chunk as tmlstm
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
    (1, 256, 264, 4, 4, 128, False, None),    # the UNet at b = 1
    (2, 130, 200, 8, 1, 128, True, None),     # MQA, causal, ragged
    (2, 97, 150, 4, 1, 64, False, 120),       # MQA, kv_len, D 64
    (3, 1, 264, 4, 4, 128, False, None),      # Sq = 1
    (2, 40, 77, 4, 2, 64, True, 60),          # one tile, causal + kv_len
])
def test_flash_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, KH, D,
                                    causal, kv):
    """float32 at head dims 64 and 128 (every diffusion call) takes the
    3xTF32 tensor-core route and holds the float32 tolerance."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(g, (B, Sq, H, D), cuda, dtype)
    k = _randn(g, (B, Sk, KH, D), cuda, dtype)
    v = _randn(g, (B, Sk, KH, D), cuda, dtype)
    way = tflash.route(dtype, D)
    if dtype == torch.float32:
        assert way == ("tf32x3" if D in (64, 128) else "cuda_core")
    before = tflash.flash_attention.launches
    routes = dict(tflash.flash_attention.route_launches)
    got = tflash.flash_attention(q, k, v, causal=causal, kv_len=kv)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    assert tflash.flash_attention.route_launches == {**routes,
                                                     way: routes[way] + 1}
    assert torch.isfinite(got).all()
    want = ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, want, **FA_TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,kv", [
    (4, 512, 512, 32, 4, 128, True, None),    # Yi-9B prefill, G = 8
    (4, 512, 512, 32, 8, 128, True, None),    # Jamba prefill, G = 4
    (2, 200, 200, 4, 4, 64, True, None),      # causal G = 1, ragged tiles
    (2, 333, 333, 16, 2, 128, True, None),    # causal G = 8, ragged
    (1, 2049, 2049, 8, 2, 64, True, None),    # Sq = 2049
    (3, 1, 77, 8, 1, 128, False, None),       # Sq = 1, MQA, Sk < a tile
    (2, 190, 300, 4, 2, 128, False, 250),     # kv_len < Sk, ragged Sk
    (2, 300, 300, 8, 8, 64, True, 260),       # causal and kv_len
])
def test_flash_wgmma_kernel_matches_plain(cuda, B, Sq, Sk, H, KH, D, causal,
                                          kv):
    """bfloat16 at head dims 64 and 128 takes the tensor-core kernel and
    meets the standing bf16 tolerance, P rounded to bf16 included."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q = _randn(g, (B, Sq, H, D), cuda, torch.bfloat16)
    k = _randn(g, (B, Sk, KH, D), cuda, torch.bfloat16)
    v = _randn(g, (B, Sk, KH, D), cuda, torch.bfloat16)
    before = dict(tflash.flash_attention.route_launches)
    got = tflash.flash_attention(q, k, v, causal=causal, kv_len=kv)
    torch.cuda.synchronize()
    assert tflash.flash_attention.route_launches == {
        **before, "wgmma": before["wgmma"] + 1}
    want = ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **FA_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype,D,way", [(torch.float32, 128, "tf32x3"),
                                         (torch.float32, 64, "tf32x3"),
                                         (torch.float32, 32, "cuda_core"),
                                         (torch.float32, 16, "cuda_core"),
                                         (torch.bfloat16, 32, "cuda_core"),
                                         (torch.bfloat16, 16, "cuda_core")])
def test_flash_cuda_core_route_keeps_the_rest(cuda, dtype, D, way):
    """float32 at head dims 64 and 128 goes to tf32x3; head dims 16 and
    32 stay on CUDA cores in both dtypes."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q = _randn(g, (2, 70, 4, D), cuda, dtype)
    k = _randn(g, (2, 90, 2, D), cuda, dtype)
    before = dict(tflash.flash_attention.route_launches)
    got = tflash.flash_attention(q, k, k, causal=False)
    torch.cuda.synchronize()
    assert tflash.route(dtype, D) == way
    assert tflash.flash_attention.route_launches == {
        **before, way: before[way] + 1}
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, k,
                                                            causal=False),
                               **FA_TOL[dtype])


def test_flash_wgmma_repeats_on_cached_tensor_maps(cuda):
    """The tensor maps are cached by pointer and shape: a second call on
    the same tensors, and a call on new tensors of the same shape, give
    the plain version's output."""
    g = torch.Generator(device=cuda).manual_seed(14)
    shp = (2, 256, 8, 128), (2, 256, 2, 128)
    for _ in range(2):
        q = _randn(g, shp[0], cuda, torch.bfloat16)
        k = _randn(g, shp[1], cuda, torch.bfloat16)
        v = _randn(g, shp[1], cuda, torch.bfloat16)
        want = ref.flash_attention_ref(q, k, v)
        for _ in range(2):
            torch.testing.assert_close(tflash.flash_attention(q, k, v), want,
                                       **FA_TOL[torch.bfloat16])


def test_flash_wgmma_one_q_against_many_fresh_kv(cuda):
    """One q, held alive, against 12 fresh k/v pairs: the cached maps
    wrap (16 slots), so a k or v miss evicts the slot of q's map in the
    very call that found q there; each call must still read q, k and v
    through their own maps."""
    g = torch.Generator(device=cuda).manual_seed(17)
    q = _randn(g, (2, 256, 8, 128), cuda, torch.bfloat16)
    kvs = []
    for _ in range(12):
        k = _randn(g, (2, 256, 2, 128), cuda, torch.bfloat16)
        v = _randn(g, (2, 256, 2, 128), cuda, torch.bfloat16)
        kvs.append((k, v))       # kept alive: every pointer is new
        torch.testing.assert_close(tflash.flash_attention(q, k, v),
                                   ref.flash_attention_ref(q, k, v),
                                   **FA_TOL[torch.bfloat16])


@pytest.mark.parametrize("shape,groups,act", [
    ((8, 64, 64, 128), 8, True),      # UNet top level
    ((8, 16, 16, 1024), 8, True),     # UNet bottom, widest
    ((8, 16, 16, 512), 8, False),     # attention pre-norm
    ((8, 32, 32, 24), 8, True),       # discriminator stem
    ((8, 4, 4, 384), 8, True),        # discriminator, ragged channel block
    ((3, 6, 6, 10), 8, True),         # group shrink 10 -> 5
    ((5, 8, 24), 4, False),           # pre-flattened (B, HW, C)
    ((8, 64, 64, 384), 8, True),      # the widest slice: cluster of 8
    ((8, 16, 16, 512), 8, True),      # cluster of 2
    ((4, 32, 32, 512), 8, True),      # cluster of 4
    ((2, 128, 128, 512), 8, True),    # over 8 x 227 KB: reread
    ((1, 300, 7, 40), 1, False),      # one group, ragged cluster rows
])
def test_groupnorm_kernel_matches_plain(cuda, shape, groups, act):
    """Every planner mode and cluster size (1, 2, 4, 8; resident and
    reread; 16- and 4-byte copies) against the plain version."""
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


def test_groupnorm_plans_cover_every_mode(cuda):
    """The shapes above reach every cluster size and both modes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = [tgn.plan(shape, 8, sms) for shape in (
        (8, 32, 32, 24), (8, 16, 16, 512), (4, 32, 32, 512),
        (8, 64, 64, 384), (2, 128, 128, 512))]
    assert {p.cluster for p in plans} == {1, 2, 4, 8}
    assert {p.mode for p in plans} == {"resident", "reread"}
    assert {p.vec for p in plans} == {1, 4}


@pytest.mark.parametrize("shape,scale_x,shift", [
    ((8, 64, 64, 128), 1e4, 3e4),     # large |x| around a large mean
    ((8, 16, 16, 512), 3e3, -1e5),
    ((2, 128, 128, 512), 1e4, 0.0),   # reread mode
])
def test_groupnorm_large_values_stay_finite(cuda, shape, scale_x, shift):
    """Two-pass statistics at large |x| and a SiLU pushed past exp's
    range (biases to about -200 and 200): no NaN or Inf, and the plain
    version's output."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = _randn(g, shape, cuda) * scale_x + shift
    s = torch.rand(shape[-1], generator=g, device=cuda) * 4 + 0.5
    b = torch.randn(shape[-1], generator=g, device=cuda) * 50
    got = tgn.fused_groupnorm(x, s, b, groups=8, act=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, ref.groupnorm_silu_ref(x, s, b, groups=8, act=True), **GN_TOL)


def test_groupnorm_unaligned_view_takes_4_byte_copies(cuda):
    """A view one float into its storage is not 16-byte aligned: the
    kernel copies 4 bytes at a time and gives the same output."""
    g = torch.Generator(device=cuda).manual_seed(6)
    flat = _randn(g, (1 + 4 * 16 * 16 * 64,), cuda)
    x = flat[1:].view(4, 16, 16, 64)
    s = torch.rand(64, generator=g, device=cuda) + 0.5
    b = torch.randn(64, generator=g, device=cuda)
    assert x.data_ptr() % 16 and tgn.plan(x.shape, 8, 132).vec == 4
    torch.testing.assert_close(
        tgn.fused_groupnorm(x, s, b, groups=8),
        ref.groupnorm_silu_ref(x, s, b, groups=8), **GN_TOL)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)          # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="kv_len"):
        tflash.flash_attention(q, q, q, kv_len=9)
    # the TMA route takes 16-byte aligned tensors only
    flat = torch.zeros(1 + 8 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(q, q, q)
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
    z = dict(dtype=torch.float32, device=cuda)
    ops.mlstm_chunk(q, q, q, q[..., 0], q[..., 1], torch.zeros(1, 2, 16, 16,
                                                               **z),
                    torch.zeros(1, 2, 16, **z), torch.zeros(1, 2, **z))
    u = torch.randn(1, 8, 32, device=cuda)
    ops.mamba_scan(u, u.abs(), -torch.ones(32, 4, **z), q[..., 0, :4],
                   q[..., 1, :4], torch.ones(32, **z),
                   torch.zeros(1, 32, 4, **z))
    assert ops.launch_counts() == {"flash_attention": 1,
                                   "fused_groupnorm": 1,
                                   "decode_attention": 1,
                                   "fused_rmsnorm": 1, "swiglu": 1,
                                   "mlstm_chunk": 1, "mamba_scan": 1}


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
                                   "fused_rmsnorm": 0, "swiglu": 0,
                                   "mlstm_chunk": 0, "mamba_scan": 0}
    b = apply_unet(p, cfg, x, t, toks, impl="unfused")
    torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-5)


# ---------------------------------------------------------------------------
# The LM kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,D,T,valid", [
    (4, 32, 4, 128, 1024, (513, 520, 530, 544)),   # Yi-9B served decode
    (4, 32, 8, 128, 1024, (513, 520, 530, 544)),   # Jamba, KH 8, G 4
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
@pytest.mark.parametrize("G,D", [(1, 128), (8, 128), (16, 64)])
def test_decode_split_kernel_edge_valid_lens(cuda, dtype, G, D):
    """valid_len 0, 1, 63, 64, 65 and T in one batch, T = 1000 not a
    multiple of the 64-row tile: the cache is split 8 ways (128 rows a
    split), so short sequences leave whole blocks of their cluster
    empty; sequences with no live row get zeros."""
    B, T, KH = 6, 1000, 2
    valid = (0, 1, 63, 64, 65, T)
    assert tdecode.plan_splits(T, B * KH,
                               torch.cuda.get_device_properties(cuda)
                               .multi_processor_count)[0] > 1
    g = torch.Generator(device=cuda).manual_seed(15)
    q = _randn(g, (B, KH * G, D), cuda, dtype)
    k = _randn(g, (B, T, KH, D), cuda, dtype)
    v = _randn(g, (B, T, KH, D), cuda, dtype)
    # rows at or past valid_len are never read: NaN there changes nothing
    dead = torch.arange(T, device=cuda)[None, :] >= torch.tensor(
        valid, device=cuda)[:, None]
    k[dead], v[dead] = float("nan"), float("nan")
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    before = tdecode.decode_attention.launches
    got = tdecode.decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert tdecode.decode_attention.launches == before + 1
    assert torch.isfinite(got).all() and not got[0].any()
    want = ref.decode_attention_ref(q, k.nan_to_num(), v.nan_to_num(), vl)
    torch.testing.assert_close(got, want, **FA_TOL[dtype])


def test_decode_split_kernel_on_two_streams_at_once(cuda):
    """Calls queued on two streams at once share no scratch: the splits
    combine inside each launch's clusters."""
    g = torch.Generator(device=cuda).manual_seed(16)
    runs = []
    for valid in ((513, 520, 530, 544), (1, 1000, 64, 0)):
        q = _randn(g, (4, 32, 128), cuda, torch.bfloat16)
        k = _randn(g, (4, 1024, 4, 128), cuda, torch.bfloat16)
        v = _randn(g, (4, 1024, 4, 128), cuda, torch.bfloat16)
        runs.append((q, k, v, torch.tensor(valid, dtype=torch.int32,
                                           device=cuda)))
    wants = [ref.decode_attention_ref(*r) for r in runs]
    streams = [torch.cuda.Stream(cuda) for _ in runs]
    torch.cuda.synchronize()
    got = []
    for s, r in zip(streams, runs):
        with torch.cuda.stream(s):
            got.append([tdecode.decode_attention(*r) for _ in range(8)])
    torch.cuda.synchronize()
    for outs, want in zip(got, wants):
        for o in outs:
            torch.testing.assert_close(o, want, **FA_TOL[torch.bfloat16])


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
        lp, cache, _ = forward(p, cfg, toks[:, :19], cache=cache,
                            mode="prefill")
        ld, _, _ = forward(p, cfg, toks[:, 19:], cache=cache, cache_index=19,
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


def _chunked(cfg, p, toks, index, device):
    """Logits of ``toks[:, 4:]`` prefilled as a chunk at ``index`` after
    ``toks[:, :4]``."""
    cache = init_cache(cfg, toks.shape[0], 32, device)
    forward(p, cfg, toks[:, :4], cache=cache, mode="prefill")
    return forward(p, cfg, toks[:, 4:], cache=cache, cache_index=index,
                   mode="prefill")[0]


def test_float32_chunk_takes_the_tf32x3_offset_route(cuda, monkeypatch):
    """A float32 prompt chunk at an int cache_index > 0 (head dim 128)
    runs the tf32x3 kernel's offset instantiation, and its logits equal
    those with every ``ops`` function swapped for its plain version."""
    cfg, p = _lm(cuda)
    g = torch.Generator(device=cuda).manual_seed(10)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g,
                         device=cuda)
    ops.reset_launch_counts()
    got = _chunked(cfg, p, toks, 4, cuda)
    assert ops.offset_launches("tf32x3") == cfg.num_layers
    for name, plain in ops.PLAIN.items():
        monkeypatch.setattr(ops, name, plain)
    want = _chunked(cfg, p, toks, 4, cuda)
    torch.testing.assert_close(got, want, **FA_TOL[torch.float32])


def test_tensor_cache_index_chunk_takes_the_position_route(cuda,
                                                           monkeypatch):
    """A prompt chunk at a 0-d device cache_index runs flash's position
    route over the whole cache, with nothing read on the host (CUDA's
    sync debug mode raises on a synchronising call), and gives the
    logits of the same chunk at the int index (the offset route) and of
    the plain versions."""
    cfg, p = _lm(cuda)
    g = torch.Generator(device=cuda).manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g,
                         device=cuda)
    index = torch.tensor(4, device=cuda)
    cache = init_cache(cfg, 2, 32, cuda)
    forward(p, cfg, toks[:, :4], cache=cache, mode="prefill")
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = forward(p, cfg, toks[:, 4:], cache=cache, cache_index=index,
                      mode="prefill")[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.position_launches("tf32x3") == cfg.num_layers
    at_int = _chunked(cfg, p, toks, 4, cuda)
    torch.testing.assert_close(got, at_int, **FA_TOL[torch.float32])
    for name, plain in ops.PLAIN.items():
        monkeypatch.setattr(ops, name, plain)
    want = _chunked(cfg, p, toks, index, cuda)
    torch.testing.assert_close(got, want, **FA_TOL[torch.float32])


@pytest.mark.parametrize("B,Sq,T,H,KH,D,q_off", [
    (4, 128, 512, 28, 4, 128, 384),   # qwen2-vl's last chunk, G = 7
    (4, 128, 512, 28, 4, 128, 128),   # its second chunk
    (2, 200, 640, 8, 2, 64, 333),     # ragged Sq, D 64
    (1, 1, 64, 8, 8, 128, 17),        # one query row
    (3, 130, 300, 9, 3, 64, 170),     # smollm's G = 3, two query tiles
])
def test_flash_wgmma_offset_route_matches_plain(cuda, B, Sq, T, H, KH, D,
                                                q_off):
    """The wgmma route with a query offset: query row r at q_off + r
    against a cache of T rows, kv_len = q_off + Sq, against the plain
    version; its launches count on wgmma and as offset launches."""
    g = torch.Generator(device=cuda).manual_seed(31)
    q = _randn(g, (B, Sq, H, D), cuda, torch.bfloat16)
    k = _randn(g, (B, T, KH, D), cuda, torch.bfloat16)
    v = _randn(g, (B, T, KH, D), cuda, torch.bfloat16)
    before = dict(tflash.flash_attention.route_launches)
    off = tflash.flash_attention.offset_launches
    got = tflash.flash_attention(q, k, v, causal=True, kv_len=q_off + Sq,
                                 q_offset=q_off)
    torch.cuda.synchronize()
    assert tflash.flash_attention.route_launches == {
        **before, "wgmma": before["wgmma"] + 1}
    assert tflash.flash_attention.offset_launches == off + 1
    want = ref.flash_attention_ref(q, k, v, causal=True, kv_len=q_off + Sq,
                                   q_offset=q_off)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **FA_TOL[torch.bfloat16])


def test_chunked_prefill_takes_the_offset_route(cuda):
    """A bf16 LM (head dim 128, G = 4): a prompt prefilled in 4 chunks
    gives the one-shot prefill's logits, the later chunks on the wgmma
    route's offset."""
    cfg, p = _lm(cuda, dtype="bfloat16")
    g = torch.Generator(device=cuda).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=g,
                         device=cuda)
    one = init_cache(cfg, 2, 256, cuda)
    full, _, _ = forward(p, cfg, toks, cache=one, mode="prefill")
    cache = init_cache(cfg, 2, 256, cuda)
    ops.reset_launch_counts()
    for start in range(0, 256, 64):
        got, _, _ = forward(p, cfg, toks[:, start:start + 64], cache=cache,
                            cache_index=start, mode="prefill")
    assert ops.offset_launches() == 3 * cfg.num_layers
    assert ops.route_counts()["wgmma"] == 4 * cfg.num_layers
    torch.testing.assert_close(got[:, -1].float(), full[:, -1].float(),
                               atol=5e-2, rtol=5e-2)
    # the same rows of K; each chunk's projection is its own matmul
    torch.testing.assert_close(cache[0]["k"], one[0]["k"],
                               **FA_TOL[torch.bfloat16])


def _positions(kind, B, Sq, kv, device):
    """int32 (B, Sq) query positions: ``zeros`` an image prompt under
    M-RoPE (every patch at t = 0), ``grid_text`` an image then text
    tokens, ``random`` any in [0, kv + 9], ``slots`` the chunk's own
    slots (kv - Sq + row: the offset route's mask)."""
    r = torch.arange(Sq, device=device, dtype=torch.int32)
    if kind == "zeros":
        pos = torch.zeros(Sq, dtype=torch.int32, device=device)
    elif kind == "grid_text":
        pos = torch.where(r < Sq // 2, 0, r - Sq // 2 + 7).to(torch.int32)
    elif kind == "slots":
        pos = r + (kv - Sq)
    else:
        g = torch.Generator(device=device).manual_seed(5)
        return torch.randint(0, kv + 10, (B, Sq), generator=g,
                             device=device, dtype=torch.int32)
    return pos.expand(B, Sq).contiguous()


@pytest.mark.parametrize("B,Sq,T,H,KH,D,kv,kind", [
    (4, 512, 512, 28, 4, 128, 512, "zeros"),     # qwen2-vl's image prompt
    (4, 128, 512, 28, 4, 128, 256, "zeros"),     # a chunk of it, cached
    (2, 200, 640, 8, 2, 64, 640, "grid_text"),   # ragged Sq, D 64
    (3, 130, 300, 9, 3, 64, 300, "random"),      # smollm's G = 3
    (2, 256, 384, 8, 2, 128, 384, "slots"),      # = the offset route
])
def test_flash_wgmma_position_route_matches_plain(cuda, B, Sq, T, H, KH, D,
                                                  kv, kind):
    """The wgmma route with a query-position tensor: row r of sequence b
    masks keys past q_positions[b, r] (and at or past kv_len), against
    the plain version; a tile whose rows all sit at t = 0 still sees key
    0. Its launches count on wgmma and as position launches. At the
    slots it equals the offset route."""
    g = torch.Generator(device=cuda).manual_seed(37)
    q = _randn(g, (B, Sq, H, D), cuda, torch.bfloat16)
    k = _randn(g, (B, T, KH, D), cuda, torch.bfloat16)
    v = _randn(g, (B, T, KH, D), cuda, torch.bfloat16)
    pos = _positions(kind, B, Sq, kv, cuda)
    before = dict(tflash.flash_attention.route_launches)
    n_pos = tflash.flash_attention.position_launches
    got = tflash.flash_attention(q, k, v, causal=True, kv_len=kv,
                                 q_positions=pos)
    torch.cuda.synchronize()
    assert tflash.flash_attention.route_launches == {
        **before, "wgmma": before["wgmma"] + 1}
    assert tflash.flash_attention.position_launches == n_pos + 1
    want = ref.flash_attention_ref(q, k, v, causal=True, kv_len=kv,
                                   q_positions=pos)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **FA_TOL[torch.bfloat16])
    if kind == "slots":
        off = tflash.flash_attention(q, k, v, causal=True, kv_len=kv,
                                     q_offset=kv - Sq)
        torch.testing.assert_close(got, off, rtol=0, atol=0)


@pytest.mark.parametrize("B,Sq,T,H,KH,D,q_off", [
    (4, 128, 512, 28, 4, 128, 128),   # qwen2-vl's chunk shape, float32
    (4, 128, 512, 28, 4, 128, 256),
    (4, 128, 512, 28, 4, 128, 384),
    (2, 200, 640, 8, 2, 64, 333),     # ragged Sq, D 64
    (1, 1, 64, 8, 8, 128, 17),        # one query row
    (3, 130, 300, 9, 3, 64, 170),     # G = 3, ragged tiles
    (2, 100, 400, 8, 2, 32, 250),     # cuda_core
    (1, 70, 90, 4, 4, 16, 20),        # cuda_core, one tile
])
def test_flash_float32_offset_matches_plain(cuda, B, Sq, T, H, KH, D, q_off):
    """The float32 routes with a query offset (tf32x3's offset
    instantiation at head dims 64/128, cuda_core's mask at 16/32): query
    row r at q_off + r against a cache of T rows, kv_len = q_off + Sq,
    against the plain version; launches count on the route and as offset
    launches there."""
    g = torch.Generator(device=cuda).manual_seed(41)
    q = _randn(g, (B, Sq, H, D), cuda)
    k = _randn(g, (B, T, KH, D), cuda)
    v = _randn(g, (B, T, KH, D), cuda)
    way = tflash.route(torch.float32, D)
    assert way == ("tf32x3" if D in (64, 128) else "cuda_core")
    ops.reset_launch_counts()
    got = tflash.flash_attention(q, k, v, causal=True, kv_len=q_off + Sq,
                                 q_offset=q_off)
    torch.cuda.synchronize()
    assert ops.offset_launches(way) == ops.route_counts()[way] == 1
    want = ref.flash_attention_ref(q, k, v, causal=True, kv_len=q_off + Sq,
                                   q_offset=q_off)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **FA_TOL[torch.float32])


@pytest.mark.parametrize("B,Sq,T,H,KH,D,kv,kind", [
    (4, 512, 512, 28, 4, 128, 512, "zeros"),     # an image prompt at t = 0
    (4, 128, 512, 28, 4, 128, 256, "grid_text"),  # a grid-then-text chunk
    (2, 200, 640, 8, 2, 64, 640, "grid_text"),   # ragged Sq, D 64
    (3, 130, 300, 9, 3, 64, 260, "random"),      # past kv_len - 1 too
    (2, 256, 384, 8, 2, 128, 384, "slots"),      # = the offset route
    (2, 64, 200, 8, 2, 32, 150, "random"),       # cuda_core
    (1, 90, 90, 4, 4, 16, 90, "zeros"),          # cuda_core at t = 0
])
def test_flash_float32_positions_match_plain(cuda, B, Sq, T, H, KH, D, kv,
                                             kind):
    """The float32 routes with a query-position tensor: row r of sequence
    b masks keys past q_positions[b, r] and at or past kv_len (rows at
    t = 0 see key 0 only; random positions run past kv_len - 1), against
    the plain version; launches count on the route and as position
    launches there. At the slots it equals the offset route."""
    g = torch.Generator(device=cuda).manual_seed(43)
    q = _randn(g, (B, Sq, H, D), cuda)
    k = _randn(g, (B, T, KH, D), cuda)
    v = _randn(g, (B, T, KH, D), cuda)
    pos = _positions(kind, B, Sq, kv, cuda)
    way = tflash.route(torch.float32, D)
    ops.reset_launch_counts()
    got = tflash.flash_attention(q, k, v, causal=True, kv_len=kv,
                                 q_positions=pos)
    torch.cuda.synchronize()
    assert ops.position_launches(way) == ops.route_counts()[way] == 1
    want = ref.flash_attention_ref(q, k, v, causal=True, kv_len=kv,
                                   q_positions=pos)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **FA_TOL[torch.float32])
    if kind == "slots":
        off = tflash.flash_attention(q, k, v, causal=True, kv_len=kv,
                                     q_offset=kv - Sq)
        torch.testing.assert_close(got, off, rtol=0, atol=0)


def test_flash_position_route_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=cuda)
    for bad in (torch.zeros(1, 8, dtype=torch.int64, device=cuda),
                torch.zeros(1, 7, dtype=torch.int32, device=cuda),
                torch.zeros(1, 8, dtype=torch.int32)):
        with pytest.raises(ValueError, match="q_positions"):
            tflash.flash_attention(q, k, k, q_positions=bad)
    # float32 at the slots is the same-position mask: taken
    slots = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    out = tflash.flash_attention(q.float(), k.float(), k.float(),
                                 q_positions=slots)
    assert torch.isfinite(out).all()


def test_lm_under_mrope_image_positions_matches_plain_on_cuda(cuda,
                                                              monkeypatch):
    """A bf16 M-RoPE LM (head dim 128) prefilled with an image grid at
    t = 0 and decoded at t below its slot: the kernels (flash's position
    route, decode attention at valid_len = t + 1) against the plain
    versions, logits within the bf16 tolerance."""
    cfg, p = _lm(cuda, dtype="bfloat16", rope="mrope",
                 mrope_sections=(16, 24, 24), num_position_dims=3)
    B, S = 2, 64
    g = torch.Generator(device=cuda).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=cuda)
    r = torch.arange(S, device=cuda)
    pos = torch.stack([0 * r, r // 8, r % 8])[:, None].expand(3, B, S)
    step = torch.full((3, B, 1), 8, device=cuda)

    def run():
        cache = init_cache(cfg, B, S + 1, cuda)
        lp, cache, _ = forward(p, cfg, toks[:, :S], positions=pos,
                               cache=cache, mode="prefill")
        ld, _, _ = forward(p, cfg, toks[:, S:], positions=step, cache=cache,
                           cache_index=S, mode="decode")
        return lp.float(), ld.float()
    ops.reset_launch_counts()
    got = run()
    assert ops.position_launches() == cfg.num_layers
    assert ops.launch_counts()["decode_attention"] == cfg.num_layers
    for name, plain in ops.PLAIN.items():
        monkeypatch.setattr(ops, name, plain)
    want = run()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# The recurrent kernels (xLSTM and Jamba slices)
# ---------------------------------------------------------------------------
REC_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _mlstm_inputs(g, cuda, dtype, B, T, H, dk, dv, warm):
    """q, k (k pre-scaled by dk^-1/2, as the model does), v, gates, and a
    state: zeros with m = -inf, or (``warm``) one reached mid-sequence."""
    q = _randn(g, (B, T, H, dk), cuda, dtype)
    k = (_randn(g, (B, T, H, dk), cuda) * dk ** -0.5).to(dtype)
    v = _randn(g, (B, T, H, dv), cuda, dtype)
    ip = _randn(g, (B, T, H), cuda)
    fp = _randn(g, (B, T, H), cuda) + 2.0
    z = dict(dtype=torch.float32, device=cuda)
    C, n = torch.zeros(B, H, dk, dv, **z), torch.zeros(B, H, dk, **z)
    m = torch.full((B, H), float("-inf"), **z)
    if warm:
        C = _randn(g, (B, H, dk, dv), cuda) * 0.3
        n = _randn(g, (B, H, dk), cuda).abs() + 0.1
        m = _randn(g, (B, H), cuda)
    return q, k, v, ip, fp, C, n, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,dk,dv,warm", [
    (4, 512, 4, 384, 384, False),   # xlstm-125m prefill: dh 384, m = -inf
    (4, 1, 4, 384, 384, True),      # decode: one step, mid-sequence state
    (2, 13, 2, 384, 384, True),     # T not a multiple of the 32-step chunk
    (3, 21, 2, 100, 72, False),     # dk, dv not multiples of the tiles
    (2, 16, 2, 8, 8, True),         # the JAX kernel test's widths
    (3, 1, 2, 100, 72, True),       # decode, ragged: a cluster of 6
    (2, 1, 2, 16, 6, True),         # decode, dv not a multiple of 4
    (1, 70, 1, 384, 384, True),     # prefill from a mid-sequence state
])
def test_mlstm_kernel_matches_plain(cuda, dtype, B, T, H, dk, dv, warm):
    """Both routes: ``recurrent`` for one step, ``chunkwise`` else."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, ip, fp, C, n, m = _mlstm_inputs(g, cuda, dtype, B, T, H, dk,
                                             dv, warm)
    want_state = [t.clone() for t in (C, n, m)]
    before = tmlstm.mlstm_chunk.launches
    way = tmlstm.route(T)
    before_way = tmlstm.mlstm_chunk.route_launches[way]
    got = tmlstm.mlstm_chunk(q, k, v, ip, fp, C, n, m)
    torch.cuda.synchronize()
    assert tmlstm.mlstm_chunk.launches == before + 1
    assert tmlstm.mlstm_chunk.route_launches[way] == before_way + 1
    want = ref.mlstm_chunk_ref(q, k, v, ip, fp, *want_state)
    assert got.dtype == dtype and got.shape == v.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **REC_TOL[dtype])
    for a, b in zip((C, n, m), want_state):
        torch.testing.assert_close(a, b, **REC_TOL[torch.float32])


def test_mlstm_kernel_runs_back_to_back_from_its_own_state(cuda):
    """Prefill then decode steps on one state equal the plain version
    over the same sequence in one call: the kernel's final n and m (the
    last block's write) are the next launch's initial state."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, ip, fp, C, n, m = _mlstm_inputs(g, cuda, torch.float32, 2, 24,
                                             4, 384, 384, False)
    want_state = [t.clone() for t in (C, n, m)]
    want = ref.mlstm_chunk_ref(q, k, v, ip, fp, *want_state)
    parts = []
    for sl in [slice(0, 20)] + [slice(t, t + 1) for t in range(20, 24)]:
        x = [t[:, sl].contiguous() for t in (q, k, v, ip, fp)]
        parts.append(tmlstm.mlstm_chunk(*x, C, n, m))
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(parts, 1), want,
                               **REC_TOL[torch.float32])
    for a, b in zip((C, n, m), want_state):
        torch.testing.assert_close(a, b, **REC_TOL[torch.float32])


def test_mlstm_kernel_on_two_streams_at_once(cuda):
    """Launches queued on two streams at once each keep their own arrival
    counters: both final states (n and m, written by the last block to
    arrive) equal the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(10)
    runs = [_mlstm_inputs(g, cuda, torch.float32, 4, 64, 4, 384, 384, False)
            for _ in range(2)]
    wants = []
    for q, k, v, ip, fp, C, n, m in runs:
        state = [t.clone() for t in (C, n, m)]
        wants.append((ref.mlstm_chunk_ref(q, k, v, ip, fp, *state), state))
    streams = [torch.cuda.Stream(cuda) for _ in runs]
    torch.cuda.synchronize()
    got = []
    for s, x in zip(streams, runs):
        with torch.cuda.stream(s):
            got.append(tmlstm.mlstm_chunk(*x))
    torch.cuda.synchronize()
    for h, x, (want, state) in zip(got, runs, wants):
        torch.testing.assert_close(h, want, **REC_TOL[torch.float32])
        for a, b in zip(x[5:], state):
            torch.testing.assert_close(a, b, **REC_TOL[torch.float32])


def _mamba_inputs(g, cuda, Bt, T, E, N, dtypes, warm):
    """u, dt, A, B, C, D, h with u/dt/B/C in ``dtypes``; B and C are
    column slices of one projection, as the model hands them over."""
    du, ddt, db, dc = dtypes
    u = (_randn(g, (Bt, T, E), cuda) * 0.5).to(du)
    dt = (torch.nn.functional.softplus(_randn(g, (Bt, T, E), cuda))
          * 0.1).to(ddt)
    A = -_randn(g, (E, N), cuda).abs()
    proj = _randn(g, (Bt, T, 5 + 2 * N), cuda) * 0.3
    Bm, Cm = proj[..., 5:5 + N].to(db), proj[..., 5 + N:].to(dc)
    D = torch.ones(E, device=cuda)
    h = _randn(g, (Bt, E, N), cuda) if warm else \
        torch.zeros(Bt, E, N, device=cuda)
    return u, dt, A, Bm, Cm, D, h


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("Bt,T,E,N,dtypes,warm", [
    (4, 512, 8192, 16, (BF16, F32, BF16, BF16), False),  # Jamba prefill
    (4, 1, 8192, 16, (BF16, F32, BF16, BF16), True),     # decode, mid state
    (2, 45, 300, 16, (F32, F32, F32, F32), True),        # ragged T and E
    (1, 32, 16, 4, (F32, F32, F32, F32), False),         # JAX kernel test
    (2, 64, 32, 8, (BF16, BF16, F32, BF16), True),       # mixed dtypes
    (3, 1, 300, 16, (F32, BF16, BF16, F32), True),       # decode, ragged E
    (2, 1, 32, 8, (BF16, F32, F32, BF16), True),         # decode, N = 8
    (40, 1, 64, 16, (BF16, F32, BF16, BF16), True),      # decode, 40 rows
])
def test_mamba_kernel_matches_plain(cuda, Bt, T, E, N, dtypes, warm):
    """Both routes: ``step`` for one step, ``scan`` else."""
    g = torch.Generator(device=cuda).manual_seed(10)
    u, dt, A, Bm, Cm, D, h = _mamba_inputs(g, cuda, Bt, T, E, N, dtypes,
                                           warm)
    want_h = h.clone()
    before = tmamba.mamba_scan.launches
    way = tmamba.route(T)
    before_way = tmamba.mamba_scan.route_launches[way]
    got = tmamba.mamba_scan(u, dt, A, Bm, Cm, D, h)
    torch.cuda.synchronize()
    assert tmamba.mamba_scan.launches == before + 1
    assert tmamba.mamba_scan.route_launches[way] == before_way + 1
    want = ref.mamba_scan_ref(u, dt, A, Bm, Cm, D, want_h)
    assert got.dtype == u.dtype and got.shape == u.shape
    torch.testing.assert_close(got, want, **REC_TOL[u.dtype])
    torch.testing.assert_close(h, want_h, **REC_TOL[F32])


def test_recurrent_kernels_refuse_what_they_do_not_take(cuda):
    z = dict(dtype=torch.float32, device=cuda)
    q = torch.zeros(1, 4, 2, 400, **z)                       # dk > 384
    g = torch.zeros(1, 4, 2, **z)
    with pytest.raises(ValueError, match="dk"):
        tmlstm.mlstm_chunk(q, q, q, g, g, torch.zeros(1, 2, 400, 400, **z),
                           torch.zeros(1, 2, 400, **z), torch.zeros(1, 2,
                                                                    **z))
    q = torch.zeros(1, 4, 2, 16, **z)
    with pytest.raises(ValueError, match="dv=400"):            # dv > 384
        tmlstm.mlstm_chunk(q, q, torch.zeros(1, 4, 2, 400, **z), g, g,
                           torch.zeros(1, 2, 16, 400, **z),
                           torch.zeros(1, 2, 16, **z), torch.zeros(1, 2,
                                                                   **z))
    with pytest.raises(ValueError, match="k dtype"):          # q, k differ
        tmlstm.mlstm_chunk(q, q.bfloat16(), q, g, g,
                           torch.zeros(1, 2, 16, 16, **z),
                           torch.zeros(1, 2, 16, **z), torch.zeros(1, 2,
                                                                   **z))
    with pytest.raises(ValueError, match="float32"):
        tmlstm.mlstm_chunk(q, q, q, g, g, torch.zeros(1, 2, 16, 16,
                                                      device=cuda).bfloat16(),
                           torch.zeros(1, 2, 16, **z), torch.zeros(1, 2,
                                                                   **z))
    u = torch.zeros(1, 4, 32, **z)
    A, D, h = torch.zeros(32, 20, **z), torch.zeros(32, **z), \
        torch.zeros(1, 32, 20, **z)                          # N > 16
    b = torch.zeros(1, 4, 20, **z)
    with pytest.raises(ValueError, match="N=20"):
        tmamba.mamba_scan(u, u, A, b, b, D, h)
    A, b, h = A[:, :4].contiguous(), b[..., :4], h[..., :4].contiguous()
    with pytest.raises(ValueError, match="u is not contiguous"):
        tmamba.mamba_scan(torch.zeros(1, 8, 32, **z)[:, ::2], u, A, b, b, D,
                          h)
    with pytest.raises(ValueError, match="B is not contiguous"):
        tmamba.mamba_scan(u, u, A, torch.zeros(1, 4, 8, **z)[..., ::2], b,
                          D, h)


def _recurrent_lm(cuda, arch):
    cfg = reduced_config(arch)
    if arch == "xlstm-125m":        # dh 384: the full model's head width
        cfg = dataclasses.replace(cfg, d_model=768, num_heads=4)
    else:                           # N 16, the full model's state size
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, d_state=16))
    return cfg, init_params(cfg, seed=0, device=cuda)


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_recurrent_lm_kernel_path_matches_plain_path(cuda, monkeypatch,
                                                     arch):
    """Reduced xlstm-125m (at dh 384) and Jamba (at N 16) in float32:
    prefill and decode logits through the kernels equal those with every
    ``ops`` function swapped for its plain version, and the recurrent
    kernels ran once per layer of their kind and forward."""
    cfg, p = _recurrent_lm(cuda, arch)
    g = torch.Generator(device=cuda).manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=g,
                         device=cuda)

    def run():
        cache = init_cache(cfg, 2, 32, cuda)
        lp, cache, _ = forward(p, cfg, toks[:, :19], cache=cache,
                            mode="prefill")
        ld, _, _ = forward(p, cfg, toks[:, 19:], cache=cache, cache_index=19,
                        mode="decode")
        return lp, ld
    ops.reset_launch_counts()
    got = run()
    counts = ops.launch_counts()
    kinds = [mixer for mixer, _ in cfg.flat_pattern()]
    assert counts["mlstm_chunk"] == 2 * kinds.count("mlstm")
    assert counts["mamba_scan"] == 2 * kinds.count("mamba")
    for name, plain in ops.PLAIN.items():
        monkeypatch.setattr(ops, name, plain)
    want = run()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The live control loop
# ---------------------------------------------------------------------------
def test_live_control_loop_on_cuda(cuda):
    """A small two-tier cascade behind ``ClusterRuntime`` and
    ``ClusterBackend`` on the card: e(b) measured there feeds the
    planner, every batch runs through the kernels, and the loop
    re-plans; every query is accounted for."""
    from repro_torch.config.base import as_cascade_spec
    from repro_torch.core.cascade import DiffusionCascade
    from repro_torch.models.efficientnet import (DiscriminatorConfig,
                                                 init_discriminator)
    from repro_torch.serving.baselines import make_profiles
    from repro_torch.serving.cluster import ClusterBackend, ClusterRuntime
    from repro_torch.serving.controlplane import build_control_plane
    from repro_torch.serving.profiles import default_serving
    from repro_torch.serving.trace import static_trace
    kw = dict(image_size=16, base_channels=32, channel_mults=(1, 2),
              num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
              text_dim=32)
    stages = [(c, init_unet(c, seed=i, device=cuda)) for i, c in enumerate(
        (DiffusionConfig(name="s0", num_steps=1, **kw),
         DiffusionConfig(name="s1", num_steps=4, **kw)))]
    dcfg = DiscriminatorConfig(in_channels=4)
    casc = DiffusionCascade(stages, dcfg,
                            init_discriminator(dcfg, seed=2, device=cuda),
                            device=cuda, seed=0)
    sv = default_serving("sdturbo", num_workers=3, batch_choices=(1, 2, 4),
                         kernel_impl="fused", batch_buckets=(1, 2, 4, 8))
    rt = ClusterRuntime(casc, sv, device=cuda)
    prof = rt.measure_profile(batches=(1, 2, 4), repeats=1)
    spec = as_cascade_spec(sv.cascade)
    spec = dataclasses.replace(
        spec, tiers=tuple(dataclasses.replace(t, profile=prof[i])
                          for i, t in enumerate(spec.tiers)),
        slo_s=max(10 * prof[-1].base_s, 1.0))
    sv = dataclasses.replace(sv, cascade=spec)
    profiles = make_profiles(sv, 0)
    control = build_control_plane(spec, sv, profiles)
    backend = ClusterBackend(rt, sv, profiles, seed=0, device=cuda)
    ops.reset_launch_counts()
    r = backend.serve(control, static_trace(4.0, 12))
    counts = ops.launch_counts()
    assert r.total > 0
    assert r.completed + r.dropped == r.total
    assert r.completed > 0.5 * r.total
    assert len(backend.plan_timeline) >= 3
    assert counts["fused_groupnorm"] > 0 and counts["flash_attention"] > 0
    assert backend._conf_samples[0]


# ---------------------------------------------------------------------------
# The offline phase: the discriminator's train step and the grad guard
# ---------------------------------------------------------------------------
def test_disc_train_step_on_cuda_matches_cpu(cuda):
    """The full-width discriminator (64x64x4 inputs) on the card against
    the same on the CPU, on the unfused route (no kernel launches): the
    loss and every gradient leaf at the models' 5e-5 (float32 cuDNN
    convolutions, TF32 off, against the CPU's), then one train step's
    parameters at 5e-5 with AdamW's eps at 1e-6, as in
    tests/test_torch_training.py: at the default eps Adam's first step
    moves an element by about lr * sign(g), which no wrong gradient of
    the right sign would show."""
    from repro_torch.models.efficientnet import (DiscriminatorConfig,
                                                 init_discriminator)
    from repro_torch.training.discriminator import (loss_and_grads,
                                                    make_disc_train_step)
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.tree import leaves, map_tree
    cfg = DiscriminatorConfig(in_channels=4)
    p_cpu = init_discriminator(cfg, seed=3, device="cpu")
    p_gpu = map_tree(lambda t: t.to(cuda), p_cpu)
    g = torch.Generator().manual_seed(4)
    x = torch.rand((32, 64, 64, 4), generator=g) * 2 - 1
    y = (torch.arange(32) % 2).to(torch.int32)
    ops.reset_launch_counts()
    lg, ag, gg = loss_and_grads(p_gpu, cfg, x.to(cuda), y.to(cuda))
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == 0
    lc, ac, gc = loss_and_grads(p_cpu, cfg, x, y)
    assert float(lg) == pytest.approx(float(lc), abs=5e-5)
    assert float(ag) == float(ac)
    assert len(leaves(gg)) == len(leaves(gc)) == len(leaves(p_cpu))
    for a, b in zip(leaves(gg), leaves(gc)):
        torch.testing.assert_close(a.cpu(), b, atol=5e-5, rtol=5e-5)
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=20, total_steps=40,
                           weight_decay=1e-4, eps=1e-6)
    init, step = make_disc_train_step(cfg, ocfg)
    pg, _, mg = step(p_gpu, init(p_gpu), x.to(cuda), y.to(cuda))
    pc, _, mc = step(p_cpu, init(p_cpu), x, y)
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), abs=5e-5)
    for a, b in zip(leaves(pg), leaves(pc)):
        torch.testing.assert_close(a.cpu(), b, atol=5e-5, rtol=0)


def test_kernel_wrappers_refuse_grad_on_cuda(cuda):
    """No kernel has a backward: on the card a call autograd would
    differentiate raises and names the unfused route; without grad the
    same call launches."""
    x = torch.randn((2, 8, 8, 16), device=cuda, requires_grad=True)
    scale = torch.ones(16, device=cuda)
    bias = torch.zeros(16, device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="unfused"):
        ops.fused_groupnorm(x, scale, bias, groups=4)
    q = torch.randn((1, 64, 2, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="unfused"):
        ops.flash_attention(q, q.detach(), q.detach(), causal=False)
    assert sum(ops.launch_counts().values()) == 0
    with torch.no_grad():
        ops.fused_groupnorm(x, scale, bias, groups=4)
    assert ops.launch_counts()["fused_groupnorm"] == 1
