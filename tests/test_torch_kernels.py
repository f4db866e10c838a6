"""The port's kernel modules against the JAX package.

Inputs are made with numpy from a seed and go through the JAX kernel
(Pallas in interpret mode, as the JAX package's own tests run it on the
CPU) and through the port's dispatch on CPU tensors, which runs the
kernel's plain PyTorch version. Tolerance 3e-5, the JAX package's kernel
tolerance (5e-2 for bfloat16, as there). The kernels themselves run only
on a CUDA card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
them against the plain versions there.
"""
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import selective_scan as jax_selective_scan
from repro.models.unet import _fused_attn
from repro.models.xlstm import mlstm_scan as jax_mlstm_scan
from repro_torch.kernels import build, impls
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import fused_groupnorm as tgn
from repro_torch.kernels import fused_rmsnorm as trms
from repro_torch.kernels import mamba_scan as tmamba
from repro_torch.kernels import mlstm_chunk as tmlstm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swiglu as tswiglu
from torch_threads import one_thread  # noqa: F401

TOL = dict(atol=3e-5, rtol=3e-5)
REPO = Path(__file__).resolve().parents[1]
NO_LAUNCHES = {"flash_attention": 0, "fused_groupnorm": 0,
               "decode_attention": 0, "fused_rmsnorm": 0, "swiglu": 0,
               "mlstm_chunk": 0, "mamba_scan": 0}


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else TOL


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(a, dtype="float32"):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# GroupNorm(+SiLU): the cases of the JAX package's serving kernel tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,groups,act", [
    ((3, 4, 4, 16), 8, True),     # conv feature map, fused silu
    ((3, 4, 4, 16), 8, False),    # attention pre-norm (no act)
    ((2, 6, 6, 10), 8, True),     # group shrink: 10 % 8 -> g=5
    ((5, 8, 24), 4, True),        # pre-flattened (B, HW, C)
])
def test_groupnorm_matches_jax_kernel(shape, groups, act):
    (x,) = _normal(0, shape)
    s = np.linspace(0.5, 1.5, shape[-1]).astype(np.float32)
    b = np.linspace(-0.2, 0.2, shape[-1]).astype(np.float32)
    want = jops.fused_groupnorm(_jax(x), _jax(s), _jax(b), groups=groups,
                                act=act, impl="interpret")
    got = ops.fused_groupnorm(_torch(x), _torch(s), _torch(b), groups=groups,
                              act=act)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,D,bq,bk", [
    (1, 64, 4, 4, 32, 32, 32),     # MHA
    (2, 128, 4, 2, 32, 64, 64),    # GQA
    (1, 128, 8, 1, 16, 128, 32),   # MQA, uneven blocks
])
def test_flash_attention_causal_matches_jax_kernel(dtype, B, S, H, KH, D,
                                                   bq, bk):
    q, k, v = _normal(1, (B, S, H, D), (B, S, KH, D), (B, S, KH, D))
    want = jops.flash_attention(_jax(q, dtype), _jax(k, dtype),
                                _jax(v, dtype), impl="interpret",
                                block_q=bq, block_k=bk)
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("Sq,Sk,kv", [
    (128, 256, 132),     # padded K/V: mask covers the whole tail block
    (128, 128, 72),      # padding inside a single block
])
def test_flash_attention_kv_len_matches_jax_kernel(Sq, Sk, kv):
    q, k, v = _normal(2, (2, Sq, 2, 16), (2, Sk, 2, 16), (2, Sk, 2, 16))
    want = jops.flash_attention(_jax(q), _jax(k), _jax(v), causal=False,
                                kv_len=kv, impl="interpret")
    got = ops.flash_attention(_torch(q), _torch(k), _torch(v), causal=False,
                              kv_len=kv)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # kv_len means attention over the first kv rows only
    short = ops.flash_attention(_torch(q), _torch(k[:, :kv]),
                                _torch(v[:, :kv]), causal=False)
    np.testing.assert_allclose(_np(got), _np(short), **TOL)


def test_unpadded_sk264_matches_jax_padded_route():
    """The UNet's attention at 16x16 with an 8-token prompt: Sk = 264.
    The JAX route pads Sk to 384 and masks with kv_len=264; the port
    hands the kernel the unpadded K/V."""
    q, k, v = _normal(3, (2, 256, 2, 16), (2, 264, 2, 16), (2, 264, 2, 16))
    want = _fused_attn(_jax(q), _jax(k), _jax(v), "interpret")
    got = ops.flash_attention(_torch(q), _torch(k), _torch(v), causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# The LM kernels: the grids of tests/test_kernels.py, against the JAX
# kernel in interpret mode and the JAX package's jnp oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,D,T,bk", [
    (2, 4, 2, 32, 256, 64),
    (1, 8, 8, 16, 128, 128),
    (3, 6, 1, 64, 192, 64),
])
def test_decode_attention_matches_jax_kernel(dtype, B, H, KH, D, T, bk):
    q, k, v = _normal(7, (B, H, D), (B, T, KH, D), (B, T, KH, D))
    vl = np.random.default_rng(0).integers(1, T + 1, B).astype(np.int32)
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(vl),
                                 impl="interpret", block_k=bk)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(vl))
    got = ops.decode_attention(_torch(q, dtype), _torch(k, dtype),
                               _torch(v, dtype), torch.from_numpy(vl))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


def test_decode_attention_valid_len_zero_gives_zeros():
    """The TPU kernel's ``acc / max(l, 1e-30)`` gives zeros for a
    sequence with no live entry (the jnp oracle gives NaN); the plain
    version follows the kernel."""
    q, k, v = _normal(8, (2, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16))
    vl = np.array([0, 5], np.int32)
    want = jops.decode_attention(_jax(q), _jax(k), _jax(v), jnp.asarray(vl),
                                 impl="interpret", block_k=64)
    got = ops.decode_attention(_torch(q), _torch(k), _torch(v),
                               torch.from_numpy(vl))
    assert not got[0].any()
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _split_decode(q, k, v, valid_len, splits, rows, cover):
    """The decode kernel's split arithmetic in plain torch, fp32: split
    s of each (batch, KV head) takes cache rows [s * rows, (s + 1) *
    rows) cut at valid_len; inside it warp w takes the 16-row chunks w,
    w + 4, ... with its own online softmax; the warps' partials merge
    into the split's, the splits' into the output. ``cover`` (B, T)
    counts the rows each (batch, KV head 0) read."""
    B, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D).float()
    out = torch.zeros(B, KH, G, D)

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(0)
        mu = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        w = [torch.exp(p[0] - mu) for p in parts]
        l = sum(wi * p[1] for wi, p in zip(w, parts))
        acc = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
        return m, l, acc
    for b in range(B):
        valid = min(max(int(valid_len[b]), 0), T)
        for kh in range(KH):
            splits_parts = []
            for s in range(splits):
                r0, r1 = s * rows, min(s * rows + rows, valid)
                n_chunks = math.ceil((r1 - r0) / 16) if r1 > r0 else 0
                warps = []
                for w in range(4):
                    m = torch.full((G,), float("-inf"))
                    l, acc = torch.zeros(G), torch.zeros(G, D)
                    for c in range(w, n_chunks, 4):
                        idx = torch.arange(r0 + 16 * c,
                                           min(r0 + 16 * c + 16, r1))
                        if kh == 0:
                            cover[b, idx] += 1
                        sc = qg[b, kh] @ k[b, idx, kh].float().T \
                            / math.sqrt(D)
                        m_new = torch.maximum(m, sc.amax(-1))
                        mu = torch.where(torch.isinf(m_new),
                                         torch.zeros_like(m_new), m_new)
                        alpha, p = torch.exp(m - mu), torch.exp(
                            sc - mu[:, None])
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + p @ v[b, idx, kh].float()
                        m = m_new
                    warps.append((m, l, acc))
                splits_parts.append(merge(warps))
            _, l, acc = merge(splits_parts)
            out[b, kh] = acc / l.clamp_min(1e-30)[:, None]
    return out.reshape(B, H, D)


@pytest.mark.parametrize("T,sms", [(200, 132), (200, 1), (1000, 8),
                                   (1000, 132)])
def test_decode_split_arithmetic_matches_jax_kernel(T, sms):
    """The split planner the decode wrapper uses, through a plain
    emulation of the kernel's partials and their combine, against the
    JAX kernel at the edge valid_lens: every live row read exactly once,
    no NaN from an empty split, zeros for valid_len = 0."""
    B, KH, G, D = 6, 2, 4, 32
    valid = np.array([0, 1, 63, 64, 65, T], np.int32)
    splits, rows = tdecode.plan_splits(T, B * KH, sms)
    q, k, v = _normal(17, (B, KH * G, D), (B, T, KH, D), (B, T, KH, D))
    want = jops.decode_attention(_jax(q), _jax(k), _jax(v),
                                 jnp.asarray(valid), impl="interpret",
                                 block_k=200)
    cover = torch.zeros(B, T, dtype=torch.int64)
    got = _split_decode(_torch(q), _torch(k), _torch(v), valid, splits,
                        rows, cover)
    live = torch.arange(T)[None, :] < torch.from_numpy(valid)[:, None]
    assert torch.equal(cover, live.long())
    assert torch.isfinite(got).all() and not got[0].any()
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decode_split_plan_covers_the_cache():
    """Splits: 1..8 (a portable cluster), at most one a 64-row tile, rows
    a multiple of 64, every row of T in one split and no split past T;
    more splits where fewer (batch, KV head) pairs fill the card, never
    more than one block an SM once split."""
    for T in (0, 1, 63, 64, 65, 200, 1000, 1024, 33280):
        for pairs in (1, 3, 16, 128, 512, 4096):
            for sms in (1, 8, 132):
                splits, rows = tdecode.plan_splits(T, pairs, sms)
                assert 1 <= splits <= tdecode.MAX_SPLITS
                assert rows % tdecode.TILE_ROWS == 0 and rows > 0
                assert splits * rows >= T
                assert (splits - 1) * rows < max(T, 1)
                assert splits == 1 or splits * pairs <= sms
    # the served decode of Yi-9B (B 4 x KH 4, T 1024) and of Jamba
    # (KH 8), and decode_32k
    assert tdecode.plan_splits(1024, 16, 132) == (8, 128)
    assert tdecode.plan_splits(1024, 32, 132) == (4, 256)
    assert tdecode.plan_splits(33280, 512, 132) == (1, 33280)


def _decode_case(seed, B, H, KH, D, T):
    q, k, v = _normal(seed, (B, H, D), (B, T, KH, D), (B, T, KH, D))
    return _torch(q), _torch(k), _torch(v)


def test_decode_attention_lse_matches_logsumexp():
    """The plain version's log-sum-exp against ``torch.logsumexp`` of the
    scaled, masked scores written out directly: -inf for a sequence with
    no live row; the output is the one without lse, bit for bit, and the
    dispatcher passes both through on the CPU."""
    B, H, KH, D, T = 4, 6, 2, 32, 96
    q, k, v = _decode_case(21, B, H, KH, D, T)
    vl = torch.tensor([0, 1, 40, T], dtype=torch.int32)
    o, lse = ref.decode_attention_ref(q, k, v, vl, with_lse=True)
    kr = k.repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bhd,bthd->bht", q, kr) / math.sqrt(D)
    s = s.masked_fill(torch.arange(T)[None, None, :] >= vl[:, None, None],
                      float("-inf"))
    want = torch.logsumexp(s, dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1:]).all()
    torch.testing.assert_close(lse, want, **TOL)
    assert torch.equal(o, ref.decode_attention_ref(q, k, v, vl))
    o2, lse2 = ops.decode_attention(q, k, v, vl, with_lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_decode_combine_of_row_blocks_matches_whole_cache():
    """``combine_partials`` over the plain version's (output, lse) on 4
    row blocks of the cache, each at its valid_len shifted by
    the block's first row and clipped to its rows (what each model rank
    of a sequence-sharded cache computes), against one call over the
    whole cache and the JAX kernel: a sequence live in the first block
    only, one with valid_len = 0 (zeros, never NaN), one across three
    blocks and one across all."""
    B, H, KH, D, T, blocks = 4, 8, 2, 32, 128, 4
    q, k, v = _decode_case(22, B, H, KH, D, T)
    vl = torch.tensor([20, 0, 77, T], dtype=torch.int32)
    rows = T // blocks
    parts = [ref.decode_attention_ref(
        q, k[:, r * rows:(r + 1) * rows], v[:, r * rows:(r + 1) * rows],
        (vl - r * rows).clamp(0, rows), with_lse=True)
        for r in range(blocks)]
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    assert torch.isneginf(lse[1:, 0]).all()       # live in block 0 only
    got = ref.combine_partials(o, lse, lambda t: t.amax(0, keepdim=True),
                               lambda t: t.sum(0, keepdim=True))[0]
    assert torch.isfinite(got).all() and not got[1].any()
    torch.testing.assert_close(got, ref.decode_attention_ref(q, k, v, vl),
                               **TOL)
    want = jops.decode_attention(_jax(q.numpy()), _jax(k.numpy()),
                                 _jax(v.numpy()), jnp.asarray(vl.numpy()),
                                 impl="interpret", block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_flash_route_follows_dtype_and_head_dim():
    """At head dims 64 and 128 both dtypes take tensor cores (bf16 on
    wgmma, float32 as 3xTF32, every diffusion call); 16 and 32 stay on
    CUDA cores."""
    assert [tflash.route(torch.bfloat16, d) for d in tflash.HEAD_DIMS] == \
        ["cuda_core", "cuda_core", "wgmma", "wgmma"]
    assert [tflash.route(torch.float32, d) for d in tflash.HEAD_DIMS] == \
        ["cuda_core", "cuda_core", "tf32x3", "tf32x3"]
    assert set(tflash.ROUTES) == {"wgmma", "tf32x3", "cuda_core"}


@pytest.mark.parametrize("B,H,Sq,want", [
    (8, 4, 256, 2),      # the UNet at b = 8: 128 blocks of 64 rows
    (4, 4, 256, 4),      # b = 4: 128 blocks of 32 rows
    (2, 4, 256, 8),      # b = 2: 128 blocks of 16 rows
    (1, 4, 256, 8),      # b = 1: 64 blocks of 16 rows, not 16 of 64
    (3, 8, 1, 8),        # Sq = 1: one row a block whatever the split
    (4, 32, 512, 2),     # many (batch, head) pairs
])
def test_flash_tf32_key_groups_fill_the_card(B, H, Sq, want):
    kw = tflash.plan_key_groups(B, H, Sq, 132)
    assert kw == want and kw in tflash.KEY_GROUPS
    blocks = B * H * -(-Sq // (128 // kw))
    # the fewest groups that reach 3/4 of the SMs, where any does
    fewer = [k for k in tflash.KEY_GROUPS if k < kw]
    assert all(B * H * -(-Sq // (128 // k)) < 99 for k in fewer)
    assert blocks >= 99 or kw == tflash.KEY_GROUPS[-1]


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, split):
    """a @ b in float32 from TF32 operands: hi*hi + hi*lo + lo*hi
    (``split``) or hi*hi alone. Each product of two TF32 values is exact
    in float32, as in the tensor core; sums round in float32."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if split:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = ah @ bl + al @ bh + out
    return out


def _attention_tf32(q, k, v, split):
    """The tf32x3 kernel's arithmetic in plain torch (non-causal):
    both products from TF32 operands, softmax and P in float32, P split
    like the others."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    s = _mm(qt, kt.transpose(-1, -2), split) / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _mm(p, vt, split) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.transpose(1, 2)


def test_tf32x3_split_keeps_float32_accuracy_at_the_unet_shape():
    """The UNet's attention (q (8,256,4,128), k/v (8,264,4,128)) through
    the 3xTF32 split against a float64 attention: well inside the float32
    tolerance of 1e-4 (``FLASH_TOL`` in chip_smoke.py). One TF32 product
    alone is not, which is why the kernel takes three."""
    q, k, v = (_torch(a) for a in _normal(
        16, (8, 256, 4, 128), (8, 264, 4, 128), (8, 264, 4, 128)))
    exact = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                    causal=False)
    err3 = (_attention_tf32(q, k, v, True).double() - exact).abs().max()
    err1 = (_attention_tf32(q, k, v, False).double() - exact).abs().max()
    assert err3 < 1e-5, err3
    assert err1 > 1e-4, err1


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64), (4, 16, 96), (2, 3, 5, 128)])
def test_rmsnorm_matches_jax_kernel(shape, dtype, residual):
    x, r = _normal(9, shape, shape)
    s = np.linspace(0.5, 1.5, shape[-1]).astype(np.float32)
    res = _jax(r, dtype) if residual else None
    want = jops.fused_rmsnorm(_jax(x, dtype), _jax(s), residual=res,
                              impl="interpret")
    oracle = jref.rmsnorm_ref(_jax(x, dtype), _jax(s), residual=res)
    got = ops.fused_rmsnorm(_torch(x, dtype), _torch(s),
                            residual=_torch(r, dtype) if residual else None)
    if residual:
        (got, got_sum), (want, want_sum) = got, want
        assert got_sum.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(got_sum), _np(want_sum), **_tol(dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 128), (2, 8, 256), (64, 512)])
def test_swiglu_matches_jax_kernel(shape, dtype):
    g, u = _normal(10, shape, shape)
    want = jops.swiglu(_jax(g, dtype), _jax(u, dtype), impl="interpret")
    oracle = jref.swiglu_ref(_jax(g, dtype), _jax(u, dtype))
    got = ops.swiglu(_torch(g, dtype), _torch(u, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


# ---------------------------------------------------------------------------
# The recurrences: mLSTM and selective scan, state in and state out
# ---------------------------------------------------------------------------
def _mlstm_inputs(seed, B, T, H, dh):
    """The JAX kernel test's distributions: k scaled by dh^-1/2 (as
    ``mlstm_apply`` pre-scales it), forget pre-activations around +2."""
    q, k, v = _normal(seed, (B, T, H, dh), (B, T, H, dh), (B, T, H, dh))
    ip, fp = _normal(seed + 1, (B, T, H), (B, T, H))
    return q, k * dh ** -0.5, v, ip, fp + 2.0


def _mlstm_state(B, H, dk, dv, seed=None):
    """Zeros with m = -inf, or (``seed``) a state reached mid-sequence."""
    if seed is None:
        return (np.zeros((B, H, dk, dv), np.float32),
                np.zeros((B, H, dk), np.float32),
                np.full((B, H), -np.inf, np.float32))
    C, n, m = _normal(seed, (B, H, dk, dv), (B, H, dk), (B, H))
    return C * 0.3, np.abs(n) + 0.1, m


@pytest.mark.parametrize("B,T,H,dh,chunk", [
    (1, 16, 2, 8, 4), (2, 32, 2, 16, 8), (1, 24, 4, 8, 6)])
def test_mlstm_plain_matches_jax_kernel(B, T, H, dh, chunk):
    """From the zero state (m = -inf) the plain version computes what the
    TPU kernel computes (at ``tests/test_kernels.py``'s shapes), and
    leaves the final state in place."""
    q, k, v, ip, fp = _mlstm_inputs(11, B, T, H, dh)
    want = jops.mlstm_chunk(*(_jax(a) for a in (q, k, v, ip, fp)),
                            impl="interpret", chunk=chunk)
    state = [_torch(a) for a in _mlstm_state(B, H, dh, dh)]
    got = ops.mlstm_chunk(*(_torch(a) for a in (q, k, v, ip, fp)), *state)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    _, jstate = jax_mlstm_scan(*(_jax(a) for a in (q, k, v, ip, fp)))
    for name, t in zip("Cnm", state):
        np.testing.assert_allclose(t.numpy(), np.asarray(jstate[name]),
                                   **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,dh", [(2, 9, 2, 16), (1, 1, 4, 8),
                                      (2, 20, 1, 32)])
def test_mlstm_plain_from_state_matches_jax_scan(B, T, H, dh, dtype):
    """From a state reached mid-sequence (T = 1 is one decode step), h
    and the final (C, n, m) equal the JAX package's ``mlstm_scan``; h
    comes back in v's dtype."""
    q, k, v, ip, fp = _mlstm_inputs(12, B, T, H, dh)
    st = _mlstm_state(B, H, dh, dh, seed=13)
    jh, jst = jax_mlstm_scan(*(_jax(a, dtype) for a in (q, k, v)), _jax(ip),
                             _jax(fp), dict(zip("Cnm", (_jax(a)
                                                        for a in st))))
    # torch gets its own copy of the state: ``from_numpy`` would share
    # ``st``'s memory, which the JAX call above may still be reading
    # (asynchronous dispatch) while the kernel overwrites it in place
    state = [_torch(a.copy()) for a in st]
    got = ops.mlstm_chunk(*(_torch(a, dtype) for a in (q, k, v)),
                          _torch(ip), _torch(fp), *state)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(jh), **_tol(dtype))
    for name, t in zip("Cnm", state):
        np.testing.assert_allclose(t.numpy(), np.asarray(jst[name]), **TOL)


def _mamba_inputs(seed, Bt, T, E, N):
    """The JAX kernel test's distributions."""
    u, dt, A, B, C = _normal(seed, (Bt, T, E), (Bt, T, E), (E, N),
                             (Bt, T, N), (Bt, T, N))
    softplus = np.log1p(np.exp(dt))
    return (u * 0.5, (softplus * 0.1).astype(np.float32), -np.abs(A),
            B * 0.3, C * 0.3, np.ones(E, np.float32))


@pytest.mark.parametrize("Bt,T,E,N,chunk", [
    (1, 32, 16, 4, 8), (2, 64, 32, 8, 16), (1, 48, 8, 16, 12)])
def test_mamba_plain_matches_jax_kernel(Bt, T, E, N, chunk):
    """From h = 0 the plain version computes what the TPU kernel computes
    (at ``tests/test_kernels.py``'s shapes), and leaves the final state
    in place."""
    args = _mamba_inputs(14, Bt, T, E, N)
    want = jops.mamba_scan(*(_jax(a) for a in args), impl="interpret",
                           chunk=chunk)
    h = torch.zeros(Bt, E, N)
    got = ops.mamba_scan(*(_torch(a) for a in args), h)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    _, jh = jax_selective_scan(*(_jax(a) for a in args))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,T,E,N", [(2, 11, 24, 8), (3, 1, 16, 16),
                                      (1, 40, 8, 4)])
def test_mamba_plain_from_state_matches_jax_scan(Bt, T, E, N, dtype):
    """From a non-zero state (T = 1 is one decode step), y and the final
    h equal the JAX package's ``selective_scan``, with u, B and C in the
    model's dtype and dt, A, D in float32; y comes back in u's dtype."""
    u, dt, A, B, C, D = _mamba_inputs(15, Bt, T, E, N)
    (h0,) = _normal(16, (Bt, E, N))
    jy, jh = jax_selective_scan(_jax(u, dtype), _jax(dt), _jax(A),
                                _jax(B, dtype), _jax(C, dtype), _jax(D),
                                h0=_jax(h0))
    h = _torch(h0.copy())  # its own copy, as for the mLSTM state above
    got = ops.mamba_scan(_torch(u, dtype), _torch(dt), _torch(A),
                         _torch(B, dtype), _torch(C, dtype), _torch(D), h)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(jy), **_tol(dtype))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


def test_mamba_kernel_takes_column_slices_of_one_projection():
    """B and C come to the kernel as column slices of the model's
    x_proj output, without a copy: the wrapper reads their row stride."""
    proj = torch.zeros(2, 5, 40)
    assert tmamba._row_stride(proj[..., 8:24]) == 40
    assert tmamba._row_stride(proj[:, :1, 8:24]) == 200
    assert tmamba._row_stride(proj.contiguous()) == 40
    assert tmamba._row_stride(proj[..., ::2]) is None
    assert tmamba._row_stride(proj[:, ::2]) is None


# ---------------------------------------------------------------------------
# What the recurrent kernels' designs rest on: the mLSTM's chunkwise form
# (gates, 3xTF32 products), the selective scan's polynomial exp2, and the
# routes and launch plans
# ---------------------------------------------------------------------------
def _gate_chain(f_pre, i_pre, m0, chunk):
    """The chunkwise kernel's gates in plain torch: each chunk's
    log-sigmoids at once, then the max-plus recurrence m = max(lf + m, i)
    step by step, carried from chunk to chunk. f_pre, i_pre: (B, T, H);
    m0: (B, H). Returns m_t (B, T, H)."""
    lf = torch.nn.functional.logsigmoid(f_pre.float())
    ip, m, out = i_pre.float(), m0.clone(), []
    for t0 in range(0, f_pre.shape[1], chunk):
        for t in range(t0, min(t0 + chunk, f_pre.shape[1])):
            m = torch.maximum(lf[:, t] + m, ip[:, t])
            out.append(m)
    return torch.stack(out, dim=1)


def _tree_max_plus(f_pre, i_pre, m0):
    """The same m_t by an associative (Hillis-Steele) scan of the pairs
    (a, b) -> (a1 + a2, max(b1 + a2, b2)): the adds regrouped."""
    a = torch.nn.functional.logsigmoid(f_pre.float())
    b = i_pre.float().clone()
    step = 1
    while step < a.shape[1]:
        a2, b2 = a.clone(), b.clone()
        a2[:, step:] = a[:, :-step] + a[:, step:]
        b2[:, step:] = torch.maximum(b[:, :-step] + a[:, step:], b[:, step:])
        a, b, step = a2, b2, 2 * step
    return torch.maximum(m0[:, None] + a, b)


@pytest.mark.parametrize("fresh", [True, False])
def test_mlstm_gate_chain_gives_the_recurrence_m_bit_for_bit(fresh):
    """The chunkwise kernel's stabiliser (log-sigmoids in parallel, then
    the max-plus recurrence one add and one max a step) equals the plain
    recurrence's m_t bit for bit in float32, from a fresh state (m = -inf,
    no NaN) and from one reached mid-sequence, across chunk boundaries.
    A tree scan of the same operator regroups the adds and does not; m_t
    enters den directly, so the kernel keeps the recurrence's order."""
    B, T, H, dh = 2, 3 * tmlstm.CHUNK + 5, 2, 8
    q, k, v, ip, fp = _mlstm_inputs(21, B, T, H, dh)
    st = _mlstm_state(B, H, dh, dh, seed=None if fresh else 22)
    want = []
    state = [_torch(a.copy()) for a in st]
    for t in range(T):       # the plain version one step at a time
        ops.mlstm_chunk(*(_torch(a[:, t:t + 1].copy())
                          for a in (q, k, v, ip, fp)), *state)
        want.append(state[2].clone())
    want = torch.stack(want, dim=1)
    got = _gate_chain(_torch(fp), _torch(ip), _torch(st[2].copy()),
                      tmlstm.CHUNK)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    tree = _tree_max_plus(_torch(fp), _torch(ip), _torch(st[2].copy()))
    torch.testing.assert_close(tree, want, atol=1e-5, rtol=1e-5)
    assert not torch.equal(tree, want)


def _round_tf32(x):
    return _tf32(x.float())


def _mm_tf32(a, b, exact_a, exact_b, split):
    """a @ b from the operands a tensor core reads: TF32 hi, plus (where
    ``split`` and the operand is not exact in TF32) its lo, summed in
    float64 (a tensor core's products of TF32 values are exact)."""
    a, b = a.float(), b.float()
    ah = a if exact_a else _round_tf32(a)
    bh = b if exact_b else _round_tf32(b)
    out = ah.double() @ bh.double()
    if split and not exact_a:
        out = out + _round_tf32(a - ah).double() @ bh.double()
    if split and not exact_b:
        out = out + ah.double() @ _round_tf32(b - bh).double()
    return out


def _mlstm_chunkwise(q, k, v, ip, fp, C, n, m, exact, unsplit=None):
    """The chunkwise kernel's algebra for one (batch, head) in float64:
    chunks of ``tmlstm.CHUNK`` steps, the gates as the kernel takes them
    (``_gate_chain``'s float32 m), the products S = Q K^T, C^T q, P V and
    the state's (w V)^T K from TF32 operands split into hi and lo
    (``exact``: q, k, v are bfloat16 values, exact in TF32, and enter
    unsplit), except the one named ``unsplit``, taken as one TF32
    product. q, k: (T, dk); v: (T, dv); ip, fp: (T,); C, n, m: the state.
    Returns (h, C, n, m)."""
    T, dk = q.shape
    qs = dk ** -0.5
    lf = torch.nn.functional.logsigmoid(fp.float())
    C, n, mc, hs = C.double(), n.double(), m.float(), []
    for t0 in range(0, T, tmlstm.CHUNK):
        sl = slice(t0, min(T, t0 + tmlstm.CHUNK))
        mt = _gate_chain(fp[None, sl, None], ip[None, sl, None],
                         mc[None, None], tmlstm.CHUNK)[0, :, 0].double()
        F = torch.cumsum(lf[sl].double(), 0)
        iv = ip[sl].double()
        d = torch.exp(F + mc.double() - mt)          # 0 from m = -inf
        w = torch.exp((F - mt)[:, None] - (F - iv)[None, :]).tril()
        Q, K, V = q[sl], k[sl], v[sl]
        P = _mm_tf32(Q, K.T, exact, exact, unsplit != "S") * qs * w
        num = d[:, None] * _mm_tf32(Q, C, exact, False, unsplit != "QC") \
            * qs + _mm_tf32(P, V, False, exact, unsplit != "PV")
        nq = d * (Q.double() @ n) * qs + P.sum(1)
        hs.append(num / torch.maximum(nq.abs(), torch.exp(-mt))[:, None])
        we = torch.exp(F[-1] - F + iv - mt[-1])
        C = d[-1] * C + _mm_tf32((K.double() * we[:, None]).T, V, False,
                                 exact, unsplit != "KV")
        n = d[-1] * n + (K.double() * we[:, None]).sum(0)
        mc = mt[-1].float()
    return torch.cat(hs), C, n, mc


def _mlstm_recurrence_f64(q, k, v, ip, fp, C, n, m):
    """The recurrence step by step in float64 (the plain version's
    arithmetic); one (batch, head)."""
    dk = q.shape[1]
    qf, kf, vf = q.double() * dk ** -0.5, k.double(), v.double()
    lf = torch.nn.functional.logsigmoid(fp.double())
    C, n, m, hs = C.double(), n.double(), m.double(), []
    for t in range(q.shape[0]):
        mn = torch.maximum(lf[t] + m, ip[t].double())
        fg, ig = torch.exp(lf[t] + m - mn), torch.exp(ip[t].double() - mn)
        C = fg * C + ig * torch.outer(kf[t], vf[t])
        n = fg * n + ig * kf[t]
        hs.append(qf[t] @ C / torch.maximum((qf[t] @ n).abs(),
                                            torch.exp(-mn)))
        m = mn
    return torch.stack(hs), C, n, m


def _mlstm_head(dtype, warm, T=64, d=384):
    """One (batch, head) at xlstm-125m's width; q, k, v rounded to
    ``dtype``'s values."""
    q, k, v, ip, fp = (_torch(a)[0, :, 0] for a in _mlstm_inputs(23, 1, T,
                                                                 1, d))
    q, k, v = (t.to(getattr(torch, dtype)).float() for t in (q, k, v))
    C, n, m = (_torch(a)[0, 0] for a in _mlstm_state(1, 1, d, d,
                                                     seed=24 if warm
                                                     else None))
    return q, k, v, ip, fp, C, n, m


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlstm_chunkwise_split_keeps_float32_accuracy(dtype, warm):
    """The chunkwise form with every product split into TF32 hi and lo
    (unsplit where an operand is a bfloat16 input) against the float64
    recurrence at xlstm-125m's width (dk = dv = 384), two chunks: h and
    the final C, n, m within 1e-5, inside the 1e-4 that chip_smoke.py
    holds the final state to in both dtype modes."""
    args = _mlstm_head(dtype, warm)
    got = _mlstm_chunkwise(*args, exact=dtype == "bfloat16")
    want = _mlstm_recurrence_f64(*args)
    for g, w in zip(got, want):
        assert (g.double() - w).abs().max() < 1e-5


@pytest.mark.parametrize("product", ["S", "QC", "PV", "KV"])
def test_mlstm_one_unsplit_product_leaves_float32_accuracy(product):
    """In float32 each of the four products, taken as one TF32 product,
    puts h or the final C outside 1e-4: why the kernel splits them all."""
    args = _mlstm_head("float32", False)
    got = _mlstm_chunkwise(*args, exact=False, unsplit=product)
    want = _mlstm_recurrence_f64(*args)
    err = max((got[i] - want[i]).abs().max().item() for i in (0, 1))
    assert err > 1e-4, err


def _exp2_fma(x, coef=tmamba.EXP2_POLY):
    """The scan kernel's exp2_fma in torch float32: clamp to [-125, 127],
    j = rint(x) by the magic-number add, f = x - j, Horner with each FMA
    rounded once (float64 then float32), 2^j added to the exponent bits."""
    x = x.float().clamp(-125.0, 127.0)
    big = x + 12582912.0
    f = x - (big - 12582912.0)
    r = torch.full_like(f, coef[-1])
    for c in coef[-2::-1]:
        r = (r.double() * f.double() + c).float()
    bits = r.view(torch.int32) + (big.view(torch.int32) << 23)
    return bits.view(torch.float32)


def test_exp2_polynomial_matches_exp2_over_the_scan_range():
    """2^x on the FMA pipe against float64 exp2, over dt A log2(e) as Jamba
    gives it (A = -exp(A_log) in [-16, -1] at initialisation, dt a
    softplus up to ~2: x in [-50, 0], dense) and the clamped range
    [-125, 127]: within 2e-7 relative, float32's own accuracy, far inside
    the 1e-4 the scan is held to; exact at 0."""
    x = torch.cat([torch.linspace(-50.0, 0.0, 200001),
                   torch.linspace(-125.0, 127.0, 20001),
                   torch.tensor([0.0, -0.5, 0.5, -1.0, 1.0])])
    got = _exp2_fma(x).double()
    want = torch.exp2(x.double())
    assert ((got - want).abs() / want).max() < 2e-7
    assert _exp2_fma(torch.tensor([0.0])).item() == 1.0
    # x below -125 is clamped: 2^-125, effectively 0 beside any h
    assert _exp2_fma(torch.tensor([-300.0])).item() == 2.0 ** -125


def test_recurrent_routes_follow_the_length():
    """One step (decode) takes the recurrent / step kernel; a prompt of
    any other length the chunkwise / scan kernel."""
    assert [tmlstm.route(T) for T in (1, 2, 13, 512)] == \
        ["recurrent", "chunkwise", "chunkwise", "chunkwise"]
    assert [tmamba.route(T) for T in (1, 2, 45, 512)] == \
        ["step", "scan", "scan", "scan"]
    assert set(tmlstm.ROUTES) == {"chunkwise", "recurrent"}
    assert set(tmamba.ROUTES) == {"scan", "step"}
    for name, kernel in (("mlstm_chunk", tmlstm), ("mamba_scan", tmamba)):
        assert set(ops.route_counts(name)) == set(kernel.ROUTES)


@pytest.mark.parametrize("args,want", [
    # xlstm-125m's prefill (a block per (batch, head) and 48 columns)
    ((4, 512, 4, 384, 384, 2), ("chunkwise", 1, True, True)),
    ((4, 512, 4, 384, 384, 4), ("chunkwise", 1, True, True)),
    # its decode: clusters of 8 split dk, 16-byte loads of C
    ((4, 1, 4, 384, 384, 2), ("recurrent", 8, False, True)),
    # ragged: 200-byte bf16 rows of q, k go through plain loads
    ((3, 21, 2, 100, 72, 2), ("chunkwise", 1, False, True)),
    ((3, 1, 2, 100, 72, 2), ("recurrent", 6, False, True)),
    ((2, 1, 2, 8, 8, 4), ("recurrent", 1, False, True)),
    ((2, 1, 2, 16, 6, 4), ("recurrent", 1, False, False)),
])
def test_mlstm_plan_by_length_and_shape(args, want):
    p = tmlstm.plan(*args)
    assert tuple(p) == want
    assert tmlstm.plan(*args, aligned=False)[2:] == (False, False)


def test_mamba_plan_by_length_and_shape():
    """cp.async rows where they start on 16 bytes and are whole 16-byte
    chunks (Jamba's column slices at dt_rank 256 are), plain loads
    else; 4-state step threads at N = 16."""
    def tensors(Bt, T, E, N, dtype, off):
        proj = torch.zeros(Bt, T, off + 2 * N, dtype=dtype)
        return (torch.zeros(Bt, T, E, dtype=dtype),
                torch.zeros(Bt, T, E), torch.zeros(E, N),
                proj[..., off:off + N], proj[..., off + N:],
                torch.zeros(Bt, E, N))
    served = tmamba.plan(*tensors(4, 512, 8192, 16, torch.bfloat16, 256))
    assert served == ("scan", True, True, True, True)
    step = tmamba.plan(*tensors(4, 1, 8192, 16, torch.bfloat16, 256))
    assert step.route == "step" and step.quad
    ragged = tmamba.plan(*tensors(2, 45, 300, 16, torch.bfloat16, 5))
    assert ragged[:4] == ("scan", False, True, False)
    assert not tmamba.plan(*tensors(2, 1, 32, 8, torch.float32, 5)).quad
    # the special-function floor of Jamba's prefill on 132 SMs at 1.98 GHz
    assert tmamba.sfu_floor_ms(4, 512, 8192, 16, 132, 1.98) == \
        pytest.approx(0.0642, abs=1e-4)


# ---------------------------------------------------------------------------
# Dispatch rules and launch counters
# ---------------------------------------------------------------------------
def test_cpu_dispatch_runs_plain_versions_and_counts_nothing():
    ops.reset_launch_counts()
    q, k, v = _normal(4, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    ops.flash_attention(_torch(q), _torch(k), _torch(v))
    (x,) = _normal(5, (2, 4, 4, 8))
    ops.fused_groupnorm(_torch(x), torch.ones(8), torch.zeros(8), groups=4)
    ops.decode_attention(_torch(q[:, 0]), _torch(k), _torch(v),
                         torch.tensor([8], dtype=torch.int32))
    ops.fused_rmsnorm(_torch(x), torch.ones(8), residual=_torch(x))
    ops.swiglu(_torch(x), _torch(x))
    ops.mlstm_chunk(*(_torch(a) for a in _mlstm_inputs(6, 1, 3, 2, 8)),
                    *(_torch(a) for a in _mlstm_state(1, 2, 8, 8)))
    ops.mamba_scan(*(_torch(a) for a in _mamba_inputs(6, 1, 3, 8, 4)),
                   torch.zeros(1, 8, 4))
    assert ops.launch_counts() == NO_LAUNCHES
    assert ops.route_counts() == {"wgmma": 0, "tf32x3": 0, "cuda_core": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA or raises: it never runs its
    plain version in the kernel's place."""
    t = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="CUDA"):
        tgn.fused_groupnorm(torch.zeros(1, 4, 8), torch.ones(8),
                            torch.zeros(8), groups=4)
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_attention(t[:, 0], t, t,
                                 torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        trms.fused_rmsnorm(t, torch.ones(16))
    with pytest.raises(ValueError, match="CUDA"):
        tswiglu.swiglu(t, t)
    with pytest.raises(ValueError, match="CUDA"):
        tmlstm.mlstm_chunk(*(_torch(a) for a in _mlstm_inputs(6, 1, 3, 2, 8)),
                           *(_torch(a) for a in _mlstm_state(1, 2, 8, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        tmamba.mamba_scan(*(_torch(a) for a in _mamba_inputs(6, 1, 3, 8, 4)),
                          torch.zeros(1, 8, 4))
    assert ops.launch_counts() == NO_LAUNCHES


def test_plain_versions_live_beside_their_kernels():
    """``ops.PLAIN`` names one plain version for every kernel, and it is
    the function a CPU tensor takes through ``ops``."""
    assert ops.PLAIN == {"flash_attention": ref.flash_attention_ref,
                         "fused_groupnorm": ref.groupnorm_silu_ref,
                         "decode_attention": ref.decode_attention_ref,
                         "fused_rmsnorm": ref.rmsnorm_ref,
                         "swiglu": ref.swiglu_ref,
                         "mlstm_chunk": ref.mlstm_chunk_ref,
                         "mamba_scan": ref.mamba_scan_ref}
    assert ops.PLAIN.keys() == ops.KERNELS.keys()


def test_kernel_modules_import_without_triton_or_nvcc():
    code = ("import sys; sys.modules['triton'] = None; "
            "sys.modules['jax'] = None\n"
            "from repro_torch.kernels import ops, fused_groupnorm, "
            "flash_attention, build, decode_attention, fused_rmsnorm, "
            "swiglu, mlstm_chunk, mamba_scan\n"
            f"assert ops.launch_counts() == {NO_LAUNCHES!r}\n"
            "assert fused_groupnorm._FN is None and "
            "flash_attention._FN is None and flash_attention._FN_TC is None "
            "and flash_attention._FN_TF32 is None\n"
            "assert fused_rmsnorm.tl is None and swiglu.tl is None and "
            "decode_attention._FN is None\n"
            "assert mlstm_chunk._FN is None and mamba_scan._FN is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/nonexistent"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# every GroupNorm shape of one full-width UNet and discriminator forward
# (b = 8, g = 8) and the cluster the planner gives it on 132 SMs
GN_PATH_PLANS = [
    ((4, 4, 96), 1), ((4, 4, 256), 1), ((4, 4, 384), 1), ((8, 8, 64), 1),
    ((8, 8, 192), 1), ((8, 8, 256), 1), ((16, 16, 48), 1),
    ((16, 16, 96), 1), ((16, 16, 192), 1), ((16, 16, 256), 1),
    ((16, 16, 512), 2), ((16, 16, 768), 2), ((16, 16, 1024), 2),
    ((32, 32, 24), 1), ((32, 32, 96), 2), ((32, 32, 128), 2),
    ((32, 32, 256), 2), ((32, 32, 384), 2), ((32, 32, 512), 2),
    ((32, 32, 768), 2), ((64, 64, 128), 2), ((64, 64, 256), 8),
    ((64, 64, 384), 8),
]


def _check_plan_covers(p, shape):
    """The clusters cover HW exactly, no block empty, and each block's
    share (rows and the group's scale and bias) fits its 227 KB."""
    assert p.groups * p.cg == shape[-1]
    assert p.hw == math.prod(shape[1:-1])
    assert p.cluster in tgn.CLUSTER_SIZES
    assert (p.cluster - 1) * p.rows < p.hw <= p.cluster * p.rows
    assert 1 <= p.chunk_rows <= p.rows
    assert p.smem == 16 * ((2 * p.cg + 3) // 4) + p.chunk_rows * p.cg * 4
    assert p.smem <= tgn.SMEM_BYTES < 227 * 1024
    assert p.vec == (4 if p.cg % 4 == 0 else 1)


@pytest.mark.parametrize("hwc,cluster", GN_PATH_PLANS)
def test_groupnorm_plan_covers_path_shapes(hwc, cluster):
    """Every path shape holds x in shared memory (one read), in the
    cluster predicted: the fewest blocks that fit, doubled while the
    blocks need a second wave of the SMs or twice as many still fit one
    wave and each holds more than 32 KB."""
    shape = (8, *hwc)
    p = tgn.plan(shape, 8, 132)
    _check_plan_covers(p, shape)
    assert p.mode == "resident" and p.chunk_rows == p.rows
    assert p.cluster == cluster
    # the widest slice, (64 x 64) x 48 channels = 768 KB, is 96 KB a block
    if hwc == (64, 64, 384):
        assert (p.rows * p.cg * 4, p.smem) == (96 * 1024, 98688)


@pytest.mark.parametrize("shape,groups,want", [
    # 4 MB a (sample, group): over 8 x 227 KB, so chunked, x read again
    ((2, 128, 128, 512), 8, dict(cluster=8, mode="reread", vec=4)),
    # group shrink 10 -> 5, CG = 2: 4-byte copies, one block
    ((3, 6, 6, 10), 8, dict(groups=5, cluster=1, mode="resident", vec=1)),
    # the discriminator's stem, CG = 3
    ((8, 32, 32, 24), 8, dict(cg=3, cluster=1, mode="resident", vec=1)),
    # pre-flattened (B, HW, C)
    ((5, 8, 24), 4, dict(groups=4, cg=6, cluster=1, vec=1)),
    # one sample of the widest slice: the fit alone asks for 4 blocks,
    # filling the card for 8
    ((1, 64, 64, 384), 8, dict(cluster=8, rows=512, mode="resident")),
])
def test_groupnorm_plan_modes(shape, groups, want):
    p = tgn.plan(shape, groups, 132)
    _check_plan_covers(p, shape)
    assert {k: getattr(p, k) for k in want} == want
    if p.mode == "reread":
        assert p.chunk_rows < p.rows
        assert (p.chunk_rows + 1) * p.cg * 4 + 16 * ((2 * p.cg + 3) // 4) \
            > tgn.SMEM_BYTES


def test_groupnorm_plan_fits_before_it_fills():
    """The cluster is never below the fewest blocks whose shares fit, and
    grows past that only for the card: a 128 KB slice of 64 (sample,
    group)s stays one block each on 64 SMs (one wave) and takes 2 on
    132 (SMs left idle); the widest slice (fit: 4 blocks of 192 KB, one
    an SM) takes 8 for its second wave."""
    for sms in (1, 64, 132, 1000):
        for shape in ((8, 16, 16, 1024), (8, 64, 64, 384), (8, 64, 64, 128)):
            p = tgn.plan(shape, 8, sms)
            fit = next(c for c in tgn.CLUSTER_SIZES
                       if -(-p.hw // c) * p.cg * 4 + 16 * ((2 * p.cg + 3) // 4)
                       <= tgn.SMEM_BYTES)
            assert p.cluster >= fit
    assert tgn.plan((8, 16, 16, 1024), 8, 64).cluster == 1
    assert tgn.plan((8, 16, 16, 1024), 8, 132).cluster == 2
    assert tgn.plan((8, 64, 64, 384), 8, 132).cluster == 8
    assert tgn.plan((4, 32, 32, 512), 8, 132).cluster == 4


def test_rmsnorm_launch_config_covers_path_widths():
    # (BLOCK_D, num_warps): Yi-9B's d_model, smollm's 576, the test widths
    assert trms.launch_config(4096) == (4096, 8)
    assert trms.launch_config(576) == (1024, 2)
    assert trms.launch_config(96) == (128, 1)


def test_build_targets_hopper_and_keys_on_source():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    names = ("flash_attention", "flash_attention_tc", "flash_attention_tf32",
             "fused_groupnorm", "decode_attention", "mlstm_chunk",
             "mamba_scan")
    for name in names:
        p = build.library_path(name)
        assert p.parent == build.BUILD_DIR and p.suffix == ".so"
        assert p == build.library_path(name)   # stable name
        assert (build.CSRC / f"{name}.cu").is_file()
    assert len({build.library_path(name) for name in names}) == len(names)


def test_build_keys_on_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header (csrc/*.cuh) renames every library, so an
    edited header is rebuilt, never loaded stale."""
    assert (build.CSRC / "common.cuh").is_file()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// two\n")
    assert build.library_path("k") != first


def test_kernel_impl_registry():
    assert impls.resolve_kernel_impl("auto") == "fused"
    assert set(impls.TORCH_KERNEL_IMPLS) == {"fused", "unfused"}
    with pytest.raises(ValueError):
        impls.resolve_kernel_impl("pallas")
    assert [impls.bucket_for(n, (1, 2, 4, 8)) for n in range(1, 10)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 16]
    assert impls.bucket_for(3, ()) == 3
