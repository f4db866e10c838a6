"""The port's kernel modules against the JAX package.

Inputs are made with numpy from a seed and go through the JAX kernel
(Pallas in interpret mode, as the JAX package's own tests run it on the
CPU) and through the port's dispatch on CPU tensors, which runs the
kernel's plain PyTorch version. Tolerance 3e-5, the JAX package's kernel
tolerance (5e-2 for bfloat16, as there). The kernels themselves run only
on a CUDA card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
them against the plain versions there.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.unet import _fused_attn
from repro_torch.kernels import build, impls
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import fused_groupnorm as tgn
from repro_torch.kernels import ops, ref

TOL = dict(atol=3e-5, rtol=3e-5)
REPO = Path(__file__).resolve().parents[1]


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
# Dispatch rules and launch counters
# ---------------------------------------------------------------------------
def test_cpu_dispatch_runs_plain_versions_and_counts_nothing():
    ops.reset_launch_counts()
    q, k, v = _normal(4, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    ops.flash_attention(_torch(q), _torch(k), _torch(v))
    (x,) = _normal(5, (2, 4, 4, 8))
    ops.fused_groupnorm(_torch(x), torch.ones(8), torch.zeros(8), groups=4)
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "fused_groupnorm": 0}
    assert ops.specialization_count() == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA or raises: it never runs its
    plain version in the kernel's place."""
    t = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="CUDA"):
        tgn.fused_groupnorm(torch.zeros(1, 4, 8), torch.ones(8),
                            torch.zeros(8), groups=4)
    assert tflash.flash_attention.launches == 0
    assert tgn.fused_groupnorm.launches == 0


def test_plain_versions_live_beside_their_kernels():
    assert tflash.plain_flash_attention is ref.flash_attention_ref
    assert tgn.plain_groupnorm is ref.groupnorm_silu_ref


def test_kernel_modules_import_without_triton_or_nvcc():
    code = ("import sys; sys.modules['triton'] = None; "
            "sys.modules['jax'] = None\n"
            "from repro_torch.kernels import ops, fused_groupnorm, "
            "flash_attention, build\n"
            "assert ops.launch_counts() == {'flash_attention': 0, "
            "'fused_groupnorm': 0}\n"
            "assert fused_groupnorm.tl is None and "
            "flash_attention._FN is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/nonexistent"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_groupnorm_launch_config_covers_path_shapes():
    # full-width UNet top level and the discriminator's widest head
    assert tgn.launch_config((8, 64, 64, 128), 8) == (8, 4096, 16, 128, 16)
    assert tgn.launch_config((8, 4, 4, 384), 8) == (8, 16, 48, 16, 64)
    # group shrink 10 -> 5, ragged channel block
    assert tgn.launch_config((2, 6, 6, 10), 8) == (5, 36, 2, 64, 2)


def test_build_targets_hopper_and_keys_on_source():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    p = build.library_path("flash_attention")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p == build.library_path("flash_attention")   # stable name
    assert (build.CSRC / "flash_attention.cu").is_file()


def test_kernel_impl_registry():
    assert impls.resolve_kernel_impl("auto") == "fused"
    assert set(impls.TORCH_KERNEL_IMPLS) == {"fused", "unfused"}
    with pytest.raises(ValueError):
        impls.resolve_kernel_impl("pallas")
    assert [impls.bucket_for(n, (1, 2, 4, 8)) for n in range(1, 10)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 16]
    assert impls.bucket_for(3, ()) == 3
