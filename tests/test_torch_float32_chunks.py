"""The float32 flash routes' query offset and positions through
``forward``, on the CPU, against the JAX package.

On CUDA a prompt chunk at an int ``cache_index`` > 0 takes the flash
kernel's query offset (or its position tensor, where the forward is
given positions), and a chunk at a 0-d tensor ``cache_index`` the
position route over the whole cache with positions ``min(t, slots[-1])``
(``layers.attn_apply``). Here the kernel branch runs on the CPU: the
device check answers "cuda" for flash attention and its kernel wrapper
is the plain version, counting launches by route as the kernel does, so
the arithmetic the kernel is handed (positions, ``kv_len``, offset) is what is held
against the JAX forward, at 5e-5 (the model tolerance), in float32 at
head dim 64 (the ``tf32x3`` route) and 16 (``cuda_core``). The kernels
themselves are held against the same plain version on the card
(``tests/test_torch_cuda.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import kvcache as jkv
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro_torch import configs
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import forward
from torch_threads import one_thread  # noqa: F401

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
B, C = 2, 8


@pytest.fixture
def kernel_branch(monkeypatch):
    """The CUDA dispatch on CPU tensors, the flash kernel replaced by its
    plain version that counts launches as the kernel does."""
    fn = tflash.flash_attention

    def plain_kernel(q, k, v, *, causal=True, kv_len=None, q_offset=0,
                     q_positions=None):
        way = tflash.route(q.dtype, q.shape[-1])
        fn.launches += 1
        fn.route_launches[way] += 1
        if q_positions is not None and causal:
            plain_kernel.position_launches += 1
            fn.position_route_launches[way] += 1
        elif q_offset and causal:
            plain_kernel.offset_launches += 1
            fn.offset_route_launches[way] += 1
        return ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                       q_offset=q_offset,
                                       q_positions=q_positions)
    plain_kernel.offset_launches = plain_kernel.position_launches = 0
    for name in ("route_launches", "offset_route_launches",
                 "position_route_launches"):
        setattr(plain_kernel, name, getattr(fn, name))
    monkeypatch.setattr(tflash, "flash_attention", plain_kernel)
    monkeypatch.setattr(ops, "_device_type", lambda t, kernel: "cuda"
                        if kernel == "flash_attention" else t.device.type)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _pair(head_dim):
    over = dict(head_dim=head_dim)
    jcfg = dataclasses.replace(jconfigs.reduced_config("yi-9b"), **over)
    tcfg = dataclasses.replace(configs.reduced_config("yi-9b"), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("head_dim,way", [(64, "tf32x3"),
                                          (16, "cuda_core")])
@pytest.mark.parametrize("kind", ["int", "tensor", "positions"])
def test_float32_chunk_through_the_kernel_branch_matches_jax(
        kernel_branch, head_dim, way, kind):
    """A prompt in three chunks of 8: the later ones at an int index (the
    offset), at a 0-d tensor index (positions min(slot, last slot) over
    the whole cache) or with explicit positions (half the chunk at t =
    0, then past the slots); every chunk's logits against the JAX
    forward's, and each chunk's flash launch on the route."""
    jcfg, tcfg, jp, tp = _pair(head_dim)
    assert tflash.route(torch.float32, head_dim) == way
    x = np.random.default_rng(21).integers(
        0, tcfg.vocab_size, (B, 3 * C)).astype(np.int32)
    jc = jkv.init_cache(jcfg, B, 4 * C)
    tc = init_cache(tcfg, B, 4 * C, "cpu")
    for i in range(3):
        start = i * C
        pos = None
        if kind == "positions":
            r = np.arange(start, start + C)
            pos = np.stack([np.where(r < start + C // 2, 0, r + 3)] * B
                           ).astype(np.int32)
        want, jc, _ = jax_forward(
            jp, jcfg, jnp.asarray(x[:, start:start + C]),
            positions=None if pos is None else jnp.asarray(pos), cache=jc,
            cache_index=start, mode="prefill")
        index = torch.tensor(start) if kind == "tensor" and i else start
        got, tc, _ = forward(
            tp, tcfg, torch.from_numpy(x[:, start:start + C]),
            positions=None if pos is None else torch.from_numpy(pos),
            cache=tc, cache_index=index, mode="prefill")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL, err_msg=f"chunk {i}")
    L = tcfg.num_layers
    assert ops.route_counts()[way] == 3 * L
    offset, at_pos = {"int": (2 * L, 0), "tensor": (0, 2 * L),
                      "positions": (0, 3 * L)}[kind]
    assert ops.offset_launches(way) == offset
    assert ops.position_launches(way) == at_pos
