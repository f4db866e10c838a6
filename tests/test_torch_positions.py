"""The port's attention under query positions that are not the sequence
slots, against the JAX package, on the CPU: M-RoPE on an image-like grid
(every patch at t = 0) and plain RoPE with positions a caller picks, in
``attn_apply`` and in ``forward``'s train, prefill, chunked prefill and
decode; the flash plain version with a position tensor against the JAX
``gqa_attention``; the decode step's live length; and MLA's chunked
prefill.

The JAX attention masks key j for a query at position t where j > t
(``repro/models/layers.py:attn_apply``); the port masks by the same
positions, and by the slots only where a forward is given none. Both
packages get the same weights (the JAX ``init_params`` through
``lm_from_jax``) and numpy-seeded inputs, in float32. Tolerances: 5e-5
for models and 3e-5 for a kernel's plain version (the JAX package's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import kvcache as jkv
from repro.models import layers as jlayers
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import forward
from torch_threads import one_thread  # noqa: F401

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
KERNEL_TOL = dict(atol=3e-5, rtol=3e-5)
B, S = 2, 16
# (arch, positions kind): an image grid under M-RoPE, and plain RoPE at
# positions that are neither the slots nor distinct
CASES = [("qwen2-vl-7b", "grid"), ("smollm-135m", "custom"),
         ("yi-9b", "custom")]


def _pair(arch, **over):
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **over)
    tcfg = dataclasses.replace(configs.reduced_config(arch), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, seed, length=S):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, length)).astype(np.int32)
    return rng.standard_normal((B, length, cfg.d_model)).astype(np.float32)


def _positions(kind, start, length):
    """int32 positions of slots start .. start + length - 1: ``grid`` an
    M-RoPE image (t = 0, (h, w) over a 4-wide grid), (3, B, S);
    ``custom`` plain RoPE (B, S): sequence 0 at half its slot (pairs of
    equal positions), sequence 1 at its slot plus 5 (past the slots)."""
    r = np.arange(start, start + length)
    if kind == "grid":
        return np.broadcast_to(np.stack([0 * r, r // 4, r % 4])[:, None],
                               (3, B, length)).astype(np.int32).copy()
    return np.stack([r // 2, r + 5]).astype(np.int32)


def _step_positions(kind, t, batch=B):
    """One decode token at position t on every axis (t below its slot
    after a grid prompt)."""
    if kind == "grid":
        return np.full((3, batch, 1), t, np.int32)
    return np.full((batch, 1), t, np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("kv_len", [None, 20])
@pytest.mark.parametrize("kind", ["zeros", "grid_text", "random"])
def test_flash_plain_with_q_positions_matches_jax_gqa(kind, kv_len):
    """``ref.flash_attention_ref(..., q_positions=)`` (GQA group 2) against
    the JAX ``gqa_attention`` with the same query positions: all at 0
    (every query sees key 0 only), an image then text tokens, and random
    non-negative positions; with and without a kv_len bound."""
    rng = np.random.default_rng(3)
    Sq, Sk, H, KH, D = 12, 24, 4, 2, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KH, D)).astype(np.float32)
    if kind == "zeros":
        pos = np.zeros((B, Sq), np.int32)
    elif kind == "grid_text":
        pos = np.concatenate([np.zeros((B, 8), np.int32),
                              np.broadcast_to(np.arange(4, 8), (B, 4))],
                             axis=1).astype(np.int32)
    else:
        pos = rng.integers(0, Sk + 4, (B, Sq)).astype(np.int32)
    kw = {} if kv_len is None else {
        "kv_valid_len": jnp.full((B,), kv_len, jnp.int32)}
    want = jlayers.gqa_attention(_j(q), _j(k), _j(v), causal=True,
                                 q_positions=_j(pos), **kw)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                                  kv_len=kv_len, q_positions=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # through ops on a CPU tensor: the same function
    via = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              kv_len=kv_len, q_positions=_t(pos))
    torch.testing.assert_close(via, got, rtol=0, atol=0)


def test_flash_plain_positions_at_the_slots_equal_the_offset_mask():
    """Positions ``q_offset + arange(Sq)`` give the offset route's mask
    exactly."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(B, 8, 4, 16, generator=g)
    k = torch.randn(B, 24, 2, 16, generator=g)
    v = torch.randn(B, 24, 2, 16, generator=g)
    pos = (10 + torch.arange(8, dtype=torch.int32)).expand(B, 8)
    a = ref.flash_attention_ref(q, k, v, kv_len=18, q_offset=10)
    b = ref.flash_attention_ref(q, k, v, kv_len=18, q_positions=pos)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("arch,kind", CASES)
def test_attn_apply_under_positions_matches_jax(arch, kind, cached):
    """One attention block against ``jlayers.attn_apply`` at the same
    positions: without a cache, and as a prefill of S - 4 rows into one
    followed by a chunk of 3 and a decode step below its slot."""
    jcfg, tcfg, jp, tp = _pair(arch)
    ja = jax.tree.map(lambda a: a[0], jp["scan"]["b0"]["attn"])
    ta = tp["layers"][0]["attn"]
    x = np.random.default_rng(9).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    if not cached:
        pos = _positions(kind, 0, S)
        want, _ = jlayers.attn_apply(ja, jcfg, _j(x), positions=_j(pos))
        got, _ = layers.attn_apply(ta, tcfg, _t(x), positions=_t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        return
    hd, kh = tcfg.resolved_head_dim, tcfg.num_kv_heads
    jc = {"k": jnp.zeros((B, S + 2, kh, hd)), "v": jnp.zeros((B, S + 2, kh,
                                                                hd))}
    tc = {"k": torch.zeros(B, S + 2, kh, hd), "v": torch.zeros(B, S + 2, kh,
                                                               hd)}
    for start, length in ((0, S - 4), (S - 4, 3), (S - 1, 1)):
        pos = _positions(kind, start, length) if length > 1 \
            else _step_positions(kind, 2)
        xs = x[:, start:start + length]
        want, jc = jlayers.attn_apply(ja, jcfg, _j(xs), positions=_j(pos),
                                      cache=jc, cache_index=start)
        got, tc = layers.attn_apply(ta, tcfg, _t(xs), positions=_t(pos),
                                    cache=tc, cache_index=start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   **MODEL_TOL)


@pytest.mark.parametrize("arch,kind", CASES)
def test_forward_train_and_prefill_under_positions_match_jax(arch, kind):
    jcfg, tcfg, jp, tp = _pair(arch)
    x, pos = _inputs(tcfg, 11), _positions(kind, 0, S)
    want, _, _ = jax_forward(jp, jcfg, _j(x), positions=_j(pos),
                             mode="train")
    got, _, _ = forward(tp, tcfg, _t(x), positions=_t(pos), mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    jc = jkv.init_cache(jcfg, B, S + 4)
    want, _, _ = jax_forward(jp, jcfg, _j(x), positions=_j(pos), cache=jc,
                             cache_index=0, mode="prefill")
    got, _, _ = forward(tp, tcfg, _t(x), positions=_t(pos),
                        cache=init_cache(tcfg, B, S + 4, "cpu"),
                        mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("tensor_index", [False, True])
@pytest.mark.parametrize("arch,kind", CASES)
def test_chunked_prefill_and_decode_under_positions_match_jax(
        arch, kind, tensor_index):
    """The prompt in two chunks of 8 (the second through the flash plain
    version over the cache's rows with the chunk's positions, or, with a
    0-d tensor cache_index, the plain ``gqa_attention``), then three
    decode steps at positions 2, 3, 4, below their slots 16, 17, 18
    (the live length ``min(slot + 1, t + 1)``): every step's logits
    against the JAX forward's."""
    jcfg, tcfg, jp, tp = _pair(arch)
    x = _inputs(tcfg, 13, length=S + 3)
    jc = jkv.init_cache(jcfg, B, S + 4)
    tc = init_cache(tcfg, B, S + 4, "cpu")
    steps = [(0, 8, "prefill"), (8, 8, "prefill")] \
        + [(S + i, 1, "decode") for i in range(3)]
    for n, (start, length, mode) in enumerate(steps):
        xs = x[:, start:start + length]
        pos = _positions(kind, start, length) if mode == "prefill" \
            else _step_positions(kind, n)
        want, jc, _ = jax_forward(jp, jcfg, _j(xs), positions=_j(pos),
                                  cache=jc, cache_index=start, mode=mode)
        index = torch.tensor(start) if tensor_index else start
        got, tc, _ = forward(tp, tcfg, _t(xs), positions=_t(pos), cache=tc,
                             cache_index=index, mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL, err_msg=f"{mode} {start}")


def test_decode_valid_len_follows_the_query_position():
    slots = torch.tensor([7])
    assert layers.decode_valid_len(slots, 3).tolist() == [8, 8, 8]
    t = torch.tensor([[0], [7], [30]], dtype=torch.int32)
    assert layers.decode_valid_len(slots, 3, t).tolist() == [1, 8, 8]
    assert layers.decode_valid_len(slots, 3, t).dtype == torch.int32
    pos = torch.tensor([[[2], [9]], [[0], [0]], [[0], [0]]])
    qpos = layers.query_positions(pos)
    assert qpos.dtype == torch.int32 and qpos.tolist() == [[2], [9]]


def test_mrope_prompt_with_default_positions_masks_by_the_slots():
    """A forward given no positions masks by the slots, which its default
    positions are: the same logits as passing the slots explicitly."""
    _, tcfg, _, tp = _pair("qwen2-vl-7b")
    x = _t(_inputs(tcfg, 17))
    a, _, _ = forward(tp, tcfg, x, mode="train")
    slots = torch.arange(S, dtype=torch.int32)
    b, _, _ = forward(tp, tcfg, x, positions=slots.expand(3, B, S),
                      mode="train")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mla_chunked_prefill_matches_jax_and_differs_from_one_shot():
    """Reduced deepseek-v3 (float32, B 2, 16 token ids below 100): the
    prompt prefilled in two chunks of 8 equals the JAX package's chunked
    prefill at 5e-5, chunk by chunk; and the second chunk's logits
    differ from the one-shot prefill's by more than 5e-5, because MLA's
    prefill at ``cache_index`` > 0 attends over its own fresh rows only
    (``repro/models/mla.py``), as the port copies it."""
    jcfg, tcfg, jp, tp = _pair("deepseek-v3-671b")
    ids = np.random.default_rng(19).integers(0, 100, (B, S)).astype(np.int32)
    jc = jkv.init_cache(jcfg, B, S)
    tc = init_cache(tcfg, B, S, "cpu")
    chunks = []
    for start in (0, 8):
        xs = ids[:, start:start + 8]
        want, jc, _ = jax_forward(jp, jcfg, _j(xs), cache=jc,
                                  cache_index=start, mode="prefill")
        got, tc, _ = forward(tp, tcfg, _t(xs), cache=tc, cache_index=start,
                             mode="prefill")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        chunks.append(got)
    one, _, _ = forward(tp, tcfg, _t(ids),
                        cache=init_cache(tcfg, B, S, "cpu"), mode="prefill")
    torch.testing.assert_close(chunks[0], one[:, :8], **MODEL_TOL)
    assert (chunks[1] - one[:, 8:]).abs().max().item() > 5e-5
