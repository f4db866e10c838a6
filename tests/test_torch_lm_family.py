"""The rest of the LM family against the JAX package, on the CPU:
starcoder2-3b, olmo-1b, musicgen-large (embedding inputs, learned
positions, LayerNorm, GELU), llama4-scout (MoE with a shared expert),
deepseek-v3 (MLA, MoE, the multi-token prediction head) and qwen2-vl
(embedding inputs, M-RoPE), each at ``reduced_config`` size; MLA and
M-RoPE alone; chunked prefill through the flash plain version with a
query offset; ``LMCascade``; the step inputs.

Both packages get the same weights (the JAX ``init_params``, converted
by ``lm_from_jax``) and the same numpy-seeded inputs, in float32. On CPU
tensors the port's kernel calls run their plain versions. Tolerances are
the JAX package's: 5e-5 for models, 3e-5 for a kernel's plain version,
2e-3 for the teacher-forcing invariant (``tests/test_arch_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.cascade import LMCascade as JaxLMCascade
from repro.launch.steps import input_specs as jax_input_specs
from repro.models import kvcache as jkv
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro.models.transformer import count_params as jax_count_params
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import mtp_logits as jax_mtp_logits
from repro_torch import configs
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.cascade import LMCascade, greedy_lm_step
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import input_specs, serve_decode, serve_prefill
from repro_torch.models import layers, mla
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import (count_params, forward,
                                            init_params, mtp_logits)
from torch_threads import one_thread  # noqa: F401

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
KERNEL_TOL = dict(atol=3e-5, rtol=3e-5)
TF_TOL = dict(atol=2e-3, rtol=2e-3)
NEW_ARCHS = ["starcoder2-3b", "olmo-1b", "musicgen-large",
             "llama4-scout-17b-a16e", "deepseek-v3-671b", "qwen2-vl-7b"]
MOE_ARCHS = ["llama4-scout-17b-a16e", "deepseek-v3-671b"]
B, S = 2, 12


def _pair(arch, **over):
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **over)
    tcfg = dataclasses.replace(configs.reduced_config(arch), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, seed, length=S, batch=B):
    """numpy tokens (B, S) int32 or embeddings (B, S, D) float32."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (batch, length)).astype(
            np.int32)
    return rng.standard_normal((batch, length, cfg.d_model)).astype(
        np.float32)


def _mrope_positions(start, length, batch=B):
    """(3, B, S) int32 M-RoPE positions on distinct axes: t the sequence
    slot, (h, w) a 3-wide patch grid walked row by row."""
    t = np.arange(start, start + length)
    h = (t // 3) + 100
    w = (t % 3) + 7
    return np.broadcast_to(np.stack([t, h, w])[:, None, :],
                           (3, batch, length)).astype(np.int32).copy()


def _positions(cfg, start, length):
    return _mrope_positions(start, length) if cfg.rope == "mrope" else None


def _t(a):
    if a is None:
        return None
    a = np.asarray(a)
    return torch.from_numpy(a.copy()).long() if a.dtype.kind == "i" \
        else torch.from_numpy(a.copy())


def _j(a):
    return None if a is None else jnp.asarray(a)


def _run_jax(jp, jcfg, x, *, pos=None, **kw):
    return jax_forward(jp, jcfg, _j(x), positions=_j(pos), **kw)


# ---------------------------------------------------------------------------
# every new arch through forward, in three modes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_family_forward_matches_jax(arch, mode):
    jcfg, tcfg, jp, tp = _pair(arch)
    x = _inputs(tcfg, 1)
    if mode == "train":
        want, _, jaux = _run_jax(jp, jcfg, x, pos=_positions(tcfg, 0, S),
                                 mode="train")
        got, cache, aux = forward(tp, tcfg, _t(x),
                                  positions=_t(_positions(tcfg, 0, S)),
                                  mode="train")
        assert cache is None
    else:
        jc = jkv.init_cache(jcfg, B, S + 4)
        tc = init_cache(tcfg, B, S + 4, "cpu")
        n = S if mode == "prefill" else S - 1
        want, jc, jaux = _run_jax(jp, jcfg, x[:, :n],
                                  pos=_positions(tcfg, 0, n), cache=jc,
                                  cache_index=0, mode="prefill")
        got, tc, aux = forward(tp, tcfg, _t(x[:, :n]),
                               positions=_t(_positions(tcfg, 0, n)),
                               cache=tc, cache_index=0, mode="prefill")
        if mode == "decode":
            want, jc, jaux = _run_jax(jp, jcfg, x[:, n:],
                                      pos=_positions(tcfg, n, 1), cache=jc,
                                      cache_index=n, mode="decode")
            got, tc, aux = forward(tp, tcfg, _t(x[:, n:]),
                                   positions=_t(_positions(tcfg, n, 1)),
                                   cache=tc, cache_index=n, mode="decode")
        mixer = tcfg.period_pattern[0][0]
        key = "c_kv" if mixer == "mla" else "k"
        want_cache = np.asarray(jc["scan"]["b0"][key])    # (P, B, T, ...)
        n_pre = len(tcfg.prefix_pattern)
        got_cache = np.stack([e[key].numpy() for e in tc[n_pre:]])
        np.testing.assert_allclose(got_cache, want_cache, **MODEL_TOL)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **MODEL_TOL)
    if arch in MOE_ARCHS:
        assert float(aux) > 0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_family_decode_matches_teacher_forcing(arch):
    """Prefill of S-1 tokens then one decode step gives the full-context
    forward's last logits (MLA's absorbed decode against its prefill)."""
    _, tcfg, _, tp = _pair(arch)
    x = _t(_inputs(tcfg, 2))
    pos = _t(_positions(tcfg, 0, S))
    full, _, _ = forward(tp, tcfg, x, positions=pos, mode="train")
    cache = init_cache(tcfg, B, S + 2, "cpu")
    _, cache, _ = forward(tp, tcfg, x[:, :S - 1], cache=cache,
                          positions=None if pos is None else pos[..., :S - 1],
                          mode="prefill")
    last, _, _ = forward(tp, tcfg, x[:, S - 1:], cache=cache,
                         positions=None if pos is None else pos[..., S - 1:],
                         cache_index=S - 1, mode="decode")
    torch.testing.assert_close(last[:, 0], full[:, -1], **TF_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_family_init_has_the_jax_structure(arch):
    jcfg, tcfg, jp, conv = _pair(arch)
    tp = init_params(tcfg, seed=3, device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tp)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), conv)
    assert sum(t.numel() for t in jax.tree.leaves(tp)) \
        == count_params(tcfg) == jax_count_params(jcfg)
    assert ("embed" in tp) == ("embed" in jp)
    assert ("mtp" in tp) == bool(tcfg.mtp_depth)


@pytest.mark.parametrize("active_only,include_embedding",
                         [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_count_params_options_match_jax(arch, active_only,
                                        include_embedding):
    kw = dict(active_only=active_only, include_embedding=include_embedding)
    assert count_params(configs.get_config(arch), **kw) == \
        jax_count_params(jconfigs.get_config(arch), **kw)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sections", [(16, 24, 24), (2, 3, 3), (8, 0, 8)])
def test_mrope_angles_match_jax(sections):
    """(3, B, S) positions on three distinct axes, each section of the
    frequencies taking its own axis (a zero section skips its axis)."""
    rng = np.random.default_rng(6)
    half = sum(sections)
    pos = np.stack([rng.integers(0, 4097, (2, 33)) for _ in range(3)])
    x = rng.standard_normal((2, 33, 3, 2 * half)).astype(np.float32)
    jcos, jsin = jlayers.rope_angles(jnp.asarray(pos, jnp.int32), 2 * half,
                                     1e6, sections)
    want = jlayers.apply_rope(jnp.asarray(x), jcos, jsin)
    cos, sin = layers.rope_angles(_t(pos), 2 * half, 1e6, sections)
    got = layers.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the same positions on every axis reduce M-RoPE to RoPE
    same = np.broadcast_to(pos[:1], pos.shape)
    c1, s1 = layers.rope_angles(_t(same), 2 * half, 1e6, sections)
    c0, s0 = layers.rope_angles(_t(pos[0]), 2 * half, 1e6)
    torch.testing.assert_close(c1, c0)
    torch.testing.assert_close(s1, s0)
    with pytest.raises(ValueError, match="sections"):
        layers.rope_angles(_t(pos), 2 * half + 2, 1e6, sections)


@pytest.mark.parametrize("cached", [False, True])
def test_attn_apply_with_mrope_matches_jax(cached):
    """qwen2-vl's attention block with M-RoPE on distinct (t, h, w) axes:
    without a cache, and as a prefill into one followed by a decode."""
    jcfg, tcfg, jp, tp = _pair("qwen2-vl-7b")
    ja, ta = jp["scan"]["b0"]["attn"], tp["layers"][0]["attn"]
    ja = jax.tree.map(lambda a: a[0], ja)
    x = np.random.default_rng(9).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    if not cached:
        pos = _mrope_positions(0, S)
        want, _ = jlayers.attn_apply(ja, jcfg, jnp.asarray(x),
                                     positions=jnp.asarray(pos))
        got, _ = layers.attn_apply(ta, tcfg, torch.from_numpy(x),
                                   positions=_t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        return
    hd, kh = tcfg.resolved_head_dim, tcfg.num_kv_heads
    jc = {"k": jnp.zeros((B, S + 2, kh, hd)), "v": jnp.zeros((B, S + 2, kh,
                                                                hd))}
    tc = {"k": torch.zeros(B, S + 2, kh, hd), "v": torch.zeros(B, S + 2, kh,
                                                               hd)}
    for start, length in ((0, S - 1), (S - 1, 1)):
        pos = _mrope_positions(start, length)
        xs = x[:, start:start + length]
        want, jc = jlayers.attn_apply(ja, jcfg, jnp.asarray(xs),
                                      positions=jnp.asarray(pos), cache=jc,
                                      cache_index=start)
        got, tc = layers.attn_apply(ta, tcfg, torch.from_numpy(xs),
                                    positions=_t(pos), cache=tc,
                                    cache_index=start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   **MODEL_TOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
def _mla_pair(q_rank):
    over = {} if q_rank else {"mla": dataclasses.replace(
        configs.reduced_config("deepseek-v3-671b").mla, q_lora_rank=0)}
    jcfg, tcfg, jp, tp = _pair("deepseek-v3-671b", **over)
    jattn = jax.tree.map(lambda a: a[0], jp["scan"]["b0"]["attn"])
    return jcfg, tcfg, jattn, tp["layers"][3]["attn"]


def _mla_cache(cfg, T):
    m = cfg.mla
    return ({"c_kv": jnp.zeros((B, T, m.kv_lora_rank)),
             "k_rope": jnp.zeros((B, T, m.qk_rope_head_dim))},
            {"c_kv": torch.zeros(B, T, m.kv_lora_rank),
             "k_rope": torch.zeros(B, T, m.qk_rope_head_dim)})


def _pos(start, length):
    return np.broadcast_to(np.arange(start, start + length)[None],
                           (B, length)).astype(np.int32).copy()


@pytest.mark.parametrize("q_rank", [True, False])
def test_mla_prefill_and_decode_match_jax(q_rank):
    """``mla_prefill`` into the latent cache (at 0, then a chunk at 8,
    which as in JAX attends over its fresh rows only), then two absorbed
    ``mla_decode`` steps, each output and the cache against JAX's."""
    jcfg, tcfg, jattn, tattn = _mla_pair(q_rank)
    x = np.random.default_rng(11).standard_normal(
        (B, 14, tcfg.d_model)).astype(np.float32)
    jc, tc = _mla_cache(tcfg, 16)
    for start, length, fn in ((0, 8, "prefill"), (8, 4, "prefill"),
                              (12, 1, "decode"), (13, 1, "decode")):
        xs, pos = x[:, start:start + length], _pos(start, length)
        if fn == "prefill":
            want, jc = jmla.mla_prefill(jattn, jcfg, jnp.asarray(xs),
                                        jnp.asarray(pos), cache=jc,
                                        cache_index=start)
            got, tc = mla.mla_prefill(tattn, tcfg, torch.from_numpy(xs),
                                      _t(pos), cache=tc, cache_index=start)
        else:
            want, jc = jmla.mla_decode(jattn, jcfg, jnp.asarray(xs),
                                       jnp.asarray(pos), jc, start)
            got, tc = mla.mla_decode(tattn, tcfg, torch.from_numpy(xs),
                                     _t(pos), tc, start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **MODEL_TOL)


def test_mla_absorbed_decode_matches_teacher_forcing():
    """The absorbed decode over the latent cache gives the materialised
    prefill's last output."""
    _, tcfg, _, tattn = _mla_pair(True)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, 10, tcfg.d_model)).astype(np.float32))
    full, _ = mla.mla_prefill(tattn, tcfg, x, _t(_pos(0, 10)))
    _, tc = _mla_cache(tcfg, 12)
    mla.mla_prefill(tattn, tcfg, x[:, :9], _t(_pos(0, 9)), cache=tc)
    last, _ = mla.mla_decode(tattn, tcfg, x[:, 9:], _t(_pos(9, 1)), tc,
                             torch.tensor(9))
    torch.testing.assert_close(last[:, 0], full[:, -1], **TF_TOL)


def test_mtp_logits_and_aux_match_jax():
    """deepseek-v3's multi-token prediction head over the forward's
    hidden state, and the forward's and head's MoE aux losses."""
    jcfg, tcfg, jp, tp = _pair("deepseek-v3-671b")
    toks = _inputs(tcfg, 13)
    nxt = _inputs(tcfg, 14)
    jl, _, jaux, jh = jax_forward(jp, jcfg, jnp.asarray(toks),
                                  return_hidden=True)
    tl, _, taux, th = forward(tp, tcfg, _t(toks), return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), **MODEL_TOL)
    want, waux = jax_mtp_logits(jp, jcfg, jh, jnp.asarray(nxt))
    got, gaux = mtp_logits(tp, tcfg, th, _t(nxt))
    assert got.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(gaux.numpy(), np.asarray(waux), **MODEL_TOL)
    assert float(gaux) > 0


# ---------------------------------------------------------------------------
# chunked prefill: the flash plain version with a query offset
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q_offset,Sq,KH", [(0, 8, 2), (8, 8, 2),
                                            (16, 5, 1), (3, 7, 4)])
def test_flash_plain_with_q_offset_matches_jax_gqa(q_offset, Sq, KH):
    """``flash_attention_ref`` with a query offset over a cache of
    T rows, kv_len = q_offset + Sq, against the JAX package's
    ``gqa_attention`` with ``q_positions`` and ``kv_valid_len``."""
    rng = np.random.default_rng(q_offset + Sq)
    T, H, D = 24, 4, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    kv_len = q_offset + Sq
    want = jlayers.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_positions=jnp.asarray(_pos(q_offset, Sq)),
        kv_valid_len=jnp.full((B,), kv_len, jnp.int32))
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  kv_len=kv_len, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    via_ops = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  kv_len=kv_len, q_offset=q_offset)
    torch.testing.assert_close(via_ops, got, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-vl-7b"])
def test_chunked_prefill_matches_jax(arch):
    """A prompt prefilled in three chunks of 8 at cache_index 0, 8 and
    16 (the later two through the flash plain version with a query
    offset): each chunk's logits and the cache against JAX's, and the
    last position against the one-shot prefill."""
    jcfg, tcfg, jp, tp = _pair(arch, num_kv_heads=2)
    x = _inputs(tcfg, 15, length=24)
    jc = jkv.init_cache(jcfg, B, 32)
    tc = init_cache(tcfg, B, 32, "cpu")
    for start in (0, 8, 16):
        xs, pos = x[:, start:start + 8], _positions(tcfg, start, 8)
        want, jc, _ = _run_jax(jp, jcfg, xs, pos=pos, cache=jc,
                               cache_index=start, mode="prefill")
        got, tc, _ = forward(tp, tcfg, _t(xs), positions=_t(pos), cache=tc,
                             cache_index=start, mode="prefill")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
    np.testing.assert_allclose(tc[-1]["v"].numpy(),
                               np.asarray(jc["scan"]["b0"]["v"][-1]),
                               **MODEL_TOL)
    one = init_cache(tcfg, B, 32, "cpu")
    full, _, _ = forward(tp, tcfg, _t(x), positions=_t(_positions(
        tcfg, 0, 24)), cache=one, mode="prefill")
    torch.testing.assert_close(got[:, -1], full[:, -1], **MODEL_TOL)


# ---------------------------------------------------------------------------
# serve steps with embeddings and positions, and the step inputs
# ---------------------------------------------------------------------------
def test_serve_steps_take_embeddings_and_mrope_positions():
    """qwen2-vl: ``serve_prefill`` of embeddings with (3, B, S) positions
    on distinct axes, then two ``serve_decode`` steps fed embeddings,
    against the JAX forward's last-position logits."""
    jcfg, tcfg, jp, tp = _pair("qwen2-vl-7b")
    x = _inputs(tcfg, 16, length=10)
    jc = jkv.init_cache(jcfg, B, 16)
    tc = init_cache(tcfg, B, 16, "cpu")
    for start, length in ((0, 8), (8, 1), (9, 1)):
        xs, pos = x[:, start:start + length], _mrope_positions(start, length)
        mode = "prefill" if start == 0 else "decode"
        want, jc, _ = _run_jax(jp, jcfg, xs, pos=pos, cache=jc,
                               cache_index=start, mode=mode)
        if start == 0:
            got, tc = serve_prefill(tp, tcfg, tc, _t(xs), _t(pos))
        else:
            got, tc = serve_decode(tp, tcfg, tc, _t(xs), start, _t(pos))
        assert got.shape == (B, tcfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1],
                                   **MODEL_TOL)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match_jax(arch, kind):
    """Seeded step inputs of the JAX ``input_specs`` shapes and dtypes
    (at a small shape); tokens below the vocabulary; M-RoPE positions
    the default ones."""
    shape = ShapeConfig("tiny", kind, 6, 2)
    cfg = configs.reduced_config(arch)
    want = jax_input_specs(jconfigs.reduced_config(arch), shape)
    got = input_specs(cfg, shape, seed=4, device="cpu")
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == spec.shape, name
        assert str(got[name].dtype).split(".")[-1] == spec.dtype.name, name
    again = input_specs(cfg, shape, seed=4, device="cpu")
    for name in got:
        torch.testing.assert_close(got[name], again[name], rtol=0, atol=0)
    if cfg.input_mode == "tokens":
        assert 0 <= int(got["inputs"].min()) and \
            int(got["inputs"].max()) < cfg.vocab_size
    if "positions" in got:
        start = 6 if kind == "decode" else 0
        assert got["positions"][:, :, 0].eq(start).all()


# ---------------------------------------------------------------------------
# LMCascade
# ---------------------------------------------------------------------------
def _host_steps(seed, n_steps=3, new=5, vocab=32):
    """Deterministic host step callables: prompt -> (tokens, log-probs),
    numpy, the same for both cascades."""
    def make(i):
        def step(prompt):
            p = np.asarray(prompt)
            rng = np.random.default_rng([seed, i, int(p.sum())])
            toks = rng.integers(0, vocab, (p.shape[0], new))
            lp = np.log(rng.uniform(0.05, 1.0, (p.shape[0], new)))
            return toks, lp
        return step
    return [make(i) for i in range(n_steps)]


@pytest.mark.parametrize("n_steps,thresholds", [
    (2, 0.5), (2, 1.1), (2, 0.0), (3, (0.45, 0.55)), (3, 0.6)])
def test_lm_cascade_run_batch_matches_jax(n_steps, thresholds):
    steps = _host_steps(21, n_steps)
    prompts = np.random.default_rng(22).integers(0, 32, (9, 4))
    want = JaxLMCascade(*steps).run_batch(prompts, thresholds)
    got = LMCascade(*steps).run_batch(prompts, thresholds)
    for field in ("outputs", "confidences", "deferred", "light_outputs",
                  "stage_index"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    for stage, row in zip(got.stage_index, got.outputs):
        assert stage < n_steps
    with pytest.raises(ValueError, match="2 stages"):
        LMCascade(steps[0])


def test_greedy_lm_step_generates_jax_greedy_tokens():
    """``greedy_lm_step`` (the port's step callable over the serve
    steps) against greedy decoding through the JAX forward: the same
    tokens, and the chosen tokens' log-probabilities."""
    jcfg, tcfg, jp, tp = _pair("smollm-135m")
    prompts = _inputs(tcfg, 23, length=6)
    toks, lps = greedy_lm_step(tp, tcfg, 4, device="cpu")(prompts)
    assert toks.shape == lps.shape == (B, 4)
    jc = jkv.init_cache(jcfg, B, 10)
    logits, jc, _ = jax_forward(jp, jcfg, jnp.asarray(prompts), cache=jc,
                                cache_index=0, mode="prefill")
    for i in range(4):
        lp = jax.nn.log_softmax(logits[:, -1].astype(jnp.float32))
        nxt = jnp.argmax(lp, axis=-1)
        np.testing.assert_array_equal(toks[:, i], np.asarray(nxt))
        np.testing.assert_allclose(
            lps[:, i], np.asarray(lp[jnp.arange(B), nxt]), **MODEL_TOL)
        logits, jc, _ = jax_forward(jp, jcfg, nxt[:, None], cache=jc,
                                    cache_index=6 + i, mode="decode")


def test_mrope_mask_follows_the_t_axis_as_in_jax():
    """With an M-RoPE prompt whose first axis is not the sequence (an
    image's patches, all at t = 0), the JAX attention masks by t and lets
    every query see key 0 only; the port masks by the same query
    positions and agrees at 5e-5 (a departure this test used to pin,
    ROADMAP.md Queue 3). Where t is the slot the two agree too
    (``test_attn_apply_with_mrope_matches_jax``)."""
    jcfg, tcfg, jp, tp = _pair("qwen2-vl-7b")
    ja = jax.tree.map(lambda a: a[0], jp["scan"]["b0"]["attn"])
    ta = tp["layers"][0]["attn"]
    x = np.random.default_rng(9).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    r = np.arange(S)
    pos = np.broadcast_to(np.stack([0 * r, r // 4, r % 4])[:, None],
                          (3, B, S)).astype(np.int32).copy()
    want, _ = jlayers.attn_apply(ja, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos))
    got, _ = layers.attn_apply(ta, tcfg, torch.from_numpy(x),
                               positions=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    # every query sees key 0 only: the output is v_0's projection at
    # every row
    v = layers.proj_heads(torch.from_numpy(x), ta["wv"])
    wo = ta["wo"]
    only0 = v[:, :1].expand(B, S, -1, -1).reshape(B, S, -1) \
        @ wo.reshape(-1, wo.shape[-1])
    torch.testing.assert_close(got, only0, **MODEL_TOL)
