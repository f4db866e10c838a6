"""The port's dense LM serving path against the JAX package, on the CPU.

Both packages get the same weights (the JAX ``init_params``, converted
by ``repro_torch.models.convert.lm_from_jax``) and the same numpy-seeded
tokens, in float32. On CPU tensors the port's kernel calls run their
plain versions (``kernels/ops.py``); the JAX LM runs plain ``jnp``.
Tolerance 5e-5, the JAX package's model tolerance; the teacher-forcing
invariant keeps its own 2e-3 (``tests/test_arch_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import base as jbase
from repro.launch.steps import cache_len as jax_cache_len
from repro.models import kvcache as jkv
from repro.models import layers as jlayers
from repro.models.transformer import count_params as jax_count_params
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro_torch import configs
from repro_torch.config import base
from repro_torch.kernels import ops
from repro_torch.launch.steps import cache_len, serve_decode, serve_prefill
from repro_torch.models import layers
from repro_torch.models.convert import from_jax, lm_from_jax
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import count_params, forward, init_params
from torch_threads import one_thread  # noqa: F401

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
TF_TOL = dict(atol=2e-3, rtol=2e-3)
# reduced yi-9b (4 heads over 4 KV heads), its GQA variant (KH = 2) and
# reduced smollm-135m (tied embeddings, KH = 1)
VARIANTS = {"yi": ("yi-9b", {}), "yi-gqa": ("yi-9b", {"num_kv_heads": 2}),
            "smollm": ("smollm-135m", {})}
B, S = 2, 12


def _pair(name):
    arch, over = VARIANTS[name]
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **over)
    tcfg = dataclasses.replace(configs.reduced_config(arch), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, vocab, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lm_forward_matches_jax(variant, mode):
    jcfg, tcfg, jp, tp = _pair(variant)
    toks = _tokens(1, tcfg.vocab_size)
    if mode == "train":
        want, _, _ = jax_forward(jp, jcfg, jnp.asarray(toks), mode="train")
        got, cache, _ = forward(tp, tcfg, _t(toks), mode="train")
        assert cache is None
    else:
        jc = jkv.init_cache(jcfg, B, S + 4)
        tc = init_cache(tcfg, B, S + 4, "cpu")
        n = S if mode == "prefill" else S - 1
        want, jc, _ = jax_forward(jp, jcfg, jnp.asarray(toks[:, :n]),
                                  cache=jc, cache_index=0, mode="prefill")
        got, tc, _ = forward(tp, tcfg, _t(toks[:, :n]), cache=tc,
                          cache_index=0, mode="prefill")
        if mode == "decode":
            want, jc, _ = jax_forward(jp, jcfg, jnp.asarray(toks[:, n:]),
                                      cache=jc, cache_index=n, mode="decode")
            got, tc, _ = forward(tp, tcfg, _t(toks[:, n:]), cache=tc,
                              cache_index=n, mode="decode")
        jk = np.asarray(jc["scan"]["b0"]["k"])            # (L, B, T, KH, hd)
        np.testing.assert_allclose(
            np.stack([e["k"].numpy() for e in tc]), jk, **MODEL_TOL)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_matches_teacher_forcing(variant):
    """Prefill of S-1 tokens then one decode step gives the full-context
    forward's last logits (``tests/test_arch_smoke.py``'s invariant)."""
    _, tcfg, _, tp = _pair(variant)
    toks = _t(_tokens(2, tcfg.vocab_size))
    full, _, _ = forward(tp, tcfg, toks, mode="train")
    cache = init_cache(tcfg, B, S + 2, "cpu")
    _, cache, _ = forward(tp, tcfg, toks[:, :S - 1], cache=cache, mode="prefill")
    last, _, _ = forward(tp, tcfg, toks[:, S - 1:], cache=cache,
                      cache_index=S - 1, mode="decode")
    torch.testing.assert_close(last[:, 0], full[:, -1], **TF_TOL)


@pytest.mark.parametrize("index", ["int", "tensor"])
def test_chunked_prefill_on_cpu_matches_jax(index):
    """S > 1 at cache_index > 0, with the index as an int (the flash
    plain version with a query offset, the kernel's route on CUDA) or as
    a 0-d tensor (the plain ``gqa_attention`` on a CPU tensor)."""
    jcfg, tcfg, jp, tp = _pair("yi-gqa")
    toks = _tokens(3, tcfg.vocab_size)
    jc = jkv.init_cache(jcfg, B, S + 4)
    tc = init_cache(tcfg, B, S + 4, "cpu")
    _, jc, _ = jax_forward(jp, jcfg, jnp.asarray(toks[:, :8]), cache=jc,
                           cache_index=0, mode="prefill")
    _, tc, _ = forward(tp, tcfg, _t(toks[:, :8]), cache=tc, mode="prefill")
    want, _, _ = jax_forward(jp, jcfg, jnp.asarray(toks[:, 8:]), cache=jc,
                             cache_index=8, mode="decode")
    at = 8 if index == "int" else torch.tensor(8)
    got, _, _ = forward(tp, tcfg, _t(toks[:, 8:]), cache=tc, cache_index=at,
                     mode="decode")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_serve_steps_generate_jax_greedy_tokens():
    """serve_prefill then serve_decode steps: last-position logits equal
    the JAX forward's, and greedy decoding picks the same tokens."""
    jcfg, tcfg, jp, tp = _pair("yi")
    prompt = _tokens(4, tcfg.vocab_size, (B, 6))
    steps = 4
    jc = jkv.init_cache(jcfg, B, 16)
    tc = init_cache(tcfg, B, 16, "cpu")
    want, jc, _ = jax_forward(jp, jcfg, jnp.asarray(prompt), cache=jc,
                              cache_index=0, mode="prefill")
    got, tc = serve_prefill(tp, tcfg, tc, _t(prompt))
    want = np.asarray(want)[:, -1]
    for step in range(steps + 1):
        assert got.shape == (B, tcfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
        nxt = got.argmax(-1, keepdim=True)
        np.testing.assert_array_equal(nxt.numpy()[:, 0], want.argmax(-1))
        if step == steps:
            break
        at = prompt.shape[1] + step
        want, jc, _ = jax_forward(jp, jcfg, jnp.asarray(nxt.numpy()),
                                  cache=jc, cache_index=at, mode="decode")
        want = np.asarray(want)[:, -1]
        got, tc = serve_decode(tp, tcfg, tc, nxt, at)


def test_cpu_forward_counts_no_launches():
    _, tcfg, _, tp = _pair("yi")
    ops.reset_launch_counts()
    cache = init_cache(tcfg, B, S + 1, "cpu")
    toks = _t(_tokens(5, tcfg.vocab_size))
    forward(tp, tcfg, toks, cache=cache, mode="prefill")
    forward(tp, tcfg, toks[:, :1], cache=cache, cache_index=S, mode="decode")
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope_matches_jax(theta):
    """Positions up to 4096: the inverse frequencies are float32
    ``theta ** (arange(half) / half)`` in both packages."""
    rng = np.random.default_rng(6)
    pos = np.stack([np.arange(0, 4097, 64), rng.integers(0, 4097, 65)])
    x = rng.standard_normal((2, 65, 3, 128)).astype(np.float32)
    jcos, jsin = jlayers.rope_angles(jnp.asarray(pos, jnp.int32), 128, theta)
    want = jlayers.apply_rope(jnp.asarray(x), jcos, jsin)
    cos, sin = layers.rope_angles(_t(pos), 128, theta)
    got = layers.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_mrope_angles_without_sections_match_jax():
    """(P, B, S) positions and no sections: every frequency takes the
    first axis, as in the JAX package."""
    pos = np.random.default_rng(8).integers(0, 4097, (3, 2, 5))
    jcos, jsin = jlayers.rope_angles(jnp.asarray(pos, jnp.int32), 16, 1e4)
    cos, sin = layers.rope_angles(_t(pos), 16, 1e4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_count_params_matches_jax(arch):
    assert count_params(configs.get_config(arch)) == \
        jax_count_params(jconfigs.get_config(arch))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_init_has_the_jax_structure(variant):
    jcfg, tcfg, jp, _ = _pair(variant)
    tp = init_params(tcfg, seed=3, device="cpu")
    conv = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tp)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), conv)
    assert sum(t.numel() for t in jax.tree.leaves(tp)) \
        == count_params(tcfg) == jax_count_params(jcfg)
    assert tp["layers"][0]["ln1"]["scale"].dtype == torch.float32


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _defaults(cls):
    return {f.name: (f.default, f.default_factory() if f.default_factory
                     is not dataclasses.MISSING else None)
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["ModelConfig", "MoEConfig", "MLAConfig",
                                  "SSMConfig", "XLSTMConfig"])
def test_config_copies_have_the_jax_fields_and_defaults(name):
    mine, ref = getattr(base, name), getattr(jbase, name)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    d_mine, d_ref = _defaults(mine), _defaults(ref)
    for key, (default, made) in d_ref.items():
        assert d_mine[key][0] == default, key
        if made is not None:
            assert _fields(d_mine[key][1]) == _fields(made), key


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_registered_configs_equal_the_jax_ones(arch, reduced):
    get = "reduced_config" if reduced else "get_config"
    mine, ref = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
    assert _fields(mine).keys() == _fields(ref).keys()
    for key, val in _fields(ref).items():
        got = _fields(mine)[key]
        assert (_fields(got) if dataclasses.is_dataclass(got) else got) == \
            (_fields(val) if dataclasses.is_dataclass(val) else val), key
    assert mine.resolved_head_dim == ref.resolved_head_dim
    assert mine.n_periods == ref.n_periods
    assert mine.flat_pattern() == ref.flat_pattern()


@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
def test_shapes_and_cache_len_match_jax(shape):
    mine, ref = configs.SHAPES[shape], jconfigs.SHAPES[shape]
    assert _fields(mine) == _fields(ref)
    assert cache_len(mine) == jax_cache_len(ref)


def test_unregistered_arch_is_refused():
    with pytest.raises(KeyError, match="not-an-arch"):
        configs.get_config("not-an-arch")
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS


def test_lm_converter_never_takes_the_conv_rule():
    """The JAX LM's stacked wq (P, D, H, hd) is 4-D: ``from_jax`` would
    transpose it as an HWIO conv weight, so it refuses an LM tree, and
    ``lm_from_jax`` copies each period's slice as it is."""
    jcfg, tcfg, jp, tp = _pair("yi-gqa")
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="lm_from_jax"):
        from_jax(tree, "cpu")
    with pytest.raises(ValueError, match="LM parameter tree"):
        from_jax({"embed": tree["embed"]}, "cpu")
    wq = tree["scan"]["b0"]["attn"]["wq"]
    assert wq.ndim == 4 and len(tp["layers"]) == tcfg.num_layers
    for j, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), wq[j])
        np.testing.assert_array_equal(
            layer["ffn"]["wo_mlp"].numpy(),
            tree["scan"]["b0"]["ffn"]["wo_mlp"][j])
    with pytest.raises(ValueError, match="scan"):
        lm_from_jax({"embed": tree["embed"]}, tcfg, "cpu")


def test_lm_converter_keeps_bfloat16():
    jcfg = dataclasses.replace(jconfigs.reduced_config("yi-9b"),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(configs.reduced_config("yi-9b"),
                               dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(1)))
    tp = lm_from_jax(tree, tcfg, "cpu")
    w = tp["layers"][1]["attn"]["wk"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), tree["scan"]["b0"]["attn"]["wk"][1].astype(
            np.float32))


def test_forward_refuses_what_it_does_not_run():
    _, tcfg, _, tp = _pair("yi")
    toks = _t(_tokens(7, tcfg.vocab_size))
    with pytest.raises(ValueError, match="mode"):
        forward(tp, tcfg, toks, mode="sample")
    with pytest.raises(ValueError, match="cache"):
        forward(tp, tcfg, toks, mode="prefill")
    with pytest.raises(ValueError, match="unknown mixer"):
        count_params(dataclasses.replace(
            tcfg, period_pattern=(("conv", "mlp"),)))
    with pytest.raises(ValueError, match="sections"):
        forward(tp, dataclasses.replace(tcfg, rope="mrope",
                                        mrope_sections=(2, 3)), toks,
                positions=torch.zeros(3, B, S, dtype=torch.long),
                mode="train")


def test_lm_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = configs.reduced_config("yi-9b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_from_jax({"scan": {}}, tcfg)
