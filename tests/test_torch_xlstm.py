"""The port's xLSTM serving path against the JAX package, on the CPU.

Both packages get the same weights (the JAX ``init_params`` or block
inits, converted by ``repro_torch.models.convert.lm_from_jax`` or copied
leaf by leaf) and the same numpy-seeded inputs, in float32. On CPU
tensors the port's ``ops.mlstm_chunk`` runs its plain version; the JAX
model runs its XLA scan. Tolerance 5e-5, the JAX package's model
tolerance; the teacher-forcing invariant keeps its own 2e-3
(``tests/test_arch_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import kvcache as jkv
from repro.models import xlstm as jxlstm
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.steps import serve_decode, serve_prefill
from repro_torch.models import xlstm
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import count_params, forward, init_params
from torch_threads import one_thread  # noqa: F401

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
TF_TOL = dict(atol=2e-3, rtol=2e-3)
ARCH = "xlstm-125m"
B, S = 2, 12


def _cfgs():
    return jconfigs.reduced_config(ARCH), configs.reduced_config(ARCH)


def _pair():
    jcfg, tcfg = _cfgs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, vocab, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_state(specs, seed):
    """A non-zero state of the JAX package's specs, as numpy: what a
    cache holds mid-sequence (n positive, as sums of exp gates make it)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sds in specs.items():
        a = rng.standard_normal(sds.shape).astype(np.float32) * 0.5
        out[name] = np.abs(a) + 0.1 if name == "n" else a
    return out


def _assert_state(got, want):
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(want[name]),
                                   err_msg=name, **MODEL_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_apply_matches_jax(with_state):
    jcfg, tcfg = _cfgs()
    jp = jxlstm.mlstm_init(jax.random.PRNGKey(1), jcfg)
    tp = _torch_tree(jp)
    x = _x(2, (B, 7, tcfg.d_model))
    st = _jax_state(jxlstm.mlstm_state_specs(jcfg, B), 3) \
        if with_state else None
    want, wstate = jxlstm.mlstm_apply(
        jp, jcfg, jnp.asarray(x),
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    tstate = None if st is None else _torch_tree(st)
    got, gstate = xlstm.mlstm_apply(tp, tcfg, torch.from_numpy(x),
                                    state=tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _assert_state(gstate, wstate)
    if with_state:                          # written in place
        assert all(gstate[k] is tstate[k] for k in tstate)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_matches_jax(with_state):
    jcfg, tcfg = _cfgs()
    jp = jxlstm.slstm_init(jax.random.PRNGKey(4), jcfg)
    tp = _torch_tree(jp)
    x = _x(5, (B, 6, tcfg.d_model))
    st = _jax_state(jxlstm.slstm_state_specs(jcfg, B), 6) \
        if with_state else None
    want, wstate = jxlstm.slstm_apply(
        jp, jcfg, jnp.asarray(x),
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    tstate = None if st is None else _torch_tree(st)
    got, gstate = xlstm.slstm_apply(tp, tcfg, torch.from_numpy(x),
                                    state=tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _assert_state(gstate, wstate)
    if with_state:
        assert all(gstate[k] is tstate[k] for k in tstate)


def test_slstm_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the sLSTM's
    up projection uses it. With pre-activations of order 1-3 the erf
    form is off by more than the tolerance, so the match pins the form."""
    jcfg, tcfg = _cfgs()
    jp = jxlstm.slstm_init(jax.random.PRNGKey(7), jcfg)
    jp = dict(jp, up_proj=jp["up_proj"] * 8.0)
    tp = _torch_tree(jp)
    x = _x(8, (1, 4, tcfg.d_model))
    want, _ = jxlstm.slstm_apply(jp, jcfg, jnp.asarray(x))
    got, _ = xlstm.slstm_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    erf = torch.nn.functional.gelu
    torch.nn.functional.gelu = lambda v, approximate="none": erf(v)
    try:
        off, _ = xlstm.slstm_apply(tp, tcfg, torch.from_numpy(x))
    finally:
        torch.nn.functional.gelu = erf
    assert np.abs(off.numpy() - np.asarray(want)).max() > 10 * 5e-5


@pytest.mark.parametrize("d_model,want", [(768, 1024), (64, 85), (96, 128)])
def test_slstm_up_projection_width_is_truncated(d_model, want):
    """``int(4/3 * D)``: 1024 at the full width, 85 (not 86) at the
    reduced width; the JAX init has the same shapes."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, d_model=d_model)
    tcfg = dataclasses.replace(tcfg, d_model=d_model)
    assert xlstm.slstm_up_dim(tcfg) == want
    jp = jxlstm.slstm_init(jax.random.PRNGKey(0), jcfg)
    tp = xlstm.slstm_init(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert tp["up_proj"].shape == (d_model, want)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_xlstm_forward_matches_jax(mode):
    jcfg, tcfg, jp, tp = _pair()
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
        per = len(jcfg.period_pattern)
        for i, entry in enumerate(tc):
            jentry = jc["scan"][f"b{i % per}"]
            _assert_state(entry, {k: np.asarray(v)[i // per]
                                  for k, v in jentry.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_xlstm_decode_matches_teacher_forcing():
    _, tcfg, _, tp = _pair()
    toks = _t(_tokens(2, tcfg.vocab_size))
    full, _, _ = forward(tp, tcfg, toks, mode="train")
    cache = init_cache(tcfg, B, S + 2, "cpu")
    _, cache, _ = forward(tp, tcfg, toks[:, :S - 1], cache=cache, mode="prefill")
    last, _, _ = forward(tp, tcfg, toks[:, S - 1:], cache=cache,
                      cache_index=S - 1, mode="decode")
    torch.testing.assert_close(last[:, 0], full[:, -1], **TF_TOL)


def test_xlstm_serve_steps_generate_jax_greedy_tokens():
    """serve_prefill then serve_decode steps: last-position logits equal
    the JAX forward's, and greedy decoding picks the same tokens."""
    jcfg, tcfg, jp, tp = _pair()
    prompt = _tokens(4, tcfg.vocab_size, (B, 6))
    jc = jkv.init_cache(jcfg, B, 16)
    tc = init_cache(tcfg, B, 16, "cpu")
    want, jc, _ = jax_forward(jp, jcfg, jnp.asarray(prompt), cache=jc,
                              cache_index=0, mode="prefill")
    got, tc = serve_prefill(tp, tcfg, tc, _t(prompt))
    want = np.asarray(want)[:, -1]
    for step in range(5):
        np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
        nxt = got.argmax(-1, keepdim=True)
        np.testing.assert_array_equal(nxt.numpy()[:, 0], want.argmax(-1))
        if step == 4:
            break
        at = prompt.shape[1] + step
        want, jc, _ = jax_forward(jp, jcfg, jnp.asarray(nxt.numpy()),
                                  cache=jc, cache_index=at, mode="decode")
        want = np.asarray(want)[:, -1]
        got, tc = serve_decode(tp, tcfg, tc, nxt, at)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_init_cache_matches_jax(arch, dtype):
    """Entries per layer with the JAX cache's names, shapes and dtypes
    (conv in the cache dtype, recurrent state in float32), zero except
    every stabiliser ``m``, which starts at -inf (``fix_m``)."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(configs.reduced_config(arch), dtype=dtype)
    jc = jkv.init_cache(jcfg, 3, 8)
    tc = init_cache(tcfg, 3, 8, "cpu")
    per = len(jcfg.period_pattern)
    assert len(tc) == tcfg.num_layers and not jc["prefix"]
    for i, entry in enumerate(tc):
        want = {k: np.asarray(v.astype(jnp.float32))[i // per]
                for k, v in jc["scan"][f"b{i % per}"].items()}
        dts = {k: str(v.dtype) for k, v in jc["scan"][f"b{i % per}"].items()}
        assert set(entry) == set(want)
        for name, t in entry.items():
            assert tuple(t.shape) == want[name].shape, name
            assert str(t.dtype).split(".")[-1] == dts[name], name
            np.testing.assert_array_equal(t.float().numpy(), want[name])
        if "m" in entry:
            assert torch.isneginf(entry["m"]).all()


def test_xlstm_init_has_the_jax_structure():
    jcfg, tcfg, jp, _ = _pair()
    tp = init_params(tcfg, seed=3, device="cpu")
    conv = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tp)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), conv)
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == count_params(tcfg)
    mixer = tp["layers"][0]["mixer"]
    np.testing.assert_array_equal(mixer["f_bias"].numpy(),
                                  np.linspace(3, 6, tcfg.num_heads))


def test_xlstm_cpu_forward_counts_no_launches():
    _, tcfg, _, tp = _pair()
    ops.reset_launch_counts()
    cache = init_cache(tcfg, B, S + 1, "cpu")
    toks = _t(_tokens(5, tcfg.vocab_size))
    forward(tp, tcfg, toks, cache=cache, mode="prefill")
    forward(tp, tcfg, toks[:, :1], cache=cache, cache_index=S, mode="decode")
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_recurrent_entry_points_default_to_cuda(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = configs.reduced_config(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_from_jax({"scan": {}}, tcfg)
