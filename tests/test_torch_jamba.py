"""The port's Jamba serving path (Mamba, attention without RoPE, MoE)
against the JAX package, on the CPU.

Both packages get the same weights (the JAX ``init_params`` or block
inits, converted by ``repro_torch.models.convert.lm_from_jax`` or copied
leaf by leaf) and the same numpy-seeded inputs, in float32. On CPU
tensors the port's ``ops.mamba_scan`` and ``ops.swiglu`` run their plain
versions; the JAX model runs its XLA scan. Tolerance 5e-5, the JAX
package's model tolerance; the teacher-forcing invariant keeps its own
2e-3 (``tests/test_arch_smoke.py``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import kvcache as jkv
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.steps import serve_decode, serve_prefill
from repro_torch.models import layers, ssm
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import count_params, forward, init_params
from torch_threads import one_thread  # noqa: F401

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
TF_TOL = dict(atol=2e-3, rtol=2e-3)
ARCH = "jamba-v0.1-52b"
B, S = 2, 12


def _cfgs(**over):
    return (dataclasses.replace(jconfigs.reduced_config(ARCH), **over),
            dataclasses.replace(configs.reduced_config(ARCH), **over))


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
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    """The depthwise causal conv, from zeros or from a trailing context
    (decode), and its new context."""
    x, k, b, st = (_x(1, (B, 5, 24)), _x(2, (4, 24)), _x(3, (24,)),
                   _x(4, (B, 3, 24)))
    jst = jnp.asarray(st) if with_state else None
    want, wnew = jssm._causal_conv(jnp.asarray(x), jnp.asarray(k),
                                   jnp.asarray(b), jst)
    got, gnew = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(b),
                                 torch.from_numpy(st) if with_state
                                 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(gnew.numpy(), np.asarray(wnew), **MODEL_TOL)


def test_causal_conv_decode_step_keeps_the_context():
    """At S = 1 < W - 1 the new context is the old one shifted by the
    new row."""
    x, k, b, st = (_x(5, (B, 1, 8)), _x(6, (4, 8)), _x(7, (8,)),
                   _x(8, (B, 3, 8)))
    _, gnew = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(k),
                               torch.from_numpy(b), torch.from_numpy(st))
    np.testing.assert_array_equal(gnew.numpy(),
                                  np.concatenate([st[:, 1:], x], axis=1))


@pytest.mark.parametrize("with_state", [False, True])
def test_selective_scan_matches_jax(with_state):
    u, dt, B_, C_ = _x(9, (B, 7, 32)), _x(10, (B, 7, 32)), \
        _x(11, (B, 7, 8)), _x(12, (B, 7, 8))
    dt = np.log1p(np.exp(dt)).astype(np.float32) * 0.1
    A = -np.abs(_x(13, (32, 8)))
    D = _x(14, (32,))
    h0 = _x(15, (B, 32, 8)) if with_state else None
    want, wh = jssm.selective_scan(*(jnp.asarray(a) for a in
                                     (u, dt, A, B_, C_, D)),
                                   h0=None if h0 is None
                                   else jnp.asarray(h0))
    th = None if h0 is None else torch.from_numpy(h0.copy())
    got, gh = ssm.selective_scan(*(torch.from_numpy(a) for a in
                                   (u, dt, A, B_, C_, D)), h0=th)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **MODEL_TOL)
    if with_state:
        assert gh is th                          # written in place


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_matches_jax(with_state):
    jcfg, tcfg = _cfgs()
    jp = jssm.mamba_init(jax.random.PRNGKey(1), jcfg)
    tp = _torch_tree(jp)
    x = _x(16, (B, 7, tcfg.d_model))
    st = None
    if with_state:
        specs = jssm.mamba_state_specs(jcfg, B)
        st = {k: _x(17 + i, v.shape) for i, (k, v) in
              enumerate(sorted(specs.items()))}
    want, wstate = jssm.mamba_apply(
        jp, jcfg, jnp.asarray(x),
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    tstate = None if st is None else _torch_tree(st)
    got, gstate = ssm.mamba_apply(tp, tcfg, torch.from_numpy(x),
                                  state=tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert set(gstate) == set(wstate) == {"conv", "h"}
    for name in gstate:
        np.testing.assert_allclose(gstate[name].numpy(),
                                   np.asarray(wstate[name]), **MODEL_TOL)
    if with_state:
        assert all(gstate[k] is tstate[k] for k in tstate)


def _moe_case(seed, cf, T_tokens=24, E=4, skew=0.0):
    """A reduced-Jamba MoE layer and its input; ``skew`` adds that much
    to every token's router logit for expert 0 (through feature 0), so
    that expert 0 overflows."""
    jcfg, tcfg = _cfgs()
    m = dataclasses.replace(jcfg.moe, num_experts=E, capacity_factor=cf)
    jcfg = dataclasses.replace(jcfg, moe=m)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, num_experts=E, capacity_factor=cf))
    jp = jlayers.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = _x(seed + 1, (2, T_tokens // 2, tcfg.d_model))
    if skew:
        jp = dict(jp, router=jp["router"].at[0, 0].add(skew / 2))
        x[..., 0] = 2.0
    return jcfg, tcfg, jp, x


def _routing(tp, tcfg, x):
    """(top-k experts (T, K), renormalised gates, keep mask (T, K), pairs
    per expert) rebuilt from the router: a pair keeps its slot iff fewer
    than ``cap`` earlier pairs in the row-major (T * K) order chose its
    expert."""
    T, K, E = x.shape[0] * x.shape[1], tcfg.moe.top_k, tcfg.moe.num_experts
    cap = layers.moe_capacity(T, tcfg)
    xt = torch.from_numpy(x).reshape(T, -1)
    gates, idx = torch.topk(torch.softmax(xt @ tp["router"], dim=-1), K,
                            dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    seen, keep = [0] * E, []
    for e in idx.reshape(-1).tolist():
        keep.append(seen[e] < cap)
        seen[e] += 1
    return idx, gates, torch.tensor(keep).reshape(T, K), seen


@pytest.mark.parametrize("cf,skew", [(4.0, 0.0), (1.25, 0.0), (1.25, 6.0)])
def test_moe_apply_matches_jax(cf, skew):
    """The reduced config's drop-free capacity factor 4, and the
    production 1.25 without and with tokens dropped (a skewed router
    overflows expert 0): output and load-balance loss equal the JAX
    package's."""
    jcfg, tcfg, jp, x = _moe_case(20, cf, skew=skew)
    _, _, keep, _ = _routing(_torch_tree(jp), tcfg, x)
    assert bool(keep.all()) == (skew == 0.0)
    want, waux = jlayers.moe_apply(jp, jcfg, jnp.asarray(x))
    got, gaux = layers.moe_apply(_torch_tree(jp), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(gaux.item(), float(waux), **MODEL_TOL)


def test_moe_drop_order_at_the_production_capacity_factor():
    """At capacity factor 1.25 a (token, k) pair keeps its slot iff fewer
    than ``cap = max(ceil(T K cf / E), 4)`` earlier pairs in the
    row-major (T * K) order chose its expert (an exclusive cumsum); a
    dropped pair's gate weight is 0 and the kept gates are those
    renormalised over all K. Rebuilt here from the routing and held
    against both packages."""
    jcfg, tcfg, jp, x = _moe_case(30, 1.25, T_tokens=40, skew=6.0)
    T, K, E = 40, tcfg.moe.top_k, tcfg.moe.num_experts
    cap = layers.moe_capacity(T, tcfg)
    assert cap == max(math.ceil(T * K * 1.25 / E), 4) == 25
    tp = _torch_tree(jp)
    xt = torch.from_numpy(x).reshape(T, -1)
    idx, gates, keep, seen = _routing(tp, tcfg, x)
    assert not keep.all() and max(seen) > cap        # tokens were dropped
    # every pair's expert output, weighted by its gate if kept
    h = torch.stack([torch.nn.functional.silu(xt @ tp["e_wg"][e])
                     * (xt @ tp["e_wi"][e]) @ tp["e_wo"][e]
                     for e in range(E)], dim=1)      # (T, E, D)
    pair = torch.gather(h, 1, idx[..., None].expand(T, K, h.shape[-1]))
    want = (pair * (gates * keep)[..., None]).sum(1).reshape(x.shape)
    got, _ = layers.moe_apply(tp, tcfg, torch.from_numpy(x))
    jgot, _ = jlayers.moe_apply(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MODEL_TOL)
    np.testing.assert_allclose(np.asarray(jgot), want.numpy(), **MODEL_TOL)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_jamba_forward_matches_jax(mode):
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
            assert set(entry) == set(jentry)
            for name, t in entry.items():
                np.testing.assert_allclose(
                    t.numpy(), np.asarray(jentry[name])[i // per],
                    err_msg=f"layer {i} {name}", **MODEL_TOL)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_jamba_decode_matches_teacher_forcing():
    _, tcfg, _, tp = _pair()
    toks = _t(_tokens(2, tcfg.vocab_size))
    full, _, _ = forward(tp, tcfg, toks, mode="train")
    cache = init_cache(tcfg, B, S + 2, "cpu")
    _, cache, _ = forward(tp, tcfg, toks[:, :S - 1], cache=cache, mode="prefill")
    last, _, _ = forward(tp, tcfg, toks[:, S - 1:], cache=cache,
                      cache_index=S - 1, mode="decode")
    torch.testing.assert_close(last[:, 0], full[:, -1], **TF_TOL)


def test_jamba_serve_steps_generate_jax_greedy_tokens():
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


def test_converter_keeps_conv_kernels_and_expert_weights_as_they_are():
    """``lm_from_jax`` applies no conv rule: each layer's Mamba conv
    kernel stays (W, E) and the stacked 4-D expert weights (P, E, D, F)
    are cut by period, never transposed."""
    jcfg, tcfg, jp, tp = _pair()
    tree = jax.tree.map(np.asarray, jp)
    per = len(tcfg.period_pattern)
    for i, (spec, layer) in enumerate(zip(tcfg.flat_pattern(),
                                          tp["layers"])):
        src = tree["scan"][f"b{i % per}"]
        if spec[0] == "mamba":
            k = layer["mixer"]["conv_kernel"]
            assert tuple(k.shape) == (tcfg.ssm.d_conv,
                                      tcfg.ssm.expand * tcfg.d_model)
            np.testing.assert_array_equal(
                k.numpy(), src["mixer"]["conv_kernel"][i // per])
        if spec[1] == "moe":
            w = src["ffn"]["e_wi"]
            assert w.ndim == 4
            np.testing.assert_array_equal(layer["ffn"]["e_wi"].numpy(),
                                          w[i // per])


def test_jamba_init_has_the_jax_structure():
    jcfg, tcfg, jp, _ = _pair()
    tp = init_params(tcfg, seed=3, device="cpu")
    conv = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tp)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), conv)
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == count_params(tcfg)
    mixer = tp["layers"][0]["mixer"]
    N = tcfg.ssm.d_state
    np.testing.assert_allclose(torch.exp(mixer["A_log"][0]).numpy(),
                               np.arange(1, N + 1), rtol=1e-6)
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert bool(((dt > 0.001 - 1e-6) & (dt < 0.1 + 1e-6)).all())


def test_jamba_cpu_forward_counts_no_launches():
    _, tcfg, _, tp = _pair()
    ops.reset_launch_counts()
    cache = init_cache(tcfg, B, S + 1, "cpu")
    toks = _t(_tokens(5, tcfg.vocab_size))
    forward(tp, tcfg, toks, cache=cache, mode="prefill")
    forward(tp, tcfg, toks[:, :1], cache=cache, cache_index=S, mode="decode")
    assert set(ops.launch_counts().values()) == {0}
