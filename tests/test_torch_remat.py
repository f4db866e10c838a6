"""Recomputation in the port's train step (``repro_torch/remat.py``)
against the JAX package's ``jax.checkpoint`` sites, on the CPU.

* Per-period ``remat`` (``models/transformer.py`` ``forward``): the
  train step under ``dots_nb`` (smollm-135m, xlstm-125m, jamba-v0.1-52b)
  and ``full`` (deepseek-v3-671b, its prefix layer and MTP head) equals
  the JAX package's under the same policy, at the tolerances of
  ``tests/test_torch_train.py`` (metrics 5e-5, parameters at the bound
  Adam's first step puts on 5e-5 gradients), and the port's own
  ``remat="none"`` step bit for bit (a checkpoint recomputes the same
  ops on the same values); each period of the body, and no prefix block,
  runs under one checkpoint; what a period keeps for the backward is
  what its policy saves; ``dots_nb`` tells a product's batch dims by its
  operands' leading dim.
* The plain attention in 1024-row query chunks (``kernels/ref.py``
  ``query_chunks``): ``flash_attention_ref`` and the plain GQA attention
  at 2048 query rows equal their whole computation at 3e-5, in values
  and gradients, and the JAX package's ``gqa_attention``; forward and
  backward allocate no tile larger than one chunk's scores.
* The recurrences' 256-step chunks under checkpoint: at 512 steps the
  outputs, final states and gradients equal those without the
  checkpoint bit for bit, at a lower peak of live bytes.
* Serving unchanged: prefill and decode under ``dots_nb`` run the same
  ops as under ``none`` and give the same outputs bit for bit, and a
  ``train`` forward under ``no_grad`` checkpoints nothing.
* An unknown ``remat`` raises.

About 100-130 s of wall on one torch thread, alone or on its worker in
the whole suite (the four JAX train steps and the 2048-row attention
cases most of it).
"""
import dataclasses
import functools
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.models.layers import gqa_attention as jax_gqa_attention
from repro_torch import configs, remat
from repro_torch.analysis.count import Live
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.kvcache import init_cache
from repro_torch.training import train_loop as T_tl
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.tree import leaves
from test_torch_train import OPT, _batch, _check_step, _pair, _t
from torch_threads import one_thread  # noqa: F401

ATTN_TOL = dict(atol=3e-5, rtol=3e-5)
F32 = 4


# ---------------------------------------------------------------------------
# Per-period remat: the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,policy", [
    ("smollm-135m", "dots_nb"), ("xlstm-125m", "dots_nb"),
    ("jamba-v0.1-52b", "dots_nb"), ("deepseek-v3-671b", "full")])
def test_train_step_under_remat_matches_jax_and_none(arch, policy):
    _, tcfg, _, topt, (tnew, tm) = _check_step(arch, 1, remat=policy)
    assert tcfg.remat == policy
    _, none_cfg, _, tp = _pair(arch)
    assert none_cfg.remat == "none"
    t_init, t_step = T_tl.make_train_step(none_cfg, T_tl.TrainConfig(
        opt=OptimizerConfig(**OPT)))
    new, opt, m = t_step(tp, t_init(tp), _t(_batch(none_cfg, 5)))
    assert set(m) == set(tm)
    for key in m:
        assert torch.equal(m[key], tm[key]), key
    for a, b in zip(leaves(new) + leaves(opt.m) + leaves(opt.v),
                    leaves(tnew) + leaves(topt.m) + leaves(topt.v)):
        assert torch.equal(a, b)


def _spans(monkeypatch):
    """The first block of every period ``forward`` checkpoints, in order,
    and the policies they ran under."""
    seen = []
    real = remat.recompute

    def spy(fn, *args, remat="full"):
        if isinstance(fn, functools.partial) \
                and fn.func.__name__ == "period_blocks":
            seen.append((fn.args[0], remat))
        return real(fn, *args, remat=remat)
    monkeypatch.setattr(remat, "recompute", spy)
    return seen


@pytest.mark.parametrize("arch,policy", [
    ("deepseek-v3-671b", "full"), ("jamba-v0.1-52b", "dots_nb"),
    ("xlstm-125m", "dots"), ("smollm-135m", "dots_nb")])
def test_forward_checkpoints_each_period_not_the_prefix(monkeypatch, arch,
                                                        policy):
    """Each period of ``len(period_pattern)`` blocks after the prefix runs
    under one checkpoint of ``cfg.remat``; the prefix blocks and the MTP
    head run outside, and a forward that autograd does not record runs
    none."""
    cfg = dataclasses.replace(configs.reduced_config(arch), remat=policy)
    seen = _spans(monkeypatch)
    params = T.init_params(cfg, 0, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    toks = torch.arange(12).reshape(2, 6) % cfg.vocab_size
    _, _, _, hidden = T.forward(params, cfg, toks, return_hidden=True,
                                impl="unfused")
    n, period = len(cfg.prefix_pattern), len(cfg.period_pattern)
    want = [(i, policy) for i in range(n, cfg.num_layers, period)]
    assert len(want) == cfg.n_periods == 2
    assert seen == want
    if cfg.mtp_depth:
        T.mtp_logits(params, cfg, hidden, toks, impl="unfused")
        assert seen == want
    with torch.no_grad():
        T.forward(params, cfg, toks, impl="unfused")
    assert seen == want


class _Made(TorchDispatchMode):
    """The storages that the ops run under it make, while they live
    ({id: (op, output shape)}), and every product it runs (op, whether it
    has batch dims)."""

    def __init__(self):
        super().__init__()
        self.made, self.products = {}, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if remat.is_product(func):
            self.products.append((func, remat.has_batch_dims(func, *args)))
        out = func(*args, **kwargs)
        ins = {id(a.untyped_storage()) for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if id(st) in ins or id(st) in self.made:
                continue
            self.made[id(st)] = (func, tuple(t.shape))
            weakref.finalize(st, self.made.pop, id(st), None).atexit = False
        return out


def _period_keeps(monkeypatch, policy):
    """A one-period reduced smollm-135m (one attention + SwiGLU block)
    forward under ``policy``, the period watched by ``_Made`` (its
    checkpoint's call, or under ``none`` its block's): (the storages made
    in the period that are live after the forward, its output's aside;
    its products; B, S, H)."""
    cfg = dataclasses.replace(configs.reduced_config("smollm-135m"),
                              num_layers=1, remat=policy, vocab_size=100)
    params = T.init_params(cfg, 0, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    B, S = 2, 24
    modes = []

    def watched(fn, *args):
        mode = _Made()
        modes.append(mode)
        with mode:
            out = fn(*args)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                mode.made.pop(id(t.untyped_storage()), None)
        return out

    if policy == "none":
        real = T.block_apply
        monkeypatch.setattr(T, "block_apply", lambda *a, **k: watched(
            functools.partial(real, *a, **k)))
    else:
        real = remat.recompute
        monkeypatch.setattr(remat, "recompute", lambda fn, *a, remat: watched(
            functools.partial(real, fn, remat=remat), *a))
    toks = (torch.arange(B * S).reshape(B, S) * 7) % cfg.vocab_size
    logits, _, _ = T.forward(params, cfg, toks, impl="unfused")
    assert len(modes) == 1
    kept = list(modes[0].made.values())
    logits.sum().backward()
    return kept, modes[0].products, B, S, cfg.num_heads


@pytest.mark.parametrize("policy", ["dots_nb", "dots", "full", "none"])
def test_period_keeps_what_its_policy_saves(monkeypatch, policy):
    """After the forward a period holds, besides its output: under
    ``dots_nb`` the outputs of its weight products (q, k, v, the output
    projection, gate, up, down: seven ``mm``) and no (B, H, S, S) score
    tensor; under ``dots`` also attention's two batched products (the
    scores and the weighted values); under ``full`` nothing (its input
    is the caller's); under ``none`` (no checkpoint) whatever each op
    saves, the float32 softmax (B, KH, G, S, S) among it."""
    kept, products, B, S, H = _period_keeps(monkeypatch, policy)
    assert sorted(b for _, b in products) == [False] * 7 + [True] * 2
    aten = torch.ops.aten
    kept_products = [k for k in kept if remat.is_product(k[0])]
    # a (B, H, S, S) tile in any layout: attention's first product
    # lowers to a bmm of (B * KH, G * S, S)
    scores = [k for k in kept if math.prod(k[1]) == B * H * S * S]
    if policy == "dots_nb":
        assert len(kept) == len(kept_products) == 7
        assert all(k[0] == aten.mm.default for k in kept)
        assert not scores
    elif policy == "dots":
        assert len(kept) == len(kept_products) == 9
        assert [k[0] for k in scores] == [aten.bmm.default]
    elif policy == "full":
        assert kept == []
    else:
        assert aten._softmax.default in [k[0] for k in scores]
        assert len(kept) > 9


def test_dots_nb_reads_the_leading_dim():
    """A ``bmm`` whose batch is 1 (a no-batch ``einsum``) counts as a
    weight product; one of batch B x H does not; ``mm``/``addmm`` never
    have batch dims. The einsums of the port lower as stated."""
    aten = torch.ops.aten
    a1, b1 = torch.ones(1, 6, 4), torch.ones(1, 4, 5)
    a8, b8 = torch.ones(8, 6, 4), torch.ones(8, 4, 5)
    assert not remat.has_batch_dims(aten.bmm.default, a1, b1)
    assert remat.has_batch_dims(aten.bmm.default, a8, b8)
    assert not remat.has_batch_dims(aten.baddbmm.default,
                                    torch.ones(6, 5), a1, b1)
    assert remat.has_batch_dims(aten.baddbmm.default, torch.ones(6, 5),
                                a8, b8)
    assert not remat.has_batch_dims(aten.mm.default, a8[0], b8[0])
    assert not remat.has_batch_dims(aten.addmm.default, torch.ones(5),
                                    a8[0], b8[0])
    assert not remat.is_product(aten.add.Tensor)
    seen = []

    class _Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if remat.is_product(func):
                seen.append((func, tuple(args[0].shape),
                             remat.has_batch_dims(func, *args)))
            return func(*args, **(kwargs or {}))
    x, w = torch.ones(2, 5, 4), torch.ones(4, 3, 2)
    q = torch.ones(2, 5, 3, 2)
    with _Ops():
        torch.einsum("bsd,dhk->bshk", x, w)
        torch.einsum("bshd,bthd->bhst", q, q)
        x @ w.reshape(4, 6)
    assert seen == [(aten.bmm.default, (1, 10, 4), False),
                    (aten.bmm.default, (6, 5, 2), True),
                    (aten.mm.default, (10, 4), False)]


# ---------------------------------------------------------------------------
# The plain attention in query chunks
# ---------------------------------------------------------------------------
# (q rows, k/v rows, q_offset or None, kv_len or None, positions): a
# fresh 2048 x 2048 call, a 2048-row prompt chunk at offset 1024 over a
# 3072-row cache with 2900 rows live, and query positions that hold
# every row back a little (t = slot - slot % 3)
ATTN_CASES = {"same": (2048, 2048, None, None, False),
              "offset": (2048, 3072, 1024, 2900, False),
              "positions": (2048, 2048, None, None, True)}
B_ATT, H_ATT, KH_ATT, D_ATT = 1, 2, 1, 8


def _attn_inputs(case):
    Sq, Sk, off, kv_len, pos = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B_ATT, Sq, H_ATT, D_ATT)).astype(np.float32)
    k = rng.standard_normal((B_ATT, Sk, KH_ATT, D_ATT)).astype(np.float32)
    v = rng.standard_normal((B_ATT, Sk, KH_ATT, D_ATT)).astype(np.float32)
    qpos = (off or 0) + np.arange(Sq)
    if pos:
        qpos = qpos - qpos % 3
    qpos = np.broadcast_to(qpos, (B_ATT, Sq)).astype(np.int32).copy()
    return q, k, v, qpos, off, kv_len


def _port_attn(fn, case, q, k, v, qpos, off, kv_len):
    if fn == "flash":
        kw = {"q_positions": torch.from_numpy(qpos).long()} \
            if ATTN_CASES[case][4] else {"q_offset": off or 0}
        return ref.flash_attention_ref(q, k, v, kv_len=kv_len, **kw)
    valid = None if kv_len is None \
        else torch.full((B_ATT,), kv_len, dtype=torch.long)
    return L.gqa_attention(q, k, v, q_positions=torch.from_numpy(qpos).long(),
                           kv_valid_len=valid)


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("fn", ["flash", "gqa"])
def test_query_chunks_match_whole_and_jax(monkeypatch, fn, case):
    q, k, v, qpos, off, kv_len = _attn_inputs(case)
    Sq, Sk = q.shape[1], k.shape[1]
    cot = np.random.default_rng(4).standard_normal(q.shape).astype(
        np.float32)

    def run():
        ts = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (q, k, v)]
        with Live() as live:
            out = _port_attn(fn, case, *ts, qpos, off, kv_len)
            grads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
        return out.detach(), grads, live.largest["bytes"]

    got, got_g, largest = run()
    chunk = B_ATT * H_ATT * ref.QUERY_CHUNK * Sk * F32
    assert largest <= chunk < B_ATT * H_ATT * Sq * Sk * F32
    monkeypatch.setattr(ref, "QUERY_CHUNK", 1 << 30)
    want, want_g, whole = run()
    assert whole >= B_ATT * H_ATT * Sq * Sk * F32
    torch.testing.assert_close(got, want, **ATTN_TOL)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, **ATTN_TOL)
    # the JAX package's attention (its own 1024-row chunks), values and
    # gradients
    valid = None if kv_len is None else jnp.full((B_ATT,), kv_len)

    def jfn(q, k, v):
        return jax_gqa_attention(q, k, v, q_positions=jnp.asarray(qpos),
                                 kv_valid_len=valid)
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), **ATTN_TOL)
    for a, b in zip(got_g, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ATTN_TOL)


# ---------------------------------------------------------------------------
# The recurrences' chunks under checkpoint
# ---------------------------------------------------------------------------
def _mlstm_inputs(rng, B=2, T=512, H=2, dh=8):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return ([f(B, T, H, dh), f(B, T, H, dh) * dh ** -0.5, f(B, T, H, dh),
             f(B, T, H), f(B, T, H) + 2.0],
            [np.zeros((B, H, dh, dh), np.float32),
             np.zeros((B, H, dh), np.float32),
             np.full((B, H), -np.inf, np.float32)])


def _mamba_inputs(rng, B=2, T=512, E=8, N=4):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return ([f(B, T, E), np.log1p(np.exp(f(B, T, E))), -np.exp(f(E, N)),
             f(B, T, N), f(B, T, N), f(E)],
            [np.zeros((B, E, N), np.float32)])


RECURRENCES = {"mlstm": (ref.mlstm_chunk_ref, _mlstm_inputs),
               "mamba": (ref.mamba_scan_ref, _mamba_inputs)}


@pytest.mark.parametrize("name", list(RECURRENCES))
def test_recurrence_chunks_checkpoint_changes_no_value(monkeypatch, name):
    """Two 256-step chunks under grad: the same output, final state and
    gradient of every input, bit for bit, with and without the chunks'
    checkpoints; the checkpointed run's peak of live bytes lower."""
    fn, make = RECURRENCES[name]
    xs, states = make(np.random.default_rng(7))
    cot = None

    def run():
        nonlocal cot
        ins = [torch.from_numpy(x).requires_grad_(True) for x in xs]
        st = [torch.from_numpy(s.copy()) for s in states]
        with Live() as live:
            out = fn(*ins, *st)
            if cot is None:
                cot = torch.randn(out.shape, generator=torch.Generator(
                ).manual_seed(8))
            grads = torch.autograd.grad(out, ins, cot)
        return out.detach(), st, grads, live.peak

    got = run()
    real = remat.records
    monkeypatch.setattr(remat, "records", lambda *a: False)
    want = run()
    monkeypatch.setattr(remat, "records", real)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1] + list(got[2]), want[1] + list(want[2])):
        assert torch.equal(a, b)
    assert got[3] < want[3]


# ---------------------------------------------------------------------------
# Serving unchanged
# ---------------------------------------------------------------------------
class _Trace(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["smollm-135m", "xlstm-125m"])
def test_serving_forward_runs_as_without_remat(monkeypatch, arch):
    """Prefill and decode (the cache written in place) under ``dots_nb``,
    with grad on and parameters that require it, and a ``train`` forward
    under ``no_grad``: the same ops, outputs and caches as under
    ``none``, bit for bit, and no checkpoint."""
    seen = _spans(monkeypatch)
    out = {}
    for policy in ("none", "dots_nb"):
        cfg = dataclasses.replace(configs.reduced_config(arch),
                                  remat=policy)
        params = T.init_params(cfg, 0, "cpu")
        for p in leaves(params):
            p.requires_grad_(True)
        toks = (torch.arange(2 * 9).reshape(2, 9) * 5) % cfg.vocab_size
        cache = init_cache(cfg, 2, 12, "cpu")
        with _Trace() as tr:
            pre, cache, _ = T.forward(params, cfg, toks[:, :8], cache=cache,
                                      mode="prefill")
            dec, cache, _ = T.forward(params, cfg, toks[:, 8:], cache=cache,
                                      cache_index=8, mode="decode")
            with torch.no_grad():
                train, _, _ = T.forward(params, cfg, toks, impl="unfused")
        out[policy] = (tr.ops, [pre, dec, train], leaves(cache))
    assert seen == []
    (ops0, outs0, c0), (ops1, outs1, c1) = out["none"], out["dots_nb"]
    assert ops0 == ops1
    for a, b in zip(outs0 + c0, outs1 + c1):
        assert torch.equal(a, b)


def test_unknown_remat_raises():
    cfg = dataclasses.replace(configs.reduced_config("smollm-135m"),
                              remat="dots_with_no_batch_dims")
    params = T.init_params(cfg, 0, "cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="remat"):
        T.forward(params, cfg, toks)
    with pytest.raises(ValueError, match="remat"):
        remat.recompute(torch.exp, toks.float(), remat="none")
