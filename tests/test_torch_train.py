"""The LM train step against the JAX package, on the CPU: cross-entropy
with z-loss, the multi-token prediction term, the microbatch loop and
its accumulation dtypes, 8-bit moments, one AdamW step on five archs.
(``diffusion_loss``, gradient compression, ``lm_to_jax``, LM checkpoints
and ``launch.train``: ``tests/test_torch_train_io.py``.)

Both packages get the same weights (the JAX ``init_params``, converted
by ``lm_from_jax``) and the same numpy-seeded inputs, in float32 at
``reduced_config`` size. On CPU tensors the port's train route
(``"unfused"``) runs the kernels' plain versions.

Tolerances. Losses and metrics: 5e-5, the JAX package's model
tolerance. Gradients: 5e-5 of the largest entry of the leaf's module
(the leaf and its siblings in the tree) plus 5e-5 of the entry (float32
sums over a batch in another order; a bias whose gradient cancels to
zero analytically, as the sLSTM's input-gate bias under its stabiliser
does, carries float32 noise on its module's scale). The parameters after
one AdamW step are held per entry at the bound that tolerance implies:
at the first step the update is ``lr * (s + wd * p)`` with ``s = g / (|g|
+ eps)`` (g clipped), whose slope in g is at most ``eps / (max(|g| - D,
0) + eps)^2`` within D of g, so a gradient D off moves p by at most ``lr
* D`` times that, plus a few float32 roundings of s (times lr) and of
the new parameter (4 ulps of |p| + lr). It is tight where
|g| >> D and loose only for the few entries whose gradient is within D of
zero, where the update's sign is not determined by float32 gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.transformer import init_params as jax_init_params
from repro.training import train_loop as R_tl
from repro.training.optimizer import OptimizerConfig as R_OptimizerConfig
from repro_torch import configs
from repro_torch.models.convert import lm_from_jax, lm_to_jax
from repro_torch.training import train_loop as T_tl
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.tree import leaves, unflatten
from torch_threads import one_thread  # noqa: F401

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
GRAD_TOL = 5e-5
B, S = 4, 16
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_ARCHS = ["smollm-135m", "jamba-v0.1-52b", "deepseek-v3-671b",
               "xlstm-125m", "qwen2-vl-7b"]


def _pair(arch, **over):
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **over)
    tcfg = dataclasses.replace(configs.reduced_config(arch), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, seed, batch=B, length=S):
    """numpy batch: tokens or embeddings, labels, and for M-RoPE an
    image-like grid (t = 0, (h, w) over a 4-wide grid) so the causal
    mask follows t, not the slots."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (batch, length))
           .astype(np.int32)}
    if cfg.input_mode == "tokens":
        out["inputs"] = rng.integers(0, cfg.vocab_size, (batch, length)) \
            .astype(np.int32)
    else:
        out["inputs"] = rng.standard_normal(
            (batch, length, cfg.d_model)).astype(np.float32)
    if cfg.rope == "mrope":
        r = np.arange(length)
        out["positions"] = np.broadcast_to(
            np.stack([0 * r, r // 4, r % 4])[:, None],
            (3, batch, length)).astype(np.int32).copy()
    return out


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _jax_grads(jcfg, jtcfg, jp, batch, k):
    """The reference's gradient: the mean of the microbatches' (the JAX
    train step's arithmetic, float32)."""
    loss_fn = R_tl.make_loss_fn(jcfg, jtcfg)
    grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
    def part(n, v, i):
        if n == "positions":
            m = v.shape[1] // k
            return v[:, i * m:(i + 1) * m]
        m = v.shape[0] // k
        return v[i * m:(i + 1) * m]
    parts = [{n: part(n, v, i) for n, v in batch.items()}
             for i in range(k)]
    gs = [grad(jp, _j(p)) for p in parts]
    return jax.tree.map(lambda *x: sum(x) / k, *gs)


def _port_grads(tcfg, ttcfg, tp, batch, k):
    loss_fn = T_tl.make_loss_fn(tcfg, ttcfg)
    out = None
    for mb in T_tl.split_batch(_t(batch), k):
        flat = [p.detach().requires_grad_(True) for p in leaves(tp)]
        total, _ = loss_fn(unflatten(tp, flat), mb)
        g = torch.autograd.grad(total, flat, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for p, x in zip(flat, g)]
        out = g if out is None else [a + b for a, b in zip(out, g)]
    mean = unflatten(tp, [x.detach() / k for x in out])
    return [torch.from_numpy(x) for x in leaves(lm_to_jax(mean, tcfg))]


def _module_scales(tree):
    """Per leaf (``tree_flatten`` order), the largest |entry| among the
    leaf and its siblings (the leaves of its parent node)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    top = {}
    for path, x in flat:
        key = jax.tree_util.keystr(path[:-1])
        top[key] = max(top.get(key, 0.0), float(np.abs(_np(x)).max()))
    return [max(top[jax.tree_util.keystr(path[:-1])], 1e-30)
            for path, _ in flat]


def _assert_grads_close(port, ref):
    """``ref``: the JAX gradient tree; ``port``: leaves in its order."""
    scales = _module_scales(ref)
    for i, (a, b, sc) in enumerate(zip(port, jax.tree.leaves(ref), scales)):
        np.testing.assert_allclose(a.detach().numpy(), _np(b),
                                   atol=GRAD_TOL * sc, rtol=GRAD_TOL,
                                   err_msg=f"grad leaf {i}")


def _param_bound(g, p, lr, eps, clip, scale):
    """The per-entry bound on |p_port - p_jax| after one AdamW step from
    a gradient known to within D (module docstring); ``scale`` the
    leaf's module scale."""
    g = np.abs(_np(g)) * clip
    D = GRAD_TOL * scale * clip + GRAD_TOL * g
    slope = eps / (np.maximum(g - D, 0.0) + eps) ** 2
    # float32 roundings: of s (a few ulps of |s| <= 1, times lr) and of
    # the new parameter (p, or lr where the update is larger than p)
    return lr * D * slope \
        + 4 * np.finfo(np.float32).eps * (np.abs(_np(p)) + lr)


@pytest.mark.parametrize("z", [0.0, 1e-4, 0.1])
def test_cross_entropy_with_z_loss_matches_jax(z):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = R_tl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z)
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = T_tl.cross_entropy(lg, torch.from_numpy(labels), z)
    np.testing.assert_allclose(got.item(), float(want), **MODEL_TOL)
    (g,) = torch.autograd.grad(got, lg)
    jg = jax.grad(lambda x: R_tl.cross_entropy(x, jnp.asarray(labels), z))(
        jnp.asarray(logits))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **MODEL_TOL)


def test_loss_fn_with_mtp_matches_jax():
    """Reduced deepseek-v3: the CE with z-loss, the MTP term at weight
    0.3 on hidden[:, :-1] against labels[:, 1:], the MoE aux losses; the
    metrics dict and every gradient leaf."""
    jcfg, tcfg, jp, tp = _pair("deepseek-v3-671b")
    assert tcfg.mtp_depth == 1
    batch = _batch(tcfg, 3)
    jt, tt = R_tl.TrainConfig(), T_tl.TrainConfig()
    _, jm = jax.jit(R_tl.make_loss_fn(jcfg, jt))(jp, _j(batch))
    _, tm = T_tl.make_loss_fn(tcfg, tt)(tp, _t(batch))
    assert set(tm) == set(jm) == {"ce", "aux", "mtp_ce", "loss"}
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   **MODEL_TOL, err_msg=key)
    assert float(tm["aux"]) > 0
    _assert_grads_close(_port_grads(tcfg, tt, tp, batch, 1),
                        _jax_grads(jcfg, jt, jp, batch, 1))


def _check_step(arch, k, eight_bit=False):
    jcfg, tcfg, jp, tp = _pair(arch)
    batch = _batch(tcfg, 5)
    jt = R_tl.TrainConfig(opt=R_OptimizerConfig(
        **OPT, eight_bit_moments=eight_bit), microbatches=k)
    tt = T_tl.TrainConfig(opt=OptimizerConfig(
        **OPT, eight_bit_moments=eight_bit), microbatches=k)
    j_init, j_step = R_tl.make_train_step(jcfg, jt)
    t_init, t_step = T_tl.make_train_step(tcfg, tt)
    jnew, jopt, jm = jax.jit(j_step)(jp, j_init(jp), _j(batch))
    tnew, topt, tm = t_step(tp, t_init(tp), _t(batch))
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   **MODEL_TOL, err_msg=key)
    jtree = _jax_grads(jcfg, jt, jp, batch, k)
    _assert_grads_close(_port_grads(tcfg, tt, tp, batch, k), jtree)
    jg, scales = jax.tree.leaves(jtree), _module_scales(jtree)
    lr = OPT["peak_lr"]
    clip = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    eps = OptimizerConfig().eps
    want = jax.tree.leaves(lm_to_jax_tree(jnew))
    got = leaves(lm_to_jax(tnew, tcfg))
    old = jax.tree.leaves(jp)
    assert len(got) == len(want) == len(jg)
    for i, (a, b, g, p, sc) in enumerate(zip(got, want, jg, old, scales)):
        err = np.abs(_np(a) - _np(b))
        bound = _param_bound(g, p, lr, eps, clip, sc)
        assert (err <= bound).all(), (i, float(err.max()),
                                      float(bound[err > bound].min()))
    assert int(topt.count) == int(jopt.count) == 1
    return jcfg, tcfg, jopt, topt


def lm_to_jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_jax(arch, k):
    """One AdamW step, whole-batch and in two microbatches, on the four
    archs of the JAX package's train-step smoke test plus qwen2-vl with
    M-RoPE positions on an image-like grid: metrics at 5e-5, gradients
    and parameters as the module docstring states."""
    _check_step(arch, k)


def test_8bit_moment_step_matches_jax():
    """8-bit moments in two microbatches (float32 weights, so the sums
    are in float32 on both sides): the step as above, and each moment
    within one quantization level of the reference's (a value on a
    rounding edge may go either way)."""
    jcfg, tcfg, jopt, topt = _check_step("smollm-135m", 2, eight_bit=True)
    for field in ("m", "v"):
        qs = leaves(lm_to_jax(getattr(topt, field), tcfg))
        ss = leaves(lm_to_jax(getattr(topt, field + "_scale"), tcfg))
        jq = jax.tree.leaves(getattr(jopt, field))
        js = jax.tree.leaves(getattr(jopt, field + "_scale"))
        for q, s, a, b in zip(qs, ss, jq, js):
            np.testing.assert_allclose(s, np.asarray(b), rtol=1e-4,
                                       atol=1e-12)
            assert q.dtype == np.int8
            assert np.abs(q.astype(np.int32)
                          - np.asarray(a).astype(np.int32)).max() <= 1


def test_microbatch_sums_take_the_jax_dtype_rule(monkeypatch):
    """The gradient handed to the optimizer after microbatching: bf16
    for bf16 weights under 8-bit moments, float32 otherwise, leaf for
    leaf as the JAX step hands it (both optimizers' ``update`` spied)."""
    import repro.training.train_loop as R_mod
    import repro_torch.training.train_loop as T_mod
    seen = {}

    def spy(mod, key, leaves_of):
        real = mod.make_adamw

        def make(cfg):
            init, update = real(cfg)

            def upd(grads, state, params):
                seen[key] = [str(x.dtype).split(".")[-1]
                             for x in leaves_of(grads)]
                return update(grads, state, params)
            return init, upd
        monkeypatch.setattr(mod, "make_adamw", make)
    jcfg, tcfg, jp, tp = _pair("smollm-135m", dtype="bfloat16")
    spy(R_mod, "jax", jax.tree.leaves)
    spy(T_mod, "port", lambda g: leaves(lm_to_jax(g, tcfg)))
    for eight in (True, False):
        batch = _batch(tcfg, 6)
        opt = dict(**OPT, eight_bit_moments=eight)
        j_init, j_step = R_mod.make_train_step(jcfg, R_tl.TrainConfig(
            opt=R_OptimizerConfig(**opt), microbatches=2))
        t_init, t_step = T_mod.make_train_step(tcfg, T_tl.TrainConfig(
            opt=OptimizerConfig(**opt), microbatches=2))
        jax.jit(j_step)(jp, j_init(jp), _j(batch))
        t_step(tp, t_init(tp), _t(batch))
        assert seen["port"] == seen["jax"]
        assert ("bfloat16" in seen["port"]) == eight
        assert ("float32" in seen["port"])


def test_split_batch_cuts_mrope_positions_on_the_batch_axis():
    pos = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    x = torch.arange(4 * 5).reshape(4, 5)
    parts = T_tl.split_batch({"positions": pos, "inputs": x}, 2)
    assert [tuple(p["positions"].shape) for p in parts] == [(3, 2, 5)] * 2
    torch.testing.assert_close(parts[1]["positions"], pos[:, 2:])
    torch.testing.assert_close(parts[1]["inputs"], x[2:])
    with pytest.raises(ValueError, match="microbatches"):
        T_tl.split_batch({"inputs": x}, 3)


def test_train_route_runs_no_kernel_dispatch(monkeypatch):
    """The train step takes the plain versions directly (``unfused``):
    no ``ops`` dispatcher is called, so on CUDA no kernel refuses the
    gradient."""
    from repro_torch.kernels import ops
    calls = []
    for name in ops.PLAIN:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    _, tcfg, _, tp = _pair("smollm-135m")
    t_init, t_step = T_tl.make_train_step(tcfg, T_tl.TrainConfig(
        opt=OptimizerConfig(**OPT)))
    _, _, m = t_step(tp, t_init(tp), _t(_batch(tcfg, 9)))
    assert torch.isfinite(m["loss"]) and calls == []
