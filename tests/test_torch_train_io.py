"""The rest of the training slice against the JAX package, on the CPU:
``diffusion_loss`` on the JAX package's toy UNet, gradient compression
(top-k, int8, error feedback), ``lm_to_jax``, LM checkpoints written by
either package and loaded by the other, and ``python -m
repro_torch.launch.train`` with resume. (The LM train step:
``tests/test_torch_train.py``.)

Same weights and numpy-seeded inputs on both sides, float32 unless a
case says otherwise. Tolerances: the loss at 5e-5 (the JAX package's
model tolerance); gradients at 5e-5 of their module's largest entry plus
5e-5 of the entry (as in ``tests/test_torch_train.py``); compression
exact where the arithmetic is (top-k, int8) and 1e-6 where a float32
sum enters (error feedback); checkpoints bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.checkpoint as R_ck
from repro import configs as jconfigs
from repro.config.base import DiffusionConfig as R_DiffusionConfig
from repro.models.diffusion import diffusion_loss as r_diffusion_loss
from repro.models.transformer import init_params as jax_init_params
from repro.models.unet import init_unet as r_init_unet
from repro.training import grad_compress as R_gc
from repro.training import train_loop as R_tl
from repro.training.optimizer import OptimizerConfig as R_OptimizerConfig
from repro_torch import configs
from repro_torch.config.base import DiffusionConfig
from repro_torch.launch import train as T_train
from repro_torch.models.convert import (from_jax, lm_from_jax, lm_to_jax,
                                        to_jax)
from repro_torch.models.diffusion import diffusion_loss
from repro_torch.models.transformer import init_params
from repro_torch.training import checkpoint as T_ck
from repro_torch.training import grad_compress as T_gc
from repro_torch.training import train_loop as T_tl
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.tree import leaves, unflatten
from torch_threads import one_thread  # noqa: F401

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
GRAD_TOL = 5e-5
REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _pair(arch, **over):
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **over)
    tcfg = dataclasses.replace(configs.reduced_config(arch), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, seed, batch=4, length=16):
    """numpy tokens or embeddings and labels; M-RoPE positions t = 0
    and (h, w) over a 4-wide grid."""
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


def _module_scales(tree):
    """Per leaf, the largest |entry| among the leaf and its siblings."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    top = {}
    for path, x in flat:
        key = jax.tree_util.keystr(path[:-1])
        top[key] = max(top.get(key, 0.0), float(np.abs(np.asarray(x)).max()))
    return [max(top[jax.tree_util.keystr(path[:-1])], 1e-30)
            for path, _ in flat]


def _toy_diffusion():
    kw = dict(name="toy", image_size=8, in_channels=3, base_channels=16,
              channel_mults=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
              num_steps=4, text_dim=32)
    return R_DiffusionConfig(**kw), DiffusionConfig(**kw)


def test_diffusion_loss_matches_jax():
    """The toy UNet of the JAX package's own test: t and noise drawn as
    ``diffusion_loss`` draws them (``jax.random.split(key)``) and passed
    to the port; the loss at 5e-5, every gradient leaf as stated above."""
    jcfg, tcfg = _toy_diffusion()
    key = jax.random.PRNGKey(0)
    jp = r_init_unet(key, jcfg)
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x0 = np.random.default_rng(7).standard_normal((2, 8, 8, 3)) \
        .astype(np.float32)
    toks = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    kt, kn = jax.random.split(key)
    t = np.array(jax.random.randint(kt, (2,), 0, 1000))
    noise = np.array(jax.random.normal(kn, x0.shape, jnp.float32))
    want, jg = jax.jit(jax.value_and_grad(r_diffusion_loss),
                       static_argnums=1)(jp, jcfg, key, jnp.asarray(x0),
                                         jnp.asarray(toks))
    flat = [p.detach().requires_grad_(True) for p in leaves(tp)]
    got = diffusion_loss(unflatten(tp, flat), tcfg, torch.from_numpy(x0),
                         torch.from_numpy(toks), t=torch.from_numpy(t),
                         noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.item(), float(want), **MODEL_TOL)
    grads = torch.autograd.grad(got, flat)
    for a, b, sc in zip(leaves(to_jax(unflatten(tp, list(grads)))),
                        jax.tree.leaves(jg), _module_scales(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=GRAD_TOL * sc, rtol=GRAD_TOL)


def test_diffusion_loss_draws_from_an_explicit_generator():
    jcfg, tcfg = _toy_diffusion()
    tp = from_jax(jax.tree.map(np.asarray,
                               r_init_unet(jax.random.PRNGKey(1), jcfg)),
                  "cpu")
    x0 = torch.zeros(2, 8, 8, 3)
    toks = torch.zeros(2, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="Generator"):
        diffusion_loss(tp, tcfg, x0, toks)
    a = diffusion_loss(tp, tcfg, x0, toks,
                       generator=torch.Generator().manual_seed(3))
    b = diffusion_loss(tp, tcfg, x0, toks,
                       generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(a) and a.item() == b.item()


def _distinct(shape, seed):
    """Normal draws with all magnitudes distinct (``lax.top_k`` and
    ``torch.topk`` may order ties otherwise)."""
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    assert len(np.unique(np.abs(g))) == g.size
    return g


@pytest.mark.parametrize("frac", [0.1, 0.01, 1e-6])
def test_topk_compression_matches_jax(frac):
    g = _distinct((64, 32), 3)
    ji, jv, js = R_gc.compress_topk(jnp.asarray(g), frac)
    ti, tv, ts = T_gc.compress_topk(torch.from_numpy(g), frac)
    assert ti.dtype == torch.int32 and tuple(js) == ts
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        T_gc.decompress_topk(ti, tv, ts).numpy(),
        np.asarray(R_gc.decompress_topk(ji, jv, js)))


@pytest.mark.parametrize("shape", [(4, 256), (3, 100), (2, 3, 128)])
def test_int8_compression_matches_jax(shape):
    g = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jq, js = R_gc.compress_int8(jnp.asarray(g))
    tq, tsc = T_gc.compress_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        T_gc.decompress_int8(tq, tsc).numpy(),
        np.asarray(R_gc.decompress_int8(jq, js)))


def test_error_feedback_matches_jax_over_steps():
    """Three error-feedback steps over a two-leaf tree (the JAX
    package's round-trip test, continued): the sent gradients and the
    residuals equal the reference's; sent + residual carries the whole
    corrected gradient."""
    jst = R_gc.ErrorFeedbackState.init({"a": jnp.zeros((64, 32)),
                                        "b": jnp.zeros((50,))})
    tst = T_gc.ErrorFeedbackState.init({"a": torch.zeros(64, 32),
                                        "b": torch.zeros(50)})
    for step in range(3):
        g = {"a": _distinct((64, 32), 10 + step),
             "b": _distinct((50,), 20 + step)}
        resid = {k: v.numpy().copy() for k, v in tst.residual.items()}
        jout, jst = R_gc.ef_compress_step(
            {k: jnp.asarray(v) for k, v in g.items()}, jst, frac=0.1)
        tout, tst = T_gc.ef_compress_step(
            {k: torch.from_numpy(v) for k, v in g.items()}, tst, frac=0.1)
        for k in g:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       atol=1e-6)
            np.testing.assert_allclose(tst.residual[k].numpy(),
                                       np.asarray(jst.residual[k]),
                                       atol=1e-6)
            np.testing.assert_allclose(
                tout[k].numpy() + tst.residual[k].numpy(), g[k] + resid[k],
                atol=1e-6)


def _bits(x):
    """The leaf's bits as numpy (bfloat16 as uint16)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return x.view(torch.uint16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch,dtype", [
    *((a, "float32") for a in configs.ARCH_IDS),
    ("smollm-135m", "bfloat16"), ("deepseek-v3-671b", "bfloat16"),
    ("qwen2-vl-7b", "bfloat16")])
def test_lm_to_jax_inverts_lm_from_jax(arch, dtype):
    """``lm_to_jax(lm_from_jax(tree))`` is the JAX tree, bit for bit,
    for every arch (prefix layers, periods of several blocks, MLA, the
    MTP block, embedding inputs), and in bfloat16 (leaves kept as
    tensors) for a dense, an MLA and an embedding-input arch."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype=dtype)
    back = lm_to_jax(tp, tcfg)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, back)) \
        == jax.tree.structure(jax.tree.map(lambda _: 0, jp))
    for a, b in zip(leaves(back), jax.tree.leaves(jp)):
        b = np.asarray(b)
        if torch.is_tensor(a):
            assert a.dtype == torch.bfloat16 and b.dtype.name == "bfloat16"
        else:
            assert a.dtype == b.dtype
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _lm_setup(arch, eight, dtype):
    jcfg, tcfg, jp, tp = _pair(arch, dtype=dtype)
    opt = dict(**OPT, eight_bit_moments=eight)
    jstep = R_tl.make_train_step(
        jcfg, R_tl.TrainConfig(opt=R_OptimizerConfig(**opt)))
    tstep = T_tl.make_train_step(
        tcfg, T_tl.TrainConfig(opt=OptimizerConfig(**opt)))
    return jcfg, tcfg, jp, tp, jstep, tstep, _batch(tcfg, 8)


CKPT_CASES = [("smollm-135m", False, "float32"),
              ("deepseek-v3-671b", True, "bfloat16"),
              ("qwen2-vl-7b", False, "bfloat16")]


@pytest.mark.parametrize("arch,eight,dtype", CKPT_CASES)
def test_port_written_lm_checkpoint_loads_in_jax(tmp_path, arch, eight,
                                                 dtype):
    """The port saves its (params, opt_state) after one train step; the
    JAX package's ``load`` restores them into its own trees, bit for bit
    what ``lm_to_jax`` gives (the moments, and the 8-bit scales, in
    ``AdamWState``'s field order)."""
    jcfg, tcfg, jp, tp, (j_init, _), (t_init, t_step), batch = _lm_setup(
        arch, eight, dtype)
    tp, to, _ = t_step(tp, t_init(tp),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    T_ck.save(str(tmp_path), (tp, to), 1, extra={"arch": arch}, cfg=tcfg)
    (rp, ro), step, extra = R_ck.load(str(tmp_path), (jp, j_init(jp)))
    assert step == 1 and extra == {"arch": arch}
    want = leaves((lm_to_jax(tp, tcfg), [to.count, *[
        lm_to_jax(t, tcfg) for t in to[1:] if t is not None]]))
    got = jax.tree.leaves((rp, ro))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).shape == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch,eight,dtype", CKPT_CASES)
def test_jax_written_lm_checkpoint_loads_in_the_port(tmp_path, arch, eight,
                                                     dtype):
    """The reverse: the JAX package saves its (params, opt_state) after
    one train step; the port loads them into its trees, bit for bit
    ``lm_from_jax`` of each tree, with the step and extra; then the
    port's own save and load give the same bits back."""
    jcfg, tcfg, jp, tp, (j_init, j_step), (t_init, _), batch = _lm_setup(
        arch, eight, dtype)
    jp, jo, _ = jax.jit(j_step)(jp, j_init(jp),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    to = t_init(tp)
    R_ck.save(str(tmp_path), (jp, jo), 7, extra={"k": 1})
    (lp, lo), step, extra = T_ck.load(str(tmp_path), (tp, to),
                                      device="cpu", cfg=tcfg)
    assert step == 7 and extra == {"k": 1}
    np_tree = jax.tree.map(np.asarray, jp)
    for a, b in zip(leaves(lp), leaves(lm_from_jax(np_tree, tcfg, "cpu"))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(lo.count) == int(jo.count) == 1
    for field in ("m", "v", "m_scale", "v_scale"):
        jt = getattr(jo, field)
        if jt is None:
            assert getattr(lo, field) is None
            continue
        want = lm_from_jax(jax.tree.map(np.asarray, jt), tcfg, "cpu")
        for a, b in zip(leaves(getattr(lo, field)), leaves(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
    T_ck.save(str(tmp_path / "port"), (lp, lo), 8, cfg=tcfg)
    (p2, o2), _, _ = T_ck.load(str(tmp_path / "port"), (tp, to),
                               device="cpu", cfg=tcfg)
    for a, b in zip(leaves((p2, o2)), leaves((lp, lo))):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_lm_checkpoint_needs_its_config(tmp_path):
    _, tcfg, _, tp = _pair("smollm-135m")
    with pytest.raises(ValueError, match="ModelConfig"):
        T_ck.save(str(tmp_path), tp, 1)


_TRAIN_RUNNER = """
import runpy, sys
for blocked in ("jax", "jaxlib", "repro"):
    sys.modules[blocked] = None
sys.argv = ["repro_torch.launch.train", *sys.argv[1:]]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
loaded = sorted(k for k in sys.modules if sys.modules[k] is not None
                and k.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", loaded)
"""


def _train(*args):
    res = subprocess.run(
        [sys.executable, "-c", _TRAIN_RUNNER, "--device", "cpu", *args],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(SRC),
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    return res.stdout


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-vl-7b"])
def test_launch_train_resumes_from_its_checkpoint(tmp_path, arch):
    """``python -m repro_torch.launch.train --device cpu`` (no JAX, no
    ``repro`` imported): 6 steps with checkpoints every 2; then, with the
    last checkpoint removed, the same command resumes from step 4 (the
    token stream from ``default_rng(seed + 4)``, as the JAX package's
    entry point does) and writes the step-6 checkpoint that two train
    steps from the step-4 checkpoint give here, bit for bit (one thread
    on both sides)."""
    ck = tmp_path / "ck"
    seed, batch, seq = 3, 2, 16
    args = ("--arch", arch, "--steps", "6", "--batch", str(batch), "--seq",
            str(seq), "--ckpt", str(ck), "--ckpt-every", "2", "--seed",
            str(seed))
    out = _train(*args)
    assert "step    1 loss" in out and "done" in out
    assert [s for s, _ in T_ck.sorted_steps(str(ck))] == [2, 4, 6]
    os.unlink(ck / "step_6.ckpt")
    out = _train(*args)
    assert "resumed from step 4" in out and "step    5 loss" in out
    assert [s for s, _ in T_ck.sorted_steps(str(ck))] == [2, 4, 6]

    cfg = configs.reduced_config(arch)
    tp = init_params(cfg, seed, "cpu")
    opt_init, step = T_tl.make_train_step(cfg, T_tl.TrainConfig(
        opt=OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=6)))
    like = (tp, opt_init(tp))
    (params, opt), at, _ = T_ck.load(str(ck), like, step=4, device="cpu",
                                     cfg=cfg)
    assert at == 4
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = np.random.default_rng(seed + 4)
        for i in (4, 5):
            params, opt, _ = step(params, opt, T_train.make_batch(
                cfg, rng, batch, seq, seed, i, "cpu"))
    finally:
        torch.set_num_threads(threads)
    (got, got_opt), at, _ = T_ck.load(str(ck), like, device="cpu", cfg=cfg)
    assert at == 6 and int(got_opt.count) == 6
    for a, b in zip(leaves((got, got_opt)), leaves((params, opt))):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert not torch.equal(leaves(got)[0], leaves(tp)[0])


def test_launch_train_defaults_to_cuda():
    """Without ``--device`` the entry point asks for CUDA; without a card it
    raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
