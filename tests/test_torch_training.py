"""The port's offline phase against the JAX package's, on the CPU: the
training data's batches, AdamW in
both moment modes, checkpoints (the same files in both directions, the
msgpack codec byte for byte against ``msgpack``), the discriminator's
loss, gradients and train steps on converted parameters, the CUDA
kernels' grad guard, and the two entry points run on the CPU.

Tolerances. Optimizer parameters 1e-6: the same float32 operations on
the same numpy gradients, rounded in another order (summed norms,
``cos`` of another library). The discriminator's loss and gradients at
the models' 5e-5, compared first. After one full train step and along
an 8-step trajectory, parameters and losses at 5e-5 as well, with
AdamW's eps at 1e-6 in both packages: Adam's first step moves an
element by about ``lr * g / (|g| + eps)``, which at the default eps
1e-8 is ``lr * sign(g)`` for gradients as small as 2.4e-8 (some of the
discriminator's are), so where the packages round such a gradient
differently the element moves by up to ``2 * lr`` (3e-4 at the first
step's lr); at eps 1e-6 the step is a smooth function of g and every
element agrees within 5e-6. The optimizer's own tests keep eps 1e-8.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.models.efficientnet as R_eff
import repro.training.checkpoint as R_ck
import repro.training.discriminator as R_disc
import repro.training.optimizer as R_opt
from repro.config.base import DiffusionConfig as R_DiffusionConfig
from repro.models.unet import init_unet as r_init_unet
from repro.training.data import DiscriminatorBatcher as R_Batcher
import repro_torch.training.checkpoint as T_ck
import repro_torch.training.discriminator as T_disc
import repro_torch.training.optimizer as T_opt
from repro_torch.kernels import ops
from repro_torch.models.convert import from_jax, hwio_to_oihw, to_jax
from repro_torch.models.efficientnet import (DiscriminatorConfig,
                                             confidence_score)
from repro_torch.training.data import (DiscriminatorBatcher,
                                       degraded_images, natural_images)
from repro_torch.tree import leaves, map_tree, unflatten
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
CPU = torch.device("cpu")
MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
OPT_TOL = dict(atol=1e-6, rtol=1e-6)
# AdamW's eps in the train-step comparisons (the module docstring says why)
STEP_EPS = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(port, ref_np, **tol):
    """A port tree against a JAX tree (numpy leaves), leaf by leaf in
    the port's layout."""
    want = leaves(from_jax(ref_np, CPU))
    got = leaves(port)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


# ---------------------------------------------------------------------------
# data: a framework-free copy (its syntax-tree pin is in
# tests/test_torch_control.py with the other copies)
# ---------------------------------------------------------------------------
def test_batcher_draws_the_same_batches():
    a = iter(R_Batcher(rng=np.random.default_rng(3), size=8, image_size=16))
    b = iter(DiscriminatorBatcher(rng=np.random.default_rng(3), size=8,
                                  image_size=16))
    for _ in range(3):
        (xa, ya), (xb, yb) = next(a), next(b)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def test_tree_order_is_jax_tree_flatten_order():
    tree = {"z": [np.zeros(1), {"b": np.ones(2), "a": np.full(3, 2.0)}],
            "a": (np.zeros(4), None), "m": np.zeros(5)}
    want = jax.tree_util.tree_leaves(tree)
    got = leaves(tree)
    assert [g.shape for g in got] == [w.shape for w in want]
    back = unflatten(tree, [g + 1 for g in got])
    assert list(back) == list(tree) and back["a"][1] is None
    assert map_tree(lambda x: x.size, tree)["z"][1] == {"b": 2, "a": 3}
    with pytest.raises(ValueError):
        unflatten(tree, got[:-1])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_cosine_lr_matches_over_a_step_range():
    cfg_r = R_opt.OptimizerConfig(peak_lr=3e-3, warmup_steps=20,
                                  total_steps=100)
    cfg_t = T_opt.OptimizerConfig(peak_lr=3e-3, warmup_steps=20,
                                  total_steps=100)
    steps = np.arange(0, 131, 3, dtype=np.int32)
    want = np.asarray(R_opt.cosine_lr(cfg_r, jnp.asarray(steps)))
    got = T_opt.cosine_lr(cfg_t, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **OPT_TOL)
    assert float(T_opt.cosine_lr(cfg_t, 7)) == pytest.approx(
        float(R_opt.cosine_lr(cfg_r, 7)), rel=1e-6)


def _opt_tree(rng):
    """A JAX-layout tree: dense, vector, conv HWIO and depthwise
    (3,3,1,mid) leaves; last dims 16 (blocked at 8) and 5/3 (per-row
    fallback)."""
    return {"w": rng.standard_normal((4, 16)).astype(np.float32),
            "conv": rng.standard_normal((3, 3, 2, 16)).astype(np.float32),
            "dw": rng.standard_normal((3, 3, 1, 16)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32),
                  {"s": rng.standard_normal((2, 3)).astype(np.float32)}]}


@pytest.mark.parametrize("eight", [False, True], ids=["fp32", "8bit"])
@pytest.mark.parametrize("updates", [1, 5])
def test_adamw_matches_on_the_same_gradients(eight, updates):
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=3.0,
              eight_bit_moments=eight, quant_block=8)
    rng = np.random.default_rng(updates + 10 * eight)
    p_np = _opt_tree(rng)
    init_r, upd_r = R_opt.make_adamw(R_opt.OptimizerConfig(**kw))
    init_t, upd_t = T_opt.make_adamw(T_opt.OptimizerConfig(**kw))
    pr = jax.tree.map(jnp.asarray, p_np)
    pt = from_jax(p_np, CPU)
    sr, st = init_r(pr), init_t(pt)
    for _ in range(updates):
        g_np = _opt_tree(rng)
        pr, sr, mr = upd_r(jax.tree.map(jnp.asarray, g_np), sr, pr)
        pt, st, mt = upd_t(from_jax(g_np, CPU), st, pt)
        for k in ("lr", "grad_norm"):
            assert float(mt[k]) == pytest.approx(float(mr[k]), rel=1e-6)
    _assert_tree_close(pt, _np_tree(pr), **OPT_TOL)
    assert int(st.count) == int(sr.count) == updates
    assert st.count.dtype == torch.int32
    if eight:
        # moments in the JAX package's layout: int8 codes within one
        # (a value within float32 rounding of a .5 boundary), scales at
        # the optimizer tolerance
        for got, want in ((st.m, sr.m), (st.v, sr.v)):
            for a, b in zip(leaves(got), jax.tree.leaves(want)):
                assert a.dtype == torch.int8 and a.shape == b.shape
                assert np.abs(a.numpy().astype(int)
                              - np.asarray(b).astype(int)).max() <= 1
        for got, want in ((st.m_scale, sr.m_scale),
                          (st.v_scale, sr.v_scale)):
            for a, b in zip(leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **OPT_TOL)
    else:
        assert st.m_scale is None and st.v_scale is None


def test_8bit_moments_of_conv_weights_block_over_output_channels():
    """The chosen layout rule: a conv weight's moments are blocked over
    the JAX package's last axis (HWIO's O, the port's OIHW dim 0), so a
    block holds one output-channel run, never kernel columns."""
    cfg = T_opt.OptimizerConfig(eight_bit_moments=True, quant_block=8,
                                warmup_steps=0)
    init, update = T_opt.make_adamw(cfg)
    w = torch.zeros((16, 2, 3, 3))               # OIHW, 16 out channels
    st = init({"conv": w})
    assert st.m["conv"].shape == (3, 3, 2, 16)   # HWIO
    assert st.m_scale["conv"].shape == (3, 3, 2, 2)
    g = torch.zeros_like(w)
    g[:8] = 1e-3                                 # first block of O only
    g[8:] = 1.0
    _, st, om = update({"conv": g}, st, {"conv": w})
    sc = st.m_scale["conv"].numpy()
    # each scale covers 8 output channels of one (kh, kw, ci) position:
    # the clipped first moment (1 - b1) * g * clip over 127
    clip = min(1.0, cfg.grad_clip / float(om["grad_norm"]))
    for blk, gval in ((0, 1e-3), (1, 1.0)):
        np.testing.assert_allclose(sc[..., blk],
                                   (1 - cfg.b1) * gval * clip / 127,
                                   rtol=1e-5)
    assert (st.m["conv"] == 127).all()           # every block is uniform
    m = T_opt.dequantize8(st.m["conv"], st.m_scale["conv"], 8)
    assert hwio_to_oihw(m).shape == w.shape


def test_quantize8_round_trip_matches():
    x = np.random.default_rng(2).standard_normal((3, 32)).astype(np.float32)
    qr, sr = R_opt.quantize8(jnp.asarray(x), 8)
    qt, st = T_opt.quantize8(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **OPT_TOL)
    np.testing.assert_allclose(
        T_opt.dequantize8(qt, st, 8).numpy(),
        np.asarray(R_opt.dequantize8(qr, sr, 8)), **OPT_TOL)


# ---------------------------------------------------------------------------
# checkpoint: the msgpack codec
# ---------------------------------------------------------------------------
MSGPACK_CASES = {
    "fixint": 127, "uint8": 128, "uint8-top": 255, "uint16": 256,
    "uint16-top": 65535, "uint32": 65536, "uint32-top": 2 ** 32 - 1,
    "uint64": 2 ** 32, "bin8-empty": b"", "bin8": b"x" * 255,
    "bin16": b"y" * 256, "bin16-top": bytes(65535), "bin32": bytes(65536),
    "fixarray": list(range(15)), "array16": list(range(16)),
    "array32": [0] * 65536, "fixmap": {b"k%d" % i: i for i in range(15)},
    "map16": {b"k%d" % i: [i] for i in range(16)},
    "payload": {b"leaves": [{b"dtype": b"float32", b"shape": [3, 4],
                             b"data": bytes(48)}],
                b"extra": b"{}", b"step": 1200},
}


@pytest.mark.parametrize("case", list(MSGPACK_CASES))
def test_msgpack_codec_matches_msgpack_byte_for_byte(case):
    obj = MSGPACK_CASES[case]
    want = msgpack.packb(obj)
    assert T_ck.packb(obj) == want
    assert T_ck.unpackb(want) == msgpack.unpackb(want)


def test_msgpack_codec_refuses_what_the_payload_never_holds():
    for bad in (-1, 1.5, "text", True, None, {"str-key": 1}):
        with pytest.raises((TypeError, ValueError)):
            T_ck.packb(bad)
    for blob in (msgpack.packb(-3), msgpack.packb(1.5),
                 msgpack.packb("s"), msgpack.packb([1]) + b"\x00"):
        with pytest.raises(ValueError):
            T_ck.unpackb(blob)


# ---------------------------------------------------------------------------
# checkpoint: files
# ---------------------------------------------------------------------------
def _disc_tree():
    cfg = R_eff.DiscriminatorConfig(stages=((16, 1, 1, 1), (24, 1, 2, 4)),
                                    head_channels=32)
    return _np_tree(R_eff.init_discriminator(jax.random.PRNGKey(4), cfg))


def _mixed_tree():
    """tests/test_training.py's round-trip tree (bfloat16 and an int32
    scalar among float32)."""
    return {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": [np.asarray(jnp.ones((2,), jnp.bfloat16)),
                  {"c": np.asarray(3, np.int32)}]}


@pytest.fixture(params=["zlib", "zstd"])
def codec(request, monkeypatch):
    """Both packages write with one codec: zlib with ``zstandard`` taken
    away, zstd where it imports (the JAX package's own rule)."""
    if request.param == "zlib":
        monkeypatch.setattr(R_ck, "zstandard", None)
        monkeypatch.setattr(T_ck, "zstandard", None)
    else:
        pytest.importorskip("zstandard")
    return request.param


@pytest.mark.parametrize("tree_fn", [_disc_tree, _mixed_tree],
                         ids=["discriminator", "mixed"])
def test_jax_written_checkpoint_loads_in_the_port(tmp_path, codec, tree_fn):
    tree = tree_fn()
    R_ck.save(str(tmp_path), jax.tree.map(jnp.asarray, tree), step=7,
              extra={"acc": 0.5})
    got, step, extra = T_ck.load(str(tmp_path), from_jax(tree, CPU),
                                 device="cpu")
    assert (step, extra) == (7, {"acc": 0.5})
    want = from_jax(tree, CPU)
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("tree_fn", [_disc_tree, _mixed_tree],
                         ids=["discriminator", "mixed"])
def test_port_written_checkpoint_loads_in_jax(tmp_path, codec, tree_fn):
    tree = tree_fn()
    T_ck.save(str(tmp_path / "t"), from_jax(tree, CPU), step=3,
              extra={"note": "x"})
    got, step, extra = R_ck.load(str(tmp_path / "t"),
                                 jax.tree.map(jnp.asarray, tree))
    assert (step, extra) == (3, {"note": "x"})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)
    # the same file, byte for byte, as the JAX package writes
    R_ck.save(str(tmp_path / "r"), jax.tree.map(jnp.asarray, tree), step=3,
              extra={"note": "x"})
    assert (tmp_path / "t" / "step_3.ckpt").read_bytes() == \
        (tmp_path / "r" / "step_3.ckpt").read_bytes()
    assert (tmp_path / "t" / "step_3.ckpt").read_bytes()[10:11] == \
        {"zlib": b"L", "zstd": b"Z"}[codec]


def test_zstd_checkpoint_without_zstandard_raises(tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    T_ck.save(str(tmp_path), {"w": torch.zeros(2)}, step=1)
    monkeypatch.setattr(T_ck, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        T_ck.load(str(tmp_path), {"w": torch.zeros(2)}, device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    tree = from_jax(_mixed_tree(), CPU)
    path = str(tmp_path / "ck")
    T_ck.save(path, tree, step=7, extra={"note": "x"})
    out, step, extra = T_ck.load(path, tree, device="cpu")
    assert step == 7 and extra["note"] == "x"
    for a, b in zip(leaves(tree), leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_rotation_and_latest(tmp_path):
    path = str(tmp_path / "ck")
    tree = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        T_ck.save(path, tree, step=s, keep=3)
    assert [s for s, _ in T_ck.sorted_steps(path)] == [3, 4, 5]
    assert T_ck.latest_step(path) == 5
    _, s, _ = T_ck.load(path, tree, device="cpu")     # newest by default
    assert s == 5
    (tmp_path / "none").mkdir()
    with pytest.raises(FileNotFoundError):
        T_ck.load(str(tmp_path / "none"), tree, device="cpu")


def test_checkpoint_structure_mismatch(tmp_path):
    path = str(tmp_path / "ck")
    T_ck.save(path, {"w": torch.zeros(2)}, step=1)
    with pytest.raises(ValueError):
        T_ck.load(path, {"w": torch.zeros(2), "extra": torch.zeros(1)},
                  device="cpu")


def _unet_tree():
    cfg = R_DiffusionConfig(name="t", image_size=8, in_channels=4,
                            base_channels=16, channel_mults=(1, 2),
                            num_res_blocks=1, attn_resolutions=(4,),
                            num_heads=2, text_dim=16)
    return _np_tree(r_init_unet(jax.random.PRNGKey(1), cfg))


@pytest.mark.parametrize("tree_fn", [_unet_tree, _disc_tree],
                         ids=["unet", "discriminator"])
def test_to_jax_inverts_from_jax(tree_fn):
    tree = tree_fn()
    back = to_jax(from_jax(tree, CPU))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.is_contiguous()
        arr = np.asarray(a)
        assert arr.dtype == b.dtype and arr.shape == b.shape
        np.testing.assert_array_equal(arr, b)
    with pytest.raises(ValueError, match="LM"):
        to_jax({"embed": torch.zeros(2), "layers": []})


# ---------------------------------------------------------------------------
# the discriminator's training
# ---------------------------------------------------------------------------
def _disc_setup(seed=0, batch=8, size=16):
    cfg_r = R_eff.DiscriminatorConfig()
    pr = R_eff.init_discriminator(jax.random.PRNGKey(seed), cfg_r)
    x, y = next(iter(R_Batcher(rng=np.random.default_rng(seed), size=batch,
                               image_size=size)))
    return cfg_r, pr, DiscriminatorConfig(), from_jax(_np_tree(pr), CPU), \
        x, y


def test_disc_loss_and_gradients_match_jax():
    cfg_r, pr, cfg_t, pt, x, y = _disc_setup()

    def ref_loss(p):
        logits, _ = R_eff.apply_discriminator(p, cfg_r, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                   axis=-1).mean()
        return nll, jnp.mean((jnp.argmax(logits, -1) == y)
                             .astype(jnp.float32))

    (loss_r, acc_r), grads_r = jax.value_and_grad(ref_loss, has_aux=True)(pr)
    loss_t, acc_t, grads_t = T_disc.loss_and_grads(
        pt, cfg_t, torch.from_numpy(x), torch.from_numpy(y))
    assert float(loss_t) == pytest.approx(float(loss_r), abs=5e-5)
    assert float(acc_t) == float(acc_r)
    _assert_tree_close(grads_t, _np_tree(grads_r), **MODEL_TOL)
    # the unused GroupNorm of a residual block gets zeros, as in JAX
    assert all(torch.count_nonzero(g) == 0 for g in
               leaves(grads_t["stage0"][0]["gn3"]))
    assert not any(p.requires_grad for p in leaves(pt))


def _train_steps(n, seed=0):
    cfg_r, pr, cfg_t, pt, _, _ = _disc_setup(seed)
    kw = dict(peak_lr=3e-3, warmup_steps=20, total_steps=40,
              weight_decay=1e-4, eps=STEP_EPS)
    init_r, step_r = R_disc.make_disc_train_step(
        cfg_r, R_opt.OptimizerConfig(**kw))
    init_t, step_t = T_disc.make_disc_train_step(
        cfg_t, T_opt.OptimizerConfig(**kw))
    sr, st = init_r(pr), init_t(pt)
    batches = iter(R_Batcher(rng=np.random.default_rng(seed + 1), size=16,
                             image_size=16))
    losses = []
    for _ in range(n):
        x, y = next(batches)
        pr, sr, mr = step_r(pr, sr, jnp.asarray(x), jnp.asarray(y))
        pt, st, mt = step_t(pt, st, torch.from_numpy(x), torch.from_numpy(y))
        losses.append((float(mr["loss"]), float(mt["loss"]),
                       float(mr["acc"]), float(mt["acc"])))
    return pr, pt, losses


def test_one_train_step_matches_jax():
    pr, pt, losses = _train_steps(1)
    _assert_tree_close(pt, _np_tree(pr), atol=5e-5, rtol=0)
    assert losses[0][1] == pytest.approx(losses[0][0], abs=5e-5)


def test_train_step_loss_trajectory_matches_jax():
    pr, pt, losses = _train_steps(8, seed=2)
    for lr_, lt, ar, at in losses:
        assert lt == pytest.approx(lr_, abs=5e-5)
        assert at == ar
    _assert_tree_close(pt, _np_tree(pr), atol=5e-5, rtol=0)


def test_discriminator_learns_and_separates():
    """The mirror of tests/test_training.py's test on the port."""
    params, cfg, hist = T_disc.train_discriminator(
        0, steps=120, batch_size=16, image_size=16, lr=3e-3, log_every=30,
        device="cpu")
    assert np.mean([h["acc"] for h in hist[-2:]]) > 0.75
    rng = np.random.default_rng(5)
    real = torch.from_numpy(natural_images(rng, 16, 16))
    fake = torch.from_numpy(degraded_images(rng, 16, 16))
    with torch.inference_mode():
        c_real = confidence_score(params, cfg, real).numpy()
        c_fake = confidence_score(params, cfg, fake).numpy()
    assert c_real.mean() > c_fake.mean() + 0.1   # confidence separates


def test_train_discriminator_from_given_params_with_checkpoints(tmp_path):
    cfg_r, pr, cfg_t, pt, _, _ = _disc_setup(3)
    params, _, hist = T_disc.train_discriminator(
        cfg=cfg_t, steps=5, batch_size=8, image_size=16, log_every=2,
        checkpoint_dir=str(tmp_path), params=pt, device="cpu")
    assert [h["step"] for h in hist] == [2, 4, 5]
    assert T_ck.latest_step(str(tmp_path)) == 5
    # the given tree is not trained in place
    _assert_tree_close(pt, _np_tree(pr), atol=0, rtol=0)
    # the checkpoint holds the returned parameters, loadable by JAX too
    back, _, extra = T_ck.load(str(tmp_path), params, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(params)))
    ref, step, _ = R_ck.load(str(tmp_path), pr)
    _assert_tree_close(params, _np_tree(ref), atol=0, rtol=0)
    assert step == 5 and set(extra) == {"acc"}


def test_training_raises_without_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        T_disc.train_discriminator(steps=1)


# ---------------------------------------------------------------------------
# the kernel wrappers' grad guard
# ---------------------------------------------------------------------------
def test_needs_grad_predicate():
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    assert ops.needs_grad(x, y) and ops.needs_grad(None, x)
    assert not ops.needs_grad(y, None)
    with torch.no_grad():
        assert not ops.needs_grad(x)
    with torch.inference_mode():
        assert not ops.needs_grad(torch.zeros(2))


def _wrapper_args(name):
    t = lambda *s: torch.zeros(*s)    # noqa: E731
    return {
        "flash_attention": ((t(1, 4, 2, 16), t(1, 4, 2, 16),
                             t(1, 4, 2, 16)), {"causal": False}),
        "fused_groupnorm": ((t(1, 4, 4, 8), t(8), t(8)), {"groups": 2}),
        "decode_attention": ((t(1, 2, 16), t(1, 4, 2, 16), t(1, 4, 2, 16),
                              torch.ones(1, dtype=torch.int32)), {}),
        "fused_rmsnorm": ((t(2, 8), t(8)), {}),
        "swiglu": ((t(2, 8), t(2, 8)), {}),
        "mlstm_chunk": ((t(1, 2, 1, 4), t(1, 2, 1, 4), t(1, 2, 1, 4),
                         t(1, 2, 1), t(1, 2, 1), t(1, 1, 4, 4), t(1, 1, 4),
                         t(1, 1)), {}),
        "mamba_scan": ((t(1, 2, 4), t(1, 2, 4), t(4, 2), t(1, 2, 2),
                        t(1, 2, 2), t(4), t(1, 4, 2)), {}),
    }[name]


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_wrappers_refuse_grad_on_cuda(name, monkeypatch):
    """On the CUDA path (the device check stubbed to "cuda"), a call
    autograd would differentiate raises before any launch and names the
    unfused route; each input position is tried."""
    monkeypatch.setattr(ops, "_device_type", lambda t, kernel: "cuda")
    args, kw = _wrapper_args(name)
    for i, a in enumerate(args):
        if not a.is_floating_point():
            continue
        call = list(args)
        call[i] = a.clone().requires_grad_(True)
        before = ops.KERNELS[name].launches
        with pytest.raises(RuntimeError, match="unfused"):
            getattr(ops, name)(*call, **kw)
        assert ops.KERNELS[name].launches == before


def test_cpu_route_keeps_autograd():
    """On the CPU a wrapper runs its plain version, which autograd
    differentiates: the fused route trains there."""
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    out = ops.fused_groupnorm(x, torch.ones(8), torch.zeros(8), groups=2)
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
EXAMPLES = ["examples/serve_cascade_torch.py",
            "examples/train_discriminator_torch.py"]


_RUNNER = """
import json, runpy, sys
for blocked in ("jax", "jaxlib", "repro"):
    sys.modules[blocked] = None
import repro_torch.serving.cluster as C
import repro_torch.serving.simulator as S
results = []
def keep(fn):
    def run(self, *a, **k):
        r = fn(self, *a, **k)
        results.append(r)
        return r
    return run
S.Simulator.run = keep(S.Simulator.run)
C.ClusterBackend.serve = keep(C.ClusterBackend.serve)
mod = runpy.run_path(sys.argv[1], run_name="entry")
out = mod["main"](sys.argv[2:])
loaded = sorted(k for k in sys.modules if sys.modules[k] is not None
                and k.split(".")[0] in ("jax", "jaxlib", "repro"))
sims = [{"completed": r.completed, "dropped": r.dropped,
         "total": r.total, "conserved": r.conserved()} for r in results]
print("RESULT " + json.dumps({"out": out, "sims": sims,
                              "loaded": loaded}, default=str))
"""


def _run_entry(path, *args):
    res = subprocess.run(
        [sys.executable, "-c", _RUNNER, str(REPO / path), *args], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


REPORT_KEYS = {"mode", "cascade", "controller", "estimator", "tiers",
               "workers", "served", "total", "slo_violation_ratio",
               "defer_fraction", "fid_star"}


def _report_keys(path):
    """The string keys the script writes into ``report``."""
    keys = set()
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name) \
                and node.targets[0].id == "report" \
                and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.value,
                                                          ast.Name) \
                and node.value.id == "report" \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys


def test_serve_entry_point_writes_the_references_report_keys():
    assert _report_keys("examples/serve_cascade_torch.py") == \
        _report_keys("examples/serve_cascade.py")


@pytest.mark.parametrize("mode,extra", [
    ("sim", ["--duration", "20"]),
    ("cluster", ["--workers", "2", "--duration", "8"]),
])
def test_serve_entry_point_on_the_cpu(mode, extra):
    got = _run_entry("examples/serve_cascade_torch.py", "--device", "cpu",
                     "--mode", mode, *extra)
    assert got["loaded"] == []
    (sim,) = got["sims"]
    assert sim["conserved"] and sim["total"] > 0
    assert sim["completed"] + sim["dropped"] == sim["total"]
    rep = got["out"]
    assert REPORT_KEYS <= set(rep) and rep["mode"] == mode
    assert (rep["served"], rep["total"]) == (sim["completed"], sim["total"])
    if mode == "cluster":
        assert rep["control_ticks"] >= 2


def test_train_entry_point_on_the_cpu(tmp_path):
    got = _run_entry("examples/train_discriminator_torch.py", "--device",
                     "cpu", "--steps", "60", "--checkpoint-dir",
                     str(tmp_path))
    assert got["loaded"] == []
    out = got["out"]
    assert [h["step"] for h in out["history"]] == [30, 60]
    assert T_ck.latest_step(str(tmp_path)) == 60
    f = [out["f"][k] for k in sorted(out["f"], key=float)]
    assert f == sorted(f) and 0.0 <= f[0] <= f[-1] <= 1.0


def test_serve_entry_point_flags_name_the_registries():
    """The CLI side of the config->CLI threading: each policy flag's
    choices are its registry's keys, and the stage graph's knobs are
    threaded into the serving config."""
    import runpy
    from repro_torch.kernels.impls import TORCH_KERNEL_IMPLS
    from repro_torch.serving.baselines import TORCH_CONTROLLERS
    from repro_torch.serving.controlplane import TORCH_ESTIMATORS
    from repro_torch.serving.microserve import TORCH_STAGES
    mod = runpy.run_path(str(REPO / EXAMPLES[0]), run_name="entry")
    ap, args = mod["parse_args"](["--stage-graph", "micro",
                                  "--stage-denoise-steps", "3"])
    choices = {a.dest: a.choices for a in ap._actions if a.choices}
    assert set(choices["controller"]) == set(TORCH_CONTROLLERS)
    assert set(choices["estimator"]) == set(TORCH_ESTIMATORS)
    assert set(choices["stage_graph"]) == set(TORCH_STAGES)
    assert set(choices["kernel_impl"]) == set(TORCH_KERNEL_IMPLS) | {"auto"}
    assert (args.stage_graph, args.stage_denoise_steps) == ("micro", 3)
    for name in ("controller", "estimator", "stage-graph", "kernel-impl",
                 "stage-denoise-steps", "stage-preempt-frac", "device"):
        assert any(f"--{name}" in a.option_strings for a in ap._actions)


@pytest.mark.parametrize("path", EXAMPLES)
def test_entry_points_raise_without_cuda_unless_asked_for_the_cpu(path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    import runpy
    mod = runpy.run_path(str(REPO / path), run_name="entry")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod["main"]([])
