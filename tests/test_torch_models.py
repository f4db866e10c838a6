"""The port's models against the JAX package, on the CPU.

Both packages get the same weights (the JAX init, converted by
``repro_torch.models.convert``) and the same numpy inputs. The port's
"unfused" route is held against JAX's "xla" route and its "fused" route
(the plain kernel versions on CPU tensors) against JAX's Pallas kernels
in interpret mode, at the JAX package's model tolerance 5e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import DiffusionConfig as JaxDiffusionConfig
from repro.models import diffusion as jdiff
from repro.models.efficientnet import DiscriminatorConfig as JaxDiscConfig
from repro.models.efficientnet import apply_discriminator as jax_disc
from repro.models.efficientnet import conv as jax_conv
from repro.models.efficientnet import init_discriminator as jax_init_disc
from repro.models.unet import apply_unet as jax_unet
from repro.models.unet import init_unet as jax_init_unet
from repro_torch.config.base import DiffusionConfig
from repro_torch.models import diffusion as tdiff
from repro_torch.models.convert import from_jax
from repro_torch.models.efficientnet import (DiscriminatorConfig,
                                             apply_discriminator, conv,
                                             confidence_score,
                                             init_discriminator)
from repro_torch.models.unet import apply_unet, init_unet

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
# DDIM's first step divides by sqrt(alpha_bar) at t=999, where alpha_bar
# is clipped to 1e-5: x0 = (x - sqrt(1-ab)*eps)/sqrt(ab) multiplies the
# UNet's eps error by 1/sqrt(1e-5) ~ 316. Held to 316 x the model
# tolerance; measured here: 1.8e-4 at 1 step, 5.3e-5 at 4 steps.
DDIM_TOL = dict(atol=316 * 5e-5, rtol=0)
IMPLS = [("unfused", "xla"), ("fused", "interpret")]


def _cfg_kwargs(image_size=8, attn=(8,), steps=1, name="t0"):
    return dict(name=name, image_size=image_size, in_channels=3,
                base_channels=8, channel_mults=(1,), num_res_blocks=1,
                attn_resolutions=attn, num_heads=2, num_steps=steps,
                text_dim=16)


def _pair(**kw):
    jcfg, tcfg = JaxDiffusionConfig(**kw), DiffusionConfig(**kw)
    jp = jax_init_unet(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(seed, batch, size, prompt_len=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    t = rng.integers(0, 1000, batch).astype(np.int32)
    toks = rng.integers(0, 4096, (batch, prompt_len)).astype(np.int32)
    return x, t, toks


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("batch", [1, 3])
def test_unet_matches_jax(impl, jimpl, batch):
    jcfg, tcfg, jp, tp = _pair(**_cfg_kwargs())
    x, t, toks = _inputs(batch, batch, 8)
    want = jax_unet(jp, jcfg, jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(toks), impl=jimpl)
    got = apply_unet(tp, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(toks), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_unet_padded_kv_config_matches_jax():
    """image 16 + 4 prompt tokens gives Sk=260: the JAX interpret route
    pads K/V and masks with kv_len, the port's does not pad."""
    jcfg, tcfg, jp, tp = _pair(**_cfg_kwargs(16, (16,), name="t16"))
    x, t, toks = _inputs(9, 1, 16)
    want = jax_unet(jp, jcfg, jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(toks), impl="interpret")
    got = apply_unet(tp, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(toks), impl="fused")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def _disc_kwargs(**over):
    kw = dict(stages=((16, 1, 1, 1), (24, 1, 2, 4)), head_channels=32,
              in_channels=3)
    kw.update(over)
    return kw


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("kw,size", [
    (_disc_kwargs(), 16),                                  # stride-2 SAME
    (_disc_kwargs(), 15),                                  # odd input
    (_disc_kwargs(stem_channels=12, stages=((10, 1, 1, 1), (20, 1, 2, 2)),
                  head_channels=36), 16),                  # group shrink
])
def test_discriminator_matches_jax(impl, jimpl, kw, size):
    jcfg, tcfg = JaxDiscConfig(**kw), DiscriminatorConfig(**kw)
    jp = jax_init_disc(jax.random.PRNGKey(3), jcfg)
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    imgs = np.random.default_rng(4).standard_normal(
        (3, size, size, 3)).astype(np.float32)
    jl, jf = jax_disc(jp, jcfg, jnp.asarray(imgs), impl=jimpl)
    tl, tf = apply_discriminator(tp, tcfg, torch.from_numpy(imgs), impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **MODEL_TOL)
    conf = confidence_score(tp, tcfg, torch.from_numpy(imgs), impl=impl)
    np.testing.assert_allclose(conf.numpy(),
                               np.asarray(jax.nn.softmax(jl, -1)[:, 1]),
                               **MODEL_TOL)


@pytest.mark.parametrize("size,k,stride,groups", [
    (8, 3, 2, 1), (7, 3, 2, 1), (8, 3, 1, 1), (8, 1, 1, 1), (8, 3, 2, 4),
])
def test_conv_same_padding_matches_jax(size, k, stride, groups):
    """XLA "SAME" at stride 2 on an even input pads (0, 1); a symmetric
    padding=1 would shift every output pixel."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4 // groups, 8)).astype(np.float32)
    want = jax_conv(jnp.asarray(x), jnp.asarray(w), stride=stride,
                    groups=groups)
    got = conv(torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1),
               stride=stride, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_timestep_table_matches_jax_linspace():
    for steps in range(1, 65):
        want = np.asarray(jnp.linspace(jdiff.NUM_TRAIN_STEPS - 1, 0,
                                       steps).astype(jnp.int32))
        np.testing.assert_array_equal(tdiff.ddim_timesteps(steps), want,
                                      err_msg=f"steps={steps}")
    # the trap: a float64 linspace rounds differently
    assert list(tdiff.ddim_timesteps(4)) == [999, 665, 332, 0]


def test_schedule_and_q_sample_match_jax():
    np.testing.assert_array_equal(tdiff._schedule_np(), jdiff._schedule_np())
    rng = np.random.default_rng(6)
    x0, noise = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
                 for _ in range(2))
    t = np.array([0, 500, 999], np.int32)
    want = jdiff.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = tdiff.q_sample(torch.from_numpy(x0), torch.from_numpy(t).long(),
                         torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("steps", [1, 4])
def test_ddim_sample_matches_jax(impl, jimpl, steps):
    jcfg, tcfg, jp, tp = _pair(**_cfg_kwargs(steps=steps))
    _, _, toks = _inputs(7, 3, 8)
    noise = np.random.default_rng(8).standard_normal(
        (3, 8, 8, 3)).astype(np.float32)
    want = jdiff.ddim_sample(jp, jcfg, None, jnp.asarray(toks), impl=jimpl,
                             init_noise=jnp.asarray(noise))
    got = tdiff.ddim_sample(tp, tcfg, torch.from_numpy(toks), impl=impl,
                            init_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DDIM_TOL)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("steps", [1, 4])
def test_euler_sample_matches_jax(impl, jimpl, steps):
    """The same standard-normal noise through both Euler samplers. The
    start is that noise times sigma at t = 999, sqrt((1 - 1e-5) / 1e-5)
    ~ 316, and the steps add eps x (sigma_next - sigma), which sum to
    -316: the UNet's eps error reaches the sample times ~316, as in DDIM,
    so the sample is held to DDIM_TOL (316 x the model tolerance)."""
    jcfg, tcfg, jp, tp = _pair(**_cfg_kwargs(steps=steps))
    _, _, toks = _inputs(9, 3, 8)
    noise = np.random.default_rng(10).standard_normal(
        (3, 8, 8, 3)).astype(np.float32)
    want = jdiff.euler_sample(jp, jcfg, None, jnp.asarray(toks), impl=jimpl,
                              init_noise=jnp.asarray(noise))
    got = tdiff.euler_sample(tp, tcfg, torch.from_numpy(toks), impl=impl,
                             init_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DDIM_TOL)


def test_converter_layouts():
    kw = _disc_kwargs()
    jp = jax_init_disc(jax.random.PRNGKey(0), JaxDiscConfig(**kw))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    dw = np.asarray(jp["stage1"][0]["w_dw"])               # (3,3,1,mid)
    assert tp["stage1"][0]["w_dw"].shape == (dw.shape[3], 1, 3, 3)
    np.testing.assert_array_equal(tp["stage1"][0]["w_dw"][:, 0].numpy(),
                                  dw[:, :, 0].transpose(2, 0, 1))
    assert tp["stem"].shape == (24, 3, 3, 3)                # OIHW
    assert tp["fc"].shape == (32, 2) and tp["fc_b"].shape == (2,)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return None if tree is None else tuple(tree.shape)


@pytest.mark.parametrize("full", [False, True])
def test_port_init_has_the_jax_structure(full):
    """The port's own init builds the converted JAX tree's structure and
    shapes, at a toy config and (shapes only, through jax.eval_shape) at
    the full-width default, 64.6 M parameters."""
    kw = dataclasses.asdict(JaxDiffusionConfig(name="full")) if full \
        else _cfg_kwargs()
    jcfg = JaxDiffusionConfig(**kw)
    jshapes = jax.eval_shape(lambda k: jax_init_unet(k, jcfg),
                             jax.random.PRNGKey(0))
    if full:
        n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes))
        assert round(n / 1e6, 1) == 64.6
        return
    want = _shapes(from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jshapes), "cpu"))
    tp = init_unet(DiffusionConfig(**kw), seed=0, device="cpu")
    assert _shapes(tp) == want
    dkw = _disc_kwargs()
    jd = jax.eval_shape(lambda k: jax_init_disc(k, JaxDiscConfig(**dkw)),
                        jax.random.PRNGKey(0))
    got = _shapes(init_discriminator(DiscriminatorConfig(**dkw),
                                     device="cpu"))
    assert got == _shapes(from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jd), "cpu"))


def test_unet_fused_matches_unfused_on_port_init():
    """The port's own seeded init drives both routes to the same eps."""
    cfg = DiffusionConfig(**_cfg_kwargs())
    p = init_unet(cfg, seed=1, device="cpu")
    x, t, toks = (torch.from_numpy(a) for a in _inputs(10, 2, 8))
    a = apply_unet(p, cfg, x, t, toks, impl="fused")
    b = apply_unet(p, cfg, x, t, toks, impl="unfused")
    torch.testing.assert_close(a, b, **MODEL_TOL)
