"""The port's serving slice against the JAX package, and the port's
rules: the cascade's stage samplers, confidence and ``run_batch`` with
the same weights and noise as the JAX cascade; shape bucketing; the
cluster runtime on the CPU; CUDA by default; no JAX and no ``repro``
import anywhere in the port or its smoke script."""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import DiffusionConfig as JaxDiffusionConfig
from repro.core.cascade import DiffusionCascade as JaxCascade
from repro.core.cascade import _stage_sample
from repro.models.efficientnet import DiscriminatorConfig as JaxDiscConfig
from repro.models.efficientnet import init_discriminator as jax_init_disc
from repro.models.unet import init_unet as jax_init_unet
from repro_torch.config.base import DiffusionConfig, LatencyProfile
from repro_torch.core.cascade import DiffusionCascade
from repro_torch.device import resolve_device
from repro_torch.models.convert import from_jax
from repro_torch.models.efficientnet import (DiscriminatorConfig,
                                             init_discriminator)
from repro_torch.models.unet import init_unet
from repro_torch.serving.cluster import ClusterBackend, ClusterRuntime
from repro_torch.serving.profiles import default_serving

REPO = Path(__file__).resolve().parents[1]
# DDIM at t=999 multiplies eps error by 1/sqrt(1e-5) ~ 316 (see
# tests/test_torch_models.py): 316 x the 5e-5 model tolerance
DDIM_TOL = dict(atol=316 * 5e-5, rtol=0)
SCORE_TOL = dict(atol=5e-5, rtol=5e-5)
BUCKETS = (1, 2, 4, 8)


def _ucfg(i):
    return dict(name=f"b{i}", image_size=8, in_channels=3, base_channels=8,
                channel_mults=(1,), num_res_blocks=1, attn_resolutions=(8,),
                num_heads=2, num_steps=1 + 2 * i, text_dim=16)


def _dcfg():
    return dict(stages=((16, 1, 1, 1), (24, 1, 2, 4)), head_channels=32,
                in_channels=3)


@pytest.fixture(scope="module")
def pair():
    """The same two-tier cascade in both packages (JAX weights)."""
    jstages, tstages = [], []
    for i in range(2):
        jcfg = JaxDiffusionConfig(**_ucfg(i))
        jp = jax_init_unet(jax.random.PRNGKey(i), jcfg)
        jstages.append((jcfg, jp))
        tstages.append((DiffusionConfig(**_ucfg(i)),
                        from_jax(jax.tree.map(np.asarray, jp), "cpu")))
    jd = jax_init_disc(jax.random.PRNGKey(9), JaxDiscConfig(**_dcfg()))
    td = from_jax(jax.tree.map(np.asarray, jd), "cpu")
    jc = JaxCascade(jstages, JaxDiscConfig(**_dcfg()), jd, kernel_impl="xla",
                    batch_buckets=BUCKETS)
    return jc, tstages, td


def _port(pair, **kw):
    _, tstages, td = pair
    kw.setdefault("kernel_impl", "unfused")
    kw.setdefault("batch_buckets", BUCKETS)
    return DiffusionCascade(tstages, DiscriminatorConfig(**_dcfg()), td,
                            device="cpu", **kw)


def _toks(n, seed=0):
    return np.random.default_rng(seed).integers(0, 4096, (n, 4)) \
        .astype(np.int32)


def _jax_noise(key, n_stages, cfgs, m):
    keys = jax.random.split(key, n_stages)

    def noise_fn(i, shape):
        assert shape == (m, cfgs[i].image_size, cfgs[i].image_size,
                         cfgs[i].in_channels)
        return torch.tensor(np.asarray(
            jax.random.normal(keys[i], shape, jnp.float32)))
    return noise_fn


@pytest.mark.parametrize("impl,jimpl", [("unfused", "xla"),
                                        ("fused", "interpret")])
def test_stage_samplers_match_jax(pair, impl, jimpl):
    jc, _, _ = pair
    noise = np.random.default_rng(1).standard_normal(
        (4, 8, 8, 3)).astype(np.float32)
    seen = []

    def noise_fn(i, shape):
        seen.append((i, shape))
        return torch.from_numpy(noise)
    casc = _port(pair, kernel_impl=impl, noise_fn=noise_fn)
    toks = _toks(3)
    for i, ((cfg, fn, params), (jcfg, jp)) in enumerate(
            zip(casc.stage_fns(), jc.stages)):
        got = fn(params, toks)
        padded = np.concatenate([toks, np.zeros((1, 4), np.int32)])
        want = _stage_sample(jp, jnp.asarray(noise), jnp.asarray(padded),
                             cfg=jcfg, impl=jimpl)[:3]
        assert got.shape == (3, 8, 8, 3)      # sliced back to the batch
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DDIM_TOL)
    assert seen == [(0, (4, 8, 8, 3)), (1, (4, 8, 8, 3))]


def test_confidence_on_odd_batch_matches_jax(pair):
    jc, _, _ = pair
    imgs = np.random.default_rng(2).standard_normal(
        (3, 8, 8, 3)).astype(np.float32)
    want = jc.confidence(jnp.asarray(imgs))
    for impl in ("unfused", "fused"):
        got = _port(pair, kernel_impl=impl).confidence(imgs)
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, **SCORE_TOL)


@pytest.mark.parametrize("n", [3, 8])
def test_run_batch_matches_jax(pair, n):
    """Same weights, the JAX noise injected through the port's noise
    seam, and a threshold in the widest gap between stage-0 scores (clear
    of every score), so both packages defer the same queries."""
    jc, _, _ = pair
    key = jax.random.PRNGKey(n)
    toks = _toks(n, seed=n)
    m = jc.bucket_for(n)
    probe = jc.run_batch(key, jnp.asarray(toks), 1.0)
    s = np.sort(probe.confidences)
    gap = int(np.argmax(np.diff(s)))
    th = float((s[gap] + s[gap + 1]) / 2)
    want = jc.run_batch(key, jnp.asarray(toks), th)
    casc = _port(pair, noise_fn=_jax_noise(
        key, 2, [c for c, _ in jc.stages], m))
    got = casc.run_batch(toks, th)
    assert 0 < got.deferred.sum() < n
    np.testing.assert_array_equal(got.deferred, want.deferred)
    np.testing.assert_array_equal(got.stage_index, want.stage_index)
    np.testing.assert_allclose(got.confidences, want.confidences,
                               **SCORE_TOL)
    np.testing.assert_allclose(got.light_outputs, want.light_outputs,
                               **DDIM_TOL)
    np.testing.assert_allclose(got.outputs, want.outputs, **DDIM_TOL)


def test_batch_sweep_runs_at_most_one_shape_per_bucket(pair):
    casc = _port(pair)
    for n in range(1, 9):
        for cfg, fn, params in casc.stage_fns():
            assert fn(params, _toks(n)).shape[0] == n
        casc.confidence(np.zeros((n, 8, 8, 3), np.float32))
    assert casc.shape_counts() == [4, 4, 4]


def test_configure_kernels_is_idempotent(pair):
    casc = _port(pair)
    fn = casc.stage_fns()[0][1]
    casc.configure_kernels("unfused", BUCKETS)
    assert casc.stage_fns()[0][1] is fn
    casc.configure_kernels("auto", BUCKETS)
    assert casc.kernel_impl == "fused" and casc.stage_fns()[0][1] is not fn


def test_seeded_generator_noise_is_reproducible(pair):
    a = _port(pair, seed=5).run_batch(_toks(3), 0.0)
    b = _port(pair, seed=5).run_batch(_toks(3), 0.0)
    np.testing.assert_array_equal(a.outputs, b.outputs)
    assert not a.deferred.any()


def test_cluster_runtime_on_cpu(pair):
    casc = _port(pair)
    sv = default_serving("sdturbo", num_workers=3, kernel_impl="fused",
                         batch_buckets=(1, 2, 4))
    rt = ClusterRuntime(casc, sv, device="cpu")
    assert casc.kernel_impl == "fused" and casc.batch_buckets == (1, 2, 4)
    assert [s.devices for s in rt.slices] == [(torch.device("cpu"),)] * 3
    prof = rt.measure_profile(batches=(1, 2), repeats=2)
    assert len(prof) == 2
    assert all(isinstance(p, LatencyProfile) and p.base_s > 0
               and p.marginal_s > 0 for p in prof)
    assert casc.shape_counts()[:2] == [2, 2]
    res = rt.serve_batch(_toks(3), 1.0)
    assert res.outputs.shape == (3, 8, 8, 3) and res.deferred.all()
    assert np.isfinite(res.outputs).all()


def test_measure_profile_refuses_a_new_shape_while_timing(pair):
    casc = _port(pair)
    rt = ClusterRuntime(casc, default_serving("sdturbo"), device="cpu")
    cfg, fn, params = casc.stage_fns()[0]
    calls = []

    def leaky(params, toks):      # runs a new batch shape on every call
        calls.append(toks.shape[0])
        return fn(params, _toks(len(calls) + 1))
    casc.stage_fns = lambda: [(cfg, leaky, params)]
    with pytest.raises(RuntimeError, match="timed repeats"):
        rt.measure_profile(batches=(1,), repeats=2)


def test_entry_points_default_to_cuda(pair, monkeypatch):
    """With no CUDA and no explicit device every entry point raises:
    the port has no silent CPU path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tstages, td = pair
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffusionCascade(tstages, DiscriminatorConfig(**_dcfg()), td)
    sv = default_serving("sdturbo", num_workers=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterRuntime(_port(pair), sv)
    rt = ClusterRuntime(_port(pair), sv, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterBackend(rt, sv, ())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_unet(DiffusionConfig(**_ucfg(0)))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_discriminator(DiscriminatorConfig(**_dcfg()))
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax({"w": np.zeros(2)})
    assert resolve_device("cpu") == torch.device("cpu")


def _port_modules():
    root = REPO / "src" / "repro_torch"
    return sorted(".".join(p.relative_to(REPO / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in root.rglob("*.py"))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "repro_torch.serving.cluster" in mods and len(mods) >= 18
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None; sys.modules['triton'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_and_smoke_script_import_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{f.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
