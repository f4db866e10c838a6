"""The distribution layer on gloo process groups on the CPU, against the
JAX package.

One subprocess (its own timeout) computes the JAX package's results
(the collectives and the pipeline on a 4-device mesh of forced host
devices; the train and serve steps of reduced configs in float32) and
the port's unsharded steps on the same numpy-seeded inputs and weights
(the JAX ``init_params`` converted by ``lm_from_jax``), then runs every
gloo case in one ``mp.spawn`` of 4 ranks: ``allgather_matmul``,
``reduce_scatter_grads`` and ``run_pipeline`` on 1-D meshes of the 4
ranks (mirroring ``tests/test_parallel.py``), and the step builders on
a 2 x 2 ("data", "model") mesh. The ranks meet through a ``file://``
init method in the test's temporary directory, so two files' groups
never share a port. Rank 0 writes the gathered results, which the tests
below hold: the collectives and the pipeline at 1e-5 (as the JAX
package's tests); the steps at 5e-5, the model tolerance, against both
the unsharded port step and the JAX step (the train step's parameters
and moments against the unsharded port step, whose own parity with the
JAX step, parameters included, ``tests/test_torch_train.py`` holds;
8-bit moments within one quantisation level, their scales at 1e-4).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
WORLD = 4
COLL_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=5e-5, rtol=5e-5)
# the train cases: (arch, the reduced config's fields replaced). Beside
# smollm-135m and deepseek-v3 (MLA, MoE, MTP, sequence parallelism,
# 8-bit moments), each repaired sharded path at reduced widths: Yi-9B at
# 6 heads and 3 KV heads, which the 2-way model axis does not divide,
# under FSDP (the K/V projections' weight gradients come back split over
# 48 = 3 x 16 columns, which the head split's backward cannot view as 3
# heads; at 1 KV head, or without FSDP, DTensor gives them no such split
# on a 2 x 2 mesh); Jamba's selective scan and xLSTM's mLSTM, whose
# states the plain versions write in place under grad, and the sLSTM's
# log-sigmoid (-softplus(-x)); 8-bit moments under FSDP at d_model 384,
# where every leaf whose last dim is d_model (three blocks of 128) has
# it split over the 2-way data axis (at 64, one block, DTensor views
# the singleton block count through and nothing shows)
TRAIN_CASES = {
    "smollm-135m": ("smollm-135m", {}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}),
    "yi-9b-3kv-fsdp": ("yi-9b", {"num_heads": 6, "num_kv_heads": 3,
                                 "d_model": 96, "fsdp": True}),
    "jamba-v0.1-52b": ("jamba-v0.1-52b", {}),
    "xlstm-125m": ("xlstm-125m", {}),
    "smollm-135m-fsdp-8bit": ("smollm-135m", {"d_model": 384, "fsdp": True,
                                              "opt_8bit_moments": True}),
}
# Yi-9B reduced: 4 KV heads divide the 2-way model axis (head-sharded
# cache); at 1 KV head the cache is sequence-sharded
SERVE_KV_HEADS = (4, 1)
B, S, DECODES, T_MAX = 4, 8, 3, 32


# ---------------------------------------------------------------------------
# Inputs (numpy, seeded) shared by both packages
# ---------------------------------------------------------------------------
def _collective_inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((3, 16)).astype(np.float32),
            "w": rng.standard_normal((16, 8)).astype(np.float32),
            "g": np.arange(32, dtype=np.float32).reshape(8, 4),
            "g2": rng.standard_normal((4, 3, 2)).astype(np.float32),
            "W": (rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32),
            "xs": rng.standard_normal((6, 2, 8)).astype(np.float32)}


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape) \
        .astype(np.int32)


def _serve_cfgs(kv_heads):
    from repro import configs as jconfigs
    from repro_torch import configs
    return tuple(dataclasses.replace(c.reduced_config("yi-9b"),
                                     num_kv_heads=kv_heads)
                 for c in (jconfigs, configs))


def _train_cfgs(case):
    from repro import configs as jconfigs
    from repro_torch import configs
    arch, fields = TRAIN_CASES[case]
    return tuple(dataclasses.replace(c.reduced_config(arch), **fields)
                 for c in (jconfigs, configs))


# ---------------------------------------------------------------------------
# The subprocess: JAX references, unsharded port steps, then the spawn
# ---------------------------------------------------------------------------
def _jax_collectives(inp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from repro.parallel.collectives import allgather_matmul, \
        reduce_scatter_grads
    from repro.parallel.pipeline import run_pipeline
    out = {}
    mesh = jax.make_mesh((WORLD,), ("fsdp",))
    ws = jax.device_put(inp["w"], NamedSharding(mesh, JP("fsdp", None)))
    out["agmm"] = np.asarray(allgather_matmul(jnp.asarray(inp["x"]), ws,
                                              mesh=mesh, axis="fsdp"))
    mesh = jax.make_mesh((WORLD,), ("data",))
    rs = reduce_scatter_grads({"w": jnp.asarray(inp["g"]),
                               "u": jnp.asarray(inp["g2"])},
                              mesh=mesh, axis="data")
    out["rs_w"], out["rs_u"] = np.asarray(rs["w"]), np.asarray(rs["u"])
    mesh = jax.make_mesh((WORLD,), ("stage",))
    out["pipe"] = np.asarray(run_pipeline(
        lambda w, x: jnp.tanh(x @ w), jnp.asarray(inp["W"]),
        jnp.asarray(inp["xs"]), mesh=mesh, axis="stage"))
    return out


def _jax_train(case, jp, batch):
    import jax
    from repro.training import train_loop as R
    jcfg, _ = _train_cfgs(case)
    init, step = R.make_train_step(jcfg, R.TrainConfig())
    _, _, m = jax.jit(step)(jp, init(jp), batch)
    return {k: float(v) for k, v in m.items()}


def _jax_serve(kv_heads, jp, toks):
    from repro.models import kvcache
    from repro.models.transformer import forward
    jcfg, _ = _serve_cfgs(kv_heads)
    cache = kvcache.init_cache(jcfg, B, T_MAX)
    lg, cache, _ = forward(jp, jcfg, toks[:, :S], cache=cache,
                           cache_index=0, mode="prefill")
    out = [np.asarray(lg[:, -1])]
    for i in range(DECODES):
        lg, cache, _ = forward(jp, jcfg, toks[:, S + i:S + i + 1],
                               cache=cache, cache_index=S + i, mode="decode")
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out)


def _port_tree(jp, tcfg):
    from repro_torch.models.convert import lm_from_jax
    import jax
    return lm_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _port_serve(p, cfg, toks, sharded=None):
    """Prefill then DECODES steps; with ``sharded`` (steps, params,
    cache, batch shardings) through the built steps."""
    from repro_torch.launch import steps
    from repro_torch.models.kvcache import init_cache
    from repro_torch.parallel.sharding import distribute, full
    t = torch.from_numpy(toks)
    if sharded is None:
        cache = init_cache(cfg, B, T_MAX, "cpu")
        out = [steps.serve_prefill(p, cfg, cache, t[:, :S])[0]]
        for i in range(DECODES):
            out.append(steps.serve_decode(p, cfg, cache,
                                          t[:, S + i:S + i + 1], S + i)[0])
        return torch.stack(out), cache
    pstep, dstep, c_sh, b_sh = sharded
    cache = distribute(init_cache(cfg, B, T_MAX, "cpu"), c_sh)
    out = [pstep(p, cache, distribute({"inputs": t[:, :S]}, b_sh))[0]]
    for i in range(DECODES):
        out.append(dstep(p, cache, distribute(
            {"inputs": t[:, S + i:S + i + 1]}, b_sh), S + i)[0])
    return torch.stack([full(o) for o in out]), full(cache)


def subprocess_main(out_dir: str) -> None:
    """The 4-rank spawn on the shared inputs and weights, and meanwhile
    the JAX references and the unsharded port steps; everything lands in
    ``out_dir``."""
    import jax
    import torch.multiprocessing as mp
    from repro.models.transformer import init_params
    from repro_torch.training.train_loop import TrainConfig, \
        make_train_step
    out = Path(out_dir)
    inp = _collective_inputs()
    params, jparams = {}, {}
    for case in TRAIN_CASES:
        jcfg, tcfg = _train_cfgs(case)
        jparams[case] = init_params(jcfg, jax.random.PRNGKey(0))
        params[case] = (_port_tree(jparams[case], tcfg),
                        {"inputs": _tokens(1, (B, 16)),
                         "labels": _tokens(2, (B, 16))})
    for kvh in SERVE_KV_HEADS:
        jcfg, tcfg = _serve_cfgs(kvh)
        jparams[kvh] = init_params(jcfg, jax.random.PRNGKey(0))
        params[("serve", kvh)] = (_port_tree(jparams[kvh], tcfg),
                                  _tokens(3, (B, S + DECODES)))
    torch.save({"inputs": inp, "params": params}, out / "inputs.pt")
    ranks = mp.spawn(_worker, args=(WORLD, out_dir), nprocs=WORLD,
                     join=False)
    ref = {"coll": _jax_collectives(inp), "train": {}, "serve": {},
           "port_train": {}, "port_serve": {}}
    for case in TRAIN_CASES:
        _, tcfg = _train_cfgs(case)
        p, batch = params[case]
        ref["train"][case] = _jax_train(case, jparams[case], batch)
        init, step = make_train_step(tcfg, TrainConfig())
        new_p, new_o, m = step(p, init(p), {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        ref["port_train"][case] = (new_p, new_o,
                                   {k: float(v) for k, v in m.items()})
    for kvh in SERVE_KV_HEADS:
        _, tcfg = _serve_cfgs(kvh)
        p, toks = params[("serve", kvh)]
        ref["serve"][kvh] = _jax_serve(kvh, jparams[kvh], toks)
        ref["port_serve"][kvh] = _port_serve(p, tcfg, toks)
    torch.save(ref, out / "ref.pt")
    while not ranks.join():
        pass


def _worker(rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out / 'rdv'}",
                            rank=rank, world_size=world)
    data = torch.load(out / "inputs.pt", weights_only=False)
    got = {"coll": _port_collectives(data["inputs"], rank)}
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    got["train"] = {c: _sharded_train(c, mesh, *data["params"][c])
                    for c in TRAIN_CASES}
    got["serve"] = {k: _sharded_serve(k, mesh, *data["params"][("serve", k)])
                    for k in SERVE_KV_HEADS}
    if rank == 0:
        torch.save(got, out / "got.pt")
    dist.barrier()
    dist.destroy_process_group()


def _gather_rows(t, group):
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _port_collectives(inp, rank):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.collectives import allgather_matmul, \
        reduce_scatter_grads
    from repro_torch.parallel.pipeline import run_pipeline
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = {}
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("fsdp",))
    rows = t["w"].shape[0] // WORLD
    got["agmm"] = allgather_matmul(t["x"], t["w"][rank * rows:
                                                  (rank + 1) * rows],
                                   mesh=mesh, axis="fsdp")
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    group = mesh.get_group("data")
    rs = reduce_scatter_grads({"w": t["g"], "u": t["g2"]}, mesh=mesh,
                              axis="data")
    got["rs_w"] = _gather_rows(rs["w"], group)
    got["rs_u"] = _gather_rows(rs["u"], group)
    # each rank's own gradient: the mean over the ranks, scattered
    own = reduce_scatter_grads({"w": t["g"] * (rank + 1)}, mesh=mesh,
                               axis="data")
    got["rs_mean"] = _gather_rows(own["w"], group)
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
    got["pipe"] = run_pipeline(lambda w, x: torch.tanh(x @ w), t["W"],
                               t["xs"], mesh=mesh, axis="stage")
    return got


def _sharded_train(case, mesh, p, batch):
    from repro_torch.launch import steps
    from repro_torch.parallel.sharding import distribute, full
    from repro_torch.training.train_loop import TrainConfig, \
        make_train_step
    _, tcfg = _train_cfgs(case)
    step, (ps, os_, _), specs = steps.build_train_step(tcfg, mesh,
                                                       TrainConfig())
    init, _ = make_train_step(tcfg, TrainConfig())
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    new_p, new_o, m = step(
        distribute(p, steps.named_safe(mesh, specs["params"], ps)),
        distribute(init(p), steps.named_safe(mesh, specs["opt"], os_)),
        distribute(b, steps.named_safe(mesh, specs["batch"], b)))
    return full(new_p), full(new_o), {k: float(full(v))
                                      for k, v in m.items()}


def _sharded_serve(kv_heads, mesh, p, toks):
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.kvcache import init_cache
    from repro_torch.parallel.sharding import distribute
    _, tcfg = _serve_cfgs(kv_heads)
    pre = ShapeConfig("prefill", "prefill", T_MAX, B)
    dec = ShapeConfig("decode", "decode", T_MAX - 1, B)
    pstep, pargs, specs = steps.build_serve_step(tcfg, mesh, pre)
    dstep, _, _ = steps.build_serve_step(tcfg, mesh, dec)
    dp = distribute(p, steps.named_safe(mesh, specs["params"], pargs[0]))
    cache = init_cache(tcfg, B, T_MAX, "cpu")
    c_sh = steps.named_safe(mesh, specs["cache"], cache)
    b_sh = steps.named_safe(mesh, specs["batch"],
                            {"inputs": torch.from_numpy(toks[:, :S])})
    logits, cache = _port_serve(dp, tcfg, toks, (pstep, dstep, c_sh, b_sh))
    return logits, cache, [tuple(sh.spec) for sh in
                           (c_sh[0]["k"], c_sh[0]["v"])]


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{TESTS}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    r = subprocess.run(
        [sys.executable, "-c", "import test_torch_parallel_dist as m; "
         f"m.subprocess_main({str(out)!r})"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=420)
    assert r.returncode == 0, r.stderr[-4000:]
    return (torch.load(out / "ref.pt", weights_only=False),
            torch.load(out / "got.pt", weights_only=False))


def test_allgather_matmul_matches_jax(results):
    ref, got = results
    want = ref["coll"]["agmm"]
    np.testing.assert_allclose(got["coll"]["agmm"].numpy(), want, **COLL_TOL)
    inp = _collective_inputs()
    np.testing.assert_allclose(want, inp["x"] @ inp["w"], atol=1e-4,
                               rtol=1e-4)


def test_reduce_scatter_grads_matches_jax(results):
    """Replicated gradients come back as themselves (JAX's output,
    sharded on dim 0, gathered); each rank's own gradient g (r + 1)
    gives the mean 2.5 g."""
    ref, got = results
    for key in ("rs_w", "rs_u"):
        np.testing.assert_allclose(got["coll"][key].numpy(),
                                   ref["coll"][key], **COLL_TOL)
    g = _collective_inputs()["g"]
    np.testing.assert_allclose(ref["coll"]["rs_w"], g, atol=1e-6)
    np.testing.assert_allclose(got["coll"]["rs_mean"].numpy(), 2.5 * g,
                               **COLL_TOL)


def test_pipeline_matches_jax(results):
    ref, got = results
    np.testing.assert_allclose(got["coll"]["pipe"].numpy(),
                               ref["coll"]["pipe"], **COLL_TOL)
    inp = _collective_inputs()
    want = inp["xs"]
    for i in range(WORLD):
        want = np.tanh(want @ inp["W"][i])
    np.testing.assert_allclose(ref["coll"]["pipe"], want, **COLL_TOL)


def _close_trees(a, b):
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.int8:       # 8-bit moments: one level
            assert (x.int() - y.int()).abs().max() <= 1
        elif x.dtype in (torch.int32, torch.int64):
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x, y, **MODEL_TOL)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_built_train_step_matches_unsharded_and_jax(results, case):
    """build_train_step on the 2 x 2 mesh: metrics against the unsharded
    port step and the JAX step, new parameters and optimizer state
    against the unsharded port step (``TRAIN_CASES`` says what each case
    goes through)."""
    ref, got = results
    new_p, new_o, m = got["train"][case]
    up, uo, um = ref["port_train"][case]
    assert set(m) == set(um) == set(ref["train"][case])
    for k in m:
        np.testing.assert_allclose(m[k], um[k], **MODEL_TOL, err_msg=k)
        np.testing.assert_allclose(m[k], ref["train"][case][k], **MODEL_TOL,
                                   err_msg=k)
    _close_trees(new_p, up)
    for field in ("count", "m", "v"):
        _close_trees(getattr(new_o, field), getattr(uo, field))
    for field in ("m_scale", "v_scale"):
        a, b = getattr(new_o, field), getattr(uo, field)
        assert (a is None) == (b is None)
        if a is not None:
            from repro_torch.tree import leaves
            for x, y in zip(leaves(a), leaves(b)):
                torch.testing.assert_close(x, y, atol=1e-12, rtol=1e-4)


@pytest.mark.parametrize("kv_heads", SERVE_KV_HEADS)
def test_built_serve_step_matches_unsharded_and_jax(results, kv_heads):
    """build_serve_step on the 2 x 2 mesh: prefill and three decode
    steps, the cache written in place, head-sharded (4 KV heads) or
    sequence-sharded (1 KV head); last-position logits against the
    unsharded port steps and the JAX forward, the cache against the
    unsharded port's."""
    ref, got = results
    logits, cache, kspecs = got["serve"][kv_heads]
    want_specs = [("data", None, "model", None)] * 2 if kv_heads == 4 \
        else [("data", "model", None, None)] * 2
    assert kspecs == want_specs
    ul, uc = ref["port_serve"][kv_heads]
    torch.testing.assert_close(logits, ul, **MODEL_TOL)
    np.testing.assert_allclose(logits.numpy(), ref["serve"][kv_heads],
                               **MODEL_TOL)
    _close_trees(cache, uc)
