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
a 2 x 2 ("data", "model") mesh (a 1 x 4 one where ``MESHES`` says). The ranks meet through a ``file://``
init method in the test's temporary directory, so two files' groups
never share a port. Rank 0 writes the gathered results, which the tests
below hold: the collectives and the pipeline at 1e-5 (as the JAX
package's tests); the steps at 5e-5, the model tolerance, against both
the unsharded port step and the JAX step (the train step's parameters
and moments against the unsharded port step, whose own parity with the
JAX step, parameters included, ``tests/test_torch_train.py`` holds;
8-bit moments within one quantisation level, their scales at 1e-4).
Each rank also records the local shapes of its attention and mLSTM
calls (the kernel dispatchers and plain versions wrapped in the worker),
so that each case shows which of ``local_calls``' plans it took.
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
# the singleton block count through and nothing shows). Attention: Yi-9B
# at 6 heads and 3 KV heads splits the query heads and gives each rank
# one KV head per query head; at 3 heads and 1 KV head, which the 2-way
# model axis does not divide, it splits the query rows (and the output
# projection takes each rank's own rows). xLSTM at 1 head: the 2-way
# model axis splits the mLSTM's value columns (each rank dv / 2 of the
# head's, q, k and the gates gathered, the state joined back) and the
# sLSTM's hidden units (h gathered at each step); at the reduced config's
# 4 heads it splits the mLSTM by heads. xLSTM at 2 heads on a 1 x 4 mesh
# (``MESHES``): each head's value columns over 2 of the 4 model ranks
# (head 0 on ranks 0 and 1, head 1 on 2 and 3), so that a rank's head
# and columns are both taken at an offset and C, n, m are joined across
# heads
TRAIN_CASES = {
    "smollm-135m": ("smollm-135m", {}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}),
    "yi-9b-3kv-fsdp": ("yi-9b", {"num_heads": 6, "num_kv_heads": 3,
                                 "d_model": 96, "fsdp": True}),
    "yi-9b-3h-rows": ("yi-9b", {"num_heads": 3, "num_kv_heads": 1,
                                "d_model": 48}),
    "jamba-v0.1-52b": ("jamba-v0.1-52b", {}),
    "xlstm-125m": ("xlstm-125m", {}),
    "xlstm-125m-1h": ("xlstm-125m", {"num_heads": 1}),
    "xlstm-125m-2h": ("xlstm-125m", {"num_heads": 2}),
    "smollm-135m-fsdp-8bit": ("smollm-135m", {"d_model": 384, "fsdp": True,
                                              "opt_8bit_moments": True}),
    # recomputation on DTensors: the periods under the full configs'
    # policies (the reduced configs take "none"), deepseek-v3's prefix
    # layer and MTP head outside its checkpoints
    "smollm-135m-dots_nb": ("smollm-135m", {"remat": "dots_nb"}),
    "deepseek-v3-671b-full": ("deepseek-v3-671b", {"remat": "full"}),
}
# the train cases that split their batch into microbatches (the rest take
# one): DeepSeek-V3's MoE routes each microbatch's tokens together and its
# MTP head reads the microbatch's labels, so each microbatch must be the
# same consecutive rows as in the JAX step
MICROBATCHES = {"deepseek-v3-671b-mb2": 2}
TRAIN_CASES["deepseek-v3-671b-mb2"] = ("deepseek-v3-671b", {})
# the cross entropy's cases: the logits' placements on the 2 x 2
# ("data", "model") mesh and whether the labels come as a DTensor split
# by batch; (4, 6, 12) float32 logits, so each model rank holds 6 of the
# 12 classes where the vocabulary is split (the vocab-parallel pick: the
# first three cases; a partial sum over the data axis reduced first),
# and with the vocabulary whole the plain ops run on the DTensors
CE_SHAPE, CE_Z = (4, 6, 12), 1e-2
CE_CASES = {"batch-vocab": (("S0", "S2"), True),
            "vocab": (("R", "S2"), False),
            "partial-vocab": (("P", "S2"), False),
            "batch": (("S0", "R"), True)}
# ``sharding.batch_chunks``' cases: (shape, placements on the 2 x 2
# mesh, batch dim, microbatches): the rows split over the data axis, over
# both axes (as the multi-pod mesh splits the batch over two), M-RoPE
# positions' batch on dim 1, and 4 microbatches of a batch the 2-way
# data axis splits (4 does not divide 2 ranks: it raises)
CHUNK_CASES = {"data": ((4, 3, 5), ("S0", "R"), 0, 2),
               "both-axes": ((8, 3), ("S0", "S0"), 0, 2),
               "positions": ((3, 4, 6), ("S1", "R"), 1, 2),
               "uneven": ((8, 3), ("S0", "R"), 0, 4)}
# the serve cases: (arch, the reduced config's fields replaced). Yi-9B: 4
# KV heads divide the 2-way model axis (head-sharded cache); at 1 KV head
# the cache is sequence-sharded, prefill splits the 4 query heads and
# decode joins the two ranks' rows; at 3 heads and 1 KV head prefill
# splits the query rows. xLSTM at 1 head: the recurrences split over the
# model axis, their states written back in place into the cache's own
# layout (replicated over the model axis at 1 head); at 2 heads on the
# 1 x 4 mesh, as the train case; at 1 head and a batch of 1
# (``SERVE_BATCH``), which the 2-way data axis leaves whole, q, k and v's
# projections also contract over the idle data axis
# (``sharding.idle_product``)
SERVE_CASES = {4: ("yi-9b", {"num_kv_heads": 4}),
               1: ("yi-9b", {"num_kv_heads": 1}),
               "3-heads-1kv": ("yi-9b", {"num_heads": 3, "num_kv_heads": 1,
                                         "d_model": 48}),
               "xlstm-1-head": ("xlstm-125m", {"num_heads": 1}),
               "xlstm-2-heads": ("xlstm-125m", {"num_heads": 2}),
               "xlstm-1-head-b1": ("xlstm-125m", {"num_heads": 1})}
B, S, DECODES, T_MAX = 4, 8, 3, 32
# the cases' (data, model) meshes over the 4 ranks: 2 x 2 unless named
MESHES = {"xlstm-125m-2h": (1, 4), "xlstm-2-heads": (1, 4)}
# the serve cases' batches: B unless named
SERVE_BATCH = {"xlstm-1-head-b1": 1}


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


def _ce_inputs():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal(CE_SHAPE) * 3).astype(np.float32)
    labels = rng.integers(0, CE_SHAPE[-1], CE_SHAPE[:-1]).astype(np.int32)
    return logits, labels


def _idle_inputs():
    """A batch of 1 (which the 2-way data axis cannot split) and a weight
    for ``sharding.idle_product``."""
    rng = np.random.default_rng(5)
    return (rng.standard_normal((1, 3, 8)).astype(np.float32),
            rng.standard_normal((8, 6)).astype(np.float32))


def _mesh_shape(case):
    return MESHES.get(case, (2, 2))


def _batch(case):
    return SERVE_BATCH.get(case, B)


def _train_config(module, case):
    return module.TrainConfig(microbatches=MICROBATCHES.get(case, 1))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape) \
        .astype(np.int32)


def _serve_cfgs(case):
    from repro import configs as jconfigs
    from repro_torch import configs
    arch, fields = SERVE_CASES[case]
    return tuple(dataclasses.replace(c.reduced_config(arch), **fields)
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
    init, step = R.make_train_step(jcfg, _train_config(R, case))
    _, _, m = jax.jit(step)(jp, init(jp), batch)
    return {k: float(v) for k, v in m.items()}


def _jax_serve(case, jp, toks):
    from repro.models import kvcache
    from repro.models.transformer import forward
    jcfg, _ = _serve_cfgs(case)
    cache = kvcache.init_cache(jcfg, len(toks), T_MAX)
    lg, cache, _ = forward(jp, jcfg, toks[:, :S], cache=cache,
                           cache_index=0, mode="prefill")
    out = [np.asarray(lg[:, -1])]
    for i in range(DECODES):
        lg, cache, _ = forward(jp, jcfg, toks[:, S + i:S + i + 1],
                               cache=cache, cache_index=S + i, mode="decode")
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out)


def _ce_references():
    """The JAX package's and the unsharded port's cross entropy (z-loss
    ``CE_Z``) of the CE inputs: (value, gradient) each."""
    import jax
    import jax.numpy as jnp
    from repro.training.train_loop import cross_entropy as jce
    from repro_torch.training.train_loop import cross_entropy
    logits, labels = _ce_inputs()
    v, g = jax.value_and_grad(lambda x: jce(x, jnp.asarray(labels), CE_Z))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = cross_entropy(x, torch.from_numpy(labels), CE_Z)
    loss.backward()
    return {"jax": (float(v), np.asarray(g)),
            "port": (float(loss), x.grad.numpy())}


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
    batch = len(toks)
    if sharded is None:
        cache = init_cache(cfg, batch, T_MAX, "cpu")
        out = [steps.serve_prefill(p, cfg, cache, t[:, :S])[0]]
        for i in range(DECODES):
            out.append(steps.serve_decode(p, cfg, cache,
                                          t[:, S + i:S + i + 1], S + i)[0])
        return torch.stack(out), cache
    pstep, dstep, c_sh, b_sh = sharded
    cache = distribute(init_cache(cfg, batch, T_MAX, "cpu"), c_sh)
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
    from repro_torch.training import train_loop as T_loop
    from repro_torch.training.train_loop import make_train_step
    out = Path(out_dir)
    inp = _collective_inputs()
    params, jparams = {}, {}
    for case in TRAIN_CASES:
        jcfg, tcfg = _train_cfgs(case)
        jparams[case] = init_params(jcfg, jax.random.PRNGKey(0))
        params[case] = (_port_tree(jparams[case], tcfg),
                        {"inputs": _tokens(1, (B, 16)),
                         "labels": _tokens(2, (B, 16))})
    for case in SERVE_CASES:
        jcfg, tcfg = _serve_cfgs(case)
        jparams[case] = init_params(jcfg, jax.random.PRNGKey(0))
        params[("serve", case)] = (_port_tree(jparams[case], tcfg),
                                   _tokens(3, (_batch(case), S + DECODES)))
    torch.save({"inputs": inp, "params": params}, out / "inputs.pt")
    ranks = mp.spawn(_worker, args=(WORLD, out_dir), nprocs=WORLD,
                     join=False)
    ref = {"coll": _jax_collectives(inp), "train": {}, "serve": {},
           "port_train": {}, "port_serve": {}, "ce": _ce_references()}
    for case in TRAIN_CASES:
        _, tcfg = _train_cfgs(case)
        p, batch = params[case]
        ref["train"][case] = _jax_train(case, jparams[case], batch)
        init, step = make_train_step(tcfg, _train_config(T_loop, case))
        new_p, new_o, m = step(p, init(p), {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        ref["port_train"][case] = (new_p, new_o,
                                   {k: float(v) for k, v in m.items()})
    for case in SERVE_CASES:
        _, tcfg = _serve_cfgs(case)
        p, toks = params[("serve", case)]
        ref["serve"][case] = _jax_serve(case, jparams[case], toks)
        ref["port_serve"][case] = _port_serve(p, tcfg, toks)
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
    meshes = {shape: init_device_mesh("cpu", shape,
                                      mesh_dim_names=("data", "model"))
              for shape in {(2, 2), *MESHES.values()}}
    mesh = meshes[(2, 2)]
    got["ce"] = {c: _sharded_ce(c, mesh) for c in CE_CASES}
    got["chunks"] = {c: _sharded_chunks(c, mesh) for c in CHUNK_CASES}
    got["idle"] = _sharded_idle_product(mesh)
    calls = _record_attention_calls()
    picks = _record_label_picks()
    idle = _record_idle_products()
    got["train"], got["serve"], got["calls"], got["picks"] = {}, {}, {}, {}
    got["idle_calls"] = {}
    for c in TRAIN_CASES:
        got["train"][c] = _sharded_train(c, meshes[_mesh_shape(c)],
                                         *data["params"][c])
        got["calls"][c] = list(calls)
        got["picks"][c] = list(picks)
        calls.clear()
        picks.clear()
    for c in SERVE_CASES:
        idle.clear()
        got["serve"][c] = _sharded_serve(c, meshes[_mesh_shape(c)],
                                         *data["params"][("serve", c)])
        got["calls"][c] = list(calls)
        got["idle_calls"][c] = list(idle)
        calls.clear()
    # ranks 0 and 1: model 0 and 1 (data 0 on the 2 x 2 mesh)
    if rank < 2:
        torch.save((got["calls"], got["picks"]), out / f"calls{rank}.pt")
    if rank == 0:
        torch.save(got, out / "got.pt")
    dist.barrier()
    dist.destroy_process_group()


def _record_attention_calls():
    """Wraps the attention and mLSTM dispatchers and plain versions that
    the built steps reach (both routes) so that each call on this rank
    appends (name, local q shape, local k shape, valid_len values, lse
    asked), for the mLSTM (name, local q shape, local C shape, None,
    False); returns the list."""
    from repro_torch.kernels import ops
    calls = []

    def recorded(name, fn):
        def run(q, k, v, *args, **kwargs):
            if name == "mlstm_chunk":
                calls.append((name, tuple(q.shape), tuple(args[2].shape),
                              None, False))
                return fn(q, k, v, *args, **kwargs)
            vl = args[0].tolist() if args else None
            calls.append((name, tuple(q.shape), tuple(k.shape), vl,
                          bool(kwargs.get("with_lse"))))
            return fn(q, k, v, *args, **kwargs)
        return run
    for name in ("flash_attention", "decode_attention", "mlstm_chunk"):
        setattr(ops, name, recorded(name, getattr(ops, name)))
        ops.PLAIN[name] = recorded(name, ops.PLAIN[name])
    return calls


def _record_idle_products():
    """Wraps the mLSTM's ``idle_product`` so that each call on this rank
    appends whether its product came back a partial sum (contracted over
    an idle mesh dim); returns the list."""
    from torch.distributed.tensor import DTensor, Partial
    from repro_torch.models import xlstm
    split = []
    inner = xlstm.idle_product

    def recorded(x, w):
        y = inner(x, w)
        split.append(isinstance(y, DTensor) and any(
            isinstance(p, Partial) for p in y.placements))
        return y
    xlstm.idle_product = recorded
    return split


def _record_label_picks():
    """Wraps the train loop's ``cross_entropy`` so that each call on this
    rank appends (the logits' local shape, the operand shapes of the
    all-gathers the call ran on this rank); returns the list."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.training import train_loop
    picks = []

    class Gathers(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented   # the local ops are what run
            if func._schema.name.startswith(
                    "_c10d_functional::all_gather"):
                self.shapes.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    inner = train_loop.cross_entropy

    def recorded(logits, labels, z_coef=0.0):
        with Gathers() as g:
            loss = inner(logits, labels, z_coef)
        picks.append((tuple(logits.to_local().shape), g.shapes))
        return loss
    train_loop.cross_entropy = recorded
    return picks


def _placement(code):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return {"R": Replicate(), "P": Partial()}.get(code) \
        or Shard(int(code[1:]))


def _sharded_ce(case, mesh):
    """The port's ``cross_entropy`` (z-loss ``CE_Z``) of the CE inputs
    laid out by ``CE_CASES[case]``: (value, the logits' full gradient)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, \
        distribute_tensor
    from repro_torch.training.train_loop import cross_entropy
    codes, dt_labels = CE_CASES[case]
    pl = tuple(_placement(c) for c in codes)
    logits, labels = (torch.from_numpy(a) for a in _ce_inputs())
    if any(c == "P" for c in codes):
        # each data rank's share of a partial sum: half the logits
        local = distribute_tensor(logits, mesh, tuple(
            Replicate() if c == "P" else p for c, p in zip(codes, pl)))
        x = DTensor.from_local(local.to_local() / 2, mesh, pl,
                               run_check=False)
        x = x.detach().requires_grad_(True)
    else:
        x = distribute_tensor(logits, mesh, pl).requires_grad_(True)
    if dt_labels:
        labels = distribute_tensor(labels, mesh, (Shard(0), Replicate()))
    loss = cross_entropy(x, labels, CE_Z)
    loss.backward()
    return float(loss.full_tensor()), x.grad.full_tensor()


def _chunk_input(case):
    shape = CHUNK_CASES[case][0]
    return torch.arange(int(np.prod(shape)), dtype=torch.float32) \
        .reshape(shape)


def _sharded_chunks(case, mesh):
    """``batch_chunks`` of the case's input laid out on the mesh: each
    microbatch's (full tensor, placements, local shape), or the message
    it raised."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.sharding import batch_chunks
    _, codes, dim, k = CHUNK_CASES[case]
    x = distribute_tensor(_chunk_input(case), mesh,
                          tuple(_placement(c) for c in codes))
    try:
        parts = batch_chunks(x, dim, k)
    except ValueError as e:
        return str(e)
    return [(p.full_tensor(), tuple(p.placements),
             tuple(p.to_local().shape)) for p in parts]


def _sharded_idle_product(mesh):
    """``sharding.idle_product`` of the idle inputs, x whole and the
    weight split by columns over the model axis, under the standard
    rules: (the full product, its placements)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.parallel import sharding as S
    x, w = (torch.from_numpy(a) for a in _idle_inputs())
    with S.sharding_rules(S.make_rules(), mesh):
        y = S.idle_product(distribute_tensor(x, mesh, (Replicate(),) * 2),
                           distribute_tensor(w, mesh, (Replicate(),
                                                       Shard(1))))
    return y.full_tensor(), tuple(y.placements)


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
    from repro_torch.training import train_loop
    from repro_torch.training.train_loop import make_train_step
    _, tcfg = _train_cfgs(case)
    step, (ps, os_, _), specs = steps.build_train_step(
        tcfg, mesh, _train_config(train_loop, case))
    init, _ = make_train_step(tcfg, _train_config(train_loop, case))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    new_p, new_o, m = step(
        distribute(p, steps.named_safe(mesh, specs["params"], ps)),
        distribute(init(p), steps.named_safe(mesh, specs["opt"], os_)),
        distribute(b, steps.named_safe(mesh, specs["batch"], b)))
    return full(new_p), full(new_o), {k: float(full(v))
                                      for k, v in m.items()}


def _sharded_serve(case, mesh, p, toks):
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.kvcache import init_cache
    from repro_torch.parallel.sharding import distribute
    _, tcfg = _serve_cfgs(case)
    batch = len(toks)
    pre = ShapeConfig("prefill", "prefill", T_MAX, batch)
    dec = ShapeConfig("decode", "decode", T_MAX - 1, batch)
    pstep, pargs, specs = steps.build_serve_step(tcfg, mesh, pre)
    dstep, _, _ = steps.build_serve_step(tcfg, mesh, dec)
    dp = distribute(p, steps.named_safe(mesh, specs["params"], pargs[0]))
    cache = init_cache(tcfg, batch, T_MAX, "cpu")
    c_sh = steps.named_safe(mesh, specs["cache"], cache)
    b_sh = steps.named_safe(mesh, specs["batch"],
                            {"inputs": torch.from_numpy(toks[:, :S])})
    logits, cache = _port_serve(dp, tcfg, toks, (pstep, dstep, c_sh, b_sh))
    return logits, cache, {name: tuple(sh.spec)
                           for name, sh in c_sh[0].items()}


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
    got = torch.load(out / "got.pt", weights_only=False)
    got["calls"], got["picks"] = zip(*[
        torch.load(out / f"calls{r}.pt", weights_only=False)
        for r in (0, 1)])
    return torch.load(out / "ref.pt", weights_only=False), got


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


# the attention calls each case makes on ranks 0 and 1 (data 0, model 0
# and 1): (name, local q shape, local k shape, valid_len values on rank 0
# and on rank 1, log-sum-exp asked), in order. Local batch 2 of 4, head
# dim 16; prefill and training run flash attention once a layer (2
# layers), decode runs decode attention once a layer and step.
def _decode_calls(q, k, lse, shifted):
    """Decode's calls at steps S, S + 1, S + 2: rank 0 holds rows from 0,
    rank 1 from ``shifted`` (clipped to 0 where its rows are all past
    the live ones)."""
    return [("decode_attention", q, k, [S + i + 1] * 2,
             [max(S + i + 1 - shifted, 0)] * 2, lse)
            for i in range(DECODES) for _ in range(2)]


EXPECTED_CALLS = {
    # heads and KV heads split
    4: [("flash_attention", (2, 8, 2, 16), (2, 8, 2, 16), None, None,
         False)] * 2 + _decode_calls((2, 2, 16), (2, 32, 2, 16), False, 0),
    # query heads split, each rank's two read one KV head; decode over
    # each rank's 16 of the 32 cache rows, joined by their lse
    1: [("flash_attention", (2, 8, 2, 16), (2, 8, 1, 16), None, None,
         False)] * 2 + _decode_calls((2, 4, 16), (2, 16, 1, 16), True, 16),
    # 3 heads on 2: query rows split, K/V whole
    "3-heads-1kv": [("flash_attention", (2, 4, 3, 16), (2, 8, 1, 16), None,
                     None, False)] * 2
    + _decode_calls((2, 3, 16), (2, 16, 1, 16), True, 16),
    # 6 heads split 3 a rank over 3 KV heads: one KV head per query head
    "yi-9b-3kv-fsdp": [("flash_attention", (2, 16, 3, 16), (2, 16, 3, 16),
                        None, None, False)] * 2,
    "yi-9b-3h-rows": [("flash_attention", (2, 8, 3, 16), (2, 16, 1, 16),
                       None, None, False)] * 2,
}
# the mLSTM's (10 layers of the reduced config's 12): at 4 heads each
# rank two heads whole (dk = dv = 32), at 1 head each rank half the
# head's value columns (dk 128, dv 64 of 128), at 2 heads on the 1 x 4
# mesh a quarter of E, half of its head's columns (dk 64, dv 32 of 64, the
# whole batch of 4 a rank); train over 16 tokens, serve a prefill of S
# then one step at a time
_MLSTM = 10


def _served(b, dk, dv):
    return [("mlstm_chunk", (b, S, 1, dk), (b, 1, dk, dv), None, None,
             False)] * _MLSTM + [("mlstm_chunk", (b, 1, 1, dk),
                                  (b, 1, dk, dv), None, None, False)] * (
        _MLSTM * DECODES)


EXPECTED_CALLS.update({
    "xlstm-125m": [("mlstm_chunk", (2, 16, 2, 32), (2, 2, 32, 32), None,
                    None, False)] * _MLSTM,
    "xlstm-125m-1h": [("mlstm_chunk", (2, 16, 1, 128), (2, 1, 128, 64),
                       None, None, False)] * _MLSTM,
    "xlstm-125m-2h": [("mlstm_chunk", (4, 16, 1, 64), (4, 1, 64, 32),
                       None, None, False)] * _MLSTM,
    "xlstm-1-head": _served(2, 128, 64),
    "xlstm-2-heads": _served(4, 64, 32),
    "xlstm-1-head-b1": _served(1, 128, 64),
})
# the mLSTM state's layout in the serve cases' caches: split by batch over
# a data axis of 2 ranks (the 1 x 4 mesh's data axis of one rank named in
# no spec, a batch of 1 whole), never over the model axis, on which
# neither 1 head on 2 ranks nor 2 heads on 4 split
XLSTM_CACHE_BATCH = {"xlstm-1-head": "data", "xlstm-2-heads": None,
                     "xlstm-1-head-b1": None}


def _assert_calls(got, case):
    """Each rank's attention and mLSTM calls are the case's plan's."""
    want = EXPECTED_CALLS.get(case)
    if want is None:
        return
    for rank, calls in enumerate(got["calls"]):
        assert [(n, qs, ks, vl, lse) for n, qs, ks, vl, lse in calls[case]] \
            == [(n, qs, ks, vls[rank], lse)
                for n, qs, ks, *vls, lse in want], (case, rank)


@pytest.mark.parametrize("case", list(CE_CASES))
def test_vocab_parallel_cross_entropy_matches_plain_and_jax(results, case):
    """The port's cross entropy with z-loss on logits laid out by
    ``CE_CASES[case]`` on the 2 x 2 mesh (the label pick on each rank's
    vocabulary slice): its value and the logits' gradient against the
    unsharded port's and the JAX package's, with labels in both model
    ranks' slices."""
    ref, got = results
    _, labels = _ce_inputs()
    half = CE_SHAPE[-1] // 2
    assert (labels < half).any() and (labels >= half).any()
    value, grad = got["ce"][case]
    for want_value, want_grad in (ref["ce"]["port"], ref["ce"]["jax"]):
        np.testing.assert_allclose(value, want_value, **MODEL_TOL)
        np.testing.assert_allclose(grad.numpy(), want_grad, **MODEL_TOL)


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_batch_chunks_keep_the_rows_and_the_split(results, case):
    """``sharding.batch_chunks`` on the 2 x 2 mesh: each microbatch holds
    the consecutive rows that ``chunk`` gives the whole tensor, laid out
    as the input was, each rank holding its share of the microbatch's
    rows; a split it cannot keep raises."""
    _, got = results
    shape, codes, dim, k = CHUNK_CASES[case]
    if case == "uneven":
        assert "do not make 4 microbatches" in got["chunks"][case]
        return
    want = _chunk_input(case).chunk(k, dim=dim)
    split = 2 ** sum(c == f"S{dim}" for c in codes)
    assert len(got["chunks"][case]) == k
    for (full, pl, local), w in zip(got["chunks"][case], want):
        torch.testing.assert_close(full, w, atol=0, rtol=0)
        assert pl == tuple(_placement(c) for c in codes)
        assert local[dim] == w.shape[dim] // split


def test_idle_product_contracts_over_the_idle_data_axis(results):
    """``sharding.idle_product`` at a batch of 1 on the 2 x 2 mesh: each
    data rank contracts its half of K (the product a partial sum over the
    data axis, split by columns over the model axis), and the reduced
    product is ``x @ w``."""
    from torch.distributed.tensor import Partial, Shard
    _, got = results
    y, pl = got["idle"]
    x, w = _idle_inputs()
    np.testing.assert_allclose(y.numpy(), x @ w, **COLL_TOL)
    assert pl == (Partial(), Shard(2))


def _assert_vocab_parallel(got, case):
    """Each cross entropy of the case's step ran on ranks 0 and 1 on its
    own half of the vocabulary and its own rows, and gathered nothing:
    the loss's and, with the MTP head, the MTP loss's, once a
    microbatch."""
    _, tcfg = _train_cfgs(case)
    data, model = _mesh_shape(case)
    rows = B // data // MICROBATCHES.get(case, 1)
    per_mb = 2 if tcfg.mtp_depth else 1
    for picks in got["picks"]:
        assert len(picks[case]) == per_mb * MICROBATCHES.get(case, 1)
        for shape, gathers in picks[case]:
            assert shape[0] == rows and \
                shape[-1] == tcfg.vocab_size // model
            assert gathers == [], (case, gathers)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_built_train_step_matches_unsharded_and_jax(results, case):
    """build_train_step on the case's mesh: metrics against the unsharded
    port step and the JAX step, new parameters and optimizer state
    against the unsharded port step (``TRAIN_CASES`` says what each case
    goes through); the attention split each rank took
    (``EXPECTED_CALLS``); each label pick on the rank's own rows and
    vocabulary slice, with no all-gather."""
    ref, got = results
    _assert_calls(got, case)
    _assert_vocab_parallel(got, case)
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


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_built_serve_step_matches_unsharded_and_jax(results, case):
    """build_serve_step on the case's mesh: prefill and three decode
    steps, the cache written in place, head-sharded (4 KV heads) or
    sequence-sharded (1 KV head), or xLSTM's recurrent states;
    last-position logits against the unsharded port steps and the JAX
    forward, the cache against the unsharded port's; the attention or
    mLSTM split each rank took (``EXPECTED_CALLS``); at a batch of 1,
    q, k and v's projections contracted over the idle data axis."""
    ref, got = results
    _assert_calls(got, case)
    logits, cache, specs = got["serve"][case]
    if SERVE_CASES[case][0] == "xlstm-125m":
        b = XLSTM_CACHE_BATCH[case]
        assert (specs["C"], specs["n"], specs["m"]) == (
            (b, None, None, None), (b, None, None), (b, None))
        # 3 products a layer and call: prefill and each decode step
        idle = got["idle_calls"][case]
        assert len(idle) == 3 * _MLSTM * (1 + DECODES)
        assert all(idle) == (_batch(case) == 1) and any(idle) == all(idle)
    else:
        want_specs = [("data", None, "model", None)] * 2 if case == 4 \
            else [("data", "model", None, None)] * 2
        assert [specs["k"], specs["v"]] == want_specs
    ul, uc = ref["port_serve"][case]
    torch.testing.assert_close(logits, ul, **MODEL_TOL)
    np.testing.assert_allclose(logits.numpy(), ref["serve"][case],
                               **MODEL_TOL)
    _close_trees(cache, uc)
