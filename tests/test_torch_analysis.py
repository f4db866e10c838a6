"""The port's analysis and dry run against the JAX package's, on the CPU.

Mirrors ``tests/test_hlo_analysis.py``: the dtype byte table, layer
counting (the port unrolls every layer, so a config at 4 periods counts
exactly two periods more than at 2, where the JAX package weights its
scanned loop), dot flops against ``analyze_hlo`` of the JAX package's
compiled prefill (reduced configs, B 2, S 64; the JAX side from
``jax.eval_shape`` shapes, the port's from ``meta`` and from CPU
tensors), collectives on a 4-rank gloo group and ``model_flops`` for
every (arch, shape). Then the kernels' work formulas (``ops.WORK``)
against the count of their plain versions, the ``meta`` branch, the
roofline at the H100 peaks, ``dryrun.run_cell`` on a ``fake`` group of
256 ranks, the dry run's skip rule, and the CLI in a process where
``jax`` and ``repro`` fail to import. Counts are exact.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import hlo as jhlo
from repro.analysis.roofline import model_flops as jax_model_flops
from repro.configs import applicable as jax_applicable
from repro.models import kvcache as jkv
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro_torch import configs
from repro_torch.analysis import count, roofline
from repro_torch.analysis.count import count_call
from repro_torch.kernels import ops
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import forward, init_params
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
DOT_ARCHS = ("yi-9b", "smollm-135m", "jamba-v0.1-52b", "deepseek-v3-671b")


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="2", **extra)


# ---------------------------------------------------------------------------
# the dtype byte table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(count.HLO_NAMES), ids=str)
def test_dtype_bytes_match_the_hlo_table(dtype):
    name = count.HLO_NAMES[dtype]
    assert count.dtype_bytes(dtype) == jhlo._DTYPE_BYTES[name] \
        == torch.empty((), dtype=dtype).element_size()


def test_tensor_bytes():
    """``test_shape_bytes``'s cases as tensors."""
    assert count.tensor_bytes(torch.empty(8, 16)) == 8 * 16 * 4
    assert count.tensor_bytes(torch.empty(2, 3, dtype=torch.bfloat16)) == 12
    assert count.tensor_bytes([torch.empty((), dtype=torch.int32),
                               [torch.empty(4)]]) == 4 + 16
    assert count.tensor_bytes(torch.empty((), dtype=torch.bool)) == 1


# ---------------------------------------------------------------------------
# layer counting (the JAX package's loop weighting)
# ---------------------------------------------------------------------------
def _prefill_count(cfg, cache_len=S, dev="meta", impl="fused"):
    params = init_params(cfg, seed=0, device=dev) if dev == "cpu" \
        else init_params(cfg, device="meta")
    toks = torch.zeros((B, S), dtype=torch.int32, device=dev)
    _, got = count_call(forward, params, cfg, toks,
                        cache=init_cache(cfg, B, cache_len, dev),
                        cache_index=0, mode="prefill", impl=impl)
    return got


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-v0.1-52b"])
def test_every_layer_is_counted(arch):
    """A reduced config at 4 periods counts exactly two periods more
    than at 2 (one period: 2 periods less 1), flops and bytes."""
    cfg = configs.reduced_config(arch)

    def at(periods):
        layers = len(cfg.prefix_pattern) + periods * len(cfg.period_pattern)
        return _prefill_count(dataclasses.replace(cfg, num_layers=layers))
    c1, c2, c4 = at(1), at(2), at(4)
    for key in ("dot_flops", "traffic_bytes"):
        assert c2[key] > c1[key] > 0
        assert c4[key] - c2[key] == 2 * (c2[key] - c1[key]), key


# ---------------------------------------------------------------------------
# dot flops against the JAX package's compiled steps
# ---------------------------------------------------------------------------
def _jax_dot_flops(jcfg, cache_len, S_in, cache_index):
    ps = jax.eval_shape(lambda k: jax_init_params(jcfg, k),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    cache = jax.eval_shape(lambda: jkv.init_cache(jcfg, B, cache_len))
    mode = "prefill" if S_in > 1 else "decode"

    def step(p, c, t, i):
        return jax_forward(p, jcfg, t, cache=c, cache_index=i,
                           mode=mode)[:2]
    args = (ps, cache, jax.ShapeDtypeStruct((B, S_in), jnp.int32))
    if cache_index == 0:
        f = jax.jit(lambda p, c, t: step(p, c, t, 0))
    else:
        f = jax.jit(step)
        args = args + (jax.ShapeDtypeStruct((), jnp.int32),)
    hlo = f.lower(*args).compile().as_text()
    return jhlo.analyze_hlo(hlo)["dot_flops"]


def _attention_gap(cfg, cache_len):
    """What the JAX prefill computes beyond the port's: QKᵀ and PV over
    the cache rows past the prompt, in every non-MLA attention layer
    (the port attends over the fresh rows at ``cache_index`` 0)."""
    n_attn = sum(m == "attn" for m, _ in cfg.flat_pattern())
    return n_attn * 2 * 2 * B * cfg.num_heads * S * (cache_len - S) \
        * cfg.resolved_head_dim


@pytest.mark.parametrize("cache_len", [S, 2 * S])
@pytest.mark.parametrize("arch", DOT_ARCHS)
def test_prefill_dot_flops_match_the_reference(arch, cache_len):
    """At a cache as long as the prompt the counts are equal; at 128
    rows the JAX prefill also multiplies over the 64 unused rows of each
    non-MLA attention layer (4,194,304 for yi-9b; deepseek-v3's MLA
    attends over the fresh rows in both). The port's count is the same
    on its plain route on CPU tensors and through the kernels on
    ``meta``."""
    jcfg, cfg = jconfigs.reduced_config(arch), configs.reduced_config(arch)
    want = _jax_dot_flops(jcfg, cache_len, S, 0)
    plain = _prefill_count(cfg, cache_len, dev="cpu", impl="unfused")
    meta = _prefill_count(cfg, cache_len)
    assert plain["dot_flops"] == meta["dot_flops"]
    assert want - meta["dot_flops"] == _attention_gap(cfg, cache_len)
    if cache_len == S:
        assert want == meta["dot_flops"] > 0
    if arch == "yi-9b":
        assert meta["dot_flops"] == 41_943_040
        assert want == 41_943_040 + (4_194_304 if cache_len > S else 0)
    if arch == "jamba-v0.1-52b":
        assert meta["dot_flops"] == 623_378_432


@pytest.mark.parametrize("arch", DOT_ARCHS)
def test_decode_dot_flops_match_the_reference(arch):
    """One decode step at slot 64 against a 128-row cache: equal, since
    both attend over every cache row and mask the dead ones."""
    jcfg, cfg = jconfigs.reduced_config(arch), configs.reduced_config(arch)
    want = _jax_dot_flops(jcfg, 2 * S, 1, S)
    _, got = count_call(
        forward, init_params(cfg, device="meta"), cfg,
        torch.zeros((B, 1), dtype=torch.int32, device="meta"),
        cache=init_cache(cfg, B, 2 * S, "meta"), cache_index=S,
        mode="decode")
    assert got["dot_flops"] == want > 0


# ---------------------------------------------------------------------------
# collectives on a 4-rank gloo group
# ---------------------------------------------------------------------------
_GLOO = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist, torch.multiprocessing as mp
    from repro_torch.analysis.count import Count

    def worker(rank, path):
        dist.init_process_group("gloo", init_method="file://" + path,
                                rank=rank, world_size=4)
        import torch.distributed._functional_collectives as fc
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        x = torch.full((8, 16), float(rank))
        res = {}
        with Count() as c:
            dist.all_gather_into_tensor(torch.empty(32, 16), x)
        res["all_gather"] = c.result()
        with Count() as c:
            for _ in range(5):
                dist.all_reduce(x)
        res["all_reduces"] = c.result()
        with Count() as c:
            fc.all_gather_tensor(x, 0, list(range(4))) + 0
        res["functional"] = c.result()
        mesh = init_device_mesh("cpu", (4,))
        xd = DTensor.from_local(x, mesh, [Shard(0)], run_check=False)
        wd = DTensor.from_local(torch.ones(16, 32), mesh, [Replicate()],
                                run_check=False)
        with Count() as c:
            xd @ wd
            xd.redistribute(mesh, [Replicate()]).to_local() + 0
        res["dtensor"] = c.result()
        if rank == 0:
            print("RESULT " + json.dumps(res), flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.start_processes(worker, args=(sys.argv[1],), nprocs=4,
                           start_method="fork")
    """)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("gloo") / "rdv"
    r = subprocess.run([sys.executable, "-c", _GLOO, str(rdv)],
                       capture_output=True, text=True, env=_env(), cwd=ROOT,
                       timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.split("RESULT ", 1)[1])


def test_all_gather_is_counted(gloo):
    """``test_while_trip_count_weighting``'s all-gather: an f32 (8, 16)
    shard on 4 ranks, operand 512 bytes, result 2048; also through the
    functional collective."""
    for key in ("all_gather", "functional"):
        ag = gloo[key]["collectives"]["all-gather"]
        assert ag == {"operand_bytes": 512.0, "result_bytes": 2048.0,
                      "count": 1.0}


def test_all_reduces_in_a_loop_are_counted(gloo):
    """Five all-reduces of 512 bytes: count 5, operand 5 x 512."""
    ar = gloo["all_reduces"]["collectives"]
    assert ar == {"all-reduce": {"operand_bytes": 5 * 512.0,
                                 "result_bytes": 5 * 512.0, "count": 5.0}}


def test_dtensor_work_is_counted_per_device(gloo):
    """A DTensor product counts rank 0's local product, its (8, 16)
    shard @ (16, 32), not the global (32, 16) one; gathering the f32
    shards counts one all-gather of 512 bytes."""
    got = gloo["dtensor"]
    assert got["dot_flops"] == 2 * 8 * 16 * 32
    assert got["collectives"] == {"all-gather": {
        "operand_bytes": 512.0, "result_bytes": 2048.0, "count": 1.0}}


# ---------------------------------------------------------------------------
# model_flops, the skip rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_model_flops_match_the_reference(arch, shape):
    assert roofline.model_flops(arch, shape) == jax_model_flops(arch, shape)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_applicable_and_subquadratic_match_the_reference(arch):
    mine, theirs = configs.get_config(arch), jconfigs.get_config(arch)
    assert mine.is_subquadratic == theirs.is_subquadratic
    for name in jconfigs.SHAPES:
        assert configs.applicable(mine, configs.SHAPES[name]) == \
            jax_applicable(theirs, jconfigs.SHAPES[name])


# ---------------------------------------------------------------------------
# the kernels' work, whichever route runs
# ---------------------------------------------------------------------------
def _kernel_args(name, small):
    g = torch.Generator().manual_seed(0 if small else 1)

    def r(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dt)
    Bk, T = (2, 5) if small else (3, 9)
    f32 = torch.float32
    if name in ("flash_attention", "flash_attention_noncausal"):
        q, kv = r(Bk, T, 4, 16), (r(Bk, T + 3, 2, 16), r(Bk, T + 3, 2, 16))
        return (q, *kv), {"causal": name == "flash_attention",
                          "kv_len": T + 1}
    if name == "decode_attention":
        return (r(Bk, 4, 16), r(Bk, T, 2, 16), r(Bk, T, 2, 16),
                torch.arange(1, Bk + 1, dtype=torch.int32)), {}
    if name == "fused_groupnorm":
        return (r(Bk, 4, 4, 8), r(8, dt=f32), r(8, dt=f32)), {"groups": 4}
    if name == "fused_rmsnorm":
        x = r(Bk, T, 32)
        return (x, r(32, dt=f32)), ({} if small else {"residual": r(Bk, T,
                                                                    32)})
    if name == "swiglu":
        return (r(Bk, T, 24), r(Bk, T, 24)), {}
    if name == "mlstm_chunk":
        H, dk, dv = 2, 8, 4
        return (r(Bk, T, H, dk), r(Bk, T, H, dk), r(Bk, T, H, dv),
                r(Bk, T, H, dt=f32), r(Bk, T, H, dt=f32),
                torch.zeros(Bk, H, dk, dv), torch.zeros(Bk, H, dk),
                torch.full((Bk, H), -math.inf)), {}
    E, N = 6, 4
    return (r(Bk, T, E), r(Bk, T, E).abs(), -r(E, N, dt=f32).abs(),
            r(Bk, T, N), r(Bk, T, N), r(E, dt=f32),
            torch.zeros(Bk, E, N)), {}


KERNEL_CASES = list(ops.WORK) + ["flash_attention_noncausal"]


@pytest.mark.parametrize("small", [True, False], ids=["small", "large"])
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernel_work_formula(case, small):
    """``ops.WORK``: the flops the count gives the plain version (a
    product over every key row, masked or not; the recurrences' per
    step), and 2 x the bytes the kernel writes (outputs and in-place
    states); the dispatcher on CPU tensors counts exactly that."""
    name = "flash_attention" if case.startswith("flash") else case
    args, kw = _kernel_args(case, small)
    flops, nbytes = ops.WORK[name](*args, **kw)
    out, plain = count_call(ops.PLAIN[name], *[a.clone() for a in args],
                            **kw)
    assert flops == plain["dot_flops"]
    if name in ("flash_attention", "decode_attention", "mlstm_chunk",
                "mamba_scan"):
        assert flops > 0
    states = {"mlstm_chunk": args[5:], "mamba_scan": args[6:]}.get(name, ())
    assert nbytes == 2 * count.tensor_bytes([out, *states])
    _, routed = count_call(getattr(ops, name), *[a.clone() for a in args],
                           **kw)
    assert routed == {"collectives": {}, "dot_flops": flops,
                      "traffic_bytes": float(nbytes)}


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_meta_branch_launches_nothing(case, monkeypatch):
    """On ``meta`` each dispatcher returns an empty output of its plain
    version's shapes and dtypes, reaches no kernel wrapper and moves no
    launch counter; under a count it adds the same work as on the
    CPU."""
    name = "flash_attention" if case.startswith("flash") else case
    before = ops.launch_counts()
    for module, kernel in ((ops._flash, "flash_attention"),
                           (ops._gn, "fused_groupnorm"),
                           (ops._decode, "decode_attention"),
                           (ops._rms, "fused_rmsnorm"),
                           (ops._swiglu, "swiglu"),
                           (ops._mlstm, "mlstm_chunk"),
                           (ops._mamba, "mamba_scan")):
        monkeypatch.setattr(module, kernel, _refuse)
    args, kw = _kernel_args(case, True)
    want = ops.PLAIN[name](*[a.clone() for a in args], **kw)
    meta = [a.to("meta") for a in args]
    kw_meta = {k: v.to("meta") if torch.is_tensor(v) else v
               for k, v in kw.items()}
    got, counted = count_call(getattr(ops, name), *meta, **kw_meta)
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    assert [(o.device.type, o.shape, o.dtype) for o in outs] == \
        [("meta", w.shape, w.dtype) for w in wants]
    assert ops.launch_counts() == before
    flops, nbytes = ops.WORK[name](*args, **kw)
    assert (counted["dot_flops"], counted["traffic_bytes"]) == \
        (flops, nbytes)


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel wrapper was reached on meta")


def test_count_by_op_sums_the_dot_flops():
    """``Count(by_op=True)``: the dot flops by op and operand shapes, a
    kernel call under its name, largest first, summing to the total."""
    x, w = torch.randn(3, 4), torch.randn(4, 5)
    args, _ = _kernel_args("mlstm_chunk", True)
    with count.Count(by_op=True) as c:
        x @ w
        x @ w
        ops.mlstm_chunk(*[a.clone() for a in args])
    res = c.result()
    by = res["dot_flops_by_op"]
    assert [v for _, v in by] == sorted((v for _, v in by), reverse=True)
    assert dict(by) == {"mm (3, 4) x (4, 5)": 2 * 2.0 * 3 * 4 * 5,
                        "mlstm_chunk": ops.WORK["mlstm_chunk"](*args)[0]}
    assert sum(v for _, v in by) == res["dot_flops"]


# ---------------------------------------------------------------------------
# the roofline at the H100 peaks
# ---------------------------------------------------------------------------
def test_roofline_terms_at_h100_peaks():
    rec = {"arch": "smollm-135m", "shape": "train_4k", "mesh": "16x16",
           "n_devices": 256, "status": "ok", "dot_flops": 989e12,
           "traffic_bytes": 6.7e12,
           "collectives": {"all-gather": {"operand_bytes": 100e9,
                                          "result_bytes": 0, "count": 3},
                           "all-reduce": {"operand_bytes": 50e9,
                                          "result_bytes": 0, "count": 1}},
           "argument_size_in_bytes": 2**31, "temp_size_in_bytes": None}
    got = roofline.analyze(rec)
    assert got["compute_s"] == pytest.approx(1.0, rel=1e-12)
    assert got["memory_s"] == pytest.approx(2.0, rel=1e-12)
    assert got["collective_s"] == pytest.approx(3.0, rel=1e-12)
    assert got["dominant"] == "collective"
    mf = roofline.model_flops("smollm-135m", "train_4k")
    assert got["model_flops"] == mf
    assert got["useful_ratio"] == mf / (989e12 * 256)
    assert got["roofline_frac"] == pytest.approx(mf / 256 / 989e12 / 3.0,
                                                 rel=1e-12)
    assert (got["temp_gib"], got["arg_gib"]) == (0.0, 2.0)
    assert roofline.analyze({**rec, "status": "error"}) is None
    assert "| smollm-135m | train_4k |" in roofline.to_markdown([got])
    text = " ".join(roofline.NOTES.values()).lower()
    assert "tensor-core" in text and "mxu" not in text
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NET_BW) == \
        (989e12, 3.35e12, 50e9)


# ---------------------------------------------------------------------------
# the dry run on a fake group of 256 ranks
# ---------------------------------------------------------------------------
_CELLS = textwrap.dedent("""
    import dataclasses, json, math
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun, steps
    from repro_torch.parallel.sharding import mesh_sizes
    from repro_torch.tree import leaves

    def shard_bytes(tree, shardings, sizes):
        total = 0
        for t, sh in zip(leaves(tree), leaves(shardings)):
            n = 1
            for d, entry in zip(t.shape, tuple(sh.spec) + (None,) * t.ndim):
                axes = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                n *= d // math.prod(sizes[a] for a in axes)
            total += n * t.element_size()
        return total

    cfg, full = configs.reduced_config("yi-9b"), configs.get_config("yi-9b")
    reduced = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
               if getattr(cfg, f.name) != getattr(full, f.name)}
    out = {}
    for shape in ("decode_32k", "train_4k"):
        rec = dryrun.run_cell("yi-9b", shape, False, reduced)
        rec["overrides"] = sorted(rec["overrides"])
        mesh = dryrun.make_production_mesh(device_type="cpu")
        sizes = mesh_sizes(mesh)
        if shape == "train_4k":
            _, trees, specs = steps.build_train_step(cfg, mesh)
            names = ("params", "opt", "batch")
        else:
            _, trees, specs = steps.build_serve_step(cfg, mesh, SHAPES[shape])
            names = ("params", "cache", "batch")
        want = sum(shard_bytes(t, steps.named_safe(mesh, specs[n], t), sizes)
                   for t, n in zip(trees, names))
        want += sum(t.element_size() for t in trees[3:])
        out[shape] = {"rec": rec, "want_args": want}
    out["skipped"] = dryrun.run_cell("yi-9b", "long_500k", False)
    print("RESULT " + json.dumps(out))
    """)


@pytest.fixture(scope="module")
def cells():
    r = subprocess.run([sys.executable, "-c", _CELLS], capture_output=True,
                       text=True, env=_env(), cwd=ROOT, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.split("RESULT ", 1)[1])


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_dryrun_cell_on_a_fake_group(cells, shape):
    """Reduced yi-9b (its fields as overrides) on the 16 x 16 mesh of
    256 fake ranks: status ok,
    argument bytes the sum of rank 0's shard sizes under ``named_safe``'s
    specs (each dim over its axes' product), work counted, collectives
    counted (train: all-gathers; decode: the all-reduces that join each
    rank's attention over its rows of the sequence-sharded cache, which
    is not gathered), the memory record (a peak and a largest allocation
    no larger), the fields the roofline reads."""
    got = cells[shape]
    rec = got["rec"]
    assert rec["status"] == "ok", rec
    assert (rec["mesh"], rec["axes"], rec["n_devices"]) == \
        ("16x16", ["data", "model"], 256)
    assert "num_layers" in rec["overrides"] and "name" in rec["overrides"]
    assert rec["argument_size_in_bytes"] == got["want_args"] > 0
    assert rec["output_size_in_bytes"] > 0
    assert rec["dot_flops"] > 0 and rec["traffic_bytes"] > 0
    if shape == "decode_32k":
        assert rec["collectives"]["all-reduce"]["count"] > 0
        assert "all-gather" not in rec["collectives"]
    else:
        assert rec["collectives"]["all-gather"]["count"] > 0
    temp, largest = rec["temp_size_in_bytes"], rec["largest_allocation"]
    assert isinstance(temp, int) and 0 < largest["bytes"] <= temp
    assert set(rec["counted_by"]) >= {
        "dot_flops", "traffic_bytes", "collectives",
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "largest_allocation"}
    assert roofline.analyze(rec)["dominant"] in ("compute", "memory",
                                                 "collective")


def test_skipped_cell_gives_its_reason(cells):
    """long_500k on a full-attention arch is skipped, with the JAX
    package's reason, before any step is built."""
    rec = cells["skipped"]
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
    assert "dot_flops" not in rec


_NO_JAX_CLI = textwrap.dedent("""
    import json, runpy, sys
    for blocked in ("jax", "jaxlib", "repro"):
        sys.modules[blocked] = None
    sys.argv = ["dryrun"] + sys.argv[1:]
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
    loaded = sorted(k for k in sys.modules if sys.modules[k] is not None
                    and k.split(".")[0] in ("jax", "jaxlib", "repro"))
    print("LOADED " + json.dumps(loaded))
    """)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --arch yi-9b --shape
    decode_32k --both-meshes`` (full size) in a process where importing
    ``jax`` or ``repro`` fails: (the modules it loaded of those, the
    records' directory)."""
    out = tmp_path_factory.mktemp("dryrun")
    argv = ["--arch", "yi-9b", "--shape", "decode_32k", "--both-meshes",
            "--out-dir", str(out)]
    r = subprocess.run([sys.executable, "-c", _NO_JAX_CLI, *argv],
                       capture_output=True, text=True, env=_env(), cwd=ROOT,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.split("LOADED ", 1)[1]), out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_dryrun_cli_runs_without_jax(cli, mesh):
    """The CLI's record on 256 or 512 fake ranks, with nothing of JAX or
    the JAX package loaded: status ok, nonzero dot flops and
    all-gathers."""
    loaded, out = cli
    assert loaded == []
    rec = json.loads((out / mesh / "yi-9b__decode_32k.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == (512 if mesh == "2x16x16" else 256)
    assert rec["dot_flops"] > 0
    assert rec["collectives"]["all-gather"]["count"] > 0
