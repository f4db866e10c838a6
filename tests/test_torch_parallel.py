"""The port's sharding specs against the JAX package's, on the CPU.

``param_pspecs``, ``cache_pspecs`` (``decode_32k``, model axis 16) and
``opt_state_pspecs`` (with and without 8-bit moments) for all ten
``ARCH_IDS`` under four rule sets, from full-size shapes (``jax.
eval_shape`` there, ``meta`` tensors here); ``named_safe`` on the 16 x 16
and 2 x 16 x 16 production meshes for every parameter, optimizer-state
and cache leaf, the JAX side on 512 forced host devices and the port
side on the ``fake`` process-group backend, both in one subprocess per
mesh. The port's layers are a list where the JAX package stacks each
period's blocks under ``"scan"``: a stacked JAX leaf's spec is the
port's with a leading ``None`` (the layer axis), for every period.
Specs are compared entry for entry (exact).
"""
import functools
import json
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
from repro.models import kvcache as jkv
from repro.models.transformer import init_params as jax_init_params
from repro.parallel import sharding as jsh
from repro.training import optimizer as jopt
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import steps
from repro_torch.models import kvcache
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.sharding import P
from repro_torch.training import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
RULES = {
    "train": dict(data_axes=("data",)),
    "train_fsdp_sp": dict(data_axes=("data",), fsdp=True,
                          sequence_parallel=True),
    "serve": dict(data_axes=("data",), serve=True),
    "serve_multipod": dict(data_axes=("pod", "data"), serve=True),
}
DECODE = SHAPES["decode_32k"]


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jax_flat(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [("/".join(_key(k) for k in path), leaf) for path, leaf in flat]


def _unstack(cfg, flat):
    """{port path: spec} from the JAX package's flat (path, spec) list:
    ``prefix/i`` layers kept as ``layers/i``, ``scan/b<j>`` layers
    unstacked to every period (the leading layer axis dropped, which
    must be ``None``)."""
    n_pre, period = len(cfg.prefix_pattern), len(cfg.period_pattern)
    out = {}
    for path, spec in flat:
        parts = path.split("/")
        spec = tuple(spec)
        if parts[0] == "prefix":
            out["/".join(["layers"] + parts[1:])] = spec
        elif parts[0] == "scan":
            assert spec[0] is None, (path, spec)
            j = int(parts[1][1:])
            for p in range(cfg.n_periods):
                i = n_pre + p * period + j
                out["/".join(["layers", str(i)] + parts[2:])] = spec[1:]
        else:
            out[path] = spec
    return out


def _cache_unstack(cfg, flat):
    """The cache's flat JAX specs keyed by the port's ``layer/name``."""
    got = _unstack(cfg, flat)
    return {k[len("layers/"):]: v for k, v in got.items()}


def _port_spec_flat(tree):
    """(path, spec) of a tree whose leaves are PartitionSpecs (tuples)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, P) or node is None:
            if node is not None:
                out[prefix[:-1]] = tuple(node)
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k in node._fields:
                walk(getattr(node, k), f"{prefix}{k}/")
        else:
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
    walk(tree, "")
    return out


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    cfg = jconfigs.get_config(arch)
    ps = jax.eval_shape(lambda k: jax_init_params(cfg, k),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    return cfg, ps


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    cfg = configs.get_config(arch)
    return cfg, steps.param_shapes(cfg)


def _jax_opt_flat(cfg, ostate, ospecs):
    """{field/port path: spec} of a JAX AdamWState spec tree."""
    out = {"count": tuple(ospecs.count)}
    for field in ("m", "v", "m_scale", "v_scale"):
        sub = getattr(ospecs, field)
        if sub is None:
            continue
        flat = _jax_flat(sub, is_leaf=lambda s: isinstance(s, jsh.P))
        for k, v in _unstack(cfg, flat).items():
            out[f"{field}/{k}"] = v
    return out


@pytest.mark.parametrize("rules_name", sorted(RULES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_specs_match_jax(arch, rules_name):
    """param_pspecs, cache_pspecs and opt_state_pspecs (8-bit moments
    on and off) equal the JAX package's entry for entry."""
    jcfg, jps = _jax_shapes(arch)
    tcfg, tps = _port_shapes(arch)
    jrules = jsh.make_rules(**RULES[rules_name])
    trules = tsh.make_rules(**RULES[rules_name])
    assert dict(trules) == dict(jrules)

    jp = jsh.param_pspecs(jps, jrules)
    tp = tsh.param_pspecs(tps, trules)
    want = _unstack(jcfg, _jax_flat(jp, is_leaf=lambda s: isinstance(
        s, jsh.P)))
    got = _port_spec_flat(tp)
    assert got == want

    jc = jkv.cache_specs(jcfg, DECODE.global_batch, steps.cache_len(DECODE))
    tc = kvcache.cache_specs(tcfg, DECODE.global_batch,
                             steps.cache_len(DECODE))
    want = _cache_unstack(jcfg, _jax_flat(
        jkv.cache_pspecs(jc, jrules, 16),
        is_leaf=lambda s: isinstance(s, jsh.P)))
    assert _port_spec_flat(kvcache.cache_pspecs(tc, trules, 16)) == want
    assert all(t.device.type == "meta" for e in tc for t in e.values())
    assert kvcache.cache_bytes(tc) == jkv.cache_bytes(jc)

    for eight in (False, True):
        jstate = jax.eval_shape(jopt.make_adamw(jopt.OptimizerConfig(
            eight_bit_moments=eight))[0], jps)
        tstate = topt.make_adamw(topt.OptimizerConfig(
            eight_bit_moments=eight))[0](tps)
        want = _jax_opt_flat(jcfg, jstate,
                             jopt.opt_state_pspecs(jstate, jp))
        assert _port_spec_flat(topt.opt_state_pspecs(tstate, tp)) == want


def test_constrain_is_a_no_op_without_rules_or_mesh():
    """As in the JAX package: no rules, no effect; rules without a mesh
    leave a plain tensor as it is."""
    x = torch.randn(4, 8)
    assert tsh.constrain(x, "batch", None) is x
    with tsh.sharding_rules(tsh.make_rules()):
        assert tsh.constrain(x, "batch", None) is x


def test_safe_spec_takes_the_longest_dividing_suffix():
    """The divisibility fallback on the JAX package's own examples: 3 KV
    heads replicate on a 16-way axis; 16 experts fall back from ("data",
    "model") to "model", freeing "data" for the expert FFN dim."""
    sizes = {"data": 16, "model": 16}
    assert tsh.safe_spec(P("data", None, "model", None), (128, 9, 3, 64),
                         sizes) == P("data", None, None, None)
    assert tsh.safe_spec(P(("data", "model"), None, "data"),
                         (16, 7168, 2048), sizes) == P("model", None, "data")
    assert tsh.safe_spec(P(("data", "model"), None), (256, 4), sizes) \
        == P(("data", "model"), None)
    assert tsh.safe_spec(P("data"), (3, 5), {"data": 1}) == P(None, None)


def _named_safe_script(multi_pod: bool) -> str:
    return textwrap.dedent(f"""
        import json, sys
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as JP
        from repro import configs as jconfigs
        from repro.launch import steps as jsteps
        from repro.launch.mesh import make_production_mesh as jmesh
        from repro.models import kvcache as jkv
        from repro.models.transformer import init_params
        from repro.parallel.sharding import param_pspecs
        from repro.training.optimizer import (OptimizerConfig, make_adamw,
                                              opt_state_pspecs)
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch import configs
        from repro_torch.configs.shapes import SHAPES
        from repro_torch.launch import steps
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import kvcache
        from repro_torch.parallel import sharding as tsh
        from repro_torch.training import optimizer as topt

        def key(k):
            for a in ("key", "idx", "name"):
                if hasattr(k, a):
                    return str(getattr(k, a))
            return str(k)

        def jflat(tree):
            flat, _ = jax.tree_util.tree_flatten_with_path(tree)
            return [["/".join(key(k) for k in p), list(s.spec)]
                    for p, s in flat]

        def tflat(tree, prefix=""):
            out = []
            if tree is None:
                return out
            if isinstance(tree, tsh.NamedSharding):
                return [[prefix[:-1], list(tree.spec)]]
            if isinstance(tree, dict):
                for k in sorted(tree):
                    out += tflat(tree[k], f"{{prefix}}{{k}}/")
            elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
                for k in tree._fields:
                    out += tflat(getattr(tree, k), f"{{prefix}}{{k}}/")
            else:
                for i, v in enumerate(tree):
                    out += tflat(v, f"{{prefix}}{{i}}/")
            return out

        multi = {multi_pod}
        jm = jmesh(multi_pod=multi)
        n = 512 if multi else 256
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        tm = make_production_mesh(multi_pod=multi, device_type="cpu")
        dec = SHAPES["decode_32k"]
        out = {{}}
        for arch in jconfigs.ARCH_IDS:
            jc, tc = jconfigs.get_config(arch), configs.get_config(arch)
            jps = jax.eval_shape(lambda k: init_params(jc, k),
                                 jax.ShapeDtypeStruct((2,), jnp.uint32))
            tps = steps.param_shapes(tc)
            rec = {{}}
            for serve in (False, True):
                jr = jsteps.rules_for(jc, jm, serve=serve)
                tr = steps.rules_for(tc, tm, serve=serve)
                jp, tp = param_pspecs(jps, jr), tsh.param_pspecs(tps, tr)
                rec[f"params_{{serve}}"] = [
                    jflat(jsteps.named_safe(jm, jp, jps)),
                    tflat(steps.named_safe(tm, tp, tps))]
            eight = jc.opt_8bit_moments
            jst = jax.eval_shape(make_adamw(OptimizerConfig(
                eight_bit_moments=eight))[0], jps)
            tst = topt.make_adamw(topt.OptimizerConfig(
                eight_bit_moments=eight))[0](tps)
            rec["opt"] = [jflat(jsteps.named_safe(
                              jm, opt_state_pspecs(jst, jp), jst)),
                          tflat(steps.named_safe(
                              tm, topt.opt_state_pspecs(tst, tp), tst))]
            L = jsteps.cache_len(dec)
            jcs = jkv.cache_specs(jc, dec.global_batch, L)
            tcs = kvcache.cache_specs(tc, dec.global_batch, L)
            jr = jsteps.rules_for(jc, jm, serve=True)
            tr = steps.rules_for(tc, tm, serve=True)
            rec["cache"] = [
                jflat(jsteps.named_safe(jm, jkv.cache_pspecs(jcs, jr, 16),
                                        jcs)),
                tflat(steps.named_safe(tm, kvcache.cache_pspecs(tcs, tr, 16),
                                       tcs))]
            out[arch] = rec
        print("RESULT" + json.dumps(out))
        """)


def _as_spec(entry):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entry)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_named_safe_matches_jax_on_the_production_meshes(multi_pod):
    """named_safe of every parameter (train and serve rules), optimizer
    state and decode_32k cache leaf of all ten archs on the production
    mesh: the JAX package's on 512 forced host devices, the port's on a
    fake process group of 256 or 512 ranks; specs entry for entry, the
    JAX package's stacked layer axis unstacked as above."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run([sys.executable, "-c", _named_safe_script(multi_pod)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.split("RESULT", 1)[1])
    assert sorted(res) == sorted(jconfigs.ARCH_IDS)
    for arch, rec in res.items():
        jcfg = jconfigs.get_config(arch)
        for what, (jside, tside) in rec.items():
            flat = [(p, _as_spec(s)) for p, s in jside]
            if what == "opt":
                want = {"count": dict(flat)["count"]}
                for field in ("m", "v", "m_scale", "v_scale"):
                    sub = [(p[len(field) + 1:], s) for p, s in flat
                           if p.startswith(field + "/")]
                    if sub:
                        want.update({f"{field}/{k}": v for k, v in
                                     _unstack(jcfg, sub).items()})
            elif what == "cache":
                want = _cache_unstack(jcfg, flat)
            else:
                want = _unstack(jcfg, flat)
            got = {p: _as_spec(s) for p, s in tside}
            assert got == want, (arch, what)


_NO_JAX = """
import json, sys
for blocked in ("jax", "jaxlib", "repro"):
    sys.modules[blocked] = None
import torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import mesh as tmesh, steps
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import init_params
from repro_torch.parallel import collectives, local_calls, pipeline, sharding
dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                        rank=0, world_size=1)
try:
    tmesh.make_production_mesh(device_type="cpu")
    refused = False
except ValueError:
    refused = True
mesh = tmesh.make_worker_mesh(1, device_type="cpu")
cfg = configs.reduced_config("yi-9b")
step, args, specs = steps.build_serve_step(cfg, mesh,
                                           ShapeConfig("p", "prefill", 16, 2))
p = init_params(cfg, 0, "cpu")
T = steps.cache_len(ShapeConfig("p", "prefill", 16, 2))
toks = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32)
batch = {"inputs": toks}
logits, _ = step(
    sharding.distribute(p, steps.named_safe(mesh, specs["params"], args[0])),
    sharding.distribute(init_cache(cfg, 2, T, "cpu"),
                        steps.named_safe(mesh, specs["cache"], args[1])),
    sharding.distribute(batch, steps.named_safe(mesh, specs["batch"], batch)))
want = steps.serve_prefill(p, cfg, init_cache(cfg, 2, T, "cpu"), toks)[0]
loaded = sorted(k for k in sys.modules if sys.modules[k] is not None
                and k.split(".")[0] in ("jax", "jaxlib", "repro"))
dist.destroy_process_group()
print("RESULT " + json.dumps({
    "refused": refused, "mesh": list(mesh.mesh.shape),
    "equal": torch.equal(sharding.full(logits), want), "loaded": loaded}))
"""


def test_distribution_runs_without_jax(tmp_path):
    """The distribution modules in a subprocess in which importing
    ``jax`` or ``repro`` fails, as on the machine with the card: a
    one-rank gloo group, the worker mesh (1, 1); the production mesh
    refuses a group of another size; a built prefill step gives
    ``serve_prefill``'s logits bit for bit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _NO_JAX,
                        str(tmp_path / "rdv")], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.split("RESULT ", 1)[1])
    assert res == {"refused": True, "mesh": [1, 1], "equal": True,
                   "loaded": []}
