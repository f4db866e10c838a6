"""Dry run of the built steps (port of ``repro/launch/dryrun.py``): for
every (arch × shape × mesh) cell, the step that ``build_train_step`` or
``build_serve_step`` builds on the production mesh is traced once under
``analysis.count.Count`` and its per-device work recorded for §Dry-run /
§Roofline (``analysis/roofline.py``), with rank 0's peak live bytes and
largest allocation beside it (``analysis.count.Live``).

The JAX package lowers and compiles each cell on 512 placeholder host
devices. The port runs each cell in one process on a ``fake`` process
group (``torch.testing``'s ``FakeStore``: every collective returns at
once) of 256 ranks, or 512 with ``--multi-pod``, over the production
mesh with ``device_type="cpu"``. The step's arguments are ``meta``
DTensors laid out by ``named_safe``: rank 0's shards are ``meta``
tensors of their local shapes, so the step runs every op at full size
and computes nothing, and no kernel is launched (each kernel call takes
its ``meta`` branch in ``kernels/ops.py``). Nothing here touches CUDA.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
Results land in experiments/dryrun_torch/<mesh>/<arch>__<shape>.json.
Each record's ``counted_by`` says how each of its fields was counted,
and its ``remat`` the config's recomputation policy
(``repro_torch/remat.py``): a train cell's counts include what the
backward recomputes (the periods' forward under ``cfg.remat``, the
plain attention's query chunks and the recurrences' step chunks), as
XLA's count of the JAX package's step does, and its peak what the
checkpoints keep.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import pathlib
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.count import Count, Live, tensor_bytes
from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (build_serve_step, build_train_step,
                                      named_safe)
from repro_torch.tree import leaves, map_tree

OUT_ROOT = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"

COUNTED_BY = {
    "dot_flops": "analysis/count.py: 2·M·N·K of every matrix product rank "
                 "0 runs on its shards, each kernel call by ops.WORK; every "
                 "layer and microbatch counted as eager PyTorch unrolls "
                 "them (no loop weighting)",
    "traffic_bytes": "analysis/count.py: 2 x the bytes written by "
                     "real-work ops on rank 0 (products, copies, cat, "
                     "gathers, scatters, reductions, sorts, collectives, "
                     "kernel calls); views and elementwise ops not counted "
                     "(a fusion-optimistic lower bound)",
    "collectives": "analysis/count.py: rank 0's collectives of DTensor's "
                   "redistributions, operand bytes its input's; on this "
                   "CPU mesh a Shard-to-Shard redistribution runs as an "
                   "all-gather and a chunk (gloo has no all-to-all), where "
                   "NCCL runs an all-to-all of the same operand",
    "argument_size_in_bytes": "rank 0's local shard bytes of every step "
                              "argument (params, opt state or cache, "
                              "batch, decode's cache index), laid out by "
                              "named_safe",
    "output_size_in_bytes": "rank 0's local shard bytes of the step's "
                            "outputs",
    "temp_size_in_bytes": "analysis/count.py Live: rank 0's peak live "
                          "local bytes of the storages the step makes "
                          "(each counted once, from its op until its "
                          "storage is freed; tensors saved for the "
                          "backward live until the backward frees them), "
                          "the arguments not included and the outputs "
                          "included; XLA's temp excludes both, and a "
                          "compiled step reuses buffers that eager "
                          "PyTorch allocates anew",
    "largest_allocation": "analysis/count.py Live: rank 0's single "
                          "largest storage made in the step: its bytes, "
                          "the shape and dtype of the output that made "
                          "it, and its op",
}


class MetaCache(TorchDispatchMode):
    """Outputs of functional ops on ``meta`` tensors made from the
    metadata of an earlier call with the same inputs, instead of through
    torch's Python meta kernels (about 0.3 ms an elementwise op: the
    recurrences' step loops run hundreds of thousands). An op qualifies
    when every tensor argument is a plain ``meta`` tensor, it writes no
    argument, no output aliases one, and its other arguments hash: its
    output depends then only on the arguments' shapes, strides and
    dtypes, which with the op and the other arguments key the cache
    (aten ops only: a collective's output must be the one its wait
    finds; an output off ``meta`` is not kept).
    Entered outside ``Count`` and ``Live`` (first), so both see every op
    and the fresh storage each output gets."""

    def __init__(self):
        super().__init__()
        self._outs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = self._key(func, types, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        meta = self._outs.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            if all(o.device.type == "meta" for o in _as_list(out)):
                self._outs[key] = (isinstance(out, tuple),
                                   [(o.shape, o.stride(), o.dtype)
                                    for o in _as_list(out)])
            return out
        many, outs = meta
        made = [torch.empty_strided(shape, stride, dtype=dtype,
                                    device="meta")
                for shape, stride, dtype in outs]
        return tuple(made) if many else made[0]

    @staticmethod
    def _key(func, types, args, kwargs):
        if func.namespace != "aten" or types:    # a subclass among them
            return None
        schema = func._schema
        if schema.is_mutable or any(r.alias_info is not None
                                    for r in schema.returns) or not all(
                str(r.type) == "Tensor" for r in schema.returns):
            return None
        parts, tensors = [func], 0
        for a in (*args, *sorted(kwargs.items())):
            for x in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(x, torch.Tensor):
                    if x.device.type != "meta":
                        return None
                    parts.append((tuple(x.shape), x.stride(), x.dtype))
                    tensors += 1
                else:
                    parts.append(x)
        if not tensors:
            return None
        try:
            hash(tuple(parts))
        except TypeError:
            return None
        return tuple(parts)


def _as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


def fake_group(world_size: int) -> None:
    """The default process group as a ``fake`` one of ``world_size``
    ranks, this process rank 0 (a group of another size or backend is
    destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" \
                and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def laid_out(tree, shardings):
    """``meta`` DTensors of ``tree``'s (``meta``) shapes laid out by the
    matching ``NamedSharding``s: each an empty ``meta`` shard of rank 0's
    local shape."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(t, sh):
        local, _ = compute_local_shape_and_global_offset(
            t.shape, sh.mesh, sh.placements)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), sh.mesh,
            sh.placements, run_check=False, shape=t.shape, stride=t.stride())
    return map_tree(one, tree, shardings)


def local_bytes(tree) -> int:
    """Rank 0's bytes of every tensor in ``tree`` (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor
    return sum(tensor_bytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in leaves(tree))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides=None) -> dict:
    """One cell's record: the config's fields replaced by
    ``overrides``, the step built and traced once."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, mesh.mesh.shape)),
           "axes": list(mesh.mesh_dim_names),
           "n_devices": int(mesh.size()), "remat": cfg.remat,
           "status": "skipped", "overrides": {k: str(v) for k, v in
                                              (overrides or {}).items()}}
    if not applicable(cfg, shape):
        rec["reason"] = ("long_500k skipped: pure full-attention arch "
                         "(see DESIGN.md §4)")
        return rec

    t0 = time.time()
    if shape.kind == "train":
        step, trees, specs = build_train_step(cfg, mesh)
        names, extra = ("params", "opt", "batch"), ()
    else:
        step, trees, specs = build_serve_step(cfg, mesh, shape)
        names, extra = ("params", "cache", "batch"), tuple(trees[3:])
    args = [laid_out(t, named_safe(mesh, specs[n], t))
            for t, n in zip(trees, names)] + list(extra)
    rec["build_s"] = round(time.time() - t0, 2)
    t1 = time.time()
    with MetaCache(), Count() as c, Live() as live:
        out = step(*args)
    rec["trace_s"] = round(time.time() - t1, 2)
    rec["argument_size_in_bytes"] = local_bytes(args)
    rec["output_size_in_bytes"] = local_bytes(out)
    rec["temp_size_in_bytes"] = live.peak
    rec["largest_allocation"] = live.largest
    rec.update(c.result())          # collectives, dot_flops, traffic_bytes
    rec["counted_by"] = COUNTED_BY
    rec["status"] = "ok"
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override key=value (python literal)")
    ap.add_argument("--out-dir", default=str(OUT_ROOT),
                    help="records go to <out-dir>/<mesh>/")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    cells = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    import torch.distributed as dist
    try:
        for arch, shape_name, mp in cells:
            mesh_tag = "2x16x16" if mp else "16x16"
            out_dir = pathlib.Path(args.out_dir) / mesh_tag
            out_dir.mkdir(parents=True, exist_ok=True)
            out = out_dir / f"{arch}__{shape_name}{args.tag}.json"
            t0 = time.time()
            try:
                rec = run_cell(arch, shape_name, mp, overrides or None)
            except Exception as e:  # noqa: BLE001 — record the failure
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
            rec["wall_s"] = round(time.time() - t0, 2)
            out.write_text(json.dumps(rec, indent=1))
            print(f"[{rec['status']:7s}] {mesh_tag} {arch} {shape_name} "
                  f"({rec['wall_s']}s)", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
