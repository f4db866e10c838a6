"""The dry run of the port, one process per cell.

Runs ``python -m repro_torch.launch.dryrun`` once for each (arch, shape,
mesh) cell in its own process, several at a time, each under its own
time limit, so that one slow cell does not stop the rest; then prints
one line per cell (status, build and trace seconds, per-device dot
flops, the dominant roofline term, the error and its last port frame)
and writes ``summary.json``, ``summary.md`` (the table) and
``roofline_<mesh>.md`` (``analysis.roofline.to_markdown`` of the ok
cells) under ``--out-dir``. A cell cut by its time limit is recorded as
``timeout`` with its wall, never as ok. ``--combine`` prints one table
of several runs' ``summary.json`` (two torch versions, say);
``--compare`` prints two runs' collectives and dot flops cell by cell.
``--reference`` compiles the JAX package's step for each ok cell of a
run's ``summary.json`` (``repro.launch.dryrun.run_cell``, one process a
cell, with ``jax.make_mesh`` wrapped to ``Auto`` axes, on which the
JAX package's ``constrain`` runs under jax 0.9) and prints port ÷
reference dot flops, both all-gathers' result bytes, both collectives'
result bytes of all kinds and both temp bytes (the port's peak live
bytes, ``analysis.count.Live``, beside XLA's ``temp_size_in_bytes``);
it needs JAX and the JAX package, and only its child processes import
them.

Usage:
  PYTHONPATH=src python scripts/dryrun_sweep_torch.py --all --both-meshes \
      --jobs 4 --timeout 1800 --out-dir experiments/dryrun_torch/sweep
  # chosen cells: ARCH/SHAPE[/MESH[/k=v,k=v]] (MESH 16x16 or 2x16x16)
  PYTHONPATH=src python scripts/dryrun_sweep_torch.py \
      --cell yi-9b/train_4k/16x16/num_layers=1 --out-dir /tmp/dr
  PYTHONPATH=src python scripts/dryrun_sweep_torch.py --combine \
      A/summary.json B/summary.json
  PYTHONPATH=src python scripts/dryrun_sweep_torch.py --reference \
      A/summary.json --jobs 3 --out-dir A/reference
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MESHES = ("16x16", "2x16x16")


def parse_cell(text: str):
    parts = text.split("/")
    arch, shape = parts[0], parts[1]
    mesh = parts[2] if len(parts) > 2 and parts[2] else "16x16"
    over = [kv for kv in parts[3].split(",") if kv] if len(parts) > 3 else []
    if mesh not in MESHES:
        raise SystemExit(f"mesh {mesh!r} is not one of {MESHES}")
    return arch, shape, mesh, tuple(over)


def record_path(out_dir: pathlib.Path, cell) -> pathlib.Path:
    arch, shape, mesh, over = cell
    tag = ("__" + "_".join(o.replace("=", "") for o in over)) if over else ""
    return out_dir / mesh / f"{arch}__{shape}{tag}.json"


def run_one(cell, out_dir: pathlib.Path, timeout: float) -> dict:
    arch, shape, mesh, over = cell
    path = record_path(out_dir, cell)
    tag = path.name[len(f"{arch}__{shape}"):-len(".json")]
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out-dir", str(out_dir), "--tag", tag]
    if mesh == "2x16x16":
        cmd.append("--multi-pod")
    for o in over:
        cmd += ["--override", o]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=timeout)
        rc = r.returncode
    except subprocess.TimeoutExpired:
        rc = None
    wall = round(time.time() - t0, 2)
    if rc is None:
        rec = {"status": "timeout"}
    elif path.exists():
        rec = json.loads(path.read_text())
    else:
        rec = {"status": "error", "error": f"exit {rc}: "
               + (r.stderr or "")[-1500:]}
    rec.update(arch=arch, shape=shape, mesh=mesh, overrides=list(over),
               process_wall_s=wall)
    return rec


# the JAX package's dry run of one cell: argv arch, shape, multi-pod
# (0/1), overrides as JSON [k=v, ...], record path
REFERENCE = """
import ast, json, sys, time
import jax
from jax.sharding import AxisType
_make_mesh = jax.make_mesh


def make_mesh(shape, axes, *args, **kwargs):
    kwargs.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *args, **kwargs)


jax.make_mesh = make_mesh
from repro.launch.dryrun import run_cell
arch, shape, multi_pod, over, out = sys.argv[1:]
overrides = {}
for kv in json.loads(over):
    k, v = kv.split("=", 1)
    try:
        overrides[k] = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        overrides[k] = v
t0 = time.time()
rec = run_cell(arch, shape, multi_pod == "1", overrides or None)
rec["wall_s"] = round(time.time() - t0, 2)
open(out, "w").write(json.dumps(rec))
"""


def run_reference(cell, out_dir: pathlib.Path, timeout: float) -> dict:
    """The JAX package's record of one cell (``REFERENCE`` in its own
    process), or {"status": "error"} with the process's stderr."""
    arch, shape, mesh, over = cell
    path = record_path(out_dir, cell)
    path.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    try:
        r = subprocess.run(
            [sys.executable, "-c", REFERENCE, arch, shape,
             "1" if mesh == "2x16x16" else "0", json.dumps(list(over)),
             str(path)], capture_output=True, text=True, env=env, cwd=ROOT,
            timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"status": "timeout"}
    if r.returncode or not path.exists():
        return {"status": "error", "error": r.stderr[-1500:]}
    return json.loads(path.read_text())


def against_reference(summary, out_dir: pathlib.Path, jobs: int,
                      timeout: float) -> str:
    """One line per ok cell of a run's ``summary.json``: its dot flops
    and all-gather result bytes, the reference's, and port ÷ reference;
    the reference's records land under ``out_dir``."""
    run = json.loads(pathlib.Path(summary).read_text())
    cells = [c for c in run["cells"] if c["status"] == "ok"]
    with cf.ThreadPoolExecutor(max_workers=jobs) as pool:
        refs = list(pool.map(lambda c: run_reference(
            (c["arch"], c["shape"], c["mesh"], tuple(c["overrides"])),
            out_dir, timeout), cells))

    def gathered(rec):
        return rec["collectives"].get("all-gather", {}).get(
            "result_bytes", 0.0)

    def moved(rec):
        return sum(c.get("result_bytes", 0.0)
                   for c in rec["collectives"].values())
    lines = [f"torch {run['torch']} against the JAX package"]
    for c, r in zip(cells, refs):
        key = f"{c['mesh']} {c['arch']} {c['shape']} " \
              f"{','.join(c['overrides'])}".rstrip()
        if r.get("status") != "ok":
            lines.append(f"{key}: reference {r.get('status')} "
                         f"{r.get('error', '')[-300:]}")
            continue
        lines.append(
            f"{key}: dot flops port {c['dot_flops']:.6e} reference "
            f"{r['hlo_dot_flops']:.6e} port/reference "
            f"{c['dot_flops'] / r['hlo_dot_flops']:.4f}; all-gather result "
            f"bytes port {gathered(c):.6e} reference {gathered(r):.6e}; "
            f"collective result bytes (all kinds) port {moved(c):.6e} "
            f"reference {moved(r):.6e} port/reference "
            f"{moved(c) / max(moved(r), 1.0):.4f}; "
            f"temp bytes port {c.get('temp_size_in_bytes')} reference "
            f"{r.get('temp_size_in_bytes')}; port largest allocation "
            f"{largest(c)}")
    return "\n".join(lines)


def largest(rec) -> str:
    """A record's largest allocation as bytes, shape, dtype and op."""
    a = rec.get("largest_allocation")
    return "-" if not a else \
        f"{a['bytes']} B {tuple(a['shape'])} {a['dtype']} {a['op']}"


def port_frame(tb: str) -> str:
    """The last frame of the traceback inside the port's package."""
    frames = [ln.strip() for ln in tb.splitlines()
              if ln.strip().startswith("File ") and "repro_torch" in ln]
    return frames[-1] if frames else ""


def summarise(recs, out_dir: pathlib.Path) -> None:
    from repro_torch.analysis import roofline
    import torch
    rows = ["| arch | shape | mesh | overrides | status | build s | "
            "trace s | wall s | dot flops / device | dominant | temp B | "
            "largest allocation |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    ok = {m: [] for m in MESHES}
    for r in recs:
        a = roofline.analyze(r) if r["status"] == "ok" else None
        if a:
            ok[r["mesh"]].append(a)
        r["dominant"] = a["dominant"] if a else None
        flops = f"{r['dot_flops']:.6e}" if "dot_flops" in r else "-"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{','.join(r['overrides']) or '-'} | {r['status']} | "
            f"{r.get('build_s', '-')} | {r.get('trace_s', '-')} | "
            f"{r['process_wall_s']} | {flops} | {r['dominant'] or '-'} | "
            f"{r.get('temp_size_in_bytes', '-')} | {largest(r)} |")
        line = (f"[{r['status']:7s}] {r['mesh']:8s} {r['arch']} {r['shape']} "
                f"{','.join(r['overrides'])} build {r.get('build_s')} trace "
                f"{r.get('trace_s')} wall {r['process_wall_s']} dot_flops "
                f"{r.get('dot_flops')} dominant {r['dominant']} temp "
                f"{r.get('temp_size_in_bytes')} largest {largest(r)}")
        if r["status"] not in ("ok", "skipped"):
            line += (f"\n    {r.get('error', '')[:600]}\n    "
                     f"{port_frame(r.get('traceback', ''))}")
        print(line, flush=True)
    head = f"torch {torch.__version__}"
    (out_dir / "summary.md").write_text(head + "\n\n" + "\n".join(rows)
                                        + "\n")
    (out_dir / "summary.json").write_text(json.dumps(
        {"torch": torch.__version__, "cells": recs}, indent=1))
    for mesh, rows_ok in ok.items():
        if rows_ok:
            rows_ok.sort(key=lambda a: (a["arch"], a["shape"]))
            (out_dir / f"roofline_{mesh}.md").write_text(
                roofline.to_markdown(rows_ok) + "\n")
    counts = {}
    for r in recs:
        counts[r["status"]] = counts.get(r["status"], 0) + 1
    print(f"SWEEP torch {torch.__version__} {json.dumps(counts)}",
          flush=True)


def combine(paths) -> str:
    """One markdown row per (arch, shape) from several runs'
    ``summary.json`` (runs of one torch version merged): for each mesh
    and torch version the status and build / trace seconds, then the
    first version's per-device dot flops and dominant roofline term on
    each mesh."""
    by_ver = {}
    for p in paths:
        run = json.loads(pathlib.Path(p).read_text())
        by_ver.setdefault(run["torch"], {}).update(
            {(c["arch"], c["shape"], c["mesh"]): c for c in run["cells"]})
    vers, cells = list(by_ver), list(by_ver.values())
    keys = sorted({(a, s) for c in cells for a, s, _ in c})
    head = ["arch", "shape"]
    for mesh in MESHES:
        head += [f"{mesh} torch {v}: status, build/trace s" for v in vers]
    head += [f"{mesh} dot flops / device, dominant ({vers[0]})"
             for mesh in MESHES]
    rows = ["| " + " | ".join(head) + " |",
            "|" + "---|" * len(head)]
    for arch, shape in keys:
        row = [arch, shape]
        for mesh in MESHES:
            for c in cells:
                r = c.get((arch, shape, mesh))
                row.append("-" if r is None else
                           f"{r['status']} {r.get('build_s', '-')}/"
                           f"{r.get('trace_s', '-')}"
                           if r["status"] != "skipped" else "skipped")
        for mesh in MESHES:
            r = cells[0].get((arch, shape, mesh))
            row.append(f"{r['dot_flops']:.4e}, {r['dominant']}"
                       if r and "dot_flops" in r else "-")
        rows.append("| " + " | ".join(row) + " |")
    return "\n".join(rows)


def compare(path_a, path_b) -> str:
    """Per cell ok in both runs' ``summary.json`` (say, parent and
    change): each collective's count, operand and result bytes, the dot
    flops, the temp bytes and the largest allocation, in run A and run
    B."""
    a, b = (json.loads(pathlib.Path(p).read_text()) for p in (path_a, path_b))
    cb = {(c["arch"], c["shape"], c["mesh"]): c for c in b["cells"]}
    lines = []
    for ca in a["cells"]:
        key = (ca["arch"], ca["shape"], ca["mesh"])
        c2 = cb.get(key)
        if ca["status"] != "ok" or not c2 or c2["status"] != "ok":
            continue
        kinds = sorted(set(ca["collectives"]) | set(c2["collectives"]))
        parts = []
        for k in kinds:
            x, y = (c["collectives"].get(k, {}) for c in (ca, c2))
            parts.append(f"{k} {int(x.get('count', 0))} -> "
                         f"{int(y.get('count', 0))} ({x.get('operand_bytes', 0):.6e}"
                         f" -> {y.get('operand_bytes', 0):.6e} B; result "
                         f"{x.get('result_bytes', 0):.6e} -> "
                         f"{y.get('result_bytes', 0):.6e} B)")
        lines.append(f"{' '.join(key)}: dot_flops {ca['dot_flops']:.6e} -> "
                     f"{c2['dot_flops']:.6e}; " + "; ".join(parts)
                     + f"; temp {ca.get('temp_size_in_bytes')} -> "
                     f"{c2.get('temp_size_in_bytes')}; largest "
                     f"{largest(ca)} -> {largest(c2)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--combine", nargs="+", metavar="SUMMARY_JSON",
                    help="print one table of these runs' summaries, run "
                         "nothing")
    ap.add_argument("--compare", nargs=2, metavar="SUMMARY_JSON",
                    help="print run A's and run B's collectives and dot "
                         "flops per cell, run nothing")
    ap.add_argument("--reference", metavar="SUMMARY_JSON",
                    help="compile the JAX package's step for this run's "
                         "ok cells and print port / reference, run no "
                         "port cell")
    ap.add_argument("--cell", action="append", default=[],
                    help="ARCH/SHAPE[/MESH[/k=v,k=v]]")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape (full configs)")
    ap.add_argument("--arch", action="append", default=[],
                    help="with --all: only these archs")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds for each cell's process")
    ap.add_argument("--out-dir")
    args = ap.parse_args(argv)
    if args.combine or args.compare:
        print(combine(args.combine) if args.combine
              else compare(*args.compare))
        return 0
    if not args.out_dir:
        ap.error("--out-dir is required to run cells")
    if args.reference:
        print(against_reference(args.reference, pathlib.Path(args.out_dir),
                                args.jobs, args.timeout))
        return 0

    from repro_torch.configs import ARCH_IDS, SHAPES
    cells = [parse_cell(c) for c in args.cell]
    if args.all:
        meshes = MESHES if args.both_meshes else \
            (MESHES[1] if args.multi_pod else MESHES[0],)
        for mesh in meshes:
            for arch in args.arch or ARCH_IDS:
                for shape in SHAPES:
                    cells.append((arch, shape, mesh, ()))
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with cf.ThreadPoolExecutor(max_workers=args.jobs) as pool:
        recs = list(pool.map(lambda c: run_one(c, out_dir, args.timeout),
                             cells))
    summarise(recs, out_dir)
    return 0 if all(r["status"] in ("ok", "skipped") for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
