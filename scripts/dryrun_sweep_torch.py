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

Usage:
  PYTHONPATH=src python scripts/dryrun_sweep_torch.py --all --both-meshes \
      --jobs 4 --timeout 1800 --out-dir experiments/dryrun_torch/sweep
  # chosen cells: ARCH/SHAPE[/MESH[/k=v,k=v]] (MESH 16x16 or 2x16x16)
  PYTHONPATH=src python scripts/dryrun_sweep_torch.py \
      --cell yi-9b/train_4k/16x16/num_layers=1 --out-dir /tmp/dr
  PYTHONPATH=src python scripts/dryrun_sweep_torch.py --combine \
      A/summary.json B/summary.json
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


def port_frame(tb: str) -> str:
    """The last frame of the traceback inside the port's package."""
    frames = [ln.strip() for ln in tb.splitlines()
              if ln.strip().startswith("File ") and "repro_torch" in ln]
    return frames[-1] if frames else ""


def summarise(recs, out_dir: pathlib.Path) -> None:
    from repro_torch.analysis import roofline
    import torch
    rows = ["| arch | shape | mesh | overrides | status | build s | "
            "trace s | wall s | dot flops / device | dominant |",
            "|---|---|---|---|---|---|---|---|---|---|"]
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
            f"{r['process_wall_s']} | {flops} | {r['dominant'] or '-'} |")
        line = (f"[{r['status']:7s}] {r['mesh']:8s} {r['arch']} {r['shape']} "
                f"{','.join(r['overrides'])} build {r.get('build_s')} trace "
                f"{r.get('trace_s')} wall {r['process_wall_s']} dot_flops "
                f"{r.get('dot_flops')} dominant {r['dominant']}")
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
    change): each collective's count and operand bytes, and the dot
    flops, in run A and run B."""
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
                         f" -> {y.get('operand_bytes', 0):.6e} B)")
        lines.append(f"{' '.join(key)}: dot_flops {ca['dot_flops']:.6e} -> "
                     f"{c2['dot_flops']:.6e}; " + "; ".join(parts))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--combine", nargs="+", metavar="SUMMARY_JSON",
                    help="print one table of these runs' summaries, run "
                         "nothing")
    ap.add_argument("--compare", nargs=2, metavar="SUMMARY_JSON",
                    help="print run A's and run B's collectives and dot "
                         "flops per cell, run nothing")
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
