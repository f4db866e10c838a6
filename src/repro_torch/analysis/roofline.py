"""§Roofline report: three-term roofline per (arch × shape × mesh) from the
dry-run records (``launch/dryrun.py``), at the peaks of one NVIDIA H100
SXM5 (NVIDIA's data sheet, dense, at its 700 W limit):

  compute    = dot_flops / 989 TFLOP/s (bf16 tensor cores)
  memory     = traffic_bytes / 3.35 TB/s (HBM3)
  collective = collective operand bytes / 50 GB/s

all per device (``analysis/count.py`` counts rank 0's local work, every
layer and microbatch as eager PyTorch unrolls them). The collective rate
is one 400 Gb/s NDR InfiniBand port a GPU, as in a DGX H100: a 16-way
axis of the production meshes spans two 8-GPU nodes, so its collectives
cross the network. Inside a node NVLink gives 450 GB/s a direction.

MODEL_FLOPS convention: train = 6·N·tokens (N = active, non-embedding
params; fwd 2N + bwd 4N); prefill = 2·N·tokens; decode = 2·N·batch
(+ attention cache reads are memory, not MODEL_FLOPS).

Usage: PYTHONPATH=src python -m repro_torch.analysis.roofline [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import List, Optional, Union

from repro_torch.config.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig

PEAK_FLOPS = 989e12          # bf16 dense / H100 SXM5
HBM_BW = 3.35e12             # B/s / H100 SXM5 (HBM3)
NET_BW = 50e9                # B/s / GPU: one 400 Gb/s NDR port (inside
                             # an 8-GPU node, NVLink: 450 GB/s a direction)

ROOT = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"


def model_flops(arch: Union[str, ModelConfig],
                shape: Union[str, ShapeConfig]) -> float:
    """6·N·tokens (train), 2·N·tokens (prefill) or 2·N·batch (decode);
    ``arch`` and ``shape`` by name or as configs."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.transformer import count_params
    cfg = get_config(arch) if isinstance(arch, str) else arch
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    n = count_params(cfg, active_only=True, include_embedding=False)
    if sh.kind == "train":
        return 6.0 * n * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * n * sh.global_batch * sh.seq_len
    return 2.0 * n * sh.global_batch          # decode: one token / sequence


def terms(dot_flops: float, traffic_bytes: float,
          collective_bytes: float = 0.0) -> dict:
    """The three roofline terms (s) of one device's work at the peaks,
    and the dominant one."""
    t = {"compute": dot_flops / PEAK_FLOPS,
         "memory": traffic_bytes / HBM_BW,
         "collective": collective_bytes / NET_BW}
    return {**{f"{k}_s": v for k, v in t.items()},
            "dominant": max(t, key=t.get)}


def load_records(mesh: str) -> List[dict]:
    out = []
    for f in sorted((ROOT / mesh).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("overrides"):
            continue                    # perf-iteration cells, not baselines
        out.append(rec)
    return out


def analyze(rec: dict) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    chips = rec.get("n_devices", 256)
    fl_dev = rec.get("dot_flops", 0.0)
    tb_dev = rec.get("traffic_bytes", 0.0)
    coll_dev = sum(v.get("operand_bytes", 0.0)
                   for v in rec.get("collectives", {}).values())
    t = terms(fl_dev, tb_dev, coll_dev)
    mf = model_flops(rec["arch"], rec["shape"])
    global_flops = fl_dev * chips
    ratio = mf / global_flops if global_flops else float("nan")
    bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
    # roofline fraction: useful-FLOPs time / bound time
    useful_s = (mf / chips) / PEAK_FLOPS
    frac = useful_s / bound if bound else float("nan")
    return {"arch": rec["arch"], "shape": rec["shape"],
            "mesh": rec.get("mesh"), "chips": chips, **t,
            "model_flops": mf, "flops_global": global_flops,
            "useful_ratio": ratio, "roofline_frac": frac,
            "temp_gib": (rec.get("temp_size_in_bytes") or 0) / 2**30,
            "arg_gib": (rec.get("argument_size_in_bytes") or 0) / 2**30}


NOTES = {
    "compute": "compute-bound: raise tensor-core utilization (larger "
               "per-GPU tiles, less recompute)",
    "memory": "memory-bound: fuse fp32 intermediates / the flash kernel "
              "removes score materialization",
    "collective": "collective-bound: overlap collectives with compute, "
                  "shrink gathered weights (FSDP prefetch), keep the "
                  "model axis inside an NVLink node, or compress",
}


def to_markdown(rows: List[dict]) -> str:
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | MODEL/counted | roofline frac | temp GiB | "
             "args GiB |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']:.3f} | {r['temp_gib']:.1f} | "
            f"{r['arg_gib']:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = [a for a in (analyze(r) for r in load_records(args.mesh)) if a]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    md = to_markdown(rows)
    print(md)
    out = ROOT / f"roofline_{args.mesh}.md"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(md + "\n")
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(rows, indent=1))
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
