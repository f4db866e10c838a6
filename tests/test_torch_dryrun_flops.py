"""The port's per-device dot flops against the JAX package's on the
production mesh, at full widths and cut depth (one layer).

For each cell one process runs the port's dry run (``python -m
repro_torch.launch.dryrun``: the built step traced over ``meta``
DTensors on a ``fake`` group of 256 ranks, 16 x 16 ("data", "model"))
and another compiles the JAX package's step (``repro.launch.dryrun.
run_cell`` on 512 forced host devices), all started together; each test
waits for its own pair. Under jax 0.9 ``jax.make_mesh`` makes
``Explicit`` axes, on which the reference's ``constrain`` raises, so the
reference's process wraps ``jax.make_mesh`` to ``Auto`` axes before it
imports ``repro.launch.dryrun`` (nothing in the JAX package changes).

The serving cells are those where the port used to compute attention
whole on every model rank: Yi-9B (32 heads over 4 KV heads, which the
16-way model axis does not divide) at decode over its sequence-sharded
cache and at prefill, and Qwen2-VL-7B (28 heads) at prefill. The port
must count 0.9-1.15 x the reference's dot flops (its parent read 6.31,
6.52 and 4.04 at one layer; 8.96, 9.48 and 6.29 at full depth).

The train cell, Yi-9B's ``train_4k`` under its config's ``remat``
(``dots_nb``), pins the recomputation (``repro_torch/remat.py``): rank
0's peak live bytes (``temp_size_in_bytes``) at most ``TRAIN_TEMP``,
1.8e9 B. Measured under torch 2.13.0+cpu: 1,626,001,460 B with the
periods, the attention's query chunks and the recurrences' step chunks
under checkpoint, 3,098,701,876 B without them (the reference's XLA
temp: 3,406,724,264 B). Its dot flops are 0.991 x the reference's
(11.931 / 12.034 TFLOP; 0.957 x without recomputation): the backward
recomputes the forward's batched products, as XLA's count does.
About 10 s of wall (30 s of CPU) on an 8-core CPU.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("yi-9b", "decode_32k"), ("yi-9b", "prefill_32k"),
         ("qwen2-vl-7b", "prefill_32k"), ("yi-9b", "train_4k"))
LAYERS = 1
TRAIN_TEMP = 1.8e9
LIMIT_S = 240
RATIO = (0.9, 1.15)

REFERENCE = """
import json, sys
import jax
from jax.sharding import AxisType
_make_mesh = jax.make_mesh


def make_mesh(shape, axes, *args, **kwargs):
    kwargs.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, *args, **kwargs)


jax.make_mesh = make_mesh
from repro.launch.dryrun import run_cell
arch, shape, layers, out = sys.argv[1:]
rec = run_cell(arch, shape, False, {"num_layers": int(layers)})
open(out, "w").write(json.dumps(rec))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{cell: (port process, its record, reference process, its record)},
    all started together, and the deadline on ``time.monotonic``."""
    out = tmp_path_factory.mktemp("flops")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = {}
    for arch, shape in CELLS:
        port = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--override", f"num_layers={LAYERS}",
             "--out-dir", str(out / "port")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
        ref_rec = out / f"ref_{arch}__{shape}.json"
        ref = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, arch, shape, str(LAYERS),
             str(ref_rec)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
        procs[arch, shape] = (port, out / "port" / "16x16" /
                              f"{arch}__{shape}.json", ref, ref_rec)
    yield procs, time.monotonic() + LIMIT_S
    for port, _, ref, _ in procs.values():
        for p in (port, ref):
            if p.poll() is None:
                p.kill()
                p.communicate()


def _record(proc, path, deadline):
    _, err = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
    assert proc.returncode == 0, err[-3000:]
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok", (rec.get("error"),
                                   rec.get("traceback", "")[-3000:])
    return rec


@pytest.mark.parametrize("arch,shape", CELLS)
def test_port_counts_the_reference_dot_flops(runs, arch, shape):
    procs, deadline = runs
    port, port_rec, ref, ref_rec = procs[arch, shape]
    got = _record(port, port_rec, deadline)
    want = _record(ref, ref_rec, deadline)
    assert (got["mesh"], got["n_devices"]) == ("16x16", 256)
    assert want["mesh"] == "16x16"
    ratio = got["dot_flops"] / want["hlo_dot_flops"]
    assert RATIO[0] <= ratio <= RATIO[1], (got["dot_flops"],
                                           want["hlo_dot_flops"], ratio)


def test_train_cell_keeps_what_remat_saves(runs):
    """Yi-9B's train step at one layer under ``remat="dots_nb"``: rank
    0's peak under ``TRAIN_TEMP`` (the module note)."""
    procs, deadline = runs
    port, port_rec, _, _ = procs["yi-9b", "train_4k"]
    got = _record(port, port_rec, deadline)
    assert 0 < got["temp_size_in_bytes"] <= TRAIN_TEMP, \
        got["temp_size_in_bytes"]
    assert got["remat"] == "dots_nb"
