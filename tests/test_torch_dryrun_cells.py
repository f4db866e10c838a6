"""The built train steps on the production mesh, at full widths and cut
depth: one dry-run cell for each way a sharded train step used to fail.

Each cell runs ``python -m repro_torch.launch.dryrun`` (the step that
``build_train_step`` builds, traced over ``meta`` DTensors on a ``fake``
group of 256 ranks, the 16 x 16 ("data", "model") mesh) in its own
process with its own time limit; the processes start together and each
test waits for its own. A cell passes when its record says ``ok`` with
nonzero dot flops and at least one collective.

  * yi-9b (4 KV heads on the 16-way model axis) and qwen2-vl-7b (28
    heads): the backward of the head split and of the head merge, whose
    gradients DTensor shards over more parts than there are heads
    (``sharding.splittable_grad`` in ``layers.proj_heads`` and
    ``layers.merge_heads``);
  * jamba-v0.1-52b at 8 layers (its first attention layer, 8 KV heads on
    16, and the selective scan) and xlstm-125m at 6 (five mLSTM layers and
    the sLSTM): the recurrences' states, which the plain versions write in
    place, given as copies under grad (``local_calls.call``), and the
    sLSTM's log-sigmoid as ``-softplus(-x)``, whose backward DTensor
    propagates;
  * deepseek-v3 at one MLA + MoE layer and the MTP block: its 8-bit
    moments, blocked by 128 over a last dim that FSDP splits 16 ways
    (7168 / 16 = 448), gathered before the blocking
    (``optimizer.quantize8`` / ``dequantize8``).

Every cell also folds (B, S) with the sequence split under sequence
parallelism ahead of each product, which torch 2.11's DTensor refuses
(``sharding.foldable`` at the blocks' inputs).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# (arch, overrides, seconds allowed)
CELLS = {
    "yi-9b": (("num_layers=1",), 240),
    "qwen2-vl-7b": (("num_layers=1",), 240),
    "jamba-v0.1-52b": (("num_layers=8",), 420),
    "xlstm-125m": (("num_layers=6",), 420),
    "deepseek-v3-671b": (("prefix_pattern=()", "num_layers=1"), 300),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every cell's process, started together: {arch: (process, its
    record's path, its deadline on ``time.monotonic``)}."""
    out = tmp_path_factory.mktemp("cells")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    start = time.monotonic()
    for arch, (overrides, limit) in CELLS.items():
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", "train_4k",
                "--out-dir", str(out / arch)]
        for ov in overrides:
            argv += ["--override", ov]
        procs[arch] = (subprocess.Popen(argv, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True,
                                        env=env, cwd=ROOT),
                       out / arch / "16x16" / f"{arch}__train_4k.json",
                       start + limit)
    yield procs
    for proc, _, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("arch", list(CELLS))
def test_train_cell_builds_on_the_production_mesh(runs, arch):
    proc, path, deadline = runs[arch]
    _, err = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
    assert proc.returncode == 0, err[-3000:]
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok", (rec.get("error"),
                                   rec.get("traceback", "")[-3000:])
    assert (rec["mesh"], rec["n_devices"]) == ("16x16", 256)
    assert rec["dot_flops"] > 0
    assert sum(c["count"] for c in rec["collectives"].values()) > 0
