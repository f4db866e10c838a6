"""The dry run's memory record (``analysis.count.Live``) and what it
pins: a sharded train step's largest allocation on a rank.

* A known graph on plain CPU tensors, forward and backward, counted by
  hand: a view, an in-place op and an ``out=`` write add nothing, a
  tensor autograd saves for the backward stays live after its Python
  name is gone and until the backward releases it, and the arguments
  (made before the mode) are not counted.
* ``Live`` entered beside ``Count`` changes neither's result.
* yi-9b's and smollm-135m's ``train_4k`` cells at one layer on the
  16 x 16 ``fake`` group (``python -m repro_torch.launch.dryrun``, each
  in its own process, started together; ~10 s each): the largest
  allocation on rank 0 is under 1/16 of the global microbatch's float32
  logits, which a vocabulary gather for the label pick, or a lookup of
  the whole microbatch's tokens, would allocate whole (62.5 GiB and
  192 GiB), and ``temp_size_in_bytes`` is a number.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.count import Count, Live

ROOT = Path(__file__).resolve().parents[1]
F32 = 4


def test_live_counts_a_known_graph():
    x = torch.randn(1000, requires_grad=True)   # an argument: not counted
    with Live() as m:
        a = x * 2                               # +4000
        a.add_(1)                               # in place: +0
        v = a.view(10, 100)                     # a view: +0
        b = torch.exp(v)                        # +4000, saved by exp
        assert m.live == 8000
        del a, v                                # nothing saved a
        assert m.live == 4000
        c = b.sum()                             # +4
        del b                                   # held for exp's backward
        assert m.live == 4004
        g, = torch.autograd.grad(c, x)
        # the backward: the seed ones (+4), exp's grad * b (+4000), b
        # released (-4000), mul's grad * 2 (+4000) = g, exp's grad and
        # the seed released: c and g are left, the peak 8008 at exp's
        # backward (c, b, the seed, its grad) and again at mul's
        assert m.live == 4004 and m.peak == 8008
        out = torch.empty(1000)                 # +4000
        torch.mul(g, 3, out=out)                # out=: +0
        h = torch.cat([g, g, g]).view(3, 1000)  # +12000
        assert m.live == 20004
    assert m.peak == 20004
    assert m.largest == {"bytes": 12000, "shape": [3000],
                         "dtype": "float32", "op": "aten.cat"}
    del h
    assert m.live == 8004


def test_live_beside_count_changes_neither():
    def fn(w, x):
        y = torch.tanh(x @ w)
        return (y * y).sum(), y.t() @ x

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(16, 8, generator=gen)
    x = torch.randn(4, 16, generator=gen)
    with Count() as alone:
        fn(w, x)
    with Live() as live_alone:
        fn(w, x)
    with Count() as c, Live() as m:
        fn(w, x)
    assert c.result() == alone.result()
    assert m.result() == live_alone.result()
    # nothing needs grad, so nothing is saved: x @ w (4, 8) is freed
    # once tanh has made y, y * y once the sum is made; the peak holds y,
    # the sum and y.t() @ x (8, 16)
    assert m.peak == F32 * (4 * 8 + 1 + 8 * 16)
    assert m.largest["shape"] == [8, 16] and m.largest["op"] == "aten.mm"


# ---------------------------------------------------------------------------
# The pin: the cut train cells on the production mesh
# ---------------------------------------------------------------------------
PIN_CELLS = ("yi-9b", "smollm-135m")
PIN_LIMIT = 240          # seconds a cell may take (~10 s alone)


@pytest.fixture(scope="module")
def pin_runs(tmp_path_factory):
    """Both cells' processes, started together: {arch: (process, its
    record's path)}."""
    out = tmp_path_factory.mktemp("pin")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for arch in PIN_CELLS:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", "train_4k",
                "--override", "num_layers=1", "--out-dir", str(out / arch)]
        procs[arch] = (subprocess.Popen(argv, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True,
                                        env=env, cwd=ROOT),
                       out / arch / "16x16" / f"{arch}__train_4k.json")
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("arch", PIN_CELLS)
def test_train_cell_holds_only_its_own_logits(pin_runs, arch):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import MICROBATCHES
    proc, path = pin_runs[arch]
    _, err = proc.communicate(timeout=PIN_LIMIT)
    assert proc.returncode == 0, err[-4000:]
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    cfg, shape = get_config(arch), SHAPES["train_4k"]
    rows = shape.global_batch // MICROBATCHES.get(arch, 1)
    logits = rows * shape.seq_len * cfg.vocab_size * F32
    assert isinstance(rec["temp_size_in_bytes"], int)
    assert 0 < rec["temp_size_in_bytes"]
    largest = rec["largest_allocation"]
    assert 0 < largest["bytes"] < logits / 16, largest
