"""The port's entry points against the JAX package's, on the CPU:
``python -m repro_torch.launch.serve`` (the serving CLI),
``examples/quickstart_torch.py``, ``examples/trace_replay_torch.py`` and
``scripts/smoke_models_torch.py``.

The serving CLI runs the simulator over the port's exact copies of the
serving stack, so with the same arguments its JSON report equals
``repro.launch.serve``'s key for key and value for value, save the
solver's measured wall time (``mean_milp_ms``, a clock reading). The
scripts run in subprocesses in which importing ``jax`` or ``repro``
fails, as on the machine with the card.
"""
import ast
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import serve as jserve
from repro.models.transformer import count_params as jax_count_params
from repro import configs as jconfigs
from repro_torch.kernels.impls import TORCH_KERNEL_IMPLS, resolve_kernel_impl
from repro_torch.launch import serve as tserve
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
# measured on the host's clock: the one key whose value differs run to run
CLOCK_KEYS = {"mean_milp_ms"}
ARG_SETS = {
    "default": [],
    "auto-cascade": ["--auto-cascade"],
    "scaler-predictive": ["--scaler", "predictive"],
    "stage-graph-micro": ["--stage-graph", "micro"],
    "queue-depth-overload": ["--admission", "queue-depth",
                             "--load-scale", "16"],
    "worker-classes-cost": ["--worker-classes", "a100:4:1.0,a10g:12:0.45",
                            "--cost-per-class", "a100=4.10,a10g=1.21"],
}


def _jax_main(argv):
    """The reference CLI in process: (stdout, exit code)."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["serve.py", *argv]
    try:
        with contextlib.redirect_stdout(out):
            jserve.main()
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = saved
    return out.getvalue(), code


def _torch_main(argv):
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            tserve.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return out.getvalue(), code


def _same_report(got: dict, want: dict):
    assert list(got) == list(want)
    for key, val in want.items():
        if key in CLOCK_KEYS:
            assert isinstance(got[key], float) and got[key] > 0
            continue
        assert got[key] == val, key


@pytest.mark.parametrize("name", list(ARG_SETS))
def test_serve_cli_report_matches_jax(name):
    argv = ["--duration", "45", *ARG_SETS[name]]
    jout, jcode = _jax_main(argv)
    tout, tcode = _torch_main(argv)
    assert jcode == tcode == 0
    want, got = json.loads(jout), json.loads(tout)
    _same_report(got, want)
    assert got["completed"] + got["dropped"] + got["shed_admission"] \
        == got["total_queries"]


@pytest.mark.parametrize("flag", ["--list-cascades", "--list-controllers",
                                  "--list-frontier"])
def test_serve_cli_lists_match_jax(flag):
    jout, _ = _jax_main([flag])
    tout, _ = _torch_main([flag])
    assert tout == jout and len(tout.splitlines()) > 2


@pytest.mark.parametrize("argv", [
    ["--static-qps", "-1"], ["--load-scale", "-2"],
    ["--admission", "token-bucket"], ["--ecn-shed-mult", "0.5"],
    ["--admission-burst", "0"], ["--cost-per-class", "a100=1"],
    ["--cascade", "no-such-cascade"], ["--forecast-horizon", "-1"],
    ["--warm-pool", "-1"], ["--stage-denoise-steps", "0"],
    ["--stage-preempt-frac", "1.5"], ["--batch-buckets", "1,x"],
])
def test_serve_cli_errors_match_jax(argv, capsys):
    """The reference's ``ap.error`` messages, word for word (the usage
    line above them lists the port's ``--kernel-impl`` choices)."""
    _jax_main(argv)
    want = capsys.readouterr().err.strip().splitlines()[-1]
    _, code = _torch_main(argv)
    got = capsys.readouterr().err.strip().splitlines()[-1]
    # the program name before "error:" is argparse's, from sys.argv
    assert code == 2 and "error:" in got
    assert got.split("error:", 1)[1] == want.split("error:", 1)[1]


def test_serve_cli_threads_kernel_impl_to_the_torch_registry(monkeypatch):
    """``--kernel-impl`` offers ``TORCH_KERNEL_IMPLS`` (and ``auto``),
    each choice resolves, and the chosen one reaches the serving config
    the controller runs under (the repo linter indexes only the first
    ``--kernel-impl`` flag under ``src/``, the JAX package's)."""
    tree = ast.parse((SRC / "repro_torch/launch/serve.py").read_text())
    flag = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"
            and n.args and getattr(n.args[0], "value", "") == "--kernel-impl"]
    assert len(flag) == 1
    assert sorted(set(tserve.KERNEL_IMPL_CHOICES)) == sorted(
        set(TORCH_KERNEL_IMPLS) | {"auto"})
    assert {resolve_kernel_impl(c) for c in tserve.KERNEL_IMPL_CHOICES} \
        == set(TORCH_KERNEL_IMPLS)
    seen = []
    real = tserve.run_controller

    def spy(name, trace, serving, **kw):
        seen.append(serving.kernel_impl)
        return real(name, trace, serving, **kw)
    monkeypatch.setattr(tserve, "run_controller", spy)
    for choice in tserve.KERNEL_IMPL_CHOICES:
        _torch_main(["--duration", "10", "--kernel-impl", choice])
    assert seen == tserve.KERNEL_IMPL_CHOICES
    _, code = _torch_main(["--kernel-impl", "pallas"])
    assert code == 2


# ---------------------------------------------------------------------------
# the scripts, in subprocesses that cannot import jax or repro
# ---------------------------------------------------------------------------
_RUNNER = """
import json, runpy, sys
for blocked in ("jax", "jaxlib", "repro"):
    sys.modules[blocked] = None
path, argv = sys.argv[1], sys.argv[2:]
if path.startswith("-m"):
    import importlib
    mod = importlib.import_module(path[2:])
    out = mod.main(argv)
else:
    mod = runpy.run_path(path, run_name="entry")
    out = mod["main"](argv) if "main" in mod else None
loaded = sorted(k for k in sys.modules if sys.modules[k] is not None
                and k.split(".")[0] in ("jax", "jaxlib", "repro"))
print("RESULT " + json.dumps({"out": out, "loaded": loaded}, default=str))
"""


def _run(target, *args, runner=True):
    cmd = [sys.executable, "-c", _RUNNER, target, *args] if runner else \
        [sys.executable, target, *args]
    res = subprocess.run(
        cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "2",
             "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _result(stdout):
    line = [x for x in stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_serve_cli_runs_without_jax():
    stdout = _run("-mrepro_torch.launch.serve", "--duration", "30")
    res = _result(stdout)
    assert res["loaded"] == []
    want = json.loads(_jax_main(["--duration", "30"])[0])
    _same_report(res["out"], want)


def test_trace_replay_prints_what_the_reference_prints():
    mine = _run(str(REPO / "examples/trace_replay_torch.py"))
    ref = _run(str(REPO / "examples/trace_replay.py"), runner=False)
    assert mine.split("RESULT ")[0] == ref
    assert _result(mine)["loaded"] == []
    assert "restored run completed" in ref


def test_quickstart_runs_on_the_cpu():
    res = _result(_run(str(REPO / "examples/quickstart_torch.py"),
                       "--device", "cpu"))
    out = res["out"]
    assert res["loaded"] == []
    assert out["outputs_shape"] == [8, 16, 16, 3]
    assert len(out["confidences"]) == 8 and 0 <= out["deferred"] <= 8
    assert all(0.0 <= c <= 1.0 for c in out["confidences"])
    assert sum(out["workers"]) <= 16 and len(out["thresholds"]) == 1


def test_smoke_models_runs_every_arch_and_counts_as_jax():
    res = _result(_run(str(REPO / "scripts/smoke_models_torch.py"),
                       "--device", "cpu"))
    assert res["loaded"] == []
    assert list(res["out"]) == jconfigs.ARCH_IDS
    for arch, n in res["out"].items():
        full = jconfigs.get_config(arch)
        assert n == {"params": jax_count_params(full),
                     "active": jax_count_params(full, active_only=True)}


@pytest.mark.parametrize("path", ["examples/quickstart_torch.py",
                                  "scripts/smoke_models_torch.py"])
def test_script_entry_points_default_to_cuda(path, monkeypatch):
    import runpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = runpy.run_path(str(REPO / path), run_name="entry")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod["main"]([])
