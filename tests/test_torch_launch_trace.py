"""The trace-replay CLI and the three examples on the CPU.

``launch/serve_torch.py --out`` writes a report EQUAL to the reference
CLI's (``launch/serve.py``) ``--out`` report on the same flags: no field
of it is a wall time, and with no EOS it does not depend on the weights,
so the reference runs jitted on its own draw.  The traces run 12 ticks.
The three examples each run to their end on ``--device cpu`` in a
subprocess with a timeout, on one thread, so that it does not contend
with the test workers' threads.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "cli_" + path.stem, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--trace", "spike", "--ticks", "12"],
    ["--trace", "poisson", "--prefix-cache", "--repetition", "0.6",
     "--ticks", "12"],
], ids=["spike", "poisson_prefix_cache"])
def test_trace_replay_report_equals_reference(tmp_path, argv):
    jout, tout = tmp_path / "ref.json", tmp_path / "port.json"
    assert _load("launch/serve.py").main(argv + ["--out", str(jout)]) == 0
    rep = _load("launch/serve_torch.py").main(
        argv + ["--out", str(tout), "--device", "cpu"])
    want = json.loads(jout.read_text())
    assert json.loads(tout.read_text()) == want
    assert rep["unserved"] == 0 and rep["completed"] == want["requests"]
    assert ("prefix_cache" in want) == ("--prefix-cache" in argv)


@pytest.mark.parametrize("name", ["quickstart", "bitfluid_serving",
                                  "mixed_precision_resnet18"])
def test_example_runs_on_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=180, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip()


def test_entry_points_default_to_cuda():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("launch/serve_torch.py").main(["--ticks", "2"])
    for name in ("quickstart", "bitfluid_serving",
                 "mixed_precision_resnet18"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(f"examples/{name}_torch.py").main([])
