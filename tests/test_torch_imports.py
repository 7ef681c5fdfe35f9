"""The port stands alone: importing repro_torch and every submodule loads
neither jax nor any module of the reference package.

The check runs in a fresh subprocess: test workers share a process across
test files, so this process's ``sys.modules`` already holds the other
files' jax.  A source scan backs it up for imports a module makes only
inside a function."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_CHILD = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""


def test_import_loads_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad, names = (res.stdout.splitlines() + ["", ""])[:3]
    assert int(n) >= 65                      # every submodule was imported
    assert {"repro_torch.dist", "repro_torch.dist.api",
            "repro_torch.dist.placement", "repro_torch.dist.sharding",
            "repro_torch.launch.mesh",
            "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.compress",
            "repro_torch.train", "repro_torch.train.loop",
            "repro_torch.train.checkpoint", "repro_torch.train.watchdog",
            "repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.launch", "repro_torch.launch.train",
            "repro_torch.launch.serve",
            "repro_torch.core", "repro_torch.core.emulator",
            "repro_torch.analysis", "repro_torch.analysis.common",
            "repro_torch.analysis.lint", "repro_torch.analysis.ledger",
            "repro_torch.analysis.registry", "repro_torch.analysis.retrace",
            "repro_torch.analysis.sharding", "repro_torch.launch.analyze",
            "repro_torch.launch.specs", "repro_torch.launch.dryrun",
            "repro_torch.launch.opcost"} \
        <= set(names.split(","))
    assert bad == "", f"importing repro_torch loaded {bad}"


_ANALYZE_CHILD = r"""
import sys
from repro_torch.launch import analyze
rc = analyze.main(["--lint", "--ledger", "--sharding", "--configs",
                   "qwen3_4b"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
print("RC", rc)
print("BAD", ",".join(bad))
"""


def test_analysis_suite_runs_without_jax_or_the_reference():
    """repro_torch.analysis and repro_torch.launch.analyze, run (their
    passes import lazily), load no jax and no reference module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _ANALYZE_CHILD],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "RC 0" in lines, res.stdout
    assert "BAD " in lines, res.stdout


_DRYRUN_CHILD = r"""
import sys
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.dist.api import RecordingMesh
from repro_torch.models.config import ShapeConfig
counts = dryrun.predict_counts(configs.get_smoke("qwen3_4b"), (2, 1),
                               batch=1, prompt=8, steps=1, max_len=16)
dryrun.accum_for = lambda cfg, shape: 1
mesh = RecordingMesh((2, 2), ("data", "model"))
_, cost, _ = dryrun.run_train(configs.get_smoke("mamba2_1_3b"),
                              ShapeConfig("train_4k", 16, 16, "train"), mesh)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
print("SEQ", counts["seq_max"][0], cost.ops > 0 and "grad_heads" in mesh.counts)
print("BAD", ",".join(bad))
"""


def test_lowering_report_runs_without_jax_or_the_reference():
    """repro_torch.launch.dryrun and opcost, run on fake tensors and a
    recording mesh, load no jax and no reference module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _DRYRUN_CHILD],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "SEQ 2 True" in lines, res.stdout     # 2 layers, 1 decode step
    assert "BAD " in lines, res.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def test_sources_never_import_jax_or_the_reference():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("*_torch.py"))
             + [ROOT / "launch" / "serve_torch.py"])
    assert len(files) >= 16
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []
