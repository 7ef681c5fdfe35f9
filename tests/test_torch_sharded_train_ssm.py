"""mamba2_1_3b SMOKE trained on gloo meshes: two CPU ranks on ``(1, 2)``
and ``(2, 1)`` against one process, against the reference's jitted
sharded step and across checkpoints (``tests/torch_mesh_train.py`` holds
the body and states the tolerances), and the training CLI on a
tensor-parallel mesh.

On ``(1, 2)`` each model rank runs the SSD on its half of the heads and
indexes the replicated ``A_log``, ``dt_bias`` and ``D`` by them, so
their gradients SUM over the model axis (``grad_heads``).
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_train as mt  # noqa: E402

mt.install(globals(), "ssm")


def test_launcher_trains_on_a_tensor_parallel_mesh(tmp_path):
    """``python -m repro_torch.launch.train --arch mamba2_1_3b --smoke --tp
    2 --ranks 2`` spawns two ranks on a (1, 2) mesh, and its loss falls."""
    env = dict(os.environ, PYTHONPATH=os.path.join(mt.ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2_1_3b", "--smoke", "--tp", "2", "--ranks", "2", "--device",
         "cpu", "--steps", "6", "--batch", "4", "--seq", "32",
         "--log-every", "1", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, cwd=mt.ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "[train] mesh {'data': 1, 'model': 2}" in lines
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines
              if ln.startswith("[train] step=")]
    last = json.loads(lines[-1])
    assert len(losses) == 6 and last["mesh"] == {"data": 1, "model": 2}
    assert last["final_loss"] < losses[0] - 0.5, losses
