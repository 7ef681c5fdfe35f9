"""The training substrate around the step, on the CPU: the data pipeline
against the reference's bytes, the prefetch iterator, ``host_slice``,
the straggler watchdog, the launcher end to end (a checkpoint, then a
resumed run; two gloo ranks killed, then resumed on another mesh), and
serving parameters that require grad (the engines'
entry points run under ``torch.no_grad()``: the same tokens and logits,
no graph)."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import policy as pol  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import cnn, lm  # noqa: E402
from repro_torch.serve.cnn import CNNServeEngine  # noqa: E402
from repro_torch.serve.engine import ServeEngine, default_controller  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train.watchdog import StragglerWatchdog  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", ["qwen3_4b", "internvl2_1b",
                                  "seamless_m4t_medium"])
def test_make_batch_bytes_equal_reference(arch):
    """tokens int32, and the vlm prefix / encdec frames in bf16, byte for
    byte: the same numpy draws, f64 -> bf16 through ``Tensor.to``."""
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    for seed, step, B, S in ((0, 0, 4, 33), (7, 42, 3, 129)):
        want = jpipe.make_batch(seed, step, B, S, jcfg.vocab_size, jcfg)
        got = tpipe.make_batch(seed, step, B, S, tcfg.vocab_size, tcfg)
        assert got.keys() == want.keys()
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k]
            assert g.device.type == "cpu" and tuple(g.shape) == w.shape
            if k == "tokens":
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    g.view(torch.int16).numpy(), w.view(np.int16))
    assert set(tpipe.make_batch(0, 0, 2, 9, 100)) == {"tokens"}


def test_make_batch_pure_and_prefetch_iterator():
    b1 = tpipe.make_batch(7, 42, 4, 64, 1000)
    assert torch.equal(b1["tokens"], tpipe.make_batch(7, 42, 4, 64,
                                                      1000)["tokens"])
    assert not torch.equal(b1["tokens"],
                           tpipe.make_batch(7, 43, 4, 64, 1000)["tokens"])
    it = tpipe.SyntheticLM(seed=1, batch=2, seq_len=16, vocab=100,
                           start_step=5, device="cpu")
    try:
        (s1, b1), (s2, b2) = next(it), next(it)
        assert (s1, s2) == (5, 6) and it.step == 7
        assert torch.equal(b1["tokens"],
                           tpipe.make_batch(1, 5, 2, 16, 100)["tokens"])
        assert torch.equal(b2["tokens"],
                           tpipe.make_batch(1, 6, 2, 16, 100)["tokens"])
    finally:
        it.close()
    assert not it._thread.is_alive()


class _Mesh:
    """A duck-typed ("data", "model") mesh: its shape, and the data index
    of global rank ``rank`` (row-major, as ``dist.Mesh`` orders ranks)."""

    def __init__(self, data, model, rank):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")
        self.dp_index = rank // model


def test_host_slice_and_shard_batch():
    """Rows go by the data index: the model ranks of one data index take
    the same rows, every row when the data ranks do not divide them."""
    assert tpipe.host_slice(8) == slice(0, 8)          # no mesh: every row
    assert tpipe.host_slice(8, _Mesh(2, 1, 1)) == slice(4, 8)
    assert tpipe.host_slice(9, _Mesh(3, 1, 2)) == slice(6, 9)
    for rank in (0, 1):                                 # (1, 2): all rows
        assert tpipe.host_slice(8, _Mesh(1, 2, rank)) == slice(0, 8)
    assert [tpipe.host_slice(8, _Mesh(2, 2, r)) for r in range(4)] == [
        slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]
    assert tpipe.host_slice(5, _Mesh(2, 1, 1)) == slice(0, 5)
    b = tpipe.make_batch(0, 0, 4, 9, 50)
    assert torch.equal(tpipe.shard_batch(b, "cpu")["tokens"], b["tokens"])
    half = tpipe.shard_batch(b, "cpu", _Mesh(2, 1, 1))
    assert torch.equal(half["tokens"], b["tokens"][2:])
    for rank in (0, 1):
        both = tpipe.shard_batch(b, "cpu", _Mesh(1, 2, rank))
        assert torch.equal(both["tokens"], b["tokens"])


def test_watchdog_flags_straggler():
    """The reference's test, on the copy."""
    events = []
    wd = StragglerWatchdog(z_threshold=2.0, warmup=3,
                           on_straggler=lambda s, dt: events.append(s))
    for step in range(12):
        wd.start()
        if step == 10:
            time.sleep(0.05)
        wd.stop(step)
    assert any(e["step"] == 10 for e in wd.events)
    assert events == [10]
    with pytest.raises(RuntimeError, match="start"):
        wd.stop(12)


def _cmd(ckpt, steps, *extra):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3_4b", "--smoke", "--device", "cpu", "--steps", str(steps),
            "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
            "--log-every", "1", *extra]


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _launch(ckpt, steps, *extra):
    res = subprocess.run(_cmd(ckpt, steps, *extra), capture_output=True,
                         text=True, env=_env(), timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    return res.stdout.splitlines()


def test_launcher_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = _launch(ckpt, 3)
    first = json.loads(out[-1])
    assert first["steps"] == 3 and first["start"] == 0
    assert first["device"] == "cpu" and np.isfinite(first["final_loss"])
    assert tckpt.latest_step(ckpt) == 3
    assert os.path.exists(os.path.join(ckpt, "step_00000003", "arrays.npz"))
    out = _launch(ckpt, 2)
    assert "[train] resumed from step 3" in out
    assert any(line.startswith("[train] step=3 ") for line in out)
    second = json.loads(out[-1])
    assert second["start"] == 3 and tckpt.latest_step(ckpt) == 5


def test_launcher_trains_on_two_ranks_killed_and_resumed(tmp_path):
    """``--tp 2`` spawns two gloo ranks on a (1, 2) mesh; the run is killed
    (the whole process group) once it has checkpointed, and a second run
    resumes from the latest checkpoint on a (2, 1) mesh (``--ranks 2``),
    the state resharded onto it."""
    ckpt = str(tmp_path / "ckpt")
    run = subprocess.Popen(_cmd(ckpt, 1000, "--tp", "2", "--ckpt-every", "2"),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=_env(), cwd=ROOT,
                           start_new_session=True)
    try:
        deadline = time.time() + 240
        while (tckpt.latest_step(ckpt) or 0) < 4:
            assert run.poll() is None, run.communicate()[1][-2000:]
            assert time.time() < deadline, "no checkpoint within 240 s"
            time.sleep(0.2)
    finally:
        os.killpg(run.pid, signal.SIGKILL)
        out, _ = run.communicate()
    assert "[train] mesh {'data': 1, 'model': 2}" in out
    killed_at = tckpt.latest_step(ckpt)
    assert killed_at >= 4 and killed_at % 2 == 0
    out = _launch(ckpt, 2, "--tp", "1", "--ranks", "2")
    assert "[train] mesh {'data': 2, 'model': 1}" in out
    assert f"[train] resumed from step {killed_at}" in out
    res = json.loads(out[-1])
    assert res["start"] == killed_at and res["mesh"] == {"data": 2,
                                                          "model": 1}
    assert np.isfinite(res["final_loss"])
    assert tckpt.latest_step(ckpt) == killed_at + 2


def test_launcher_on_a_data_and_model_mesh(tmp_path):
    """Four ranks as a (2, 2) mesh, FSDP and tensor parallelism at once:
    each step's loss within 1e-3 of one device's (the mesh tolerance of
    ``test_torch_sharded_train``), and its checkpoint resumes on one
    device."""
    def losses(out):
        return [float(line.split("loss=")[1].split()[0]) for line in out
                if line.startswith("[train] step=")]

    extra = ("--batch", "4", "--accum", "2")
    ckpt = str(tmp_path / "ckpt")
    mesh = _launch(ckpt, 2, "--tp", "2", "--ranks", "4", *extra)
    assert "[train] mesh {'data': 2, 'model': 2}" in mesh
    one = _launch(str(tmp_path / "one"), 2, *extra)
    assert len(losses(mesh)) == len(losses(one)) == 2
    for got, want in zip(losses(mesh), losses(one)):
        assert abs(got - want) <= 1e-3 * abs(want)
    out = _launch(ckpt, 1, *extra)
    assert "[train] resumed from step 2" in out
    assert json.loads(out[-1])["start"] == 2


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(tree.is_floating_point())


def test_serving_parameters_that_require_grad(monkeypatch):
    """Trained leaves that require grad serve as plain ones do: quantize
    and every engine entry point (generate, submit/step, the CNN serve)
    give the same tokens and logits, and the forwards run with grad mode
    off."""
    modes = []
    fwd = lm.forward_hidden
    monkeypatch.setattr(lm, "forward_hidden", lambda *a, **k: (
        modes.append(torch.is_grad_enabled()), fwd(*a, **k))[1])
    cfg = configs.get_smoke("qwen3_4b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = {}
    for name, p in (("plain", params), ("grad", _grad_tree(params))):
        q = lm.quantize_params(p, cfg)
        assert not any(t.grad_fn is not None for t in _flat(q))
        eng = ServeEngine(cfg, q, max_len=64, n_slots=2, prefill_len=8,
                          controller=default_controller(
                              lm.n_bit_slots(cfg)), device="cpu")
        eng.set_budget(0.4)
        batch = {"tokens": torch.tensor([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]])}
        gen = eng.generate(batch, 4)
        rid = eng.submit([2, 7, 1, 8], max_new_tokens=3)
        while eng.requests[rid].done is False:
            eng.step()
        toks[name] = (gen.tolist(), list(eng.requests[rid].tokens))
    assert toks["grad"] == toks["plain"]
    assert modes and not any(modes)

    seen = []
    fwd_cnn = cnn.cnn_forward
    monkeypatch.setattr(cnn, "cnn_forward", lambda *a, **k: (
        seen.append(torch.is_grad_enabled()), fwd_cnn(*a, **k))[1])
    gen = torch.Generator().manual_seed(2)
    cparams, layers = cnn.init_cnn("resnet18", gen, image=32, device="cpu")
    images = torch.randn((2, 32, 32, 3), generator=gen)
    ctrl = pol.cnn_budget_controller("resnet18", layers=layers)
    out = {}
    for name, p in (("plain", cparams), ("grad", _grad_tree(cparams))):
        eng = CNNServeEngine(p, layers, controller=ctrl, max_batch=2,
                             device="cpu")
        logits, _ = eng.serve(images, [1e30, 1e30])
        out[name] = logits
    np.testing.assert_array_equal(out["grad"], out["plain"])
    assert seen and not any(seen)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]
