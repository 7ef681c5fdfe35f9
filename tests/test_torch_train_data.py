"""The training substrate around the step, on the CPU: the data pipeline
against the reference's bytes, the prefetch iterator, ``host_slice``,
the straggler watchdog, the launcher end to end (a checkpoint, then a
resumed run), and serving parameters that require grad (the engines'
entry points run under ``torch.no_grad()``: the same tokens and logits,
no graph)."""
import json
import os
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
    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def test_host_slice_and_shard_batch():
    assert tpipe.host_slice(8) == slice(0, 8)          # no mesh: every row
    assert tpipe.host_slice(8, _Mesh(1, 2)) == slice(4, 8)
    assert tpipe.host_slice(9, _Mesh(2, 3)) == slice(6, 9)
    b = tpipe.make_batch(0, 0, 4, 9, 50)
    assert torch.equal(tpipe.shard_batch(b, "cpu")["tokens"], b["tokens"])
    half = tpipe.shard_batch(b, "cpu", _Mesh(1, 2))
    assert torch.equal(half["tokens"], b["tokens"][2:])


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


def _launch(ckpt, steps):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3_4b", "--smoke", "--device", "cpu", "--steps", str(steps),
         "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
         "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
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


def test_launcher_refuses_model_parallel():
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="20 \\(c\\)"):
        train.main(["--smoke", "--device", "cpu", "--tp", "2"])


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
