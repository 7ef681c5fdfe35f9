"""The serving CLI on the CPU, port vs reference.

``python -m repro_torch.launch.serve`` (``main(argv)``) against
``repro.launch.serve.main`` on the same qwen3_4b SMOKE weights: the
reference's own ``PRNGKey(0)`` draw, carried across with the weight
bridge, or a checkpoint that ``repro_torch.launch.train`` wrote, which
both restore.  The reference serves op by op (``jax.disable_jit``;
``tests/test_torch_lm.py`` says why), and its engine is recorded where
its ``main`` builds it.  Per-request host fields (budget, mean wbits,
tokens served, slot, AP latency, energy and EDP, the closed loop's spend
and SLO) and the greedy token ids are EQUAL, in continuous, ``--slo-edp``,
``--kv-bits 8``, ``--batch`` and ``--ckpt-dir`` runs; so are the
argument errors.  Every size is small: at most 3 requests of 8-token
prompts, 4 new tokens.  ``tests/test_torch_launch_trace.py`` holds the
trace-replay CLI and the examples.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro.launch.serve as jserve  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve.accounting import predict_table  # noqa: E402
from repro_torch.serve.engine import default_controller  # noqa: E402

ARCH = "qwen3_4b"
BASE = ["--arch", ARCH, "--smoke", "--requests", "3", "--prompt-len", "8",
        "--steps", "4", "--max-len", "32", "--n-slots", "2",
        "--decode-block", "2"]
FIELDS = ("budget_s", "mean_wbits", "n_tokens", "slot", "ap_latency_s",
          "ap_energy_j", "edp")


@pytest.fixture(scope="module")
def weights():
    """The reference main's own draw (PRNGKey(0)) as port tensors."""
    jparams = jlm.init_params(jconfigs.get_smoke(ARCH), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jparams)


def _reference(monkeypatch, argv):
    """Run the reference CLI's main on ``argv`` op by op; returns its
    engine (recorded where main builds it) and each generate's ids."""
    built, generated = [], []

    class Recorded(jserve.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

        def generate(self, batch, steps, **kw):
            out = super().generate(batch, steps, **kw)
            generated.append(np.asarray(out).tolist())
            return out

    def op_by_op(fn):
        def run(*a, **kw):
            with jax.disable_jit():
                return fn(*a, **kw)
        return run

    # the draw, restore and quantize run as main runs them; serving runs
    # op by op
    monkeypatch.setattr(jserve, "ServeEngine", Recorded)
    for name in ("_serve_continuous", "_serve_batches"):
        monkeypatch.setattr(jserve, name, op_by_op(getattr(jserve, name)))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    (eng,) = built
    return eng, generated


def _port(monkeypatch, argv, weights):
    """The port's CLI on the CPU, its seed-0 draw replaced by ``weights``
    (which a checkpoint in ``--ckpt-dir`` replaces in turn)."""
    monkeypatch.setattr(tlm, "init_params", lambda cfg, gen, device:
                        from_numpy_params(weights, device="cpu"))
    return tserve.main(argv + ["--device", "cpu"])


def _hold_continuous(jeng, got):
    recs = [jeng.requests[r["rid"]] for r in got["requests"]]
    assert len(recs) == len(jeng.requests)
    for r, st in zip(got["requests"], recs):
        for f in FIELDS:
            assert r[f] == getattr(st, f), f
        assert r["tokens"] == [int(t) for t in st.tokens]
        assert r["n_tokens"] == 4


def _slo(n_requests: int) -> float:
    """0.3 of the priced int8 cost of the stream: the loop serves its
    requests at different bits (4, 4 and 6 here) to stay inside it."""
    cfg = tconfigs.get_smoke(ARCH)
    preds = predict_table(tlm.layer_gemm_dims(cfg),
                          default_controller(tlm.n_bit_slots(cfg)).configs,
                          axis="edp", units=8 + 4,
                          head=tlm.head_gemm_dims(cfg))
    return 0.3 * n_requests * preds["int8"]


@pytest.mark.parametrize("extra", [
    ["--budgets", "2.0", "0.5", "0.75"],
    ["--slo-edp", "SLO"],
    ["--kv-bits", "8"],
], ids=["continuous", "slo_edp", "kv_bits_8"])
def test_continuous_modes_equal_reference(monkeypatch, weights, extra):
    argv = BASE + [f"{_slo(3)!r}" if a == "SLO" else a for a in extra]
    jeng, _ = _reference(monkeypatch, argv)
    got = _port(monkeypatch, argv, weights)
    assert got["mode"] == "continuous" and got["restored_step"] is None
    _hold_continuous(jeng, got)
    if "--slo-edp" in extra:
        loop = got["closed_loop"]
        spent = sum(st.edp for st in jeng.requests.values())
        assert loop["slo_edp"] == jeng.controller.slo
        assert loop["spent_edp"] == spent and loop["admissions"] == 3
        assert spent <= loop["slo_edp"]
        assert len({r["mean_wbits"] for r in got["requests"]}) > 1
    else:
        assert got["closed_loop"] is None
    assert got["calls"]["prefill"] == 3
    assert got["stats"]["tokens"] == 12 and got["stats"]["admitted"] == 3


def test_batch_mode_equals_reference(monkeypatch, weights):
    # two rows: the decode step's shapes are the continuous runs' own
    argv = BASE + ["--batch", "--budgets", "2.0", "0.5", "--requests", "2"]
    jeng, jtoks = _reference(monkeypatch, argv)
    got = _port(monkeypatch, argv, weights)
    assert got["mode"] == "batch" and len(got["batches"]) == 2
    for b, want in zip(got["batches"], jtoks):
        wv, _ = jeng.controller.resolve(jax.numpy.asarray(b["budget_s"]))
        cost = jeng.price_budget(b["budget_s"])
        assert b["mean_wbits"] == float(np.mean(np.asarray(wv)))
        assert (b["ap_cycles"], b["ap_energy_j"]) == (cost.cycles,
                                                       cost.energy_j)
        assert b["tokens"] == want
    assert got["calls"] == {"prefill": 2, "decode": 6}
    assert all(len(t) == 2 and len(t[0]) == 4
               for t in (b["tokens"] for b in got["batches"]))


def test_ckpt_dir_restores_trained_weights(monkeypatch, weights, tmp_path):
    """train -> checkpoint -> serve: the port's trainer writes the
    checkpoint; both CLIs restore its params and serve the same tokens,
    which differ from the untrained weights'."""
    ckpt = str(tmp_path / "ckpt")
    ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
                 "--lr", "0.05"])
    argv = BASE + ["--ckpt-dir", ckpt]
    jeng, _ = _reference(monkeypatch, argv)
    got = _port(monkeypatch, argv, weights)
    assert got["restored_step"] == 2
    _hold_continuous(jeng, got)
    fresh = _port(monkeypatch, BASE, weights)
    assert [r["tokens"] for r in fresh["requests"]] != \
        [r["tokens"] for r in got["requests"]]


@pytest.mark.parametrize("argv", [
    ["--continuous", "--batch"],
    ["--batch", "--slo-edp", "1e-6"],
    ["--slo-edp", "1e-6", "--budgets", "1.0"],
    ["--kv-bits", "4"],
])
def test_argument_errors_equal_reference(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as want:
        jserve.main()
    jerr = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        tserve.main(argv + ["--device", "cpu"])
    terr = capsys.readouterr().err.splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert terr.split("error:")[1] == jerr.split("error:")[1]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke", "--batch"])


@pytest.mark.parametrize("mode", [[], ["--batch"]])
def test_specialisations_line_does_not_grow_with_budgets(monkeypatch, capsys,
                                                         mode):
    """The counterpart of the reference's compiled-programs line: the
    kernel specialisations a run launched (bit-plane launches counted by
    a plain version that keys them as the wrapper does) are the same
    set for one budget level and for three."""
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import ops

    def counting(x_q, w_q, *, n_planes=8):
        M, K = x_q.shape
        N = w_q.shape[1]
        key = (bpm.plan(M, K, N).path, n_planes, M, K, N)
        bpm.spec_launches[key] = bpm.spec_launches.get(key, 0) + 1
        return bpm.bitplane_matmul_ref(x_q, w_q, n_planes)

    monkeypatch.setattr(ops, "bitplane_matmul", counting)
    runs = []
    for budgets in (["2.0"], ["2.0", "0.5", "0.4"]):
        monkeypatch.setattr(bpm, "spec_launches", {})
        out = tserve.main(BASE + ["--device", "cpu", "--budgets"] + budgets
                          + mode)
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[serve] kernel specialisations:")]
        assert line == [f"[serve] kernel specialisations: bitplane="
                        f"{out['specialisations']['bitplane_matmul']} "
                        f"flash=0 (fluid across {len(budgets)} budget "
                        f"levels)"]
        runs.append((out["specialisations"], set(bpm.spec_launches)))
    assert runs[0][0]["bitplane_matmul"] > 0
    assert runs[0] == runs[1]
