"""Grouped convolutions and AlexNet, port vs reference on the same weights.

The grouped helpers and ``serve_linear_stacked`` (scalar bits, ``(B,)``
per-row bits, per-slice ``stack_bits``), then AlexNet end to end:
reference weights (``jax.random``) bridged to the port, serve-form logits
with int8 and packed-int4 containers under every bit form, and the
batched engine on the paper's energy-axis int4/int8 controller.  Integer
GEMMs are exact and the float math rounds identically, so serve-form
outputs are asserted EQUAL; the train form (a bf16 matmul whose
accumulation order differs between XLA and PyTorch) is held to a
tolerance stated there.

At 32 px AlexNet's grouped convs see a 2x2 (conv2) and 1x1 (conv4,
conv5) map with 1x1 kernels, so a 64-px forward also runs conv2 with its
5x5 kernel (25 taps split by channel into two groups).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.serve import accounting as jacc  # noqa: E402
from repro.serve.cnn import CNNServeEngine as JEngine  # noqa: E402
from repro_torch.apsim import metrics as tapm  # noqa: E402
from repro_torch.apsim.workloads import Layer  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve import accounting as tacc  # noqa: E402
from repro_torch.serve.cnn import CNNServeEngine  # noqa: E402

N_GEMM = 8                  # AlexNet: conv1..conv5, fc6..fc8
GROUPED = ("conv2", "conv4", "conv5")


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# Helpers and the stacked dispatch
# ---------------------------------------------------------------------------

def test_grouped_cols_equals_reference(rng):
    cols = rng.normal(size=(2, 3, 4, 9 * 12)).astype(np.float32)
    for g in (2, 3, 4):
        got = tcnn.grouped_cols(torch.from_numpy(cols), g, 9)
        want = jcnn.grouped_cols(jnp.asarray(cols), g, 9)
        assert got.shape == (2, 3, 4, g, 9 * 12 // g)
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_stack_grouped_weight_equals_reference(rng):
    w = rng.normal(size=(27, 12)).astype(np.float32)
    for g in (2, 3):
        got = tcnn.stack_grouped_weight(torch.from_numpy(w), g, 12)
        assert got.is_contiguous() and got.shape == (g, 27, 12 // g)
        np.testing.assert_array_equal(
            got.numpy(), _np(jcnn.stack_grouped_weight(jnp.asarray(w), g, 12)))


@pytest.mark.parametrize("mode", ["scalar-int", "scalar-tensor", "rows",
                                  "stack_bits"])
def test_serve_linear_stacked_equals_reference(rng, mode):
    G, B, K, N = 2, 3, 24, 10
    w3 = (rng.normal(size=(G, K, N)) * K ** -0.5).astype(np.float32)
    jp = jcm.quantize_linear({"w": jnp.asarray(w3)}, "int8")
    tp = tcm.quantize_linear({"w": torch.from_numpy(w3)}, "int8")
    for k in jp:
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]))
    # the two slices differ in scale by 10x: one shared activation scale
    # would quantize the quiet slice coarsely and change its output
    x = rng.normal(size=(G, B, 5, K)).astype(np.float32)
    x[1] *= 10.0
    kw = {}
    if mode == "scalar-int":
        jw = tw = 4
    elif mode == "scalar-tensor":
        jw, tw = jnp.asarray(6, jnp.int32), torch.tensor(6, dtype=torch.int32)
    elif mode == "rows":
        wb = np.asarray([2, 8, 4], np.int32)
        jw, tw = jnp.asarray(wb), torch.from_numpy(wb)
    else:
        wb = np.asarray([3, 8], np.int32)
        jw, tw = jnp.asarray(wb), torch.from_numpy(wb)
        kw = {"stack_bits": True}
    want = jops.serve_linear_stacked(jp, jnp.asarray(x), jw, 8, **kw)
    got = tops.serve_linear_stacked(tp, torch.from_numpy(x), tw, 8, **kw)
    assert got.shape == (G, B, 5, N) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # each slice equals serve_linear on that slice alone
    for g in range(G):
        solo = tops.serve_linear({k: v[g] for k, v in tp.items()},
                                 torch.from_numpy(x[g]),
                                 tw[g] if kw else tw, 8)
        np.testing.assert_array_equal(got[g].numpy(), solo.numpy())


# ---------------------------------------------------------------------------
# AlexNet end to end
# ---------------------------------------------------------------------------

def _alexnet(image):
    box = {}

    def init(key):                      # one trace: keep the layer list
        p, box["layers"] = jcnn.init_cnn("alexnet", key, image=image)
        return p

    params = jax.jit(init)(jax.random.PRNGKey(0))
    jlayers = box["layers"]
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    tlayers = [Layer(**dataclasses.asdict(l)) for l in jlayers]
    assert [l.name for l in tlayers if l.groups > 1] == list(GROUPED)
    return params, jlayers, tparams, tlayers


@pytest.fixture(scope="module")
def net():
    """AlexNet@32: reference params, bridged port params, both containers
    quantized eagerly on both sides (under jit the reference may round a
    weight one step apart), and a 3-image batch."""
    params, jlayers, tparams, tlayers = _alexnet(32)
    qp = {c: jcnn.quantize_cnn_params(params, jlayers, container=c)
          for c in ("int8", "int4")}
    tqp = {c: tcnn.quantize_cnn_params(tparams, tlayers, container=c)
           for c in ("int8", "int4")}
    x = np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(np.float32)
    return dict(params=params, jlayers=jlayers, tparams=tparams,
                layers=tlayers, qp=qp, tqp=tqp, x=x)


def test_quantized_params_equal(net):
    for c in ("int8", "int4"):
        for name, p in net["qp"][c].items():
            t = net["tqp"][c][name]
            assert set(t) == set(p)
            if name in GROUPED:                 # always int8 stacks
                assert t["q"].shape[0] == 2 and "q4" not in t
            elif c == "int4":
                assert "q4" in t
            for k, v in p.items():
                np.testing.assert_array_equal(_np(t[k]), _np(v))


def _bits(form):
    vec = np.asarray([8, 4, 6, 8, 4, 8, 4, 8], np.int32)
    if form == "vector":
        return vec
    return np.stack([vec, np.full(N_GEMM, 4, np.int32),
                     np.full(N_GEMM, 8, np.int32)])


@pytest.mark.parametrize("form", ["none", "vector", "rows"])
@pytest.mark.parametrize("container", ["int8", "int4"])
def test_alexnet_serve_logits_equal(net, monkeypatch, container, form):
    """Container width (no bits: the int4 layers take the packed branch,
    five int4_matmul calls), an (n_gemm,) vector and (B, n_gemm) rows."""
    x = net["x"]
    if form == "none":
        # op by op: jitted, XLA contracts the static-bits epilogue's
        # multiply and bias add into an FMA, one rounding fewer than the
        # reference's own eager ops and the port (and 8-bit activation
        # quantizers then carry that ulp to the logits)
        want = jcnn.cnn_forward(net["qp"][container], jnp.asarray(x),
                                net["jlayers"])
        args = ()
    else:
        b = _bits(form)
        want = jax.jit(lambda wv: jcnn.cnn_forward(
            net["qp"][container], jnp.asarray(x), net["jlayers"], wv, wv))(
            jnp.asarray(b))
        args = (torch.from_numpy(b), torch.from_numpy(b))
    calls = []
    real = tops.int4_matmul
    monkeypatch.setattr(tops, "int4_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tcnn.cnn_forward(net["tqp"][container], torch.from_numpy(x),
                           net["layers"], *args)
    assert got.shape == (3, 1000) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(want))
    packed = container == "int4" and form == "none"
    assert len(calls) == (N_GEMM - len(GROUPED) if packed else 0)


def test_alexnet_serve_logits_equal_at_64px():
    """conv2 with its 5x5 kernel: grouped_cols splits 25 taps by channel
    (the grouped stacks are int8 whatever the container)."""
    params, jlayers, tparams, tlayers = _alexnet(64)
    conv2 = next(l for l in tlayers if l.name == "conv2")
    assert conv2.hk == 5 and conv2.hin == 6
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    b = _bits("rows")[:2]
    qp = jcnn.quantize_cnn_params(params, jlayers)
    tqp = tcnn.quantize_cnn_params(tparams, tlayers)
    want = jax.jit(lambda wv: jcnn.cnn_forward(
        qp, jnp.asarray(x), jlayers, wv, wv))(jnp.asarray(b))
    got = tcnn.cnn_forward(tqp, torch.from_numpy(x), tlayers,
                           torch.from_numpy(b), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_alexnet_train_form_close(net):
    """fp (fake-quant identity) forward through the grouped stacks, and a
    per-row fake-quant forward at 8/4/8 bits: both sides round each
    layer's output to bf16, but the bf16 products accumulate in different
    orders (XLA vs PyTorch's CPU matmul), so a layer can land one bf16 ulp
    apart and the difference compounds over 8 layers.  Held at 5e-2 of
    the largest logit, as for ResNet18, with equal argmax.  The reference
    runs op by op: jitted, XLA fuses the fake-quant steps and rounds some
    apart, and at 4-bit activations one ulp moves a whole quantizer step
    (ROADMAP Queue C); its jitted per-row logits sit 0.43 x max|logit|
    from its own op-by-op ones at this size."""
    x = net["x"]
    for bits in (None, _bits("rows")):
        args = () if bits is None else (jnp.asarray(bits),) * 2
        targs = () if bits is None else (torch.from_numpy(bits),) * 2
        want = np.asarray(jcnn.cnn_forward(
            net["params"], jnp.asarray(x), net["jlayers"], *args))
        got = tcnn.cnn_forward(net["tparams"], torch.from_numpy(x),
                               net["layers"], *targs).numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 5e-2 * scale
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_alexnet_engine_matches_reference(net):
    """The energy-axis int4/int8 controller: budgets split across the
    batch resolve both configurations; logits, bits, EDP and the
    aggregate() ledger equal the reference engine's."""
    configs = lambda pol: {"int4": pol.fixed(4), "int8": pol.fixed(8)}  # noqa: E731
    jctrl = jpol.cnn_budget_controller("alexnet", layers=net["jlayers"],
                                       configs=configs(jpol), metric="energy")
    tctrl = tpol.cnn_budget_controller("alexnet", layers=net["layers"],
                                       configs=configs(tpol), metric="energy")
    assert tctrl.predicted_latency_s == jctrl.predicted_latency_s
    jeng = JEngine(net["params"], net["jlayers"], controller=jctrl,
                   max_batch=4)
    teng = CNNServeEngine(net["tparams"], net["layers"], controller=tctrl,
                          max_batch=4, device="cpu")
    assert teng.int4_names == jeng.int4_names == ()
    assert teng.families == (4, 8)
    e4, e8 = (tctrl.predicted_latency_s[k] for k in ("int4", "int8"))
    x = np.random.default_rng(1).normal(
        size=(4, 32, 32, 3)).astype(np.float32)
    batches = [(x, [e4 * 1.01, e8 * 1.01, 0.0, 1e30]),
               (x[:3], [e8 * 1.01, e4 * 1.01, e8]),    # padded batch
               (x[:2], None)]                          # unconstrained
    jrecs, trecs = [], []
    for imgs, bud in batches:
        jl, js = jeng.serve(imgs, bud)
        tl, ts = teng.serve(imgs, bud)
        np.testing.assert_array_equal(tl, np.asarray(jl))
        for t, j in zip(ts, js):
            assert t.wbits == j.wbits and t.abits == j.abits
            assert t.mean_wbits == j.mean_wbits
            assert t.edp == j.edp and t.budget == j.budget
        jrecs += js
        trecs += ts
    assert {r.mean_wbits for r in trecs} == {4.0, 8.0}
    assert tacc.aggregate(trecs) == jacc.aggregate(jrecs)
    costs = tapm.price_bit_matrix(tapm.network_gemms(net["layers"]),
                                  [r.wbits for r in trecs],
                                  [r.abits for r in trecs])
    assert [c.edp for c in costs] == [r.edp for r in trecs]
