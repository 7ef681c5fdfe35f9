"""The slice end to end on the CPU: ResNet18 serve-form logits and the
batched bit-fluid engine, port vs reference on the same weights.

Weights are made once by the reference (``jax.random``) and handed to the
port through the weight bridge (``repro_torch.models.convert``).  At 32 px
every serve-form op the two packages run is exact or rounds identically
(integer GEMMs, IEEE f32 elementwise math, one bf16 rounding per layer,
and a global-average pool over a single pixel), so serve-form logits are
asserted EQUAL.  The train-form (fake-quant fp) forward is a bf16 matmul
whose accumulation order differs between XLA and PyTorch; it is held to a
tolerance stated there, with argmax agreement.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.serve import accounting as jacc  # noqa: E402
from repro.serve.cnn import CNNServeEngine as JEngine  # noqa: E402
from repro_torch.apsim import metrics as tapm  # noqa: E402
from repro_torch.apsim.workloads import (HAWQV3_RESNET18, Layer, add,  # noqa: E402
                                         conv, fc, gemm_layers,
                                         per_layer_bits, pool)
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models.convert import from_numpy_params  # noqa: E402
from repro_torch.serve import accounting as tacc  # noqa: E402
from repro_torch.serve.cnn import CNNServeEngine, hawq_fidelity_sweep  # noqa: E402

IMAGE = 32


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def net():
    """ResNet18@32: reference params, bridged port params, both serve
    forms, and a jitted reference serve forward (bits as traced args)."""
    box = {}

    def init(key):                      # one trace: keep the layer list
        p, box["layers"] = jcnn.init_cnn("resnet18", key, image=IMAGE)
        return p

    params = jax.jit(init)(jax.random.PRNGKey(0))
    layers = box["layers"]
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    # the port's own Layer records (its copied apsim prices by type)
    tlayers = [Layer(**dataclasses.asdict(l)) for l in layers]
    # eager, as the reference engine quantizes (under jit XLA may round
    # a weight's x / scale differently, one step apart)
    qp = jcnn.quantize_cnn_params(params, layers)
    tqp = tcnn.quantize_cnn_params(tparams, tlayers)
    x = np.random.default_rng(0).normal(
        size=(3, IMAGE, IMAGE, 3)).astype(np.float32)
    jfwd = jax.jit(lambda wv, av: jcnn.cnn_forward(qp, jnp.asarray(x),
                                                   layers, wv, av))
    return dict(params=params, tparams=tparams, jlayers=layers,
                layers=tlayers, qp=qp, tqp=tqp, x=x, jfwd=jfwd)


def test_bridge_and_quantized_params_equal(net):
    for name, p in net["params"].items():
        for k, v in p.items():
            t = net["tparams"][name][k]
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(t), _np(v))
    for name, p in net["qp"].items():
        for k, v in p.items():
            np.testing.assert_array_equal(_np(net["tqp"][name][k]), _np(v))


@pytest.mark.parametrize("config", list(HAWQV3_RESNET18))
def test_resnet18_serve_logits_equal(net, config):
    """Every HAWQ-V3 config, as an (n_gemm,) vector and as (B, n_gemm)
    per-row matrices (mixed with the int4/int8 rows): logits are equal."""
    layers = net["layers"]
    bits = np.asarray(per_layer_bits(layers, HAWQV3_RESNET18[config]),
                      np.int32)
    rows = np.stack([bits,
                     np.asarray(per_layer_bits(layers, [4]), np.int32),
                     np.asarray(per_layer_bits(layers, [8]), np.int32)])
    for b in (bits, rows):
        want = np.asarray(net["jfwd"](jnp.asarray(b), jnp.asarray(b)))
        got = tcnn.cnn_forward(net["tqp"], torch.from_numpy(net["x"]), layers,
                               torch.from_numpy(b), torch.from_numpy(b))
        assert got.shape == (3, 1000) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))


def test_resnet18_train_form_close(net):
    """fp (fake-quant identity) forward: both sides round each layer's
    output to bf16, but the bf16 products accumulate in different orders
    (XLA vs PyTorch's CPU matmul), so a layer can land one bf16 ulp apart
    and the difference compounds over 21 layers.  Measured worst gap at
    this size: 6.9e-3 of the largest logit; held at 5e-2 of it, with equal
    argmax."""
    x = net["x"]
    want = np.asarray(jax.jit(lambda p: jcnn.cnn_forward(
        p, jnp.asarray(x), net["jlayers"]))(net["params"]))
    got = tcnn.cnn_forward(net["tparams"], torch.from_numpy(x),
                           net["layers"]).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-2 * scale
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_engine_mixed_budgets_match_reference(net):
    """Mixed per-image EDP budgets spanning all five configurations:
    per-image wbits, abits, mean_wbits and edp, the aggregate() ledger,
    and the logits equal the reference engine's."""
    layers, jlayers = net["layers"], net["jlayers"]
    jctrl = jpol.cnn_budget_controller("resnet18", layers=jlayers)
    tctrl = tpol.cnn_budget_controller("resnet18", layers=layers)
    jeng = JEngine(net["params"], jlayers, controller=jctrl, max_batch=4)
    teng = CNNServeEngine(net["tparams"], layers, controller=tctrl,
                          max_batch=4, device="cpu")
    assert teng.int4_names == jeng.int4_names == ()
    assert teng.families == (4, 8)
    preds = [jctrl.predicted_latency_s[k] for k in jctrl.order()]
    x = np.random.default_rng(1).normal(
        size=(4, IMAGE, IMAGE, 3)).astype(np.float32)
    batches = [(x, [p * 1.01 for p in preds[1:]]),      # low..int8
               (x[:3], [0.0, preds[0] * 1.01, 1e30]),   # padded batch
               (x[:2], None)]                           # unconstrained
    jrecs, trecs = [], []
    for imgs, bud in batches:
        jl, js = jeng.serve(imgs, bud)
        tl, ts = teng.serve(imgs, bud)
        np.testing.assert_array_equal(tl, np.asarray(jl))
        assert len(ts) == len(js) == imgs.shape[0]
        for t, j in zip(ts, js):
            assert t.wbits == j.wbits and t.abits == j.abits
            assert t.mean_wbits == j.mean_wbits
            assert t.edp == j.edp and t.budget == j.budget
        jrecs += js
        trecs += ts
    assert sorted({r.mean_wbits for r in trecs})[0] == 4.0
    assert trecs[-1].mean_wbits == 8.0
    assert len({r.wbits for r in trecs}) == 5            # all five configs
    assert tacc.aggregate(trecs) == jacc.aggregate(jrecs)
    assert teng.stats.images == 9 and teng.stats.batches == 3
    # per-image EDP is the copied AP model's price of the image's bits
    costs = tapm.price_bit_matrix(tapm.network_gemms(layers),
                                  [r.wbits for r in trecs],
                                  [r.abits for r in trecs])
    assert [c.edp for c in costs] == [r.edp for r in trecs]


def _tiny_layers():
    """conv -> maxpool -> conv -> residual add -> fc (3 ungrouped GEMMs)."""
    return [conv("c1", 8, 4, 3, 8), pool("p1", "maxpool", 8, 8, 2, 2),
            conv("c2", 4, 8, 3, 8), add("a1", 4, 8),
            fc("fc", 8 * 4 * 4, 10, relu=False)]


def _tiny_params():
    layers = _tiny_layers()
    gen = torch.Generator().manual_seed(0)
    params = {l.name: tcm.dense_init(gen, l.hk * l.wk * l.cin if l.kind ==
                                     "conv" else l.cin, l.cout, bias=True,
                                     device="cpu")
              for l in gemm_layers(layers)}
    return params, layers


def test_engine_int4_container_plan(rng):
    """A controller whose every configuration runs <= 4 bits packs the
    layers into int4 containers, and rows still resolve per budget."""
    params, layers = _tiny_params()
    n = len(gemm_layers(layers))
    ctrl = tpol.BudgetController(
        {"int4": tpol.fixed(4), "int2": tpol.fixed(2)},
        {"int4": 2.0, "int2": 1.0}, n)
    eng = CNNServeEngine(params, layers, controller=ctrl, max_batch=2,
                         device="cpu")
    assert set(eng.int4_names) == {"c1", "c2", "fc"}
    assert all("q4" in eng.qparams[k] for k in eng.int4_names)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    logits, stats = eng.serve(x, [0.5, 3.0])
    assert np.isfinite(logits).all() and logits.shape == (2, 10)
    assert stats[0].mean_wbits == 2 and stats[1].mean_wbits == 4
    ctrl8 = tpol.BudgetController(
        {"int4": tpol.fixed(4), "int8": tpol.fixed(8)},
        {"int4": 1.0, "int8": 2.0}, n)
    assert CNNServeEngine(params, layers, controller=ctrl8,
                          device="cpu").int4_names == ()
    with pytest.raises(ValueError, match="cannot honor"):
        CNNServeEngine(params, layers, controller=ctrl8, container="int4",
                       device="cpu")


def test_engine_validates_inputs(rng):
    params, layers = _tiny_params()
    ctrl = tpol.BudgetController({"int8": tpol.fixed(8)}, {"int8": 0.0}, 7)
    with pytest.raises(ValueError, match="GEMM"):
        CNNServeEngine(params, layers, controller=ctrl, device="cpu")
    eng = CNNServeEngine(params, layers, max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        eng.serve(rng.normal(size=(3, 8, 8, 4)).astype(np.float32))


def test_forward_validates_bits_and_wiring(net, rng):
    layers = net["layers"]
    x = torch.from_numpy(net["x"][:1])
    short = torch.tensor(HAWQV3_RESNET18["medium"], dtype=torch.int32)
    with pytest.raises(ValueError, match="21 GEMM"):
        tcnn.cnn_forward(net["tqp"], x, layers, short, short)
    good = torch.full((21,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="21 GEMM"):
        tcnn.cnn_forward(net["tqp"], x, layers, good, good[:-1])
    broken = [l for l in layers if l.name != "s3b1_down"]
    qp = {k: v for k, v in net["tqp"].items() if k != "s3b1_down"}
    with pytest.raises(ValueError, match="residual add"):
        tcnn.cnn_forward(qp, x, broken)


def test_hawq_fidelity_sweep_on_cpu():
    fid, launches = hawq_fidelity_sweep(image=IMAGE, batch=2, device="cpu")
    assert list(fid) == list(HAWQV3_RESNET18)
    assert all(0.0 < v <= 1.0 for v in fid.values())
    assert launches == {}                  # the CPU runs the plain version


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcnn.init_cnn("resnet18", gen, image=IMAGE)
    params, layers = _tiny_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        CNNServeEngine(params, layers)
    with pytest.raises(RuntimeError, match="CUDA"):
        hawq_fidelity_sweep(image=IMAGE)
